"""getdist_tpu_torch CUDA kernels against their plain PyTorch versions.

Needs a CUDA card and nvcc; every test skips without a card. The file
imports no JAX, so it runs on a machine that has none:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from getdist_tpu_torch.ops import batched, dft_conv, pair_hist  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _indices(p, n, seed):
    x = np.random.default_rng(seed).standard_normal((p, n))
    return np.clip(x * 40 + 128, 0, 255).astype(np.uint8)


def _pairs(p, device):
    pairs = torch.tensor([(i, j) for i in range(p) for j in range(i + 1, p)], dtype=torch.int32, device=device)
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def test_pair_histograms_integer_weights_bit_exact(cuda):
    p, n = 9, 100_003
    ix = torch.from_numpy(_indices(p, n, seed=1)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(2).integers(1, 5, n).astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    before = pair_hist.pair_histograms.launches
    got = pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=True)
    assert pair_hist.pair_histograms.launches == before + 1
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pair_histograms_float_weights(cuda):
    """f32 atomics sum in a varying order: equal to f32 rounding."""
    p, n = 5, 50_000
    ix = torch.from_numpy(_indices(p, n, seed=3)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(4).random(n).astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    got = pair_hist.pair_histograms(ix, w, pa, pb)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad,n,m,offset", [(128, 48, 13, 6), (384, 256, 61, 30)])
def test_dft_conv_kernels_match_plain(cuda, pad, n, m, offset):
    rng = np.random.RandomState(4)
    grids = torch.from_numpy((rng.rand(5, n, n) * 50).astype(np.float32)).to(cuda)
    kernels = torch.from_numpy(rng.rand(5, m, m).astype(np.float32)).to(cuda)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    for got, want in ((ur, ur0), (ui, ui0)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    out = dft_conv.dft_conv2d(grids, ur, ui, n, offset, pad)
    want = dft_conv.dft_conv2d_plain(grids, ur0, ui0, n, offset, pad)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_slice_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(7)
    n, p = 30_000, 5
    cov = np.eye(p)
    cov[0, 1] = cov[1, 0] = 0.6
    x = rng.multivariate_normal(np.zeros(p), cov, n)
    w = rng.randint(1, 4, n).astype(np.float64)
    g1, g2 = batched.triangle_densities(x, w, device=cuda)
    c1, c2 = batched.triangle_densities(x, w, device="cpu")
    torch.testing.assert_close(g1["neff"].cpu(), c1["neff"], rtol=1e-4, atol=0)
    torch.testing.assert_close(g1["P"].cpu(), c1["P"], rtol=0, atol=1e-4)
    for key in ("rx", "ry", "corr"):
        torch.testing.assert_close(g2[key].cpu(), c2[key], rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(g2["P"].cpu(), c2["P"], rtol=0, atol=5e-4)
    torch.testing.assert_close(g2["contours"].cpu(), c2["contours"], rtol=0.02, atol=0)


@pytest.mark.parametrize("nbins,index_dtype", [(256, torch.uint8), (512, torch.int16), (960, torch.int32)])
def test_dynamic_pair_histograms_bit_exact(cuda, nbins, index_dtype):
    """K4's entry on a sheared-stack pair list (repeated a rows, unique b rows)."""
    p, n = 6, 200_003
    rng = np.random.default_rng(5)
    ix = torch.from_numpy(np.clip(rng.standard_normal((p, n)) * nbins / 6 + nbins / 2, 0, nbins - 1).astype(np.int64))
    ix = ix.to(index_dtype).to(cuda)
    w = torch.from_numpy(rng.integers(1, 5, n).astype(np.float32)).to(cuda)
    pa = torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32, device=cuda)
    pb = torch.tensor([2, 3, 4, 5, 2], dtype=torch.int32, device=cuda)
    before = pair_hist.pair_histograms_dynamic.launches
    got = pair_hist.pair_histograms_dynamic(ix, w, pa, pb, integer_weights=True, nbins=nbins)
    assert pair_hist.pair_histograms_dynamic.launches == before + 1
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True, nbins=nbins)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dft_conv_kernels_f64_match_plain(cuda):
    rng = np.random.RandomState(6)
    pad, n, m, offset = 768, 452, 197, 196
    grids = torch.from_numpy(rng.rand(3, n, n) * 50).to(cuda)
    kernels = torch.from_numpy(rng.rand(3, m, m)).to(cuda)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    for got, want in ((ur, ur0), (ui, ui0)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))
    out = dft_conv.dft_conv2d(grids, ur, ui, 256, offset, pad)
    want = dft_conv.dft_conv2d_plain(grids, ur0, ui0, 256, offset, pad)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-12 * float(want.abs().max()))


def test_parity_on_card_matches_cpu(cuda):
    from getdist_tpu_torch.mcsamples import MCSamples

    rng = np.random.RandomState(3)
    n = 12000
    base = rng.standard_normal((n, 2))
    x = base[:, 0]
    kwargs = dict(
        samples=np.column_stack([x, 0.75 * x + 0.66 * base[:, 1], np.abs(rng.standard_normal(n))]),
        weights=rng.randint(1, 4, n).astype(np.float64),
        names=["x", "y", "z"],
        ranges={"z": [0, None]},
    )
    g1, g2 = MCSamples(device=cuda, **kwargs).fastParityDensities(device=True)
    c1, c2 = MCSamples(device="cpu", **kwargs).fastParityDensities(device=True)
    assert set(g2) == set(c2)
    for key in c1:
        assert np.abs(g1[key].P - c1[key].P).max() <= 1e-10, key
    for key in c2:
        got, want = g2[key].P, c2[key].P
        assert np.abs(got / got.max() - want / want.max()).max() <= 1e-5, key
        assert np.abs(np.asarray(g2[key].contours) - np.asarray(c2[key].contours)).max() <= 1e-5, key


def test_dft_conv_batches_split_over_pairs(cuda, monkeypatch):
    """A batch whose scratch passes SCRATCH_BYTES runs in several launches,
    with the same result."""
    rng = np.random.RandomState(8)
    grids = torch.from_numpy(rng.rand(5, 200, 200)).to(cuda)
    kernels = torch.from_numpy(rng.rand(5, 37, 37)).to(cuda)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, 384)
    want = dft_conv.dft_conv2d(grids, ur, ui, 200, 18, 384)
    monkeypatch.setattr(dft_conv, "SCRATCH_BYTES", 2 * 4 * 384 * 384 * 8)
    before = (dft_conv.dft_conv_spectrum.launches, dft_conv.dft_conv2d.launches)
    ur2, ui2 = dft_conv.dft_conv_spectrum(kernels, 384)
    got = dft_conv.dft_conv2d(grids, ur2, ui2, 200, 18, 384)
    assert (dft_conv.dft_conv_spectrum.launches - before[0], dft_conv.dft_conv2d.launches - before[1]) == (3, 3)
    torch.testing.assert_close(ur2, ur, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
