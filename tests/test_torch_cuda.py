"""getdist_tpu_torch CUDA kernels against their plain PyTorch versions.

Needs a CUDA card and nvcc; every test skips without a card. The file
imports no JAX, so it runs on a machine that has none:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import contextlib

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
    """Fractional weights in fixed point: equal to f32 rounding of the
    plain version's f64 sums, and the same bits on a second call."""
    p, n = 5, 50_000
    ix = torch.from_numpy(_indices(p, n, seed=3)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(4).random(n).astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    got = pair_hist.pair_histograms(ix, w, pa, pb)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, pair_hist.pair_histograms(ix, w, pa, pb))


@pytest.mark.parametrize("weights", ["fractional", "negative", "many-decades"])
@pytest.mark.parametrize("nbins", [256, 200])
def test_fractional_weights_same_bits_on_both_routes(cuda, monkeypatch, nbins, weights):
    """The uint8 kernel's fixed-point bins are order independent: one chunk
    a pair and the split route (forced), and two calls, give the same
    bits; each bin within 1e-6 of the plain version's f64 sum (rounded to
    f32 once) plus 1e-9 of its pair's peak. "many-decades": like weights
    exp(-chi2/2) over 30 decades."""
    p, n = 6, 300_001
    rng = np.random.default_rng(nbins)
    ix = torch.from_numpy(_spread_indices(p, n, seed=nbins + 1)).to(cuda)
    w = {
        "fractional": rng.random(n),
        "negative": rng.normal(0.5, 1.0, n),
        "many-decades": np.exp(-0.5 * rng.uniform(0, 140, n)),
    }[weights]
    w = torch.from_numpy(w.astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    whole = pair_hist.pair_histograms(ix, w, pa, pb, nbins=nbins)
    assert torch.equal(whole, pair_hist.pair_histograms(ix, w, pa, pb, nbins=nbins))
    monkeypatch.setattr(pair_hist, "split_plan", lambda k, n, sms, parts=2: 5)
    split = pair_hist.pair_histograms(ix, w, pa, pb, nbins=nbins)
    assert torch.equal(whole, split)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, nbins=nbins)
    peak = want.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((whole - want).abs() <= 1e-6 * want.abs() + 1e-9 * peak).all())


def _fixed_weights(kind, n, seed):
    rng = np.random.default_rng(seed)
    w = {
        "fractional": rng.random(n),
        "negative": rng.normal(0.5, 1.0, n),
        "many-decades": np.exp(-0.5 * rng.uniform(0, 140, n)),
    }[kind]
    return torch.from_numpy(w.astype(np.float32))


def _fixed_rows(p, n, nbins, seed):
    """uint8 rows for the fixed-point route: peaked (Gaussian) columns, whose
    outer quarters skip most vectors, and flat ones that fill every
    quarter; at fewer than 256 bins the indices from nbins up are dropped."""
    rng = np.random.default_rng(seed)
    peaked = np.clip(rng.standard_normal((p, n)) * nbins / 7 + nbins / 2, 0, 255)
    flat = rng.integers(0, 256, (p, n))
    return torch.from_numpy(np.where(np.arange(p)[:, None] % 3 == 2, flat, peaked).astype(np.uint8))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("weights", ["fractional", "negative", "many-decades"])
@pytest.mark.parametrize("k", [1, 8, 110])
@pytest.mark.parametrize("nbins", [256, 200, 129])
def test_fixed_point_route_bit_exact(cuda, nbins, k, weights, scaled):
    """The uint8 kernel's fixed-point route (four blocks a pair, each add
    two native 32-bit shared adds with the low word's carry, a and w read
    only where a vector's b indices meet the block's rows): the raw int64
    sums and the converted f32 sums bitwise equal to the plain version's,
    and two calls bitwise equal. N = 300,003 puts the columns off 16-byte
    boundaries; 1 and 8 pairs take the split route (global-atomic flush),
    110 one chunk a pair; quarters of 200 and 129 bins do not divide
    evenly. ``scaled``: a group's scale (a larger max |w|, three ranks'
    samples), as the sharded paths pass it."""
    p, n = 16, 300_003
    ix = _fixed_rows(p, n, nbins, seed=nbins + k).to(cuda)
    w = _fixed_weights(weights, n, seed=k).to(cuda)
    pa, pb = (x[:k].contiguous() for x in _pairs(p, cuda))
    scale = (1.5 * w.abs().max(), 3 * n) if scaled else None
    raw = pair_hist.pair_histograms(ix, w, pa, pb, nbins=nbins, scale=scale, raw=True)
    assert raw.dtype == torch.int64
    assert torch.equal(raw, pair_hist.pair_histograms_plain(ix, w, pa, pb, nbins=nbins, scale=scale, raw=True))
    assert torch.equal(raw, pair_hist.pair_histograms(ix, w, pa, pb, nbins=nbins, scale=scale, raw=True))
    got = pair_hist.pair_histograms(ix, w, pa, pb, nbins=nbins, scale=scale)
    assert torch.equal(got, pair_hist.pair_histograms_plain(ix, w, pa, pb, nbins=nbins, scale=scale))
    assert torch.equal(got, pair_hist.pair_histograms(ix, w, pa, pb, nbins=nbins, scale=scale))
    assert torch.equal(got, pair_hist.fixed_to_f32(raw, scale or pair_hist.group_scale(w, n)))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("weights", ["fractional", "negative", "many-decades"])
def test_fixed_point_route_k5_plan(cuda, weights, scaled):
    """K5's plan (b-anchored groups of 8, short groups padded) on the
    fixed-point route: raw and converted sums bitwise equal to the plain
    version's and K1's on the same pairs, two calls bitwise equal."""
    p, n = 13, 300_003
    ix = _fixed_rows(p, n, 256, seed=5).to(cuda)
    w = _fixed_weights(weights, n, seed=6).to(cuda)
    pa, pb = _pairs(p, cuda)
    plan = [torch.from_numpy(x).to(cuda) for x in pair_hist.group_pairs(list(zip(pa.tolist(), pb.tolist())))]
    scale = (2.0 * w.abs().max(), 2 * n) if scaled else None
    for raw in (True, False):
        got = pair_hist.pair_histograms_grouped(ix, w, *plan, scale=scale, raw=raw)
        assert torch.equal(got, pair_hist.pair_histograms_grouped_plain(ix, w, *plan, scale=scale, raw=raw))
        assert torch.equal(got, pair_hist.pair_histograms_grouped(ix, w, *plan, scale=scale, raw=raw))
        assert torch.equal(got, pair_hist.pair_histograms(ix, w, pa, pb, scale=scale, raw=raw))


def test_fixed_point_refused_launch_raises(cuda):
    """A launch the card refuses raises (no fallback to another kernel or
    the plain version), and the card goes on: 65,536 pairs put the grid's
    y dimension past its limit (the wrappers refuse more than 65,535 before
    launching, so the entry point is called directly)."""
    from getdist_tpu_torch.ops import _cuda

    k, n, nbins = 65_536, 64, 16
    ix = torch.zeros((2, n), dtype=torch.uint8, device=cuda)
    w = torch.rand(n, device=cuda)
    pa = torch.zeros(k, dtype=torch.int32, device=cuda)
    pb = torch.ones(k, dtype=torch.int32, device=cuda)
    wmax = w.abs().max().reshape(1)
    out = torch.empty((k, nbins, nbins), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="pair_hist_uint8_launch failed with cudaError_t"):
        _cuda.call("pair_hist_uint8_launch", cuda, ix.data_ptr(), 2, w.data_ptr(), 4, pa.data_ptr(), pb.data_ptr(),
                   0, 0, n, k, nbins, 1, 0, wmax.data_ptr(), n, 0, 0, out.data_ptr())
    torch.cuda.synchronize()
    got = pair_hist.pair_histograms(ix, w, pa[:3].contiguous(), pb[:3].contiguous(), nbins=nbins)
    assert torch.equal(got, pair_hist.pair_histograms_plain(ix, w, pa[:3], pb[:3], nbins=nbins))


# K1's uint8 kernel: (P, N, nbins, route). "whole": the two blocks of a
# pair each write their half of its f32 histogram; "split": few pairs, the
# samples split over several chunks per pair (global-atomic flush). N odd
# or N % 16 != 0 puts the column starts off 16-byte boundaries; at 200 bins
# the indices 200..255 are dropped.
UINT8_CASES = {
    "whole-30-odd-n": (30, 100_003, 256, "whole"),
    "whole-30-200bins": (30, 20_008, 200, "whole"),
    "split-6-odd-n": (6, 200_003, 256, "split"),
    "split-9-200bins": (9, 200_008, 200, "split"),
}


def _spread_indices(p, n, seed):
    """uint8 indices over all of 0..255, Gaussian-piled in the middle."""
    x = np.random.default_rng(seed).standard_normal((p, n))
    return np.clip(x * 60 + 128, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("int8_weights", [True, False], ids=["int32", "f32-integer-valued"])
@pytest.mark.parametrize("case", list(UINT8_CASES))
def test_pair_histograms_uint8_routes_bit_exact(cuda, case, int8_weights):
    p, n, nbins, route = UINT8_CASES[case]
    ix = torch.from_numpy(_spread_indices(p, n, seed=13)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(14).integers(1, 5, n).astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    n_split = pair_hist.split_plan(pa.shape[0], n, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (n_split == 1) == (route == "whole")
    before = pair_hist.pair_histograms.launches
    got = pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=int8_weights, nbins=nbins)
    assert pair_hist.pair_histograms.launches == before + 1
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True, nbins=nbins)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if nbins < 256:
        assert float(got.double().sum()) < float(w.double().sum()) * pa.shape[0]  # dropped indices


@pytest.mark.parametrize("n", [100_003, 300_001], ids=["whole", "split"])
def test_pair_histograms_skewed_chain_bit_exact(cuda, n):
    """Most samples in one bin, weights up to 127: that bin passes 2^16 (and
    stays below f32's 2^24), in both weight modes."""
    p = 6
    rng = np.random.default_rng(15)
    ix = _spread_indices(p, n, seed=16)
    ix[:, rng.random(n) < 0.9] = 131
    ix = torch.from_numpy(ix).to(cuda)
    w = torch.from_numpy(rng.integers(0, 128, n).astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True)
    assert float(want.max()) > 2**16
    for mode in (True, False):
        torch.testing.assert_close(pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=mode), want, rtol=0, atol=0)


def test_pair_histograms_weight_types(cuda):
    """uint8 weights (integer weights read at a quarter of the f32 stream,
    as narrow_weights makes them) equal the same f32 integer weights;
    integer weights past 255 stay f32 and exact."""
    p, n = 7, 60_001
    ix = torch.from_numpy(_spread_indices(p, n, seed=22)).to(cuda)
    rng = np.random.default_rng(23)
    pa, pb = _pairs(p, cuda)
    small = torch.from_numpy(rng.integers(0, 256, n).astype(np.float32)).to(cuda)
    want = pair_hist.pair_histograms_plain(ix, small, pa, pb, integer_weights=True)
    narrowed = pair_hist.narrow_weights(small)
    assert narrowed.dtype == torch.uint8
    for w in (small, narrowed):
        torch.testing.assert_close(pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=True), want, rtol=0, atol=0)
    torch.testing.assert_close(pair_hist.pair_histograms_grouped(
        ix, narrowed, *(torch.from_numpy(x).to(cuda) for x in pair_hist.group_pairs(list(zip(pa.tolist(), pb.tolist())))),
        int8_weights=True), want, rtol=0, atol=0)
    large = torch.from_numpy(rng.integers(0, 3000, n).astype(np.float32)).to(cuda)
    assert pair_hist.narrow_weights(large) is large
    want = pair_hist.pair_histograms_plain(ix, large, pa, pb, integer_weights=True)
    torch.testing.assert_close(pair_hist.pair_histograms(ix, large, pa, pb, integer_weights=True), want, rtol=0, atol=0)


def test_uint8_kernel_checks_indices_after_its_launch(cuda):
    """The uint8 route reads its checks back after the launch (the kernel
    clamps pair indices): a bad pair still raises, and the card goes on."""
    p, n = 4, 5_000
    ix = torch.from_numpy(_spread_indices(p, n, seed=24)).to(cuda)
    w = torch.ones(n, device=cuda)
    bad = torch.tensor([0, 7], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="pair indices"):
        pair_hist.pair_histograms(ix, w, bad, bad.flip(0))
    pairs = [(0, 1), (2, 3)]
    grp_a, grp_b, inv = (torch.from_numpy(x).to(cuda) for x in pair_hist.group_pairs(pairs))
    with pytest.raises(ValueError, match="group parameter indices"):
        pair_hist.pair_histograms_grouped(ix, w, grp_a + 9, grp_b, inv)
    pa, pb = _pairs(p, cuda)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb)
    torch.testing.assert_close(pair_hist.pair_histograms(ix, w, pa, pb), want, rtol=0, atol=0)


def test_pair_histograms_wide_rows_take_the_slab_kernel(cuda):
    """K1's entry on int16 rows past 256 bins (parity's wide fine grids, with
    indices past the grid, which are dropped) takes the wide kernels."""
    p, n, nbins = 5, 50_001, 512
    ix = np.clip(np.random.default_rng(17).standard_normal((p, n)) * 90 + 256, 0, 600).astype(np.int16)
    ix = torch.from_numpy(ix).to(cuda)
    w = torch.from_numpy(np.random.default_rng(18).integers(1, 5, n).astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    before = (pair_hist.pair_histograms.launches, pair_hist.pair_histograms.wide_launches)
    got = pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=True, nbins=nbins)
    assert (pair_hist.pair_histograms.launches, pair_hist.pair_histograms.wide_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, pair_hist.pair_histograms_plain(ix, w, pa, pb, True, nbins), rtol=0, atol=0)


# (pad, I, m, offset, out_size): the fused 'same' convolution, its 'valid'
# extended-mask convolution (batched.py conv_valid_ext), ragged supports,
# odd sizes (element-wise copies, unpaired stores), parity's frame 512
GEOMETRIES = {
    "same-384": (384, 256, 61, 30, 256),
    "valid-ext-384": (384, 316, 61, 60, 256),
    "ragged-128": (128, 48, 13, 6, 48),
    "ragged-384": (384, 200, 37, 18, 200),
    "odd-384": (384, 201, 37, 17, 199),
    "parity-512": (512, 256, 69, 34, 256),
}
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}  # of the largest reference value


def _conv_inputs(k, in_size, m, dtype, device, seed):
    rng = np.random.RandomState(seed)
    grids = torch.from_numpy(rng.rand(k, in_size, in_size) * 50).to(device, dtype)
    kernels = torch.from_numpy(rng.rand(k, m, m)).to(device, dtype)
    return grids, kernels


def _check_dft_conv(grids, kernels, out_size, offset, pad, tol):
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    for got, want in ((ur, ur0), (ui, ui0)):
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))
    out = dft_conv.dft_conv2d(grids, ur, ui, out_size, offset, pad)
    want = dft_conv.dft_conv2d_plain(grids, ur0, ui0, out_size, offset, pad)
    torch.testing.assert_close(out, want, rtol=0, atol=tol * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_dft_conv_kernels_match_plain(cuda, geometry, dtype):
    pad, in_size, m, offset, out_size = GEOMETRIES[geometry]
    grids, kernels = _conv_inputs(5, in_size, m, dtype, cuda, seed=4)
    _check_dft_conv(grids, kernels, out_size, offset, pad, TOL[dtype])


def test_dft_conv_f32_production_frame_within_1e5(cuda):
    """3xTF32 at the fused path's frame keeps f32 accuracy: within 1e-5 of
    the largest value (one TF32 pass keeps about three digits and fails)."""
    pad, in_size, m, offset, out_size = GEOMETRIES["same-384"]
    grids, kernels = _conv_inputs(8, in_size, m, torch.float32, cuda, seed=5)
    _check_dft_conv(grids, kernels, out_size, offset, pad, 1e-5)


def test_dft_conv_calls_bitwise_equal(cuda):
    """No atomics, no split-K: two calls on the same inputs agree bit for bit."""
    for dtype in (torch.float32, torch.float64):
        grids, kernels = _conv_inputs(6, 256, 61, dtype, cuda, seed=6)
        runs = []
        for _ in range(2):
            ur, ui = dft_conv.dft_conv_spectrum(kernels, 384)
            runs.append((ur, ui, dft_conv.dft_conv2d(grids, ur, ui, 256, 30, 384)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


# (pad, I, m, offset, out_size): the bounded chain's f32 shapes (the clamped
# rescue's 508-wide 'valid' convolution at 768 with 253^2 kernels, the
# 316-wide ones at 384), and odd kernel and input widths beside them (element
# copies of the data operand, ragged tiles and depths)
BOUNDED_F32 = {
    "rescue-768": (768, 508, 253, 252, 256),
    "ext316-384": (384, 316, 61, 60, 256),
    "odd-768": (768, 507, 251, 250, 255),
    "odd-384": (384, 315, 63, 61, 253),
}


@pytest.mark.parametrize("geometry", list(BOUNDED_F32))
def test_dft_conv_f32_bounded_shapes_within_1e5(cuda, geometry):
    """The wgmma route at the bounded chain's shapes: K2 and K3 within 1e-5
    of the largest value of the plain versions."""
    pad, in_size, m, offset, out_size = BOUNDED_F32[geometry]
    grids, kernels = _conv_inputs(3, in_size, m, torch.float32, cuda, seed=12)
    _check_dft_conv(grids, kernels, out_size, offset, pad, 1e-5)


def test_dft_conv_f32_frame768_calls_bitwise_equal(cuda):
    """One summation order per output element at the rescue's frame: two
    calls give the same bits."""
    pad, in_size, m, offset, out_size = BOUNDED_F32["rescue-768"]
    grids, kernels = _conv_inputs(4, in_size, m, torch.float32, cuda, seed=13)
    runs = []
    for _ in range(2):
        ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
        runs.append((ur, ui, dft_conv.dft_conv2d(grids, ur, ui, out_size, offset, pad)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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


def _k4_stack(k, n, seed, device):
    """uint8 index rows shaped like parity's sheared stacks: max(1, k // 4)
    lead rows that the pairs' a sides repeat (in no order), and one residual
    row per pair as its b side."""
    g = torch.Generator(device=device).manual_seed(seed)
    leads = max(1, k // 4)
    ix = (torch.randn((leads + k, n), generator=g, device=device) * 45 + 128).clamp(0, 255).to(torch.uint8)
    pa = torch.randint(0, leads, (k,), generator=g, device=device, dtype=torch.int32)
    pb = (leads + torch.randperm(k, generator=g, device=device)).to(torch.int32)
    w = torch.randint(1, 5, (n,), generator=g, device=device).to(torch.float32)
    return ix, w, pa, pb


@pytest.mark.parametrize("weights", ["uint8", "f32-integer", "f32-fractional"])
@pytest.mark.parametrize("n", [200_003, 1_000_000], ids=["misaligned", "aligned"])
@pytest.mark.parametrize("k", [1, 5, 66, 112, 133])
def test_dynamic_pairs_uint8_rows(cuda, k, n, weights):
    """K4 on uint8 rows (the uint8 kernel) against the plain version: split
    route (k < 66) and one chunk a pair, columns off and on 16-byte
    boundaries, each weight type. Integer weights bit-exact; fractional ones to 1e-5 (fixed
    point against the plain version's f64 sums, each rounded once)."""
    ix, w, pa, pb = _k4_stack(k, n, seed=k, device=cuda)
    integer = weights != "f32-fractional"
    w_in = {"uint8": pair_hist.narrow_weights(w), "f32-integer": w, "f32-fractional": w * 0.37}[weights]
    assert (w_in.dtype == torch.uint8) == (weights == "uint8")
    before = pair_hist.pair_histograms_dynamic.launches
    got = pair_hist.pair_histograms_dynamic(ix, w_in, pa, pb, integer_weights=integer)
    assert pair_hist.pair_histograms_dynamic.launches == before + 1
    want = pair_hist.pair_histograms_plain(ix, w_in, pa, pb, integer_weights=integer)
    tol = 0 if integer else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [7, 70], ids=["split", "whole"])
def test_dynamic_pairs_uint8_rows_200_bins(cuda, k):
    """uint8 rows over 0..255 at 200 bins: indices 200..255 are dropped."""
    n = 200_003
    ix, w, pa, pb = _k4_stack(k, n, seed=40 + k, device=cuda)
    ix = ((ix.to(torch.int32) - 128) * 2 + 128).clamp(0, 255).to(torch.uint8)
    w8 = pair_hist.narrow_weights(w)
    got = pair_hist.pair_histograms_dynamic(ix, w8, pa, pb, integer_weights=True, nbins=200)
    want = pair_hist.pair_histograms_plain(ix, w8, pa, pb, integer_weights=True, nbins=200)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got.double().sum()) < float(w.double().sum()) * k


def test_dynamic_pairs_int16_rows_drop_out_of_range(cuda, monkeypatch):
    """int16 rows at 256 bins (rows that hold indices outside [0, 256), which
    no narrowing to uint8 may wrap into range) take the wide kernels, which
    drop those indices: both routes, f32 and uint8 integer weights."""
    n = 200_003
    ix, w, pa, pb = _k4_stack(9, n, seed=50, device=cuda)
    wide = ix.to(torch.int16) * 2 - 20  # -20 .. 490
    assert pair_hist.narrow_rows(wide, 256).dtype == torch.int16
    want = pair_hist.pair_histograms_plain(wide, w, pa, pb, integer_weights=True)
    assert float(want.double().sum()) < float(w.double().sum()) * pa.shape[0]
    for route in ("direct", "bucket"):
        for w_in in (w, pair_hist.narrow_weights(w)):
            with _forced_route(monkeypatch, route):
                before = (pair_hist.pair_histograms_dynamic.launches, pair_hist.pair_histograms_dynamic.wide_launches)
                got = pair_hist.pair_histograms_dynamic(wide, w_in, pa, pb, integer_weights=True)
            after = (pair_hist.pair_histograms_dynamic.launches, pair_hist.pair_histograms_dynamic.wide_launches)
            assert after == (before[0] + 1, before[1] + 1)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dynamic_pairs_checked_after_the_launch(cuda):
    """K4 on uint8 rows reads its pair checks back after the launch (the
    kernel clamps its rows): a bad pair raises, and the card goes on."""
    ix, w, pa, pb = _k4_stack(5, 50_000, seed=60, device=cuda)
    bad = pb.clone()
    bad[2] = ix.shape[0] + 3
    with pytest.raises(ValueError, match="pair indices"):
        pair_hist.pair_histograms_dynamic(ix, w, pa, bad, integer_weights=True)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True)
    torch.testing.assert_close(pair_hist.pair_histograms_dynamic(ix, w, pa, pb, True), want, rtol=0, atol=0)


@contextlib.contextmanager
def _forced_route(monkeypatch, route, **fields):
    """pair_hist.wide_plan with its route (and any other fields) forced."""
    plan = pair_hist.wide_plan
    with monkeypatch.context() as m:
        m.setattr(pair_hist, "wide_plan", lambda *args: plan(*args)._replace(route=route, **fields))
        yield


def _wide_stack(p, n, nbins, seed, device):
    """int16 rows of p columns correlated at 0.9 on one latent, over the
    grid's middle, and integer weights 1..4."""
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(n, generator=g, device=device)
    x = 0.95 * z + 0.31 * torch.randn((p, n), generator=g, device=device)
    ix = (x * nbins / 10 + nbins / 2).round().clamp(0, nbins - 1).to(torch.int16)
    return ix, torch.randint(1, 5, (n,), generator=g, device=device).to(torch.float32)


@pytest.mark.parametrize("weights", ["uint8", "f32-integer", "f32-fractional"])
@pytest.mark.parametrize("n", [1_000_003, 200_003])
@pytest.mark.parametrize("k", [1, 10, 26])
@pytest.mark.parametrize("nbins", [257, 384, 576, 960, 1024])
def test_wide_kernels_bit_exact(cuda, monkeypatch, nbins, k, n, weights):
    """The wide kernels against the plain version, by both routes and by the
    route rule: K of the pairs of 2, 5 or 8 int16 columns, N odd (columns
    off 16-byte boundaries). Integer weights (uint8, or f32 with int32
    accumulation) and fractional f32 weights (64-bit fixed point on both
    sides, as on the uint8 kernel) bit-exact."""
    p = {1: 2, 10: 5, 26: 8}[k]
    ix, w = _wide_stack(p, n, nbins, seed=nbins + k, device=cuda)
    pa, pb = (x[:k].contiguous() for x in _pairs(p, cuda))
    integer = weights != "f32-fractional"
    w_in = {"uint8": pair_hist.narrow_weights(w), "f32-integer": w, "f32-fractional": w * 0.37}[weights]
    want = pair_hist.pair_histograms_plain(ix, w_in, pa, pb, integer_weights=integer, nbins=nbins)
    for route in ("direct", "bucket", None):
        if route is None:
            got = pair_hist.pair_histograms(ix, w_in, pa, pb, integer_weights=integer, nbins=nbins)
        else:
            with _forced_route(monkeypatch, route):
                got = pair_hist.pair_histograms(ix, w_in, pa, pb, integer_weights=integer, nbins=nbins)
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"route {route}")


def _f64_sums(ix, w, pa, pb, nbins):
    """Per pair, the f64 sums of the weights by (b, a) bin, on the host."""
    ix, w = ix.cpu().long(), w.cpu().double()
    return torch.stack([
        torch.bincount(ix[b] * nbins + ix[a], weights=w, minlength=nbins * nbins).view(nbins, nbins)
        for a, b in zip(pa.tolist(), pb.tolist())
    ])


@pytest.mark.parametrize("route", ["direct", "bucket"])
@pytest.mark.parametrize("nbins", [384, 960])
def test_wide_kernels_fractional_weights_same_bits(cuda, monkeypatch, nbins, route):
    """ROADMAP C13 (b): the wide kernels add fractional weights (like
    weights over 26 decades) in 64-bit fixed point: two calls bitwise
    equal, equal to the plain version bit for bit, each bin within one f32
    rounding of the f64 sum (the sum rounded to f64 first: 2^-53 of it)
    plus the weights' own rounding (half a multiple of 2^-62 of max |w| * N
    each, at most 2^-62 * max |w| * N a sample in the bin)."""
    p, n = 5, 300_001
    ix, _ = _wide_stack(p, n, nbins, seed=nbins + 3, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(nbins)
    like = torch.exp(-0.5 * 120 * torch.rand(n, generator=g, device=cuda))
    pa, pb = _pairs(p, cuda)
    with _forced_route(monkeypatch, route):
        before = pair_hist.pair_histograms.float_launches
        first = pair_hist.pair_histograms(ix, like, pa, pb, nbins=nbins)
        again = pair_hist.pair_histograms(ix, like, pa, pb, nbins=nbins)
        assert pair_hist.pair_histograms.float_launches == before + 2
    assert torch.equal(first, again)
    torch.testing.assert_close(first, pair_hist.pair_histograms_plain(ix, like, pa, pb, nbins=nbins), rtol=0, atol=0)
    exact = _f64_sums(ix, like, pa, pb, nbins)
    counts = _f64_sums(ix, torch.ones_like(like), pa, pb, nbins)
    got = first.cpu().double()
    ulp = torch.from_numpy(np.spacing(exact.abs().float().numpy()).astype(np.float64))
    floor = 2.0**-53 * exact.abs() + counts * 2.0**-62 * float(like.max()) * n
    assert bool(((got - exact).abs() <= 0.5 * ulp + floor).all())


def test_fixed_to_f32_kernel_matches_twin(cuda):
    """The conversion kernel of raw fixed-point sums gives its torch twin's
    bits (the sharded paths convert all-reduced sums with it)."""
    acc = torch.from_numpy(np.random.default_rng(6).integers(-(2**62), 2**62, 1_000_003, dtype=np.int64))
    wmax, count = torch.tensor(2.5), 987_654
    before = pair_hist.fixed_to_f32.launches
    got = pair_hist.fixed_to_f32(acc.to(cuda), (wmax.to(cuda), count))
    assert pair_hist.fixed_to_f32.launches == before + 1
    assert torch.equal(got.cpu(), pair_hist.fixed_to_f32(acc, (wmax, count)))


@pytest.mark.parametrize("kind", ["K1-whole", "K1-split", "K4-wide-direct", "K4-wide-bucket", "K5"])
def test_raw_block_sums_equal_one_call(cuda, monkeypatch, kind):
    """ROADMAP C13 (a): four blocks of a chain binned raw on the whole
    chain's scale, summed as int64 and converted once, give the bits of one
    call on the whole chain (what W ranks all-reduce), on every route."""
    p, n = 6, 400_003
    nbins = 576 if kind.startswith("K4-wide") else 256
    if nbins == 256:
        ix = torch.from_numpy(_spread_indices(p, n, seed=11)).to(cuda)
    else:
        ix, _ = _wide_stack(p, n, nbins, seed=11, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    like = torch.exp(-0.5 * 60 * torch.rand(n, generator=g, device=cuda))
    pa, pb = _pairs(p, cuda)
    if kind == "K1-split":
        monkeypatch.setattr(pair_hist, "split_plan", lambda k, n, sms, parts=2: 3)
    wide = kind.startswith("K4-wide")
    route = _forced_route(monkeypatch, kind.rsplit("-", 1)[1]) if wide else contextlib.nullcontext()
    if kind == "K5":
        plan = [torch.from_numpy(x).to(cuda) for x in pair_hist.group_pairs(list(zip(pa.tolist(), pb.tolist())))]

        def run(rows, w, **kw):
            return pair_hist.pair_histograms_grouped(rows, w, *plan, **kw)
    else:
        entry = pair_hist.pair_histograms_dynamic if kind.startswith("K4") else pair_hist.pair_histograms

        def run(rows, w, **kw):
            return entry(rows, w, pa, pb, nbins=nbins, **kw)

    with route:
        whole = run(ix, like)
        scale = pair_hist.group_scale(like, n)
        total = torch.zeros_like(whole, dtype=torch.int64)
        for block in torch.arange(n, device=cuda).tensor_split(4):
            total += run(ix[:, block].contiguous(), like[block].contiguous(), scale=scale, raw=True)
    assert torch.equal(pair_hist.fixed_to_f32(total, scale), whole)


def test_wide_kernels_check_pairs_after_the_launch(cuda, monkeypatch):
    """The wide kernels clamp their pair indices and the wrapper reads them
    back after the launch: a bad pair raises on both routes, and the card
    goes on."""
    ix, w = _wide_stack(4, 100_003, 960, seed=3, device=cuda)
    pa, pb = _pairs(4, cuda)
    bad = pb.clone()
    bad[1] = 9
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True, nbins=960)
    for route in ("direct", "bucket"):
        with _forced_route(monkeypatch, route):
            with pytest.raises(ValueError, match="pair indices"):
                pair_hist.pair_histograms(ix, w, pa, bad, integer_weights=True, nbins=960)
            with pytest.raises(ValueError, match="pair indices"):
                pair_hist.pair_histograms_dynamic(ix, w, pa - 1, pb, integer_weights=True, nbins=960)
            got = pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=True, nbins=960)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("weights", ["uint8", "f32-fractional"])
def test_wide_bucket_splits_a_skewed_slab_exactly(cuda, weights):
    """90% of the samples in one slab: the bucket route splits that slab's
    segment over several blocks, which flush into its accumulator slab, the
    last writing the rows; integer weights stay bit-exact."""
    nbins, n, p = 960, 1_000_000, 4
    ix, w = _wide_stack(p, n, nbins, seed=7, device=cuda)
    plan = pair_hist.wide_plan(6, n, nbins, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.route == "bucket" and 0.9 * n > 2 * plan.part
    g = torch.Generator(device=cuda).manual_seed(8)
    crowd = torch.rand(n, generator=g, device=cuda) < 0.9
    row0 = 5 * plan.rows
    ix[:, crowd] = (row0 + torch.randint(0, plan.rows, (p, int(crowd.sum())), generator=g, device=cuda)).to(torch.int16)
    pa, pb = _pairs(p, cuda)
    integer = weights == "uint8"
    w_in = pair_hist.narrow_weights(w) if integer else w * 0.37
    want = pair_hist.pair_histograms_plain(ix, w_in, pa, pb, integer_weights=integer, nbins=nbins)
    got = pair_hist.pair_histograms(ix, w_in, pa, pb, integer_weights=integer, nbins=nbins)
    assert float(want[:, row0 : row0 + plan.rows].double().sum()) >= 0.9 * float(want.double().sum())
    tol = 0 if integer else 1e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.max()))


@pytest.mark.parametrize("pad,k", [(768, 3), (1152, 2)])
def test_dft_conv_kernels_f64_match_plain(cuda, pad, k):
    """Wide f64 frames (parity mode's larger groups and windows)."""
    rng = np.random.RandomState(6)
    n, m, offset = 452, 197, 196
    grids = torch.from_numpy(rng.rand(k, n, n) * 50).to(cuda)
    kernels = torch.from_numpy(rng.rand(k, m, m)).to(cuda)
    _check_dft_conv(grids, kernels, 256, offset, pad, 1e-12)


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
    before = (dft_conv.dft_conv_spectrum.launches, dft_conv.dft_conv2d.launches)
    # two pairs' scratch a launch: 5 pairs in 3 launches
    monkeypatch.setattr(dft_conv, "SCRATCH_BYTES", 2 * dft_conv.spectrum_scratch(384, 37) * 8)
    ur2, ui2 = dft_conv.dft_conv_spectrum(kernels, 384)
    monkeypatch.setattr(dft_conv, "SCRATCH_BYTES", 2 * dft_conv.conv_scratch(384, 200, 200) * 8)
    got = dft_conv.dft_conv2d(grids, ur2, ui2, 200, 18, 384)
    assert (dft_conv.dft_conv_spectrum.launches - before[0], dft_conv.dft_conv2d.launches - before[1]) == (3, 3)
    torch.testing.assert_close(ur2, ur, rtol=0, atol=0)
    torch.testing.assert_close(ui2, ui, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("int8_weights", [True, False], ids=["int32", "f32-integer-valued"])
def test_grouped_pair_histograms_bit_exact(cuda, int8_weights):
    """K5 at 30 parameters (68 groups of 8, short groups padded) against its
    plain version and against K1 on the same rows."""
    p, n = 30, 20_000
    ix = torch.from_numpy(_indices(p, n, seed=9)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(10).integers(1, 5, n).astype(np.float32)).to(cuda)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    plan = [torch.from_numpy(x).to(cuda) for x in pair_hist.group_pairs(pairs)]
    before = pair_hist.pair_histograms_grouped.launches
    got = pair_hist.pair_histograms_grouped(ix, w, *plan, int8_weights=int8_weights)
    assert pair_hist.pair_histograms_grouped.launches == before + 1
    want = pair_hist.pair_histograms_grouped_plain(ix, w, *plan, int8_weights=int8_weights)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    pa, pb = _pairs(p, cuda)
    torch.testing.assert_close(got, pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=int8_weights), rtol=0, atol=0)


@pytest.mark.parametrize("int8_weights", [True, False], ids=["int32", "f32-integer-valued"])
def test_grouped_pair_histograms_short_groups_odd_n(cuda, int8_weights):
    """K5 on 11 parameters (b = 9 and 10 end in short groups, padded with
    a = b slots) at an odd N: equal to K1 and to the plain version, so no
    padding slot reaches the output."""
    p, n = 11, 100_003
    ix = torch.from_numpy(_spread_indices(p, n, seed=19)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(20).integers(1, 5, n).astype(np.float32)).to(cuda)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    plan = [torch.from_numpy(x).to(cuda) for x in pair_hist.group_pairs(pairs)]
    assert int((plan[0] == plan[1][:, None]).sum()) > 0  # the plan has padding slots
    got = pair_hist.pair_histograms_grouped(ix, w, *plan, int8_weights=int8_weights)
    pa, pb = _pairs(p, cuda)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, pair_hist.pair_histograms(ix, w, pa, pb, int8_weights), rtol=0, atol=0)


def test_grouped_wrapper_refuses_repeated_slots(cuda):
    ix = torch.from_numpy(_indices(4, 64, seed=21)).to(cuda)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    grp_a, grp_b, inv = (torch.from_numpy(x).to(cuda) for x in pair_hist.group_pairs(pairs))
    inv[1] = inv[0]
    with pytest.raises(ValueError, match="distinct slots"):
        pair_hist.pair_histograms_grouped(ix, torch.ones(64, device=cuda), grp_a, grp_b, inv)


def test_one_rank_nccl_sharded_pair_hists(cuda, tmp_path):
    """A one-rank NCCL group: the all-reduce of K5's and K4's per-rank
    histograms runs on the card and changes nothing."""
    import torch.distributed as dist

    from getdist_tpu_torch.parallel import init_group, sharded_pair_hists

    p, n = 6, 50_000
    ix = torch.from_numpy(_indices(p, n, seed=11)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(12).integers(1, 5, n).astype(np.float32)).to(cuda)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa, pb = _pairs(p, cuda)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True)
    group = init_group("nccl", 0, 1, init_method=f"file://{tmp_path}/store")
    try:
        before = (pair_hist.pair_histograms_grouped.launches, pair_hist.pair_histograms_dynamic.launches)
        grouped = sharded_pair_hists(group, ix, w, pa.tolist(), pb.tolist(), static_pairs=pairs, int8_weights=True)
        dynamic = sharded_pair_hists(group, ix, w, pa.tolist(), pb.tolist())
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    after = (pair_hist.pair_histograms_grouped.launches, pair_hist.pair_histograms_dynamic.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    torch.testing.assert_close(grouped, want, rtol=0, atol=0)
    torch.testing.assert_close(dynamic, want, rtol=0, atol=0)


# -- the public fused entry (MCSamples.fastTriangleDensities) -----------------


@pytest.mark.parametrize("nbins", [384, 576, 960])
def test_slab_route_at_regrid_grids_bit_exact(cuda, nbins):
    """K1's entry at the regrid reruns' corr-adaptive fine grids: rows
    narrowed to int16 by ``narrow_rows`` take the wide kernels."""
    p, n = 5, 200_003
    x = np.random.default_rng(nbins).standard_normal((p, n))
    ix = np.clip(x * nbins / 8 + nbins / 2, 0, nbins - 1).astype(np.int32)
    ix = pair_hist.narrow_rows(torch.from_numpy(ix).to(cuda), nbins)
    assert ix.dtype == torch.int16
    w = torch.from_numpy(np.random.default_rng(2).integers(1, 5, n).astype(np.float32)).to(cuda)
    pa, pb = _pairs(p, cuda)
    before = (pair_hist.pair_histograms.launches, pair_hist.pair_histograms.wide_launches)
    got = pair_hist.pair_histograms(ix, w, pa, pb, integer_weights=True, nbins=nbins)
    after = (pair_hist.pair_histograms.launches, pair_hist.pair_histograms.wide_launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    want = pair_hist.pair_histograms_plain(ix, w, pa, pb, True, nbins)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got.double().sum()) == float(w.double().sum()) * pa.shape[0]


# (pad, fine, winw): frame_for(fine + 4 winw + 1) of the regrid reruns
# (winw = max(30, fine / 9)) and of the clamped rescue (256 bins, winw 126)
REGRID_FRAMES = {
    "fine384": (640, 384, 43),
    "rescue256": (768, 256, 126),
    "fine576": (896, 576, 64),
    "fine960": (1408, 960, 107),
}


@pytest.mark.parametrize("geometry", ["same", "valid-ext"])
@pytest.mark.parametrize("case", list(REGRID_FRAMES))
def test_dft_conv_f32_regrid_frames_within_1e5(cuda, case, geometry):
    """f32 K2/K3 at the fused entry's larger frames and windows: the 'same'
    convolution of the fine grids and the 'valid' one of the extended
    masks, within 1e-5 of the largest value of an f64 chain on the same
    inputs, and (frames up to 896) of the f32 plain versions. At 1408 the
    f32 plain chain itself sits ~1e-5 from the f64 one on these inputs
    (uniform random kernels of 215^2), so the two f32 results are held to
    each other through the f64 chain."""
    pad, fine, winw = REGRID_FRAMES[case]
    assert dft_conv.frame_for(fine + 4 * winw + 1) == pad
    in_size, offset = (fine, winw) if geometry == "same" else (fine + 2 * winw, 2 * winw)
    grids, kernels = _conv_inputs(3, in_size, 2 * winw + 1, torch.float32, cuda, seed=pad)
    if pad <= 896:
        _check_dft_conv(grids, kernels, fine, offset, pad, 1e-5)
    u64 = dft_conv.dft_conv_spectrum_plain(kernels.double(), pad)
    want = dft_conv.dft_conv2d_plain(grids.double(), *u64, fine, offset, pad)
    got = dft_conv.dft_conv2d(grids, *dft_conv.dft_conv_spectrum(kernels, pad), fine, offset, pad)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_fast_triangle_on_card_matches_cpu(cuda):
    """The public fused entry on the card against the port on the CPU, on
    a 40k x 8 chain that takes the two-program route, a 960-bin regrid
    (K1's wide kernels, a 1408 frame), a sheared f64 assist and, at this
    size, the clamped-window rescue (a 768 frame): the same regrid keys and
    grid sizes, grids within the zoo's 5e-3."""
    from chip_smoke import hard_chain
    from getdist_tpu_torch.mcsamples import MCSamples

    samples, weights = hard_chain(40_000)
    kw = dict(samples=samples, weights=weights, names=[f"h{i}" for i in range(8)])
    before = pair_hist.pair_histograms.wide_launches
    mc = MCSamples(device=cuda, **kw)
    g1, g2, pairs = mc.fastTriangleDensities()
    assert pair_hist.pair_histograms.wide_launches > before
    c1, c2, _ = MCSamples(device="cpu", **kw).fastTriangleDensities()
    assert "program_a" in mc.fast_profile
    kinds = {group["bandwidths"] for group in mc.fast_regrid_groups}
    assert kinds == {"program", "assist", "clamped"}, mc.fast_regrid_groups
    assert set(g2["regrid"]) == set(c2["regrid"]) and (6, 7) in g2["regrid"]
    assert g2["regrid"][(4, 5)]["P"].shape == (960, 960)
    torch.testing.assert_close(g1["P"].cpu(), c1["P"], rtol=0, atol=1e-4)
    for k, key in enumerate(pairs):
        got = g2["regrid"][key]["P"] if key in g2["regrid"] else g2["P"][k]
        want = c2["regrid"][key]["P"] if key in c2["regrid"] else c2["P"][k]
        assert got.shape == want.shape
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=5e-3)


def test_bounded_entry_on_card_matches_cpu(cuda):
    """The public fused entry with meanlikes on a 20k x 6 bounded chain
    (every 10th sample of ``chip_smoke.bounded_chain(200k, 6)``: lower,
    upper and two-sided limits, a periodic column, loglikes) on the card
    against the port on the CPU: K1 ran with f32 like weights once in
    program B and once in each rerun, and K3 on the 316-wide extended grids; the same regrid keys; grids within the
    zoo's 5e-3, 1D and its like curves within 1e-4, the like grids within
    5e-3 (f32 round-off over the density floor, on both sides)."""
    from chip_smoke import bounded_chain
    from getdist_tpu_torch.mcsamples import MCSamples

    s, w, ll, names, ranges = bounded_chain(200_000, p=6, kinds=(1, 1, 1, 1))
    kw = dict(samples=s[::10].copy(), weights=w[::10].copy(), loglikes=ll[::10].copy(), names=names, ranges=ranges)
    float_before = pair_hist.pair_histograms.float_launches
    ext_before = dft_conv.dft_conv2d.inputs.get((384, 316), 0)
    on_card = MCSamples(device=cuda, **kw)
    g1, g2, pairs = on_card.fastTriangleDensities(meanlikes=True)
    # like weights once in program B and once in each rerun
    assert pair_hist.pair_histograms.float_launches == float_before + 1 + len(on_card.fast_regrid_groups)
    assert dft_conv.dft_conv2d.inputs.get((384, 316), 0) >= ext_before + 6
    c1, c2, _ = MCSamples(device="cpu", **kw).fastTriangleDensities(meanlikes=True)
    assert set(g2["regrid"]) == set(c2["regrid"])
    torch.testing.assert_close(g1["P"].cpu(), c1["P"], rtol=0, atol=1e-4)
    torch.testing.assert_close(g1["likes"].cpu(), c1["likes"], rtol=0, atol=1e-4)
    torch.testing.assert_close(g2["likes"].cpu(), c2["likes"], rtol=0, atol=5e-3)
    for k, key in enumerate(pairs):
        got = g2["regrid"][key]["P"] if key in g2["regrid"] else g2["P"][k]
        want = c2["regrid"][key]["P"] if key in c2["regrid"] else c2["P"][k]
        assert got.shape == want.shape
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=5e-3)


# -- parity with periodic parameters, the host variant, sharded limits -------


def _periodic_parity_chain(n, weights):
    """A correlated pair, a column limited at 0 and two periodic ones; integer
    or fractional (importance) weights."""
    rng = np.random.RandomState(21)
    z = rng.standard_normal((n, 5))
    s = z.copy()
    s[:, 1] = 0.7 * z[:, 0] + 0.71 * z[:, 1]
    s[:, 2] = np.abs(z[:, 2])
    s[:, 3] = np.mod(1.2 * z[:, 3] + np.pi, 2 * np.pi)
    s[:, 4] = np.mod(0.5 * z[:, 4] + 0.4 * z[:, 3], 2.0)
    w = rng.randint(1, 4, n).astype(np.float64) if weights == "integer" else np.exp(-0.5 * rng.uniform(0, 3, n))
    return dict(samples=s, weights=w, names=list("abcde"),
                ranges={"c": [0, None], "d": [0, 2 * np.pi, True], "e": [0, 2.0, True]})


@pytest.mark.parametrize("device_mode", [True, False], ids=["device", "host"])
def test_periodic_parity_on_card_matches_cpu(cuda, device_mode):
    """Device parity with periodic parameters (integer weights) and the host
    variant (fractional weights) on the card against the port on the CPU:
    f64 K3 ran on the periodically extended (256 + 2 winw)^2 grids; 2D
    within 1e-5 of the peak, 1D within 1e-10."""
    from getdist_tpu_torch.mcsamples import MCSamples

    kwargs = _periodic_parity_chain(20_000, "integer" if device_mode else "fractional")
    before = dict(dft_conv.dft_conv2d.inputs)
    mc = MCSamples(device=cuda, **kwargs)
    g1, g2 = mc.fastParityDensities(device=device_mode)
    extended = {256 + 2 * b["winw"] for b in mc.parity_buckets}
    ran = {size for (_pad, size), count in dft_conv.dft_conv2d.inputs.items() if count > before.get((_pad, size), 0)}
    assert extended & ran, (extended, ran)
    c1, c2 = MCSamples(device="cpu", **kwargs).fastParityDensities(device=device_mode)
    assert set(g2) == set(c2) and set(g1) == set(c1)
    for key in c1:
        assert np.abs(g1[key].P - c1[key].P).max() <= 1e-10, key
    for key in c2:
        got, want = g2[key].P, c2[key].P
        assert np.abs(got / got.max() - want / want.max()).max() <= 1e-5, key


@pytest.mark.parametrize("winw", [34, 66, 126])
def test_dft_conv_f64_on_periodic_extension_matches_plain(cuda, winw):
    """f64 K3 'valid' on (256 + 2 winw)^2 periodically extended histograms
    (parity's periodic buckets) within 1e-12 of the largest value, two
    calls bitwise equal."""
    rng = np.random.RandomState(winw)
    k = 4
    hists = torch.from_numpy(rng.poisson(20.0, (k, 256, 256)).astype(np.float64)).to(cuda)
    per = torch.tensor([True, False, True, True], device=cuda)
    ext = batched._extend_periodic(hists, per, per.roll(1), winw)
    assert tuple(ext.shape) == (k, 256 + 2 * winw, 256 + 2 * winw)
    widths = torch.linspace(0.8, winw / 2.5, k, dtype=torch.float64, device=cuda)
    kernels = batched._gauss_kernel_2d(widths, widths.flip(0), torch.full_like(widths, 0.3), winw)
    pad = dft_conv.frame_for(256 + 4 * winw + 1)
    _check_dft_conv(ext, kernels, 256, 2 * winw, pad, 1e-12)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    assert torch.equal(dft_conv.dft_conv2d(ext, ur, ui, 256, 2 * winw, pad),
                       dft_conv.dft_conv2d(ext, ur, ui, 256, 2 * winw, pad))


# (pad, I, m, offset, out_size, pairs): every f64 shape the paths run. Bounded
# parity's five buckets, (256 + 2 winw)^2 periodic extensions sliced at 2 winw
# with (2 winw + 1)^2 kernels at their pair counts; the meanlikes run's
# like-weighted smoothing at 384 and at the clamped rescue's 768; an odd grid
# width and slice beside them (element copies, ragged tiles)
F64_SHAPES = {
    "bucket37-384": (384, 292, 37, 36, 256, 15),
    "bucket69-512": (512, 324, 69, 68, 256, 310),
    "bucket133-640": (640, 388, 133, 132, 256, 105),
    "bucket197-768": (768, 452, 197, 196, 256, 2),
    "bucket253-768": (768, 508, 253, 252, 256, 3),
    "like-384": (384, 316, 61, 60, 256, 435),
    "like-768": (768, 508, 253, 252, 256, 110),
    "odd-512": (512, 323, 67, 65, 255, 5),
}


@pytest.mark.parametrize("geometry", list(F64_SHAPES))
def test_dft_conv_f64_path_shapes_within_1e12(cuda, geometry):
    """The f64 DMMA route at the paths' shapes: K2 and K3 within 1e-12 of the
    largest value of the plain versions."""
    pad, in_size, m, offset, out_size, k = F64_SHAPES[geometry]
    grids, kernels = _conv_inputs(k, in_size, m, torch.float64, cuda, seed=14)
    _check_dft_conv(grids, kernels, out_size, offset, pad, 1e-12)


def test_dft_conv_f64_frame768_calls_bitwise_equal(cuda):
    """One summation order per output element in f64 too: two calls at the
    768 frame give the same bits."""
    pad, in_size, m, offset, out_size, k = F64_SHAPES["bucket253-768"]
    grids, kernels = _conv_inputs(k, in_size, m, torch.float64, cuda, seed=15)
    runs = []
    for _ in range(2):
        ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
        runs.append((ur, ui, dft_conv.dft_conv2d(grids, ur, ui, out_size, offset, pad)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_one_rank_nccl_bounded_sharded_matches_fused(cuda, tmp_path):
    """``sharded_triangle_densities`` with limits, periodic axes and like
    weights in a one-rank NCCL group against ``triangle_densities`` on the
    same device tensors, at tests/test_parallel.py's tolerances; the like
    curves within 1e-4, the 2D like grids equal."""
    import torch.distributed as dist

    from chip_smoke import bounded_chain, like_weights_of, limit_arrays
    from getdist_tpu_torch.parallel import init_group, shard_samples, shard_values, sharded_triangle_densities

    s, w, ll, names, ranges = bounded_chain(200_000, p=6, kinds=(1, 1, 1, 1))
    lo, hi, per = limit_arrays(names, ranges)
    like = like_weights_of(w, ll)
    kw = dict(limits_lo=lo, limits_hi=hi, periodic=per, int8_weights=True, enable_shear=True)
    group = init_group("nccl", 0, 1, init_method=f"file://{tmp_path}/store")
    try:
        local = shard_samples(group, s, w, device=cuda)
        g1, g2 = sharded_triangle_densities(group, *local, like_weights=shard_values(group, like, cuda),
                                            n_samples=len(s), **kw)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    u1, u2 = batched.triangle_densities(*local, like_weights=like, device=cuda, **kw)
    torch.testing.assert_close(g1["neff"], u1["neff"], rtol=1e-3, atol=0)
    torch.testing.assert_close(g1["P"], u1["P"], rtol=0, atol=1e-5)
    torch.testing.assert_close(g2["P"], u2["P"], rtol=0, atol=3e-5)
    torch.testing.assert_close(g2["contours"], u2["contours"], rtol=1e-3, atol=0)
    torch.testing.assert_close(g1["likes"], u1["likes"], rtol=0, atol=1e-4)
    # K1 adds the like weights in fixed point, order independent, and a
    # one-rank group's all-reduce is the identity: the like grids are equal
    # bit for bit over the whole grid (ROADMAP C13)
    assert torch.equal(g2["likes"], u2["likes"])
    assert torch.equal(g1["active_lo"], u1["active_lo"]) and torch.equal(g1["periodic"], u1["periodic"])


def test_host_api_routes_onto_the_card(cuda, monkeypatch):
    """A CUDA MCSamples serves getMargeStats from one fused program on the
    card (K1, K2 and K3 launched, one cache entry); its limits track the
    host path's (GETDIST_TPU_TORCH_FUSED=0) within 0.05 sd, and a CPU
    object takes the host path."""
    from getdist_tpu_torch import chains
    from getdist_tpu_torch.mcsamples import MCSamples

    monkeypatch.setattr(chains, "print_load_details", False)
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    rng = np.random.default_rng(17)
    n = 40000
    x = rng.normal(size=n)
    chain = dict(samples=np.c_[x, 0.6 * x + 0.8 * rng.normal(size=n), np.abs(rng.normal(size=n))],
                 names=["x", "y", "z"], ranges={"z": [0, None]})
    mc = MCSamples(device="cuda", **chain)
    assert mc._fused_route_enabled() and not MCSamples(device="cpu", **chain)._fused_route_enabled()
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    before = [fn.launches for fn in counters]
    routed = mc.getMargeStats()
    assert all(fn.launches > b for fn, b in zip(counters, before))
    assert list(mc._fused_cache) == [False]
    monkeypatch.setenv("GETDIST_TPU_TORCH_FUSED", "0")
    host = MCSamples(device="cuda", **chain).getMargeStats()
    for name in "xyz":
        p, q = routed.parWithName(name), host.parWithName(name)
        for lim_p, lim_q in zip(p.limits, q.limits):
            assert abs(lim_p.lower - lim_q.lower) < 0.05 * q.err and abs(lim_p.upper - lim_q.upper) < 0.05 * q.err


# -- the device primitives (ops.binning, ops.stats, ops.fft, ops.convolve) on the card against the CPU --


def _both(cuda, *arrays):
    """Each array as a CPU tensor and as a copy on the card."""
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return cpu, [t.to(cuda) for t in cpu]


def test_weighted_bincount_on_card_bitwise(cuda):
    from getdist_tpu_torch.ops import binning

    rng = np.random.default_rng(61)
    ix, iy = rng.integers(0, 64, 500_000), rng.integers(0, 48, 500_000)
    w = rng.integers(1, 9, 500_000).astype(np.float64)
    (c_ix, c_iy, c_w), (g_ix, g_iy, g_w) = _both(cuda, ix, iy, w)
    assert torch.equal(binning.weighted_bincount(g_ix, g_w, 64).cpu(), binning.weighted_bincount(c_ix, c_w, 64))
    assert torch.equal(binning.weighted_bincount_2d(g_ix, g_iy, g_w, 64, 48).cpu(),
                       binning.weighted_bincount_2d(c_ix, c_iy, c_w, 64, 48))
    values = rng.standard_normal(100_000)
    (c_v,), (g_v,) = _both(cuda, values)
    assert torch.equal(binning.bin_indices_1d(g_v, -3.0, 0.01, 600).cpu(), binning.bin_indices_1d(c_v, -3.0, 0.01, 600))


@pytest.mark.parametrize("name", ["weighted_mean", "weighted_var", "weighted_cov", "kde_lag", "kde_lag_2d",
                                  "confidence", "gelman_rubin"])
def test_stats_on_card_match_cpu(cuda, name):
    """f64 statistics on the card within 1e-12 of the CPU's (relative to the
    largest value); the confidence limits equal."""
    from getdist_tpu_torch.ops import stats

    rng = np.random.default_rng(62)
    x = rng.standard_normal((200_000, 6)) @ rng.standard_normal((6, 6))
    w = rng.integers(1, 5, 200_000).astype(np.float64)
    (cx, cw), (gx, gw) = _both(cuda, x, w)
    calls = {
        "weighted_mean": lambda s, v: stats.weighted_mean(s, v),
        "weighted_var": lambda s, v: stats.weighted_var(s, v),
        "weighted_cov": lambda s, v: stats.weighted_cov(s, v),
        "kde_lag": lambda s, v: stats.kde_lag_correlation(s[:, 0].contiguous(), v, 17, 0.3),
        "kde_lag_2d": lambda s, v: stats.kde_lag_correlation_2d(s[:, 0], s[:, 1], v, 5,
                                                                 torch.eye(2, dtype=s.dtype, device=s.device)),
        "confidence": lambda s, v: stats.confidence_bounds(s[:, 2].contiguous(), v,
                                                           torch.tensor([0.025, 0.5, 0.975], dtype=s.dtype)),
        "gelman_rubin": lambda s, v: stats.gelman_rubin_eigenvalues(
            s[:4, :3] * 0.01, torch.stack([stats.weighted_cov(s[i::4, :3], v[i::4]) for i in range(4)]),
            torch.zeros(3, dtype=s.dtype, device=s.device)),
    }
    got, want = calls[name](gx, gw).cpu(), calls[name](cx, cw)
    if name == "confidence":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("name", ["dct2d", "idct2d", "convolveFFT", "convolveFFTn", "periodic_1d", "periodic_both",
                                  "autoConvolve", "gaussDCT", "gaussTrunc"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fft_convolutions_on_card_match_cpu(cuda, name, dtype):
    """cuFFT against the CPU's FFT: f64 within 1e-12 of the largest value,
    f32 within 1e-5."""
    from getdist_tpu_torch.ops import convolve, fft

    rng = np.random.default_rng(63)
    two_d = name in ("dct2d", "idct2d", "convolveFFTn", "periodic_both")
    x = rng.random((300, 257) if two_d else 20_000).astype(dtype)
    k = rng.random((21, 17) if two_d else 41).astype(dtype)
    (cx, ck), (gx, gk) = _both(cuda, x, k)
    calls = {
        "dct2d": lambda a, b: fft.dct2d(a),
        "idct2d": lambda a, b: fft.idct2d(a),
        "convolveFFT": lambda a, b: convolve.convolveFFT(a, b, "same"),
        "convolveFFTn": lambda a, b: convolve.convolveFFTn(a, b, "valid"),
        "periodic_1d": lambda a, b: convolve.convolve1D(a, b, "periodic"),
        "periodic_both": lambda a, b: convolve.convolve2D(a, b, "periodic_both"),
        "autoConvolve": lambda a, b: convolve.autoConvolve(a, n=2000),
        "gaussDCT": lambda a, b: convolve.convolveGaussianDCT(a, 7.5),
        "gaussTrunc": lambda a, b: convolve.convolveGaussianTrunc(a, 3.0, mode="full"),
    }
    got, want = calls[name](gx, gk).cpu(), calls[name](cx, ck)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_device_ops_chain_statistics_on_card(cuda, monkeypatch):
    """GETDIST_TPU_TORCH_DEVICE_OPS=1 on a CUDA MCSamples: means, covariance,
    autocorrelation, N_eff and the confidence limits computed on the card
    (its upload cached there), within 1e-12 / 1e-10 / equal of the host
    path's."""
    from getdist_tpu_torch import chains
    from getdist_tpu_torch.mcsamples import MCSamples

    monkeypatch.setattr(chains, "print_load_details", False)
    monkeypatch.delenv("GETDIST_TPU_TORCH_DEVICE_OPS", raising=False)
    rng = np.random.default_rng(64)
    x = np.cumsum(rng.standard_normal((4, 20_000, 4)) * 0.1, axis=1)
    parts = [x[i] - x[i].mean(0) for i in range(4)]
    weights = [rng.integers(1, 4, 20_000).astype(float) for _ in range(4)]
    kwargs = dict(samples=parts, weights=weights, names=["a", "b", "c", "d"])
    host = MCSamples(device="cpu", **kwargs)
    monkeypatch.setenv("GETDIST_TPU_TORCH_DEVICE_OPS", "1")
    card = MCSamples(device="cuda", **kwargs)
    assert card._device_cache[0].device.type == "cuda"
    np.testing.assert_allclose(card.getMeans(), host.getMeans(), rtol=0, atol=1e-12 * np.abs(host.getMeans()).max())
    np.testing.assert_allclose(card.getCov(), host.getCov(), rtol=0, atol=1e-12 * np.abs(host.getCov()).max())
    curve, want = card.getAutocorrelation(1, maxOff=500), host.getAutocorrelation(1, maxOff=500)
    assert np.abs(curve - want).max() <= 1e-12 * abs(want[0])
    assert card.getEffectiveSamplesGaussianKDE(2) == pytest.approx(host.getEffectiveSamplesGaussianKDE(2), rel=1e-10)
    assert card.getEffectiveSamplesGaussianKDE_2d(0, 3) == pytest.approx(host.getEffectiveSamplesGaussianKDE_2d(0, 3),
                                                                         rel=1e-10)
    np.testing.assert_array_equal(card.twoTailLimits(3, 0.95), host.twoTailLimits(3, 0.95))
    # the N-D histogram through the card's weighted_bincount, on an object
    # whose ranges the host computed: bitwise the host's
    monkeypatch.delenv("GETDIST_TPU_TORCH_DEVICE_OPS")
    plain = MCSamples(device="cuda", **kwargs)
    want_nd = plain.getRawNDDensityGridData(["a", "b", "c"])
    monkeypatch.setenv("GETDIST_TPU_TORCH_DEVICE_OPS", "1")
    np.testing.assert_array_equal(plain.getRawNDDensityGridData(["a", "b", "c"]).P, want_nd.P)


# -- the plots layer's data path (no matplotlib on the card's machine) --


def test_plot_data_layer_routes_onto_the_card(cuda, monkeypatch, tmp_path):
    """The plotter's data layer (``sample_analysis.MCSampleAnalysis``) on a
    small chain root loads it on the card, whose 1D and 2D requests come
    from one fused program (K1, K2 and K3 launched), bitwise equal to the
    routed queries of the object itself; a repeat is served by the
    analyser's cache with no launch."""
    import getdist_tpu_torch
    from getdist_tpu_torch import chains
    from getdist_tpu_torch.sample_analysis import MCSampleAnalysis

    monkeypatch.setattr(chains, "print_load_details", False)
    monkeypatch.setattr(getdist_tpu_torch, "cache_dir", str(tmp_path / "cache"))
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    rng = np.random.default_rng(19)
    n = 40000
    x = rng.normal(size=n)
    table = np.c_[np.ones(n), x * x / 2, x, 0.6 * x + 0.8 * rng.normal(size=n), np.abs(rng.normal(size=n))]
    np.savetxt(tmp_path / "toy_1.txt", table)
    (tmp_path / "toy.paramnames").write_text("x\tx\ny\ty\nz\tz\n")
    (tmp_path / "toy.ranges").write_text("z 0 N\n")
    analyser = MCSampleAnalysis(str(tmp_path), device="cuda")
    mc = analyser.samples_for_root("toy")
    assert mc.device.type == "cuda"
    params = {name: mc.paramNames.parWithName(name) for name in "xyz"}
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    before = [fn.launches for fn in counters]
    dens1 = {name: analyser.get_density("toy", params[name]) for name in "xyz"}
    dens2 = {(a, b): analyser.get_density_grid("toy", params[a], params[b]) for a, b in ("xy", "xz", "yz")}
    assert all(fn.launches > b for fn, b in zip(counters, before)) and list(mc._fused_cache) == [False]
    other = getdist_tpu_torch.loadMCSamples(str(tmp_path / "toy"), ini=analyser.ini, device="cuda")
    for name, got in dens1.items():
        assert np.array_equal(got.P, other.get1DDensityGridData(name).P)
    for (a, b), got in dens2.items():
        want = other.get2DDensityGridData(a, b, num_plot_contours=2)
        assert np.array_equal(got.P, want.P) and np.array_equal(got.contours, want.contours)
    after = [fn.launches for fn in counters]
    assert analyser.get_density_grid("toy", params["x"], params["y"]) is dens2[("x", "y")]
    assert [fn.launches for fn in counters] == after


def test_mixture_samples_on_the_card(cuda):
    from getdist_tpu_torch import chains
    from getdist_tpu_torch.gaussian_mixtures import Gaussian2D

    chains.print_load_details = False
    gauss = Gaussian2D([0, 0], (0.9, 1.1, 0.3))
    on_card = gauss.MCSamples(5000, logLikes=True, random_state=11, names=["x", "y"])
    on_cpu = gauss.MCSamples(5000, logLikes=True, random_state=11, names=["x", "y"], device="cpu")
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    assert np.array_equal(on_card.samples, on_cpu.samples) and np.array_equal(on_card.loglikes, on_cpu.loglikes)


def test_device_timer_waits_for_the_card(cuda):
    from getdist_tpu_torch.utils.profiling import device_timer

    a = torch.randn(2048, 2048, device=cuda)
    with device_timer("matmul", sync_value=a) as holder:
        b = a @ a
        holder["sync"] = b
    assert holder["seconds"] > 0 and torch.isfinite(b).all()


class _NumpyCollection:
    """A Cobaya SampleCollection's surface on numpy columns."""

    def __init__(self, columns):
        self._columns = columns
        self.data = type("Frame", (), {"columns": list(columns), "__iter__": lambda s: iter(s.columns)})()

    def __getitem__(self, key):
        import types

        if isinstance(key, list):
            return types.SimpleNamespace(values=np.column_stack([self._columns[k] for k in key]))
        return types.SimpleNamespace(values=np.asarray(self._columns[key]))


def _launch_counts():
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    return [fn.launches for fn in counters]


def test_cobaya_collections_on_the_card(cuda, monkeypatch):
    """``MCSamplesFromCobaya`` builds its samples on the card by default
    (the same arrays, names and ranges as a CPU build), and their routed
    marginalized statistics come from one fused program (K1, K2 and K3
    launched) with the host statistics' means."""
    from getdist_tpu_torch import chains, cobaya_interface

    monkeypatch.setattr(chains, "print_load_details", False)
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    rng = np.random.default_rng(23)
    info = {"params": {"a": {"prior": {"min": 0, "max": 1}}, "b": {"prior": {"min": 0}},
                       "phi": {"prior": {"min": 0, "max": 6.283185307179586}, "periodic": True},
                       "g": {"prior": {"dist": "norm", "loc": 0, "scale": 1}}, "c": {"derived": True}},
            "likelihood": {"l": None}, "sampler": {"mcmc": {}}}
    collections = []
    for _ in range(2):
        n = 30000
        cols = {"weight": rng.integers(1, 4, n).astype(float), "minuslogpost": rng.random(n), "a": rng.random(n),
                "b": np.abs(rng.normal(size=n)), "phi": rng.random(n) * 6.283185307179586, "g": rng.normal(size=n)}
        cols["c"] = cols["a"] + cols["g"]
        cols.update(minuslogprior=cols["minuslogpost"], minuslogprior__0=cols["minuslogpost"],
                    chi2=cols["minuslogpost"], chi2__l=cols["minuslogpost"])
        collections.append(_NumpyCollection(cols))
    on_card = cobaya_interface.MCSamplesFromCobaya(info, collections)
    on_cpu = cobaya_interface.MCSamplesFromCobaya(info, collections, device="cpu")
    assert on_card.device.type == "cuda"
    for attr in ("samples", "weights", "loglikes"):
        assert np.array_equal(getattr(on_card, attr), getattr(on_cpu, attr))
    assert on_card.paramNames.list() == on_cpu.paramNames.list() and on_card.ranges.periodic == {"phi"}
    before = _launch_counts()
    marge = on_card.getMargeStats()
    assert all(a > b for a, b in zip(_launch_counts(), before)) and list(on_card._fused_cache) == [False]
    assert [p.mean for p in marge.names] == [p.mean for p in on_cpu.getMargeStats().names]


def test_arviz_on_the_card(cuda):
    """``arviz_to_mcsamples`` builds its samples on the card by default, the
    CPU build's arrays, whose routed 2D density is a fused program's."""
    from getdist_tpu_torch.arviz_wrapper import arviz_to_mcsamples

    rng = np.random.default_rng(29)

    class Array:
        def __init__(self, values, dims):
            self.values, self.shape, self.dims, self.coords = values, values.shape, dims, {}

    class Group(dict):
        sizes = {"chain": 4, "draw": 20000}

        @property
        def data_vars(self):
            return list(self)

    class IData:
        def __init__(self, **groups):
            self.__dict__.update(groups)

        def __contains__(self, name):
            return name in self.__dict__

    posterior = Group(mu=Array(rng.normal(size=(4, 20000)), ("chain", "draw")),
                      theta=Array(rng.normal(size=(4, 20000, 2)), ("chain", "draw", "k")))
    stats = Group(w=Array(rng.integers(1, 3, (4, 20000)).astype(float), ("chain", "draw")))
    idata = IData(posterior=posterior, sample_stats=stats)
    on_card = arviz_to_mcsamples(idata, weights_var="w", custom_ranges={"mu": (-10, 10)})
    on_cpu = arviz_to_mcsamples(idata, weights_var="w", custom_ranges={"mu": (-10, 10)}, device="cpu")
    assert on_card.device.type == "cuda" and on_card.paramNames.list() == ["mu", "theta_0", "theta_1"]
    assert np.array_equal(on_card.samples, on_cpu.samples) and np.array_equal(on_card.weights, on_cpu.weights)
    before = _launch_counts()
    dens = on_card.get2DDensityGridData("mu", "theta_0")
    assert dens is not None and all(a > b for a, b in zip(_launch_counts(), before))


def test_gui_session_on_the_card(cuda, monkeypatch, tmp_path):
    """``GuiSession()`` runs on the card by default: its statistics text
    equals the analysis API's on an object loaded with the session's
    settings, its triangle data (through the session's data layer, no
    matplotlib) comes from one fused program, and its scripts say
    ``device='cuda'``."""
    import getdist_tpu_torch
    from getdist_tpu_torch import chains
    from getdist_tpu_torch.gui import app_logic

    monkeypatch.setattr(chains, "print_load_details", False)
    monkeypatch.setattr(getdist_tpu_torch, "cache_dir", str(tmp_path / "cache"))
    monkeypatch.setattr(app_logic, "RECENT_FILE", str(tmp_path / "recent"))
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    rng = np.random.default_rng(31)
    n = 40000
    x = rng.normal(size=n)
    table = np.c_[np.ones(n), x * x / 2, x, 0.6 * x + 0.8 * rng.normal(size=n), np.abs(rng.normal(size=n))]
    np.savetxt(tmp_path / "toy_1.txt", table)
    (tmp_path / "toy.paramnames").write_text("x\tx\ny\ty\nz\tz\n")
    (tmp_path / "toy.ranges").write_text("z 0 N\n")
    session = app_logic.GuiSession()
    assert session.device == "cuda" and session.open_directory(str(tmp_path)) == ["toy"]
    session.add_root("toy")
    api = getdist_tpu_torch.loadMCSamples(str(tmp_path / "toy"), ini=session.analysis().ini, device="cuda")
    assert session.marge_stats("toy") == str(api.getMargeStats())
    assert session.like_stats("toy") == str(api.getLikeStats())
    assert [tex for _, tex in session.param_table_tabs("toy")] == [
        api.getTable(columns=1, limit=i + 1).tableTex() for i in range(3)]
    analysis = session.analysis()
    mc = analysis.samples_for_root("toy")
    assert mc.device.type == "cuda" and list(mc._fused_cache) == [False]
    params = {name: mc.paramNames.parWithName(name) for name in "xyz"}
    for a, b in ("xy", "xz", "yz"):
        got = analysis.get_density_grid("toy", params[a], params[b])
        want = api.get2DDensityGridData(a, b, num_plot_contours=2)
        assert np.array_equal(got.P, want.P) and np.array_equal(got.contours, want.contours)
    assert "device='cuda'" in session.script_for(app_logic.PlotSpec(plot_type="triangle", x_params=["x", "y"]))


def test_span_holds_its_kernels_device_interval(cuda):
    """The recorder's stamps and a CUDA trace's device events share a clock:
    a kernel launched and synchronized inside a span ran inside its
    recorded interval."""
    from torch.profiler import ProfilerActivity, profile

    from getdist_tpu_torch import tracing

    x = torch.randn(4096, 4096, device=cuda)
    (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, tracing.recording() as spans:
        with tracing.span("2d:probe"):
            y = x @ x
            torch.cuda.synchronize()
    (span,) = [s for s in spans if s.name == "2d:probe"]
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("2d:", "Activity Buffer"))]
    assert kernels and y.shape == x.shape
    for e in kernels:
        assert span.t0_ns <= e.start_ns() <= e.end_ns() <= span.t1_ns, (e.name(), e.start_ns() - span.t0_ns,
                                                                         span.t1_ns - e.end_ns())
