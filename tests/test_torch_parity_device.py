"""getdist_tpu_torch parity-mode device passes against the JAX package.

Kernel K4 (dynamic pair lists) and the stages of ``ops/parity_device.py``,
each fed the same numpy inputs as its JAX counterpart, on the CPU: the
port through its kernels' plain versions, the JAX side in f64 (the
session's x64 mode, which JAX parity mode requires), except the
interpret-mode Pallas K4, which traces in 32-bit mode as the JAX package
runs it. The CUDA kernels themselves are held against these plain
versions by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from getdist_tpu.ops import dft_conv as jdft  # noqa: E402
from getdist_tpu.ops import parity_device as jpdev  # noqa: E402
from getdist_tpu.ops.batched import _pair_hist_256  # noqa: E402
from getdist_tpu.ops.pallas_kernels import pair_histograms as jax_pair_histograms  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import samplemath as smath  # noqa: E402
from getdist_tpu_torch.ops import dft_conv, pair_hist  # noqa: E402
from getdist_tpu_torch.ops import parity_device as pdev  # noqa: E402
from test_batched import make_chain  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def chain():
    """An AR(1) chain with integer weights (bench.py's construction)."""
    samples, weights = make_chain(n=8000, p=4)
    return samples, weights


def _sheared_stack(p, n, seed):
    """Index rows as parity's sheared stacks have them: two lead rows, each
    paired with several unique residual rows."""
    rng = np.random.default_rng(seed)
    ix = np.clip(rng.standard_normal((p, n)) * 40 + 128, 0, 255).astype(np.uint8)
    w = rng.integers(1, 5, n).astype(np.float32)
    pa = np.array([0, 0, 0, 1, 1, 0], np.int32)
    pb = np.array([2, 3, 4, 2, 3, 1], np.int32)
    return ix, w, pa, pb


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("narrowed", [False, True], ids=["f32-weights", "uint8-weights"])
def test_dynamic_pairs_match_pallas_kernel_bit_exact(narrowed):
    """P = 5, N = 8192, K = 6 with repeated a rows: the plain version equals
    the TPU kernel (interpret mode) bit for bit on integer weights, given as
    f32 or narrowed to uint8 as parity mode passes them."""
    ix, w, pa, pb = _sheared_stack(5, 8192, seed=1)
    with jax.enable_x64(False):
        want = np.asarray(
            jax_pair_histograms(
                jnp.asarray(ix), jnp.asarray(w), jnp.asarray(pa), jnp.asarray(pb), block=4096, interpret=True
            )
        )
    weights = pair_hist.narrow_weights(_t(w)) if narrowed else _t(w)
    assert weights.dtype == (torch.uint8 if narrowed else torch.float32)
    before = pair_hist.pair_histograms_dynamic.launches
    got = pair_hist.pair_histograms_dynamic(_t(ix), weights, _t(pa), _t(pb), integer_weights=True).numpy()
    assert pair_hist.pair_histograms_dynamic.launches == before  # CPU tensors never launch
    assert got.dtype == np.float32 and got.shape == (6, 256, 256)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("index_dtype", [torch.int16, torch.int32], ids=["int16", "int32"])
def test_dynamic_pairs_at_384_bins_bit_exact(index_dtype):
    """A stretched fine group's bin count, against the one-hot reference."""
    rng = np.random.default_rng(2)
    n = 6000
    ix = np.clip(rng.standard_normal((3, n)) * 60 + 192, 0, 383).astype(np.int32)
    w = rng.integers(1, 5, n).astype(np.float32)
    pairs = [(0, 1), (0, 2), (1, 2)]
    with jax.enable_x64(False):
        want = np.stack(
            [np.asarray(_pair_hist_256(jnp.asarray(ix[a]), jnp.asarray(ix[b]), jnp.asarray(w), nbins=384)) for a, b in pairs]
        )
    pa = _t(np.array([a for a, _ in pairs], np.int32))
    pb = _t(np.array([b for _, b in pairs], np.int32))
    got = pair_hist.pair_histograms_dynamic(_t(ix).to(index_dtype), _t(w), pa, pb, integer_weights=True, nbins=384)
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_of_range_indices_are_dropped():
    ix = np.array([[3, 300, 5], [7, 8, -1]], np.int32)
    w = np.array([2.0, 5.0, 1.0], np.float32)
    got = pair_hist.pair_histograms_plain(_t(ix), _t(w), _t(np.array([0], np.int32)), _t(np.array([1], np.int32)), nbins=256)[0]
    assert got[7, 3] == 2.0 and got.sum() == 2.0


# ---------------------------------------------------------------------------
# parity_device stages
# ---------------------------------------------------------------------------


def _edges(samples):
    lo = samples.min(0) - 0.1 * np.ptp(samples, 0)
    hi = samples.max(0) + 0.1 * np.ptp(samples, 0)
    return lo, (hi - lo) / 255


def test_bin_indices_bit_exact(chain):
    samples, _ = chain
    lo, fw = _edges(samples)
    got = pdev.bin_indices(_t(samples), lo, fw).numpy()
    want = np.asarray(jpdev.bin_indices(jnp.asarray(samples), jnp.asarray(lo), jnp.asarray(fw)))
    numpy_formula = ((samples - lo) / fw + 0.5).astype(np.int64).T
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, numpy_formula)


def test_sheared_rows_and_bin_rows(chain):
    samples, _ = chain
    other, lead = np.array([1, 2, 3]), np.array([0, 0, 1])
    rng = np.random.default_rng(3)
    r00, r10, r11 = (rng.uniform(0.5, 1.5, 3) for _ in range(3))
    rows, rlo, rhi = pdev.sheared_rows_minmax(_t(samples), other, lead, r00, r10, r11)
    j_rows, j_lo, j_hi = (
        np.asarray(a)
        for a in jpdev.sheared_rows_minmax(*(jnp.asarray(x) for x in (samples, other, lead, r00, r10, r11)))
    )
    # bit-exact against the host formula (mcsamples.py _sheared_bandwidths_batch)
    first, second = r00[:, None] * samples[:, other].T, r10[:, None] * samples[:, lead].T
    np.testing.assert_array_equal(rows.numpy(), (first - second) / r11[:, None])
    # XLA contracts r00 * other - r10 * lead into an FMA: measured up to 4
    # ulps of the larger product apart from the unfused host formula, so a
    # 1-ulp bar against JAX cannot hold; the bin indices these rows give are
    # held bit-exact against JAX's in tests/test_torch_parity_slice.py
    ulp = np.spacing(np.maximum(np.abs(first), np.abs(second)) / r11[:, None])
    assert np.all(np.abs(rows.numpy() - j_rows) <= 4 * ulp)
    assert np.all(np.abs(rlo.numpy() - j_lo) <= 4 * ulp.max(1))
    assert np.all(np.abs(rhi.numpy() - j_hi) <= 4 * ulp.max(1))
    # kde_bandwidth.bin_samples convention on the JAX rows
    pad = (j_hi - j_lo) * 0.1
    rmin = j_lo - pad
    dx = ((j_hi + pad) - rmin) / 255
    got = pdev.bin_rows(_t(j_rows), rmin, dx).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpdev.bin_rows(jnp.asarray(j_rows), jnp.asarray(rmin), jnp.asarray(dx))))
    np.testing.assert_array_equal(got, ((j_rows - rmin[:, None]) / dx[:, None]).astype(int))


@pytest.mark.parametrize("narrowed", [False, True], ids=["f32-weights", "uint8-weights"])
@pytest.mark.parametrize("fine", [256, 384])
def test_group_pair_hists_bit_exact(chain, fine, narrowed):
    """Both weight types parity mode passes (uint8 weights are widened to f32
    for the 384-bin group's int16 rows)."""
    samples, weights = chain
    lo = samples.min(0) - 0.1 * np.ptp(samples, 0)
    fw = (samples.max(0) + 0.1 * np.ptp(samples, 0) - lo) / (fine - 1)
    ix = np.asarray(jpdev.bin_indices(jnp.asarray(samples), jnp.asarray(lo), jnp.asarray(fw)))
    pa, pb = np.triu_indices(4, 1)
    parts = jpdev.weight_parts(jnp.asarray(weights, jnp.float32))
    want = np.asarray(jpdev.group_pair_hists(jnp.asarray(ix), pa, pb, parts, fine))
    w32 = _t(weights.astype(np.float32))
    hist_w = pair_hist.narrow_weights(w32) if narrowed else w32
    assert hist_w.dtype == (torch.uint8 if narrowed else torch.float32)
    got = pdev.group_pair_hists(_t(ix), pa, pb, hist_w, fine, True).numpy()
    np.testing.assert_array_equal(got, want)


def test_group_pair_hists_drop_out_of_range_indices():
    """An index outside [0, 256) at 256 bins is dropped, as the JAX function
    drops it: the narrowing keeps the rows int16 instead of wrapping the
    index into range."""
    rng = np.random.default_rng(4)
    ix = rng.integers(0, 256, (3, 500)).astype(np.int32)
    ix[0, :5] = [256, 300, -1, -40, 511]
    w = rng.integers(1, 5, 500).astype(np.float32)
    pa, pb = np.array([0, 0, 1]), np.array([1, 2, 2])
    want = np.asarray(jpdev.group_pair_hists(jnp.asarray(ix), pa, pb, jpdev.weight_parts(jnp.asarray(w)), 256))
    got = pdev.group_pair_hists(_t(ix), pa, pb, pair_hist.narrow_weights(_t(w)), 256, True).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:2].sum() < 2 * w.sum()


@pytest.mark.parametrize(
    "values,nbins,dtype",
    [
        ([0, 255], 256, torch.uint8),
        ([0, 256], 256, torch.int16),
        ([-1, 200], 256, torch.int16),
        ([0, 200], 384, torch.int16),
        ([0, 40000], 960, torch.int32),
        ([-40000, 5], 256, torch.int32),
    ],
    ids=["in-range", "past-256", "negative", "wide-grid", "past-int16", "below-int16"],
)
def test_narrow_rows_never_wraps(values, nbins, dtype):
    ix = torch.tensor([values, values[::-1]], dtype=torch.int32)
    got = pair_hist.narrow_rows(ix, nbins)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), ix.numpy())


def test_pair_routes_follow_the_tile_plan():
    """All pairs of a group take K1's static entry; a sheared stack whose
    b rows are all distinct takes K4's."""
    assert pdev.static_route(30, 435)
    assert not pdev.static_route(8 + 114, 114)


def test_kde_neff_batch_matches_jax_and_host(chain):
    """The lag pair sums against JAX's, and the batched driver against the
    host adaptive-lag driver. The driver's baseline subtraction cancels
    most of each sum, so the JAX driver's own result is compared on its
    lag sums: one run in this file measured 1.6e-11 between the two
    drivers' N, where the JAX side differed from its own isolated run."""
    samples, weights = chain
    kstds = list(0.2 * samples.std(0))
    maxoffs = [40, 12, 300, 5]
    n = samples.shape[0]
    jobs = [(j, lag, kstds[j]) for j in range(4) for lag in (1, 2, 3, 17, 150, n // 2, n // 2 + 4)]
    want = jpdev.lag_terms(jnp.asarray(samples), jnp.asarray(weights), jobs)
    np.testing.assert_allclose(pdev.lag_terms(_t(samples), _t(weights), jobs), want, rtol=1e-12)
    got = pdev.kde_neff_batch(_t(samples), _t(weights), weights, kstds, maxoffs, n)
    host = [
        smath.kde_pair_sum_adaptive(
            lambda k, j=j: smath.kde_lag_term_1d(samples[:, j], weights, k, kstds[j]), weights, n, maxoffs[j], 0.05
        )
        for j in range(4)
    ]
    np.testing.assert_allclose(got, host, rtol=1e-12)


def test_acl_batch_matches_host_correlation_length(chain):
    samples, weights = chain
    wsamp = tchains.WeightedSamples(samples=samples, weights=weights)
    means, variances = wsamp.getMeans(), wsamp.getVars()
    cols = [0, 1, 2, 3]
    acl, safe = pdev.acl_batch(_t(samples), _t(weights), means, variances, cols, samples.shape[0] // 10 + 1)
    host = np.array([wsamp.getCorrelationLength(j, weight_units=False) for j in cols])
    assert safe.all()
    np.testing.assert_allclose(acl, host, rtol=1e-9)
    assert np.all(acl > 1.5)  # the AR(1) chain is correlated


# ---------------------------------------------------------------------------
# K2 / K3 in f64
# ---------------------------------------------------------------------------


def test_f64_dft_plain_versions_match_jax():
    rng = np.random.RandomState(5)
    pad, size, m, offset = 512, 300, 61, 30
    grids = rng.rand(3, size, size) * 40
    kernels = rng.rand(3, m, m)
    ur, ui = dft_conv.dft_conv_spectrum(_t(kernels), pad)
    assert ur.dtype == torch.float64
    j_ur, j_ui = (np.asarray(a) for a in jdft.dft_conv_spectrum_xla(jnp.asarray(kernels), pad=pad, precision="f64"))
    for got, want in ((ur.numpy(), j_ur), (ui.numpy(), j_ui)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    out = dft_conv.dft_conv2d(_t(grids), ur, ui, size, offset, pad).numpy()
    want = np.asarray(
        jdft.dft_conv2d_xla(jnp.asarray(grids), jnp.asarray(j_ur), jnp.asarray(j_ui), size, offset, pad=pad, precision="f64")
    )
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_frame_sizing():
    assert dft_conv.frame_for(377) == 384
    assert dft_conv.frame_for(256 + 4 * 98 + 1) == 768
    assert dft_conv.frame_for(960 + 4 * 478 + 1) == 2944
