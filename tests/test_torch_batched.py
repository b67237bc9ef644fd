"""getdist_tpu_torch fused triangle-densities path against the JAX package.

Every comparison feeds both sides the same numpy inputs and runs the JAX
side in 32-bit mode (``jax.enable_x64(False)``), the f32 program a device
runs; the session's x64 default would otherwise promote untyped constants.
Stages are held one at a time first (tolerances tighter than the
end-to-end ones), then the whole slice on the chain of
tests/test_batched.py, whose 0.6-correlated pair takes the shear route.
The port runs here on the CPU, through its kernels' plain versions.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from getdist_tpu.ops import batched as jb  # noqa: E402
from getdist_tpu.ops import fft as jfft  # noqa: E402
from getdist_tpu_torch.ops import batched as tb  # noqa: E402
from getdist_tpu_torch.ops import fft as tfft  # noqa: E402
from test_batched import make_chain  # noqa: E402

CONTOURS = (0.68, 0.95)


def _np(tree):
    """Device arrays -> numpy (inside the 32-bit context)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(scope="module")
def chain():
    samples, weights = make_chain(n=20000, p=4)
    return samples, weights


@pytest.fixture(scope="module")
def chain32(chain):
    samples, weights = chain
    return samples.astype(np.float32), weights.astype(np.float32)


@pytest.fixture(scope="module")
def pair_hists(chain32):
    """Exact f32 histograms of three pairs on the fine grid of the JAX 1D stage."""
    s, w = chain32
    with jax.enable_x64(False):
        d1 = _np(jb.all_1d_densities(jnp.asarray(s), jnp.asarray(w)))
    lo, hi = d1["range"]
    fw = (hi - lo) / 255
    ix = np.clip(((s - lo) / fw + 0.5).astype(np.int64), 0, 255)
    pairs = [(0, 1), (0, 2), (2, 3)]
    hists = np.stack(
        [np.bincount(ix[:, b] * 256 + ix[:, a], weights=w, minlength=65536).reshape(256, 256) for a, b in pairs]
    ).astype(np.float32)
    return d1, pairs, hists


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def test_dct_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 40, 64)).astype(np.float32)
    for axis in (1, 2):
        with jax.enable_x64(False):
            want = np.asarray(jfft.dct(jnp.asarray(x), axis=axis))
        got = tfft.dct(_t(x), dim=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_next_fast_len_matches_jax():
    assert [tfft.next_fast_len(n) for n in range(1, 700)] == [jfft.next_fast_len(n) for n in range(1, 700)]


def test_1d_histograms_exact(chain32):
    s, w = chain32
    ix = np.clip(((s.T - s.min(0)[:, None]) / (np.ptp(s, 0)[:, None] / 1024)).astype(np.int32), 0, 1023)
    with jax.enable_x64(False):
        want = np.asarray(jb._onehot_hist_rows(jnp.asarray(ix), jnp.asarray(w), 1024))
    got = tb._hist_rows(_t(ix), _t(w), 1024).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_quantiles_match_jax(chain32):
    s, w = chain32
    lo, width = s.min(0), np.ptp(s, 0) / 1024
    ix = np.clip(((s.T - lo[:, None]) / width[:, None]).astype(np.int64), 0, 1023)
    hist = np.stack([np.bincount(r, weights=w, minlength=1024) for r in ix]).astype(np.float32)
    probs = np.array([0.001, 0.999, 0.1, 0.25, 0.5, 0.9], np.float32)
    with jax.enable_x64(False):
        want = np.asarray(
            jax.vmap(jb._quantiles_from_hist, in_axes=(0, 0, 0, None))(
                jnp.asarray(hist), jnp.asarray(lo), jnp.asarray(width), jnp.asarray(probs)
            )
        )
    got = tb._quantiles_from_hist(_t(hist), _t(lo), _t(width), _t(probs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_neff_matches_jax(chain32):
    s, w = chain32
    values = np.ascontiguousarray(s.T)
    sigmas = s.std(0).astype(np.float32)
    lags = jb._lag_grid(values.shape[1])
    assert tb._lag_grid(values.shape[1]) == lags
    with jax.enable_x64(False):
        want = np.asarray(jb._neff_kde_batch(jnp.asarray(values), jnp.asarray(w), jnp.asarray(sigmas), lags))
    got = tb._neff_kde_batch(_t(values), _t(w), _t(sigmas), lags).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_isj_bandwidth_1d_matches_jax(chain32):
    s, w = chain32
    lo, width = s.min(0) - 0.5, (np.ptp(s, 0) + 1.0) / 1023
    ix = np.clip(((s.T - lo[:, None]) / width[:, None] + 0.5).astype(np.int64), 0, 1023)
    bins = np.stack([np.bincount(r, weights=w, minlength=1024) for r in ix]).astype(np.float32)
    neff = np.array([3000.0, 5000.0, 8000.0, 20000.0], np.float32)
    with jax.enable_x64(False):
        h, ok = jax.vmap(jb._isj_bandwidth_1d)(jnp.asarray(bins), jnp.asarray(neff))
        h, ok = np.asarray(h), np.asarray(ok)
    got_h, got_ok = tb._isj_bandwidth_1d(_t(bins), _t(neff))
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    assert ok.all()
    np.testing.assert_allclose(got_h.numpy(), h, rtol=2e-5)


def _bandwidth_inputs(pair_hists):
    d1, pairs, hists = pair_hists
    k = len(pairs)
    neff = np.full(k, 9000.0, np.float32)
    sample_corr = np.array([0.6, 0.0, 0.0], np.float32)
    do_corr = np.ones(k, bool)
    fb_t = np.full(k, 2e-4, np.float32)
    return hists, neff, sample_corr, do_corr, fb_t


def _jax_kernel_bandwidth_2d(*args):
    """The JAX optimizer op by op (vmapped, not jitted). Under jit, XLA fuses
    the near-total +-f cancellation of the odd psi functionals differently:
    on the correlated pair here the jitted program flags it FRAGILE and its
    free-correlation search diverges (AMISE ratio -2158), while op-by-op JAX
    and the port both take the free search to rho = 0.867."""
    with jax.enable_x64(False):
        return _np(jax.vmap(jb._kernel_bandwidth_2d)(*(jnp.asarray(a) for a in args)))


# the free-correlation search is a 60-step descent along a flat valley of
# the AMISE; f32 rounding of its gradient moves the stopping point ~3e-4
OPTIMIZER_RTOL = 5e-4


def test_kernel_bandwidth_2d_matches_jax(pair_hists):
    args = _bandwidth_inputs(pair_hists)
    want = _jax_kernel_bandwidth_2d(*args)
    got = _np(tb._kernel_bandwidth_2d(*(_t(a) for a in args)))
    for g, w_ in zip(got[:3], want[:3]):  # wx, wy, rho
        np.testing.assert_allclose(g, w_, rtol=OPTIMIZER_RTOL, atol=1e-6)
    np.testing.assert_array_equal(got[3], want[3])  # ok
    np.testing.assert_array_equal(got[4], want[4])  # fragile


def test_sheared_power_and_optimizer_match_jax(pair_hists):
    """The shear route: sheared spectra, then the optimizer on them."""
    d1, pairs, hists = pair_hists
    lo, hi = d1["range"]
    xc = lo[:, None] + ((hi - lo) / 255)[:, None] * np.arange(256, dtype=np.float32)[None, :]
    pa = np.array([a for a, _ in pairs])
    pb = np.array([b for _, b in pairs])
    r0 = np.array([-0.75, -0.1, 0.3], np.float32)
    r1 = np.array([1.25, 1.01, 1.05], np.float32)
    swap = np.zeros(3, bool)
    sh_args = (hists, xc[pa], xc[pb], r0, r1, swap)
    with jax.enable_x64(False):
        want = _np(jax.jit(jax.vmap(jb._sheared_power))(*(jnp.asarray(a) for a in sh_args)))
    got = _np(tb._sheared_power(*(_t(a) for a in sh_args)))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 * np.abs(want[0]).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)

    use = np.array([True, False, True])
    args = _bandwidth_inputs(pair_hists) + (want[0], use)
    want_bw = _jax_kernel_bandwidth_2d(*args)
    got_bw = _np(tb._kernel_bandwidth_2d(*(_t(a) for a in args)))
    for g, w_ in zip(got_bw[:3], want_bw[:3]):
        np.testing.assert_allclose(g, w_, rtol=OPTIMIZER_RTOL, atol=1e-6)
    np.testing.assert_array_equal(got_bw[3], want_bw[3])
    np.testing.assert_array_equal(got_bw[4], want_bw[4])


def test_gauss_kernel_2d_matches_jax():
    rx = np.array([0.8, 3.5, 12.0], np.float32)
    ry = np.array([2.0, 3.0, 7.5], np.float32)
    corr = np.array([0.0, -0.6, 0.9], np.float32)
    support = np.array([2.0, 9.0, 30.0], np.float32)
    for sup in (None, support):
        with jax.enable_x64(False):
            fn = lambda a, b, c, s: jb._gauss_kernel_2d(a, b, c, 30, jnp.float32, support=s)  # noqa: E731
            want = np.asarray(
                jax.vmap(fn, in_axes=(0, 0, 0, None if sup is None else 0))(
                    jnp.asarray(rx), jnp.asarray(ry), jnp.asarray(corr), None if sup is None else jnp.asarray(sup)
                )
            )
        got = tb._gauss_kernel_2d(_t(rx), _t(ry), _t(corr), 30, support=None if sup is None else _t(sup)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_contour_levels_match_jax():
    y, x = np.mgrid[-3:3:128j, -4:4:128j]
    grids = np.stack([np.exp(-0.5 * (x**2 + y**2 / s)) for s in (0.5, 1.0, 2.0)]).astype(np.float32)
    contours = np.array(CONTOURS, np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jb._contour_levels_batch(jnp.asarray(grids), jnp.asarray(contours)))
    got = tb._contour_levels_batch(_t(grids), _t(contours)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# stage hooks and the whole slice
# ---------------------------------------------------------------------------


def test_1d_stage_with_hooks_matches_jax(chain32, pair_hists):
    """neff, range and bandwidth pinned: binning, smoothing and the
    mult-bias round alone."""
    s, w = chain32
    d1, _, _ = pair_hists
    hooks = dict(neff_override=d1["neff"], range_override=d1["range"], bandwidth_override=d1["bandwidth"] / (d1["range"][1] - d1["range"][0]))
    with jax.enable_x64(False):
        want = _np(jb.all_1d_densities(jnp.asarray(s), jnp.asarray(w), **{k: jax.tree.map(jnp.asarray, v) for k, v in hooks.items()}))
    got = _np(tb.all_1d_densities(_t(s), _t(w), **hooks))
    np.testing.assert_allclose(got["P"], want["P"], rtol=0, atol=1e-5)


def test_2d_stage_with_hooks_matches_jax(chain32, pair_hists):
    """Histograms, bandwidths and supports pinned: kernels, the DFT-matmul
    convolutions (FFT route on the JAX side), mult-bias and contours."""
    s, w = chain32
    d1, pairs, hists = pair_hists
    pa = np.array([a for a, _ in pairs], np.int32)
    pb = np.array([b for _, b in pairs], np.int32)
    bw = (np.array([0.12, 0.3, 0.2], np.float32), np.array([0.2, 0.25, 0.3], np.float32), np.array([0.55, 0.0, -0.2], np.float32))
    support = np.array([20.0, 25.0, 30.0], np.float32)
    args = (s, w, pa, pb, d1["neff"], d1["range"][0], d1["range"][1], np.array(CONTOURS, np.float32))
    kw = dict(hists_in=hists, bandwidth_override=bw, kernel_support=support)
    with jax.enable_x64(False):
        want = _np(
            jb.all_2d_densities(*(jnp.asarray(a) for a in args), **{k: jax.tree.map(jnp.asarray, v) for k, v in kw.items()})
        )
    got = _np(tb.all_2d_densities(_t(s), _t(w), *args[2:], **kw))
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    np.testing.assert_allclose(got["P"], want["P"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got["contours"], want["contours"], rtol=0.02)


@pytest.fixture(scope="module")
def slices(chain):
    samples, weights = chain
    with jax.enable_x64(False):
        want = _np(jb.triangle_densities(samples, weights))
    got = _np(tb.triangle_densities(samples, weights, device="cpu"))
    return got, want


def test_slice_pair_histograms_exact(chain, pair_hists):
    """The port's binning on the JAX stage's grid reproduces the JAX
    histograms bit for bit (export_hists on both sides)."""
    s, w = chain
    d1, _, _ = pair_hists
    pa, pb = np.triu_indices(4, 1)
    args = (s.astype(np.float32), w.astype(np.float32), pa.astype(np.int32), pb.astype(np.int32), d1["neff"], d1["range"][0], d1["range"][1], np.array(CONTOURS, np.float32))
    with jax.enable_x64(False):
        want = np.asarray(jb.all_2d_densities(*(jnp.asarray(a) for a in args), export_hists=True)["hists"])
    got = tb.all_2d_densities(_t(args[0]), _t(args[1]), *args[2:], int8_weights=True, export_hists=True)["hists"].numpy()
    np.testing.assert_array_equal(got, want)


def test_slice_1d_matches_jax(slices):
    (g1, _), (w1, _) = slices
    np.testing.assert_allclose(g1["neff"], w1["neff"], rtol=1e-4)
    np.testing.assert_allclose(g1["bandwidth"], w1["bandwidth"], rtol=1e-4)
    for i in range(2):
        np.testing.assert_allclose(g1["range"][i], w1["range"][i], rtol=1e-4)
    np.testing.assert_allclose(g1["host_pack"], w1["host_pack"], rtol=1e-4)
    np.testing.assert_allclose(g1["x"], w1["x"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g1["P"], w1["P"], rtol=0, atol=1e-4)


def test_slice_2d_matches_jax(slices):
    (_, g2), (_, w2) = slices
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(g2[key], w2[key], rtol=1e-3)
    np.testing.assert_allclose(g2["neff"], w2["neff"], rtol=1e-4)
    np.testing.assert_array_equal(g2["fragile"], w2["fragile"])
    np.testing.assert_allclose(g2["P"], w2["P"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(g2["contours"], w2["contours"], rtol=0.02)
    assert g2["diag"].shape == w2["diag"].shape
    assert abs(g2["corr"][0]) > 0.2  # the correlated pair took the shear route


def test_slice_outputs_are_sane(slices):
    (g1, g2), _ = slices
    assert g1["P"].shape == (4, 1024) and g2["P"].shape == (6, 256, 256)
    for grid in (g1["P"], g2["P"]):
        assert np.isfinite(grid).all()
        np.testing.assert_allclose(grid.reshape(grid.shape[0], -1).max(1), 1.0, rtol=1e-6)
    assert np.all((g2["contours"] > 0) & (g2["contours"] <= 1))


def test_port_imports_no_jax():
    code = (
        "import sys, getdist_tpu_torch.ops.batched, getdist_tpu_torch.mcsamples, getdist_tpu_torch.parallel; "
        "sys.exit(int('jax' in sys.modules))"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _branch_kwargs(samples, weights, case):
    """The arguments of a branch that raised before it was ported: a lower
    limit at column 0's minimum, column 1 periodic over its span, like
    weights w exp(-chi^2 / 2), or a 128-bin 2D grid."""
    nan = np.nan
    if case == "limits":
        return dict(limits_lo=[samples[:, 0].min(), nan, nan, nan])
    if case == "periodic":
        return dict(periodic=[False, True, False, False], limits_lo=[nan, samples[:, 1].min(), nan, nan],
                    limits_hi=[nan, samples[:, 1].max(), nan, nan])
    if case == "like_weights":
        return dict(like_weights=weights * np.exp(-0.5 * np.sum(samples**2, axis=1) / 4))
    return dict(fine_bins_2d=128)


@pytest.mark.parametrize(
    "kwargs",
    ["limits", "periodic", "like_weights", "fine_bins_2d"],
    ids=["limits", "periodic", "like_weights", "fine_bins_2d"],
)
def test_unported_branches_raise(chain, kwargs):
    """Branches of ``triangle_densities`` that raised until they were
    ported (limits, periodic, like weights, a fine grid other than 256) now
    run and match the JAX function on 5000 samples: 1D (and its like
    curves) atol 1e-4, 2D kernels rtol 1e-3 where the JAX side did not flag
    the pair, P within 5e-4, contours rtol 0.02. The 2D like grids are held
    against f64 in ``tests/test_torch_bounded.py`` (the JAX side's f32 ones
    are not reliable there); here they must lie in [0, 1] with peak 1."""
    samples, weights = chain[0][:5000], chain[1][:5000]
    kw = _branch_kwargs(samples, weights, kwargs)
    with jax.enable_x64(False):
        want = _np(jb.triangle_densities(samples, weights, use_pallas=False, **kw))
    got = _np(tb.triangle_densities(samples, weights, device="cpu", **kw))
    (g1, g2), (w1, w2) = got, want
    np.testing.assert_allclose(g1["P"], w1["P"], rtol=0, atol=1e-4)
    for key in ("active_lo", "active_hi", "periodic"):
        np.testing.assert_array_equal(g1[key], w1[key])
    calm = ~w2["fragile"]
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(g2[key][calm], w2[key][calm], rtol=1e-3)
    np.testing.assert_allclose(g2["P"], w2["P"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(g2["contours"], w2["contours"], rtol=0.02)
    fine = kw.get("fine_bins_2d", 256)
    assert g2["P"].shape == (6, fine, fine)
    if kwargs == "like_weights":
        np.testing.assert_allclose(g1["likes"], w1["likes"], rtol=0, atol=1e-4)
        assert g2["likes"].min() >= -1e-6
        np.testing.assert_allclose(g2["likes"].max(axis=(1, 2)), 1.0, rtol=1e-6)
    if kwargs == "periodic":
        assert g1["P"][1, 0] == g1["P"][1, -1]


@pytest.mark.parametrize(
    "kwargs",
    [dict(exact_mult_bias=True), dict(periodic=[False, True, False, False]), dict(prior_mask=True)],
    ids=["exact_mult_bias", "periodic", "prior_mask"],
)
def test_unported_2d_branches_raise(chain32, pair_hists, kwargs):
    """``exact_mult_bias`` without host bandwidths still raises (ROADMAP
    A8). The other two raised until they were ported and now run with the
    histograms and bandwidths pinned, matching the JAX function (P within
    5e-4): a periodic axis (the wrap line exact), and a diagonal prior
    mask on a pair with an active limit (the histograms keep only the
    samples inside it), held inside the prior at boundary order 0."""
    s, w = chain32
    if "exact_mult_bias" in kwargs:
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            tb.all_2d_densities(s, w, [0], [1], np.ones(4), np.zeros(4), np.ones(4), CONTOURS, **kwargs)
        return
    d1, pairs, hists = pair_hists
    pa = np.array([a for a, _ in pairs], np.int32)
    pb = np.array([b for _, b in pairs], np.int32)
    bw = tuple(np.array(v, np.float32) for v in ([0.12, 0.3, 0.2], [0.2, 0.25, 0.3], [0.55, 0.0, -0.2]))
    kw = dict(hists_in=hists, bandwidth_override=bw)
    if "periodic" in kwargs:
        kw["periodic"] = np.array(kwargs["periodic"])
    else:
        yy, xx = np.mgrid[0:316, 0:316]
        prior = (xx + yy < 316 + 40).astype(np.float32)
        kw.update(prior_mask=np.stack([prior] * 3), hists_in=hists * prior[30:-30, 30:-30], boundary_order=0,
                  active_lo=np.array([True, False, False, False]), active_hi=np.zeros(4, bool))
    args = (s, w, pa, pb, d1["neff"], d1["range"][0], d1["range"][1], np.array(CONTOURS, np.float32))
    with jax.enable_x64(False):
        jkw = {k: v if isinstance(v, int) else jax.tree.map(jnp.asarray, v) for k, v in kw.items()}
        want = _np(jb.all_2d_densities(*(jnp.asarray(a) for a in args), **jkw))
    got = _np(tb.all_2d_densities(_t(s), _t(w), *args[2:], **kw))
    if "periodic" in kwargs:
        np.testing.assert_allclose(got["P"], want["P"], rtol=0, atol=5e-4)
        assert np.array_equal(got["P"][0][0], got["P"][0][-1])  # pair (0, 1): column 1 is its y axis
    else:
        inside = prior[30:-30, 30:-30] > 0
        for g, w_ in zip(got["P"], want["P"]):
            np.testing.assert_allclose(g[inside] / g[inside].max(), w_[inside] / w_[inside].max(), rtol=0, atol=5e-4)


@pytest.mark.parametrize(
    "kwargs",
    [dict(limits_lo=[0.0, np.nan, np.nan, np.nan]), dict(periodic=[False, True, False, False]), dict(like_weights=np.ones(200))],
    ids=["limits", "periodic", "like_weights"],
)
def test_sharded_unported_branches_raise(chain32, kwargs):
    """The sharded path raises for the branches it has not taken over from
    the unsharded one (ROADMAP A9), before any collective (so no process
    group is needed here)."""
    from getdist_tpu_torch.parallel import sharded_triangle_densities

    s, w = chain32
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        sharded_triangle_densities(None, _t(s[:200]), _t(w[:200]), **kwargs)


def _tf32_calls(chain):
    samples, weights = chain
    s32, w32 = (_t(x.astype(np.float32)) for x in (samples[:3000], weights[:3000]))
    grids = torch.from_numpy(np.random.RandomState(9).rand(2, 40, 40).astype(np.float32))
    kernels = torch.from_numpy(np.random.RandomState(10).rand(2, 9, 9).astype(np.float32))

    def dft_conv_call():
        from getdist_tpu_torch.ops import dft_conv

        ur, ui = dft_conv.dft_conv_spectrum(kernels, 64)
        dft_conv.dft_conv2d(grids, ur, ui, 40, 4, 64)

    def raising_call():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tb.all_2d_densities(s32, w32, [0], [1], np.ones(4), np.zeros(4), np.ones(4), CONTOURS,
                                exact_mult_bias=True)

    return {
        "triangle_densities": lambda: tb.triangle_densities(samples[:3000], weights[:3000], device="cpu"),
        "dft_conv": dft_conv_call,
        "raising all_2d_densities": raising_call,
    }


@pytest.mark.parametrize("allow", [True, False], ids=["tf32-on", "tf32-off"])
@pytest.mark.parametrize("call", ["triangle_densities", "dft_conv", "raising all_2d_densities"])
def test_calls_leave_the_tf32_switch_as_found(chain, call, allow):
    """The port keeps cuBLAS out of TF32 only inside its own calls: the
    caller's ``allow_tf32`` is the same after each call, and after one that
    raises."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        _tf32_calls(chain)[call]()
        assert torch.backends.cuda.matmul.allow_tf32 is allow
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
