"""getdist_tpu_torch's hard limits, periodic axes and mean-likelihood grids
against the JAX package.

The branches of the fused program (``ops/batched.py``: the 1D stage, the
in-program 2D optimizer under limits, the 2D stage's periodic axes, like
grids, prior masks and the parity branch's periodic masks), the fused
program as a whole (``triangle_densities``), the public entry
(``MCSamples.fastTriangleDensities(meanlikes=True)`` on a bounded, periodic
chain with loglikes) and the host periodic 1D density. Both sides get the
same numpy inputs: the JAX side runs with ``use_pallas=False`` (its FFT
convolutions on the CPU) inside ``jax.enable_x64(False)``, the f32 program
a device runs; the port runs on the CPU, through its kernels' plain
versions. Tolerances are those of ``tests/test_torch_batched.py`` (stages)
and the zoo's 5e-3 (served grids).

Knife edge of the JAX side, its 2D like grids in f32: the like-weighted
grid is smoothed, flattened by itself, smoothed again and multiplied back;
where a tail value of the first smoothing (the like weights span many
decades) rounds below zero, the JAX package keeps the unscaled second
smoothing, which over the 1e-4 density floor becomes the grid's peak. Its
f32 like grids are then more than 0.5 of the peak from its f64 ones on
this chain (asserted below), while in f64 (where the two vanish together)
they are right. The port scales by the first smoothing clamped at zero (equal in
exact arithmetic), and its 2D like grids are held against the JAX
function in f64 (``jax.enable_x64(True)``, the same histograms and
kernels) at the zoo's 5e-3, which the f32 convolutions' round-off over the
density floor needs (ROADMAP C10).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from getdist_tpu.mcsamples import MCSamples as JaxMCSamples  # noqa: E402
from getdist_tpu.ops import batched as jb  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from getdist_tpu_torch.ops import batched as tb  # noqa: E402
from test_zoo_fidelity import DEFAULT_TOL_2D  # noqa: E402

CONTOURS = np.array((0.68, 0.95), np.float32)
LIKES_TOL = DEFAULT_TOL_2D


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _limits(names, ranges):
    """(limits_lo, limits_hi, periodic) arrays of a ranges dict (NaN: none)."""
    lo = np.array([ranges.get(n, [None, None])[0] for n in names], dtype=float).astype(np.float32)
    hi = np.array([ranges.get(n, [None, None])[1] for n in names], dtype=float).astype(np.float32)
    per = np.array([len(ranges.get(n, ())) == 3 for n in names])
    return lo, hi, per


@pytest.fixture(scope="module")
def chain():
    """20k x 6: every 10th sample of ``chip_smoke.bounded_chain(200k, 6)``
    (N_eff close to N): a lower-limited, an upper-limited and a two-sided
    column, two periodic ones, one unbounded; loglikes and the like
    weights."""
    s, w, ll, names, ranges = chip_smoke.bounded_chain(200_000, p=6, kinds=(1, 1, 1, 2))
    s, w, ll = s[::10].copy(), w[::10].copy(), ll[::10].copy()
    lw = w * np.exp(np.sum(w * ll) / np.sum(w) - ll)
    return dict(s=s, w=w, ll=ll, names=names, ranges=ranges, lw=lw, s32=s.astype(np.float32),
                w32=w.astype(np.float32), lw32=lw.astype(np.float32))


def _jax_1d(c, **kw):
    with jax.enable_x64(False):
        args = {k: jnp.asarray(v) for k, v in kw.items() if v is not None}
        return _np(jb.all_1d_densities(jnp.asarray(c["s32"]), jnp.asarray(c["w32"]), **args))


# ---------------------------------------------------------------------------
# 1D stage
# ---------------------------------------------------------------------------

_1D_CASES = {
    "lower": lambda lo, hi, per: dict(limits_lo=lo),
    "upper": lambda lo, hi, per: dict(limits_hi=hi),
    "both": lambda lo, hi, per: dict(limits_lo=lo, limits_hi=hi),
    "periodic": lambda lo, hi, per: dict(limits_lo=np.where(per, lo, np.nan).astype(np.float32),
                                         limits_hi=np.where(per, hi, np.nan).astype(np.float32), periodic=per),
    "likes": lambda lo, hi, per: dict(limits_lo=lo, limits_hi=hi, periodic=per),
}


def _1d_kwargs(c, case):
    kw = _1D_CASES[case](*_limits(c["names"], c["ranges"]))
    if case == "likes":
        kw["like_weights"] = c["lw32"]
    return kw


# Knife edge of the JAX side: without its lower limit (cases "upper" and
# "periodic"), column 0 (a half-normal) has a cliff at 0, and the JAX
# package's f32 ISJ fixed point lands 3.2e-4 from the f64 one there; the
# port's f32 value equals its f64 run to 1e-7. That column's bandwidth is
# held against the port's f64 run at 1e-5 and against JAX at 5e-4, its
# density against JAX at 5e-4.
KNIFE_1D = {"upper": [0], "periodic": [0]}


@pytest.mark.parametrize("case", list(_1D_CASES))
def test_1d_stage_matches_jax(chain, case):
    """Free: N_eff, bandwidths and ranges rtol 1e-4 (``KNIFE_1D`` aside),
    P (and like curves) atol 1e-4, the active limits and periodic flags
    bit-equal. Then with N_eff, range and bandwidth pinned (the range
    padded 10% past the free one, so that the limits cut it): P within
    1e-5 of the peak."""
    kw = _1d_kwargs(chain, case)
    want = _jax_1d(chain, **kw)
    got = _np(tb.all_1d_densities(_t(chain["s32"]), _t(chain["w32"]), **kw))
    for key in ("active_lo", "active_hi", "periodic"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["active_lo"].any() or got["active_hi"].any() or got["periodic"].any()
    knife = KNIFE_1D.get(case, [])
    calm = np.setdiff1d(np.arange(len(want["neff"])), knife)
    np.testing.assert_allclose(got["neff"], want["neff"], rtol=1e-4)
    np.testing.assert_allclose(got["bandwidth"][calm], want["bandwidth"][calm], rtol=1e-4)
    if knife:
        got64 = _np(tb.all_1d_densities(_t(chain["s"]), _t(chain["w"]), **kw))
        np.testing.assert_allclose(got["bandwidth"][knife], got64["bandwidth"][knife], rtol=1e-5)
        np.testing.assert_allclose(got["bandwidth"][knife], want["bandwidth"][knife], rtol=5e-4)
    for i in range(2):
        np.testing.assert_allclose(got["range"][i], want["range"][i], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["P"][calm], want["P"][calm], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["P"][knife], want["P"][knife], rtol=0, atol=5e-4)
    assert ("likes" in got) == ("likes" in want) == (case == "likes")
    if case == "likes":
        np.testing.assert_allclose(got["likes"], want["likes"], rtol=0, atol=1e-4)

    lo, hi = want["range"]
    pad = 0.1 * (hi - lo)
    hooks = dict(neff_override=want["neff"], range_override=(lo - pad, hi + pad),
                 bandwidth_override=want["bandwidth"] / (hi - lo + 2 * pad))
    with jax.enable_x64(False):
        jh = {k: jax.tree.map(jnp.asarray, v) for k, v in {**kw, **hooks}.items()}
        want_h = _np(jb.all_1d_densities(jnp.asarray(chain["s32"]), jnp.asarray(chain["w32"]), **jh))
    got_h = _np(tb.all_1d_densities(_t(chain["s32"]), _t(chain["w32"]), **kw, **hooks))
    for key in ("active_lo", "active_hi", "periodic"):
        np.testing.assert_array_equal(got_h[key], want_h[key])
    np.testing.assert_allclose(got_h["P"], want_h["P"], rtol=0, atol=1e-5)
    if case == "likes":
        np.testing.assert_allclose(got_h["likes"], want_h["likes"], rtol=0, atol=1e-5)


def test_periodic_1d_wraps(chain):
    lo, hi, per = _limits(chain["names"], chain["ranges"])
    got = _np(tb.all_1d_densities(_t(chain["s32"]), _t(chain["w32"]), limits_lo=lo, limits_hi=hi, periodic=per))
    i = int(np.flatnonzero(per)[0])
    assert got["P"][i, 0] == got["P"][i, -1]
    np.testing.assert_allclose([got["x"][i, 0], got["x"][i, -1]], [0.0, 2 * np.pi], rtol=1e-6)


# ---------------------------------------------------------------------------
# 2D stage, with histograms and bandwidths pinned
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage_1d(chain):
    lo, hi, per = _limits(chain["names"], chain["ranges"])
    d1 = _jax_1d(chain, limits_lo=lo, limits_hi=hi, periodic=per)
    return d1, per


def _pair_inputs(chain, d1, pairs, fine=256):
    """Exact histograms of ``pairs`` on the 1D stage's grid, and pinned
    kernels (data units) of a few bins with a range of correlations."""
    s, w = chain["s32"], chain["w32"]
    lo, hi = d1["range"]
    fw = (hi - lo) / (fine - 1)
    ix = np.clip(((s - lo) / fw + 0.5).astype(np.int64), 0, fine - 1)
    hists = np.stack([np.bincount(ix[:, b] * fine + ix[:, a], weights=w, minlength=fine * fine).reshape(fine, fine)
                      for a, b in pairs]).astype(np.float32)
    k = len(pairs)
    rng = np.random.RandomState(3)
    pa = np.array([a for a, _ in pairs], np.int32)
    pb = np.array([b for _, b in pairs], np.int32)
    bw = ((4 + 6 * rng.rand(k)).astype(np.float32) * fw[pa], (4 + 6 * rng.rand(k)).astype(np.float32) * fw[pb],
          np.linspace(-0.6, 0.6, k).astype(np.float32))
    return pa, pb, hists, bw


# pairs of the chain's columns (0 lower, 1 upper, 2 two-sided, 3-4 periodic,
# 5 free); a is the x axis (columns), b the y axis (rows)
_2D_CASES = {
    "periodic_x": dict(pairs=[(3, 5), (4, 5), (2, 5)], periodic=True),
    "periodic_xy": dict(pairs=[(3, 4), (0, 3)], periodic=True),
    "limits_x_periodic": dict(pairs=[(0, 3), (2, 4), (1, 5)], periodic=True, limits=True),
    "likes": dict(pairs=[(0, 3), (1, 5), (3, 4)], periodic=True, limits=True, likes=True),
    "prior_mask": dict(pairs=[(0, 1), (2, 5)], limits=True, prior_mask=True),
    "exact_mult_bias_periodic": dict(pairs=[(0, 3), (3, 5), (3, 4)], periodic=True, limits=True, exact=True),
}


@pytest.mark.parametrize("case", list(_2D_CASES))
def test_2d_stage_with_hooks_matches_jax(chain, stage_1d, case):
    """Histograms and bandwidths pinned: periodic extension, folding and
    wrap lines, the limit masks with periodic axes, like grids, prior masks
    and the parity branch's periodic mult-bias mask. P within 5e-4 of the
    peak, contours rtol 0.02; like grids against the JAX function in f64 at
    the zoo's 5e-3 (module docstring)."""
    spec = _2D_CASES[case]
    d1, per = stage_1d
    pa, pb, hists, bw = _pair_inputs(chain, d1, spec["pairs"])
    k = len(pa)
    kw = dict(hists_in=hists, bandwidth_override=bw)
    if spec.get("periodic"):
        kw["periodic"] = per
    if spec.get("limits"):
        kw.update(active_lo=d1["active_lo"], active_hi=d1["active_hi"])
    if spec.get("likes"):
        kw["like_weights"] = chain["lw32"]
    if spec.get("prior_mask"):
        # a diagonal prior through the bulk; the histograms keep only the
        # samples inside it, as a chain drawn under that prior would
        yy, xx = np.mgrid[0:316, 0:316]
        prior = (xx + yy < 316 + 40).astype(np.float32)
        kw["prior_mask"] = np.stack([prior] * k)
        kw["hists_in"] = hists * prior[30:-30, 30:-30]
        # order 0 (the edge normalization alone): past the cut the linear
        # boundary kernel's moment system is near-singular, and its f32
        # round-off, not the branch, would decide the grid's peak
        kw["boundary_order"] = 0
    if spec.get("exact"):
        kw["exact_mult_bias"] = True
    args = (chain["s32"], chain["w32"], pa, pb, d1["neff"], d1["range"][0], d1["range"][1], CONTOURS)
    with jax.enable_x64(False):
        want = _np(jb.all_2d_densities(*(jnp.asarray(a) for a in args), use_pallas=False,
                                       **{n: v if isinstance(v, (bool, int)) else jax.tree.map(jnp.asarray, v)
                                          for n, v in kw.items()}))
    got = _np(tb.all_2d_densities(_t(chain["s32"]), _t(chain["w32"]), *args[2:], **kw))
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    if spec.get("prior_mask"):
        # the fused hook leaves the density past the cut (the host path
        # zeroes it, getdist_tpu/mcsamples.py:3040): there it is a ratio of
        # two kernel tails, which f32 round-off decides; held inside the
        # prior, renormalized to its peak there
        inside = prior[30:-30, 30:-30] > 0
        for g, w_ in zip(got["P"], want["P"]):
            np.testing.assert_allclose(g[inside] / g[inside].max(), w_[inside] / w_[inside].max(), rtol=0, atol=5e-4)
    else:
        np.testing.assert_allclose(got["P"], want["P"], rtol=0, atol=5e-4)
        np.testing.assert_allclose(got["contours"], want["contours"], rtol=0.02)
    # the wrap line of a periodic axis whose partner has no active limit
    # (ROADMAP C11): exact, or to the f32 round-off of the exact mask's
    # convolution (its value at both ends)
    wrap_tol = 1e-6 if spec.get("exact") else 0.0
    for k_, (a, b) in enumerate(spec["pairs"]):
        if per[a] and not (spec.get("limits") and (d1["active_lo"][b] or d1["active_hi"][b])):
            np.testing.assert_allclose(got["P"][k_][:, 0], got["P"][k_][:, -1], rtol=0, atol=wrap_tol)
        if per[b] and not (spec.get("limits") and (d1["active_lo"][a] or d1["active_hi"][a])):
            np.testing.assert_allclose(got["P"][k_][0], got["P"][k_][-1], rtol=0, atol=wrap_tol)
    if spec.get("prior_mask"):
        plain = tb.all_2d_densities(_t(chain["s32"]), _t(chain["w32"]), *args[2:],
                                    **{n: v for n, v in kw.items() if n != "prior_mask"})
        assert np.abs(plain["P"].numpy() - got["P"]).max() > 1e-2  # the mask took effect
    if spec.get("likes"):
        want64 = _jax_f64_likes(chain, d1, pa, pb, hists, bw, kw)
        np.testing.assert_allclose(got["likes"], want64, rtol=0, atol=LIKES_TOL)
        # the knife edge of the module docstring is present on this chain
        assert np.abs(want["likes"] - want64).max() > 0.5
        assert got["likes"].min() >= -1e-6 and np.allclose(got["likes"].max(axis=(1, 2)), 1.0)


def _jax_f64_likes(chain, d1, pa, pb, hists, bw, kw):
    """The JAX function's like grids in f64 on the same histograms, kernels,
    limits and periodic flags."""
    f64 = lambda v: jnp.asarray(np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f" else v)  # noqa: E731
    with jax.enable_x64(True):
        kw64 = {n: v if isinstance(v, (bool, int)) else jax.tree.map(f64, v) for n, v in kw.items()}
        kw64["like_weights"] = jnp.asarray(chain["lw"])
        kw64["bandwidth_override"] = tuple(f64(v) for v in bw)
        out = jb.all_2d_densities(jnp.asarray(chain["s"]), jnp.asarray(chain["w"]), jnp.asarray(pa), jnp.asarray(pb),
                                  f64(d1["neff"]), f64(d1["range"][0]), f64(d1["range"][1]), f64(CONTOURS),
                                  use_pallas=False, **kw64)
        return np.asarray(out["likes"])


def test_2d_stage_without_override_keeps_raising_for_exact_mult_bias(chain):
    """``exact_mult_bias`` with the in-program optimizer, which raised until
    it was ported, under hard limits and periodic axes on pinned
    histograms: the JAX function's bandwidths at rtol 1e-3 and its grids
    within 5e-4 on the pairs it did not flag FRAGILE, contours at rtol
    0.02."""
    lo, hi, per = _limits(chain["names"], chain["ranges"])
    d1 = _jax_1d(chain, limits_lo=lo, limits_hi=hi, periodic=per)
    pa, pb = (x.astype(np.int32) for x in np.triu_indices(len(chain["names"]), 1))
    args = (chain["s32"], chain["w32"], pa, pb, d1["neff"], d1["range"][0], d1["range"][1], CONTOURS)
    kw = dict(active_lo=d1["active_lo"], active_hi=d1["active_hi"], periodic=per, sigma_range=d1["sigma_range"],
              exact_mult_bias=True)
    with jax.enable_x64(False):
        want = _np(jb.all_2d_densities(*(jnp.asarray(a) for a in args), use_pallas=False, export_hists=True,
                                       **{n: v if isinstance(v, bool) else jnp.asarray(v) for n, v in kw.items()}))
    got = _np(tb.all_2d_densities(_t(chain["s32"]), _t(chain["w32"]), *args[2:], hists_in=want["hists"], **kw))
    calm = ~want["fragile"]
    assert calm.sum() >= len(pa) - 2
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(got[key][calm], want[key][calm], rtol=1e-3)
    np.testing.assert_allclose(got["P"][calm], want["P"][calm], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got["contours"][calm], want["contours"][calm], rtol=0.02)


# ---------------------------------------------------------------------------
# the in-program 2D optimizer under limits
# ---------------------------------------------------------------------------


def _optimizer_chain():
    """20k x 5, independent draws: a free parameter (0) correlated ~0.4 with
    a lower-limited one (2: one limited, so the shear puts it first and
    the kernel gets no correlation search), a lower-limited pair (1, 2) at
    ~0.94 (both limited and above 0.8: the rule of thumb), a lower-limited
    one uncorrelated with the rest (3) and a free one correlated ~0.3 with
    the first (4: the shear and the correlation search)."""
    rng = np.random.RandomState(41)
    n = 20_000
    z = rng.standard_normal((n, 5))
    a = np.abs(z[:, 0])
    b = np.abs(0.97 * z[:, 0] + np.sqrt(1 - 0.97**2) * z[:, 1])
    c = 0.6 * b + 0.8 * z[:, 2]
    d = np.abs(z[:, 3] + 1.5) - 1.5
    e = z[:, 4] + 0.3 * c
    s = np.column_stack([c, a, b, d, e])
    lo = np.array([np.nan, 0, 0, -1.5, np.nan], np.float32)
    return s.astype(np.float32), rng.randint(1, 4, n).astype(np.float32), lo


def test_in_program_optimizer_under_limits_matches_jax(monkeypatch):
    """hx, hy and c (through rx, ry, corr, pinned histograms) at rtol 1e-3
    on the pairs the JAX side did not flag FRAGILE; which pairs took the
    shear (and with the limited parameter first), the rule of thumb and the
    correlation search is compared exactly with the JAX package's rules
    (batched.py:1527-1541) on the chain's correlations."""
    s, w, lo = _optimizer_chain()
    with jax.enable_x64(False):
        d1 = _np(jb.all_1d_densities(jnp.asarray(s), jnp.asarray(w), limits_lo=jnp.asarray(lo)))
    p = s.shape[1]
    pa, pb = (x.astype(np.int32) for x in np.triu_indices(p, 1))
    args = (s, w, pa, pb, d1["neff"], d1["range"][0], d1["range"][1], CONTOURS)
    kw = dict(active_lo=d1["active_lo"], active_hi=d1["active_hi"], sigma_range=d1["sigma_range"], export_hists=True)
    with jax.enable_x64(False):
        want = _np(jb.all_2d_densities(*(jnp.asarray(a) for a in args), use_pallas=False,
                                       **{n: v if isinstance(v, bool) else jnp.asarray(v) for n, v in kw.items()}))
    seen = {}
    plan, bandwidth = tb._shear_plan_2d, tb._kernel_bandwidth_2d

    def record_plan(*a):
        seen["swap"] = a[3].numpy().copy()
        return plan(*a)

    def record_bw(hist, neff, corr, do_corr, fb_t, power=None, use=None):
        seen["do_corr"], seen["shear"] = do_corr.numpy().copy(), None if use is None else use.numpy().copy()
        return bandwidth(hist, neff, corr, do_corr, fb_t, power, use)

    monkeypatch.setattr(tb, "_shear_plan_2d", record_plan)
    monkeypatch.setattr(tb, "_kernel_bandwidth_2d", record_bw)
    kw["hists_in"] = want["hists"]
    got = _np(tb.all_2d_densities(_t(s), _t(w), *args[2:], **kw))

    # the JAX package's branch rules, on the chain's weighted correlations
    corr = np.cov(s.T.astype(float), aweights=w)
    corr = corr / np.sqrt(np.outer(np.diag(corr), np.diag(corr)))
    c_s = corr[pa, pb]
    lim = d1["active_lo"] | d1["active_hi"]
    both, either = lim[pa] & lim[pb], lim[pa] | lim[pb]
    c_eff = np.where(np.abs(c_s) < 0.1, 0.0, np.clip(c_s, -0.95, 0.95))
    np.testing.assert_array_equal(seen["swap"], lim[pb])
    np.testing.assert_array_equal(seen["do_corr"], ~either)
    np.testing.assert_array_equal(seen["shear"], (np.abs(c_eff) > 0.2) & ~both)
    rule = (np.abs(c_s) > 0.95) | (both & (c_s > 0.8))
    assert rule.any() and (seen["shear"] & lim[pb] & ~lim[pa]).any() and (seen["shear"] & ~either).any()
    calm = ~want["fragile"]
    assert calm.sum() >= len(pa) - 2
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(got[key][calm], want[key][calm], rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(got["fragile"], False)
    # rule-of-thumb pairs: widths sigma_range / N_eff^(1/6) at the clipped sample correlation
    np.testing.assert_allclose(got["corr"][rule], np.clip(c_s[rule], -0.95, 0.95), rtol=1e-5)
    np.testing.assert_allclose(got["P"], want["P"], rtol=0, atol=5e-4)


# ---------------------------------------------------------------------------
# the fused program and the public entry
# ---------------------------------------------------------------------------


def test_triangle_densities_with_limits_periodic_likes_at_384(chain):
    """All four arguments, and fine_bins_2d 384 (the wide kernels' rows on
    the card): 1D and its like curves as the 1D stage test holds them, 2D
    kernels rtol 1e-3, P within 5e-4, contours rtol 0.02; the like grids in
    [0, 1] with peak 1 (held against f64 in the stage test)."""
    lo, hi, per = _limits(chain["names"], chain["ranges"])
    kw = dict(limits_lo=lo, limits_hi=hi, periodic=per, like_weights=chain["lw32"], fine_bins_2d=384)
    with jax.enable_x64(False):
        w1, w2 = _np(jb.triangle_densities(chain["s"], chain["w"], use_pallas=False, **kw))
    g1, g2 = _np(tb.triangle_densities(chain["s"], chain["w"], device="cpu", **kw))
    np.testing.assert_allclose(g1["P"], w1["P"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g1["likes"], w1["likes"], rtol=0, atol=1e-4)
    for key in ("active_lo", "active_hi", "periodic"):
        np.testing.assert_array_equal(g1[key], w1[key])
    assert g2["P"].shape == w2["P"].shape == (15, 384, 384)
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(g2[key][~w2["fragile"]], w2[key][~w2["fragile"]], rtol=1e-3)
    np.testing.assert_allclose(g2["P"], w2["P"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(g2["contours"], w2["contours"], rtol=0.02)
    assert g2["likes"].shape == (15, 384, 384) and g2["likes"].min() >= -1e-6
    np.testing.assert_allclose(g2["likes"].max(axis=(1, 2)), 1.0, rtol=1e-6)


def test_like_grids_hold_under_f32_convolution_noise(chain, monkeypatch):
    """The program's like grids under noise in its f32 convolutions far
    inside their 1e-5 bar: every f32 K3 output moved by 1e-7 of its pair's
    largest value, signs drawn from a seed, as one f32 chain differs from
    another (the plain chain, the card's kernels). The like-weighted bins
    are smoothed in f64, whose tails then keep their sign, so the like
    grids stay within 5e-3 of the unmoved ones (the card-against-CPU bar),
    as do the densities."""
    lo, hi, per = _limits(chain["names"], chain["ranges"])
    kw = dict(limits_lo=lo, limits_hi=hi, periodic=per, like_weights=chain["lw32"])
    _, want = tb.triangle_densities(chain["s"], chain["w"], device="cpu", **kw)
    conv = tb.dft_conv2d
    rng = np.random.default_rng(3)

    def moved(grids, ur, ui, out_size, offset, pad):
        out = conv(grids, ur, ui, out_size, offset, pad)
        if out.dtype != torch.float32:
            return out
        sign = torch.from_numpy(rng.choice(np.float32([-1.0, 1.0]), size=tuple(out.shape)))
        return out + 1e-7 * out.abs().amax(dim=(1, 2), keepdim=True) * sign

    monkeypatch.setattr(tb, "dft_conv2d", moved)
    _, got = tb.triangle_densities(chain["s"], chain["w"], device="cpu", **kw)
    np.testing.assert_allclose(_np(got["likes"]), _np(want["likes"]), rtol=0, atol=5e-3)
    np.testing.assert_allclose(_np(got["P"]), _np(want["P"]), rtol=0, atol=5e-3)


@pytest.fixture(scope="module")
def entry_runs(chain):
    """The JAX method (x64 off) and the port's with meanlikes on the chain."""
    kw = dict(samples=chain["s"], weights=chain["w"], loglikes=chain["ll"], names=chain["names"],
              ranges=chain["ranges"])
    with jax.enable_x64(False):
        j1, j2, jpairs = JaxMCSamples(**kw).fastTriangleDensities(use_pallas=False, meanlikes=True)
        j1 = _np({k: v for k, v in j1.items() if v is not None})
        jreg = {key: _np(e) for key, e in j2["regrid"].items()}
        j2 = _np({k: v for k, v in j2.items() if k != "regrid" and v is not None})
    mc = MCSamples(device="cpu", **kw)
    t1, t2, tpairs = mc.fastTriangleDensities(meanlikes=True)
    return dict(j1=j1, j2=j2, jreg=jreg, jpairs=jpairs, t1=t1, t2=t2, tpairs=tpairs, mc=mc, kw=kw)


def test_entry_with_limits_periodic_meanlikes_matches_jax(chain, entry_runs):
    """Two programs on both sides; the same regrid keys and sizes; served
    grids within the zoo's 5e-3; the 1D densities and like curves within
    1e-4; the program's like grids against the JAX function in f64 on the
    port's own histograms and kernels at 5e-3."""
    r = entry_runs
    t1, t2, j1, j2 = r["t1"], r["t2"], r["j1"], r["j2"]
    assert "program_b" in r["mc"].fast_profile and r["tpairs"] == r["jpairs"]
    assert {k: int(e["P"].shape[0]) for k, e in t2["regrid"].items()} == {
        k: int(e["P"].shape[0]) for k, e in r["jreg"].items()}
    for key in ("active_lo", "active_hi", "periodic"):
        np.testing.assert_array_equal(_np(t1[key]), j1[key])
    np.testing.assert_allclose(_np(t1["P"]), j1["P"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(t1["likes"]), j1["likes"], rtol=0, atol=1e-4)
    for k, key in enumerate(r["tpairs"]):
        got = _np(t2["regrid"][key]["P"] if key in t2["regrid"] else t2["P"][k])
        want = r["jreg"][key]["P"] if key in r["jreg"] else j2["P"][k]
        np.testing.assert_allclose(got, want, rtol=0, atol=DEFAULT_TOL_2D, err_msg=str(key))
    lo, hi = _np(t1["range"][0]), _np(t1["range"][1])
    pa = np.array([a for a, _ in r["tpairs"]], np.int32)
    pb = np.array([b for _, b in r["tpairs"]], np.int32)
    fw = (hi - lo) / 255
    bw = (_np(t2["rx"]) * fw[pa], _np(t2["ry"]) * fw[pb], _np(t2["corr"]))
    s, w = chain["s32"], chain["w32"]
    ix = np.clip(((s - lo) / fw + 0.5).astype(np.int64), 0, 255)
    hists = np.stack([np.bincount(ix[:, b] * 256 + ix[:, a], weights=w, minlength=65536).reshape(256, 256)
                      for a, b in r["tpairs"]]).astype(np.float32)
    d1 = {"neff": _np(t1["neff"]), "range": (lo, hi)}
    kw = dict(hists_in=hists, active_lo=_np(t1["active_lo"]), active_hi=_np(t1["active_hi"]),
              periodic=_np(t1["periodic"]))
    want64 = _jax_f64_likes(chain, d1, pa, pb, hists, bw, kw)
    np.testing.assert_allclose(_np(t2["likes"]), want64, rtol=0, atol=LIKES_TOL)


def test_fast_densities_carry_like_grids(entry_runs, monkeypatch):
    """fastDensities(meanlikes=True) on the entry run's results (the
    method's own fastTriangleDensities call answered from the fixture, so
    the chain is not run again): each Density1D carries its like curve,
    each Density2D its like grid, from the program or, for a pair the
    entry reran, from the rerun (which bins the like weights at its own
    grid; the JAX package's reruns carry none)."""
    mc, names = entry_runs["mc"], entry_runs["kw"]["names"]
    t1, t2 = entry_runs["t1"], entry_runs["t2"]
    seen = []

    def served(**kwargs):
        seen.append(kwargs["meanlikes"])
        return t1, t2, entry_runs["tpairs"]

    monkeypatch.setattr(mc, "fastTriangleDensities", served)
    dens1, dens2 = mc.fastDensities(meanlikes=True)
    assert seen == [True]
    for i, name in enumerate(names):
        np.testing.assert_allclose(dens1[name].likes, _np(t1["likes"][i]), rtol=1e-6, atol=1e-7)
    for k, (a, b) in enumerate(entry_runs["tpairs"]):
        density = dens2[(names[a], names[b])]
        if (a, b) in t2["regrid"]:
            rerun = _np(t2["regrid"][(a, b)]["likes"])
            assert rerun.shape == density.P.shape and rerun.max() == 1.0
            np.testing.assert_allclose(density.likes, rerun, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(density.likes, _np(t2["likes"][k]), rtol=1e-6, atol=1e-7)


def test_like_weights_cache_follows_the_samples(chain):
    """The f32 like weights are cached with the chain and dropped with it;
    without meanlikes no density carries likes."""
    names = chain["names"][2:5]  # two-sided, two periodic
    kw = dict(samples=chain["s"][:3000, 2:5], weights=chain["w"][:3000], loglikes=chain["ll"][:3000], names=names,
              ranges={n: chain["ranges"][n] for n in names})
    mc = MCSamples(device="cpu", **kw)
    dens1, dens2 = mc.fastDensities()
    assert all(d.likes is None for d in list(dens1.values()) + list(dens2.values()))
    assert mc._fast_chain_cache["like_weights"] is None
    mc.fastTriangleDensities(meanlikes=True)
    st = mc._fast_chain_cache
    np.testing.assert_allclose(st["like_weights"].numpy(), mc._likelihood_weights().astype(np.float32), rtol=1e-6)
    mc.setSamples(kw["samples"], kw["weights"] * 2, loglikes=kw["loglikes"])
    assert mc._fast_chain_cache is None


# ---------------------------------------------------------------------------
# host periodic 1D density
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smooth_scale", [None, 3.0], ids=["auto", "fixed"])
def test_host_periodic_1d_density_matches_jax(smooth_scale):
    """A wrapped-normal chain on [0, 2 pi): the port's host
    ``get1DDensityGridData`` against the JAX package's at its periodic
    tests' tolerance (``tests/test_periodic_pallas.py``, 2e-6)."""
    rng = np.random.RandomState(5)
    n = 25_000
    phase = np.mod(rng.standard_normal(n) * 0.6 + 3.0, 2 * np.pi)
    kw = dict(samples=np.column_stack([phase, rng.standard_normal(n)]), names=["phi", "y"],
              ranges={"phi": [0, 2 * np.pi, True]})
    extra = {} if smooth_scale is None else {"smooth_scale_1D": smooth_scale}
    got = MCSamples(device="cpu", **kw).get1DDensityGridData("phi", **extra)
    want = JaxMCSamples(**kw).get1DDensityGridData("phi", **extra)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-12)
    np.testing.assert_allclose(got.P, want.P, atol=2e-6)
    assert got.P[0] == got.P[-1]
