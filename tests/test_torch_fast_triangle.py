"""getdist_tpu_torch's public fused entry against the JAX package.

``MCSamples.fastTriangleDensities`` / ``fastDensities`` on unbounded chains
and the pieces they run: ``kde_bandwidth.bin_samples``, the per-pair host
sheared bandwidths (``_optimize_bandwidth_sheared`` and the sheared branch
of ``getAutoBandwidth2D``), ``pair_cumulant_score``, in-program pair
histograms past 256 bins, the regrid rescue and the clamped-window rescue.
Both sides get the same numpy inputs; the JAX side runs in 32-bit mode
(``jax.enable_x64(False)``, the f32 program a device runs) and the port on
the CPU (its kernels' plain versions). The host f64 pieces are held at
rtol 1e-10, the device stages at ``tests/test_torch_batched.py``'s
tolerances, and served grids at ``tests/test_zoo_fidelity.py``'s budget.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from getdist_tpu import kde_bandwidth as jkde  # noqa: E402
from getdist_tpu.mcsamples import MCSamples as JaxMCSamples  # noqa: E402
from getdist_tpu.ops import batched as jb  # noqa: E402
from getdist_tpu_torch import kde_bandwidth as tkde  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from getdist_tpu_torch.ops import batched as tb  # noqa: E402
from test_batched import make_chain  # noqa: E402
from test_zoo_fidelity import DEFAULT_TOL_2D  # noqa: E402

CONTOURS = (0.68, 0.95)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair_chain():
    """80k x 6 chain of bench.py's construction (every 10th sample of its
    AR(1) walk, so N_eff is close to N) whose last column is replaced by a
    0.95-correlated copy of the first: |corr| in [0.943, 0.954) stretches
    that pair's fine grid to 576 bins. (On 20k samples of the unthinned
    walk, N_eff ~ 2k, every pair's kernel saturates the fused window, and
    the clamped rescue serves every pair at 256 bins, on both sides.)"""
    samples, weights = bench.make_chain(800_000, 6, seed=11)
    samples, weights = samples[::10].copy(), weights[::10].copy()
    rng = np.random.RandomState(12)
    z = (samples[:, 0] - samples[:, 0].mean()) / samples[:, 0].std()
    samples[:, 5] = 0.95 * z + np.sqrt(1 - 0.95**2) * rng.standard_normal(len(z))
    return samples, weights


def _names(p):
    return [f"p{i}" for i in range(p)]


@pytest.fixture(scope="module")
def pair_runs():
    """The JAX method (x64 off) and the port's on the 0.95-correlated chain,
    each from a fresh MCSamples, with the route each took."""
    samples, weights = _pair_chain()
    kw = dict(samples=samples, weights=weights, names=_names(6))
    calls = []
    orig = jb._triangle_program

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    jb._triangle_program = counted
    try:
        with jax.enable_x64(False):
            j1, j2, jpairs = JaxMCSamples(**kw).fastTriangleDensities(use_pallas=False)
            j1 = {k: (tuple(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v)) for k, v in j1.items()
                  if v is not None}
            jreg = {key: {n: np.asarray(v) for n, v in e.items()} for key, e in j2["regrid"].items()}
            j2 = {k: np.asarray(v) for k, v in j2.items() if k != "regrid" and v is not None}
    finally:
        jb._triangle_program = orig
    mc = MCSamples(device="cpu", **kw)
    t1, t2, tpairs = mc.fastTriangleDensities()
    return dict(j1=j1, j2=j2, jreg=jreg, jpairs=jpairs, jax_single=bool(calls), t1=t1, t2=t2, tpairs=tpairs, mc=mc,
                kw=kw)


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbins", [256, 576, 2046])
@pytest.mark.parametrize("limits", [(None, None), (-1.5, None), (None, 2.0), (-3.0, 3.5)], ids=["free", "lo", "hi", "both"])
def test_bin_samples_bit_exact(nbins, limits):
    x = np.random.default_rng(3).standard_normal(5000) * 1.3 + 0.2
    got_ix, got_w = tkde.bin_samples(x, *limits, nbins=nbins)
    want_ix, want_w = jkde.bin_samples(x, *limits, nbins=nbins)
    np.testing.assert_array_equal(got_ix, want_ix)
    assert got_ix.dtype == want_ix.dtype
    assert got_w == want_w


def _sheared_chain():
    """Two correlated pairs (one with a bounded member, which shears on the
    other axis) and a free parameter."""
    rng = np.random.RandomState(21)
    n = 15000
    base = rng.standard_normal((n, 4))
    x = base[:, 0]
    y = 0.7 * x + 0.8 * base[:, 1] ** 2
    z = np.abs(base[:, 2]) + 0.1
    u = 0.6 * z + 0.4 * base[:, 3]
    return dict(samples=np.column_stack([x, y, z, u]), weights=rng.randint(1, 4, n).astype(np.float64),
                names=["x", "y", "z", "u"], ranges={"z": [0, None]})


@pytest.mark.parametrize("pair", [(0, 1), (2, 3), (3, 2)], ids=["free", "bounded-lead", "bounded-other"])
def test_sheared_bandwidths_match_jax(pair):
    """The per-pair f64 host sheared optimizer, alone and as
    getAutoBandwidth2D's sheared branch (no sheared_result): rtol 1e-10."""
    kw = _sheared_chain()
    jmc, tmc = JaxMCSamples(**kw), MCSamples(device="cpu", **kw)
    i, j = pair
    results = []
    for mc in (jmc, tmc):
        parx, pary = mc._initParamRanges(i), mc._initParamRanges(j)
        corr = mc.getCorrelationMatrix()[j][i]
        neff = min(mc._get1DNeff(parx, i), mc._get1DNeff(pary, j))
        alone = mc._optimize_bandwidth_sheared(parx, pary, i, j, neff, 256)
        branch = mc.getAutoBandwidth2D(None, parx, pary, i, j, corr, 1.0, 1.0, 256, N_eff=neff)
        assert 0.2 < abs(corr) <= mc.max_corr_2D and not (parx.has_limits and pary.has_limits)
        results.append(np.array(alone + branch, float))
    np.testing.assert_allclose(results[1], results[0], rtol=1e-10, atol=0)


def test_make2dhist_matches_jax():
    kw = _sheared_chain()
    rng = np.random.default_rng(4)
    ix, iy = rng.integers(0, 200, 15000), rng.integers(0, 150, 15000)
    got = MCSamples(device="cpu", **kw)._make2Dhist(ix, iy, 200, 150)
    want = JaxMCSamples(**kw)._make2Dhist(ix, iy, 200, 150)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pair_cumulant_score_matches_jax():
    """f32 on both sides. Fourth moments of a heavy-tailed column (kurtosis
    ~10) summed in f32: the JAX function's sums on the CPU are 5e-4 from
    its own f64 result on this chain, the port's 4e-5. So the port is held
    to 1e-4 of the f64 result and to 1e-3 of the f32 JAX one."""
    kw = _sheared_chain()
    s = kw["samples"].astype(np.float32)
    w = kw["weights"].astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jb.pair_cumulant_score(jnp.asarray(s), jnp.asarray(w)))
    with jax.enable_x64(True):
        exact = np.asarray(jb.pair_cumulant_score(jnp.asarray(s, jnp.float64), jnp.asarray(w, jnp.float64)))
    got = tb.pair_cumulant_score(torch.from_numpy(s), torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got, exact, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)


# ---------------------------------------------------------------------------
# in-program pair histograms past 256 bins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fine", [384, 576])
def test_in_program_histograms_past_256_bins_match_jax(fine):
    """all_2d_densities binning in-program at the regrid's fine grids (the
    JAX side with use_pallas=False), at its window max(30, fine / 9)."""
    samples, weights = make_chain(n=20000, p=4)
    s, w = samples.astype(np.float32), weights.astype(np.float32)
    with jax.enable_x64(False):
        d1 = {k: np.asarray(v) for k, v in jb.all_1d_densities(jnp.asarray(s), jnp.asarray(w)).items()
              if k in ("neff", "sigma_range")}
        lo, hi = (np.asarray(r) for r in jb.all_1d_densities(jnp.asarray(s), jnp.asarray(w))["range"])
    pa, pb = (x.astype(np.int32) for x in np.triu_indices(4, 1))
    args = (s, w, pa, pb, d1["neff"], lo, hi, np.array(CONTOURS, np.float32))
    kw = dict(fine_bins=fine, winw=max(30, round(fine / 9)), sigma_range=d1["sigma_range"], max_corr=0.99,
              export_hists=True)
    with jax.enable_x64(False):
        want = jb.all_2d_densities(*(jnp.asarray(a) for a in args), use_pallas=False,
                                   **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        want = {k: np.asarray(v) for k, v in want.items() if v is not None}
    got = {k: _np(v) for k, v in tb.all_2d_densities(*(torch.from_numpy(np.array(a)) for a in args[:2]), *args[2:],
                                                      int8_weights=True, **kw).items() if v is not None}
    assert got["hists"].shape == (6, fine, fine)
    np.testing.assert_array_equal(got["hists"], want["hists"])
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3)
    np.testing.assert_allclose(got["P"], want["P"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got["contours"], want["contours"], rtol=0.02)


# ---------------------------------------------------------------------------
# the public entry on the 0.95-correlated chain
# ---------------------------------------------------------------------------


def test_two_program_route_regrids_the_tight_pair_at_576(pair_runs):
    r = pair_runs
    assert not r["jax_single"] and "program_a" in r["mc"].fast_profile  # both took the two-program route
    assert r["tpairs"] == r["jpairs"]
    assert set(r["t2"]["regrid"]) == set(r["jreg"]) == {(0, 5)}
    assert r["t2"]["regrid"][(0, 5)]["P"].shape == r["jreg"][(0, 5)]["P"].shape == (576, 576)


# Knife edge of the JAX side: on the CPU its f32 odd functionals psi_31 /
# psi_13 (a near-total cancellation of FFT power) come out above their
# Cauchy-Schwarz bound on most pairs of this chain, so the clamp binds, the
# pair is flagged FRAGILE and its correlation search runs on the clamped
# values; the port's f32 values agree with f64 to ~1e-6 and stay inside the
# bound. Kernel widths are held at rtol 1e-3 where the JAX side did not
# flag the pair; every grid is held at the zoo's budget.


def test_two_program_route_matches_jax(pair_runs):
    r = pair_runs
    t1, t2, j1, j2 = r["t1"], r["t2"], r["j1"], r["j2"]
    np.testing.assert_allclose(_np(t1["neff"]), j1["neff"], rtol=1e-4)
    np.testing.assert_allclose(_np(t1["host_pack"]), j1["host_pack"], rtol=1e-4)
    np.testing.assert_allclose(_np(t1["P"]), j1["P"], rtol=0, atol=1e-4)
    calm = ~j2["fragile"]
    assert calm.any()
    for key in ("rx", "ry", "corr"):
        np.testing.assert_allclose(_np(t2[key])[calm], j2[key][calm], rtol=1e-3)
    np.testing.assert_allclose(_np(t2["P"]), j2["P"], rtol=0, atol=DEFAULT_TOL_2D)
    np.testing.assert_allclose(_np(t2["contours"]), j2["contours"], rtol=0.02)
    for key, want in r["jreg"].items():
        got = t2["regrid"][key]
        np.testing.assert_allclose(_np(got["P"]), want["P"], rtol=0, atol=DEFAULT_TOL_2D)
        np.testing.assert_allclose(_np(got["contours"]), want["contours"], rtol=0.02)
        for name in ("rx", "ry", "corr", "neff"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-3)


def test_fast_densities_objects_match_jax(pair_runs):
    kw = pair_runs["kw"]
    with jax.enable_x64(False):
        jd1, jd2 = JaxMCSamples(**kw).fastDensities(use_pallas=False)
    mc = MCSamples(device="cpu", **kw)
    td1, td2 = mc.fastDensities()
    assert list(td1) == list(jd1) and list(td2) == list(jd2)
    for name, want in jd1.items():
        got = td1[name]
        np.testing.assert_allclose(got.x, want.x, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.P, want.P, rtol=0, atol=1e-4)
        assert mc.density1D[name] is got
    for key, want in jd2.items():
        got = td2[key]
        assert got.P.shape == want.P.shape
        np.testing.assert_allclose(got.x, want.x, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.y, want.y, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.P, want.P, rtol=0, atol=DEFAULT_TOL_2D)
        np.testing.assert_allclose(got.contours, want.contours, rtol=0.02)
    assert td2[("p0", "p5")].P.shape == (576, 576)


def test_clamped_rescue_matches_jax(pair_runs):
    """The saturated-window rescue (winw 126 at 256 bins, a 768 frame) on
    two pairs whose reported widths sit at the fused program's cap, with
    the same 1D inputs on both sides: (1, 3), which the JAX side does not
    flag, and (1, 4), which it does (kernel widths held on the first)."""
    r = pair_runs
    kw, pairs = r["kw"], r["jpairs"]
    j1 = r["j1"]
    idx = list(range(6))
    k = len(pairs)
    rx = np.full(k, 3.0, np.float32)
    ry = np.full(k, 3.0, np.float32)
    calm, flagged = pairs.index((1, 3)), pairs.index((1, 4))
    assert not r["j2"]["fragile"][calm] and r["j2"]["fragile"][flagged]
    rx[calm], ry[flagged] = 12.0, 12.5  # at or past the cap 30 / 2.5
    with jax.enable_x64(False):
        jmc = JaxMCSamples(**kw)
        d1j = {key: (tuple(jnp.asarray(v) for v in j1[key]) if key == "range" else jnp.asarray(j1[key]))
               for key in ("neff", "range", "sigma_range")}
        d2j = {"regrid": {}}
        jmc._fast_rescue_clamped_pairs(idx, pairs, d1j, d2j, CONTOURS, None, None, np.zeros(6, bool),
                                       rx_host=rx, ry_host=ry)
        want = {key: {n: np.asarray(v) for n, v in e.items()} for key, e in d2j["regrid"].items()}
    d1t = {key: j1[key] for key in ("neff", "range", "sigma_range")}
    d2t = {"regrid": {}}
    MCSamples(device="cpu", **kw)._fast_rescue_clamped_pairs(idx, pairs, d1t, d2t, CONTOURS, rx_host=rx, ry_host=ry)
    assert set(d2t["regrid"]) == set(want) == {(1, 3), (1, 4)}
    for key, w in want.items():
        got = {n: _np(v) for n, v in d2t["regrid"][key].items()}
        assert got["P"].shape == (256, 256)
        if key == (1, 3):
            for name in ("rx", "ry", "corr"):
                np.testing.assert_allclose(got[name], w[name], rtol=1e-3)
            np.testing.assert_allclose(got["P"], w["P"], rtol=0, atol=5e-4)
        np.testing.assert_allclose(got["P"], w["P"], rtol=0, atol=DEFAULT_TOL_2D)
        np.testing.assert_allclose(got["contours"], w["contours"], rtol=0.02)


def test_fast_chain_cache_follows_the_samples():
    samples, weights = make_chain(n=3000, p=3)
    mc = MCSamples(samples=samples, weights=weights, names=_names(3), device="cpu")
    mc.fastTriangleDensities()
    st = mc._fast_chain_cache
    assert st is not None and st["int8"] and mc._fast_chain_state() is st
    mc.setSamples(samples, weights * 2)
    assert mc._fast_chain_cache is None
    mc.fastTriangleDensities()
    np.testing.assert_array_equal(mc._fast_chain_cache["weights"].numpy(), (weights * 2).astype(np.float32))
    mc.filter(samples[:, 0] > -1)
    assert mc._fast_chain_cache is None
    mc.fastTriangleDensities()
    assert mc._fast_chain_cache["samples"].shape == (int(np.sum(samples[:, 0] > -1)), 3)


@pytest.mark.parametrize(
    "case,item",
    [("limits", "A2/A3"), ("periodic", "A2/A3"), ("meanlikes", "A2/A3"), ("mesh", "A9"), ("parity", "A8")],
)
def test_unported_fast_branches_raise(case, item):
    """``mesh=`` (ROADMAP A9) and the host parity variant (A8) raise. The
    branches that raised naming A2/A3 until they were ported (a lower limit
    at a column's minimum, a periodic column, meanlikes grids with
    loglikes) run and match the JAX method: the same regrid keys, served
    grids within the zoo's budget, 1D (and its like curves) within 1e-4."""
    samples, weights = make_chain(n=2000, p=3)
    kw = dict(samples=samples, weights=weights, names=_names(3), device="cpu")
    call = "fastTriangleDensities"
    args = {}
    if case == "limits":
        kw["ranges"] = {"p0": [float(samples[:, 0].min()), None]}
    elif case == "periodic":
        kw["ranges"] = {"p1": [float(samples[:, 1].min()), float(samples[:, 1].max()), True]}
    elif case == "meanlikes":
        kw["loglikes"] = 0.5 * np.sum(samples**2, axis=1)
        args["meanlikes"] = True
    elif case == "mesh":
        args["mesh"] = object()
    else:
        call, args = "fastDensities", {"parity": True}
    if case in ("mesh", "parity"):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            getattr(MCSamples(**kw), call)(**args)
        return
    t1, t2, pairs = MCSamples(**kw).fastTriangleDensities(**args)
    jkw = {k: v for k, v in kw.items() if k != "device"}
    with jax.enable_x64(False):
        j1, j2, _ = JaxMCSamples(**jkw).fastTriangleDensities(use_pallas=False, **args)
        jgrids = {key: np.asarray(j2["regrid"][key]["P"] if key in j2["regrid"] else j2["P"][k])
                  for k, key in enumerate(pairs)}
        j1 = {k: np.asarray(v) for k, v in j1.items() if v is not None and not isinstance(v, tuple)}
    assert set(t2["regrid"]) == set(j2["regrid"])
    np.testing.assert_allclose(_np(t1["P"]), j1["P"], rtol=0, atol=1e-4)
    if case == "meanlikes":
        np.testing.assert_allclose(_np(t1["likes"]), j1["likes"], rtol=0, atol=1e-4)
    else:
        assert bool(_np(t1["active_lo"])[0] or _np(t1["periodic"])[1])
    for k, key in enumerate(pairs):
        got = _np(t2["regrid"][key]["P"] if key in t2["regrid"] else t2["P"][k])
        np.testing.assert_allclose(got, jgrids[key], rtol=0, atol=DEFAULT_TOL_2D)
