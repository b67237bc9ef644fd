"""The port's host MCSamples analysis API against the JAX package.

A chain root written here with ``tests/fixtures/realchain.py`` (27
parameters, 4 chains of 12000 rows, integer weights, loglikes), its
``.ranges`` giving a lower-limited ``tau`` and ``aksz`` and a periodic
``xi``, is loaded by both packages, and both run the host path: the JAX
package on its CPU backend and the port with ``device="cpu"``. The JAX
side runs with x64 off, where its statistics take their numpy branches,
the port's arithmetic (with x64 on, its CPU backend sums the chains' means
and covariances in XLA, which flips the sign of a Gelman-Rubin eigenvalue
at round-off). Held byte for byte: ``.margestats``, ``.likestats`` and
``.converge``, ``getTable().tableTex()``, ``getLatex()`` and
``getInlineLatex`` on a two-tail, a one-tail and a periodic parameter;
within 1e-12: the host 1D and 2D grids, with and without mean likelihoods,
the 2D effective sample number and the chain statistics (Gelman-Rubin,
thinning, cooling, derived parameters, the separate chains).

Then the routing onto the fused program, with ``GETDIST_TPU_TORCH_FUSED=1``
on a CPU object (the kernels' plain versions), against the JAX package's
routing (``GETDIST_TPU_FUSED=1``) at ``tests/test_fused_routing.py``'s
bars, on that file's chain: one fused program serves ``getMargeStats``, an
error inside it reaches the caller, and the queries the host serves by
design are counted.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import getdist_tpu  # noqa: E402
import getdist_tpu_torch  # noqa: E402
import jax  # noqa: E402
from fixtures import realchain  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import mcsamples as tmcsamples  # noqa: E402

RANGES = "tau 0.01 N\nxi 0 1 periodic\naksz 0 N\n"
ALL_TESTS = ("MeanVar", "GelmanRubin", "SplitTest", "RafteryLewis", "CorrLengths", "CorrSteps")


@contextlib.contextmanager
def jax_numpy_stats():
    """The JAX package's host path with its numpy statistics (x64 off)."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("host_api")
    root = realchain.generate(base)
    with open(root + ".ranges", "w", encoding="utf-8") as handle:
        handle.write(RANGES)
    return root


@pytest.fixture(scope="module")
def loaded(root, tmp_path_factory):
    """(port, jax) MCSamples of the root, the caches under a tmp dir, the
    fused route switch unset (a CPU object takes the host path)."""
    caches = tmp_path_factory.mktemp("caches")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(getdist_tpu_torch, "cache_dir", str(caches / "torch"))
        mp.setattr(getdist_tpu, "cache_dir", str(caches / "jax"))
        mp.setattr(tchains, "print_load_details", False)
        mp.setattr(jchains, "print_load_details", False)
        mp.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
        mp.delenv("GETDIST_TPU_FUSED", raising=False)
        port = getdist_tpu_torch.loadMCSamples(root, device="cpu", no_cache=True)
        with jax_numpy_stats():
            jax_mc = getdist_tpu.loadMCSamples(root, no_cache=True)
        yield port, jax_mc


@pytest.fixture(scope="module")
def outputs(loaded, tmp_path_factory):
    """Each text output of both packages: {key: (port, jax)}."""
    port, jax_mc = loaded
    folder = tmp_path_factory.mktemp("outputs")
    assert not port._fused_route_enabled()
    texts = {}
    for which, mc in (("port", port), ("jax", jax_mc)):
        with jax_numpy_stats():
            marge = mc.getMargeStats()
            marge.saveAsText(str(folder / f"{which}.margestats"))
            mc.getLikeStats().saveAsText(str(folder / f"{which}.likestats"))
            mc.getConvergeTests(writeDataToFile=True, filename=str(folder / f"{which}.converge"))
            every = mc.getConvergeTests(what=ALL_TESTS)
            one_tail = [p.name for p in marge.names if p.limits[1].limitTag() in ("<", ">")]
            texts[which] = {
                "margestats": (folder / f"{which}.margestats").read_bytes(),
                "likestats": (folder / f"{which}.likestats").read_bytes(),
                "converge": (folder / f"{which}.converge").read_bytes(),
                "converge_all_six": every,
                "tableTex": mc.getTable().tableTex(),
                "tableTex_two_columns": mc.getTable(columns=2, limit=1).tableTex(),
                "getLatex": mc.getLatex(limit=2),
                "inline": [mc.getInlineLatex(p, limit=lim) for p in ("omegabh2", "aksz", "xi") for lim in (1, 2)],
                "one_tail": one_tail,
                "summary": mc.getNumSampleSummaryText(),
            }
    return texts


OUTPUT_KEYS = ("margestats", "likestats", "converge", "converge_all_six", "tableTex", "tableTex_two_columns",
               "getLatex", "inline", "summary")


@pytest.mark.parametrize("key", OUTPUT_KEYS)
def test_text_outputs_byte_identical_to_jax(outputs, key):
    """.margestats, .likestats and .converge (the default battery, and all
    six tests: integer weights run Raftery-Lewis and the step table), the
    latex table in one and two columns, getLatex, getInlineLatex and the
    sample summary, byte for byte."""
    assert outputs["port"][key] == outputs["jax"][key]
    assert outputs["port"][key]


def test_limit_kinds_cover_two_tail_one_tail_periodic(outputs, loaded):
    """The inline latex above covers a two-tail (omegabh2), a one-tail
    (aksz: its 95% limit is one-tailed at its lower bound) and a periodic
    (xi, no constraint at 95%) parameter."""
    assert "aksz" in outputs["port"]["one_tail"]
    marge = loaded[0].getMargeStats()
    assert marge.parWithName("omegabh2").limits[1].limitTag() == "two"
    assert marge.parWithName("xi").limits[1].limitTag() == "none"
    assert loaded[0].paramNames.parWithName("xi").periodic


@pytest.mark.parametrize("name", ["omegabh2", "tau", "xi", "aksz"])
def test_host_1d_densities_match_jax(loaded, name):
    """get1DDensity on free, lower-limited and periodic parameters, and
    the mean-likelihood curve, within 1e-12 of the JAX host grids."""
    port, jax_mc = loaded
    with jax_numpy_stats():
        want = jax_mc.get1DDensity(name)
        want_likes = jax_mc.get1DDensityGridData(name, meanlikes=True).likes
    got = port.get1DDensity(name)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_allclose(got.P, want.P, rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.get1DDensityGridData(name, meanlikes=True).likes, want_likes, rtol=0, atol=1e-12)


def _strongest_free_pair(mc):
    free = [i for i, p in enumerate(mc.paramNames.names) if not (p.has_limits_bot or p.has_limits_top or p.periodic)]
    corr = np.abs(mc.getCorrelationMatrix())
    return max(((a, b) for a in free for b in free if a < b), key=lambda ab: corr[ab])


@pytest.mark.parametrize("kind", ["free_free", "limited_free", "periodic_free", "limited_periodic", "meanlikes"])
def test_host_2d_densities_match_jax(loaded, kind):
    """get2DDensityGridData on free x free (the most correlated free pair:
    a sheared bandwidth and a corr-adapted fine grid), limited x free,
    periodic x free, limited x periodic and with mean likelihoods, within
    1e-12 of the JAX host grids; get2DDensity is its normalized density."""
    port, jax_mc = loaded
    a, b = _strongest_free_pair(port)
    pair, meanlikes = {
        "free_free": ((a, b), False),
        "limited_free": (("tau", "omegabh2"), False),
        "periodic_free": (("xi", "omegach2"), False),
        "limited_periodic": (("aksz", "xi"), False),
        "meanlikes": (("tau", "omegabh2"), True),
    }[kind]
    with jax_numpy_stats():
        want = jax_mc.get2DDensityGridData(*pair, meanlikes=meanlikes)
    got = port.get2DDensityGridData(*pair, meanlikes=meanlikes)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_allclose(got.P, want.P, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.contours, want.contours, rtol=1e-12)
    if meanlikes:
        np.testing.assert_allclose(got.likes, want.likes, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(port.get2DDensity(*pair).P, got.P, rtol=0, atol=1e-15)


@pytest.mark.parametrize("case", ["free", "limited", "explicit_neff", "use_effective_samples_2D"])
def test_auto_bandwidth_2d_with_2d_neff_matches_jax(loaded, case):
    """getAutoBandwidth2D(use_2D_Neff=True), the 2D effective sample
    estimate (getEffectiveSamplesGaussianKDE_2d), no longer raises and
    equals the JAX package's within 1e-12, on a free and a limited pair.
    It is the width at an explicit N_eff of that estimate (an explicit
    N_eff still wins over use_2D_Neff), and ``use_effective_samples_2D``
    with ``use_2D_Neff=None`` takes it too."""
    pair = (3, 0) if case == "limited" else _strongest_free_pair(loaded[0])
    widths = []
    for mc in loaded:
        with jax_numpy_stats():
            parx, pary = mc._initParamRanges(pair[0]), mc._initParamRanges(pair[1])
            _, actual = mc._pair_correlation(pair[0], pair[1], parx, pary)
            ix, _, x_lo, x_hi = mc._binSamples(mc.samples[:, pair[0]], parx, 256)
            iy, _, y_lo, y_hi = mc._binSamples(mc.samples[:, pair[1]], pary, 256)
            hist = mc._make2Dhist(ix, iy, 256, 256)[0]
            args = (hist, parx, pary, pair[0], pair[1], actual, x_hi - x_lo, y_hi - y_lo, 256)
            direct = mc.getAutoBandwidth2D(*args, use_2D_Neff=True)
            if case == "explicit_neff":
                neff = mc.getEffectiveSamplesGaussianKDE_2d(*pair)
                assert direct == mc.getAutoBandwidth2D(*args, N_eff=neff)
                assert mc.getAutoBandwidth2D(*args, N_eff=neff / 4, use_2D_Neff=True) != direct
            elif case == "use_effective_samples_2D":
                before = mc.use_effective_samples_2D
                mc.use_effective_samples_2D = True
                try:
                    assert mc.getAutoBandwidth2D(*args, use_2D_Neff=None) == direct
                finally:
                    mc.use_effective_samples_2D = before
            widths.append(direct)
    np.testing.assert_allclose(widths[0], widths[1], rtol=1e-12)


def test_chain_statistics_match_jax(loaded):
    """getGelmanRubin (and its eigenvalues), the 2D KDE effective sample
    number, the separate chains and their means, within 1e-12."""
    port, jax_mc = loaded
    with jax_numpy_stats():
        want_gr = jax_mc.getGelmanRubin(), jax_mc.getGelmanRubinEigenvalues()
        want_neff = jax_mc.getEffectiveSamplesGaussianKDE_2d(0, 1), jax_mc.getEffectiveSamplesGaussianKDE_2d("tau", "xi")
        want_chains = [c.getMeans() for c in jax_mc.getSeparateChains()]
    np.testing.assert_allclose(port.getGelmanRubin(), want_gr[0], rtol=1e-12)
    np.testing.assert_allclose(port.getGelmanRubinEigenvalues(), want_gr[1], rtol=1e-12, atol=1e-15)
    got_neff = port.getEffectiveSamplesGaussianKDE_2d(0, 1), port.getEffectiveSamplesGaussianKDE_2d("tau", "xi")
    np.testing.assert_allclose(got_neff, want_neff, rtol=1e-12)
    got_chains = port.getSeparateChains()
    assert len(got_chains) == realchain.NCHAIN
    for got, want in zip(got_chains, want_chains):
        np.testing.assert_allclose(got.getMeans(), want, rtol=1e-12)


@pytest.mark.parametrize("op", ["thin", "weighted_thin", "cool", "addDerived", "reweight"])
def test_sample_transforms_match_jax(loaded, op):
    """thin / weighted_thin (per chain, keeping the chain offsets), cool,
    addDerived with a range and importance reweighting: the same samples,
    weights and loglikes, and the same marginalized statistics after."""
    results = []
    for mc in loaded:
        with jax_numpy_stats():
            mc = mc.copy()
            if op == "thin":
                mc.thin(3)
            elif op == "weighted_thin":
                mc.weighted_thin(4)
            elif op == "cool":
                mc.cool(2.0)
            elif op == "addDerived":
                mc.addDerived(mc.samples[:, 0] + mc.samples[:, 3], "sum03", label=r"\Sigma", range=[0, None])
            else:
                mc.reweightAddingLogLikes(0.1 * mc.samples[:, 1] ** 2)
            mc.updateBaseStatistics()
            results.append((mc.samples, mc.weights, mc.loglikes, mc.chain_offsets, mc.getMeans(), mc.getVars(),
                            mc.paramNames.list(), str(mc.getLikeStats())))
    (s1, w1, l1, o1, m1, v1, n1, t1), (s2, w2, l2, o2, m2, v2, n2, t2) = results
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_allclose(m1, m2, rtol=1e-12)
    np.testing.assert_allclose(v1, v2, rtol=1e-12)
    assert n1 == n2 and t1 == t2


# -- the routing onto the fused program --------------------------------------------------------


def _routing_chain():
    """tests/test_fused_routing.py's chain, with loglikes for the
    mean-likelihood grids: x, y at corr 0.6 and z >= 0."""
    rng = np.random.default_rng(17)
    n = 40000
    x = rng.normal(size=n)
    y = 0.6 * x + 0.8 * rng.normal(size=n)
    z = np.abs(rng.normal(size=n))
    return dict(samples=np.c_[x, y, z], loglikes=0.5 * (x * x + y * y), names=["x", "y", "z"],
                labels=["x", "y", "z"], ranges={"z": [0, None]})


@pytest.fixture(scope="module")
def routed():
    """(port routed, JAX routed, port host): the port's route forced on a
    CPU object, the JAX package's by GETDIST_TPU_FUSED=1."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchains, "print_load_details", False)
        mp.setattr(jchains, "print_load_details", False)
        mp.setenv("GETDIST_TPU_TORCH_FUSED", "1")
        mp.setenv("GETDIST_TPU_FUSED", "1")
        port = tmcsamples.MCSamples(device="cpu", **_routing_chain())
        jax_mc = getdist_tpu.MCSamples(**_routing_chain())
        assert port._fused_route_enabled() and jax_mc._fused_route_enabled()
        out = {"marge": (port.getMargeStats(), jax_mc.getMargeStats()), "cache": sorted(port._fused_cache)}
        out["1d"] = {p: (port.get1DDensity(p), jax_mc.get1DDensity(p)) for p in "xyz"}
        out["2d"] = {q: (port.get2DDensityGridData(*q), jax_mc.get2DDensityGridData(*q))
                     for q in (("x", "y"), ("z", "x"), ("y", "x"))}
        out["likes"] = (port.get2DDensityGridData("x", "y", meanlikes=True),
                        port.get1DDensityGridData("x", meanlikes=True))
        out["served"] = port.fast_profile.get("host_served")
        out["regrid_likes"] = port.get2DDensityGridData("x", "z", meanlikes=True)
        out["unknown"] = port.get1DDensityGridData("nope")
        out["served_after"] = port.fast_profile.get("host_served")
        out["groups"] = port.fast_regrid_groups
        out["cache_after"] = sorted(port._fused_cache)
        mp.setenv("GETDIST_TPU_TORCH_FUSED", "0")
        host = tmcsamples.MCSamples(device="cpu", **_routing_chain())
        assert not host._fused_route_enabled() and not port._fused_route_enabled()
        out["host_likes"] = (host.get2DDensityGridData("x", "y", meanlikes=True),
                             host.get1DDensityGridData("x", meanlikes=True))
        out["regrid_host"] = host.get2DDensityGridData("x", "z", meanlikes=True)
        yield out


def _max_diff_1d(a, b, likes=False):
    """Max difference of peak-normalized curves on 300 points of the common
    range (test_fused_routing's bar): densities by their splines, like
    curves interpolated."""
    grid = np.linspace(max(a.x[0], b.x[0]), min(a.x[-1], b.x[-1]), 300)
    if likes:
        fa, fb = (np.interp(grid, d.x, d.likes) for d in (a, b))
    else:
        fa, fb = (d.Prob(grid) / d.P.max() for d in (a, b))
    return np.max(np.abs(fa - fb))


def _max_diff_2d(a, b, likes=False):
    """Max difference of peak-normalized grids on 80^2 points where the
    second density is above 0.05 of its peak (test_fused_routing's bar):
    densities by their splines, like grids interpolated."""
    gx = np.linspace(max(a.x[0], b.x[0]), min(a.x[-1], b.x[-1]), 80)
    gy = np.linspace(max(a.y[0], b.y[0]), min(a.y[-1], b.y[-1]), 80)
    X, Y = np.meshgrid(gx, gy)
    sel = b(X.ravel(), Y.ravel(), grid=False) / b.P.max() > 0.05
    if likes:
        from scipy.interpolate import RectBivariateSpline

        fa, fb = (RectBivariateSpline(d.x, d.y, d.likes.T)(gx, gy).T.ravel() for d in (a, b))
    else:
        fa, fb = (d(X.ravel(), Y.ravel(), grid=False) / d.P.max() for d in (a, b))
    return np.max(np.abs(fa[sel] - fb[sel]))


@pytest.mark.parametrize("name", ["x", "y", "z"])
def test_routed_1d_matches_jax_routing(routed, name):
    got, want = routed["1d"][name]
    assert _max_diff_1d(got, want) < 6e-3


@pytest.mark.parametrize("pair", [("x", "y"), ("z", "x"), ("y", "x")])
def test_routed_2d_matches_jax_routing(routed, pair):
    """Free x free, limited x free and a transposed query."""
    got, want = routed["2d"][pair]
    assert _max_diff_2d(got, want) < 1.5e-2
    if pair == ("y", "x"):
        np.testing.assert_array_equal(got.P, routed["2d"][("x", "y")][0].P.T)


def test_routed_margestats_one_program(routed):
    """getMargeStats on a routed object runs one fused program (one cache
    entry), and its limits are the JAX routing's within 0.05 sd
    (test_fused_routing's bar against the host)."""
    assert routed["cache"] == [False]
    got, want = routed["marge"]
    for name in "xyz":
        p, q = got.parWithName(name), want.parWithName(name)
        assert [lim.limitTag() for lim in p.limits] == [lim.limitTag() for lim in q.limits]
        for k in range(2):
            for attr in ("lower", "upper"):
                assert abs(getattr(p.limits[k], attr) - getattr(q.limits[k], attr)) < 0.05 * q.err, (name, k, attr)


def test_routed_meanlikes_and_host_served(routed):
    """A meanlikes query runs its own cached fused run (K1 with like
    weights on the card) and carries like grids that track the host path's
    (the JAX package's f32 like grids are wrong, ROADMAP C10), on a pair
    the fused path reran too (the rerun bins the like weights at its own
    grid); only an unknown parameter is served by the host, and counted."""
    grid2, grid1 = routed["likes"]
    host2, host1 = routed["host_likes"]
    assert routed["cache_after"] == [False, True]
    assert grid2.likes.max() == 1.0 and grid1.likes is not None
    assert _max_diff_2d(grid2, host2, likes=True) < 1.5e-2
    assert _max_diff_1d(grid1, host1, likes=True) < 6e-3
    assert routed["served"] == 0
    assert any((0, 2) in g["pairs"] for g in routed["groups"])
    assert routed["regrid_likes"].likes.max() == 1.0
    assert _max_diff_2d(routed["regrid_likes"], routed["regrid_host"], likes=True) < 1.5e-2
    assert routed["unknown"] is None
    assert routed["served_after"] == 1


@pytest.mark.parametrize("stage", ["_triangle_program", "all_1d_densities"])
def test_fused_error_reaches_caller(monkeypatch, stage):
    """An exception inside the fused run propagates: no silent host
    fallback (the single-dispatch route and the two-program route)."""
    monkeypatch.setenv("GETDIST_TPU_TORCH_FUSED", "1")
    monkeypatch.setattr(tchains, "print_load_details", False)

    def broken(*args, **kwargs):
        raise RuntimeError("fused run failed")

    monkeypatch.setattr(tmcsamples, stage, broken)
    chain = _routing_chain()
    if stage == "_triangle_program":
        chain = dict(chain, samples=chain["samples"][:5000, :2], loglikes=None, names=["x", "y"],
                     labels=["x", "y"], ranges=None)
    mc = tmcsamples.MCSamples(device="cpu", **chain)
    with pytest.raises(RuntimeError, match="fused run failed"):
        mc.getMargeStats()


@pytest.mark.parametrize("setting", [None, "smooth_scale_1D", "boundary_correction_order", "mult_bias_correction_order",
                                     "smooth_scale_2D"])
def test_route_switch(monkeypatch, setting):
    """The route: off on a CPU object by default, on with the switch at 1,
    off at 0 and at any non-default convention."""
    monkeypatch.setattr(tchains, "print_load_details", False)
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    chain = _routing_chain()
    mc = tmcsamples.MCSamples(device="cpu", samples=chain["samples"][:2000], names=chain["names"])
    assert not mc._fused_route_enabled()
    monkeypatch.setenv("GETDIST_TPU_TORCH_FUSED", "1")
    if setting is None:
        assert mc._fused_route_enabled()
        monkeypatch.setenv("GETDIST_TPU_TORCH_FUSED", "0")
        assert not mc._fused_route_enabled()
    else:
        mc.updateSettings({setting: {"smooth_scale_1D": 0.5, "smooth_scale_2D": 2.0}.get(setting, 2)})
        assert not mc._fused_route_enabled()
