"""getdist_tpu_torch's device parity mode against the JAX package.

``MCSamples(...).fastParityDensities(device=True)`` on both sides, on the
same arrays: the port on the CPU (its kernels' plain versions), the JAX
package on the CPU in x64. Chains: three zoo shapes (a plain Gaussian, the
|corr| 0.99 "tight" shape, whose pair takes a 960-bin fine group, and a
hard-bounded Gaussian), the 3-parameter bounded chain of
tests/test_parity_device_mode.py, and an AR(1) chain of bench.py's
construction at 20k x 5; each has pairs that take the sheared branch. The
bar is parity mode's: 2D grids and contour levels within 1e-5 of the peak,
1D grids within 1e-10. Measured here: the first four within 5e-13 in 2D and
identical in 1D; the AR(1) chain, whose host N_eff differs by ~1e-16
between the two (lag-sum reduction order), within ~3e-8 in 2D.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import zoo  # noqa: E402
from getdist_tpu.mcsamples import MCSamples as JaxMCSamples  # noqa: E402
from getdist_tpu.ops import parity_device as jpdev  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples, MCSamplesError  # noqa: E402
from getdist_tpu_torch.ops import batched as tb  # noqa: E402

ZOO = ["Gaussian", "tight", "Gaussian [x>0]"]


def _zoo_chain(label):
    shape = zoo.shapes_2d(include_cut_gaussians=True)[label]
    pts = shape.sim(8000, random_state=np.random.default_rng(10))
    return dict(samples=pts, weights=None, names=shape.paramNames.list(), ranges=shape.lims)


def _bounded_chain():
    rng = np.random.RandomState(3)
    n = 12000
    base = rng.standard_normal((n, 2))
    x = base[:, 0]
    y = 0.75 * x + 0.66 * base[:, 1]
    z = np.abs(rng.standard_normal(n))  # bounded at 0
    w = rng.randint(1, 4, n).astype(np.float64)
    return dict(samples=np.column_stack([x, y, z]), weights=w, names=["x", "y", "z"], ranges={"z": [0, None]})


def _ar1_chain():
    samples, weights = bench.make_chain(20000, 5)
    return dict(samples=samples, weights=weights, names=[f"p{i}" for i in range(5)])


CHAINS = {label: (lambda label=label: _zoo_chain(label)) for label in ZOO}
CHAINS["bounded 3-param"] = _bounded_chain
CHAINS["AR(1) 20k x 5"] = _ar1_chain


@pytest.fixture(scope="module", params=list(CHAINS))
def both(request):
    kwargs = CHAINS[request.param]()
    want = JaxMCSamples(**kwargs).fastParityDensities(device=True)
    port = MCSamples(device="cpu", **kwargs)
    return port.fastParityDensities(device=True), want, port


def test_same_keys(both):
    (d1, d2), (w1, w2), _ = both
    assert set(d1) == set(w1)
    assert set(d2) == set(w2)


def test_1d_densities_match(both):
    (d1, _), (w1, _), _ = both
    for key in w1:
        np.testing.assert_array_equal(d1[key].x, w1[key].x)
        assert np.abs(d1[key].P - w1[key].P).max() <= 1e-10, key


def test_2d_densities_match(both):
    (_, d2), (_, w2), _ = both
    for key in w2:
        got, want = d2[key].P, w2[key].P
        assert got.shape == want.shape, key
        assert np.abs(got / got.max() - want / want.max()).max() <= 1e-5, key
        assert np.abs(np.asarray(d2[key].contours) - np.asarray(w2[key].contours)).max() <= 1e-5, key


def test_profile_stages_recorded(both):
    _, _, port = both
    assert list(port.parity_profile)[:3] == ["ranges", "chain_state", "device_hists"]
    assert all(t >= 0 for t in port.parity_profile.values())


def _jax_sheared_stack(mc, idx, infos, jobs):
    """The index rows of the JAX method's sheared stack, built step by step
    as ``getdist_tpu/mcsamples.py:1773-1892`` builds them."""
    nbins = mc.fine_bins_2D
    r00, r10, r11 = (np.empty(len(jobs)) for _ in range(3))
    lead_pos, other_pos = np.empty(len(jobs), np.int32), np.empty(len(jobs), np.int32)
    for i, (a, b) in enumerate(jobs):
        lead_loc, other_loc = (b, a) if infos[b].has_limits else (a, b)
        root = np.linalg.cholesky(mc.getCov(pars=[idx[lead_loc], idx[other_loc]]))
        r00[i], r10[i], r11[i] = root[0, 0], root[1, 0], root[1, 1]
        lead_pos[i], other_pos[i] = lead_loc, other_loc
    sub64 = jnp.asarray(mc.samples[:, idx])
    rows, rlo, rhi = jpdev.sheared_rows_minmax(sub64, *(jnp.asarray(x) for x in (other_pos, lead_pos, r00, r10, r11)))
    rlo, rhi = np.asarray(rlo), np.asarray(rhi)
    pad = (rhi - rlo) * 0.1
    rmin = rlo - pad
    resid_ix = jpdev.bin_rows(rows, jnp.asarray(rmin), jnp.asarray(((rhi + pad) - rmin) / (nbins - 1)))
    leads = sorted(set(lead_pos.tolist()))
    lead_lo, lead_dx = [], []
    for k in leads:
        col = mc.samples[:, idx[k]]
        lo_d, hi_d = float(col.min()), float(col.max())
        pad_l = (hi_d - lo_d) * 0.1
        lo = infos[k].range_min if infos[k].has_limits_bot else lo_d - pad_l
        hi = infos[k].range_max if infos[k].has_limits_top else hi_d + pad_l
        lead_lo.append(lo)
        lead_dx.append((hi - lo) / (nbins - 1))
    lead_ix = jpdev.bin_rows(sub64[:, np.asarray(leads)].T, jnp.asarray(lead_lo), jnp.asarray(lead_dx))
    return np.concatenate([np.asarray(lead_ix), np.asarray(resid_ix)])


@pytest.mark.parametrize("label", list(CHAINS))
def test_sheared_stack_indices_match_jax(label):
    """The lead and residual bin indices that K4 histograms for the sheared
    branch, bit for bit against the JAX method's. The port's residual rows
    are the unfused host formula, while XLA contracts r00 * x - r10 * y into
    an FMA (rows up to 4 ulps apart, tests/test_torch_parity_device.py); on
    these chains no index moves."""
    kwargs = CHAINS[label]()
    port = MCSamples(device="cpu", **kwargs)
    port.updateBaseStatistics()
    idx = list(range(port.n))
    infos = [port._initParamRanges(j) for j in idx]
    _, jobs = port._parity_pairs(idx, infos)
    assert jobs
    got = port._sheared_stack(idx, infos, jobs, port._parity_chain()["samples"])["ix"].numpy()
    mc = JaxMCSamples(**kwargs)
    mc.updateBaseStatistics()
    want = _jax_sheared_stack(mc, idx, [mc._initParamRanges(j) for j in idx], jobs)
    np.testing.assert_array_equal(got, want)


def test_tight_pair_takes_a_stretched_fine_group():
    kwargs = _zoo_chain("tight")
    _, d2 = MCSamples(device="cpu", **kwargs).fastParityDensities(device=True)
    (density,) = d2.values()
    assert density.P.shape == (960, 960)


def test_unmaterialized_groups_match():
    kwargs = _bounded_chain()
    port = MCSamples(device="cpu", **kwargs)
    _, dens2 = port.fastParityDensities(device=True)
    _, groups = MCSamples(device="cpu", **kwargs).fastParityDensities(device=True, materialize=False)
    _, j_groups = JaxMCSamples(**kwargs).fastParityDensities(device=True, materialize=False)
    assert [(g["pairs"], g["fine"]) for g in groups] == [(g["pairs"], g["fine"]) for g in j_groups]
    for group, j_group in zip(groups, j_groups):
        np.testing.assert_allclose(group["P"].numpy(), np.asarray(j_group["P"]), rtol=0, atol=1e-9)
        np.testing.assert_allclose(group["contours"].numpy(), np.asarray(j_group["contours"]), rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(group["ranges"]), np.asarray(j_group["ranges"]), rtol=1e-15)
        for k, pair in enumerate(group["pairs"]):
            np.testing.assert_array_equal(group["P"][k].numpy(), dens2[pair].P)


@pytest.mark.parametrize("settings", [None, {"range_ND_contour": 0}], ids=["defaults", "range_ND_contour-0"])
def test_chain_with_loglikes_matches(settings):
    """A chain with loglikes: range_ND_contour (1 by default) widens the
    ranges only once likelihood statistics exist, which a fresh MCSamples
    lacks, so parity mode runs as in the JAX package."""
    kwargs = _bounded_chain()
    kwargs["loglikes"] = 0.5 * np.sum(kwargs["samples"] ** 2, axis=1)
    w1, w2 = JaxMCSamples(settings=settings, **kwargs).fastParityDensities(device=True)
    d1, d2 = MCSamples(settings=settings, device="cpu", **kwargs).fastParityDensities(device=True)
    assert set(d1) == set(w1) and set(d2) == set(w2)
    for key in w1:
        assert np.abs(d1[key].P - w1[key].P).max() <= 1e-10, key
    for key in w2:
        got, want = d2[key].P, w2[key].P
        assert np.abs(got / got.max() - want / want.max()).max() <= 1e-5, key
        assert np.abs(np.asarray(d2[key].contours) - np.asarray(w2[key].contours)).max() <= 1e-5, key


@pytest.mark.parametrize(
    "weights,reason",
    [(np.random.RandomState(8).uniform(0.5, 2.0, 3000), "fractional"), (np.full(3000, 6000.0), "reaches 2\\*\\*24")],
    ids=["fractional", "total-past-2^24"],
)
def test_inexact_weights_raise(weights, reason):
    xy = np.random.RandomState(7).standard_normal((3000, 2))
    mc = MCSamples(samples=xy, weights=weights, names=["x", "y"], device="cpu")
    with pytest.raises(MCSamplesError, match=f"{reason}.*A8"):
        mc.fastParityDensities(device=True)


def test_periodic_parameter_raises():
    rng = np.random.RandomState(7)
    xy = rng.uniform(-1, 1, (3000, 2))
    mc = MCSamples(samples=xy, names=["x", "y"], ranges={"x": [-1, 1, True]}, device="cpu")
    with pytest.raises(NotImplementedError, match="A3"):
        mc.fastParityDensities(device=True)


def test_host_variant_raises():
    mc = MCSamples(**_bounded_chain(), device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        mc.fastParityDensities()


@pytest.mark.parametrize(
    "call",
    [
        lambda s, w: tb.prepare_chain(s, w),
        lambda s, w: tb.triangle_densities(s, w),
        lambda s, w: MCSamples(samples=s, weights=w),
    ],
    ids=["prepare_chain", "triangle_densities", "MCSamples"],
)
def test_entry_points_default_to_cuda(monkeypatch, call):
    """A call that names no device runs on the card, so without CUDA it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.RandomState(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(rng.standard_normal((500, 3)), np.ones(500))
