"""getdist_tpu_torch's parity mode on periodic parameters and any weights,
against the JAX package.

``MCSamples(...).fastParityDensities`` on both sides, on the same arrays:
the port on the CPU (its kernels' plain versions and the native
pair-histogram pass), the JAX package on the CPU in x64. Device parity
with periodic parameters; the host variant (``device=False``) on integer,
fractional and negative weights, each chain with a hard-limited and two
periodic parameters and a correlated pair (its sheared branch); device
parity's routing of every weight its device histograms cannot sum exactly
to the host variant; ``use_effective_samples_2D``; and the batched
sheared bandwidths against the per-pair pass. The bar is parity mode's
(``tests/test_parity_mode.py``): 2D grids and contour levels within 1e-5
of the peak, 1D grids within 1e-10.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

from getdist_tpu.mcsamples import MCSamples as JaxMCSamples  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples, MCSamplesError  # noqa: E402


def _weights(kind, rng, n):
    if kind == "integer":
        return rng.randint(1, 4, n).astype(np.float64)
    if kind == "fractional":  # importance weights exp(-chi2 / 2) in (0, 1]
        return np.exp(-0.5 * rng.uniform(0, 3, n))
    if kind == "negative":  # a few negative weights, as a reweighted chain can carry
        w = rng.uniform(0.2, 1.5, n)
        w[rng.rand(n) < 0.05] *= -0.1
        return w
    if kind == "f32-lossy":  # integers past f32's 24-bit mantissa
        return rng.randint(1, 4, n).astype(np.float64) + 2.0**25
    raise ValueError(kind)


def _chain(kind="integer", n=4000, seed=21, periodic=2):
    """A free column a, c limited at 0 and correlated ~0.4 with a (the
    sheared branch, the limited parameter its lead), then ``periodic``
    periodic columns: d on [0, 2 pi), e on [0, 2) correlated ~0.3 with d."""
    rng = np.random.RandomState(seed)
    z = rng.standard_normal((n, 4))
    s = np.column_stack([z[:, 0], np.abs(z[:, 1]) * np.exp(0.5 * z[:, 0]), np.mod(1.2 * z[:, 2] + np.pi, 2 * np.pi),
                         np.mod(0.5 * z[:, 3] + 0.4 * z[:, 2], 2.0)])[:, : 2 + periodic]
    ranges = {"c": [0, None], "d": [0, 2 * np.pi, True], "e": [0, 2.0, True]}
    names = list("acde")[: 2 + periodic]
    return dict(samples=s, weights=_weights(kind, rng, n), names=names,
                ranges={k: v for k, v in ranges.items() if k in names})


def _small_chain(kind):
    rng = np.random.RandomState(7)
    xy = rng.standard_normal((3000, 2))
    xy[:, 1] += 0.5 * xy[:, 0]
    return dict(samples=xy, weights=_weights(kind, rng, 3000), names=["x", "y"])


def _assert_parity_close(got, want):
    (d1, d2), (w1, w2) = got, want
    assert set(d1) == set(w1) and set(d2) == set(w2)
    for key in w1:
        np.testing.assert_array_equal(d1[key].x, w1[key].x)
        assert np.abs(d1[key].P - w1[key].P).max() <= 1e-10, key
    for key in w2:
        g, w = d2[key].P, w2[key].P
        assert g.shape == w.shape, key
        assert np.abs(g / g.max() - w / w.max()).max() <= 1e-5, key
        assert np.abs(np.asarray(d2[key].contours) - np.asarray(w2[key].contours)).max() <= 1e-5, key


def _assert_identical(got, want):
    (d1, d2), (w1, w2) = got, want
    assert set(d1) == set(w1) and set(d2) == set(w2)
    for key in w1:
        np.testing.assert_array_equal(d1[key].P, w1[key].P)
    for key in w2:
        np.testing.assert_array_equal(d2[key].P, w2[key].P)
        np.testing.assert_array_equal(np.asarray(d2[key].contours), np.asarray(w2[key].contours))


def test_device_parity_with_periodic_parameters_matches_jax():
    """Two periodic parameters take the 2D programs' periodic fold and
    extension (a 'valid' f64 K3 on the (fine + 2 winw)^2 grid), in pairs
    with each other, with the limited parameter (correlated with the free
    one: the sheared branch) and with the free one. The
    port follows the JAX method, whose periodic pairs are not the
    reference's (ROADMAP C12: the periodic limits go in as active edges)."""
    kwargs = _chain()
    port = MCSamples(device="cpu", **kwargs)
    _assert_parity_close(port.fastParityDensities(device=True), JaxMCSamples(**kwargs).fastParityDensities(device=True))
    assert list(port.parity_profile)[:3] == ["ranges", "chain_state", "device_hists"]


@pytest.mark.parametrize("kind", ["integer", "fractional", "negative"])
def test_host_variant_matches_jax(kind):
    kwargs = _chain(kind, periodic=1)
    port = MCSamples(device="cpu", **kwargs)
    _assert_parity_close(port.fastParityDensities(device=False), JaxMCSamples(**kwargs).fastParityDensities())
    assert list(port.parity_profile) == ["ranges", "neff", "1d_host", "sheared", "hists_bandwidths",
                                         "conv_materialize"]
    assert sum(b["pairs"] for b in port.parity_buckets) == 3


@pytest.mark.parametrize("kind", ["negative", "f32-lossy"])
def test_device_mode_routes_inexact_weights_to_host_variant(kind, caplog):
    """Negative weights and integers f32 cannot hold (the fractional and
    2^24-total cases: tests/test_torch_parity_slice.py) go to the host
    variant with a warning, identical to calling it; with
    ``materialize=False`` device mode raises instead."""
    kwargs = _small_chain(kind)
    with caplog.at_level(logging.WARNING):
        routed = MCSamples(device="cpu", **kwargs).fastParityDensities(device=True)
    assert any("host parity variant" in rec.getMessage() for rec in caplog.records)
    _assert_identical(routed, MCSamples(device="cpu", **kwargs).fastParityDensities(device=False))
    with pytest.raises(MCSamplesError, match="integral"):
        MCSamples(device="cpu", **kwargs).fastParityDensities(device=True, materialize=False)


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
def test_use_effective_samples_2d_matches_jax(device):
    """With ``use_effective_samples_2D`` no sheared pair is batched: each
    takes getAutoBandwidth2D's per-pair host pass, with the 1D N_eff (the
    method passes no 2D estimate), so the grids equal those without the
    setting, as in the JAX package (an attribute in both: no ini key sets
    it)."""
    kwargs = _chain("integer" if device else "fractional", n=3000, periodic=1)
    port, jax_mc = MCSamples(device="cpu", **kwargs), JaxMCSamples(**kwargs)
    port.use_effective_samples_2D = jax_mc.use_effective_samples_2D = True
    infos = [port._initParamRanges(j) for j in range(3)]
    assert port._parity_pairs(list(range(3)), infos)[1] == []
    got = port.fastParityDensities(device=device)
    _assert_parity_close(got, jax_mc.fastParityDensities(device=device))
    _assert_parity_close(got, MCSamples(device="cpu", **kwargs).fastParityDensities(device=device))


def test_getautobandwidth2d_2d_neff_not_ported():
    mc = MCSamples(device="cpu", **_small_chain("integer"))
    parx, pary = mc._initParamRanges(0), mc._initParamRanges(1)
    args = (None, parx, pary, 0, 1, 0.45, 1.0, 1.0, 256)
    with pytest.raises(NotImplementedError, match="A10"):
        mc.getAutoBandwidth2D(*args, use_2D_Neff=True)
    mc.use_effective_samples_2D = True
    with pytest.raises(NotImplementedError, match="A10"):
        mc.getAutoBandwidth2D(*args, use_2D_Neff=None)
    assert np.isfinite(mc.getAutoBandwidth2D(*args, N_eff=2000.0, use_2D_Neff=True)).all()


@pytest.mark.parametrize("kind", ["integer", "fractional"])
def test_sheared_bandwidths_batch_equals_per_pair(kind):
    """The sheared branch batched over every pair of the chain that takes
    it (residual rows binned together, shared lead rows, a limited lead
    among them) gives the values of each pair alone
    (``_optimize_bandwidth_sheared``, a batch of one) exactly."""
    kwargs = _chain(kind, n=6000)
    kwargs["samples"][:, 3] = 0.3 * kwargs["samples"][:, 2] + np.sin(3 * kwargs["samples"][:, 3])  # free, corr with d
    kwargs["ranges"].pop("e")
    mc = MCSamples(device="cpu", **kwargs)
    idx = list(range(mc.n))
    infos = [mc._initParamRanges(j) for j in idx]
    _, sheared = mc._parity_pairs(idx, infos)
    assert len(sheared) >= 2 and any(infos[b].has_limits or infos[a].has_limits for a, b in sheared)
    jobs = [(infos[a], infos[b], a, b, 1000.0 + 10 * a + b) for a, b in sheared]
    batch = mc._sheared_bandwidths_batch(jobs, mc.fine_bins_2D)
    for parx, pary, a, b, n_eff in jobs:
        assert batch[(a, b)] == mc._optimize_bandwidth_sheared(parx, pary, a, b, n_eff, mc.fine_bins_2D), (a, b)
