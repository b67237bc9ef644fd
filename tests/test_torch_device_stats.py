"""The chains' device-op branches of the port (ROADMAP A7) and the
``MCSamples`` device routes, on ``device="cpu"``.

With ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` the port's means, variances,
covariance, autocorrelation, Gaussian-KDE effective sample numbers (1D and
2D), the argsort of the confidence tables, and the host densities'
histograms and convolutions run as torch on the object's device. Each is
held against the JAX package's device branches (``_use_device_ops``
monkeypatched on in ``getdist_tpu.chains`` and ``getdist_tpu.mcsamples``,
its XLA CPU backend in x64; ``GETDIST_TPU_FUSED=0`` keeps its density
queries on its host path) and against the port's own host path, on four
AR(1) chains of 3000 rows with integer weights and loglikes:

* means, variances, covariance and the mean -log(like): within 1e-12 of
  the largest value;
* the autocorrelation curve: within 1e-12 of its lag-0 value;
* the effective sample numbers: within 1e-10 relative;
* the confidence limits: equal (a stable sort gives numpy's tail values);
* the 1D and 2D densities (with mean likelihoods): within 1e-12 of the
  peak, their histograms bit for bit;
* the ``.converge`` report on against off: equal but for lines whose
  numbers move in their last printed digit (named in the failure
  message).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import mcsamples as jmcsamples  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import mcsamples as tmcsamples  # noqa: E402

NAMES = ["a", "b", "c", "d", "e"]
RANGES = {"d": [0.0, None]}
SWITCH = "GETDIST_TPU_TORCH_DEVICE_OPS"


def _chains(seed=41, nchains=4, n=3000, p=5):
    r = np.random.default_rng(seed)
    mix = r.standard_normal((p, p)) * 0.4 + np.eye(p)
    samples, weights, loglikes = [], [], []
    for _ in range(nchains):
        x = np.empty((n, p))
        x[0] = r.standard_normal(p)
        noise = r.standard_normal((n, p)) @ mix
        for i in range(1, n):
            x[i] = 0.85 * x[i - 1] + np.sqrt(1 - 0.85**2) * noise[i]
        x[:, 3] = np.abs(x[:, 3])
        samples.append(x + np.arange(p))
        weights.append(r.integers(1, 5, n).astype(float))
        loglikes.append(0.5 * np.sum(x * x, axis=1))
    return samples, weights, loglikes


CHAINS = _chains()


def port_mc():
    s, w, ll = CHAINS
    return tmcsamples.MCSamples(samples=s, weights=w, loglikes=ll, names=NAMES, ranges=RANGES, device="cpu")


def jax_mc():
    s, w, ll = CHAINS
    return jmcsamples.MCSamples(samples=s, weights=w, loglikes=ll, names=NAMES, ranges=RANGES)


@pytest.fixture
def quiet(monkeypatch):
    monkeypatch.setattr(tchains, "print_load_details", False)
    monkeypatch.setattr(jchains, "print_load_details", False)
    monkeypatch.setenv("GETDIST_TPU_FUSED", "0")
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    monkeypatch.delenv(SWITCH, raising=False)
    return monkeypatch


@pytest.fixture
def trio(quiet):
    """(port with the switch on, JAX with its device branches, port on the
    host path): the switch stays on for the test."""
    host = port_mc()
    quiet.setenv(SWITCH, "1")
    quiet.setattr(jchains, "_use_device_ops", True)
    quiet.setattr(jmcsamples, "_use_device_ops", True)
    return port_mc(), jax_mc(), host


def near(got, want, tol):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= tol * scale, float(np.max(np.abs(got - want))) / scale


@pytest.mark.parametrize("what", ["means", "vars", "cov", "mean_loglike"])
def test_moments_match_jax_device_and_port_host(trio, what):
    dev, jax_side, host = trio
    values = {
        "means": lambda mc: mc.getMeans(),
        "vars": lambda mc: mc.getVars(),
        "cov": lambda mc: mc.cov(),
        "mean_loglike": lambda mc: mc.mean_loglike,
    }[what]
    assert dev._device_cache is not None  # the statistics of the constructor took the device route
    near(values(dev), values(jax_side), 1e-12)
    near(values(dev), values(host), 1e-12)


@pytest.mark.parametrize("param", [0, 2, 4])
def test_autocorrelation_matches(trio, param):
    dev, jax_side, host = trio
    curve = dev.getAutocorrelation(param, maxOff=300)
    for other in (jax_side, host):
        want = other.getAutocorrelation(param, maxOff=300)
        assert np.max(np.abs(curve - want)) <= 1e-12 * abs(want[0])
    assert dev.getCorrelationLength(param) == pytest.approx(host.getCorrelationLength(param), rel=1e-12)


@pytest.mark.parametrize("param", [0, 1, 3])
def test_neff_gaussian_kde_1d_matches(trio, param):
    dev, jax_side, host = trio
    got = dev.getEffectiveSamplesGaussianKDE(param)
    assert got == pytest.approx(jax_side.getEffectiveSamplesGaussianKDE(param), rel=1e-10)
    assert got == pytest.approx(host.getEffectiveSamplesGaussianKDE(param), rel=1e-10)


@pytest.mark.parametrize("pair", [(0, 1), (2, 4)])
def test_neff_gaussian_kde_2d_matches(trio, pair):
    dev, jax_side, host = trio
    got = dev.getEffectiveSamplesGaussianKDE_2d(*pair)
    assert got == pytest.approx(jax_side.getEffectiveSamplesGaussianKDE_2d(*pair), rel=1e-10)
    assert got == pytest.approx(host.getEffectiveSamplesGaussianKDE_2d(*pair), rel=1e-10)


@pytest.mark.parametrize("param", [0, 3, 4])
def test_confidence_limits_equal(trio, param):
    dev, jax_side, host = trio
    tails = np.array([0.001, 0.025, 0.16, 0.5])
    for upper in (False, True):
        got = dev.confidence(param, tails, upper=upper)
        np.testing.assert_array_equal(got, jax_side.confidence(param, tails, upper=upper))
        np.testing.assert_array_equal(got, host.confidence(param, tails, upper=upper))
    np.testing.assert_array_equal(dev.twoTailLimits(param, 0.95), host.twoTailLimits(param, 0.95))


def test_device_argsort_is_stable(trio):
    dev = trio[0]
    values = np.array([3.0, 1.0, 3.0, 1.0, 2.0])
    np.testing.assert_array_equal(dev._device_argsort(values), [1, 3, 4, 0, 2])


@pytest.mark.parametrize("name", ["a", "d"])
def test_1d_density_routes_match(trio, name):
    """get1DDensityGridData with mean likelihoods: its histograms
    (``_bincount``) and convolutions (``_convolve1D``) on the device, on a
    free and a lower-limited parameter."""
    dev, jax_side, host = trio
    got = dev.get1DDensityGridData(name, meanlikes=True)
    for other in (jax_side, host):
        want = other.get1DDensityGridData(name, meanlikes=True)
        np.testing.assert_array_equal(got.x, want.x)
        near(got.P, want.P, 1e-12)
        near(got.likes, want.likes, 1e-12)


@pytest.mark.parametrize("pair", [("a", "b"), ("d", "c")])
def test_2d_density_routes_match(trio, pair):
    dev, jax_side, host = trio
    got = dev.get2DDensityGridData(*pair, meanlikes=True)
    for other in (jax_side, host):
        want = other.get2DDensityGridData(*pair, meanlikes=True)
        np.testing.assert_array_equal(got.x, want.x)
        near(got.P, want.P, 1e-12)
        near(got.likes, want.likes, 1e-12)
        np.testing.assert_allclose(got.contours, want.contours, rtol=1e-10)


def test_histograms_bitwise(trio):
    dev, _, host = trio
    ix = np.random.default_rng(3).integers(0, 40, dev.numrows)
    np.testing.assert_array_equal(dev._bincount(ix, dev.weights, 40), np.bincount(ix, dev.weights, minlength=40))
    iy = ix[::-1].copy()
    np.testing.assert_array_equal(dev._bincount2d(ix, iy, dev.weights, 40, 40), host._bincount2d(ix, iy, host.weights,
                                                                                                    40, 40))


def _same_up_to_last_digit(a, b):
    """Whether two report lines have the same words and numbers that agree
    within 2e-6 relative or one unit of their last printed digit."""
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            return False
        decimals = len(y.split(".")[1]) if "." in y and "e" not in y.lower() else 0
        if abs(fx - fy) > max(2e-6 * abs(fy), 1.01 * 10.0**-decimals):
            return False
    return True


def test_converge_report_switch_on_against_off(quiet):
    """The convergence battery (all six tests) with the switch on against
    off: each line equal, or with the same words and its numbers within
    2e-6 relative or one unit of their last printed digit. On this chain
    one line differs, a Gelman-Rubin eigenvalue at round-off printed
    ``-0.00000`` against ``0.00000`` (the f64 sums' order moves it, as x64
    XLA moves it in the JAX package)."""
    tests = ("MeanVar", "GelmanRubin", "SplitTest", "RafteryLewis", "CorrLengths", "CorrSteps")
    off = port_mc().getConvergeTests(what=tests)
    quiet.setenv(SWITCH, "1")
    on = port_mc().getConvergeTests(what=tests)
    lines_on, lines_off = on.splitlines(), off.splitlines()
    assert len(lines_on) == len(lines_off)
    differing = [(a, b) for a, b in zip(lines_on, lines_off) if a != b]
    assert all(_same_up_to_last_digit(a, b) for a, b in differing), differing
    assert len(differing) <= 3, differing


def test_device_cache_kept_until_samples_change(trio):
    dev = trio[0]
    first = dev._dev()
    assert dev._dev() is first
    assert all(t.device.type == "cpu" for t in first if t is not None)
    dev.reweightAddingLogLikes(np.full(dev.numrows, 0.5))
    assert dev._device_cache is None
    np.testing.assert_array_equal(dev._dev()[1].numpy(), dev.weights)


def test_separate_chains_carry_the_device(trio):
    dev = trio[0]
    parts = dev.getSeparateChains()
    assert len(parts) == 4 and all(part.device == dev.device for part in parts)
    near(parts[1].getMeans(), np.average(CHAINS[0][1], axis=0, weights=CHAINS[1][1]), 1e-12)


def test_parity_pins_host_stats(trio):
    """The parity modes' pin recomputes device-route statistics on the
    host: the means come back bit for bit those of the host path."""
    dev, _, host = trio
    assert dev._stats_from_device
    dev._pin_host_stats()
    np.testing.assert_array_equal(dev.getMeans(), host.getMeans())
    np.testing.assert_array_equal(dev.getCov(), host.getCov())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the failure where CUDA is absent")
def test_cuda_samples_raise_without_a_card(quiet):
    """A WeightedSamples on the card (the default device) with the switch
    on raises where there is no card: no quiet numpy path."""
    quiet.setenv(SWITCH, "1")
    samples = tchains.WeightedSamples(samples=CHAINS[0][0], weights=CHAINS[1][0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        samples.getMeans()
    quiet.delenv(SWITCH)
    near(samples.getMeans(), np.average(CHAINS[0][0], axis=0, weights=CHAINS[1][0]), 1e-12)
