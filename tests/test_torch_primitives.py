"""The port's device primitives against the JAX package's (ROADMAP A1).

``getdist_tpu_torch.ops.binning``, ``ops.stats``, ``ops.fft`` and the device
half of ``ops.convolve`` on CPU tensors, each beside its JAX function on the
same numpy inputs (made from a seed), the JAX side on its CPU backend:

* the histograms bit for bit with integer weights, and the bin indices;
* f64 statistics, DCTs and convolutions within 1e-12 of the largest value,
  f32 within 1e-5 of it;
* ``gelman_rubin_eigenvalues`` to 1e-10, ``kde_lag_correlation`` (1D and
  2D) at several lags to 1e-12 of the value, ``confidence_bounds``
  equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax.numpy as jnp  # noqa: E402
from getdist_tpu.ops import binning as jbin  # noqa: E402
from getdist_tpu.ops import convolve as jconv  # noqa: E402
from getdist_tpu.ops import fft as jfft  # noqa: E402
from getdist_tpu.ops import stats as jstats  # noqa: E402
from getdist_tpu_torch import ops as tops  # noqa: E402
from getdist_tpu_torch.ops import binning as tbin  # noqa: E402
from getdist_tpu_torch.ops import convolve as tconv  # noqa: E402
from getdist_tpu_torch.ops import stats as tstats  # noqa: E402

# of the largest value
TOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


def rng(seed=5):
    return np.random.default_rng(seed)


def close(got, want, dtype):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want))) / scale if want.size else 0.0
    assert err <= TOL[dtype], err


def test_weighted_bincount_bitwise_with_integer_weights():
    r = rng()
    ix = r.integers(0, 1024, 200_000)
    w = r.integers(1, 9, 200_000).astype(np.float64)
    got = tbin.weighted_bincount(torch.from_numpy(ix), torch.from_numpy(w), 1024).numpy()
    want = np.asarray(jbin.weighted_bincount(jnp.asarray(ix), jnp.asarray(w), 1024))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.bincount(ix, w, minlength=1024))


def test_weighted_bincount_2d_bitwise_with_integer_weights():
    r = rng(6)
    ix, iy = r.integers(0, 60, 100_000), r.integers(0, 45, 100_000)
    w = r.integers(1, 5, 100_000).astype(np.float64)
    got = tbin.weighted_bincount_2d(*(torch.from_numpy(a) for a in (ix, iy, w)), 60, 45).numpy()
    want = np.asarray(jbin.weighted_bincount_2d(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(w), 60, 45))
    assert got.shape == (45, 60)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_indices_1d_equal(dtype):
    values = (rng(7).standard_normal(50_000) * 2).astype(dtype)
    got = tbin.bin_indices_1d(torch.from_numpy(values), -3.0, 0.01, 512).numpy()
    want = np.asarray(jbin.bin_indices_1d(jnp.asarray(values), -3.0, 0.01, 512))
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == 511


def _weighted_chain(dtype, n=20_000, p=6, seed=8):
    r = rng(seed)
    samples = (r.standard_normal((n, p)) @ r.standard_normal((p, p)) + np.arange(p)).astype(dtype)
    weights = r.integers(1, 6, n).astype(dtype)
    return samples, weights


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["weighted_mean", "weighted_var", "weighted_cov", "weighted_mean_1d"])
def test_weighted_moments_match_jax(name, dtype):
    samples, weights = _weighted_chain(dtype)
    if name == "weighted_mean_1d":
        samples, name = samples[:, 2], "weighted_mean"
    got = getattr(tstats, name)(torch.from_numpy(samples), torch.from_numpy(weights))
    want = getattr(jstats, name)(jnp.asarray(samples), jnp.asarray(weights))
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cov_to_corr_matches_jax(dtype):
    samples, weights = _weighted_chain(dtype)
    cov = np.cov(samples.T).astype(dtype)
    cov[3, :] = cov[:, 3] = 0  # a zero-variance parameter stays unscaled
    close(tstats.cov_to_corr(torch.from_numpy(cov)), jstats.cov_to_corr(jnp.asarray(cov)), dtype)


@pytest.mark.parametrize("upper", [False, True])
def test_confidence_bounds_equal(upper):
    samples, weights = _weighted_chain(np.float64)
    fracs = np.array([0.001, 0.025, 0.16, 0.5, 0.84])
    for col in range(3):
        got = tstats.confidence_bounds(torch.from_numpy(samples[:, col]), torch.from_numpy(weights), fracs, upper)
        want = jstats.confidence_bounds(jnp.asarray(samples[:, col]), jnp.asarray(weights), jnp.asarray(fracs), upper)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scalar = tstats.confidence_bounds(torch.from_numpy(samples[:, 0]), torch.from_numpy(weights), 0.16, upper)
    assert scalar.shape == ()


def _ar_series(n=30_000, seed=9):
    r = rng(seed)
    x = np.empty((n, 2))
    x[0] = 0
    noise = r.standard_normal((n, 2))
    for i in range(1, n):
        x[i] = 0.9 * x[i - 1] + noise[i]
    return x, r.integers(1, 4, n).astype(np.float64)


@pytest.mark.parametrize("lag", [1, 5, 50, 333, 15_000])
def test_kde_lag_correlation_matches_jax(lag):
    x, w = _ar_series()
    got = float(tstats.kde_lag_correlation(torch.from_numpy(x[:, 0]), torch.from_numpy(w), lag, 0.3))
    want = float(jstats.kde_lag_correlation(jnp.asarray(x[:, 0]), jnp.asarray(w), lag, 0.3))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("lag", [1, 7, 120, 15_000])
def test_kde_lag_correlation_2d_matches_jax(lag):
    x, w = _ar_series()
    kinv = np.linalg.inv(np.cov(x.T)) / 0.3**2
    d1, d2, tw = (torch.from_numpy(a) for a in (x[:, 0], x[:, 1], w))
    got = float(tstats.kde_lag_correlation_2d(d1, d2, tw, lag, torch.from_numpy(kinv)))
    want = float(jstats.kde_lag_correlation_2d(*(jnp.asarray(a) for a in (x[:, 0], x[:, 1], w)), lag,
                                               jnp.asarray(kinv)))
    assert abs(got - want) <= 1e-12 * abs(want)


def test_gelman_rubin_eigenvalues_match_jax():
    r = rng(10)
    p, c = 5, 4
    means = r.standard_normal((c, p)) * 0.05
    base = r.standard_normal((p, p))
    covs = np.stack([base @ base.T + np.eye(p) * (1 + 0.1 * i) for i in range(c)])
    glob = means.mean(0) + 0.001
    got = tstats.gelman_rubin_eigenvalues(*(torch.from_numpy(a) for a in (means, covs, glob)))
    want = jstats.gelman_rubin_eigenvalues(*(jnp.asarray(a) for a in (means, covs, glob)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    singular = np.zeros_like(covs)
    assert tstats.gelman_rubin_eigenvalues(*(torch.from_numpy(a) for a in (means, singular, glob))) is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["dct", "idct", "dct_axis0", "dct2d", "idct2d"])
@pytest.mark.parametrize("n", [64, 45])
def test_dcts_match_jax(name, n, dtype):
    a = rng(11).standard_normal((n, n + 3)).astype(dtype)
    if name == "dct_axis0":
        got, want = tops.dct(torch.from_numpy(a), dim=0), jfft.dct(jnp.asarray(a), axis=0)
    else:
        got, want = getattr(tops, name)(torch.from_numpy(a)), getattr(jfft, name)(jnp.asarray(a))
    close(got, want, dtype)


def test_idct_inverts_dct():
    x = torch.from_numpy(rng(12).standard_normal(37))
    np.testing.assert_allclose((tops.idct(tops.dct(x)) / (2 * 37)).numpy(), x.numpy(), rtol=0, atol=1e-14)


CONV_CASES = [
    ("convolveFFT", "same"), ("convolveFFT", "full"), ("convolveFFT", "valid"),
    ("convolveFFTn", "same"), ("convolveFFTn", "full"), ("convolveFFTn", "valid"),
    ("convolve1D", "periodic"), ("convolve1D", "same"),
    ("convolve2D", "periodic"), ("convolve2D", "periodic_x"), ("convolve2D", "periodic_y"), ("convolve2D", "same"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,mode", CONV_CASES)
def test_convolutions_match_jax(name, mode, dtype):
    r = rng(13)
    two_d = name in ("convolveFFTn", "convolve2D")
    x = r.random((70, 61) if two_d else 300).astype(dtype)
    y = r.random((9, 13) if two_d else 21).astype(dtype)
    kwargs = {"largest_size": 0} if name != "convolve1D" or mode != "periodic" else {}
    got = getattr(tconv, name)(torch.from_numpy(x), torch.from_numpy(y), mode, **kwargs)
    want = getattr(jconv, name)(jnp.asarray(x), jnp.asarray(y), mode, **kwargs)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["autoConvolve", "autoConvolve_raw", "autoCorrelation", "gaussDCT_same",
                                  "gaussDCT_valid", "gauss", "trunc_same", "trunc_full", "trunc_valid"])
def test_autocorrelation_and_gaussian_smoothing_match_jax(case, dtype):
    x, _ = _ar_series(4000)
    x = x[:, 0].astype(dtype)
    calls = {
        "autoConvolve": lambda m, a: m.autoConvolve(a, n=400),
        "autoConvolve_raw": lambda m, a: m.autoConvolve(a, n=400, normalize=False),
        "autoCorrelation": lambda m, a: m.autoCorrelation(a, n=300, start_index=1),
        "gaussDCT_same": lambda m, a: m.convolveGaussianDCT(a, 6.5),
        "gaussDCT_valid": lambda m, a: m.convolveGaussianDCT(a, 6.5, mode="valid"),
        "gauss": lambda m, a: m.convolveGaussian(a, 4.0),
        "trunc_same": lambda m, a: m.convolveGaussianTrunc(a, 3.0),
        "trunc_full": lambda m, a: m.convolveGaussianTrunc(a, 3.0, mode="full"),
        "trunc_valid": lambda m, a: m.convolveGaussianTrunc(a, 3.0, mode="valid"),
    }
    close(calls[case](tconv, torch.from_numpy(x)), calls[case](jconv, jnp.asarray(x)), dtype)


def test_nearest_fft_number_and_exports():
    for x in (1, 7, 97, 1000, 4097):
        assert tconv.nearestFFTnumber(x) == jconv.nearestFFTnumber(x)
    np.testing.assert_array_equal(tconv.nearestFFTnumber(np.array([[3, 11], [127, 500]])),
                                  jconv.nearestFFTnumber(np.array([[3, 11], [127, 500]])))
    import getdist_tpu.ops as jops

    assert sorted(tops.__all__) == sorted(jops.__all__)
