"""Pure algorithms over weighted-sample arrays (host numpy).

The port's own copy of the parts of ``getdist_tpu/samplemath.py`` that
parity mode calls, with the same arithmetic: sorted-weight confidence
queries, the FFT autocorrelation and its correlation length, and the
Gaussian-KDE effective-sample estimator with adaptive lag stepping
(reference semantics ``getdist/chains.py``).
"""

from collections import namedtuple

import numpy as np

from getdist_tpu_torch.ops.fft import next_fast_len

__all__ = [
    "autocorr_fft",
    "acl_from_curve",
    "ParamConfidenceData",
    "sorted_weight_table",
    "tail_value",
    "kde_pair_sum_adaptive",
    "kde_lag_term_1d",
    "corr_from_cov",
]

ParamConfidenceData = namedtuple("ParamConfidenceData", ("paramVec", "norm", "indexes", "cumsum"))


# -- autocorrelation ---------------------------------------------------------


def autocorr_fft(d, n):
    """First ``n`` lags of sum_i d_i d_{i+k}, each divided by its number of
    overlapping terms (reference ``convolve.py:458-478`` normalize=True)."""
    size = next_fast_len(2 * len(d))
    spectrum = np.fft.rfft(d, size)
    lags = np.fft.irfft(spectrum * spectrum.conj(), size)[:n]
    overlap = np.arange(len(d), len(d) - n, -1)
    return lags / overlap


def acl_from_curve(corr, min_corr):
    """Autocorrelation length from a lag curve: corr[0] plus twice the sum
    of the leading run of lags above min_corr*corr[0] (reference
    ``chains.py:449-466``).  argmin-of-bool picks the first below-threshold
    lag (0 when none is below, making the tail sum empty)."""
    cut = np.argmin(corr > min_corr * corr[0])
    return corr[0] + 2 * np.sum(corr[1:cut])


# -- confidence limits ----------------------------------------------------------


def sorted_weight_table(values, weights, argsort=np.argsort):
    """Sorted-order table for repeated tail-count confidence queries."""
    order = argsort(values)
    return ParamConfidenceData(
        paramVec=values,
        norm=np.sum(weights),
        indexes=order,
        cumsum=np.cumsum(weights[order]),
    )


def tail_value(table, limfrac, upper):
    """Parameter value with ``limfrac`` of total weight beyond it in the
    chosen tail."""
    weight_in = table.norm * ((1 - limfrac) if upper else limfrac)
    pos = np.searchsorted(table.cumsum, weight_in)
    pos = np.minimum(pos, len(table.indexes) - 1)
    return table.paramVec[table.indexes[pos]]


# -- KDE effective samples -------------------------------------------------------


def baseline_pair_term(pair_term, numrows):
    """Expected pair term for *uncorrelated* samples: averaged over five
    lags near numrows//2 (reference ``chains.py:510-518``)."""
    far = numrows // 2
    pairs = 0
    acc = 0.0
    for lag in range(far, far + 5):
        acc += pair_term(lag)
        pairs += numrows - lag
    return acc / pairs


def kde_pair_sum_adaptive(pair_term, weights, numrows, maxoff, min_corr):
    """Correlation-corrected pair-sum N for the 1D KDE N_eff.

    ``pair_term(k)`` is the raw kernel pair sum at lag k. Semantics match
    reference ``chains.py:477-574``: subtract the uncorrelated baseline,
    stop below min_corr of the lag-0 term, and when the correlation decays
    slowly probe by thirds to bound the range then stride through it.
    Returns the denominator N with sum(w)^2 / N the effective samples.
    """
    base = baseline_pair_term(pair_term, numrows)

    def excess(k):
        return pair_term(k) - (numrows - k) * base

    lag0 = float(np.dot(weights, weights))
    floor = min_corr * lag0
    first = excess(1)
    if first < floor:
        return lag0
    second = excess(2)
    if second <= floor:
        return lag0 + 2 * first
    # decay is slow: find how far the excess stays above the floor, coarsely
    horizon = maxoff
    while horizon > 10 and excess(horizon // 3) < floor:
        horizon //= 3
    stride = 1 if horizon < 20 else horizon // 10
    acc = first + second
    for k in range(3, maxoff + 1, stride):
        val = excess(k)
        if val < floor:
            break
        acc += val * stride if k > 3 else val * stride / 2
    return lag0 + 2 * acc


def kde_lag_term_1d(d, w, k, kernel_std):
    """Gaussian-kernel pair sum at lag k."""
    step = d[k:] - d[:-k]
    return float(np.dot(np.exp(step * step / (-4.0 * kernel_std**2)), w[k:] * w[:-k]))


# -- linear algebra ----------------------------------------------------------------


def corr_from_cov(cov, copy=True):
    """Covariance -> correlation, leaving zero-variance rows untouched."""
    if copy:
        cov = np.array(cov)
    sd = np.sqrt(cov.diagonal())
    for i in np.nonzero(sd)[0]:
        cov[i, :] /= sd[i]
        cov[:, i] /= sd[i]
    return cov
