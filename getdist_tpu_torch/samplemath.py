"""Pure algorithms over weighted-sample arrays (host numpy).

The port's own copy of ``getdist_tpu/samplemath.py``, with the same
arithmetic: chain-file name matching, exact integer-weight thinning,
sorted-weight confidence queries, the FFT autocorrelation and its
correlation length, the 1D and 2D Gaussian-KDE effective-sample
estimators (adaptive lag stepping and the 2D lag scan), the Gelman-Rubin
eigen-diagnostic and the signal-to-noise eigen-analysis (reference
semantics ``getdist/chains.py``).
"""

import os
import re
from collections import namedtuple

import numpy as np

from getdist_tpu_torch.ops.fft import next_fast_len

__all__ = [
    "match_chain_files",
    "autocorr_fft",
    "acl_from_curve",
    "thin_exact",
    "ParamConfidenceData",
    "sorted_weight_table",
    "tail_value",
    "kde_pair_sum_adaptive",
    "kde_pair_sum_scan",
    "kde_lag_term_1d",
    "kde_lag_term_2d",
    "gelman_rubin_eigs",
    "sn_eigendecomp",
    "corr_from_cov",
]

ParamConfidenceData = namedtuple("ParamConfidenceData", ("paramVec", "norm", "indexes", "cumsum"))


# -- file discovery ------------------------------------------------------------


def match_chain_files(root, chain_indices, ext, separator, first_chain, last_chain, chain_exclude):
    """Chain files for a root, under the getdist naming conventions
    (``root.txt``, ``root_1.txt`` / ``root.1.txt``, or bare ``N.txt`` inside
    a directory when root ends in a path separator); cf. reference
    ``chains.py:77-108``."""
    folder = os.path.dirname(root) or "."
    if root.endswith((os.sep, "/")):
        matcher = re.compile("(?P<num>[0-9]+)?" + re.escape(ext))
    else:
        stem = re.escape(os.path.basename(root))
        matcher = re.compile(stem + "(" + re.escape(separator) + "(?P<num>[0-9]+))?" + re.escape(ext))

    def wanted(index):
        if index < first_chain or (0 <= last_chain < index):
            return False
        if chain_indices is not None and index not in chain_indices:
            return False
        return chain_exclude is None or index not in chain_exclude

    hits = []
    for entry in sorted(os.listdir(folder)):
        m = matcher.fullmatch(entry)
        if m and wanted(int(m.group("num") or 0)):
            hits.append(os.path.join(folder, entry))
    return hits


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


# -- thinning -----------------------------------------------------------------


def thin_exact(factor, weights):
    """Unit-weight sample indices for exact integer-weight thinning.

    Two regimes, matching reference ``chains.py:878-916`` output exactly:

    * ``factor >= max(weight)``: one index per distinct value of
      ``cumsum(w) // factor`` (first occurrence).
    * otherwise: the j-th output is the sample containing cumulative-weight
      position ``j*factor`` (a vectorized searchsorted, equivalent to the
      reference's sequential multiplicity walk).
    """
    total_f = np.sum(weights)
    weights = weights.astype(int)
    total = np.sum(weights)
    if abs(total - total_f) > 1e-4:
        raise ValueError("Can only thin with integer weights")
    if factor != int(factor):
        raise ValueError("Thin factor must be integer")
    factor = int(factor)
    running = np.cumsum(weights)
    if factor >= weights.max():
        _, first_of_group = np.unique(running // factor, return_index=True)
        return first_of_group
    marks = factor * np.arange(1, total // factor + 1)
    return np.searchsorted(running, marks, side="left")


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


def kde_pair_sum_scan(pair_term, weights, numrows, maxoff, min_corr):
    """2D-variant pair-sum N: simple lag scan with baseline subtraction and
    early exit (reference ``chains.py:576-635``)."""
    base = baseline_pair_term(pair_term, numrows)
    lag0 = float(np.dot(weights, weights))
    acc = lag0
    for k in range(1, maxoff + 1):
        val = pair_term(k) - (numrows - k) * base
        if val < min_corr * lag0:
            break
        acc += 2 * val
    return acc


def kde_lag_term_1d(d, w, k, kernel_std):
    """Gaussian-kernel pair sum at lag k."""
    step = d[k:] - d[:-k]
    return float(np.dot(np.exp(step * step / (-4.0 * kernel_std**2)), w[k:] * w[:-k]))


def kde_lag_term_2d(d1, d2, w, k, kernel_inv):
    """2D anisotropic-kernel pair sum at lag k."""
    u = d1[k:] - d1[:-k]
    v = d2[k:] - d2[:-k]
    quad = kernel_inv[0, 0] * u * u + 2 * kernel_inv[0, 1] * u * v + kernel_inv[1, 1] * v * v
    return float(np.dot(np.exp(-0.25 * quad), w[k:] * w[:-k]))


# -- convergence / linear algebra ----------------------------------------------


def gelman_rubin_eigs(global_means, chain_means, chain_covs):
    """Eigenvalues of var-of-means against mean-of-vars, in the basis where
    the mean covariance is white (Brooks & Gelman); None if the mean
    covariance is not positive definite."""
    spread = np.asarray(chain_means) - np.asarray(global_means)
    between = spread.T @ spread / (len(chain_means) - 1)
    within = np.mean(chain_covs, axis=0)
    evals, basis = np.linalg.eigh(within)
    if evals.min() <= 0:
        return None
    whitener = basis / np.sqrt(evals)
    return np.linalg.eigvalsh(whitener.T @ between @ whitener)


def sn_eigendecomp(C, noise=None, R=None, eigs_only=False):
    """Signal-to-noise eigen-analysis of covariance C against a noise
    matrix: eigenvalues (and rotation) of R C R^T, R the inverse Cholesky
    root of the noise."""
    if R is None:
        if noise is None:
            raise ValueError("Must give noise or rotation R")
        R = np.linalg.inv(np.linalg.cholesky(noise))
    white = R @ C @ R.T
    if eigs_only:
        return np.linalg.eigvalsh(white)
    evals, vecs = np.linalg.eigh(white)
    return evals, vecs.T @ R


def corr_from_cov(cov, copy=True):
    """Covariance -> correlation, leaving zero-variance rows untouched."""
    if copy:
        cov = np.array(cov)
    sd = np.sqrt(cov.diagonal())
    for i in np.nonzero(sd)[0]:
        cov[i, :] /= sd[i]
        cov[:, i] /= sd[i]
    return cov
