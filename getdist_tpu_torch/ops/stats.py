"""Weighted-sample statistics on a torch device (counterpart of
``getdist_tpu/ops/stats.py``).

The chains' statistics under ``GETDIST_TPU_TORCH_DEVICE_OPS=1``
(:mod:`getdist_tpu_torch.chains`): weighted means, variances and the
covariance as matrix products, confidence limits by a stable device sort
and cumulative sums, one lag of the Gaussian-KDE effective-sample sums
(1D and 2D; the adaptive lag search stays on the host), and the
Gelman-Rubin eigenvalues. Each function takes tensors and returns tensors
on their device; none reads a value back to the host but
:func:`gelman_rubin_eigenvalues`, whose positive-definiteness test does.
"""

import torch

__all__ = [
    "weighted_mean",
    "weighted_var",
    "weighted_cov",
    "cov_to_corr",
    "confidence_bounds",
    "kde_lag_correlation",
    "kde_lag_correlation_2d",
    "gelman_rubin_eigenvalues",
]


def weighted_mean(samples, weights):
    """Weighted mean per column, ``w @ X / sum(w)``; ``samples`` (N, p) or
    (N,)."""
    return (weights @ samples) / weights.sum()


def weighted_var(samples, weights, means=None):
    """Weighted (biased) variance per column."""
    if means is None:
        means = weighted_mean(samples, weights)
    diffs = samples - means
    return (weights @ (diffs * diffs)) / weights.sum()


def weighted_cov(samples, weights, means=None):
    """Full weighted covariance of the (N, p) samples, one (p, N) @ (N, p)
    product."""
    if means is None:
        means = weighted_mean(samples, weights)
    diffs = samples - means
    return ((diffs * weights[:, None]).T @ diffs) / weights.sum()


def cov_to_corr(cov):
    """Covariance to correlation; zero-variance rows and columns are left
    unscaled."""
    d = torch.sqrt(torch.diagonal(cov))
    scale = torch.where(d > 0, d, torch.ones_like(d))
    return cov / torch.outer(scale, scale)


def confidence_bounds(paramvec, weights, limfrac, upper=False):
    """Tail-count confidence limit(s): the value where the cumulative
    weight of the sorted samples reaches ``limfrac`` of the total
    (``1 - limfrac`` with ``upper``); ``limfrac`` a float or a tensor of
    tail fractions."""
    sorted_vals, order = torch.sort(paramvec, stable=True)
    cumsum = torch.cumsum(weights[order], 0)
    limfrac = torch.as_tensor(limfrac, dtype=cumsum.dtype, device=cumsum.device)
    target = cumsum[-1] * ((1 - limfrac) if upper else limfrac)
    ix = torch.searchsorted(cumsum, target.reshape(-1)).reshape(target.shape)
    return sorted_vals[ix.clamp(max=sorted_vals.shape[0] - 1)]


def kde_lag_correlation(d, w, k, kernel_std):
    """One lag of the Gaussian-KDE effective-sample sums,
    ``sum_i exp(-(d_i - d_{i+k})^2 / (4 sigma^2)) w_i w_{i+k}`` over the
    ``N - k`` overlapping pairs, as a 0-dim tensor."""
    n = d.shape[0]
    step = d[: n - k] - d[k:]
    return torch.sum(torch.exp(-(step * step) / (4.0 * kernel_std**2)) * w[: n - k] * w[k:])


def kde_lag_correlation_2d(d1, d2, w, k, kernel_inv):
    """2D analogue of :func:`kde_lag_correlation` with the quadratic form
    of ``kernel_inv`` (a (2, 2) tensor or array)."""
    n = d1.shape[0]
    e1 = d1[: n - k] - d1[k:]
    e2 = d2[: n - k] - d2[k:]
    diff2 = kernel_inv[0, 0] * e1 * e1 + 2 * kernel_inv[0, 1] * e1 * e2 + kernel_inv[1, 1] * e2 * e2
    return torch.sum(torch.exp(-diff2 / 4.0) * w[: n - k] * w[k:])


def gelman_rubin_eigenvalues(chain_means, chain_covs, global_means):
    """Brooks and Gelman's eigenvalues of var(mean) against mean(var), in
    the basis where the mean covariance is white; ``chain_means`` (c, p),
    ``chain_covs`` (c, p, p), ``global_means`` (p,). None when the mean
    covariance is not positive definite."""
    diffs = chain_means - global_means
    meanscov = diffs.T @ diffs / (chain_means.shape[0] - 1)
    meancov = chain_covs.mean(0)
    evals, evecs = torch.linalg.eigh(meancov)
    if not bool(evals.min() > 0):
        return None
    whitener = evecs / torch.sqrt(evals)
    return torch.linalg.eigvalsh(whitener.T @ meanscov @ whitener)
