"""Weighted sample containers (host numpy), from arrays or chain files.

The port's own copy of ``getdist_tpu/chains.py``'s host layer:
:class:`WeightedSamples` (a chain file or arrays; weights, burn-in,
min-weight filter, fixed-parameter removal, thinning, cooling and
importance reweighting, text output) and :class:`Chains` (a chain root
with its ``.paramnames``, parameter names and renames, several files or
arrays combined into one and split again, derived parameters, the
Gelman-Rubin diagnostic, pickling), the module's chain-file helpers
(:func:`chainFiles`, :func:`findChainFileRoot`, :func:`loadNumpyTxt`, the
native loader of :mod:`getdist_tpu_torch._native`), and the host
statistics in the same arithmetic as the JAX package's numpy branches:
means, variances, covariance and correlation, the FFT autocorrelation
length and the 1D and 2D Gaussian-KDE effective sample numbers.

The device route (counterpart of the JAX package's
``GETDIST_TPU_DEVICE_OPS`` branches): with ``GETDIST_TPU_TORCH_DEVICE_OPS=1``
in the environment (read at each call) the means, variances and
covariance (:mod:`getdist_tpu_torch.ops.stats`), the autocorrelation
(``ops.convolve.autoConvolve``), the Gaussian-KDE lag sums and the argsort
of the confidence tables run on the samples' torch device (``device``:
the card unless the caller names the CPU; an ``MCSamples`` hands its own
to the chains it makes). The upload (:meth:`WeightedSamples._dev`) is kept
until the samples or weights change. Host numpy stays the default, whose
text outputs are byte-identical to the JAX package's; with the switch on,
a failure on the device raises (no numpy fallback).

A chain root's names come from its ``.paramnames``, or else from a Cobaya
``*.updated.yaml`` / ``*__full.yaml`` next to the chain files
(:mod:`getdist_tpu_torch.cobaya_interface`).
"""

import os
import pickle
import re
from copy import deepcopy
from warnings import warn

import numpy as np
import torch

from getdist_tpu_torch import samplemath as smath
from getdist_tpu_torch.ops import stats as _stats
from getdist_tpu_torch.ops._cuda import resolve_device
from getdist_tpu_torch.ops.convolve import autoConvolve
from getdist_tpu_torch.paramnames import ParamInfo, ParamNames, escapeLatex
from getdist_tpu_torch.samplemath import ParamConfidenceData

# Whether to print chain names and burn-in details when loading from file.
print_load_details = True

_int_types = (int, np.integer)
_seq_types = (list, tuple)


def _use_device_ops():
    """Whether the statistics take the device route:
    ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` (read at each call, as
    ``GETDIST_TPU_TORCH_FUSED`` is)."""
    return os.environ.get("GETDIST_TPU_TORCH_DEVICE_OPS") == "1"


def _upload(values, device):
    """A copy of a host array (its dtype kept) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(resolve_device(device), copy=True)


def _host(x):
    """A tensor's values as a numpy array (a readback from the device)."""
    return x.detach().cpu().numpy()


class WeightedSampleError(Exception):
    """Error in a WeightedSamples operation."""


class ParamError(WeightedSampleError):
    """A bad parameter was requested."""


class ParSamples:
    """Attribute-bundle container for named parameter sample vectors."""


def slice_or_none(x, start=None, end=None):
    """x[start:end], or None for None (integer-valued float bounds allowed)."""
    if isinstance(start, float) and start == int(start):
        start = int(start)
    if isinstance(end, float) and end == int(end):
        end = int(end)
    if not hasattr(x, "__getitem__"):
        return None
    return x[start:end]


def covToCorr(cov, copy=True):
    """Covariance matrix -> correlation matrix (zero-variance rows kept)."""
    return smath.corr_from_cov(cov, copy=copy)


def getSignalToNoise(C, noise=None, R=None, eigs_only=False):
    """Signal-to-noise eigen-analysis: eigenvalues (and rotation) of
    R C R^T with R the inverse Cholesky root of the noise matrix."""
    try:
        return smath.sn_eigendecomp(C, noise, R, eigs_only)
    except ValueError as e:
        raise WeightedSampleError(str(e)) from None


class WeightedSamples:
    """A set of weighted parameter samples held as numpy arrays.

    :ivar weights: (N,) weights per sample
    :ivar loglikes: (N,) -log(posterior) per sample, or None
    :ivar samples: (N, n) parameter values
    :ivar n: number of parameters
    :ivar numrows: number of samples
    """

    precision = "%.8e"  # text output format for saveAsText

    def __init__(
        self,
        filename=None,
        ignore_rows=0,
        samples=None,
        weights=None,
        loglikes=None,
        name_tag=None,
        label=None,
        files_are_chains=True,
        min_weight_ratio=1e-30,
        device="cuda",
    ):
        """
        :param filename: plain text chain file to load
        :param ignore_rows: int >= 1 rows, or float < 1 fraction, to skip as burn-in
        :param samples: (N, n) array (or list of vectors) of parameter values
        :param weights: (N,) weights (default all 1)
        :param loglikes: (N,) -log(posterior)
        :param name_tag: name for this sample set
        :param label: latex label
        :param files_are_chains: False if the file has no weight/loglike columns
        :param min_weight_ratio: drop samples below this ratio of the max weight
        :param device: torch device of the statistics' device route
            (``GETDIST_TPU_TORCH_DEVICE_OPS=1``), the card unless the caller
            names the CPU; checked when the route first runs
        """
        self.device = device
        self.min_weight_ratio = min_weight_ratio
        if filename:
            self.name_tag = name_tag if name_tag else os.path.basename(filename)
            table = loadNumpyTxt(filename, skiprows=ignore_rows)
            if not len(table):
                raise WeightedSampleError(f"chain file {filename} contains no samples")
            self.setColData(table, are_chains=files_are_chains)
        else:
            self.name_tag = name_tag
            if samples is not None and int(ignore_rows) > 0:
                print_load_line(f"Removed {ignore_rows} lines as burn in")
            trimmed = (slice_or_none(arr, ignore_rows) for arr in (samples, weights, loglikes))
            self.setSamples(*trimmed)
        self.needs_update = True
        self.label = label

    # -- setup ---------------------------------------------------------------
    def setColData(self, coldata, are_chains=True):
        """Set samples from a file-loaded array; first two columns are
        weight and -log(like) unless are_chains=False."""
        if not are_chains:
            self.setSamples(coldata)
            return
        w, nll, values = coldata[:, 0], coldata[:, 1], coldata[:, 2:]
        self.setSamples(values, w, nll)

    @staticmethod
    def _as_sample_matrix(samples):
        """Coerce vectors / vector lists / arrays to a contiguous (N, n) f64."""
        if isinstance(samples, _seq_types):
            samples = np.column_stack(samples)
        samples = np.asarray(samples, dtype=np.float64)
        if samples.ndim < 2:
            samples = samples.reshape(-1, 1)
        return np.ascontiguousarray(samples)

    def setSamples(self, samples, weights=None, loglikes=None, min_weight_ratio=None):
        """Set samples/weights/loglikes from arrays; applies the min-weight
        filter unless min_weight_ratio is negative."""
        self.weights = None if weights is None else np.ascontiguousarray(weights, dtype=np.float64)
        self.loglikes = None if loglikes is None else np.ascontiguousarray(loglikes, dtype=np.float64)
        if samples is None:
            self.samples = None
        else:
            self.samples = self._as_sample_matrix(samples)
            self.numrows, self.n = self.samples.shape
            ratio = self.min_weight_ratio if min_weight_ratio is None else min_weight_ratio
            if ratio is not None and ratio >= 0:
                self.setMinWeightRatio(ratio)
        self._weightsChanged()

    def changeSamples(self, samples):
        """Replace samples keeping weights and loglikes."""
        self.setSamples(samples, self.weights, self.loglikes)

    def _weightsChanged(self):
        w = self.weights
        if w is None and self.samples is not None:
            self.weights = np.ones(self.numrows, dtype=np.float64)
            self.norm = np.float64(len(self.weights))
        elif w is not None:
            self.norm = w.sum()
        for stale in ("means", "mean_loglike", "diffs", "fullcov", "correlationMatrix", "vars", "sddev"):
            setattr(self, stale, None)
        self.needs_update = True
        self._device_cache = None
        # the parity and fused paths' device-resident chains (MCSamples)
        self._parity_chain_cache = None
        self._fast_chain_cache = None
        self._param_range_cache = {}

    # -- device route ----------------------------------------------------------
    def _device_stats_ok(self):
        """Whether means, variances and the covariance take the device
        route: the switch is on and the parity modes have not pinned them
        to numpy (``_force_host_stats``: their bandwidth optimizers need
        inputs bit-identical to the JAX package's)."""
        on = _use_device_ops() and not getattr(self, "_force_host_stats", False)
        if on:
            self._stats_from_device = True
        return on

    def _upload(self, values):
        """A copy of a host array (its dtype kept) on the samples' device."""
        return _upload(values, self.device)

    def _dev(self):
        """(samples, weights, loglikes) on the samples' device, kept until
        the samples or weights change."""
        if getattr(self, "_device_cache", None) is None:
            self._device_cache = (
                self._upload(self.samples),
                self._upload(self.weights),
                None if self.loglikes is None else self._upload(self.loglikes),
            )
        return self._device_cache

    # -- naming ----------------------------------------------------------------
    def getName(self):
        """The name tag of these samples."""
        return self.name_tag

    def getLabel(self):
        """The latex label for the samples."""
        return self.label if self.label else escapeLatex(self.getName())

    # -- parameter access --------------------------------------------------------
    def _makeParamvec(self, par):
        if not isinstance(par, _int_types):
            return par
        if 0 <= par < self.n:
            return self.samples[:, par]
        if par == -1:
            if self.loglikes is None:
                raise WeightedSampleError("par=-1 requested but these samples carry no logLikes")
            return self.loglikes
        if par == -2:
            return self.weights
        raise WeightedSampleError(f"no parameter with index {par}")

    def __getitem__(self, item):
        return self._makeParamvec(item)

    # -- moments -------------------------------------------------------------
    def setMeans(self):
        """Compute and cache weighted means."""
        if self._device_stats_ok():
            dev_samples, dev_weights, dev_loglikes = self._dev()
            self.means = _host(_stats.weighted_mean(dev_samples, dev_weights))
            self.mean_loglike = (
                None if dev_loglikes is None else float(_stats.weighted_mean(dev_loglikes, dev_weights))
            )
            return self.means
        self.means = self.weights @ self.samples / self.norm
        self.mean_loglike = None if self.loglikes is None else float(self.weights @ self.loglikes / self.norm)
        return self.means

    def getMeans(self, pars=None):
        """Weighted parameter means (cached)."""
        means = self.means if self.means is not None else self.setMeans()
        return means if pars is None else np.array([means[i] for i in pars])

    def getVars(self):
        """Weighted parameter variances (cached; also sets sddev)."""
        means = self.getMeans()
        if self.fullcov is not None:
            self.vars = self.fullcov.diagonal().copy()
        elif self._device_stats_ok():
            dev_samples, dev_weights, _ = self._dev()
            self.vars = _host(_stats.weighted_var(dev_samples, dev_weights, self._upload(means)))
        else:
            centered = self.samples - means
            self.vars = self.weights @ (centered * centered) / self.norm
        self.sddev = np.sqrt(self.vars)
        return self.vars

    def setDiffs(self):
        """Cache the array of parameter differences from the means."""
        self.diffs = self.mean_diffs()
        return self.diffs

    def weighted_sum(self, paramVec, where=None):
        """sum_i w_i p_i (optionally over a sample filter)."""
        vec = self._makeParamvec(paramVec)
        return self.weights @ vec if where is None else vec[where] @ self.weights[where]

    def get_norm(self, where=None):
        """Sum of sample weights."""
        if where is not None:
            return self.weights[where].sum()
        if self.norm is None:
            self.norm = self.weights.sum()
        return self.norm

    def mean(self, paramVec, where=None):
        """Weighted mean of a parameter vector (or list of them)."""
        norm = self.get_norm(where)
        if isinstance(paramVec, _seq_types):
            return np.array([self.weighted_sum(entry, where) for entry in paramVec]) / norm
        return self.weighted_sum(paramVec, where) / norm

    def mean_diff(self, paramVec, where=None):
        """p - mean(p) for one parameter vector."""
        if isinstance(paramVec, _int_types) and paramVec >= 0 and where is None:
            if self.diffs is not None:
                return self.diffs[paramVec]
            return self.samples[:, paramVec] - self.getMeans()[paramVec]
        vec = self._makeParamvec(paramVec)
        if where is None:
            return vec - self.mean(vec)
        return vec[where] - self.mean(vec, where)

    def mean_diffs(self, pars=None, where=None):
        """List of p_i - mean(p_i) arrays."""
        if pars is None:
            pars = self.n
        if isinstance(pars, _int_types) and pars >= 0:
            if where is not None:
                pars = range(pars)
            else:
                means = self.getMeans()
                return [self.samples[:, i] - means[i] for i in range(pars)]
        return [self.mean_diff(entry, where) for entry in pars]

    def var(self, paramVec, where=None):
        """Weighted variance of a parameter vector (or list of them)."""
        if isinstance(paramVec, _seq_types):
            return np.array([self.var(entry) for entry in paramVec])
        centered = self.mean_diff(paramVec, where)
        w = self.weights if where is None else self.weights[where]
        return (centered * centered) @ w / self.get_norm(where)

    def std(self, paramVec, where=None):
        """Weighted standard deviation."""
        return np.sqrt(self.var(paramVec, where))

    def cov(self, pars=None, where=None):
        """Weighted covariance for the given parameter vectors/indices (all
        parameters by default)."""
        if pars is None and where is None:
            if self._device_stats_ok():
                dev_samples, dev_weights, _ = self._dev()
                return _host(_stats.weighted_cov(dev_samples, dev_weights))
            centered = self.samples - self.getMeans()
            return (centered * self.weights[:, None]).T @ centered / self.norm
        block = np.column_stack(self.mean_diffs(pars, where))
        w = self.weights if where is None else self.weights[where]
        return (block * w[:, None]).T @ block / self.get_norm(where)

    def corr(self, pars=None):
        """Weighted correlation matrix."""
        return covToCorr(self.cov(pars), copy=True)

    def getCov(self, nparam=None, pars=None):
        """Covariance matrix (cached full version), optionally a submatrix."""
        full = self.fullcov if self.fullcov is not None else self._setCov()
        return full[np.ix_(pars, pars)] if pars is not None else full[:nparam, :nparam]

    def _setCov(self):
        self.fullcov = self.cov()
        return self.fullcov

    def getCorrelationMatrix(self):
        """Correlation matrix of all parameters (cached)."""
        if self.correlationMatrix is None:
            self.correlationMatrix = covToCorr(self.getCov(), copy=True)
        return self.correlationMatrix

    def getSignalToNoise(self, params, noise=None, R=None, eigs_only=False):
        """Signal-to-noise eigenvalues for the given parameters."""
        return getSignalToNoise(self.cov(params), noise=noise, R=R, eigs_only=eigs_only)

    # -- correlation structure --------------------------------------------------
    def getAutocorrelation(self, paramVec, maxOff=None, weight_units=True, normalized=True):
        """Weighted autocorrelation of a parameter, in weight units by
        default (reference ``chains.py:423-447``)."""
        maxOff = maxOff if maxOff is not None else self.n - 1
        weighted = self.mean_diff(paramVec) * self.weights
        if _use_device_ops():
            curve = _host(autoConvolve(self._upload(weighted), n=maxOff + 1, normalize=True))
        else:
            curve = smath.autocorr_fft(np.asarray(weighted), maxOff + 1)
        if normalized:
            curve = curve / self.var(paramVec)
        return curve * len(weighted) / self.get_norm() if weight_units else curve

    def getCorrelationLength(self, j, weight_units=True, min_corr=0.05, corr=None):
        """Autocorrelation length (reference ``chains.py:449-466``)."""
        if corr is None:
            corr = self.getAutocorrelation(j, maxOff=self.numrows // 10, weight_units=weight_units)
        return smath.acl_from_curve(corr, min_corr)

    def getEffectiveSamples(self, j=0, min_corr=0.05):
        """N_eff = sum(w) / correlation length for parameter j."""
        acl = self.getCorrelationLength(j, min_corr=min_corr)
        return self.get_norm() / acl

    def _independent_draws(self):
        """True when the sampler produces uncorrelated draws, making the
        KDE N_eff the simple weight-based formula."""
        return getattr(self, "sampler", "") in ("nested", "uncorrelated")

    def _weight_based_neff(self):
        norm = self.get_norm()
        return norm * norm / float(self.weights @ self.weights)

    def getEffectiveSamplesGaussianKDE(self, paramVec, h=0.2, scale=None, maxoff=None, min_corr=0.05):
        """Effective sample number for the leading MISE term of a Gaussian
        KDE, with adaptive lag sampling (reference ``chains.py:477-574``)."""
        if self._independent_draws():
            return self._weight_based_neff()
        d = self._makeParamvec(paramVec)
        if not scale:
            scale = self.std(d)
        kernel_std = h * scale
        if maxoff is None:
            maxoff = 4 + int(1.5 * self.getCorrelationLength(d, weight_units=False))
        maxoff = min(maxoff, self.numrows // 10)
        if _use_device_ops():
            dev_d, dev_w = self._upload(np.asarray(d, float)), self._dev()[1]

            def pair_term(k):
                return float(_stats.kde_lag_correlation(dev_d, dev_w, k, kernel_std))

        else:
            host_d, host_w = np.asarray(d, float), np.asarray(self.weights, float)

            def pair_term(k):
                return smath.kde_lag_term_1d(host_d, host_w, k, kernel_std)

        N = smath.kde_pair_sum_adaptive(pair_term, self.weights, self.numrows, maxoff, min_corr)
        norm = self.get_norm()
        return norm * norm / N

    def getEffectiveSamplesGaussianKDE_2d(self, i, j, h=0.3, maxoff=None, min_corr=0.05):
        """2D variant of the KDE effective-sample estimate (reference
        ``chains.py:576-635``)."""
        if self._independent_draws():
            return self._weight_based_neff()
        d1, d2 = self._makeParamvec(i), self._makeParamvec(j)
        pair_cov = self.cov([d1, d2])
        if abs(pair_cov[0, 1]) > 0.999 * np.sqrt(pair_cov[0, 0] * pair_cov[1, 1]):
            # fully degenerate pair: the 1D estimate is the right answer
            return self.getEffectiveSamplesGaussianKDE(i, h=h, min_corr=min_corr)
        kernel_inv = np.linalg.inv(pair_cov) / h**2
        if maxoff is None:
            acl = max(self.getCorrelationLength(d, weight_units=False) for d in (d1, d2))
            maxoff = int(acl * 1.5) + 4
        maxoff = min(maxoff, self.numrows // 10)
        if _use_device_ops():
            dev1, dev2, dev_w = self._upload(np.asarray(d1, float)), self._upload(np.asarray(d2, float)), self._dev()[1]
            dev_kinv = self._upload(kernel_inv)

            def pair_term(k):
                return float(_stats.kde_lag_correlation_2d(dev1, dev2, dev_w, k, dev_kinv))

        else:
            h1, h2, hw = np.asarray(d1, float), np.asarray(d2, float), np.asarray(self.weights, float)

            def pair_term(k):
                return smath.kde_lag_term_2d(h1, h2, hw, k, kernel_inv)

        N = smath.kde_pair_sum_scan(pair_term, self.weights, self.numrows, maxoff, min_corr)
        return self.get_norm() ** 2 / N

    # -- thinning ------------------------------------------------------------------
    def thin_indices(self, factor, weights=None):
        """Indices making unit-weight samples, assuming integer weights."""
        return self.thin_indices_single_samples(factor, self.weights if weights is None else weights)

    @staticmethod
    def thin_indices_and_weights(factor, weights):
        """(unique indices, new counts) for weight-preserving thinning."""
        ix = WeightedSamples.thin_indices_single_samples(factor, weights)
        return np.unique(ix, return_counts=True)

    @staticmethod
    def thin_indices_single_samples(factor, weights):
        """Exact integer-weight partition thinning (see
        :func:`getdist_tpu_torch.samplemath.thin_exact`)."""
        try:
            return smath.thin_exact(factor, weights)
        except ValueError as e:
            raise WeightedSampleError(str(e)) from None

    def random_single_samples_indices(self, random_state=None, thin=None, max_samples=None):
        """Random unit-weight sample indices drawn proportionally to weight."""
        if max_samples is None:
            thin = thin or 1
        elif thin is not None:
            raise WeightedSampleError("thin and max_samples cannot both be given")
        else:
            thin = max(1, self.norm / np.max(self.weights) / max_samples)
        rng = np.random.default_rng(random_state)
        keep_prob = self.weights / (np.max(self.weights) * thin)
        return np.nonzero(rng.random(self.numrows) <= keep_prob)[0]

    def thin(self, factor):
        """Thin to unit-weight samples by the given integer factor."""
        ix = self.thin_indices(factor)
        self.setSamples(
            self.samples[ix, :], loglikes=None if self.loglikes is None else self.loglikes[ix], min_weight_ratio=-1
        )

    def weighted_thin(self, factor):
        """Thin preserving (integer) weights."""
        ix, counts = self.thin_indices_and_weights(factor, self.weights)
        self.setSamples(
            self.samples[ix, :], loglikes=None if self.loglikes is None else self.loglikes[ix], weights=counts,
            min_weight_ratio=-1,
        )

    # -- filters, reweighting and confidence limits ---------------------------------
    def filter(self, where):
        """Keep only samples matching the index list / boolean filter."""
        kept_loglikes = self.loglikes[where] if self.loglikes is not None else None
        self.setSamples(self.samples[where, :], self.weights[where], kept_loglikes, min_weight_ratio=-1)

    def reweightAddingLogLikes(self, logLikes):
        """Importance-reweight by adding -log(likelihood) values."""
        offset = np.min(logLikes)
        if self.loglikes is not None:
            self.loglikes = self.loglikes + logLikes
        self.weights = np.asarray(self.weights, dtype=np.float64) * np.exp(offset - logLikes)
        self._weightsChanged()

    def cool(self, cool):
        """Multiply -log(likes) by ``cool`` and reweight accordingly."""
        if self.loglikes is None:
            raise WeightedSampleError("cool() needs likelihood values, which these samples lack")
        best = np.min(self.loglikes)
        cooled = self.loglikes * cool
        self.weights = np.asarray(self.weights, dtype=np.float64) * np.exp((self.loglikes - cooled) - best * (1 - cool))
        self.loglikes = cooled
        self._weightsChanged()

    def deleteZeros(self):
        """Remove zero-weight samples."""
        self.filter(self.weights > 0)

    def setMinWeightRatio(self, min_weight_ratio=1e-30):
        """Remove samples below min_weight_ratio of the maximum weight."""
        if self.weights is None or min_weight_ratio < 0:
            return
        cutoff = np.max(self.weights) * min_weight_ratio
        if np.min(self.weights) < cutoff:
            self.filter(self.weights > cutoff)

    def deleteFixedParams(self):
        """Remove parameters that never vary; returns (indices, values)."""
        fixed, values = [], []
        for col in range(self.samples.shape[1]):
            vec = self.samples[:, col]
            if np.isclose(vec[0], vec[-1], equal_nan=True):
                center = np.average(vec)
                if np.allclose(vec, center, rtol=1e-12, atol=0, equal_nan=True):
                    fixed.append(col)
                    values.append(center)
        if fixed:
            self.changeSamples(np.delete(self.samples, fixed, axis=1))
        return fixed, values

    def removeBurn(self, remove=0.3):
        """Remove burn-in: a fraction (< 1) or number (>= 1) of initial rows."""
        cut = int(remove) if remove >= 1 else int(round(self.numrows * remove))
        if self.weights is not None:
            self.weights = self.weights[cut:]
        if self.loglikes is not None:
            self.loglikes = self.loglikes[cut:]
        self.changeSamples(self.samples[cut:, :])

    def twoTailLimits(self, paramVec, confidence):
        """Two-tail equal-area confidence limits by sample counting."""
        tail = (1 - confidence) / 2
        return self.confidence(paramVec, np.array([tail, 1 - tail]))

    def initParamConfidenceData(self, paramVec, start=0, end=None, weights=None):
        """Sorted values/cumulative weights for repeated confidence queries."""
        w = self.weights if weights is None else weights
        values = self._makeParamvec(paramVec)[start:end]
        argsort = self._device_argsort if _use_device_ops() else np.argsort
        return smath.sorted_weight_table(values, w[start : start + len(values)], argsort=argsort)

    def _device_argsort(self, values):
        """Stable argsort on the samples' device (ties keep their order, as
        ``jnp.argsort``'s do; the table's tail values equal numpy's)."""
        return _host(torch.sort(self._upload(values), stable=True).indices)

    def confidence(self, paramVec, limfrac, upper=False, start=0, end=None, weights=None):
        """Tail-count confidence limit(s): the parameter value where limfrac
        of the total weight is further in the tail."""
        if isinstance(paramVec, ParamConfidenceData):
            table = paramVec
        else:
            table = self.initParamConfidenceData(paramVec, start, end, weights)
        return smath.tail_value(table, limfrac, upper)

    # -- output -------------------------------------------------------------
    def saveAsText(self, root, chain_index=None, make_dirs=False):
        """Save as a getdist-format text chain file."""
        parent = os.path.dirname(root)
        if make_dirs and not os.path.exists(parent):
            os.makedirs(parent)
        if root.endswith(".txt"):
            root = root[: -len(".txt")]
        suffix = "" if chain_index is None else f"_{chain_index + 1}"
        loglikes = self.loglikes if self.loglikes is not None else np.zeros(self.numrows)
        columns = np.column_stack([self.weights, loglikes, self.samples])
        np.savetxt(root + suffix + ".txt", columns, fmt=self.precision)


class Chains(WeightedSamples):
    """One or more chains of weighted samples with named parameters, from
    chain files (a root) or arrays, combined into one."""

    paramNames = None
    jobItem = None

    def __init__(
        self,
        root=None,
        jobItem=None,
        paramNamesFile=None,
        names=None,
        labels=None,
        renames=None,
        sampler=None,
        **kwargs,
    ):
        """
        :param root: optional file root (its ``.paramnames`` names the parameters)
        :param jobItem: optional grid jobItem with chainRoot/batchPath
            (:class:`~.chain_grid.ChainItem`, or a CosmoMC/Cobaya grid's)
        :param paramNamesFile: .paramnames file for names
        :param names: list of name strings
        :param labels: list of latex labels
        :param renames: dict of parameter aliases
        :param sampler: 'mcmc' (default), 'nested' or 'uncorrelated'
        :param kwargs: passed to :class:`WeightedSamples`
        """
        self.jobItem = jobItem
        self.root = root
        self.chains = None
        self.chain_offsets = None
        super().__init__(**kwargs)
        self.ignore_lines = float(kwargs.get("ignore_rows") or 0)
        name_source = paramNamesFile or self._sidecar_names(root) or names
        self.setParamNames(name_source)
        if labels is not None:
            self.paramNames.setLabels(labels)
        if renames is not None:
            self.updateRenames(renames)
        self.sampler = "mcmc"
        if isinstance(sampler, str):
            self.setSampler(sampler)

    @staticmethod
    def _sidecar_names(root):
        """A names source next to the chain files: .paramnames text or a
        Cobaya yaml."""
        if not root:
            return None
        candidate = root + ".paramnames"
        if os.path.exists(candidate):
            return candidate
        from getdist_tpu_torch import cobaya_interface

        return cobaya_interface.cobaya_params_file(root)

    def setSampler(self, sampler):
        """Set the sampler type ('mcmc', 'nested' or 'uncorrelated')."""
        sampler = sampler.lower()
        if sampler not in ("mcmc", "nested", "uncorrelated"):
            warn(f"Sampler type '{sampler}' not recognised; treating as MCMC.")
            sampler = "mcmc"
        self.sampler = sampler

    def setParamNames(self, names=None):
        """Set parameter names from a ParamNames, a ``.paramnames`` file
        name, or a list of name entries."""
        if isinstance(names, ParamNames):
            self.paramNames = deepcopy(names)
        elif isinstance(names, str):
            self.paramNames = ParamNames(names)
        elif names is None:
            self.paramNames = ParamNames(default=self.n) if self.samples is not None else None
        else:
            self.paramNames = ParamNames(names=names)
        if self.paramNames:
            self._getParamIndices()
        self.needs_update = True

    def getParamNames(self):
        """The :class:`~.paramnames.ParamNames` for these samples."""
        return self.paramNames

    def getRenames(self):
        """Dict of renames known to each parameter."""
        return self.paramNames.getRenames()

    def updateRenames(self, renames):
        """Merge a rename dict into the parameter aliases."""
        self.paramNames.updateRenames(renames)

    def _getParamIndices(self):
        declared = len(self.paramNames.names)
        if self.samples is not None and declared != self.n:
            raise WeightedSampleError(f"{declared} names declared but the sample array has {self.n} parameters")
        self.index = {info.name: i for i, info in enumerate(self.paramNames.names)}
        return self.index

    def _parAndNumber(self, name):
        """(index, ParamInfo) for a name, index, or ParamInfo."""
        if isinstance(name, ParamInfo):
            name = name.name
        if isinstance(name, str):
            slot = self.index.get(name)
            if slot is None:
                return None, None
            name = slot
        if isinstance(name, _int_types):
            return name, self.paramNames.names[name]
        raise ParamError(f"Unknown parameter type {name}")

    # -- named vectors --------------------------------------------------------
    def setParams(self, obj):
        """Attach obj.<name> sample vectors for every parameter; dotted
        names create sub-objects (obj.aa.bb.cc)."""
        # two passes: first grow every intermediate node, then bind values:
        # a leaf that is also a prefix of another name gets its vector on
        # node.value instead of clobbering the sub-object
        paths = [info.name.split(".") for info in self.paramNames.names]
        for path in paths:
            node = obj
            for part in path[:-1]:
                if not hasattr(node, part):
                    setattr(node, part, ParSamples())
                node = getattr(node, part)
        for column, path in enumerate(paths):
            node = obj
            for part in path[:-1]:
                node = getattr(node, part)
            leaf = getattr(node, path[-1], None)
            if isinstance(leaf, ParSamples):
                leaf.value = self.samples[:, column]
            else:
                setattr(node, path[-1], self.samples[:, column])
        return obj

    def getParams(self):
        """A ParSamples bundle with a vector attribute per parameter."""
        return self.setParams(ParSamples())

    def getParamSampleDict(self, ix, want_derived=True):
        """Dict of parameter values for one sample row."""
        row = {"weight": self.weights[ix], "loglike": None if self.loglikes is None else self.loglikes[ix]}
        for i, info in enumerate(self.paramNames.names):
            if want_derived or not info.isDerived:
                row[info.name] = self.samples[ix, i]
        return row

    def _makeParamvec(self, par):
        if self.needs_update:
            self.updateBaseStatistics()
        if isinstance(par, ParamInfo):
            par = par.name
        if not isinstance(par, str):
            return super()._makeParamvec(par)
        column = self.index.get(par)
        if column is not None:
            return self.samples[:, column]
        special = {"weight": self.weights, "loglike": self.loglikes}
        if par in special:
            return special[par]
        raise ParamError(f"no parameter named {par}")

    def updateBaseStatistics(self):
        """Recompute means/vars and multiplicity stats after changes."""
        self.needs_update = False
        self.setMeans()
        self.getVars()
        self._getParamIndices()
        self.max_mult, self.mean_mult = self.weights.max(), self.norm / self.numrows
        return self

    def updateChainBaseStatistics(self):
        # legacy name
        return self.updateBaseStatistics()

    def addDerived(self, paramVec, name, **kwargs):
        """Append a derived parameter vector with the given name."""
        if self.paramNames.parWithName(name):
            raise ValueError(f"Parameter with name {name} already exists")
        self.changeSamples(np.c_[self.samples, paramVec])
        return self.paramNames.addDerived(name, **kwargs)

    @staticmethod
    def _nesting_depth(obj):
        """How many times obj can be indexed at [0] (1 = vector, 2 = array,
        3 = list of arrays)."""
        depth = 0
        while True:
            try:
                obj = obj[0]
                depth += 1
            except (TypeError, IndexError):
                return depth

    def loadChains(self, root, files_or_samples, weights=None, loglikes=None, ignore_lines=None):
        """Load chains from a list of files, a single array, or a list of
        arrays; returns True if anything was loaded."""
        self.chains = []
        self.samples = self.weights = self.loglikes = None
        if ignore_lines is None:
            ignore_lines = self.ignore_lines
        if files_or_samples is None or (hasattr(files_or_samples, "__len__") and not len(files_or_samples)):
            raise ValueError("loadChains got nothing to load")
        from_files = isinstance(files_or_samples, str) or isinstance(files_or_samples[0], str)
        if from_files:
            if weights is not None or loglikes is not None:
                raise ValueError("weights/loglikes arguments only apply to in-memory arrays")
            count = self._chains_from_files(root, files_or_samples, ignore_lines)
        else:
            count = self._chains_from_arrays(files_or_samples, weights, loglikes, ignore_lines)
        self._weightsChanged()
        return count > 0

    def _chains_from_files(self, root, files, ignore_lines):
        if isinstance(files, str):
            files = [files]
        if not self.name_tag:
            self.name_tag = os.path.basename(root)
        for fname in files:
            print_load_line(fname)
            try:
                self.chains.append(
                    WeightedSamples(fname, ignore_rows=ignore_lines, min_weight_ratio=self.min_weight_ratio,
                                    device=self.device)
                )
            except WeightedSampleError:
                print_load_line(f"Ignored file {fname} (likely empty)")
        if not self.chains:
            raise WeightedSampleError(f"no chains found for root {root}")
        return len(self.chains)

    def _chains_from_arrays(self, arrays, weights, loglikes, ignore_lines):
        depth = self._nesting_depth(arrays)
        if depth in (1, 2):
            self.chains = None
            trimmed = (slice_or_none(block, ignore_lines) for block in (arrays, weights, loglikes))
            self.setSamples(*trimmed, self.min_weight_ratio)
            if self.paramNames is None:
                self.paramNames = ParamNames(default=self.n)
            return 1
        if depth != 3:
            raise ValueError("expected a sample array, or a list of sample arrays or file names")
        for i, block in enumerate(arrays):
            self.chains.append(
                WeightedSamples(
                    samples=block,
                    loglikes=None if loglikes is None else loglikes[i],
                    weights=None if weights is None else weights[i],
                    ignore_rows=ignore_lines,
                    min_weight_ratio=self.min_weight_ratio,
                    device=self.device,
                )
            )
        if self.paramNames is None:
            self.paramNames = ParamNames(default=self.chains[0].n)
        return len(self.chains)

    def makeSingle(self):
        """Concatenate separate chains into one array, recording offsets."""
        if not self.chains:
            raise ValueError("makeSingle() needs separated chains, and there are none")
        lengths = [chain.samples.shape[0] for chain in self.chains]
        self.chain_offsets = np.cumsum(np.array([0] + lengths))
        first = self.chains[0]
        self.setSamples(
            np.vstack([c.samples for c in self.chains]),
            None if first.weights is None else np.hstack([c.weights for c in self.chains]),
            None if first.loglikes is None else np.hstack([c.loglikes for c in self.chains]),
            min_weight_ratio=-1,
        )
        self.chains = None
        self.needs_update = True
        return self

    def getSeparateChains(self):
        """Per-chain WeightedSamples views (no copies when combined), on
        this object's device."""
        if self.chains is not None:
            return self.chains
        if self.chain_offsets is None:
            raise WeightedSampleError("these samples were never combined from separate chains")
        return [
            WeightedSamples(
                samples=self.samples[lo:hi],
                weights=self.weights[lo:hi],
                loglikes=None if self.loglikes is None else self.loglikes[lo:hi],
                device=self.device,
            )
            for lo, hi in zip(self.chain_offsets[:-1], self.chain_offsets[1:])
        ]

    def filter(self, where):
        """Filter samples, fixing up chain offsets so chains stay splittable."""
        if self.chains is not None:
            raise ValueError("chains are still separated: makeSingle first, or filter each chain")
        if self.chain_offsets is not None:
            kept = [np.count_nonzero(where[lo:hi]) for lo, hi in zip(self.chain_offsets[:-1], self.chain_offsets[1:])]
            self.chain_offsets = np.cumsum(np.array([0] + kept))
        super().filter(where)

    def weighted_thin(self, factor):
        """Weight-preserving thin, applied per chain when chains exist."""
        if not self.chains and self.chain_offsets is None:
            return super().weighted_thin(factor)
        was_split = self.chains
        parts = self.getSeparateChains()
        for part in parts:
            part.weighted_thin(factor)
        self.chains = parts
        if not was_split:
            self.makeSingle()
        self.needs_update = True

    def removeBurnFraction(self, ignore_frac):
        """Remove burn-in fraction from combined samples or each chain."""
        if self.samples is None:
            for chain in self.chains:
                chain.removeBurn(ignore_frac)
            return
        self.removeBurn(ignore_frac)
        self.chains = None
        self.needs_update = True

    def deleteFixedParams(self):
        """Delete non-varying parameters, updating names and any ranges."""
        if self.samples is None:
            lead, *rest = self.chains
            fixed, values = lead.deleteFixedParams()
            for chain in rest:
                chain.changeSamples(np.delete(chain.samples, fixed, axis=1))
        else:
            fixed, values = super().deleteFixedParams()
            self.chains = None
        bounds = getattr(self, "ranges", None)
        if bounds is not None:
            for ix, value in zip(fixed, values):
                bounds.setFixed(self.paramNames.names[ix].name, value)
        self.paramNames.deleteIndices(fixed)
        self._getParamIndices()

    # -- convergence ------------------------------------------------------------
    def getGelmanRubinEigenvalues(self, nparam=None, chainlist=None):
        """var(mean)/mean(var) eigenvalues over orthogonalized parameters
        (Brooks & Gelman)."""
        chainlist = chainlist if chainlist is not None else self.getSeparateChains()
        nparam = nparam if nparam else self.paramNames.numNonDerived()
        return smath.gelman_rubin_eigs(
            self.getMeans()[:nparam],
            [chain.getMeans()[:nparam] for chain in chainlist],
            [chain.getCov(nparam) for chain in chainlist],
        )

    def getGelmanRubin(self, nparam=None, chainlist=None):
        """Worst-eigenvalue R-1 statistic (should be << 1 when converged)."""
        return np.max(self.getGelmanRubinEigenvalues(nparam, chainlist))

    # -- output -----------------------------------------------------------------
    def saveAsText(self, root, chain_index=None, make_dirs=False):
        """Save samples and .paramnames metadata as text."""
        super().saveAsText(root, chain_index, make_dirs)
        if not chain_index:
            self.saveTextMetadata(root)

    def saveTextMetadata(self, root):
        """Save metadata (.paramnames) alongside chain text files."""
        self.paramNames.saveAsText(root + ".paramnames")

    def __getstate__(self):
        """Pickle without the device-resident caches: the statistics'
        upload, the parity and fused paths' chain copies on the card, the
        cumulant score, a ``mesh=`` block and its process group. They
        rebuild at the next call, on the device of the object that
        unpickles."""
        state = self.__dict__.copy()
        state["_device_cache"] = None
        state["_parity_chain_cache"] = None
        state["_fast_chain_cache"] = None
        state["_param_range_cache"] = {}
        return state

    def savePickle(self, filename):
        """Pickle this object to a file."""
        with open(filename, "wb") as stream:
            pickle.dump(self, stream, protocol=pickle.HIGHEST_PROTOCOL)


# -- module-level chain-file helpers ------------------------------------------


def print_load_line(message):
    if print_load_details:
        print(message)


def last_modified(files):
    """Latest modification time among the files that exist."""
    stamps = (os.path.getmtime(fname) for fname in files if os.path.exists(fname))
    return max(stamps)


def chainFiles(root, chain_indices=None, ext=".txt", separator="_", first_chain=0, last_chain=-1, chain_exclude=None):
    """List chain sample files for a root name, applying index filters."""
    return smath.match_chain_files(root, chain_indices, ext, separator, first_chain, last_chain, chain_exclude)


def hasChainFiles(file_root, ext=".txt"):
    found = (chainFiles(file_root, ext=ext, separator=sep, last_chain=1) for sep in "_.")
    return any(found)


def findChainFileRoot(chain_dir, root, search_subdirectories=True):
    """Find a chain root under a directory tree; returns full path root or None."""
    root = re.sub(r"[/\\]", re.escape(os.sep), root)
    direct = os.path.join(chain_dir, root)
    if hasChainFiles(direct):
        return direct
    if search_subdirectories:
        for base, dirs, _files in os.walk(chain_dir):
            for subdir in dirs:
                candidate = os.path.join(base, subdir, root)
                if hasChainFiles(candidate):
                    return candidate
    return None


def loadNumpyTxt(fname, skiprows=None):
    """A (rows, cols) f64 array of a whitespace-separated text file, parsed
    by the port's native loader (:func:`getdist_tpu_torch._native.
    load_chain_text`: bit for bit ``np.loadtxt``). A malformed file raises
    ``ValueError`` naming it; there is no fallback parser."""
    from getdist_tpu_torch import _native

    return np.atleast_2d(_native.load_chain_text(fname, skiprows or 0))
