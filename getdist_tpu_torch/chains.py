"""Weighted sample containers built from arrays (host numpy).

The port's own copy of the parts of ``getdist_tpu/chains.py`` that parity
mode needs: :class:`WeightedSamples` (weights, burn-in, min-weight filter,
fixed-parameter removal) and :class:`Chains` (parameter names, several
arrays combined into one), with the host statistics in the same
arithmetic as the JAX package's numpy branches: means, variances,
covariance and correlation, the FFT autocorrelation length and the
Gaussian-KDE effective sample number.

Not ported here: loading chains or parameter names from files and
renames (ROADMAP A10), the device statistics branches (the JAX package's
``ops.stats``; ROADMAP A7), covariance and correlation of parameter
subsets, thinning, Gelman-Rubin and text output.
"""

from copy import deepcopy

import numpy as np

from getdist_tpu_torch import samplemath as smath
from getdist_tpu_torch.paramnames import ParamInfo, ParamNames
from getdist_tpu_torch.samplemath import ParamConfidenceData

_int_types = (int, np.integer)
_seq_types = (list, tuple)


class WeightedSampleError(Exception):
    """Error in a WeightedSamples operation."""


class ParamError(WeightedSampleError):
    """A bad parameter was requested."""


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to getdist_tpu_torch yet (ROADMAP {item})")


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


class WeightedSamples:
    """A set of weighted parameter samples held as numpy arrays.

    :ivar weights: (N,) weights per sample
    :ivar loglikes: (N,) -log(posterior) per sample, or None
    :ivar samples: (N, n) parameter values
    :ivar n: number of parameters
    :ivar numrows: number of samples
    """

    def __init__(
        self,
        filename=None,
        ignore_rows=0,
        samples=None,
        weights=None,
        loglikes=None,
        name_tag=None,
        label=None,
        min_weight_ratio=1e-30,
    ):
        self.min_weight_ratio = min_weight_ratio
        if filename:
            raise _not_ported("loading chains from files", "A10")
        self.name_tag = name_tag
        trimmed = (slice_or_none(arr, ignore_rows) for arr in (samples, weights, loglikes))
        self.setSamples(*trimmed)
        self.needs_update = True
        self.label = label

    # -- setup ---------------------------------------------------------------
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
        # the parity path's device-resident chain (MCSamples)
        self._parity_chain_cache = None
        self._param_range_cache = {}

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

    # -- moments -------------------------------------------------------------
    def setMeans(self):
        """Compute and cache weighted means."""
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
        else:
            centered = self.samples - means
            self.vars = self.weights @ (centered * centered) / self.norm
        self.sddev = np.sqrt(self.vars)
        return self.vars

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

    def cov(self):
        """Weighted covariance of all parameters."""
        centered = self.samples - self.getMeans()
        return (centered * self.weights[:, None]).T @ centered / self.norm

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

    # -- correlation structure --------------------------------------------------
    def getAutocorrelation(self, paramVec, maxOff=None, weight_units=True, normalized=True):
        """Weighted autocorrelation of a parameter, in weight units by
        default (reference ``chains.py:423-447``)."""
        maxOff = maxOff if maxOff is not None else self.n - 1
        weighted = self.mean_diff(paramVec) * self.weights
        curve = smath.autocorr_fft(np.asarray(weighted), maxOff + 1)
        if normalized:
            curve = curve / self.var(paramVec)
        return curve * len(weighted) / self.get_norm() if weight_units else curve

    def getCorrelationLength(self, j, weight_units=True, min_corr=0.05, corr=None):
        """Autocorrelation length (reference ``chains.py:449-466``)."""
        if corr is None:
            corr = self.getAutocorrelation(j, maxOff=self.numrows // 10, weight_units=weight_units)
        return smath.acl_from_curve(corr, min_corr)

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
        host_d, host_w = np.asarray(d, float), np.asarray(self.weights, float)

        def pair_term(k):
            return smath.kde_lag_term_1d(host_d, host_w, k, kernel_std)

        N = smath.kde_pair_sum_adaptive(pair_term, self.weights, self.numrows, maxoff, min_corr)
        norm = self.get_norm()
        return norm * norm / N

    # -- filters and confidence limits -------------------------------------------
    def filter(self, where):
        """Keep only samples matching the index list / boolean filter."""
        kept_loglikes = self.loglikes[where] if self.loglikes is not None else None
        self.setSamples(self.samples[where, :], self.weights[where], kept_loglikes, min_weight_ratio=-1)

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

    def initParamConfidenceData(self, paramVec, start=0, end=None, weights=None):
        """Sorted values/cumulative weights for repeated confidence queries."""
        w = self.weights if weights is None else weights
        values = self._makeParamvec(paramVec)[start:end]
        return smath.sorted_weight_table(values, w[start : start + len(values)])

    def confidence(self, paramVec, limfrac, upper=False, start=0, end=None, weights=None):
        """Tail-count confidence limit(s): the parameter value where limfrac
        of the total weight is further in the tail."""
        if isinstance(paramVec, ParamConfidenceData):
            table = paramVec
        else:
            table = self.initParamConfidenceData(paramVec, start, end, weights)
        return smath.tail_value(table, limfrac, upper)


class Chains(WeightedSamples):
    """Weighted samples with named parameters, from one array or several
    arrays combined into one."""

    paramNames = None
    jobItem = None

    def __init__(self, root=None, jobItem=None, names=None, labels=None, sampler=None, **kwargs):
        if root or jobItem is not None:
            raise _not_ported("chain roots and grid job items", "A10")
        self.jobItem = jobItem
        self.root = root
        self.chains = None
        self.chain_offsets = None
        super().__init__(**kwargs)
        self.ignore_lines = float(kwargs.get("ignore_rows") or 0)
        self.setParamNames(names)
        if labels is not None:
            self.paramNames.setLabels(labels)
        self.sampler = "mcmc"
        if isinstance(sampler, str):
            sampler = sampler.lower()
            self.sampler = sampler if sampler in ("mcmc", "nested", "uncorrelated") else "mcmc"

    def setParamNames(self, names=None):
        """Set parameter names from a ParamNames or a list of name entries."""
        if isinstance(names, ParamNames):
            self.paramNames = deepcopy(names)
        elif isinstance(names, str):
            raise _not_ported("parameter names from files", "A10")
        elif names is None:
            self.paramNames = ParamNames(default=self.n) if self.samples is not None else None
        else:
            self.paramNames = ParamNames(names=names)
        if self.paramNames:
            self._getParamIndices()
        self.needs_update = True

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
        """Load one sample array or a list of arrays; returns True if
        anything was loaded."""
        self.chains = []
        self.samples = self.weights = self.loglikes = None
        if ignore_lines is None:
            ignore_lines = self.ignore_lines
        if files_or_samples is None or (hasattr(files_or_samples, "__len__") and not len(files_or_samples)):
            raise ValueError("loadChains got nothing to load")
        if isinstance(files_or_samples, str) or isinstance(files_or_samples[0], str):
            raise _not_ported("loading chains from files", "A10")
        depth = self._nesting_depth(files_or_samples)
        if depth in (1, 2):
            self.chains = None
            trimmed = (slice_or_none(block, ignore_lines) for block in (files_or_samples, weights, loglikes))
            self.setSamples(*trimmed, self.min_weight_ratio)
            if self.paramNames is None:
                self.paramNames = ParamNames(default=self.n)
        elif depth == 3:
            for i, block in enumerate(files_or_samples):
                self.chains.append(
                    WeightedSamples(
                        samples=block,
                        loglikes=None if loglikes is None else loglikes[i],
                        weights=None if weights is None else weights[i],
                        ignore_rows=ignore_lines,
                        min_weight_ratio=self.min_weight_ratio,
                    )
                )
            if self.paramNames is None:
                self.paramNames = ParamNames(default=self.chains[0].n)
        else:
            raise ValueError("expected a sample array, or a list of sample arrays")
        self._weightsChanged()
        return True

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
