"""MCSamples: the sample-analysis object of the port, for parity mode.

The port's own, jax-free copy of the parts of ``getdist_tpu/mcsamples.py``
that device parity mode (``fastParityDensities(device=True)``) runs: the
constructor from arrays and analysis settings, parameter ranges, the host
1D densities (binning, ISJ bandwidth, FFT smoothing, boundary and
multiplicative bias corrections), the host-exact 2D bandwidths, and the
parity driver itself, whose O(N) passes and 2D convolutions run on a torch
device (the card by default) through :mod:`getdist_tpu_torch.ops`.

Host statistics (means, covariance, correlation lengths, N_eff) are numpy,
as the JAX package's parity modes pin them (``_pin_host_stats``): the
scipy bandwidth optimizers move by up to ~1e-4 under a 1-ulp input wobble,
so their inputs are kept identical to the JAX package's wherever the
arithmetic allows.

Not ported here: loading chains from files and the plots/CLI layers
(ROADMAP A10), the fused ``fastTriangleDensities`` host layer (A6), the
host parity variant ``fastParityDensities(device=False)`` and chains with
fractional weights (A8), periodic parameters in parity mode (A3), and the
2D effective-sample estimate (``use_effective_samples_2D``).
"""

import copy
import logging
import os
import time
from collections.abc import Mapping

import numpy as np
import torch

from getdist_tpu_torch import kde_bandwidth as kde
from getdist_tpu_torch.chains import Chains, WeightedSampleError
from getdist_tpu_torch.densities import Density1D, Density2D
from getdist_tpu_torch.inifile import IniFile
from getdist_tpu_torch.ops import parity_device as pdev
from getdist_tpu_torch.ops._cuda import resolve_device
from getdist_tpu_torch.ops.batched import all_2d_densities
from getdist_tpu_torch.ops.convolve import convolveFFT_host as convolve1D
from getdist_tpu_torch.parampriors import ParamBounds

__all__ = ["MCSamples", "MCSamplesError", "SettingError", "BandwidthError", "default_getdist_settings"]

default_getdist_settings = os.path.join(os.path.dirname(os.path.abspath(__file__)), "analysis_defaults.ini")


class MCSamplesError(WeightedSampleError):
    """Error raised by MCSamples operations."""


class SettingError(MCSamplesError):
    """Bad analysis settings."""


class BandwidthError(MCSamplesError):
    """KDE bandwidth determination failure."""


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to getdist_tpu_torch yet (ROADMAP {item})")


# defaults applied as attributes of every MCSamples before settings merge;
# keys mirror analysis_defaults.ini (values here are the hard-coded floor,
# and their types are the types the ini values are read as)
_BASE_ANALYSIS_SETTINGS = dict(
    range_ND_contour=1,
    range_confidence=0.001,
    num_bins=128,
    fine_bins=1024,
    num_bins_2D=40,
    fine_bins_2D=256,
    smooth_scale_1D=-1.0,
    smooth_scale_2D=-1.0,
    boundary_correction_order=1,
    mult_bias_correction_order=1,
    max_corr_2D=0.95,
    use_effective_samples_2D=False,
    no_warning_chi2_params=True,
)


class Kernel1D:
    """Discrete normalized Gaussian window over [-winw, winw] bins."""

    def __init__(self, winw, h):
        self.winw = winw
        self.h = h
        self.x = np.arange(-winw, winw + 1)
        win = np.exp(-((self.x / h) ** 2) / 2.0)
        self.Win = win / np.sum(win)


class MCSamples(Chains):
    """Weighted parameter samples with KDE densities: the parity-mode subset
    of the JAX package's MCSamples, on a torch device."""

    def __init__(self, root=None, jobItem=None, ini=None, settings=None, ranges=None, samples=None, weights=None,
                 loglikes=None, device="cuda", **kwargs):
        """
        :param ini: .ini file (or IniFile) of analysis settings
        :param settings: dict of setting overrides
        :param ranges: dict/list of hard prior bounds per parameter; a
            triplet [min, max, True] marks a periodic parameter
        :param samples: array (or list of arrays) of sample values
        :param weights: weights array(s)
        :param loglikes: -log(posterior) array(s)
        :param device: torch device of the parity path's device passes, the
            card unless the caller names the CPU (raises without CUDA)
        :param kwargs: names/labels/ignore_rows/label/name_tag/sampler
            passed to the inherited classes
        """
        self.device = resolve_device(device)
        super().__init__(root, jobItem=jobItem, **kwargs)
        self.ini = ini
        self.ranges = ParamBounds()
        if ranges is not None:
            self.setRanges(ranges)
        for key, value in _BASE_ANALYSIS_SETTINGS.items():
            setattr(self, key, value)
        self.contours = np.array([0.68, 0.95])
        self.no_warning_params, self.density1D = [], {}
        self.parity_profile, self.parity_buckets = {}, []
        if "ignore_rows" in kwargs:
            settings = dict(settings or {})
            settings["ignore_rows"] = kwargs["ignore_rows"]
        self.ignore_rows = float(kwargs.get("ignore_rows") or 0)
        if not np.isclose(self.ignore_rows, 0) and self.sampler == "nested":
            raise ValueError("nested-sampler samples have no burn-in phase to remove")
        self.updateSettings(ini=ini, settings=settings)
        if samples is not None:
            self.readChains(samples, weights, loglikes)

    # -- settings and chains ------------------------------------------------------------

    def readChains(self, files_or_samples, weights=None, loglikes=None):
        """Load sample arrays, remove burn-in, delete fixed parameters, and
        combine into a single samples array."""
        self.loadChains(self.root, files_or_samples, weights=weights, loglikes=loglikes)
        if self.ignore_frac:
            self.removeBurnFraction(self.ignore_frac)
        self.deleteFixedParams()
        if self.chains is not None:
            self.makeSingle()
        self.updateBaseStatistics()
        return self

    def updateSettings(self, settings: Mapping | None = None, ini=None, doUpdate=True):
        """Apply settings from an ini file and/or dict of overrides."""
        if settings is not None and not isinstance(settings, Mapping):
            raise TypeError("settings must be a mapping of option overrides")
        if not ini:
            ini = self.ini or IniFile(default_getdist_settings)
        else:
            ini = IniFile(ini) if isinstance(ini, str) else copy.deepcopy(ini)
        ini.params.update(settings or {})
        self.ini = ini
        self.initParameters(ini)
        self._param_range_cache = {}
        if doUpdate and self.samples is not None:
            self.updateBaseStatistics()

    def initParameters(self, ini):
        """Read the analysis settings from an IniFile onto this object."""
        ini.setAttr("ignore_rows", self)
        self.ignore_lines = int(self.ignore_rows)
        self.ignore_frac = self.ignore_rows if not self.ignore_lines else 0
        ini.setAttr("min_weight_ratio", self)
        for name in ("range_ND_contour", "range_confidence", "num_bins", "fine_bins", "num_bins_2D", "fine_bins_2D",
                     "smooth_scale_1D", "smooth_scale_2D"):
            ini.setAttr(name, self)
        for name, default in (("boundary_correction_order", 1), ("mult_bias_correction_order", 1)):
            ini.setAttr(name, self, default)
        ini.setAttr("max_corr_2D", self)
        if ini.hasKey("contours"):
            ini.setAttr("contours", self)
        elif ini.hasKey("num_contours"):
            n_levels = ini.int("num_contours", 2)
            self.contours = np.array([ini.float("contour" + str(i + 1)) for i in range(n_levels)])
        for name, default in (("no_warning_params", []), ("no_warning_chi2_params", True)):
            ini.setAttr(name, self, default)

    def setRanges(self, ranges):
        """Set hard prior bounds from a list/array/dict/ParamBounds; a
        [min, max, True] triplet marks a periodic parameter."""
        if isinstance(ranges, np.ndarray) and ranges.ndim == 2 and ranges.shape[1] == 2:
            ranges = ranges.tolist()
        if isinstance(ranges, (list, tuple)):
            for i, window in enumerate(ranges):
                self.ranges.setRange(self.paramNames.name(i), window)
        elif isinstance(ranges, Mapping):
            for name, window in ranges.items():
                self.ranges.setRange(name, window)
        elif isinstance(ranges, ParamBounds):
            self.ranges = copy.deepcopy(ranges)
        else:
            raise ValueError("ranges must be a list/array, dict, or ParamBounds")
        self.needs_update = True

    def _initLimits(self, ini=None):
        shared_spec = ini.string("all_limits", "") if ini else ""
        for par in self.paramNames.names:
            spec = shared_spec
            if ini and not spec:
                spec = ini.string("limits[%s]" % par.name) if "limits[%s]" % par.name in ini.params else ""
            pieces = spec.split()
            if len(pieces) == 2:
                self.ranges.setRange(par.name, pieces)
            par.limmin, par.limmax = self.ranges.getLower(par.name), self.ranges.getUpper(par.name)
            par.has_limits_bot = par.limmin is not None
            par.has_limits_top = par.limmax is not None
            par.periodic = par.name in self.ranges.periodic

    def updateBaseStatistics(self):
        """Refresh basic statistics, limits and the per-parameter caches."""
        # full covariance first: getVars (inside the base update) then reads
        # the variances off its diagonal instead of a second O(N x p) pass
        self.means = None
        self.fullcov = None
        self._setCov()
        super().updateBaseStatistics()
        weight_ceiling = (self.mean_mult * self.numrows) / min(self.numrows // 2, 500)
        n_outliers = np.sum(self.weights > weight_ceiling)
        if n_outliers:
            logging.warning("%s of samples carry outlier weights", float(n_outliers) / self.numrows)
        self.density1D = dict()
        self._param_range_cache = {}
        self._initLimits(self.ini)
        for par in self.paramNames.names:
            par.N_eff_kde = None
        return self

    # -- parameter ranges ----------------------------------------------------------------

    @staticmethod
    def _peak_scale(quantiles, lo, hi, err):
        """Peak-structure width from 10%-quantile spacings (simplified
        Janssen 95): the smallest span of 4 consecutive deciles, in sigma
        units of a unit Gaussian (whose tightest such span is 1.049 sd)."""
        knots = np.concatenate(([lo], quantiles, [hi]))
        spans = knots[4:] - knots[:-4]
        tightest = np.min(spans) / 1.049
        if np.all(spans > err * 1.049) and np.all(spans < tightest * 1.5):
            return tightest  # very flat distribution
        return min(err, tightest)

    def _snap_range_to_limits(self, par, smooth_1D):
        """Pull range ends onto nearby hard priors, or drop the limit flag
        (and pad the range) when the samples sit far from the bound."""
        if par.has_limits_bot:
            clear_of_limit = par.range_min - par.limmin > 2 * smooth_1D and par.param_min - par.limmin > smooth_1D
            if clear_of_limit:
                par.has_limits_bot = False
            else:
                par.range_min = par.limmin
        if par.has_limits_top:
            clear_of_limit = par.limmax - par.range_max > 2 * smooth_1D and par.limmax - par.param_max > smooth_1D
            if clear_of_limit:
                par.has_limits_top = False
            else:
                par.range_max = par.limmax
        if not par.has_limits_bot:
            par.range_min -= 2 * smooth_1D
        if not par.has_limits_top:
            par.range_max += 2 * smooth_1D
        par.has_limits = par.has_limits_top or par.has_limits_bot

    def _initParam(self, par, paramVec, mean=None, sddev=None, paramConfid=None):
        """Set par.err/mean/param_min/param_max/range_min/range_max and the
        peak-structure scale sigma_range (reference ``mcsamples.py:
        1427-1484``); snaps range ends to hard limits when nearby."""
        par.mean = paramVec.mean() if mean is None else mean
        par.err = paramVec.std() if sddev is None else sddev
        par.param_min = np.min(paramVec)
        par.param_max = np.max(paramVec)
        paramConfid = paramConfid or self.initParamConfidenceData(paramVec)
        deciles = np.linspace(0.1, 0.9, 9)
        probe = np.concatenate(([self.range_confidence, 1 - self.range_confidence], deciles))
        levels = self.confidence(paramConfid, probe)
        par.range_min, par.range_max = levels[0], levels[1]
        par.sigma_range = self._peak_scale(levels[2:], par.param_min, par.param_max, par.err)
        if self.range_ND_contour >= 0 and self.loglikes is not None:
            raise _not_ported("ranges from the ND likelihood contour (range_ND_contour >= 0)", "A10")
        self._snap_range_to_limits(par, par.sigma_range * 0.4)
        return par

    def _initParamRanges(self, j, paramConfid=None):
        if isinstance(j, str):
            j = self.index[j]
        cache = getattr(self, "_param_range_cache", None)
        if paramConfid is None and cache is not None and j in cache:
            return cache[j]
        paramVec = self.samples[:, j]
        info = self.paramNames.names[j]
        par = self._initParam(info, paramVec, self.means[j], self.sddev[j], paramConfid)
        if paramConfid is None and cache is not None:
            cache[j] = par
        return par

    def _binSamples(self, paramVec, par, num_fine_bins, borderfrac=0.1):
        """Fine-bin index per sample over an edge-padded range; first and
        last bins are half width."""
        pad = (par.range_max - par.range_min) * borderfrac
        binmin = min(par.param_min, par.range_min) - (0 if par.has_limits_bot else pad)
        binmax = max(par.param_max, par.range_max) + (0 if par.has_limits_top else pad)
        fine_width = (binmax - binmin) / (num_fine_bins - 1)
        ix = ((paramVec - binmin) / fine_width + 0.5).astype(np.int64)
        return ix, fine_width, binmin, binmax

    # -- 1D densities ----------------------------------------------------------------------

    def _get1DNeff(self, par, param):
        N_eff = getattr(par, "N_eff_kde", None)
        if N_eff is None:
            N_eff = par.N_eff_kde = self.getEffectiveSamplesGaussianKDE(param, scale=par.sigma_range)
        return N_eff

    def getAutoBandwidth1D(self, bins, par, param, mult_bias_correction_order=None, kernel_order=1, N_eff=None):
        """ISJ bandwidth (in units of the bin range), with rule-of-thumb
        fallback and the higher-order rescale h * N^(1/5 - 1/(4m+5)) when
        multiplicative bias correction is used (reference
        ``mcsamples.py:1237-1283``)."""
        if N_eff is None:
            N_eff = self._get1DNeff(par, param)
        h = kde.gaussian_kde_bandwidth_binned(bins, Neff=N_eff)
        top, bottom = max(par.param_max, par.range_max), min(par.param_min, par.range_min)
        bin_range = top - bottom
        floor = 0.01 * N_eff ** (-1.0 / 5) * (par.range_max - par.range_min) / bin_range
        if h is None or h < floor:
            hnew = 1.06 * par.sigma_range * N_eff ** (-1.0 / 5) / bin_range
            suppressed = par.name in self.no_warning_params or (
                self.no_warning_chi2_params and ("chi2_" in par.name or "minuslog" in par.name)
            )
            if not suppressed:
                msg = (
                    f"ISJ bandwidth for {par.name} tiny or undetermined "
                    f"(h={h}, N_eff={N_eff}); falling back to h={hnew}"
                )
                if getattr(self, "raise_on_bandwidth_errors", False):
                    raise BandwidthError(msg)
                logging.warning(msg)
            h = hnew
        par.kde_h = h
        m = self.mult_bias_correction_order if mult_bias_correction_order is None else mult_bias_correction_order
        if kernel_order > 1:
            m = max(m, 1)
        if not m:
            return h
        # rescale the Parzen-optimal width for the higher-order
        # (bias-corrected) estimator's N scaling
        return h * N_eff ** (1.0 / 5 - 1.0 / (4 * m + 5))

    def get1DDensityGridData(self, j, paramConfid=None, **kwargs):
        """The marginalized 1D KDE density of a parameter, on the host
        (reference ``mcsamples.py:1517-1686``): fine binning -> auto ISJ
        bandwidth -> FFT convolution -> boundary kernel correction ->
        multiplicative bias iterations -> peak-normalized Density1D."""
        if self.needs_update:
            self.updateBaseStatistics()
        index = self._parAndNumber(j)[0]
        if index is None:
            return None
        par = self._initParamRanges(index, paramConfid)
        if par.periodic:
            raise _not_ported("periodic 1D densities", "A3")
        pick = lambda name: kwargs.get(name, getattr(self, name))  # noqa: E731
        num_bins, fine_bins = pick("num_bins"), pick("fine_bins")
        smooth_scale_1D = pick("smooth_scale_1D")
        boundary_order = pick("boundary_correction_order")
        mult_bias_order = pick("mult_bias_correction_order")

        span = par.range_max - par.range_min
        if span <= 0:
            raise MCSamplesError(f"{par.name} has an empty parameter range")
        coarse_width = span / (num_bins - 1)

        bin_indices, fine_width, binmin, binmax = self._binSamples(self.samples[:, index], par, fine_bins)
        bins = np.bincount(bin_indices, weights=self.weights, minlength=fine_bins)

        if smooth_scale_1D <= 0:
            bandwidth = self.getAutoBandwidth1D(bins, par, index, mult_bias_order, boundary_order) * (binmax - binmin)
            bandwidth = min(bandwidth, span / 4)
            smooth_1D = bandwidth * abs(smooth_scale_1D) / fine_width
        elif smooth_scale_1D < 1.0:
            smooth_1D = smooth_scale_1D * par.err / fine_width
        else:
            smooth_1D = smooth_scale_1D * coarse_width / fine_width
        if smooth_1D < 2:
            logging.warning("%s: fine_bins too coarse to resolve the smoothing kernel", par.name)
        smooth_1D = min(max(1.0, smooth_1D), fine_bins // 2)

        winw = min(int(round(2.5 * smooth_1D)), fine_bins // 2 - 2)
        kernel = Kernel1D(winw, smooth_1D)
        smoothed = convolve1D(bins, kernel.Win, "same")
        density1D = Density1D(np.linspace(binmin, binmax, fine_bins), P=smoothed,
                              view_ranges=[par.range_min, par.range_max])
        if par.has_limits and boundary_order >= 0:
            self._boundary_correct_1d(density1D, bins, par, kernel, winw, fine_bins, boundary_order)
        elif boundary_order == 2:
            self._interior_order2_correct_1d(density1D, bins, kernel)
        if mult_bias_order:
            self._mult_bias_correct_1d(density1D, bins, par, kernel, fine_bins, "same", mult_bias_order)
        density1D.normalize("max", in_place=True)
        if not kwargs:
            self.density1D[par.name] = density1D
        density1D.likes = None
        return density1D

    @staticmethod
    def _interior_order2_correct_1d(density1D, bins, kernel):
        """Higher-order kernel in the interior (no boundary): subtract the
        second-moment bias term in clamped log space."""
        curved = kernel.Win * kernel.x**2
        secondP = convolve1D(bins, curved, "same")
        m2 = np.sum(curved)
        m4 = np.dot(curved, kernel.x**2)
        corrected = (density1D.P * m4 - m2 * secondP) / (m4 - m2**2)
        positive = density1D.P > 0
        density1D.P[positive] *= np.exp(np.minimum(corrected[positive] / density1D.P[positive], 2) - 1)

    @staticmethod
    def _boundary_correct_1d(density1D, bins, par, kernel, winw, fine_bins, order):
        """Boundary-kernel correction in place: renormalize by the clipped
        window mass (order 0) or solve the linear/quadratic boundary-kernel
        moment system (orders 1/2); reference ``mcsamples.py:1600-1647``."""
        prior_mask = np.ones(2 * winw + fine_bins)
        if par.has_limits_bot:
            prior_mask[winw] = 0.5
            prior_mask[:winw] = 0
        if par.has_limits_top:
            prior_mask[-(winw + 1)] = 0.5
            prior_mask[-winw:] = 0

        def mask_conv(window):
            return convolve1D(prior_mask, window, "valid")

        m0 = mask_conv(kernel.Win)
        live = np.nonzero(m0 * density1D.P)
        m0 = m0[live]
        normed = density1D.P[live] / m0
        if order == 0:
            density1D.P[live] = normed
            return
        if order > 2:
            raise SettingError("boundary_correction_order supports only 0, 1 and 2")
        tilted = kernel.Win * kernel.x
        m1 = mask_conv(tilted)[live]
        m2 = mask_conv(tilted * kernel.x)[live]
        firstP = convolve1D(bins, tilted, "same")[live]
        if order == 1:
            corrected = (density1D.P[live] * m2 - firstP * m1) / (m0 * m2 - m1**2)
        else:
            m3 = mask_conv(tilted * kernel.x**2)[live]
            m4 = mask_conv(tilted * kernel.x**3)[live]
            secondP = convolve1D(bins, tilted * kernel.x, "same")[live]
            det = m4 * m2 * m0 - m4 * m1**2 - m2**3 - m3**2 * m0 + 2 * m1 * m2 * m3
            corrected = (
                density1D.P[live] * (m4 * m2 - m3**2) + firstP * (m2 * m3 - m4 * m1) + secondP * (m3 * m1 - m2**2)
            ) / det
        # clamped log-space update keeps the correction positive and bounded
        density1D.P[live] = normed * np.exp(np.minimum(corrected / normed, 4) - 1)

    @staticmethod
    def _mult_bias_correct_1d(density1D, bins, par, kernel, fine_bins, convolution_mode, order):
        """Multiplicative bias iterations in place: divide out the current
        estimate, re-smooth, multiply back (reference ``mcsamples.py:1649-1666``)."""
        edge_weight = np.ones(fine_bins)
        if par.has_limits_bot:
            edge_weight[0] *= 0.5
        if par.has_limits_top:
            edge_weight[-1] *= 0.5
        a0 = convolve1D(edge_weight, kernel.Win, "same")
        for _ in range(order):
            current = density1D.P.copy()
            current[current == 0] = 1
            resmoothed = convolve1D(bins / current, kernel.Win, convolution_mode)
            density1D.setP(density1D.P * resmoothed)
            density1D.P /= a0

    # -- 2D bandwidths ---------------------------------------------------------------------

    def _pair_correlation(self, j, j2, parx, pary):
        """(working corr, raw corr) for a pair: zeroed when negligible,
        clipped to max_corr_2D when fully degenerate."""
        if abs(self.max_corr_2D) > 1:
            raise SettingError("max_corr_2D must be below 1")
        raw = self.getCorrelationMatrix()[j2][j]
        corr = raw
        if abs(abs(corr) - 1.0) <= 1e-8:
            logging.warning("pair %s/%s is fully correlated", parx.name, pary.name)
            corr = np.sign(corr) * self.max_corr_2D
        if abs(corr) < 0.1:
            corr = 0.0
        return corr, raw

    def _degeneracy_adapted_bins(self, corr, base_fine_bins):
        """(fine_bins, coarse nbin2D): more bins along tight degeneracies
        (reference ``mcsamples.py:1812-1819``)."""
        tight = min(self.max_corr_2D, abs(corr))
        angle_scale = max(0.2, np.sqrt(1 - tight**2))
        nbin2D = int(round(self.num_bins_2D / angle_scale))
        fine_bins = base_fine_bins
        if corr:
            stretched = 192 * int(3 / angle_scale) // 3
            if base_fine_bins < stretched and int(1 / angle_scale) > 1:
                fine_bins = stretched
        return fine_bins, nbin2D

    def getAutoBandwidth2D(self, bins, parx, pary, paramx, paramy, corr, rangex, rangey, base_fine_bins_2D,
                           mult_bias_correction_order=None, min_corr=0.2, N_eff=None, sheared_result=None):
        """Bandwidth matrix (hx, hy, c) in parameter units via 2D ISJ in
        (optionally Cholesky-sheared) coordinates (reference
        ``mcsamples.py:1285-1419``). The sheared branch takes its result
        from parity mode's batched device pass (``sheared_result``)."""
        if N_eff is None:
            N_eff = min(self._get1DNeff(parx, paramx), self._get1DNeff(pary, paramy))
        plugin_width = N_eff ** (-1.0 / 6)
        clipped_corr = np.clip(corr, -self.max_corr_2D, self.max_corr_2D)
        both_limited = parx.has_limits and pary.has_limits

        def fallback_widths(ex):
            msg = f"2D kernel density bandwidth optimizer failed for {parx.name}, {pary.name}. Using fallback width: {ex}"
            if getattr(self, "raise_on_bandwidth_errors", False):
                raise BandwidthError(msg)
            logging.warning(msg)
            return parx.sigma_range * plugin_width, pary.sigma_range * plugin_width, clipped_corr

        if abs(corr) > self.max_corr_2D or (both_limited and corr > 0.8):
            # too degenerate to optimize: plug-in widths at clipped correlation
            hx, hy, c = parx.sigma_range * plugin_width, pary.sigma_range * plugin_width, clipped_corr
        elif abs(corr) > min_corr and not both_limited:
            if sheared_result is None:
                raise _not_ported("per-pair host sheared bandwidths (the host parity variant)", "A8")
            hx, hy, c = fallback_widths(sheared_result) if isinstance(sheared_result, Exception) else sheared_result
        else:
            seed_t = (min(pary.sigma_range / rangey, parx.sigma_range / rangex) * plugin_width) ** 2
            try:
                opt = kde.KernelOptimizer2D(
                    bins, N_eff, corr, do_correlation=not (parx.has_limits or pary.has_limits), fallback_t=seed_t
                )
                hx, hy, c = opt.get_h()
                hx, hy = hx * rangex, hy * rangey
            except ValueError as e:
                hx, hy, c = fallback_widths(e)
        order = self.mult_bias_correction_order if mult_bias_correction_order is None else mult_bias_correction_order
        if order:
            # higher-order estimator: widen by the N-scaling mismatch factor
            scale = 1.1 * N_eff ** (1.0 / 6 - 1.0 / (2 + 4 * (1 + order)))
            hx, hy = hx * scale, hy * scale
        return hx, hy, c

    @staticmethod
    def _parity_winw_level(w, fine):
        # pairs with small kernels shouldn't pay the widest pair's DFT
        # frame: bucket each fine-grid group by kernel window, in fixed
        # level steps; +3 headroom because the program clips kernel widths
        # at winw/2.5 while the per-pair kernel_support is what must match
        # the reference truncation.
        cap = fine // 2 - 2
        for level in (18, 34, 66, 98):
            if w + 3 <= level <= cap:
                return level
        return cap

    # -- parity mode ---------------------------------------------------------------------------

    def _parity_chain(self):
        """The chain on ``self.device`` for parity mode: f64 samples and
        weights, f32 weights for the histogram kernels, and whether every
        weight is a non-negative integer with a total below 2^31 (the
        kernels then accumulate exactly in int32). Cached until the samples
        change."""
        st = self._parity_chain_cache
        if st is None:
            w = self.weights
            st = {
                "samples": torch.from_numpy(self.samples).to(self.device),
                "weights": torch.from_numpy(w).to(self.device),
                "weights32": torch.from_numpy(w.astype(np.float32)).to(self.device),
                "integer": bool(w.size and np.all(w == np.round(w)) and w.min() >= 0 and float(w.sum()) < 2**31),
            }
            self._parity_chain_cache = st
        return st

    def _parity_pairs(self, idx, infos):
        """Each pair's corr-adaptive fine size, grouped: ({fine: [(a, b,
        corr)]}, the (a, b) positions that take getAutoBandwidth2D's
        sheared branch)."""
        pair_fine = {}
        sheared_jobs = []
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                corr, actual_corr = self._pair_correlation(idx[a], idx[b], infos[a], infos[b])
                fine, _nbin2d = self._degeneracy_adapted_bins(corr, self.fine_bins_2D)
                pair_fine.setdefault(fine, []).append((a, b, actual_corr))
                both_limited = infos[a].has_limits and infos[b].has_limits
                if 0.2 < abs(actual_corr) <= self.max_corr_2D and not both_limited:
                    sheared_jobs.append((a, b))
        return pair_fine, sheared_jobs

    def _sheared_stack(self, idx, infos, sheared_jobs, samples):
        """The index rows of the sheared branch's histograms (twin of the
        JAX package's ``_sheared_bandwidths_batch`` binning): the lead
        parameters binned with ``kde_bandwidth.bin_samples`` semantics,
        then one Cholesky-residual row per pair, on ``samples``' device.
        Returns a dict with 'ix' ((L + J, N) int32), 'pair_a' / 'pair_b'
        (lead row, residual row per pair), and the host 'metas',
        'lead_width', 'lead_rank' and 'rwidth' the optimizers need."""
        nbins = self.fine_bins_2D
        metas = []
        r00, r10, r11 = (np.empty(len(sheared_jobs)) for _ in range(3))
        lead_pos = np.empty(len(sheared_jobs), np.int64)
        other_pos = np.empty(len(sheared_jobs), np.int64)
        for i, (a, b) in enumerate(sheared_jobs):
            parx, pary = infos[a], infos[b]
            lead_par, other_loc = (pary, a) if pary.has_limits else (parx, b)
            lead_loc = b if pary.has_limits else a
            root = np.linalg.cholesky(self.getCov(pars=[idx[lead_loc], idx[other_loc]]))
            r00[i], r10[i], r11[i] = root[0, 0], root[1, 0], root[1, 1]
            lead_pos[i] = lead_loc
            other_pos[i] = other_loc
            metas.append((a, b, lead_par, lead_loc, root / root[0, 0]))
        rows, rlo, rhi = pdev.sheared_rows_minmax(samples, other_pos, lead_pos, r00, r10, r11)
        rlo, rhi = rlo.cpu().numpy(), rhi.cpu().numpy()
        pad = (rhi - rlo) * 0.1
        rmin = rlo - pad
        rwidth = (rhi + pad) - rmin
        resid_ix = pdev.bin_rows(rows, rmin, rwidth / (nbins - 1))
        del rows
        # lead binning: kde_bandwidth.bin_samples semantics, host scalars
        leads = sorted({m[3] for m in metas})
        lead_lo = np.empty(len(leads))
        lead_width = np.empty(len(leads))
        for i, k in enumerate(leads):
            par = infos[k]
            col = self.samples[:, idx[k]]
            lo_d, hi_d = float(col.min()), float(col.max())
            pad_l = (hi_d - lo_d) * 0.1
            range_min = par.range_min if par.has_limits_bot else lo_d - pad_l
            range_max = par.range_max if par.has_limits_top else hi_d + pad_l
            lead_lo[i] = range_min
            lead_width[i] = range_max - range_min
        lead_ix = pdev.bin_rows(samples[:, torch.as_tensor(leads, device=samples.device)].T, lead_lo,
                                lead_width / (nbins - 1))
        lead_rank = {k: i for i, k in enumerate(leads)}
        return {
            "ix": torch.cat([lead_ix, resid_ix], dim=0),
            "pair_a": [lead_rank[m[3]] for m in metas],
            "pair_b": list(range(len(leads), len(leads) + len(metas))),
            "metas": metas,
            "lead_width": lead_width,
            "lead_rank": lead_rank,
            "rwidth": rwidth,
        }

    def fastParityDensities(self, params=None, contours=None, device=False, materialize=True):
        """Reference-exact triangle densities: exact host ranges, N_eff
        values and bandwidth matrices feed batched 2D convolution programs
        on the chain's torch device.

        Only ``device=True`` is ported (:meth:`_parity_densities_device`):
        every O(N) pass (binning, exact pair histograms, sheared residuals,
        autocorrelation lengths, N_eff lag sums) and the 2D convolutions run
        on ``self.device``, and only compact per-pair histograms return to
        the host-exact bandwidth optimizers. With ``materialize=False`` the
        2D grids stay on the device and the return is ``(dens1, groups)``.

        :return: ({name: Density1D}, {(name_a, name_b): Density2D})
        """
        if not device:
            raise _not_ported("the host parity variant fastParityDensities(device=False)", "A8")
        return self._parity_densities_device(params, contours, materialize=materialize)

    def _parity_densities_device(self, params=None, contours=None, materialize=True):
        """Device parity mode (counterpart of the JAX package's method of
        the same name, ``mcsamples.py:1580-2108``).

        TPU workarounds of the JAX method not carried over: the uint16
        ``_compact_readback`` and the two readback threads (built for a
        slow host link; histograms are read back as f64 and the host
        optimizers run in the same order without threads), the f32
        convolution choice and the 1152 DFT-frame cap (the card runs K2/K3
        in f64 at any frame), and the environment switches (no switch is
        added).

        Stage times of the last call are kept in ``self.parity_profile``
        (seconds, in order), and its convolution buckets (fine grid, window
        half-width, pair count) in ``self.parity_buckets``. With ``materialize=False`` each group of the
        return is a dict with keys ``pairs`` (list of name tuples), ``P``
        ((K, fine, fine) device grids), ``contours`` ((K, C) device water
        levels), ``ranges`` (per-pair ((xmin, xmax), (ymin, ymax))) and
        ``fine``.
        """
        if float(self.smooth_scale_2D) >= 0 or float(self.smooth_scale_1D) >= 0:
            raise SettingError("parity mode supports the auto-bandwidth smooth_scale settings only")
        if self.use_effective_samples_2D:
            raise _not_ported("use_effective_samples_2D in parity mode", "A8")
        # the device histograms are exact only for integral, f32-representable
        # weights with bin sums below 2**24; the JAX package falls back to its
        # host pipeline for other chains, which the port does not have yet
        w_all = np.asarray(self.weights)
        if w_all.size and not (np.all(np.float32(w_all) == w_all) and np.all(w_all == np.round(w_all))):
            problem = "fractional or not f32-representable"
        elif w_all.size and w_all.min() < 0:
            problem = "negative"
        elif w_all.size and float(w_all.sum()) >= 2**24:
            problem = f"integral, but their total {float(w_all.sum()):.0f} reaches 2**24"
        else:
            problem = None
        if problem:
            raise MCSamplesError(
                "parity device mode needs integral f32-representable weights with a total below 2**24 for exact "
                f"device histograms; this chain's weights are {problem}, and the host parity variant that serves "
                "them is not ported yet (ROADMAP A8)"
            )
        if self.needs_update:
            self.updateBaseStatistics()
        idx = list(range(self.n)) if params is None else [self._parAndNumber(q)[0] for q in params]
        if any(self.paramNames.names[j].periodic for j in idx):
            raise _not_ported("parity mode with periodic parameters", "A3")
        contours = np.asarray(self.contours if contours is None else contours, float)

        profile = {}
        clock = [time.perf_counter()]

        def mark(label):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            profile[label] = now - clock[0]
            clock[0] = now

        infos = [self._initParamRanges(j) for j in idx]
        names = [info.name for info in infos]
        mark("ranges")
        st = self._parity_chain()
        dev_s64, dev_w64, dev_w32 = st["samples"], st["weights"], st["weights32"]
        mark("chain_state")

        # per-param fine ranges (the reference _binSamples convention)
        def grid_edge(par):
            pad = (par.range_max - par.range_min) * 0.1
            bmin = min(par.param_min, par.range_min) - (0 if par.has_limits_bot else pad)
            bmax = max(par.param_max, par.range_max) + (0 if par.has_limits_top else pad)
            return bmin, bmax

        edges = np.array([grid_edge(info) for info in infos])
        binmin, binmax = edges[:, 0], edges[:, 1]

        scale_2d = abs(float(self.smooth_scale_2D))
        pair_fine, sheared_jobs = self._parity_pairs(idx, infos)

        # -- device binning + exact pair histograms per fine group -----------
        sub64 = dev_s64 if idx == list(range(self.n)) else dev_s64[:, torch.as_tensor(idx, device=self.device)]
        group_hists = {}
        for fine, members in pair_fine.items():
            params_in = sorted({k for a, b, _ in members for k in (a, b)})
            local = {k: i for i, k in enumerate(params_in)}
            sel = sub64[:, torch.as_tensor(params_in, device=self.device)]
            fw = (binmax[params_in] - binmin[params_in]) / (fine - 1)
            ix = pdev.bin_indices(sel, binmin[params_in], fw)
            group_hists[fine] = pdev.group_pair_hists(
                ix,
                [local[a] for a, b, _ in members],
                [local[b] for a, b, _ in members],
                dev_w32,
                fine,
                st["integer"],
            )
            del sel, ix
        mark("device_hists")

        # -- N_eff: autocorrelation lengths and lag pair sums on the device ---
        norm = self.get_norm()
        if self._independent_draws():
            neff = np.full(len(idx), self._weight_based_neff())
        else:
            kstds, maxoffs = [], []
            need_acl = [p for p, info in enumerate(infos) if getattr(info, "N_eff_kde", None) is None]
            acl_by_pos = {}
            if need_acl:
                # the acl only sets the integer lag horizon
                # min(4 + int(1.5 acl), n//10); parameters whose horizon could
                # flip under f64 rounding take the exact host path
                means = self.getMeans()
                variances = self.getVars()
                acls, acl_safe = pdev.acl_batch(
                    dev_s64,
                    dev_w64,
                    [means[idx[p]] for p in need_acl],
                    [variances[idx[p]] for p in need_acl],
                    [idx[p] for p in need_acl],
                    self.numrows // 10 + 1,
                )
                for p, acl, ok in zip(need_acl, acls, acl_safe):
                    acl_by_pos[p] = float(acl) if ok else self.getCorrelationLength(idx[p], weight_units=False)
            for p, info in enumerate(infos):
                if getattr(info, "N_eff_kde", None) is not None:
                    kstds.append(None)  # cached; skip device work
                    maxoffs.append(0)
                    continue
                maxoffs.append(min(4 + int(1.5 * acl_by_pos[p]), self.numrows // 10))
                kstds.append(0.2 * info.sigma_range)
            todo = [p for p, k in enumerate(kstds) if k is not None]
            if todo:
                n_den = pdev.kde_neff_batch(
                    dev_s64,
                    dev_w64,
                    self.weights,
                    [kstds[p] for p in todo],
                    [maxoffs[p] for p in todo],
                    self.numrows,
                    col_ix=[idx[p] for p in todo],
                )
                for p, nd in zip(todo, n_den):
                    infos[p].N_eff_kde = norm * norm / nd
            neff = np.array([infos[p].N_eff_kde for p in range(len(idx))])
        mark("neff")

        # 1D densities on the host, reusing the N_eff cache
        dens1 = {info.name: self.get1DDensityGridData(j) for j, info in zip(idx, infos)}
        mark("1d_host")

        # -- sheared bandwidths: device residual binning + host optimizer ----
        sheared_results = {}
        if sheared_jobs:
            stack = self._sheared_stack(idx, infos, sheared_jobs, sub64)
            sh_hists = pdev.group_pair_hists(
                stack["ix"], stack["pair_a"], stack["pair_b"], dev_w32, self.fine_bins_2D, st["integer"]
            )
            sh_hists = sh_hists.to(torch.float64).cpu().numpy()
            lead_width, lead_rank, rwidth = stack["lead_width"], stack["lead_rank"], stack["rwidth"]
            for i, (a, b, lead_par, lead_loc, unshear) in enumerate(stack["metas"]):
                parx, pary = infos[a], infos[b]
                n_eff = min(neff[a], neff[b])
                try:
                    opt = kde.KernelOptimizer2D(
                        sh_hists[i], n_eff, 0, do_correlation=not (parx.has_limits or pary.has_limits)
                    )
                    h1, h2, c12 = opt.get_h()
                except ValueError as e:
                    sheared_results[(idx[a], idx[b])] = e
                    continue
                h1 *= lead_width[lead_rank[lead_loc]]
                h2 *= rwidth[i]
                kernel_cov = unshear @ np.array([[h1 * h1, h1 * h2 * c12], [h1 * h2 * c12, h2 * h2]]) @ unshear.T
                widths = np.sqrt(kernel_cov.diagonal())
                c = kernel_cov[0, 1] / (widths[0] * widths[1])
                if pary.has_limits:
                    sheared_results[(idx[a], idx[b])] = (widths[1], widths[0], c)
                else:
                    sheared_results[(idx[a], idx[b])] = (widths[0], widths[1], c)
        mark("sheared")

        # -- host-exact bandwidths + conv grouping ----------------------------
        # only getAutoBandwidth2D's final (plain optimizer) branch reads the
        # histogram: read those back
        def takes_plain_branch(actual_corr, parx, pary):
            both_limited = parx.has_limits and pary.has_limits
            if abs(actual_corr) > self.max_corr_2D or (both_limited and actual_corr > 0.8):
                return False
            return not (abs(actual_corr) > 0.2 and not both_limited)

        groups = {}
        for fine, members in pair_fine.items():
            rows_plain = [k for k, (a, b, c_ab) in enumerate(members) if takes_plain_branch(c_ab, infos[a], infos[b])]
            host = {}
            if rows_plain:
                plain = group_hists[fine][torch.as_tensor(rows_plain, device=self.device)]
                host = dict(zip(rows_plain, plain.to(torch.float64).cpu().numpy()))
            fw = (binmax - binmin) / (fine - 1)
            for k, (a, b, actual_corr) in enumerate(members):
                hx, hy, c = self.getAutoBandwidth2D(
                    host.get(k),
                    infos[a],
                    infos[b],
                    idx[a],
                    idx[b],
                    actual_corr,
                    binmax[a] - binmin[a],
                    binmax[b] - binmin[b],
                    self.fine_bins_2D,
                    mult_bias_correction_order=self.mult_bias_correction_order,
                    sheared_result=sheared_results.get((idx[a], idx[b])),
                )
                rx = hx * scale_2d / fw[a]
                ry = hy * scale_2d / fw[b]
                winw = max(1, int(round(2.5 * max(rx, ry))))
                groups.setdefault(fine, []).append((a, b, hx, hy, c, winw, k))
        mark("bandwidths")

        # -- f64 convolution programs with host-bandwidth overrides ------------
        active_lo = np.array([info.has_limits_bot for info in infos])
        active_hi = np.array([info.has_limits_top for info in infos])
        bounded = active_lo.any() or active_hi.any()
        sigma = np.array([info.sigma_range for info in infos])

        bucketed = []
        for fine, plist_all in groups.items():
            by_level = {}
            for entry in plist_all:
                by_level.setdefault(self._parity_winw_level(entry[5], fine), []).append(entry)
            bucketed.extend((fine, winw, plist) for winw, plist in by_level.items())
        self.parity_buckets = [{"fine": fine, "winw": winw, "pairs": len(plist)} for fine, winw, plist in bucketed]

        dens2 = {}
        out_groups = []
        for fine, winw, plist in bucketed:
            hists_in = group_hists[fine][torch.as_tensor([entry[6] for entry in plist], device=self.device)]
            with torch.no_grad():
                d2 = all_2d_densities(
                    sub64,
                    dev_w64,
                    np.array([entry[0] for entry in plist]),
                    np.array([entry[1] for entry in plist]),
                    neff,
                    binmin,
                    binmax,
                    contours,
                    fine_bins=fine,
                    winw=winw,
                    bandwidth_scale=None if scale_2d == 1.0 else scale_2d,
                    bandwidth_override=tuple(np.array([entry[i] for entry in plist]) for i in (2, 3, 4)),
                    kernel_support=np.array([float(entry[5]) for entry in plist]),
                    active_lo=active_lo if bounded else None,
                    active_hi=active_hi if bounded else None,
                    sigma_range=sigma,
                    max_corr=float(self.max_corr_2D),
                    enable_shear=False,  # bandwidths are host-exact overrides
                    exact_mult_bias=True,
                    hists_in=hists_in.to(torch.float64),
                )
            if not materialize:
                out_groups.append(
                    {
                        "pairs": [(names[entry[0]], names[entry[1]]) for entry in plist],
                        "P": d2["P"],
                        "contours": d2["contours"],
                        "ranges": [
                            ((binmin[entry[0]], binmax[entry[0]]), (binmin[entry[1]], binmax[entry[1]]))
                            for entry in plist
                        ],
                        "fine": fine,
                    }
                )
                continue
            grids = d2["P"].cpu().numpy()
            for k, (a, b, *_rest) in enumerate(plist):
                density = Density2D(
                    np.linspace(binmin[a], binmax[a], fine),
                    np.linspace(binmin[b], binmax[b], fine),
                    grids[k],
                    view_ranges=[(infos[a].range_min, infos[a].range_max), (infos[b].range_min, infos[b].range_max)],
                )
                # host water levels on the final grid (byte-exact convention)
                density.contours = density.getContourLevels(contours)
                density.likes = None
                dens2[(names[a], names[b])] = density
        mark("conv_dispatch" if not materialize else "conv_materialize")
        self.parity_profile = profile
        return (dens1, dens2) if materialize else (dens1, out_groups)
