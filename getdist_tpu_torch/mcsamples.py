"""MCSamples: the sample-analysis object of the port, for the fused and
parity paths.

The port's own, jax-free copy of the parts of ``getdist_tpu/mcsamples.py``
that the public fused entry (``fastTriangleDensities`` / ``fastDensities``,
with hard limits, periodic parameters, ``meanlikes`` grids, its host
rescues, and ``mesh=`` a process group) and parity mode
(``fastParityDensities``: the device variant, and the host variant that
serves any weights) run: the constructor from arrays and analysis
settings, parameter ranges, the host 1D densities (binning, ISJ bandwidth,
FFT smoothing, boundary and multiplicative bias corrections), the
host-exact 2D bandwidths, and the pipelines themselves, whose O(N) passes
(on the device, or on the host with the native pair-histogram pass of
:mod:`getdist_tpu_torch._native`) and 2D convolutions run on a torch device
(the card by default) through :mod:`getdist_tpu_torch.ops`.

Host statistics (means, covariance, correlation lengths, N_eff) are numpy,
as the JAX package's parity modes pin them (``_pin_host_stats``): the
scipy bandwidth optimizers move by up to ~1e-4 under a 1-ulp input wobble,
so their inputs are kept identical to the JAX package's wherever the
arithmetic allows.

Chains on disk load through :func:`loadMCSamples` (a chain root: its
chain files parsed by the port's native loader, ``.paramnames``,
``.ranges`` and ``.properties.ini`` sidecars, a pickle cache in the
package's cache directory) or ``MCSamples(root, ...).readChains(files)``.

The host analysis API: ``get1DDensity`` / ``get1DDensityGridData`` and
``get2DDensity`` / ``get2DDensityGridData`` (with ``meanlikes``), the
marginalized constraints (``getMargeStats``, ``getTable``, ``getLatex``,
``getInlineLatex``), the likelihood summary (``getLikeStats``) and the
convergence battery (``getConvergeTests``), with the result types of
:mod:`getdist_tpu_torch.types`. On a CUDA ``MCSamples`` at the fused path's
default settings the density queries are served from one run of the fused
program on the card (``_fused_route_enabled``); on the CPU the host path
answers, as the JAX package's CPU oracle does. ``GETDIST_TPU_TORCH_FUSED``
set to ``0`` forces the host path, and to ``1`` routes a CPU object too.

The batch command's outputs (:mod:`getdist_tpu_torch.command_line`):
``PCA``, the N-D histogram densities (``getRawNDDensity``), the covmat,
correlation, thin-data and chain writers, single and combined samples, and
the plot-script writers (the scripts import ``getdist_tpu_torch.plots``).

With ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` the host densities' histograms and
FFT convolutions (``_bincount``, ``_bincount2d``, ``_convolve1D``,
``_convolve2D``) and the chains' statistics (:mod:`getdist_tpu_torch.chains`)
run on ``self.device`` in f64; the default is host numpy. The switch does
not route the density queries onto the fused program (the JAX package's
``GETDIST_TPU_DEVICE_OPS`` does): that is the device's and
``GETDIST_TPU_TORCH_FUSED``'s choice.

A Cobaya root (``root.updated.yaml`` or ``root__full.yaml`` beside its
chain files, no ``.paramnames``) takes its names, labels, renames, ranges,
sampler, label, temperature and post-processing burn-in from the yaml
(:mod:`getdist_tpu_torch.cobaya_interface`, whose
:func:`~getdist_tpu_torch.cobaya_interface.MCSamplesFromCobaya` is
re-exported here: the samples of live Cobaya collections).
"""

import copy
import glob
import hashlib
import logging
import math
import os
import pickle
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy import stats

import getdist_tpu_torch
from getdist_tpu_torch import _native
from getdist_tpu_torch import chains, cobaya_interface, covmat
from getdist_tpu_torch import kde_bandwidth as kde
from getdist_tpu_torch import types
from getdist_tpu_torch.chains import (
    Chains,
    ParamError,
    WeightedSampleError,
    _host,
    _use_device_ops,
    chainFiles,
    last_modified,
)
from getdist_tpu_torch.cobaya_interface import MCSamplesFromCobaya
from getdist_tpu_torch.densities import Density1D, Density2D, DensityND, getContourLevels
from getdist_tpu_torch.inifile import IniFile
from getdist_tpu_torch.ops import parity_device as pdev
from getdist_tpu_torch.ops._cuda import resolve_device
from getdist_tpu_torch.ops.batched import (
    _triangle_program,
    all_1d_densities,
    all_2d_densities,
    pair_cumulant_score,
    prepare_chain,
)
from getdist_tpu_torch.ops import convolve as _convolve
from getdist_tpu_torch.ops.binning import weighted_bincount, weighted_bincount_2d
from getdist_tpu_torch.ops.pair_hist import narrow_weights
from getdist_tpu_torch.parallel.mesh import shard_samples, shard_values
from getdist_tpu_torch.paramnames import ParamInfo, ParamNames
from getdist_tpu_torch.parampriors import ParamBounds

__all__ = [
    "MCSamples",
    "MCSamplesError",
    "SettingError",
    "BandwidthError",
    "default_getdist_settings",
    "getRootFileName",
    "loadMCSamples",
    "MCSamplesFromCobaya",
]

default_getdist_settings = getdist_tpu_torch.default_getdist_settings

# the pickle cache's format: a cached object of another version is not used
pickle_version = 2
# the cache files' extension (the JAX package's are ".py_mcsamples", whose
# unpickling would import it)
CACHE_EXT = ".torch_mcsamples"


class MCSamplesError(WeightedSampleError):
    """Error raised by MCSamples operations."""


class SettingError(MCSamplesError):
    """Bad analysis settings."""


class BandwidthError(MCSamplesError):
    """KDE bandwidth determination failure."""


def loadMCSamples(file_root, ini=None, jobItem=None, no_cache=False, settings=None, chain_exclude=None,
                  device="cuda"):
    """Load samples from chain text files, with pickle caching.

    Chain files are ``file_root.txt`` or ``file_root_1.txt`` etc (or
    ``file_root.1.txt``; ``N.txt`` in a directory root ending in ``/``),
    with sidecar ``.paramnames`` / ``.ranges`` / ``.properties.ini`` files,
    or a Cobaya ``file_root.updated.yaml`` / ``file_root__full.yaml``.
    The analyzed object is cached in the package's cache directory
    (:func:`getdist_tpu_torch.make_cache_dir`), invalidated by the sources'
    modification times and the burn-in and weight-filter settings
    (reference ``mcsamples.py:47-126``).

    :param file_root: root name (no extension)
    :param ini: .ini filename or IniFile with analysis settings
    :param jobItem: optional grid jobItem (its ``batchPath`` becomes the
        object's ``batch_path``; an importance or burn-removed job keeps its rows)
    :param no_cache: delete/ignore any pickle cache
    :param settings: dict of analysis setting overrides
    :param chain_exclude: chain indices to exclude
    :param device: the torch device of the returned object's device passes
        (a cached object too, whatever device it was pickled on): the card
        unless the caller names the CPU
    """
    if chain_exclude:
        no_cache = True
    for separator in ("_", "."):
        files = chainFiles(file_root, separator=separator, chain_exclude=chain_exclude)
        if files:
            break
    cachefile = _cache_path(file_root)
    samples = MCSamples(file_root, jobItem=jobItem, ini=ini, settings=settings, device=device)
    if not no_cache:
        cached = _load_valid_cache(cachefile, _source_files(file_root, files), samples, ini, settings)
        if cached is not None:
            return cached
    if not files:
        raise OSError(f"no chain files found for root {file_root}")
    samples.readChains(files)
    if no_cache:
        if os.path.exists(cachefile):
            os.remove(cachefile)
    else:
        samples.savePickle(cachefile)
    return samples


def _cache_path(file_root):
    """Pickle-cache filename: in the package cache dir keyed by a path hash,
    or next to the chains when no cache dir is configured."""
    folder, name = os.path.split(file_root)
    cache_dir = getdist_tpu_torch.make_cache_dir()
    if cache_dir:
        name += "_" + hashlib.md5(os.path.abspath(folder).encode("utf-8")).hexdigest()[:10]
        folder = cache_dir
    if not os.path.exists(folder):
        os.mkdir(folder)
    return os.path.join(folder, name) + CACHE_EXT


def _source_files(file_root, files):
    """Chain files plus the metadata sidecars whose mtimes gate the cache:
    ``.ranges``, ``.paramnames`` and ``.properties.ini``, or a Cobaya root's
    ``updated.yaml`` / ``full.yaml``."""
    if os.path.isfile(f"{file_root}.paramnames"):
        return files + [file_root + ext for ext in (".ranges", ".paramnames", ".properties.ini")]
    folder, prefix = os.path.split(file_root)
    yamls = [
        os.path.join(folder, f)
        for f in os.listdir(folder or ".")
        if f.startswith(prefix) and f.lower().endswith(("updated.yaml", "full.yaml"))
    ]
    return files + yamls


def _load_valid_cache(cachefile, source_files, samples, ini, settings):
    """The cached analyzed object, when newer than every source and built
    with the same version/burn/weight-filter settings, on ``samples``'s
    device; else None. A contour-set change refreshes settings on the
    cached object in place."""
    if not os.path.exists(cachefile) or last_modified(source_files) >= os.path.getmtime(cachefile):
        return None
    try:
        with open(cachefile, "rb") as handle:
            cache = pickle.load(handle)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError, ImportError):
        return None  # a stale, truncated or foreign pickle: reload
    same_build = (
        isinstance(cache, MCSamples)
        and cache.version == pickle_version
        and cache.ignore_rows == samples.ignore_rows
        and cache.min_weight_ratio == samples.min_weight_ratio
    )
    if not same_build:
        return None
    cache.device = samples.device
    contours_changed = list(np.ravel(samples.contours)) != list(np.ravel(cache.contours))
    cache.updateSettings(ini=ini, settings=settings, doUpdate=contours_changed)
    return cache


# the regrid rescue's keys of an all_2d_densities result
_REGRID_KEYS = ("P", "contours", "rx", "ry", "corr", "neff")


def _regrid_entries(d2x, plist):
    """{pair: rerun result} of one rerun's all_2d_densities output, with its
    mean-likelihood grid under 'likes' when the rerun binned like weights."""
    keys = _REGRID_KEYS + (("likes",) if d2x.get("likes") is not None else ())
    return {key: {name: d2x[name][i] for name in keys} for i, key in enumerate(plist)}


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
    num_bins_ND=12,
    boundary_correction_order=1,
    mult_bias_correction_order=1,
    max_corr_2D=0.95,
    use_effective_samples_2D=False,
    max_scatter_points=2000,
    credible_interval_threshold=0.05,
    shade_likes_is_mean_loglikes=False,
    max_mult=0.0,
    mean_mult=0.0,
    plot_data_dir="",
    rootdirname="",
    indep_thin=0,
    subplot_size_inch=4.0,
    subplot_size_inch3=6.0,
    out_dir="",
    no_warning_chi2_params=True,
    max_split_tests=4,
    force_twotail=False,
    corr_length_thin=0,
    corr_length_steps=15,
    converge_test_limit=0.95,
    done_1Dbins=False,
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
                 loglikes=None, temperature=None, device="cuda", **kwargs):
        """
        :param root: file root to load from (its ``.paramnames``,
            ``.ranges`` and ``.properties.ini``, or its Cobaya yaml, are
            read here; the chain files by :meth:`readChains`, or
            :func:`loadMCSamples`)
        :param jobItem: grid jobItem (with chainRoot/batchPath)
        :param ini: .ini file (or IniFile) of analysis settings
        :param settings: dict of setting overrides
        :param ranges: dict/list of hard prior bounds per parameter; a
            triplet [min, max, True] marks a periodic parameter
        :param samples: array (or list of arrays) of sample values
        :param weights: weights array(s)
        :param loglikes: -log(posterior) array(s)
        :param device: torch device of the parity path's device passes, the
            card unless the caller names the CPU (raises without CUDA)
        :param temperature: sampling temperature (default from the
            ``.properties.ini``, or 1)
        :param kwargs: paramNamesFile/names/labels/renames/ignore_rows/
            label/name_tag/sampler passed to the inherited classes
        """
        self.device = resolve_device(device)
        super().__init__(root, jobItem=jobItem, device=self.device, **kwargs)
        self.version = pickle_version
        self.markers, self.ini = {}, ini
        self.batch_path = self.jobItem.batchPath if self.jobItem else ""
        self._readRanges()
        if ranges is not None:
            self.setRanges(ranges)
        for key, value in _BASE_ANALYSIS_SETTINGS.items():
            setattr(self, key, value)
        self.contours = np.array([0.68, 0.95])
        self.likeStats, self.no_warning_params, self.density1D = None, [], {}
        self.parity_profile, self.parity_buckets = {}, []
        self.fast_profile, self.fast_regrid_groups = {}, []
        self.plot_output = getdist_tpu_torch.default_plot_output
        self.subplot_size_inch2 = self.subplot_size_inch
        self.rootname = os.path.basename(root) if root else ""
        if "ignore_rows" in kwargs:
            settings = dict(settings or {})
            settings["ignore_rows"] = kwargs["ignore_rows"]
        self.ignore_rows = float(kwargs.get("ignore_rows") or 0)
        if not np.isclose(self.ignore_rows, 0) and self.sampler == "nested":
            raise ValueError("nested-sampler samples have no burn-in phase to remove")
        self.updateSettings(ini=ini, settings=settings)
        sidecar = root + ".properties.ini" if root else None
        if sidecar and os.path.exists(sidecar):
            self._adopt_properties_ini(root, kwargs)
        else:
            self._adopt_cobaya_properties(root, kwargs, temperature)
        if self.ignore_frac or self.ignore_rows:
            self.properties.params["burn_removed"] = True
        if samples is not None:
            self.readChains(samples, weights, loglikes)

    def _mark_burn_removed(self):
        self.ignore_frac = 0.0
        self.ignore_lines = 0

    def _adopt_properties_ini(self, root, kwargs):
        """Per-chain .properties.ini overrides the generic settings."""
        self.properties = IniFile(root + ".properties.ini")
        self._setBurnOptions(self.properties)
        if self.properties.bool("burn_removed", False):
            self._mark_burn_removed()
        if not self.label:
            self.label = self.properties.params.get("label")
        if "sampler" not in kwargs:
            self.setSampler(self.properties.string("sampler", self.sampler))

    def _adopt_cobaya_properties(self, root, kwargs, temperature):
        """Chain properties inferred from a Cobaya yaml info block, if any:
        the burn-in a post-processing run skipped, the label, the sampler
        and the temperature."""
        self.properties = IniFile()
        info = self.paramNames.info_dict if root and self.paramNames else None
        if info:
            if cobaya_interface.get_burn_removed(info):
                self.properties.params["burn_removed"] = True
                self._mark_burn_removed()
            if not self.label:
                self.label = cobaya_interface.get_sample_label(info)
                if self.label:
                    self.properties.params["label"] = self.label
            if "sampler" not in kwargs:
                self.setSampler(cobaya_interface.get_sampler_type(info))
            self.properties.params["sampler"] = self.sampler
            if temperature is None:
                temperature = cobaya_interface.get_sampler_temperature(info)
        if temperature not in (None, 1):
            self.properties.params["temperature"] = temperature

    def _readRanges(self):
        """Bounds from the root's ``.ranges`` sidecar, else its Cobaya yaml."""
        if self.root:
            sidecar = self.root + ".ranges"
            if os.path.isfile(sidecar):
                self.ranges = ParamBounds(sidecar)
                return
            yaml_info = cobaya_interface.cobaya_params_file(self.root)
            if yaml_info:
                self.ranges = ParamBounds(yaml_info)
                return
        self.ranges = ParamBounds()

    # -- settings and chains ------------------------------------------------------------

    def readChains(self, files_or_samples, weights=None, loglikes=None):
        """Load samples (chain files or arrays), remove burn-in, delete
        fixed parameters, and combine into a single samples array."""
        self.loadChains(self.root, files_or_samples, weights=weights, loglikes=loglikes)
        grid_item = self.jobItem
        grid_handled = grid_item is not None and hasattr(grid_item, "isImportanceJob") and (
            grid_item.isImportanceJob or grid_item.isBurnRemoved()
        )
        if self.ignore_frac and not grid_handled:
            self.removeBurnFraction(self.ignore_frac)
            chains.print_load_line(f"Removed {self.ignore_frac} as burn in")
        elif not int(self.ignore_rows):
            chains.print_load_line("Removed no burn in")
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
        self._setBurnOptions(ini)
        for name in ("range_ND_contour", "range_confidence", "num_bins", "fine_bins", "num_bins_2D", "fine_bins_2D",
                     "smooth_scale_1D", "smooth_scale_2D"):
            ini.setAttr(name, self)
        for name, default in (("boundary_correction_order", 1), ("mult_bias_correction_order", 1)):
            ini.setAttr(name, self, default)
        for name in ("num_bins_ND", "max_scatter_points", "credible_interval_threshold", "subplot_size_inch",
                     "subplot_size_inch2", "subplot_size_inch3", "plot_output", "force_twotail"):
            ini.setAttr(name, self)
        if self.force_twotail:
            logging.warning("force_twotail set: all limits treated as two-tail")
        ini.setAttr("max_corr_2D", self)
        if ini.hasKey("contours"):
            ini.setAttr("contours", self)
        elif ini.hasKey("num_contours"):
            n_levels = ini.int("num_contours", 2)
            self.contours = np.array([ini.float("contour" + str(i + 1)) for i in range(n_levels)])
        # threshold for the edge bin to allow two-tail limits
        self.max_frac_twotail = []
        for i, level in enumerate(self.contours):
            gauss_edge = np.exp(-1.0 * math.pow(stats.norm.ppf((1 - level) / 2), 2) / 2)
            self.max_frac_twotail.append(ini.float("max_frac_twotail" + str(i + 1), gauss_edge) if ini else gauss_edge)
        ini.setAttr("converge_test_limit", self, self.contours[-1])
        for name in ("corr_length_thin", "corr_length_steps"):
            ini.setAttr(name, self)
        for name, default in (("no_warning_params", []), ("no_warning_chi2_params", True)):
            ini.setAttr(name, self, default)
        self.batch_path = ini.string("batch_path", default=self.batch_path, allowEmpty=False)

    def _setBurnOptions(self, ini):
        ini.setAttr("ignore_rows", self)
        self.ignore_lines = int(self.ignore_rows)
        self.ignore_frac = self.ignore_rows if not self.ignore_lines else 0
        ini.setAttr("min_weight_ratio", self)

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
        self.markers = {}
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
            marker_key = "marker[%s]" % par.name
            if ini and marker_key in ini.params:
                spec = ini.string(marker_key)
                if spec:
                    self.markers[par.name] = float(spec)

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
        self.indep_thin = 0
        self.done_1Dbins = False
        self.density1D = dict()
        self._fused_cache = None
        self._param_range_cache = {}
        self._initLimits(self.ini)
        for par in self.paramNames.names:
            par.N_eff_kde = None
        self._setLikeStats()
        return self

    def _setLikeStats(self):
        """Compute and store the LikeStats summary: best-fit sample,
        likelihood moments, and per-parameter ND confidence region from
        sorting by -log(like) (reference ``mcsamples.py:2237-2278``)."""
        logl = self.loglikes
        if logl is None:
            self.likeStats = None
            return None
        stats = types.LikeStats()
        bestfit_ix = np.argmin(logl)
        maxlike = logl[bestfit_ix]
        stats.logLike_sample = maxlike
        spread_ok = np.max(logl) - maxlike < 30
        stats.logMeanInvLike = np.log(self.mean(np.exp(logl - maxlike))) + maxlike if spread_ok else None
        stats.meanLogLike = self.mean_loglike
        stats.logMeanLike = -np.log(self.mean(np.exp(-(logl - maxlike)))) + maxlike
        stats.complexity = 2 * (self.mean_loglike - maxlike)
        stats.varLogLike = self.mean(logl**2) - self.mean_loglike**2
        stats.names = self.paramNames.names

        # ND confidence regions: take the best-likelihood mass up to each contour
        by_like = logl.argsort()
        mass = np.cumsum(self.weights[by_like])
        ncontours = len(self.contours)
        cutoffs = np.searchsorted(mass, self.norm * self.contours[0:ncontours])
        for j, info in enumerate(self.paramNames.names):
            info.ND_limit_bot = np.empty(ncontours)
            info.ND_limit_top = np.empty(ncontours)
            for i, cut in enumerate(cutoffs):
                region = self.samples[by_like[:cut], j]
                info.ND_limit_bot[i] = np.min(region)
                info.ND_limit_top[i] = np.max(region)
            info.bestfit_sample = self.samples[bestfit_ix, j]
        self.likeStats = stats
        return stats

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
        if self.range_ND_contour >= 0 and self.likeStats:
            if self.range_ND_contour >= par.ND_limit_bot.size:
                raise SettingError("range_ND_contour must be -1 (disabled) or a valid contour-level index")
            nd_lo = par.ND_limit_bot[self.range_ND_contour]
            nd_hi = par.ND_limit_top[self.range_ND_contour]
            par.range_min = min(max(par.range_min - par.err, nd_lo), par.range_min)
            par.range_max = max(max(par.range_max + par.err, nd_hi), par.range_max)
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

    # -- histograms and convolutions: host numpy, or the device route ----------------------

    def _bincount(self, ix, weights, nbins):
        """Weighted histogram of bin indices: ``np.bincount``, or with
        ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` a scatter-add on ``self.device``
        (equal bit for bit where the weights are integers)."""
        if _use_device_ops():
            return _host(weighted_bincount(self._upload(ix), self._upload(np.asarray(weights, float)), nbins))
        return np.bincount(np.asarray(ix), weights=np.asarray(weights), minlength=nbins)

    def _bincount2d(self, ixs, iys, weights, xsize, ysize):
        """Weighted 2D histogram, (ysize, xsize) with rows y; the device
        route as :meth:`_bincount`."""
        if _use_device_ops():
            return _host(weighted_bincount_2d(self._upload(ixs), self._upload(iys),
                                              self._upload(np.asarray(weights, float)), xsize, ysize))
        flat = np.bincount(np.asarray(iys) * xsize + np.asarray(ixs), weights=np.asarray(weights),
                           minlength=xsize * ysize)
        return flat.reshape((ysize, xsize))

    def _convolve1D(self, x, y, mode, largest_size=0):
        """1D FFT convolution of the host densities: numpy, or with
        ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` ``torch.fft`` on ``self.device``."""
        if _use_device_ops():
            return _host(_convolve.convolve1D(self._upload(np.asarray(x, float)), self._upload(np.asarray(y, float)),
                                              mode, largest_size=largest_size))
        return _convolve.convolve1D_host(x, y, mode, largest_size=largest_size)

    def _convolve2D(self, x, y, mode, largest_size=0):
        """2D FFT convolution of the host densities, routed as
        :meth:`_convolve1D`."""
        if _use_device_ops():
            return _host(_convolve.convolve2D(self._upload(np.asarray(x, float)), self._upload(np.asarray(y, float)),
                                              mode, largest_size=largest_size))
        return _convolve.convolve2D_host(x, y, mode, largest_size=largest_size)

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

    def get1DDensityGridData(self, j, paramConfid=None, meanlikes=False, **kwargs):
        """The marginalized 1D KDE density of a parameter (reference
        ``mcsamples.py:1517-1686``): fine binning -> auto ISJ bandwidth ->
        FFT convolution -> boundary kernel correction -> multiplicative bias
        iterations -> peak-normalized Density1D, on the host; with
        ``meanlikes`` (needs loglikes) its ``likes`` hold the mean-likelihood
        curve. With no setting overrides and the fused route on
        (:meth:`_fused_route_enabled`) it is served from the fused
        program's run (:meth:`_fused_1d_lookup`)."""
        if self.needs_update:
            self.updateBaseStatistics()
        if not kwargs and self._fused_route_enabled() and (not meanlikes or self.loglikes is not None):
            density = self._fused_1d_lookup(j, paramConfid, meanlikes=meanlikes)
            if density is not None:
                return density
        return self._host_1d_density(j, paramConfid, meanlikes, **kwargs)

    def _host_1d_density(self, j, paramConfid=None, meanlikes=False, **kwargs):
        """The host path of :meth:`get1DDensityGridData` (the byte-exact
        oracle of the reference's conventions)."""
        index = self._parAndNumber(j)[0]
        if index is None:
            return None
        par = self._initParamRanges(index, paramConfid)
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
        bins = self._bincount(bin_indices, self.weights, fine_bins)
        finebinlikes = self._fine_like_bins(bin_indices, fine_bins) if meanlikes else None

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

        # a periodic parameter's grid ends are one point: its support is a
        # bin shorter, and it smooths circularly
        support = (fine_bins - 1) if par.periodic else fine_bins
        winw = min(int(round(2.5 * smooth_1D)), support // 2 - 2)
        kernel = Kernel1D(winw, smooth_1D)
        conv_mode = "periodic" if par.periodic else "same"
        smoothed = self._convolve1D(bins, kernel.Win, conv_mode)
        density1D = Density1D(np.linspace(binmin, binmax, fine_bins), P=smoothed,
                              view_ranges=[par.range_min, par.range_max])
        uncorrected = smoothed.copy() if meanlikes else None
        if par.has_limits and not par.periodic and boundary_order >= 0:
            self._boundary_correct_1d(density1D, bins, par, kernel, winw, fine_bins, boundary_order)
        elif not par.periodic and boundary_order == 2:
            self._interior_order2_correct_1d(density1D, bins, kernel)
        if mult_bias_order:
            self._mult_bias_correct_1d(density1D, bins, par, kernel, fine_bins, conv_mode, mult_bias_order)
        density1D.normalize("max", in_place=True)
        if not kwargs:
            self.density1D[par.name] = density1D
        if meanlikes:
            density1D.likes = self._mean_likes_1d(density1D, finebinlikes, kernel, conv_mode, uncorrected)
        else:
            density1D.likes = None
        return density1D

    def _fine_like_bins(self, bin_indices, fine_bins):
        """Likelihood-weighted fine histogram for mean-like shading."""
        if self.shade_likes_is_mean_loglikes:
            w = self.weights * self.loglikes
        else:
            w = self._likelihood_weights()
        return self._bincount(bin_indices, w, fine_bins)

    def _mean_likes_1d(self, density1D, finebinlikes, kernel, conv_mode, uncorrected):
        """Smoothed mean-likelihood curve aligned with the corrected density."""
        live = density1D.P > 0
        finebinlikes[live] /= density1D.P[live]
        binlikes = self._convolve1D(finebinlikes, kernel.Win, conv_mode)
        binlikes[live] *= density1D.P[live] / uncorrected[live]
        if self.shade_likes_is_mean_loglikes:
            floor = np.min(binlikes)
            binlikes = np.where((binlikes - floor) < 30, np.exp(-(binlikes - floor)), 0)
            binlikes[uncorrected == 0] = 0
        binlikes /= np.max(binlikes)
        return binlikes

    def get1DDensity(self, name, **kwargs):
        """Cached Density1D for a named parameter."""
        if self.needs_update:
            self.updateBaseStatistics()
        if not kwargs:
            density = self.density1D.get(name)
            if density is not None:
                return density
        return self.get1DDensityGridData(name, **kwargs)

    def _interior_order2_correct_1d(self, density1D, bins, kernel):
        """Higher-order kernel in the interior (no boundary): subtract the
        second-moment bias term in clamped log space."""
        curved = kernel.Win * kernel.x**2
        secondP = self._convolve1D(bins, curved, "same")
        m2 = np.sum(curved)
        m4 = np.dot(curved, kernel.x**2)
        corrected = (density1D.P * m4 - m2 * secondP) / (m4 - m2**2)
        positive = density1D.P > 0
        density1D.P[positive] *= np.exp(np.minimum(corrected[positive] / density1D.P[positive], 2) - 1)

    def _boundary_correct_1d(self, density1D, bins, par, kernel, winw, fine_bins, order):
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
            return self._convolve1D(prior_mask, window, "valid")

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
        firstP = self._convolve1D(bins, tilted, "same")[live]
        if order == 1:
            corrected = (density1D.P[live] * m2 - firstP * m1) / (m0 * m2 - m1**2)
        else:
            m3 = mask_conv(tilted * kernel.x**2)[live]
            m4 = mask_conv(tilted * kernel.x**3)[live]
            secondP = self._convolve1D(bins, tilted * kernel.x, "same")[live]
            det = m4 * m2 * m0 - m4 * m1**2 - m2**3 - m3**2 * m0 + 2 * m1 * m2 * m3
            corrected = (
                density1D.P[live] * (m4 * m2 - m3**2) + firstP * (m2 * m3 - m4 * m1) + secondP * (m3 * m1 - m2**2)
            ) / det
        # clamped log-space update keeps the correction positive and bounded
        density1D.P[live] = normed * np.exp(np.minimum(corrected / normed, 4) - 1)

    def _mult_bias_correct_1d(self, density1D, bins, par, kernel, fine_bins, convolution_mode, order):
        """Multiplicative bias iterations in place: divide out the current
        estimate, re-smooth, multiply back (reference ``mcsamples.py:1649-1666``);
        a periodic parameter has no edges to divide out."""
        if not par.periodic:
            edge_weight = np.ones(fine_bins)
            if par.has_limits_bot:
                edge_weight[0] *= 0.5
            if par.has_limits_top:
                edge_weight[-1] *= 0.5
            a0 = self._convolve1D(edge_weight, kernel.Win, "same")
        for _ in range(order):
            current = density1D.P.copy()
            current[current == 0] = 1
            resmoothed = self._convolve1D(bins / current, kernel.Win, convolution_mode)
            density1D.setP(density1D.P * resmoothed)
            if not par.periodic:
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

    def _make2Dhist(self, ixs, iys, xsize, ysize):
        """(weighted (ysize, xsize) histogram, rows = y, and the flat
        indices) of host bin indices (:meth:`_bincount2d`)."""
        flatix = ixs + iys * xsize
        return self._bincount2d(ixs, iys, self.weights, xsize, ysize), flatix

    # -- host 2D densities ------------------------------------------------------------------

    @staticmethod
    def _anisotropic_window(rx, ry, corr, winw):
        """Normalized 2D Gaussian window with covariance [[ry^2, rxy],
        [rxy, rx^2]] over a (2 winw+1)^2 stencil."""
        precision = np.linalg.inv(np.array([[ry**2, rx * ry * corr], [rx * ry * corr, rx**2]]))
        gy, gx = np.mgrid[-winw : winw + 1, -winw : winw + 1]
        quad = gy**2 * precision[0, 0] + gx**2 * precision[1, 1] + 2 * precision[1, 0] * gy * gx
        window = np.exp(-quad / 2)
        return window / np.sum(window)

    @staticmethod
    def _conv_mode_2d(parx, pary):
        if parx.periodic:
            return "periodic_both" if pary.periodic else "periodic_x"
        return "periodic_y" if pary.periodic else "same"

    def _meanlikes_fine_2d(self, flatix, xsize, ysize):
        return self._bincount(flatix, self._likelihood_weights(), xsize * ysize).reshape((ysize, xsize))

    def _meanlikes_smooth_2d(self, finebinlikes, bins2D, Win, mode, convolvesize, mult_bias_order):
        """Smoothed mean-likelihood surface, de-biased like the density and
        divided by it where it carries weight."""
        smoothed = self._convolve2D(finebinlikes, Win, mode, largest_size=convolvesize)
        if mult_bias_order:
            carried = smoothed > 0
            finebinlikes[carried] /= smoothed[carried]
            second = self._convolve2D(finebinlikes, Win, mode, largest_size=convolvesize)
            second[carried] *= smoothed[carried]
            smoothed = second
        floor = 1e-4 * np.max(bins2D)
        smoothed[bins2D > floor] /= bins2D[bins2D > floor]
        smoothed[bins2D <= floor] = 0
        return smoothed

    def get2DDensityGridData(
        self, j, j2, num_plot_contours=None, get_density=False, meanlikes=False, mask_function: callable = None,
        **kwargs
    ):
        """Compute the marginalized 2D KDE density for a parameter pair.

        Full reference pipeline (``mcsamples.py:1748-2010``), on the host:
        corr-adaptive fine binning -> anisotropic auto bandwidth matrix (with
        Cholesky shearing for correlated pairs) -> 2D FFT convolution
        (periodic modes per axis) -> linear boundary kernel -> multiplicative
        bias iterations -> optional mask -> contour levels. With no setting
        overrides or mask and the fused route on
        (:meth:`_fused_route_enabled`) it is served from the fused program's
        run (:meth:`_fused_2d_lookup`).
        """
        if self.needs_update:
            self.updateBaseStatistics()
        if not kwargs and mask_function is None and self._fused_route_enabled():
            if not meanlikes or self.loglikes is not None:
                density = self._fused_2d_lookup(j, j2, num_plot_contours, meanlikes=meanlikes)
                if density is not None:
                    return density
        stopwatch = time.time()
        j, parx = self._parAndNumber(j)
        j2, pary = self._parAndNumber(j2)
        if None in (j, j2):
            return None
        for axis_index in (j, j2):
            self._initParamRanges(axis_index)

        pick = lambda name: kwargs.get(name, getattr(self, name))  # noqa: E731
        base_fine_bins_2D = pick("fine_bins_2D")
        boundary_order = pick("boundary_correction_order")
        mult_bias_order = pick("mult_bias_correction_order")
        smooth_scale_2D = float(pick("smooth_scale_2D"))
        has_prior = bool(parx.has_limits or pary.has_limits or mask_function)

        corr, actual_corr = self._pair_correlation(j, j2, parx, pary)
        fine_bins_2D, nbin2D = self._degeneracy_adapted_bins(corr, base_fine_bins_2D)
        xsize = ysize = fine_bins_2D

        ixs, step_x, x_lo, x_hi = self._binSamples(self.samples[:, j], parx, fine_bins_2D)
        iys, step_y, y_lo, y_hi = self._binSamples(self.samples[:, j2], pary, fine_bins_2D)
        pair_hist, flat_cells = self._make2Dhist(ixs, iys, xsize, ysize)
        finebinlikes = self._meanlikes_fine_2d(flat_cells, xsize, ysize) if meanlikes else None

        # rx/ry are kernel widths in fine-bin units
        if smooth_scale_2D < 0:
            hx, hy, corr = self.getAutoBandwidth2D(
                pair_hist, parx, pary, j, j2, actual_corr, x_hi - x_lo, y_hi - y_lo,
                base_fine_bins_2D, mult_bias_correction_order=mult_bias_order,
            )
            rx = hx * abs(smooth_scale_2D) / step_x
            ry = hy * abs(smooth_scale_2D) / step_y
        elif smooth_scale_2D < 1.0:
            rx = smooth_scale_2D * parx.err / step_x
            ry = smooth_scale_2D * pary.err / step_y
        else:
            rx = ry = smooth_scale_2D * fine_bins_2D / nbin2D

        widest = float(max(rx, ry))
        logging.debug("kernel corr %s, fine-bin widths %s x %s", corr, rx, ry)
        if widest < 2:
            logging.warning("%s/%s: fine_bins_2D too coarse for the optimal 2D kernel", parx.name, pary.name)
        winw = max(1, int(round(2.5 * widest)))
        Win = self._anisotropic_window(rx, ry, corr, winw)

        logging.debug("2D binning+bandwidth took %s s at %s bins", time.time() - stopwatch, fine_bins_2D)
        stopwatch = time.time()
        convolvesize = xsize + 2 * winw + Win.shape[0]  # oversized for fast fft padding choice
        conv_mode = self._conv_mode_2d(parx, pary)
        surface = self._convolve2D(pair_hist, Win, conv_mode, largest_size=convolvesize)

        like_surface = None
        if meanlikes:
            like_surface = self._meanlikes_smooth_2d(finebinlikes, surface, Win, conv_mode, convolvesize, mult_bias_order)
            del finebinlikes

        need_mask = has_prior and boundary_order >= 0 or mult_bias_order or mask_function
        prior_mask = masked_out = None
        if need_mask:
            # pad by winw so 'valid' convolutions return (ysize, xsize)
            prior_mask = np.ones((2 * winw + ysize, 2 * winw + xsize))
            if mask_function:
                mask_function(
                    x_lo - winw * step_x, y_lo - winw * step_y, step_x, step_y, prior_mask
                )
                masked_out = prior_mask[winw:-winw, winw:-winw] < 1e-8

        fully_periodic = parx.periodic and pary.periodic
        if has_prior and boundary_order >= 0 and not fully_periodic:
            self._setEdgeMask2D(parx, pary, prior_mask, winw)
            self._boundary_correct_2d(surface, pair_hist, prior_mask, Win, winw, boundary_order, conv_mode, convolvesize)

        if mult_bias_order and not fully_periodic:
            self._setAllEdgeMask2D(
                prior_mask, winw, periodic_x=parx.periodic, periodic_y=pary.periodic
            )
            self._mult_bias_correct_2d(
                surface, pair_hist, prior_mask, Win, conv_mode, convolvesize, mult_bias_order, masked_out
            )

        if mask_function:
            surface[masked_out] = 0

        views = [(parx.range_min, parx.range_max), (pary.range_min, pary.range_max)]
        density = Density2D(
            np.linspace(x_lo, x_hi, xsize),
            np.linspace(y_lo, y_hi, ysize),
            surface,
            mask=None if not mask_function else np.asarray(masked_out),
            view_ranges=views,
        )
        density.normalize("max", in_place=True)
        if get_density:
            return density

        ncontours = len(self.contours)
        if num_plot_contours:
            ncontours = min(int(num_plot_contours), ncontours)
        logging.debug("2D convolutions took %s s", time.time() - stopwatch)
        density.contours = density.getContourLevels(self.contours[:ncontours])
        if meanlikes:
            like_surface /= np.max(like_surface)
        density.likes = like_surface
        return density

    def _mult_bias_correct_2d(self, surface, pair_hist, prior_mask, Win, conv_mode, convolvesize, order, masked_out):
        """Multiplicative bias iterations in place: divide out the current
        estimate, re-smooth, multiply back (reference ``mcsamples.py:1921-1944``)."""
        mask_mass = self._convolve2D(prior_mask, Win, "valid", largest_size=convolvesize)
        for _ in range(order):
            flattened = pair_hist.copy()
            significant = surface > np.max(surface) * 1e-8
            flattened[significant] /= surface[significant]
            surface *= self._convolve2D(flattened, Win, conv_mode, largest_size=convolvesize)
            if masked_out is not None:
                surface[~masked_out] /= mask_mass[~masked_out]
            else:
                surface /= mask_mass

    def get2DDensity(self, x, y, normalized=False, **kwargs):
        """Density2D for a pair of parameters (max-normalized by default)."""
        if self.needs_update:
            self.updateBaseStatistics()
        density = self.get2DDensityGridData(x, y, get_density=True, **kwargs)
        if normalized:
            density.normalize(in_place=True)
        return density

    def _getScaleForParam(self, par):
        # Half-width-at-50% based scale; also primes the 1D density cache.
        density = self.get1DDensity(par)
        mn, mx, bot_hit, top_hit = density.getLimits(0.5, accuracy_factor=1)
        if bot_hit or top_hit:
            return (mx - mn) / 0.675
        return (mx - mn) / (2 * 0.675)

    def _boundary_correct_2d(self, bins2D, histbins, prior_mask, Win, winw, order, mode, convolvesize):
        """Boundary-kernel correction in place: renormalize by the clipped
        window mass (order 0), or solve the 2D linear boundary-kernel system
        (order 1, Jones 1993 family) wherever the mask convolution carries
        weight (reference ``mcsamples.py:1921-1961``)."""

        def mask_conv(window):
            return self._convolve2D(prior_mask, window, "valid", largest_size=convolvesize)

        a00 = mask_conv(Win)
        live = a00 * bins2D > np.max(bins2D) * 1e-8
        a00 = a00[live]
        normed = bins2D[live] / a00
        if order == 0:
            bins2D[live] = normed
            return
        if order != 1:
            raise SettingError("2D boundary_correction_order supports only 0 and 1")
        # window moments against the mask: m[jk] pairs x-power j with y-power k
        dx = np.arange(-winw, winw + 1)[None, :]
        dy = dx.reshape(-1, 1)
        tilted_x, tilted_y = Win * dx, Win * dy
        m = {
            jk: mask_conv(w)[live]
            for jk, w in (
                ("10", tilted_x), ("01", tilted_y),
                ("20", tilted_x * dx), ("02", tilted_y * dy), ("11", tilted_y * dx),
            )
        }
        m00, m10, m01 = a00, m["10"], m["01"]
        m20, m02, m11 = m["20"], m["02"], m["11"]
        firstP_x = self._convolve2D(histbins, tilted_x, mode, largest_size=convolvesize)[live]
        firstP_y = self._convolve2D(histbins, tilted_y, mode, largest_size=convolvesize)[live]
        det = m20 * m01**2 + m10**2 * m02 - m00 * m02 * m20 + m11**2 * m00 - 2 * m01 * m10 * m11
        corrected = (
            bins2D[live] * (m11**2 - m02 * m20)
            + firstP_x * (m10 * m02 - m01 * m11)
            + firstP_y * (m01 * m20 - m10 * m11)
        ) / det
        # clamped log-space update keeps the correction positive and bounded
        bins2D[live] = normed * np.exp(np.minimum(corrected / normed, 4) - 1)

    def _setAllEdgeMask2D(self, prior_mask, winw, periodic_x=False, periodic_y=False):
        if not periodic_x:
            prior_mask[:, :winw] = 0
            prior_mask[:, -winw:] = 0
        if not periodic_y:
            prior_mask[:winw:] = 0
            prior_mask[-winw:, :] = 0

    def _setEdgeMask2D(self, parx, pary, prior_mask, winw):
        # Edge masks only on non-periodic axes (periodic axes have no edges).
        col = np.s_[:]
        specs = (
            (parx, (col, winw), (col, np.s_[:winw]), (col, -(winw + 1)), (col, np.s_[-winw:])),
            (pary, (winw, col), np.s_[:winw:], (-(winw + 1), col), (np.s_[-winw:], col)),
        )
        for par, bot_edge, bot_zero, top_edge, top_zero in specs:
            if par.periodic:
                continue
            if par.has_limits_bot:
                prior_mask[bot_edge] /= 2
                prior_mask[bot_zero] = 0
            if par.has_limits_top:
                prior_mask[top_edge] /= 2
                prior_mask[top_zero] = 0

    def _optimize_bandwidth_sheared(self, parx, pary, paramx, paramy, N_eff, nbins):
        """2D bandwidth for a correlated pair, in f64 on the host: shear the
        samples so the pair decorrelates (keeping a bounded axis untouched as
        the first coordinate), optimize an axis-aligned kernel on the sheared
        histogram, and map the kernel covariance back through the shear
        (reference ``mcsamples.py:1347-1391``). One pair of
        :meth:`_sheared_bandwidths_batch`; raises its ``ValueError``."""
        result = self._sheared_bandwidths_batch([(parx, pary, paramx, paramy, N_eff)], nbins)[(paramx, paramy)]
        if isinstance(result, ValueError):
            raise result
        return result

    def getAutoBandwidth2D(self, bins, parx, pary, paramx, paramy, corr, rangex, rangey, base_fine_bins_2D,
                           mult_bias_correction_order=None, min_corr=0.2, N_eff=None, use_2D_Neff=False,
                           sheared_result=None):
        """Bandwidth matrix (hx, hy, c) in parameter units via 2D ISJ in
        (optionally Cholesky-sheared) coordinates (reference
        ``mcsamples.py:1285-1419``). The sheared branch takes its result
        from parity mode's batched pass (``sheared_result``), or computes
        it for this pair on the host (:meth:`_optimize_bandwidth_sheared`).
        Without ``N_eff`` the pair's is the smaller 1D one; ``use_2D_Neff``
        (None: the ``use_effective_samples_2D`` setting) asks for the 2D
        estimate (:meth:`getEffectiveSamplesGaussianKDE_2d`) instead."""
        if N_eff is None:
            want_2d = use_2D_Neff if use_2D_Neff is not None else self.use_effective_samples_2D
            if want_2d and abs(corr) < 0.999:
                N_eff = self.getEffectiveSamplesGaussianKDE_2d(paramx, paramy)
            else:
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
            if sheared_result is not None:
                hx, hy, c = fallback_widths(sheared_result) if isinstance(sheared_result, Exception) \
                    else sheared_result
            else:
                try:
                    hx, hy, c = self._optimize_bandwidth_sheared(parx, pary, paramx, paramy, N_eff, base_fine_bins_2D)
                except ValueError as e:
                    hx, hy, c = fallback_widths(e)
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

    # -- marginalized statistics and tables ---------------------------------------------------

    def getParamSampleDict(self, ix, want_derived=True, want_fixed=True):
        """Dict of parameter values for one sample row (incl. fixed)."""
        row = super().getParamSampleDict(ix, want_derived=want_derived)
        if want_fixed:
            row.update(self.ranges.fixedValueDict())
        return row

    def getParamBestFitDict(self, best_sample=False, want_derived=True, want_fixed=True, max_posterior=True):
        """Dict of parameter values at the best-fit point (from minimum
        files, or the best sample)."""
        if best_sample:
            if not max_posterior:
                raise ValueError("best_sample=True implies max_posterior=True")
            if self.loglikes is None:
                raise ValueError("samples carry no likelihood values")
            best_row = int(np.argmin(self.loglikes))
            return self.getParamSampleDict(best_row)
        best = self.getBestFit(max_posterior=max_posterior).getParamDict(include_derived=want_derived)
        if want_fixed:
            best.update(self.ranges.fixedValueDict())
        return best

    def addDerived(self, paramVec, name, label="", comment="", range=None):
        """Add a derived parameter column (optionally with hard bounds)."""
        if range is not None:
            self.ranges.setRange(name, range)
        return super().addDerived(paramVec, name, label=label, comment=comment)

    def getNumSampleSummaryText(self):
        """Text summary of sample counts and effective sample sizes."""
        out = [
            f"using {self.numrows} rows, {self.paramNames.numParams()} parameters; "
            f"mean weight {self.mean_mult}, tot weight {self.norm}\n"
        ]
        if self.indep_thin != 0:
            out.append("Approx indep samples (N/corr length): %s\n" % round(self.norm / self.indep_thin))
        out.append("Equiv number of single samples (sum w)/max(w): %s\n" % round(self.norm / self.max_mult))
        n_eff_w = int(self.norm**2 / np.dot(self.weights, self.weights))
        out.append("Effective number of weighted samples (sum w)^2/sum(w^2): %s\n" % n_eff_w)
        return "".join(out)

    def _setMargeLimits(self, par, paramConfid, max_frac_twotail=None, density1D=None):
        """Set par.limits: one- or two-tail depending on whether the
        density is cut off at the prior edges (reference
        ``mcsamples.py:2460-2531``)."""
        if max_frac_twotail is None:
            max_frac_twotail = self.max_frac_twotail
        par.limits = []
        if density1D is None:
            density1D = self.get1DDensity(par.name)
        interpGrid = None
        for level, contour in enumerate(self.contours):
            # a tail counts as prior-cut when the density at that edge is
            # still significant relative to the peak
            edge_frac = max_frac_twotail[level]
            force = self.force_twotail
            cut_bot = par.has_limits_bot and not force and density1D.P[0] > edge_frac
            cut_top = par.has_limits_top and not force and density1D.P[-1] > edge_frac

            if cut_bot and cut_top:
                window = [par.range_min, par.range_max]
            else:
                if not interpGrid:
                    interpGrid = density1D.initLimitGrids()
                lo, hi, cut_bot, cut_top = density1D.getLimits(contour, interpGrid)
                limfrac = 1 - contour
                eq_lo = eq_hi = None
                if cut_bot:
                    lo = par.range_min
                elif cut_top:
                    lo = self.confidence(paramConfid, limfrac, upper=False)
                else:
                    eq_lo = self.confidence(paramConfid, limfrac / 2, upper=False)
                if cut_top:
                    hi = par.range_max
                elif cut_bot:
                    hi = self.confidence(paramConfid, limfrac, upper=True)
                else:
                    eq_hi = self.confidence(paramConfid, limfrac / 2, upper=True)
                if not cut_bot and not cut_top:
                    # prefer equal-tail limits when the densities at the two
                    # tails are similar
                    if math.fabs(density1D.Prob(eq_hi) - density1D.Prob(eq_lo)) < self.credible_interval_threshold:
                        lo, hi = eq_lo, eq_hi
                window = [lo, hi]

            tag = {(True, True): "none", (True, False): ">", (False, True): "<"}.get((cut_bot, cut_top), "two")
            par.limits.append(types.ParamLimit(window, tag))

    def _setDensitiesandMarge1D(self, max_frac_twotail=None, meanlikes=False):
        """Compute (and cache) all 1D densities and marginalized limits."""
        if self.done_1Dbins:
            return
        for j, info in enumerate(self.paramNames.names):
            confid = self.initParamConfidenceData(self.samples[:, j])
            self.get1DDensityGridData(j, paramConfid=confid, meanlikes=meanlikes)
            self._setMargeLimits(info, confid, max_frac_twotail)
        self.done_1Dbins = True

    def getInlineLatex(self, param, limit=1, err_sig_figs=None):
        r"""Inline tex like ``A=x\pm y`` (adjusts for one/two-tail limits)."""
        names, snippets = self.getLatex([param], limit, err_sig_figs)
        if snippets[0] is None:
            raise ValueError(f"no parameter called {param}")
        joiner = " " if snippets[0][0] in ("<", ">") else " = "
        return names[0] + joiner + snippets[0]

    def getLatex(self, params=None, limit=1, err_sig_figs=None):
        """(labels, tex snippets) for constraints on a list of parameters."""
        if isinstance(params, str):
            return self.getInlineLatex(params, limit, err_sig_figs)
        marge = self.getMargeStats()
        formatter = types.NoLineTableFormatter()
        if err_sig_figs:
            formatter.numberFormatter.err_sf = err_sig_figs
        labels, texs = [], []
        for par in params if params is not None else marge.list():
            tex = marge.texValues(formatter, par, limit=limit)
            if tex is None:
                labels.append(None)
                texs.append(None)
                continue
            info = par if isinstance(par, ParamInfo) else marge.parWithName(par)
            labels.append(info.getLabel())
            texs.append(tex[0])
        return labels, texs

    def getTable(self, columns=1, include_bestfit=False, **kwargs):
        """ResultTable of the marginalized constraints."""
        return types.ResultTable(columns, [self.getMargeStats(include_bestfit)], **kwargs)

    def getLikeStats(self):
        """LikeStats with N-D limits and best-fit sample values."""
        if self.likeStats:
            return self.likeStats
        return self._setLikeStats()

    def getMargeStats(self, include_bestfit=False):
        """MargeStats with marginalized 1D constraints for all parameters."""
        self._setDensitiesandMarge1D()
        m = types.MargeStats()
        m.hasBestFit = False
        m.limits = self.contours
        m.names = self.paramNames.names
        if include_bestfit:
            m.addBestFit(self.getBestFit())
        return m

    def getBestFit(self, max_posterior=True):
        """BestFit from the .minimum (posterior) or .bestfit (likelihood)
        sidecar file."""
        ext = ".minimum" if max_posterior else ".bestfit"
        bf_file = self.root + ext
        if os.path.exists(bf_file):
            return types.BestFit(bf_file, max_posterior=max_posterior)
        raise MCSamplesError(
            f"a {ext} file next to the chains is required for best-fit values "
            "(they cannot be derived from the samples themselves)"
        )

    def getLower(self, name):
        """Lower hard bound for a named parameter, or None."""
        par = self.paramNames.parWithName(name)
        return getattr(par, "limmin", None) if par else None

    def getUpper(self, name):
        """Upper hard bound for a named parameter, or None."""
        par = self.paramNames.parWithName(name)
        return getattr(par, "limmax", None) if par else None

    def getBounds(self):
        """ParamBounds with only the limits that are actually active."""
        bounds = ParamBounds()
        bounds.names = self.paramNames.list()
        for par in self.paramNames.names:
            if par.has_limits_bot:
                bounds.lower[par.name] = par.limmin
            if par.has_limits_top:
                bounds.upper[par.name] = par.limmax
        return bounds

    def getFractionIndices(self, weights, n):
        """Row indices splitting total weight into n equal fractions."""
        cumsum = np.cumsum(weights)
        targets = np.linspace(0, 1, n, endpoint=False) * self.norm
        return np.append(np.searchsorted(cumsum, targets), len(self.weights))

    def cool(self, cool=None):
        """Cool the samples by the given factor (default: stored
        temperature)."""
        stored = self.properties
        if cool is None:
            if not stored.hasKey("temperature"):
                raise ValueError("no stored temperature on these samples: pass the cooling factor explicitly")
            cool = stored.float("temperature")
        if cool == 1:
            return
        if stored.float("cooled", 1) != 1:
            logging.warning("samples were already cooled (factor %s)", stored.float("cooled"))
        super().cool(cool)
        stored.params["cooled"] = cool
        if stored.hasKey("temperature"):
            stored.params["temperature"] = stored.float("temperature") / cool

    def parLabel(self, i):
        """Latex label for a parameter index or name."""
        info = self.paramNames.parWithName(i) if isinstance(i, str) else self.paramNames.names[i]
        return info.label

    def parName(self, i, starDerived=False):
        """Name of the i'th parameter."""
        return self.paramNames.name(i, starDerived)

    def copy(self, label=None, settings=None) -> "MCSamples":
        """Deep copy, optionally with a new label / modified settings."""
        new = copy.deepcopy(self)
        if label:
            new.label = label
        if settings is not None:
            new.needs_update = True
            new.updateSettings(settings)
        return new

    # -- covariance, correlation, thinned and single-sample outputs ---------------------------

    def getCovMat(self):
        """CovMat of the non-derived parameters."""
        n_free = self.paramNames.numNonDerived()
        return covmat.CovMat(matrix=self.fullcov[:n_free, :n_free], paramNames=self.paramNames.list()[:n_free])

    def writeCovMatrix(self, filename=None):
        """Write the non-derived parameters' covariance as ``.covmat`` text."""
        self.getCovMat().saveToFile(filename or self.rootdirname + ".covmat")

    def writeCorrelationMatrix(self, filename=None):
        """Write the correlation matrix as text."""
        np.savetxt(filename or self.rootdirname + ".corr", self.getCorrelationMatrix(), fmt="%15.7E")

    def writeThinData(self, fname, thin_ix, cool=1):
        """Write samples for the given thinning indices, optionally cooled.

        The rows follow the JAX package's writer byte for byte (ROADMAP
        C15): row i holds the weight and -log(like) of sample
        ``thin_ix[i]`` beside the parameters of sample ``i``, and the
        uncooled weight and -log(like) are written with ``%f`` and no
        separator."""
        nparams = self.samples.shape[1]
        if cool != 1:
            logging.info("writing thinned samples cooled by %s", cool)
        if self.loglikes is None:
            raise ValueError("thinned output needs likelihood values")
        MaxL = np.max(self.loglikes)
        # one format per row: the same characters as one write per value
        row_format = "%16.7E" * nparams + "\n"
        with open(fname, "w", encoding="utf-8") as handle:
            for i, row in enumerate(thin_ix):
                if cool == 1:
                    head = "%f%f" % (1.0, self.loglikes[row])
                else:
                    newL = self.loglikes[row] * cool
                    head = "%16.7E%16.7E" % (np.exp(-(newL - self.loglikes[row]) - MaxL * (1 - cool)), newL)
                handle.write(head + row_format % tuple(self.samples[i]))
        print("Wrote ", len(thin_ix), " thinned samples")

    def makeSingleSamples(self, filename="", single_thin=None, random_state=None):
        """Random unit-weight samples, kept with probability w / (max(w)
        single_thin); written to ``filename`` when one is given."""
        if single_thin is None:
            equiv = self.norm / self.max_mult
            single_thin = max(1, equiv / self.max_scatter_points)
        draws = np.random.default_rng(random_state).random(self.numrows)
        if not filename:
            return self.samples[draws <= self.weights / (self.max_mult * single_thin)]
        row_format = "%16.7E" * (self.n + 2) + "\n"
        with open(filename, "w", encoding="utf-8") as handle:
            for i, draw in enumerate(draws):
                if draw <= self.weights[i] / self.max_mult / single_thin:
                    handle.write(row_format % (1.0, self.loglikes[i], *self.samples[i]))

    # -- chain files and combined samples ---------------------------------------------------

    def saveChainsAsText(self, root, make_dirs=False, properties=None):
        """Save each chain as text plus the metadata sidecars (samples that
        were never separate chains as one unnumbered chain file)."""
        if self.chains is None and self.chain_offsets is None:
            super(Chains, self).saveAsText(root, None, make_dirs)
        else:
            chain_list = self.getSeparateChains() if self.chains is None else self.chains
            for i, chain in enumerate(chain_list):
                chain.saveAsText(root, i, make_dirs)
        self.saveTextMetadata(root, properties)

    def saveTextMetadata(self, root, properties=None):
        """Save the .paramnames, .ranges and .properties.ini sidecars."""
        super().saveTextMetadata(root)
        self.ranges.saveToFile(root + ".ranges")
        sidecar = root + ".properties.ini"
        stored = self.properties.params if self.properties else {}
        if not (properties or stored or self.label):
            if os.path.exists(sidecar):
                os.remove(sidecar)
            return
        ini = IniFile(sidecar) if os.path.exists(sidecar) else IniFile()
        ini.params.update(stored)
        if self.label:
            ini.params["label"] = self.label
        ini.params.update(properties or {})
        ini.saveFile(sidecar)

    def getCombinedSamplesWithSamples(self, samps2, sample_weights=(1, 1)):
        """A new MCSamples (on this object's device) of this object's and
        ``samps2``'s samples of their shared parameters, weighted so that
        each set carries equal mass by default."""
        mine = set(self.paramNames.list())
        shared = ParamNames()
        shared.names = [
            ParamInfo(name=q.name, label=q.label, derived=q.isDerived)
            for q in samps2.paramNames.names
            if q.name in mine
        ]
        both_have_likes = self.loglikes is not None and samps2.loglikes is not None
        loglikes = np.concatenate([self.loglikes, samps2.loglikes]) if both_have_likes else None
        if sample_weights is None:
            balance, sample_weights = 1, (1, 1)
        else:
            balance = np.sum(self.weights) / np.sum(samps2.weights)
        weights = np.concatenate([self.weights * sample_weights[0], samps2.weights * sample_weights[1] * balance])
        first, second = self.getParams(), samps2.getParams()
        columns = [np.concatenate([getattr(first, name), getattr(second, name)]) for name in shared.list()]
        return MCSamples(samples=np.array(columns).T, weights=weights, loglikes=loglikes, paramNamesFile=shared,
                         ignore_rows=0, ranges=self.ranges, settings=copy.deepcopy(self.ini.params),
                         device=self.device)

    def getCorrelatedVariable2DPlots(self, num_plots=12, nparam=None):
        """Names of the most correlated parameter pairs, strongest first,
        for quick-look 2D plots."""
        if not nparam:
            nparam = self.paramNames.numNonDerived()
        correlation = self.getCorrelationMatrix()
        ceiling = 1e5
        best_x = best_y = 0
        pairs = []
        for _ in range(num_plots):
            strongest = -1e5
            for ix1 in range(nparam):
                for ix2 in range(ix1 + 1, nparam):
                    strength = abs(correlation[ix1][ix2])
                    if strongest < strength < ceiling:
                        strongest = strength
                        best_x, best_y = ix1, ix2
            if strongest == -1e5:
                break
            ceiling = strongest
            pairs.append([self.parName(best_x), self.parName(best_y)])
        return pairs

    # -- principal components ----------------------------------------------------------------

    def _pca_log_map(self, params, nparams):
        """N (linear) or L (log) mapping per parameter: log where the
        samples sit well away from zero."""
        chosen = []
        for info in self.paramNames.parsWithNames(params):
            self._initParamRanges(info.name)
            span10 = (info.param_max - info.param_min) / 10
            chosen.append("N" if (info.param_max < 0 or info.param_min < span10) else "L")
        return "".join(chosen)

    def PCA(self, params, param_map=None, normparam=None, writeDataToFile=False, filename=None, conditional_params=(),
            n_best_only=None):
        """Principal component analysis of the standardized (optionally
        log-mapped: ``L``, or ``M`` for ln(-x)) parameters, with any
        ``conditional_params`` marginalized through the precision matrix:
        a text report of the correlation matrix, its eigenvalues and
        eigenvectors, each component as a power law and the components'
        correlations with every parameter; written to ``<rootdirname>.PCA``
        (or ``filename``) with ``writeDataToFile``."""
        logging.info("PCA over %s parameters", len(params))
        if conditional_params:
            logging.info("with %s parameters conditioned out", len(conditional_params))
        text = ["PCA for parameters:\n"]

        params = [name for name in params if self.paramNames.parWithName(name) is not None]
        nparams = len(params)
        indices = [self.index[param] for param in params] + [self.index[p] for p in conditional_params]
        normparam = params.index(normparam) if normparam and normparam in params else -1
        if param_map is None:
            param_map = self._pca_log_map(params, nparams)

        n = len(indices)
        table = self.samples[:, indices].copy()
        doexp = False
        for i in range(nparams):
            label = self.parLabel(indices[i])
            mapped = label
            if param_map[i] == "L":
                doexp = True
                table[:, i] = np.log(table[:, i])
                mapped = "ln(" + label + ")"
            elif param_map[i] == "M":
                doexp = True
                table[:, i] = np.log(-1.0 * table[:, i])
                mapped = "ln(-" + label + ")"
            text.append("%10s :%s\n" % (str(indices[i] + 1), str(mapped)))
        center = np.empty(n)
        sd = np.empty(n)
        for i in range(n):
            center[i] = np.dot(self.weights, table[:, i]) / self.norm
            table[:, i] -= center[i]
            sd[i] = np.sqrt(np.dot(self.weights, table[:, i] ** 2) / self.norm)
            if sd[i] != 0:
                table[:, i] /= sd[i]

        text.append("\n")
        text.append("Correlation matrix for reduced parameters\n")
        correlation = np.ones((n, n))
        for i in range(n):
            for j in range(i):
                correlation[j][i] = np.dot(self.weights, table[:, i] * table[:, j]) / self.norm
                correlation[i][j] = correlation[j][i]
        for i in range(nparams):
            text.append("%12s :" % params[i] + "".join("%8.4f" % correlation[j][i] for j in range(n)) + "\n")

        if len(conditional_params):
            keep = list(range(nparams))
            reduced = np.linalg.inv(np.linalg.inv(correlation)[np.ix_(keep, keep)])
            n = nparams
            table = table[:, :nparams]
        else:
            reduced = correlation
        evals, evects = np.linalg.eig(reduced)
        by_size = evals.argsort()
        modes = np.transpose(evects[:, by_size])

        text.append("\n")
        text.append("e-values of correlation matrix\n")
        text.extend("PC%2i: %8.4f\n" % (i + 1, evals[by_size[i]]) for i in range(n))
        text.append("\n")
        text.append("e-vectors\n")
        for j in range(n):
            text.append("%3i:" % (indices[j] + 1) + "".join("%8.4f" % evects[j][by_size[i]] for i in range(n)) + "\n")

        # scale each mode so the pivot parameter enters with its own sd
        for i in range(n):
            pivot = normparam if normparam != -1 else np.abs(modes[i, :]).argmax()
            modes[i, :] = modes[i, :] / modes[i, pivot] * sd[pivot]

        # row by row, as the JAX package does: its bits decide the report
        for row in range(table.shape[0]):
            table[row, :] = np.dot(modes, table[row, :])
            if doexp:
                table[row, :] = np.exp(table[row, :])

        text.append("\n")
        text.append("Principal components\n")
        mode_texts = []
        pc_mean = np.empty(n)
        pc_sd = np.empty(n)
        for i in range(n):
            block = "PC%i (e-value: %f)\n" % (i + 1, evals[by_size[i]])
            for j in range(n):
                label = self.parLabel(indices[j])
                weight_tag = f"[{modes[i][j]:f}]"
                if param_map[j] in ("L", "M"):
                    expo = "%f" % (1.0 / sd[j] * modes[i][j])
                    sign = -1.0 if param_map[j] == "M" else 1.0
                    div = "%f" % (sign * np.exp(center[j]))
                    block += f"{weight_tag}  ({label}/{div})^{{{expo}}}\n"
                else:
                    expo = "%f" % (sd[j] / modes[i][j])
                    form = f"exp(({label}-{center[j]:f})/{expo})" if doexp else f"({label}-{center[j]:f})/{expo}"
                    block += f"{weight_tag}   {form}\n"
            pc_mean[i] = self.mean(table[:, i])
            pc_sd[i] = np.sqrt(self.mean((table[:, i] - pc_mean[i]) ** 2))
            block += f"          = {pc_mean[i]:f} +- {pc_sd[i]:f}\n"
            block += "\n"
            mode_texts.append(block)
        text.extend(mode_texts)

        text.append("Correlations of principal components\n")
        text.append("%s\n" % ("".join("%8i" % i for i in range(1, n + 1))))
        for i in range(n):
            table[:, i] = (table[:, i] - pc_mean[i]) / pc_sd[i]
        for j in range(n):
            text.append("PC%2i" % (j + 1) + "".join("%8.3f" % self.mean(table[:, i] * table[:, j]) for i in range(n))
                        + "\n")
        for j in range(self.n):
            row = "%4i" % (j + 1)
            scaled = (self.samples[:, j] - self.means[j]) / self.sddev[j]
            for i in range(n):
                row += "%8.3f" % (np.sum(self.weights * table[:, i] * scaled) / self.norm)
            text.append(row + "   (%s)\n" % self.parLabel(j))

        report = "".join(text)
        if writeDataToFile:
            with open(filename or self.rootdirname + ".PCA", "w", encoding="utf-8") as handle:
                handle.write(report)
        if n_best_only:
            return mode_texts[0] if n_best_only == 1 else mode_texts[:n_best_only]
        return report

    # -- N-D densities -------------------------------------------------------------------------

    def getRawNDDensity(self, xs, normalized=False, **kwargs):
        """DensityND (the unsmoothed histogram) of a list of parameters."""
        if self.needs_update:
            self.updateBaseStatistics()
        density = self.getRawNDDensityGridData(xs, get_density=True, **kwargs)
        if normalized:
            density.normalize(in_place=True)
        return density

    def getRawNDDensityGridData(self, js, writeDataToFile=False, num_plot_contours=None, get_density=False,
                                meanlikes=False, maxlikes=False, **kwargs):
        """Unsmoothed N-D histogram density of the parameters ``js``
        (``num_bins_ND`` bins an axis; edge cells at a hard limit counted
        at half width), with its contour levels and optional mean and
        profile likelihoods; the weighted histograms through
        :meth:`_bincount` (on ``self.device`` under
        ``GETDIST_TPU_TORCH_DEVICE_OPS=1``)."""
        if self.needs_update:
            self.updateBaseStatistics()
        resolved = [self._parAndNumber(j) for j in js]
        if any(col is None for col, _ in resolved):
            return None
        columns = [col for col, _ in resolved]
        infos = [info for _, info in resolved]
        ndim = len(js)
        for col in columns:
            self._initParamRanges(col)

        boundary_order = kwargs.get("boundary_correction_order", self.boundary_correction_order)
        bounded = any(info.has_limits for info in infos)
        nbinsND = kwargs.get("num_bins_ND") or self.num_bins_ND

        binned = [self._binSamples(self.samples[:, col], info, nbinsND) for col, info in zip(columns, infos)]
        ixv = [b[0] for b in binned]
        axis_lo = [b[2] for b in binned]
        axis_hi = [b[3] for b in binned]
        shape = nbinsND * np.ones(ndim, dtype=int)
        binsND, flatixv = self._makeNDhist(ixv, shape)

        if bounded and boundary_order >= 0:
            edge_weight = np.ones(shape[::-1])
            self._setRawEdgeMaskND(infos, edge_weight)
            binsND /= edge_weight

        binNDlikes = None
        if meanlikes:
            flat = np.array(self._bincount(flatixv, self._likelihood_weights(), int(np.prod(shape))))
            binNDlikes = flat.reshape(shape[::-1], order="C")

        binNDmaxlikes = self._profile_likes_nd(binsND.shape, ixv, ndim) if maxlikes else None

        grids = [np.linspace(lo, hi, n) for lo, hi, n in zip(axis_lo, axis_hi, shape)]
        views = [(info.range_min, info.range_max) for info in infos]
        density = DensityND(grids, binsND, view_ranges=views)
        density.normalize("max", in_place=True)
        if get_density:
            return density

        ncontours = len(self.contours)
        if num_plot_contours:
            ncontours = min(int(num_plot_contours), ncontours)
        contours = self.contours[:ncontours]
        density.contours = density.getContourLevels(contours)

        if binNDlikes is not None:
            binNDlikes /= np.max(binNDlikes)
        density.likes = binNDlikes

        density.maxlikes = binNDmaxlikes
        if maxlikes:
            density.maxcontours = getContourLevels(binNDmaxlikes, contours, half_edge=False)

        if writeDataToFile:
            self._write_nd_density_files(density, binsND, binNDlikes, binNDmaxlikes, grids, ndim, meanlikes, maxlikes)
        return density

    def _profile_likes_nd(self, shape, ixv, ndim):
        """Per-cell profile (maximum) likelihood over the N-D histogram, by
        one unordered maximum scatter (a maximum does not depend on the
        order, so the bits are those of a row-by-row loop)."""
        out = np.zeros(shape)
        bestfit = np.max(-self.loglikes)
        np.maximum.at(out, tuple(ixv[i] for i in range(ndim)[::-1]), np.exp(-bestfit - self.loglikes))
        return out

    def _write_nd_density_files(self, density, binsND, binNDlikes, binNDmaxlikes, grids, ndim, meanlikes, maxlikes):
        """Write the plot-data files of an N-D histogram density."""
        stem = self.rootname + "_%s" + f"_{ndim}D.dat"
        table = [np.ravel(binsND, order="C")]
        for i in range(ndim):
            table.append([grids[i][cell[::-1][i]] for cell in np.ndindex(binsND.shape)])
        np.savetxt(os.path.join(self.plot_data_dir, stem % "posterior"), np.transpose(table), "%16.7E")
        contfile = f"{self.rootname}_posterior_{ndim}D_cont.dat"
        np.savetxt(os.path.join(self.plot_data_dir, contfile), np.atleast_2d(density.contours), "%16.7E")
        for wanted, values, tag in ((meanlikes, binNDlikes, "meanlike"), (maxlikes, binNDmaxlikes, "maxlike")):
            if wanted:
                table[0] = np.ravel(values, order="C")
                np.savetxt(os.path.join(self.plot_data_dir, stem % tag), np.transpose(table), "%16.7E")

    def _makeNDhist(self, ixs, xsizes):
        if len(ixs) != len(xsizes):
            raise ValueError("need one bin size per index array")
        flatixv = self._flattenValues(ixs, xsizes)
        rebuilt = self._unflattenValues(flatixv, xsizes)
        if np.any(np.asarray(ixs) != np.asarray(rebuilt)):
            raise ValueError("ND flat-index round-trip failed")
        # np.array: the caller divides the histogram in place by the edge mask
        hist = np.array(self._bincount(flatixv, self.weights, int(np.prod(xsizes)))).reshape(xsizes[::-1], order="C")
        return hist, flatixv

    def _unflattenValues(self, q, xsizes):
        ndim = len(xsizes)
        if ndim == 1:
            return [q]
        strides = [np.prod(xsizes[:k]) for k in range(ndim)]
        ixs = [np.array(q) for _ in range(ndim)]
        ixs[ndim - 1] = q // strides[ndim - 1]
        consumed = 0
        for k in range(ndim - 2, -1, -1):
            consumed = consumed + ixs[k + 1] * strides[k + 1]
            remainder = q - consumed
            ixs[k] = remainder // strides[k] if k > 0 else remainder
        return ixs

    def _flattenValues(self, ixs, xsizes):
        q = ixs[0]
        for i in range(1, len(ixs)):
            q = q + np.prod(xsizes[0:i]) * ixs[i]
        return q

    def _setRawEdgeMaskND(self, parv, prior_mask):
        ndim = len(parv)
        vrap = parv[::-1]
        if len(prior_mask.shape) != ndim:
            raise ValueError("prior_mask dimensionality does not match the parameter list")
        slices = [slice(None) for _ in range(ndim)]
        for i in range(ndim):
            if vrap[i].has_limits_bot:
                slices[i] = 0
                prior_mask[tuple(slices)] /= 2
                slices[i] = slice(None)
            if vrap[i].has_limits_top:
                slices[i] = prior_mask.shape[i] - 1
                prior_mask[tuple(slices)] /= 2
                slices[i] = slice(None)

    # -- plot scripts (for the batch command) -------------------------------------------------

    def _WritePlotFile(self, filename, subplot_size, text, tag, ext=None):
        """Write a plot script for this root; the script imports
        ``getdist_tpu_torch.plots`` and its plotter loads the root on this
        object's device (``device='cpu'`` in a CPU run's script)."""
        if not self.root:
            raise ValueError("plot scripts need file-rooted samples (no root set)")
        fname = self.rootname + tag + "." + (ext or self.plot_output)
        script = [
            "import getdist_tpu_torch.plots as plots, os",
            "g=plots.GetDistPlotter(chain_dir=r'%s', device='%s')"
            % (self.batch_path or os.path.dirname(self.root), self.device),
            "g.settings.set_with_subplot_size(%s)" % subplot_size,
            "roots = ['%s']" % self.rootname,
            text,
            f"g.export(os.path.join(r'{self.out_dir}',r'{fname}'))",
        ]
        with open(filename, "w", encoding="utf-8") as handle:
            handle.write("\n".join(script) + "\n")

    def _writeScriptPlots3D(self, filename, plot_3D, ext=None):
        rows = ["sets=[]"]
        rows.extend("sets.append(['{}','{}','{}'])".format(*pars) for pars in plot_3D)
        rows.append("g.plots_3d(roots,sets)")
        self._WritePlotFile(filename, self.subplot_size_inch3, "\n".join(rows), "_3D", ext)

    def _writeScriptPlotsTri(self, filename, triangle_params, ext=None):
        self._WritePlotFile(filename, self.subplot_size_inch, "g.triangle_plot(roots, %s)" % triangle_params, "_tri",
                            ext)

    def _writeScriptPlots2D(self, filename, plot_2D_param=None, cust2DPlots=(), ext=None):
        restricted = bool(plot_2D_param) or bool(len(cust2DPlots))
        wanted = {f"{a}__{b}" for a, b in cust2DPlots}
        done2D = {}
        lines = ["pairs=[]"]
        for j, name1 in enumerate(self.paramNames.list()):
            if restricted and name1 == plot_2D_param:
                continue
            start = 0 if restricted else j + 1
            for j2 in range(start, self.n):
                name2 = self.parName(j2)
                if plot_2D_param and name2 != plot_2D_param:
                    continue
                if wanted and f"{name1}__{name2}" not in wanted:
                    continue
                if (name1, name2) not in done2D:
                    done2D[(name1, name2)] = True
                    lines.append(f"pairs.append(['{name1}','{name2}'])")
        lines.append("g.plots_2d(roots,param_pairs=pairs,filled=True)")
        self._WritePlotFile(filename, self.subplot_size_inch2, "\n".join(lines), "_2D", ext)
        return done2D

    def _writeScriptPlots1D(self, filename, plotparams=None, ext=None):
        rows = ["markers = " + (str(self.markers) if self.markers else "None")]
        if plotparams:
            quoted = ",".join(f"'{name}'" for name in plotparams)
            rows.append(f"g.plots_1d(roots,[{quoted}], markers=markers)")
        else:
            rows.append("g.plots_1d(roots, markers=markers)")
        self._WritePlotFile(filename, self.subplot_size_inch, "\n".join(rows), "", ext)

    # -- convergence tests -------------------------------------------------------------------

    class _RLAbort(Exception):
        """Raftery-Lewis hit a degenerate fitted count; abort the battery."""

    class _RLChainFail(Exception):
        """This chain cannot be RL-analysed (zero transitions)."""

    @staticmethod
    def _rl_binary_transitions(values, threshold, order):
        """Transition-count tensor of the thresholded binary chain: shape
        (2,)*(order+1), counting order+1-grams."""
        bits = (values < threshold).astype(int)
        grams = 0
        for shift in range(order + 1):
            stop = bits.size - order + shift
            grams = grams * 2 + bits[shift:stop]
        return np.bincount(grams, minlength=2 ** (order + 1)).reshape((2,) * (order + 1))

    @staticmethod
    def _rl_g2_second_vs_markov(tran):
        """2 * G^2 likelihood-ratio of a 2nd-order binary process against
        1st-order, from the (2,2,2) trigram counts."""
        lead = tran.sum(axis=2, keepdims=True)
        trail = tran.sum(axis=0, keepdims=True)
        mid = tran.sum(axis=(0, 2), keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            fitted = lead * trail / mid
            pieces = np.where(tran != 0, np.log(tran / fitted) * tran, 0.0)
        return 2 * pieces.sum()

    def _rl_g2_markov_vs_indep(self, tran2, thin_rows):
        """2 * G^2 of a Markov binary process against independence, from the
        (2,2) bigram counts; aborts the battery on degenerate fits."""
        expected = tran2.sum(axis=1, keepdims=True) * tran2.sum(axis=0, keepdims=True) / float(thin_rows - 1)
        live = tran2 != 0
        if np.any(live & ((expected <= 0) | (tran2 <= 0))):
            raise self._RLAbort()
        with np.errstate(divide="ignore", invalid="ignore"):
            pieces = np.where(live, np.log(tran2 / expected) * tran2, 0.0)
        return 2 * pieces.sum()

    def _rl_analyse_chain(self, chain, limits, nparamMC, test_confidence, shared):
        """Raftery-Lewis numbers for one chain: (markov_thin, indep_thin,
        nburn).  ``shared`` carries the hardest (param, end) across chains.
        Cf. reference ``mcsamples.py:1039-1181``.
        """
        epsilon = 0.001
        thin_fac = int(round(np.max(chain.weights)))
        nburn = 0
        for j in range(nparamMC):
            edges = self.confidence(chain.samples[:, j], limits, weights=chain.weights)
            for endb in (0, 1):
                # grow the thinning until 2nd-order structure is gone (BIC)
                tran = None
                while True:
                    thin_ix = self.thin_indices(thin_fac, chain.weights)
                    thin_rows = len(thin_ix)
                    if thin_rows < 2:
                        break
                    tran = self._rl_binary_transitions(chain.samples[thin_ix, j], edges[endb], order=2)
                    if self._rl_g2_second_vs_markov(tran) - math.log(float(thin_rows - 2)) * 2 < 0:
                        break
                    thin_fac += 1
                # burn-in from the thinned chain's Markov transition rates
                if tran is None or not (tran[:, 0, 1].sum() and tran[:, 1, 0].sum()):
                    raise self._RLChainFail()
                alpha = tran[:, 0, 1].sum() / float(tran[:, 0, 0].sum() + tran[:, 0, 1].sum())
                beta = tran[:, 1, 0].sum() / float(tran[:, 1, 0].sum() + tran[:, 1, 1].sum())
                switch_rate = alpha + beta
                decay = math.log(switch_rate * epsilon / max(alpha, beta)) / math.log(abs(1.0 - switch_rate))
                if int(decay + 1) * thin_fac > nburn:
                    nburn = int(decay + 1) * thin_fac
                    shared["hardest"] = j
                    shared["hardestend"] = endb

        markov_thin = thin_fac
        # continue growing until even Markov structure is gone -> independence
        hardest = max(shared["hardest"], 0)
        u = self.confidence(
            self.samples[:, hardest], (1 - test_confidence) / 2, shared["hardestend"] == 0
        )
        while True:
            thin_ix = self.thin_indices(thin_fac, chain.weights)
            thin_rows = len(thin_ix)
            if thin_rows < 2:
                break
            tran2 = self._rl_binary_transitions(chain.samples[thin_ix, hardest], u, order=1)
            if self._rl_g2_markov_vs_indep(tran2, thin_rows) - np.log(float(thin_rows - 1)) < 0:
                break
            thin_fac += 1
        if thin_rows < 2:
            thin_fac = 0
        return markov_thin, thin_fac, nburn

    def _report_corr_lengths(self, out, chainlist, parNames, parForm):
        out.append(
            "Parameter autocorrelation lengths (effective number of samples N_eff = tot weight/weight length)\n"
        )
        out.append("\n")
        out.append(parForm % "" + "%15s %15s %15s\n" % ("Weight Length", "Sample length", "N_eff"))
        maxoff = min(chain.weights.size // 10 for chain in chainlist)
        form = "%15.2f" if self.mean_mult > 1 else "%15.2E"
        longest = 0
        for j in range(self.n):
            curve = sum(chain.getAutocorrelation(j, maxoff, normalized=False) * chain.norm for chain in chainlist)
            curve /= self.norm * self.vars[j]
            cut = np.argmin(curve > 0.05 * curve[0])
            N = curve[0] + 2 * np.sum(curve[1:cut])
            longest = max(N, longest)
            out.append(parNames[j] + form % N + " %15.2f %15i\n" % (N / self.mean_mult, self.norm / N))
        self.indep_thin = longest
        out.append("\n")

    def _report_mean_var(self, out, chainlist, parNames):
        out.append("\n")
        out.append("mean convergence stats using remaining chains\n")
        out.append("param sqrt(var(chain mean)/mean(chain var))\n")
        out.append("\n")
        between = sum((chain.means - self.means) ** 2 for chain in chainlist) / (len(chainlist) - 1)
        within = (
            np.array([[np.dot(chain.weights, d * d) for d in chain.diffs] for chain in chainlist]).sum(axis=0)
            / self.norm
        )
        for j in range(self.n):
            out.append(parNames[j] + f"{math.sqrt(between[j] / within[j]):10.4f}  {self.parLabel(j)}\n")
        out.append("\n")

    def _report_gelman_rubin(self, out, chainlist, feedback):
        eigs = self.getGelmanRubinEigenvalues(chainlist=chainlist)
        if eigs is None:
            self.GelmanRubin = None
            summary = "Gelman-Rubin covariance not invertible (parameter not moved?)"
            logging.warning(summary)
        else:
            self.GelmanRubin = np.max(eigs)
            out.append("var(mean)/mean(var) for eigenvalues of covariance of y of orthonormalized parameters\n")
            out.extend("%3i%13.5f\n" % (k + 1, val) for k, val in enumerate(eigs))
            summary = " var(mean)/mean(var), remaining chains, worst e-value: R-1 = %13.5F" % self.GelmanRubin
        if feedback:
            print(summary)
        out.append("\n")

    def _report_split_test(self, out, parNames, limits):
        out.append(
            "Split tests: rms_n([delta(upper/lower quantile)]/sd) n={2,3,4}, limit=%.0f%%:\n"
            % (100 * self.converge_test_limit)
        )
        out.append("i.e. mean sample splitting change in the quantiles in units of the st. dev.\n")
        out.append("\n")
        n_splits = self.max_split_tests - 1
        partitions = [self.getFractionIndices(self.weights, k + 2) for k in range(n_splits)]
        for j in range(self.n):
            column = self.samples[:, j]
            whole = self.confidence(column, limits)
            rms = np.zeros((n_splits, 2))
            for ix, cuts in enumerate(partitions):
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    rms[ix] += (self.confidence(column, limits, start=lo, end=hi) - whole) ** 2
                rms[ix] = np.sqrt(rms[ix] / (ix + 2)) / self.sddev[j]
            for endb, tail_name in enumerate(("upper", "lower")):
                out.append(parNames[j] + "".join("%9.4f" % rms[ix, endb] for ix in range(n_splits)) + " %s\n" % tail_name)
        out.append("\n")

    def _report_raftery_lewis(self, out, chainlist, limits, nparamMC, test_confidence, feedback):
        num = len(chainlist)
        markov_thin = np.zeros(num, dtype=int)
        thin_fac = np.zeros(num, dtype=int)
        nburn = np.zeros(num, dtype=int)
        shared = {"hardest": -1, "hardestend": 0}
        for ix, chain in enumerate(chainlist):
            try:
                markov_thin[ix], thin_fac[ix], nburn[ix] = self._rl_analyse_chain(
                    chain, limits, nparamMC, test_confidence, shared
                )
            except self._RLAbort:
                raise
            except Exception:
                # numerical failure on this chain -> reported as Failed
                thin_fac[ix] = 0
        out.append("Raftery&Lewis statistics\n")
        out.append("\n")
        out.append("chain  markov_thin  indep_thin    nburn\n")
        for ix in range(num):
            if thin_fac[ix] == 0:
                out.append("%4i      Failed/not enough samples\n" % ix)
            else:
                out.append("%4i%12i%12i%12i\n" % (ix, markov_thin[ix], thin_fac[ix], nburn[ix]))
        self.RL_indep_thin = np.max(thin_fac)
        if feedback:
            if not np.all(thin_fac != 0):
                print("RL: Not enough samples to estimate convergence stats")
            else:
                print("RL: Thin for Markov: ", np.max(markov_thin))
                print("RL: Thin for indep samples:  ", str(self.RL_indep_thin))
                print(
                    "RL: Estimated burn in steps: ",
                    np.max(nburn),
                    " (",
                    int(round(np.max(nburn) / self.mean_mult)),
                    " rows)",
                )
        out.append("\n")

    def _report_corr_steps(self, out, chainlist, parNames, parForm):
        out.append("Parameter auto-correlations as function of step separation\n")
        out.append("\n")
        if self.corr_length_thin != 0:
            autocorr_thin = self.corr_length_thin
        elif self.indep_thin == 0:
            autocorr_thin = 20
        elif self.indep_thin <= 30:
            autocorr_thin = 5
        else:
            autocorr_thin = int(5 * (self.indep_thin / 30))

        thin_rows = len(self.thin_indices(autocorr_thin))
        maxoff = int(min(self.corr_length_steps, thin_rows // (2 * len(chainlist))))
        if maxoff <= 0:
            return
        corrs = np.zeros([maxoff, self.n])
        for chain in chainlist:
            thin_ix = chain.thin_indices(autocorr_thin)
            thin_rows = len(thin_ix)
            maxoff = min(maxoff, thin_rows // autocorr_thin)
            for j in range(self.n):
                thinned = chain.diffs[j][thin_ix]
                for off in range(1, maxoff + 1):
                    corrs[off - 1][j] += (
                        np.dot(thinned[off:], thinned[:-off]) / (thin_rows - off) / self.vars[j]
                    )
        corrs /= len(chainlist)
        out.append(parForm % "" + "".join("%8i" % ((i + 1) * autocorr_thin) for i in range(maxoff)) + "\n")
        for j in range(self.n):
            out.append(parNames[j] + "".join("%8.3f" % corrs[i][j] for i in range(maxoff)) + " %s\n" % self.parLabel(j))

    def getConvergeTests(
        self, test_confidence=0.95, writeDataToFile=False,
        what=("MeanVar", "GelmanRubin", "SplitTest", "RafteryLewis", "CorrLengths"), filename=None, feedback=False
    ):
        """Run the convergence-test battery and return the text report.

        Tests (reference ``mcsamples.py:904-1228``): CorrLengths (weighted
        autocorrelation lengths), MeanVar (per-parameter sqrt(var(chain
        mean)/mean(chain var))), GelmanRubin (worst orthogonalized
        eigenvalue R-1), SplitTest (quantile rms over 2..4 equal-weight
        splits), RafteryLewis (binary-chain BIC thinning/burn, integer
        weights only), CorrSteps table.  Each test is a ``_report_*``
        method appending to the shared line list; the report text is
        byte-compatible with the reference ``.converge`` format.
        """
        out = []
        chainlist = self.getSeparateChains()
        multi_chain = len(chainlist) > 1
        if multi_chain and feedback:
            print("Number of chains used = ", len(chainlist))
        for chain in chainlist:
            chain.setDiffs()
        parForm = self.paramNames.parFormat()
        parNames = [parForm % self.parName(j) for j in range(self.n)]
        tail = (1 - test_confidence) / 2
        limits = np.array([1 - tail, tail])
        nparamMC = self.paramNames.numNonDerived()
        integer_weights = np.all(np.abs(self.weights - self.weights.astype(int)) < 1e-4 / self.max_mult)

        battery = (
            ("CorrLengths", True, lambda: self._report_corr_lengths(out, chainlist, parNames, parForm)),
            ("MeanVar", multi_chain, lambda: self._report_mean_var(out, chainlist, parNames)),
            ("GelmanRubin", multi_chain and nparamMC > 0, lambda: self._report_gelman_rubin(out, chainlist, feedback)),
            ("SplitTest", True, lambda: self._report_split_test(out, parNames, limits)),
            (
                "RafteryLewis",
                integer_weights,
                lambda: self._report_raftery_lewis(out, chainlist, limits, nparamMC, test_confidence, feedback),
            ),
            ("CorrSteps", integer_weights, lambda: self._report_corr_steps(out, chainlist, parNames, parForm)),
        )
        for tag, applicable, run in battery:
            if tag in what and applicable:
                try:
                    run()
                except self._RLAbort:
                    print("Raftery and Lewis estimator had problems")
                    return

        report = "".join(out)
        if writeDataToFile:
            from pathlib import Path

            Path(filename or self.rootdirname + ".converge").write_text(report, encoding="utf-8")
        return report

    # -- routing onto the fused program --------------------------------------------------------

    def _fused_route_enabled(self):
        """Whether the default density queries are served from one run of
        the fused program (:meth:`_fused_densities_state`): on a CUDA
        ``MCSamples`` at the fused path's conventions (auto bandwidths,
        boundary and multiplicative-bias orders 1). A CPU object takes the
        host path, the byte-exact oracle, as the JAX package does on its CPU
        backend. ``GETDIST_TPU_TORCH_FUSED=0`` forces the host path and
        ``=1`` routes a CPU object too (the kernels' plain versions), as the
        tests do."""
        flag = os.environ.get("GETDIST_TPU_TORCH_FUSED")
        if flag == "0":
            return False
        if not (
            float(self.smooth_scale_1D) < 0
            and float(self.smooth_scale_2D) < 0
            and int(self.boundary_correction_order) == 1
            and int(self.mult_bias_correction_order) == 1
        ):
            return False
        return flag == "1" or self.device.type == "cuda"

    def _fused_densities_state(self, meanlikes=False):
        """(dens1, dens2) dicts from ONE fused program run
        (:meth:`fastDensities`), cached until the samples change; the routed
        get*DensityGridData entry points serve individual queries from here,
        so a 30-parameter ``getMargeStats`` or triangle plot costs one
        program, not one host KDE per parameter and pair. Mean-likelihood
        grids are a separately cached variant. An error of the run reaches
        the caller: there is no silent host fallback. The count of queries
        the host served by design (``fast_profile["host_served"]``) is kept
        across the run."""
        if self._fused_cache is None:
            self._fused_cache = {}
        if meanlikes not in self._fused_cache:
            served = self.fast_profile.get("host_served", 0)
            self._fused_cache[meanlikes] = self.fastDensities(
                contours=tuple(np.asarray(self.contours, float)), meanlikes=meanlikes
            )
            self.fast_profile["host_served"] = served
        return self._fused_cache[meanlikes]

    def _host_served(self):
        """None, counted in ``fast_profile["host_served"]``: a routed query
        that the host path serves by design."""
        self.fast_profile["host_served"] = self.fast_profile.get("host_served", 0) + 1

    def _fused_1d_lookup(self, j, paramConfid=None, meanlikes=False):
        """Density1D for one parameter from the fused program's run, or None
        (counted, :meth:`_host_served`) for an unknown parameter."""
        jx, par = self._parAndNumber(j)
        if par is None:
            return self._host_served()
        dens1, _ = self._fused_densities_state(meanlikes)
        density = dens1.get(par.name)
        if density is None:
            return self._host_served()
        self._initParamRanges(jx, paramConfid)
        density.view_ranges = [par.range_min, par.range_max]
        self.density1D[par.name] = density
        return density

    def _fused_2d_lookup(self, j, j2, num_plot_contours=None, meanlikes=False):
        """Density2D for a pair from the fused program's run, transposed
        when the query order is reversed relative to the stored (a < b)
        order; None (counted, :meth:`_host_served`) for an unknown
        parameter, which the host path serves. Every pair of a meanlikes run
        carries its like grid, a rerun's binned at the rerun's grid."""
        jx, parx = self._parAndNumber(j)
        jy, pary = self._parAndNumber(j2)
        if parx is None or pary is None:
            return self._host_served()
        _, dens2 = self._fused_densities_state(meanlikes)
        density = dens2.get((parx.name, pary.name))
        flipped = dens2.get((pary.name, parx.name))
        if density is None and flipped is not None:
            density = Density2D(flipped.y, flipped.x, flipped.P.T)
            density.contours = flipped.contours
            density.likes = None if getattr(flipped, "likes", None) is None else flipped.likes.T
        if density is None:
            return self._host_served()
        if meanlikes and getattr(density, "likes", None) is None:
            raise RuntimeError(f"the fused run holds no mean-likelihood grid for ({parx.name}, {pary.name})")
        self._initParamRanges(jx)
        self._initParamRanges(jy)
        out = Density2D(density.x, density.y, density.P,
                        view_ranges=[(parx.range_min, parx.range_max), (pary.range_min, pary.range_max)])
        levels = np.asarray(density.contours, float)
        if num_plot_contours:
            levels = levels[: min(int(num_plot_contours), len(levels))]
        out.contours = levels
        out.likes = getattr(density, "likes", None)
        return out

    # -- fused path ------------------------------------------------------------------------------

    def fastDensities(self, params=None, contours=(0.68, 0.95), cache_1d=True, meanlikes=False, parity=False):
        """Fused-pipeline densities as plot-ready objects: a dict of
        :class:`~.densities.Density1D` per parameter name and a dict of
        :class:`~.densities.Density2D` per name pair.

        With ``cache_1d`` the 1D results populate the ``density1D`` cache.
        Fast-path KDE conventions (see :meth:`fastTriangleDensities`), or
        reference-exact ones with ``parity=True`` (see
        :meth:`fastParityDensities`; its host variant).
        """
        if parity:
            dens1, dens2 = self.fastParityDensities(params=params, contours=contours)
            if cache_1d:
                self.density1D.update(dens1)
            return dens1, dens2
        d1, d2, pairs = self.fastTriangleDensities(params=params, contours=contours, meanlikes=meanlikes)
        if params is None:
            infos = list(self.paramNames.names)
        else:
            infos = [self._parAndNumber(p)[1] for p in params]
        names = [par.name for par in infos]
        bmin = _host(d1["range"][0]).astype(float)
        bmax = _host(d1["range"][1]).astype(float)
        x1, p1 = _host(d1["x"]).astype(float), _host(d1["P"]).astype(float)
        dens1 = {}
        likes1 = None if d1.get("likes") is None else _host(d1["likes"]).astype(float)
        for i, (name, par) in enumerate(zip(names, infos)):
            view = [par.range_min, par.range_max] if hasattr(par, "range_min") else None
            dens1[name] = Density1D(x1[i], P=p1[i], view_ranges=view)
            dens1[name].likes = None if likes1 is None else likes1[i]
        regrid = d2.get("regrid", {})
        grids, levels = _host(d2["P"]).astype(float), _host(d2["contours"]).astype(float)
        likes2 = None if d2.get("likes") is None else _host(d2["likes"]).astype(float)
        dens2 = {}
        for k, (a, b) in enumerate(pairs):
            fine = regrid.get((a, b))
            grid_p = _host(fine["P"]).astype(float) if fine else grids[k]
            npts = grid_p.shape[0]
            density = Density2D(np.linspace(bmin[a], bmax[a], npts), np.linspace(bmin[b], bmax[b], npts), grid_p)
            density.contours = _host(fine["contours"]).astype(float) if fine else levels[k]
            if fine:
                # a rerun bins the like weights at its own grid
                density.likes = _host(fine["likes"]).astype(float) if "likes" in fine else None
            else:
                density.likes = None if likes2 is None else likes2[k]
            dens2[(names[a], names[b])] = density
        if cache_1d:
            self.density1D.update(dens1)
        return dens1, dens2

    def _fast_chain_state(self, whole=True):
        """The fused path's chain state, cached until the samples change
        (``chains._weightsChanged``): whether every weight is an integer in
        [0, 127] with a total below 2^31 (the histogram kernel then
        accumulates exactly), the pair cumulant score and the f32
        likelihood weights (:meth:`_likelihood_weights`) once computed, the
        last sharded block (:meth:`_fast_device_view`), and with ``whole``
        the f32 samples and weights on ``self.device``
        (``prepare_chain``), uploaded at the first call that asks for them.

        The JAX package's x64 'native' copies and its bf16 'exact' weight
        sniff are TPU/x64 artefacts: the reruns use this f32 copy, as a
        device with x64 off does, and f32 weights need no bf16 split."""
        st = getattr(self, "_fast_chain_cache", None)
        if st is None:
            w = self.weights
            int8 = bool(
                w.size
                and np.all(w == np.round(w))
                and w.min() >= 0
                and w.max() <= 127
                and w.size * float(w.max()) < 2**31
            )
            st = {"samples": None, "weights": None, "int8": int8, "cum_score": None, "like_weights": None,
                  "block": None}
            self._fast_chain_cache = st
        if whole and st["samples"] is None:
            st["samples"], st["weights"] = prepare_chain(self.samples, self.weights, device=self.device)
        return st

    def _likelihood_weights(self):
        """Per-sample weights of the mean-likelihood grids: w exp(<-log L> -
        (-log L)), with the chain's weighted mean of ``loglikes``."""
        return self.weights * np.exp(self.mean_loglike - self.loglikes)

    def _fast_cum_score(self, mesh=None):
        """|k31| + |k13| + |k22| standardized joint cumulants per pair (host
        (P, P) array) — the gate separating genuinely non-Gaussian pairs
        (hard zoo shapes measure 0.4-3.4) from Gaussian ones (<= 0.11).
        Computed on the device from the cached chain, or with ``mesh`` from
        this rank's block with its sums all-reduced, and cached."""
        st = self._fast_chain_state(whole=False)
        if st["cum_score"] is None:
            s, w = self._fast_device_view(range(self.n), mesh)
            st["cum_score"] = _host(pair_cumulant_score(s, w, group=mesh))
        return st["cum_score"]

    def _fast_shard(self, mesh):
        """The fused programs' sharding keywords: none, or ``mesh`` and the
        chain's length."""
        return {} if mesh is None else dict(group=mesh, n_samples=self.samples.shape[0])

    def _fast_device_view(self, idx, mesh=None):
        """Cached device chain restricted to the given parameter columns;
        with ``mesh`` (a process group) this rank's block of them
        (:func:`~getdist_tpu_torch.parallel.mesh.shard_samples`), cut from
        the host chain: with a mesh no card holds the whole chain. The last
        block is cached."""
        idx = list(idx)
        if mesh is None:
            st = self._fast_chain_state()
            s = st["samples"]
            if idx != list(range(self.n)):
                s = s[:, torch.as_tensor(idx, device=s.device)]
            return s, st["weights"]
        st = self._fast_chain_state(whole=False)
        block = st["block"]
        if block is None or block[0] is not mesh or block[1] != idx:
            cols = self.samples if idx == list(range(self.n)) else self.samples[:, idx]
            s, w = shard_samples(mesh, cols, self.weights, device=self.device)
            block = st["block"] = (mesh, idx, s, w)
        return block[2], block[3]

    def fastTriangleDensities(self, params=None, contours=(0.68, 0.95), meanlikes=False, mesh=None):
        """All 1D and all-pairs 2D densities via the fused device pipeline
        (:mod:`getdist_tpu_torch.ops.batched`) on ``self.device``, with this
        chain's hard prior bounds and periodic parameters wired in and the
        JAX package's host rescues. Results follow the fast path's own KDE
        conventions rather than exact reference parity. Returns the (d1, d2)
        dicts of device tensors plus the pair index list; ``d2["regrid"]``
        maps a pair tuple to its rerun's grid, contours and kernel. With
        ``meanlikes`` and loglikes, ``d1["likes"]`` / ``d2["likes"]`` hold
        the mean-likelihood curves and grids.

        Routes (``getdist_tpu/mcsamples.py:2255-2496``):

        * single dispatch, when no pre-pass rescue can fire (no hard limit,
          periodic parameter or like weights, max |corr| below 0.866, and no
          pair at |corr| >= 0.5 measurably non-Gaussian): the 1D and 2D
          stages in one call, then the fragile-pair regrid and the
          clamped-window rescue read off the packed diagnostics;
        * two programs otherwise: the 1D stage and one readback of its
          planning fields; the 2D stage queued with its histograms exported;
          while the card runs it, the host plans the corr-adaptive fine
          regrids (fine > 256 bins, binned by K1's wide kernels) and the
          sheared f64 assists (:meth:`_fast_regrid_plan`), and serves
          hard-limited 1D densities whose kernel spans much of their range
          from the host (:meth:`_fast_rescue_wide_bounded_1d`); the reruns
          (:meth:`_fast_regrid_exec`) reuse the 256-bin histograms; then the
          diagnostics readback, the fragile-pair regrid and the clamped
          rescue (:meth:`_fast_rescue_clamped_pairs`).

        Stage times of the last call (host clock, seconds, in order; the
        card is not synchronized for them) are kept in ``self.fast_profile``,
        and each stage is a ``torch.profiler.record_function`` range named
        ``fast:<stage>``. Its reruns are listed in
        ``self.fast_regrid_groups``: one dict per rerun with its ``fine``
        grid, ``winw``, ``pairs`` (position tuples) and ``bandwidths`` ("program": the
        in-program optimizer at a corr-adaptive grid; "assist": host f64
        sheared; "fragile": host ``getAutoBandwidth2D``; "clamped": the
        saturated-window rescue).

        ``mesh``: a ``torch.distributed`` process group
        (:mod:`getdist_tpu_torch.parallel`; start the ranks with
        ``init_group`` or ``spawn_ranks``). Every rank calls this method on
        the whole chain, so the host statistics and plans are the same on
        each; every device program (programs A and B and each rerun) runs
        on this rank's block of the samples, weights and like weights, its
        sample reductions all-reduced over the group, and each rank returns
        the same result. It takes the two-program route. There is no
        ``use_pallas`` switch: on the card the kernels always run, and a
        chain on the CPU takes their plain versions.
        """
        if self.needs_update:
            self.updateBaseStatistics()
        if params is None:
            idx = list(range(self.n))
        else:
            idx = [self._parAndNumber(p)[0] for p in params]
            if None in idx:
                raise ParamError("Unknown parameter %s" % [p for p, j in zip(params, idx) if j is None])

        profile = {}
        clock = [time.perf_counter()]
        span = [None]

        def stage(label):
            """Close the running stage (if any) and open ``label`` (None: end)."""
            now = time.perf_counter()
            if span[0] is not None:
                profile[span[0][0]] = now - clock[0]
                span[0][1].__exit__(None, None, None)
            clock[0] = now
            span[0] = None
            if label is not None:
                rf = torch.profiler.record_function(f"fast:{label}")
                rf.__enter__()
                span[0] = (label, rf)

        self.fast_regrid_groups = []
        stage("chain_state")
        try:
            out = self._fast_triangle(idx, contours, meanlikes, stage, mesh)
        finally:
            stage(None)
            self.fast_profile = profile
        return out

    def _fast_triangle(self, idx, contours, meanlikes, stage, mesh=None):
        """The routes of :meth:`fastTriangleDensities`; ``stage(label)``
        marks the start of each stage, ``mesh`` shards the device
        programs."""
        pars = [self.paramNames.names[j] for j in idx]
        lo = np.array([p.limmin if p.has_limits_bot else np.nan for p in pars], np.float32)
        hi = np.array([p.limmax if p.has_limits_top else np.nan for p in pars], np.float32)
        per = np.array([bool(getattr(p, "periodic", False)) for p in pars])
        has = bool(np.isfinite(lo).any() or np.isfinite(hi).any() or per.any())
        st = self._fast_chain_state(whole=mesh is None)
        like_w = None
        if meanlikes and self.loglikes is not None:
            if mesh is not None:
                like_w = shard_values(mesh, self._likelihood_weights(), device=self.device)
            else:
                if st["like_weights"] is None:
                    st["like_weights"] = torch.from_numpy(self._likelihood_weights().astype(np.float32)).to(
                        self.device)
                like_w = st["like_weights"]
        # reference smooth_scale = -scale convention: auto bandwidth x scale
        scale_1d = -float(self.smooth_scale_1D) if float(self.smooth_scale_1D) < 0 else 1.0
        scale_2d = -float(self.smooth_scale_2D) if float(self.smooth_scale_2D) < 0 else 1.0
        bs1 = None if scale_1d == 1.0 else scale_1d
        bs2 = None if scale_2d == 1.0 else scale_2d
        dev_s, dev_w = self._fast_device_view(idx, mesh)
        # a sharded 1D stage needs the chain's length (padding moves no N_eff)
        shard_1d = self._fast_shard(mesh)
        p = len(idx)
        pairs = [(a, b) for a in range(p) for b in range(a + 1, p)]
        pairs_arr = np.array(pairs, np.int64).reshape(-1, 2)
        # exact weighted correlations decide the static shear subset (the
        # same 0.15-margin rule as ops.batched._sniff_shear, from the
        # chain's cached correlation matrix)
        corr = np.asarray(self.getCorrelationMatrix())[np.ix_(idx, idx)]
        sel = [k for k, (a, b) in enumerate(pairs) if abs(corr[a, b]) > 0.15]
        enable_shear = False if not sel else (True if len(sel) == len(pairs) else tuple(sel))
        contours_np = np.array(contours, np.float32)
        max_corr = float(self.max_corr_2D)
        k_pairs = len(pairs)
        limits = dict(limits_lo=lo, limits_hi=hi) if has else {}
        per_arg = per if per.any() else None

        # single dispatch when no pre-pass rescue can fire: no hard limit,
        # periodic axis or like weights, no corr-adaptive fine > 256 pair
        # (|corr| >= ~0.87) and no sheared-assist candidate (|corr| >= 0.5
        # AND measurably non-Gaussian)
        abs_corr = np.abs(np.asarray(corr, float))
        np.fill_diagonal(abs_corr, 0.0)
        max_corr_val = float(abs_corr.max(initial=0.0))
        single = mesh is None and not has and like_w is None and max_corr_val < 0.866
        if single and max_corr_val >= 0.5:
            stage("cum_score")
            cum = self._fast_cum_score()[np.ix_(idx, idx)]
            single = not any(abs(corr[a, b]) >= 0.5 and cum[a, b] > 0.25 for a, b in pairs)
        if single:
            stage("program")
            d1, d2 = _triangle_program(
                dev_s, dev_w, pairs_arr[:, 0], pairs_arr[:, 1], contours_np, st["int8"], max_corr=max_corr,
                enable_shear=enable_shear, bandwidth_scale_1d=bs1, bandwidth_scale_2d=bs2,
            )
            d2 = dict(d2)
            stage("diag")
            diag = _host(d2["diag"])
            frag = diag[:k_pairs] > 0.5
            regrid = {}
            if frag.any():
                stage("fragile_regrid")
                plan = self._fast_regrid_plan(idx, pairs, d1, fragile=frag, fragile_only=True)
                regrid = self._fast_regrid_exec(plan, idx, pairs, d1, contours, scale_2d)
            d2["regrid"] = regrid
            stage("clamped_rescue")
            self._fast_rescue_clamped_pairs(
                idx, pairs, d1, d2, contours, scale_2d, rx_host=diag[k_pairs : 2 * k_pairs],
                ry_host=diag[2 * k_pairs : 3 * k_pairs],
            )
            return d1, d2, pairs

        if any(0.5 <= abs(corr[a, b]) <= max_corr for a, b in pairs):
            # the plan's cumulant gate reads this score back: computed before
            # program B is queued, its readback does not wait for B
            stage("cum_score")
            self._fast_cum_score(mesh)
        # program A: all 1D densities, and one readback of the packed
        # planning fields before program B is queued (the same stream), so
        # it waits for program A only
        stage("program_a")
        with torch.no_grad():
            d1 = all_1d_densities(dev_s, dev_w, periodic=per_arg, like_weights=like_w, bandwidth_scale=bs1, **limits,
                                  **shard_1d)
        packed = _host(d1["host_pack"])
        d1h = {
            "neff": packed[:p],
            "sigma_range": packed[p : 2 * p],
            "range0": packed[2 * p : 3 * p],
            "range1": packed[3 * p : 4 * p],
            "bandwidth": packed[4 * p : 5 * p],
        }
        # program B: all-pairs 2D densities with the histograms exported;
        # its tail (AMISE searches, convolutions, contours) runs on the card
        # while the host plans
        stage("program_b")
        with torch.no_grad():
            d2 = all_2d_densities(
                dev_s, dev_w, pairs_arr[:, 0], pairs_arr[:, 1], d1["neff"], d1["range"][0], d1["range"][1],
                contours_np, active_lo=d1["active_lo"] if has else None, active_hi=d1["active_hi"] if has else None,
                periodic=per_arg, int8_weights=st["int8"], bandwidth_scale=bs2, sigma_range=d1["sigma_range"],
                max_corr=max_corr, enable_shear=enable_shear, like_weights=like_w, export_hists=True, **shard_1d,
            )
        d2 = dict(d2)
        hists = d2.pop("hists", None)
        stage("plan")
        plan = self._fast_regrid_plan(idx, pairs, d1, fragile=None, d1_host=d1h, mesh=mesh)
        if has:
            stage("wide_bounded_1d")
            d1 = self._fast_rescue_wide_bounded_1d(idx, d1, lo, hi, d1_host=d1h)
        stage("regrid")
        regrid = self._fast_regrid_exec(plan, idx, pairs, d1, contours, scale_2d, hists=hists, bounded=has,
                                        per=per_arg, mesh=mesh, like_weights=like_w)
        # program B's packed diagnostics (fragile flags + kernel widths in
        # bin units): the route's one readback of program B
        stage("diag")
        diag = _host(d2["diag"])
        frag = diag[:k_pairs] > 0.5
        stage("fragile_regrid")
        plan = self._fast_regrid_plan(idx, pairs, d1, fragile=frag, fragile_only=True, d1_host=d1h, mesh=mesh)
        regrid.update(self._fast_regrid_exec(plan, idx, pairs, d1, contours, scale_2d, hists=hists, bounded=has,
                                             per=per_arg, mesh=mesh, like_weights=like_w))
        d2["regrid"] = regrid
        stage("clamped_rescue")
        self._fast_rescue_clamped_pairs(
            idx, pairs, d1, d2, contours, scale_2d, rx_host=diag[k_pairs : 2 * k_pairs],
            ry_host=diag[2 * k_pairs : 3 * k_pairs], bounded=has, per=per_arg, mesh=mesh, like_weights=like_w,
        )
        return d1, d2, pairs

    def _fast_rescue_wide_bounded_1d(self, idx, d1, lo, hi, d1_host):
        """Serve hard-limited parameters whose kernel spans more than 0.15 of
        their grid from the host convention (``getdist_tpu/mcsamples.py:
        2498-2541``): the fused boundary correction's analytic kernel
        moments drift a few 1e-3 from the reference's masked spatial
        iteration there (zoo 1D shape "flat") while picking the same
        bandwidth. Each such parameter is recomputed on the host at the
        device's width (a fixed smoothing scale in coarse bins) and
        resampled onto the fused grid; returns ``d1`` with the new 'P'.
        ``d1_host``: program A's planning fields, read back."""
        bw = np.asarray(d1_host["bandwidth"], float)
        bmin = np.asarray(d1_host["range0"], float)
        bmax = np.asarray(d1_host["range1"], float)
        span = np.maximum(bmax - bmin, 1e-30)
        bounded = np.isfinite(lo) | np.isfinite(hi)
        flagged = [i for i in range(len(idx)) if bounded[i] and bw[i] / span[i] > 0.15]
        if not flagged:
            return d1
        p_rows = _host(d1["P"]).astype(float)
        x_rows = _host(d1["x"]).astype(float)
        for i in flagged:
            # a fixed smooth_scale_1D >= 1 is in coarse (num_bins) bin units
            par = self._initParamRanges(idx[i])
            coarse_width = (par.range_max - par.range_min) / (self.num_bins - 1)
            width_bins = max(bw[i] / coarse_width, 1.001)
            dens = self.get1DDensityGridData(idx[i], smooth_scale_1D=float(width_bins))
            vals = dens.Prob(np.clip(x_rows[i], dens.x[0], dens.x[-1]))
            peak = vals.max()
            if peak > 0:
                p_rows[i] = vals / peak
        d1 = dict(d1)
        d1["P"] = torch.from_numpy(p_rows).to(d1["P"].device, d1["P"].dtype)
        return d1

    def _fast_rescue_clamped_pairs(self, idx, pairs, d1, d2, contours, scale_2d=1.0, rx_host=None, ry_host=None,
                                   bounded=False, per=None, mesh=None, like_weights=None):
        """Re-run pairs whose kernel width saturated the fused program's
        fixed convolution window (rx/ry at winw/2.5 bins) with a near-half-
        grid window (winw = 126 at 256 bins, a 768 DFT frame), and serve its
        results in ``d2["regrid"]``. The reference sizes its window from the
        bandwidth with no cap (``mcsamples.py:1884`` winw = 2.5 width).
        ``bounded``: the chain's active limits (``d1``) apply; ``per``: (P,)
        periodic flags or None; ``mesh``: the process group of a sharded
        call; ``like_weights``: the mean-likelihood weights, binned at the
        rerun's grid (K1 with f32 weights) into its 'likes'."""
        regrid = d2.get("regrid", {})
        base_cap = 30 / 2.5

        def regrid_cap(entry):
            n_fine = int(entry["P"].shape[0])
            return max(30, int(round(n_fine / 9.0))) / 2.5

        if rx_host is not None:
            rxs, rys = rx_host, ry_host
        else:
            rxs, rys = _host(d2["rx"]), _host(d2["ry"])
        saturated = []
        for k, key in enumerate(pairs):
            entry = regrid.get(key)
            if entry is not None:
                widest = max(float(entry["rx"]), float(entry["ry"]))
                cap = regrid_cap(entry)
            else:
                widest, cap = max(float(rxs[k]), float(rys[k])), base_cap
            if widest >= cap - 1e-3:
                saturated.append(key)
        if not saturated:
            return
        fine = 256
        dev_samples, dev_weights = self._fast_device_view(idx, mesh)
        with torch.no_grad():
            d2w = all_2d_densities(
                dev_samples, dev_weights, np.array([a for a, _ in saturated]), np.array([b for _, b in saturated]),
                d1["neff"], d1["range"][0], d1["range"][1], np.array(contours, np.float32), fine_bins=fine,
                int8_weights=self._fast_chain_state(whole=False)["int8"], bandwidth_scale=None if scale_2d == 1.0 else scale_2d,
                sigma_range=d1["sigma_range"], max_corr=float(self.max_corr_2D), winw=fine // 2 - 2,
                active_lo=d1["active_lo"] if bounded else None, active_hi=d1["active_hi"] if bounded else None,
                periodic=per, like_weights=like_weights, **self._fast_shard(mesh),
            )
        regrid.update(_regrid_entries(d2w, saturated))
        d2["regrid"] = regrid
        self.fast_regrid_groups.append(
            {"fine": fine, "winw": fine // 2 - 2, "pairs": saturated, "bandwidths": "clamped"}
        )

    def _fast_regrid_plan(self, idx, pairs, d1, fragile=None, fragile_only=False, d1_host=None, mesh=None):
        """Host half of the regrid rescue: pick the pairs to re-run at the
        reference's corr-adaptive fine grid (``mcsamples.py:1812-1819``
        scales fine_bins_2D by the degeneracy angle) and compute their f64
        bandwidth overrides. Host numpy and scipy only (besides the cached
        cumulant score). Returns a list of ``(fine, plist, override, kind)``
        groups for :meth:`_fast_regrid_exec`, ``kind`` naming where the
        bandwidths come from ("program", "assist" or "fragile").

        Pairs at |corr| >= 0.5 that are measurably non-Gaussian (cumulant
        score > 0.25), and not both hard-limited, get their bandwidth matrix
        from the host f64 sheared re-binning
        (:meth:`_optimize_bandwidth_sheared`). ``fragile`` (per-pair bools
        from the fused program): pairs whose f32 AMISE correlation search
        sat on a knife edge get theirs from :meth:`getAutoBandwidth2D` at
        256 bins, when the cumulant gate passes too. ``mesh``: the score
        comes from the ranks' blocks (every rank plans alike)."""
        max_corr = float(self.max_corr_2D)
        corr = np.asarray(self.getCorrelationMatrix())[np.ix_(idx, idx)]
        infos = [self.paramNames.names[j] for j in idx]
        cum_cache = [None]

        def limited(k):
            return bool(getattr(infos[k], "has_limits_bot", False) or getattr(infos[k], "has_limits_top", False))


        def cum_gate(a, b):
            if cum_cache[0] is None:
                cum_cache[0] = self._fast_cum_score(mesh)[np.ix_(idx, idx)]
            return cum_cache[0][a, b] > 0.25

        if fragile is not None and fragile.any():
            # gate the device's blind-search flags on the same score
            fragile = np.array([bool(f) and cum_gate(a, b) for f, (a, b) in zip(fragile, pairs)])
        if fragile_only and (fragile is None or not fragile.any()):
            return []

        groups = {}
        for k, (a, b) in enumerate(pairs):
            cc_raw = float(corr[a, b])
            cc = float(np.clip(cc_raw, -max_corr, max_corr))
            fine = 256
            if abs(cc) >= 0.1:
                angle_scale = max(0.2, np.sqrt(1 - min(max_corr, abs(cc)) ** 2))
                if int(1 / angle_scale) > 1:
                    scaled = 192 * int(3 / angle_scale) // 3
                    if scaled > 256:
                        fine = scaled
            # the O(N)-per-pair host re-binning assist is reserved for pairs
            # that are both strongly correlated and measurably non-Gaussian
            assist = 0.5 <= abs(cc_raw) <= max_corr and not (limited(a) and limited(b)) and cum_gate(a, b)
            frag = bool(fragile is not None and fragile[k]) and not assist
            if fragile_only:
                if frag:
                    groups.setdefault((fine, False, True), []).append((a, b))
            elif fine > 256 or assist or frag:
                groups.setdefault((fine, assist, frag), []).append((a, b))
        neff_h = d1_host["neff"] if d1_host else _host(d1["neff"])
        plan = []
        for (fine, assist, frag), plist in groups.items():
            override = None
            kind = "assist" if assist else "fragile" if frag else "program"
            if assist:
                sigma_range = d1_host["sigma_range"] if d1_host else _host(d1["sigma_range"])
                override = zip(*(self._assist_bandwidths(idx, a, b, corr, sigma_range, float(min(neff_h[a], neff_h[b])))
                                 for a, b in plist))
            elif frag:
                override = zip(*(self._fragile_bandwidths(idx, a, b, float(min(neff_h[a], neff_h[b])))
                                 for a, b in plist))
            if override is not None:
                override = tuple(np.array(v, float) for v in override)
            plan.append((fine, plist, override, kind))
        return plan

    def _assist_bandwidths(self, idx, a, b, corr, sigma_range, pair_neff):
        """(hx, hy, c) of a sheared-assist pair: the host f64 sheared
        optimizer at 256 bins, with the reference's optimizer-failure
        fallback (plug-in widths at the clipped sample correlation) and the
        multiplicative-bias widening."""
        max_corr = float(self.max_corr_2D)
        parx = self._initParamRanges(idx[a])
        pary = self._initParamRanges(idx[b])
        try:
            wx, wy, cc = self._optimize_bandwidth_sheared(parx, pary, idx[a], idx[b], pair_neff, 256)
        except ValueError:
            plug = pair_neff ** (-1.0 / 6)
            wx, wy = sigma_range[a] * plug, sigma_range[b] * plug
            cc = np.clip(corr[a, b], -max_corr, max_corr)
        order = int(self.mult_bias_correction_order)
        if order:
            rescale = 1.1 * pair_neff ** (1.0 / 6 - 1.0 / (2 + 4 * (1 + order)))
            wx, wy = wx * rescale, wy * rescale
        return wx, wy, cc

    def _fragile_bandwidths(self, idx, a, b, pair_neff):
        """(hx, hy, c) of a fragile pair: the reference branch itself
        (:meth:`getAutoBandwidth2D` on the host 256-bin histogram)."""
        parx = self._initParamRanges(idx[a])
        pary = self._initParamRanges(idx[b])
        _, actual_corr = self._pair_correlation(idx[a], idx[b], parx, pary)
        ix_, _sx, x_lo, x_hi = self._binSamples(self.samples[:, idx[a]], parx, 256)
        iy_, _sy, y_lo, y_hi = self._binSamples(self.samples[:, idx[b]], pary, 256)
        hist, _ = self._make2Dhist(ix_, iy_, 256, 256)
        return self.getAutoBandwidth2D(
            hist, parx, pary, idx[a], idx[b], actual_corr, x_hi - x_lo, y_hi - y_lo, 256,
            mult_bias_correction_order=self.mult_bias_correction_order, N_eff=pair_neff,
        )

    def _fast_regrid_exec(self, plan, idx, pairs, d1, contours, scale_2d=1.0, hists=None, bounded=False, per=None,
                          mesh=None, like_weights=None):
        """Device half of the regrid rescue: re-run each planned group
        through :func:`all_2d_densities` with its bandwidth override and a
        window of max(30, fine / 9) bins. ``hists`` (program B's exported
        256-bin histograms) lets fine = 256 groups skip the re-binning; past
        256 bins the rerun bins in-program (K1's wide kernels on int16 rows).
        ``bounded``: the chain's active limits (``d1``) apply; ``per``: (P,)
        periodic flags or None; ``mesh``: the process group of a sharded
        call (the exported histograms are global); ``like_weights``: the
        mean-likelihood weights, binned at the rerun's grid into its
        'likes'."""
        regrid = {}
        if not plan:
            return regrid
        pair_pos = {key: k for k, key in enumerate(pairs)}
        dev_samples, dev_weights = self._fast_device_view(idx, mesh)
        int8 = self._fast_chain_state(whole=False)["int8"]
        for fine, plist, override, kind in plan:
            winw = max(30, int(round(fine / 9.0)))
            hin = None
            if hists is not None and fine == 256:
                hin = hists[torch.as_tensor([pair_pos[key] for key in plist], device=hists.device)]
            with torch.no_grad():
                d2x = all_2d_densities(
                    dev_samples, dev_weights, np.array([a for a, _ in plist]), np.array([b for _, b in plist]),
                    d1["neff"], d1["range"][0], d1["range"][1], np.array(contours, np.float32), fine_bins=fine,
                    int8_weights=int8, bandwidth_scale=None if scale_2d == 1.0 else scale_2d,
                    bandwidth_override=override, sigma_range=d1["sigma_range"], max_corr=float(self.max_corr_2D),
                    winw=winw, hists_in=hin, active_lo=d1["active_lo"] if bounded else None,
                    active_hi=d1["active_hi"] if bounded else None, periodic=per, like_weights=like_weights,
                    **self._fast_shard(mesh),
                )
            regrid.update(_regrid_entries(d2x, plist))
            self.fast_regrid_groups.append({"fine": fine, "winw": winw, "pairs": plist, "bandwidths": kind})
        return regrid

    # -- parity mode ---------------------------------------------------------------------------

    def _parity_chain(self):
        """The chain on ``self.device`` for parity mode: f64 samples and
        weights, whether every weight is a non-negative integer with a total
        below 2^31 (the kernels then accumulate exactly in int32), and the
        histogram kernels' weights: integer weights narrowed to uint8 where
        they fit (``pair_hist.narrow_weights``, a quarter of the f32
        stream), else f32. Cached until the samples change."""
        st = self._parity_chain_cache
        if st is None:
            w = self.weights
            integer = bool(w.size and np.all(w == np.round(w)) and w.min() >= 0 and float(w.sum()) < 2**31)
            w32 = torch.from_numpy(w.astype(np.float32)).to(self.device)
            st = {
                "samples": torch.from_numpy(self.samples).to(self.device),
                "weights": torch.from_numpy(w).to(self.device),
                "hist_weights": narrow_weights(w32) if integer else w32,
                "integer": integer,
            }
            self._parity_chain_cache = st
        return st

    def _parity_pairs(self, idx, infos):
        """Each pair's corr-adaptive fine size, grouped: ({fine: [(a, b,
        corr)]}, the (a, b) positions whose sheared branch of
        getAutoBandwidth2D is batched; with ``use_effective_samples_2D``
        none is, and each takes the branch's per-pair host pass)."""
        pair_fine = {}
        sheared_jobs = []
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                corr, actual_corr = self._pair_correlation(idx[a], idx[b], infos[a], infos[b])
                fine, _nbin2d = self._degeneracy_adapted_bins(corr, self.fine_bins_2D)
                pair_fine.setdefault(fine, []).append((a, b, actual_corr))
                both_limited = infos[a].has_limits and infos[b].has_limits
                if 0.2 < abs(actual_corr) <= self.max_corr_2D and not both_limited and not self.use_effective_samples_2D:
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
        values and bandwidth matrices feed batched f64 2D convolution
        programs on the chain's torch device.

        ``device=True`` (:meth:`_parity_densities_device`): every O(N) pass
        (binning, exact pair histograms, sheared residuals, autocorrelation
        lengths, N_eff lag sums) and the 2D convolutions run on
        ``self.device``, and only compact per-pair histograms return to the
        host-exact bandwidth optimizers. With ``materialize=False`` the 2D
        grids stay on the device and the return is ``(dens1, groups)``.
        Chains whose weights the device histograms cannot sum exactly go to
        the host variant.

        ``device=False`` (:meth:`_parity_densities_host`): the O(N) passes
        on the host (numpy and the native pair-histogram pass), the
        convolutions on ``self.device``; it takes any weights, and
        ``materialize`` does not apply.

        Both pin the means, variances and covariance to numpy
        (:meth:`_pin_host_stats`), whatever ``GETDIST_TPU_TORCH_DEVICE_OPS``
        says.

        :return: ({name: Density1D}, {(name_a, name_b): Density2D})
        """
        self._pin_host_stats()
        if not device:
            return self._parity_densities_host(params, contours)
        return self._parity_densities_device(params, contours, materialize=materialize)

    def _pin_host_stats(self):
        """Pin the means, variances, covariance and correlation to numpy
        (``_force_host_stats``) and recompute any computed on the device
        route: scipy's bandwidth optimizers move by their own ~1e-4
        tolerance under a 1-ulp change of their inputs, which parity keeps
        bit-identical to the JAX package's."""
        self._force_host_stats = True
        if not getattr(self, "_stats_from_device", False):
            return
        self._stats_from_device = False
        self.means = self.vars = self.fullcov = self.correlationMatrix = None
        self._param_range_cache = {}
        if not self.needs_update:
            self.updateBaseStatistics()

    def _parity_densities_1d(self, idx, infos):
        """Parity mode's 1D densities: the byte-exact host path, reusing the
        primed N_eff caches; never the fused route, whose conventions are
        not the reference's."""
        if self.needs_update:
            self.updateBaseStatistics()
        return {info.name: self._host_1d_density(j) for j, info in zip(idx, infos)}

    @staticmethod
    def _parity_grid_edges(infos):
        """(binmin, binmax) per parameter: the reference ``_binSamples``
        range (a hard limit, periodic or not, is its grid's edge)."""

        def grid_edge(par):
            pad = (par.range_max - par.range_min) * 0.1
            bmin = min(par.param_min, par.range_min) - (0 if par.has_limits_bot else pad)
            bmax = max(par.param_max, par.range_max) + (0 if par.has_limits_top else pad)
            return bmin, bmax

        edges = np.array([grid_edge(info) for info in infos])
        return edges[:, 0], edges[:, 1]

    def _parity_mark(self, profile):
        """A ``mark(label)`` that records the seconds since the previous
        mark under ``label`` (the card synchronized first)."""
        clock = [time.perf_counter()]

        def mark(label):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            profile[label] = now - clock[0]
            clock[0] = now

        return mark

    def _parity_bandwidth_entry(self, hist, infos, idx, a, b, actual_corr, binmin, binmax, fine, sheared_result, k):
        """One pair's (a, b, hx, hy, c, winw, k) from
        :meth:`getAutoBandwidth2D`: host-exact bandwidths, and the
        reference's kernel window 2.5 widths wide in the pair's fine bins."""
        scale_2d = abs(float(self.smooth_scale_2D))
        hx, hy, c = self.getAutoBandwidth2D(
            hist, infos[a], infos[b], idx[a], idx[b], actual_corr, binmax[a] - binmin[a], binmax[b] - binmin[b],
            self.fine_bins_2D, mult_bias_correction_order=self.mult_bias_correction_order,
            sheared_result=sheared_result,
        )
        rx = hx * scale_2d / ((binmax[a] - binmin[a]) / (fine - 1))
        ry = hy * scale_2d / ((binmax[b] - binmin[b]) / (fine - 1))
        return a, b, hx, hy, c, max(1, int(round(2.5 * max(rx, ry)))), k

    def _parity_convolve(self, infos, groups, binmin, binmax, neff, contours, samples, weights, pair_hists,
                         materialize=True):
        """The f64 2D programs of both parity variants: each fine group's
        pairs (``groups``: {fine: [(a, b, hx, hy, c, winw, k)]}) bucketed by
        window level (:meth:`_parity_winw_level`), one
        :func:`all_2d_densities` per bucket with the host-exact bandwidths,
        the reference's kernel supports, the exact mult-bias mask, and the
        chain's active limits and periodic axes (``samples`` (N, P) and
        ``weights`` on the programs' device; they read neither, as the
        histograms come in). ``pair_hists(fine, rows)``: the bucket's
        (K, fine, fine) f64 histograms on that device, rows k of the fine
        group. Returns {(name_a, name_b): Density2D}, or the device groups
        with ``materialize=False``; the buckets go to
        ``self.parity_buckets``."""
        names = [info.name for info in infos]
        scale_2d = abs(float(self.smooth_scale_2D))
        active_lo = np.array([info.has_limits_bot for info in infos])
        active_hi = np.array([info.has_limits_top for info in infos])
        per = np.array([bool(getattr(info, "periodic", False)) for info in infos])
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
            with torch.no_grad():
                d2 = all_2d_densities(
                    samples,
                    weights,
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
                    periodic=per if per.any() else None,
                    sigma_range=sigma,
                    max_corr=float(self.max_corr_2D),
                    enable_shear=False,  # bandwidths are host-exact overrides
                    exact_mult_bias=True,
                    hists_in=pair_hists(fine, [entry[6] for entry in plist]),
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
        return dens2 if materialize else out_groups

    def _sheared_bandwidths_batch(self, jobs, nbins):
        """The sheared 2D bandwidths of many pairs (the JAX package's
        method of the same name, ``mcsamples.py:3429-3505``; one pair is
        :meth:`_optimize_bandwidth_sheared`): per pair, the Cholesky shear
        of (lead, other), the lead's and the residual's ``kde.bin_samples``
        binning (the residual rows vectorized across pairs), their 2D
        histogram from the native pass
        (:func:`getdist_tpu_torch._native.pair_histograms`, bit-identical to
        ``_make2Dhist``), ``KernelOptimizer2D`` and the unshear. ``jobs``:
        list of (parx, pary, paramx, paramy, N_eff). Returns ``{(paramx, paramy): (hx, hy, c) | ValueError}``;
        a failure carries the exception so the caller applies the
        reference's fallback."""
        out = {}
        lead_cache = {}
        chunk_size = 24  # (24, N) f64 residual rows at a time
        n = self.samples.shape[0]
        for start in range(0, len(jobs), chunk_size):
            chunk = jobs[start : start + chunk_size]
            metas = []
            resid_rows = np.empty((len(chunk), n), np.float64)
            for i, (parx, pary, paramx, paramy, n_eff) in enumerate(chunk):
                lead_par, other = (pary, paramx) if pary.has_limits else (parx, paramy)
                lead = paramy if pary.has_limits else paramx
                root = np.linalg.cholesky(self.getCov(pars=[lead, other]))
                resid_rows[i] = (root[0, 0] * self.samples[:, other] - root[1, 0] * self.samples[:, lead]) / root[1, 1]
                if lead not in lead_cache:
                    lead_cache[lead] = kde.bin_samples(
                        self.samples[:, lead], nbins=nbins,
                        range_min=lead_par.range_min if lead_par.has_limits_bot else None,
                        range_max=lead_par.range_max if lead_par.has_limits_top else None,
                    )
                metas.append((parx, pary, paramx, paramy, n_eff, lead, root / root[0, 0]))
            # kde.bin_samples per row, vectorized: the same elementwise
            # arithmetic (extent, 10% pad, (x - lo) / dx truncated)
            lo = resid_rows.min(axis=1)
            hi = resid_rows.max(axis=1)
            pad = (hi - lo) * 0.1
            rmin = lo - pad
            width = (hi + pad) - rmin
            dx = width / (nbins - 1)
            resid_ix = ((resid_rows - rmin[:, None]) / dx[:, None]).astype(int)
            leads = sorted({m[5] for m in metas})
            lead_pos = {lead: i for i, lead in enumerate(leads)}
            ix_rows = np.concatenate([np.stack([lead_cache[lead][0] for lead in leads]), resid_ix], axis=0)
            hists = _native.pair_histograms(
                ix_rows, self.weights, [(lead_pos[m[5]], len(leads) + i) for i, m in enumerate(metas)], nbins
            )
            for i, (parx, pary, paramx, paramy, n_eff, lead, unshear) in enumerate(metas):
                try:
                    opt = kde.KernelOptimizer2D(hists[i], n_eff, 0, do_correlation=not (parx.has_limits or pary.has_limits))
                    h1, h2, c12 = opt.get_h()
                except ValueError as e:
                    out[(paramx, paramy)] = e
                    continue
                h1 *= lead_cache[lead][1]
                h2 *= width[i]
                kernel_cov = unshear @ np.array([[h1 * h1, h1 * h2 * c12], [h1 * h2 * c12, h2 * h2]]) @ unshear.T
                widths = np.sqrt(kernel_cov.diagonal())
                c = kernel_cov[0, 1] / (widths[0] * widths[1])
                out[(paramx, paramy)] = (widths[1], widths[0], c) if pary.has_limits else (widths[0], widths[1], c)
        return out

    def _parity_densities_host(self, params=None, contours=None):
        """The host parity variant (counterpart of the JAX package's
        ``fastParityDensities(device=False)``, ``mcsamples.py:1349-1542``),
        for any weights (fractional, negative, or summing past 2^24, as
        nested samplers and importance reweighting write them): the N_eff
        caches warmed by a thread pool, the host 1D densities, per-pair
        corr-adaptive fine grids with their pair histograms from the native
        pass (one call per fine group, bit-identical to ``np.bincount``),
        the sheared branch batched (:meth:`_sheared_bandwidths_batch`), the
        host-exact :meth:`getAutoBandwidth2D`, then the ``winw_level``
        buckets of f64 convolution programs (:meth:`_parity_convolve`).

        The JAX package runs those programs on its x64 CPU backend, since a
        TPU has no native f64; the card has (DMMA), so the port keeps the
        algorithm and runs them on ``self.device``: f64 K2/K3 on the card,
        their plain versions for a CPU chain. Stage times of the last call
        are kept in ``self.parity_profile``."""
        if float(self.smooth_scale_2D) >= 0 or float(self.smooth_scale_1D) >= 0:
            raise SettingError("parity mode supports the auto-bandwidth smooth_scale settings only")
        if self.needs_update:
            self.updateBaseStatistics()
        idx = list(range(self.n)) if params is None else [self._parAndNumber(q)[0] for q in params]
        contours = np.asarray(self.contours if contours is None else contours, float)
        profile = {}
        mark = self._parity_mark(profile)
        infos = [self._initParamRanges(j) for j in idx]
        mark("ranges")

        # warm the per-parameter N_eff caches concurrently (numpy releases
        # the GIL; each parameter's own arithmetic is unchanged), then the
        # host 1D densities reuse them
        self.get_norm()
        workers = max(1, min(8, os.cpu_count() or 1))
        if workers > 1 and len(idx) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(lambda ji: self._get1DNeff(ji[1], ji[0]), zip(idx, infos)))
        neff = np.array([self._get1DNeff(info, j) for j, info in zip(idx, infos)])
        mark("neff")
        dens1 = self._parity_densities_1d(idx, infos)
        mark("1d_host")

        binmin, binmax = self._parity_grid_edges(infos)
        pair_fine, sheared_pairs = self._parity_pairs(idx, infos)
        jobs = [(infos[a], infos[b], idx[a], idx[b], float(min(neff[a], neff[b]))) for a, b in sheared_pairs]
        sheared_results = self._sheared_bandwidths_batch(jobs, self.fine_bins_2D) if jobs else {}
        mark("sheared")

        groups, hists = {}, {}
        for fine, members in pair_fine.items():
            params_in = sorted({k for a, b, _ in members for k in (a, b)})
            local = {k: i for i, k in enumerate(params_in)}
            ix_rows = np.stack([self._binSamples(self.samples[:, idx[k]], infos[k], fine)[0] for k in params_in])
            hists[fine] = _native.pair_histograms(ix_rows, self.weights, [(local[a], local[b]) for a, b, _ in members],
                                                  fine)
            groups[fine] = [
                self._parity_bandwidth_entry(hists[fine][k], infos, idx, a, b, actual_corr, binmin, binmax, fine,
                                             sheared_results.get((idx[a], idx[b])), k)
                for k, (a, b, actual_corr) in enumerate(members)
            ]
        mark("hists_bandwidths")

        # the programs read the histograms and the host bandwidths only: a
        # (0, P) chain stands in for the samples, which stay on the host
        empty = torch.zeros((0, len(idx)), dtype=torch.float64, device=self.device)
        dens2 = self._parity_convolve(
            infos, groups, binmin, binmax, neff, contours, empty, empty[:, 0],
            lambda fine, rows: torch.from_numpy(hists[fine][rows]).to(self.device),
        )
        mark("conv_materialize")
        self.parity_profile = profile
        return dens1, dens2

    def _parity_densities_device(self, params=None, contours=None, materialize=True):
        """Device parity mode (counterpart of the JAX package's method of
        the same name, ``mcsamples.py:1580-2108``).

        Its device histograms are exact only for integral, f32-representable,
        non-negative weights with a total below 2^24 (the JAX package's
        bound); any other chain goes to :meth:`_parity_densities_host` with
        a warning, and raises with ``materialize=False``. Periodic
        parameters take the 2D programs' periodic fold and extension.

        TPU workarounds of the JAX method not carried over: the uint16
        ``_compact_readback`` and the two readback threads (built for a
        slow host link; histograms are read back as f64 and the host
        optimizers run in the same order without threads), the f32
        convolution choice and the 1152 DFT-frame cap (the card runs K2/K3
        in f64 at any frame), and the environment switches (no switch is
        added).

        Stage times of the last call are kept in ``self.parity_profile``
        (seconds, in order), and its convolution buckets (fine grid, window
        half-width, pair count) in ``self.parity_buckets``. With
        ``materialize=False`` each group of the return is a dict with keys
        ``pairs`` (list of name tuples), ``P`` ((K, fine, fine) device
        grids), ``contours`` ((K, C) device water levels), ``ranges``
        (per-pair ((xmin, xmax), (ymin, ymax))) and ``fine``.
        """
        if float(self.smooth_scale_2D) >= 0 or float(self.smooth_scale_1D) >= 0:
            raise SettingError("parity mode supports the auto-bandwidth smooth_scale settings only")
        w_all = np.asarray(self.weights)
        weights_device_exact = bool(
            w_all.size == 0
            or (
                np.all(np.float32(w_all) == w_all)
                and np.all(w_all == np.round(w_all))
                and w_all.min() >= 0
                and float(w_all.sum()) < 2**24
            )
        )
        if not weights_device_exact:
            if not materialize:
                raise MCSamplesError(
                    "parity device mode with materialize=False needs integral f32-representable weights (sum < 2**24) "
                    "for exact device histograms; this chain's weights are fractional, negative or f32-lossy, or sum "
                    "past 2**24: use materialize=True (host variant) or fastParityDensities(device=False)"
                )
            logging.warning(
                "parity device mode: weights are fractional, negative or not exactly f32-representable, or sum past "
                "2**24; device histograms would not be host-exact, so the host parity variant serves this chain"
            )
            return self._parity_densities_host(params, contours)
        if self.needs_update:
            self.updateBaseStatistics()
        idx = list(range(self.n)) if params is None else [self._parAndNumber(q)[0] for q in params]
        contours = np.asarray(self.contours if contours is None else contours, float)

        profile = {}
        mark = self._parity_mark(profile)
        infos = [self._initParamRanges(j) for j in idx]
        mark("ranges")
        st = self._parity_chain()
        dev_s64, dev_w64, dev_hist_w = st["samples"], st["weights"], st["hist_weights"]
        mark("chain_state")

        binmin, binmax = self._parity_grid_edges(infos)
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
                dev_hist_w,
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
        dens1 = self._parity_densities_1d(idx, infos)
        mark("1d_host")

        # -- sheared bandwidths: device residual binning + host optimizer ----
        sheared_results = {}
        if sheared_jobs:
            stack = self._sheared_stack(idx, infos, sheared_jobs, sub64)
            sh_hists = pdev.group_pair_hists(
                stack["ix"], stack["pair_a"], stack["pair_b"], dev_hist_w, self.fine_bins_2D, st["integer"]
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
            groups[fine] = [
                self._parity_bandwidth_entry(host.get(k), infos, idx, a, b, actual_corr, binmin, binmax, fine,
                                             sheared_results.get((idx[a], idx[b])), k)
                for k, (a, b, actual_corr) in enumerate(members)
            ]
        mark("bandwidths")

        # -- f64 convolution programs with host-bandwidth overrides ------------
        out = self._parity_convolve(
            infos, groups, binmin, binmax, neff, contours, sub64, dev_w64,
            lambda fine, rows: group_hists[fine][torch.as_tensor(rows, device=self.device)].to(torch.float64),
            materialize=materialize,
        )
        mark("conv_dispatch" if not materialize else "conv_materialize")
        self.parity_profile = profile
        return dens1, out


def getRootFileName(rootdir):
    """Root name of the chain files found in a directory."""
    root_file_name = ""
    for sep in ("_", "."):
        chain_files = glob.glob(os.path.join(rootdir, "*" + sep + "*.txt"))
        if chain_files:
            chain_file0 = chain_files[0]
            rindex = chain_file0.rindex(sep)
            root_file_name = chain_file0[:rindex]
            break
    return root_file_name
