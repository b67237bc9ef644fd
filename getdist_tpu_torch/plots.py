"""Publication plotting: triangle/corner, 2D contour, scatter, and 4D plots
(the port's copy of ``getdist_tpu/plots.py``).

Host-side layer (API-compatible with reference ``getdist/plots.py``)
consuming the port's Density1D/Density2D grids: figure orchestration over
matplotlib, line/contour style cycling, axis-limit negotiation against
hard priors, legends, and the named style registry. Root names resolve to
samples through :class:`~.sample_analysis.MCSampleAnalysis` (re-exported
here), which imports no matplotlib; its samples load on the plotter's
``device``, the card unless the caller names the CPU, where their density
queries are served by one fused program run.
"""

import copy
import logging
import os
import sys
import warnings
from collections.abc import Mapping, Sequence
from itertools import combinations

import matplotlib

_headless = (
    "linux" in sys.platform
    and not os.environ.get("DISPLAY")
    and all(tag not in matplotlib.rcParams["backend"] for tag in ("inline", "ipykern"))
)
if _headless:
    matplotlib.use("Agg")

import matplotlib.axis
import matplotlib.colors
import matplotlib.gridspec
import matplotlib.lines
import matplotlib.patches
import matplotlib.pyplot as plt
import numpy as np
from matplotlib import cm, rcParams
from matplotlib.font_manager import font_scalings
from matplotlib.ticker import ScalarFormatter

import getdist_tpu_torch
from getdist_tpu_torch._base import _BaseObject
from getdist_tpu_torch.densities import Density2D
from getdist_tpu_torch.gaussian_mixtures import MixtureND
from getdist_tpu_torch.matplotlib_ext import BoundedMaxNLocator, SciFuncFormatter
from getdist_tpu_torch.mcsamples import MCSamples
from getdist_tpu_torch.paramnames import ParamInfo, ParamNames, escapeLatex, makeList, mergeRenames
from getdist_tpu_torch.sample_analysis import GetDistPlotError, MCSampleAnalysis, RootInfo  # noqa: F401 (re-exported)
from getdist_tpu_torch.types import empty_dict


_list_like = (list, tuple)


def _as_cycle(value):
    # broadcast helper: scalars become one-element lists that repeat forever
    return list(value) if isinstance(value, (list, tuple)) else [value]


def extend_list_zip(*args):
    """Zip where scalars repeat and short lists are padded with their last
    element; the first argument sets the output length."""
    columns = [_as_cycle(a) for a in args]
    for row in range(len(columns[0])):
        yield [col[min(row, len(col) - 1)] for col in columns]


# default value of every public GetDistPlotSettings knob (reference
# ``plots.py:58-251`` documents each); list/dict values are copied per
# instance in __init__
_PLOT_SETTING_DEFAULTS = dict(
    scaling=True,
    scaling_reference_size=3.5,
    scaling_factor=2,
    direct_scaling=False,
    plot_meanlikes=False,
    prob_label=None,
    norm_prob_label="P",
    prob_y_ticks=False,
    norm_1d_density=False,
    line_styles=["-k", "-r", "-b", "-g", "-m", "-c", "-y", "--k", "--r", "--b", "--g", "--m"],
    plot_args=None,
    line_dash_styles={"--": (3, 2), "-.": (4, 1, 1, 1)},
    line_labels=True,
    num_shades=80,
    shade_level_scale=1.8,
    progress=False,
    tight_layout=True,
    constrained_layout=False,
    no_triangle_axis_labels=True,
    colormap="Blues",
    colormap_scatter="jet",
    colorbar_tick_rotation=None,
    colorbar_label_pad=0.0,
    colorbar_label_rotation=-90.0,
    colorbar_axes_fontsize=11.0,
    subplot_size_ratio=None,
    param_names_for_labels=None,
    legend_colored_text=False,
    legend_loc="best",
    legend_frac_subplot_margin=0.05,
    legend_fontsize=12.0,
    legend_frame=True,
    legend_rect_border=False,
    figure_legend_loc="upper center",
    figure_legend_frame=True,
    figure_legend_ncol=0,
    linewidth=1.0,
    linewidth_contour=0.6,
    linewidth_meanlikes=0.5,
    num_plot_contours=2,
    solid_contour_palefactor=0.6,
    solid_colors=["#006FED", "#E03424", "gray", "#009966", "#000866", "#336600", "#006633", "m", "r"],
    alpha_filled_add=0.85,
    alpha_factor_contour_lines=0.5,
    shade_meanlikes=False,
    axes_fontsize=11.0,
    axes_labelsize=14.0,
    axis_marker_color="gray",
    axis_marker_ls="--",
    axis_marker_lw=0.5,
    axis_tick_powerlimits=(-4, 5),
    axis_tick_max_labels=7,
    axis_tick_step_groups=[[1, 2, 5, 10], [2.5, 3, 4, 6, 8], [1.5, 7, 9]],
    axis_tick_x_rotation=0.0,
    axis_tick_y_rotation=0.0,
    scatter_size=3.0,
    fontsize=12.0,
    title_limit=0,
    title_limit_labels=True,
    title_limit_fontsize=None,
)


class GetDistPlotSettings(_BaseObject):
    """Plot style settings (colors, sizes, fonts, contours...).

    See the reference documentation (``plots.py:58-301``) for the meaning
    of each knob; the attribute set and defaults here are identical so
    existing getdist plot scripts are drop-in.
    """

    _deprecated = {
        "lab_fontsize": "axes_labelsize",
        "colorbar_rotation": "colorbar_tick_rotation",
        "font_size ": "fontsize",
        "legend_frac_subplot_line": None,
        "legend_position_config": None,
        "lineM": "line_styles",
        "lw1": "linewidth",
        "lw_contour": "linewidth_contour",
        "lw_likes": "linewidth_meanlikes",
        "thin_long_subplot_ticks": None,
        "tick_prune": None,
        "tight_gap_fraction": None,
        "x_label_rotation": "axis_tick_x_rotation",
    }

    def __init__(self, subplot_size_inch: float = 2, fig_width_inch: float | None = None):
        """
        :param subplot_size_inch: subplot size (determines default fonts)
        :param fig_width_inch: if set, fixed total figure width in inches
        """
        for knob, value in _PLOT_SETTING_DEFAULTS.items():
            # fresh containers per instance so edits never leak between plotters
            setattr(self, knob, copy.copy(value) if isinstance(value, (list, dict)) else value)
        self.scaling_max_axis_size: float | None = self.scaling_reference_size
        self.fig_width_inch = fig_width_inch
        self.subplot_size_inch: float = subplot_size_inch
        self._fail_on_not_exist = True

    def _fontsize_points(self, size):
        size = size or self.fontsize or 11
        if not isinstance(size, str):
            return size or self.fontsize
        return self.fontsize * (font_scalings.get(size) or 1)

    def scaled_fontsize(self, ax_size, var, default=None):
        """Font size scaled for the given axis size (inches)."""
        pts = self._fontsize_points(var or default)
        cap = self.scaling_max_axis_size
        if not self.scaling or (cap is not None and not cap):
            return pts
        reference = self.scaling_reference_size
        if cap is not None and ax_size >= (cap or reference):
            return pts + 2 * (cap - reference)
        if self.direct_scaling:
            return pts * ax_size / reference
        return max(5, pts + self.scaling_factor * (ax_size - reference))

    def scaled_linewidth(self, ax_size, linewidth):
        """Line width scaled for the given axis size (inches)."""
        width = linewidth or self.linewidth
        if self.scaling:
            width = max(0.6, width * ax_size / self.scaling_reference_size)
        return width

    def set_with_subplot_size(self, size_inch=3.5, size_mm=None, size_ratio=None):
        """Set subplot size in inches (or millimeters)."""
        self.subplot_size_inch = size_mm * 0.0393700787 if size_mm else size_inch
        self.subplot_size_ratio = size_ratio

    def rc_sizes(self, axes_fontsize=None, lab_fontsize=None, legend_fontsize=None):
        """Take font sizes from matplotlib rcParams defaults."""
        pick = self._fontsize_points
        self.fontsize = pick(rcParams["font.size"])
        self.legend_fontsize = legend_fontsize or pick(rcParams["legend.fontsize"])
        self.axes_labelsize = lab_fontsize or pick(rcParams["axes.labelsize"])
        self.axes_fontsize = axes_fontsize or pick(rcParams["xtick.labelsize"])

    def __str__(self):
        public = {k: v for k, v in self.__dict__.items() if not k.startswith("_")}
        return str(public)


default_settings = GetDistPlotSettings()
defaultSettings = default_settings


def get_plotter(style: str | None = None, **kwargs):
    """New plotter for the active (or named) style; ``kwargs`` go to its
    constructor (``chain_dir``, ``device``: the card unless the caller
    names the CPU, ...)."""
    cls = _style_manager.active_class(style)
    return cls(**kwargs)


def get_single_plotter(ratio=None, width_inch=None, scaling=None, rc_sizes=False, style: str | None = None, **kwargs):
    """Plotter for a single fixed-width plot (see reference
    ``plots.py:319-347``); ``kwargs`` (``chain_dir``, ``device``, ...) go
    to the plotter's constructor."""
    cls = _style_manager.active_class(style)
    return cls.get_single_plotter(ratio=ratio, width_inch=width_inch, scaling=scaling, rc_sizes=rc_sizes, **kwargs)


def get_subplot_plotter(
    subplot_size=None, width_inch=None, scaling=None, rc_sizes=False, subplot_size_ratio=None, style=None, **kwargs
) -> "GetDistPlotter":
    """Plotter for an array of subplots (see reference ``plots.py:350-386``);
    ``kwargs`` (``chain_dir``, ``device``, ...) go to the plotter's
    constructor."""
    cls = _style_manager.active_class(style)
    return cls.get_subplot_plotter(
        subplot_size=subplot_size,
        width_inch=width_inch,
        scaling=scaling,
        rc_sizes=rc_sizes,
        subplot_size_ratio=subplot_size_ratio,
        **kwargs,
    )


getPlotter = get_plotter
getSubplotPlotter = get_subplot_plotter
getSinglePlotter = get_single_plotter



class GetDistPlotter(_BaseObject):
    """Main class for making plots from one or more sets of samples.

    :ivar settings: a :class:`GetDistPlotSettings` instance
    :ivar subplots: 2D array of matplotlib Axes
    :ivar sample_analyser: the :class:`MCSampleAnalysis` resolving root names
    """

    _style_rc = {}

    def __init__(self, chain_dir=None, settings=None, analysis_settings=None, auto_close=False, device="cuda"):
        """
        :param chain_dir: directory (or grid hierarchy, or list) to search for chains
        :param settings: optional GetDistPlotSettings
        :param analysis_settings: settings for sample analysis
        :param auto_close: close the figure when a new plot is made
        :param device: torch device the roots' samples load on (their
            densities are computed there), the card unless the caller names
            the CPU
        """
        self.chain_dir = chain_dir
        if settings is None:
            self.set_default_settings()
        else:
            self.settings = settings
        self.sample_analyser = MCSampleAnalysis(chain_dir or getdist_tpu_torch.default_grid_root, analysis_settings,
                                                device=device)
        self.auto_close = auto_close
        self.fig = None
        self.new_plot()

    def set_default_settings(self):
        self.settings = copy.deepcopy(default_settings)

    def new_plot(self, close_existing=None):
        """Reset for a new empty plot."""
        if (self.auto_close if close_existing is None else close_existing) and self.fig:
            plt.close(self.fig)
        self.extra_artists, self.contours_added, self.lines_added = [], [], {}
        self.param_name_sets, self.param_bounds_sets = {}, {}
        self.fig = self.subplots = self._active_ax = None
        self.plot_col = 0

    def __del__(self):
        try:
            if self.auto_close and self.fig:
                plt.close(self.fig)
        except Exception:
            pass  # interpreter teardown: module globals may be gone

    @classmethod
    def get_subplot_plotter(
        cls, subplot_size=None, width_inch=None, scaling=True, rc_sizes=False, subplot_size_ratio=None, **kwargs
    ) -> "GetDistPlotter":
        plotter = cls(**kwargs)
        opts = plotter.settings
        opts.set_with_subplot_size(subplot_size or 2, size_ratio=subplot_size_ratio)
        if scaling is not None:
            opts.scaling = scaling
        if width_inch:
            opts.fig_width_inch = width_inch
            if rc_sizes and not kwargs.get("settings"):
                opts.rc_sizes()
        return plotter

    @classmethod
    def get_single_plotter(cls, scaling=None, rc_sizes=False, **kwargs):
        aspect = kwargs.pop("ratio", None) or 3 / 4.0
        width = kwargs.pop("width_inch", None) or 6
        plotter = cls(**kwargs)
        opts = plotter.settings
        opts.set_with_subplot_size(width, size_ratio=aspect)
        if scaling is not None:
            opts.scaling = scaling
        opts.fig_width_inch = width
        if rc_sizes and not kwargs.get("settings"):
            opts.rc_sizes()
        plotter.make_figure(1)
        return plotter

    def show_all_settings(self):
        """Print settings and library versions."""
        print(f"Python version: {sys.version}")
        print(f"\nMatplotlib version: {matplotlib.__version__}")
        print("\nGetDist Plot Settings:")
        print("getdist_tpu_torch version:", getdist_tpu_torch.__version__)
        for key, value in list(self.settings.__dict__.items()):
            print(f"{key} : {value}")
        print("\nRC params:")
        for key, value in sorted(matplotlib.rcParams.items()):
            print(f"{key} : {value}")

    # -- figure / subplot management -----------------------------------------

    def default_col_row(self, nplot=1, nx=None, ny=None):
        """Default subplot grid shape for nplot subplots."""
        cols = nx or int(round(np.sqrt(nplot / 1.4)))
        rows = ny or -(-nplot // cols)  # ceil division
        return cols, rows

    def make_figure(self, nplot=1, nx=None, ny=None, xstretch=1.0, ystretch=1.0, sharex=False, sharey=False):
        """New figure with one or more subplots (see reference
        ``plots.py:1903-1949``)."""
        self.new_plot()
        self.plot_col, self.plot_row = self.default_col_row(nplot, nx=nx, ny=ny)
        if self.settings.subplot_size_ratio:
            ystretch *= self.settings.subplot_size_ratio
        fixed_width = self.settings.fig_width_inch
        if fixed_width is None:
            self._axis_inches = self.settings.subplot_size_inch * xstretch
            figsize = (self._axis_inches * self.plot_col, self.settings.subplot_size_inch * ystretch * self.plot_row)
        else:
            self._axis_inches = fixed_width / self.plot_col
            height = fixed_width * self.plot_row * ystretch / (self.plot_col * xstretch)
            figsize = (fixed_width, height)
        self.fig = plt.figure(figsize=figsize, constrained_layout=self.settings.constrained_layout)
        self.gridspec = matplotlib.gridspec.GridSpec(nrows=self.plot_row, ncols=self.plot_col, figure=self.fig)
        self._grid_pads = {}
        if sharey:
            self._grid_pads.update(w_pad=0, wspace=0)
        if sharex:
            self._grid_pads.update(h_pad=0, hspace=0)
        if self._grid_pads and self.settings.constrained_layout:
            self.fig.get_layout_engine().set(**self._grid_pads)
        self.subplots = np.full((self.plot_row, self.plot_col), None, dtype=object)
        return self.plot_col, self.plot_row

    def _cell_axes(self, x, y, pars=None, **kwargs):
        ax = self.subplots[y, x]
        if ax is None or "projection" in kwargs:
            ax = self.fig.add_subplot(self.gridspec[y, x], **kwargs)
            self.subplots[y, x] = ax
        if pars is not None:
            ax.getdist_params = pars
        self._active_ax = ax
        return ax

    def _axes_by_index(self, i, pars=None, **kwargs):
        if i == 0 and self.fig is None:
            self.make_figure()
        return self._cell_axes(i % self.plot_col, i // self.plot_col, pars=pars, **kwargs)

    def get_axes(self, ax=None, pars=None):
        """Axes for a subplot coordinate/parameter tuple (or last used)."""
        if isinstance(ax, int):
            ax = self._axes_by_index(ax)
        elif isinstance(ax, _list_like):
            if isinstance(ax[0], (str, ParamInfo)):
                ax = self.get_axes_for_params(*ax)
            else:
                ax = self._cell_axes(ax[1], ax[0])
        elif ax is None:
            ax = self._active_ax
            if ax is None and self.fig and self.fig.axes:
                ax = self.fig.axes[0]
                if self.subplots[0, 0] is None:
                    self.subplots[0, 0] = self._active_ax = ax
            elif ax is None:
                ax = self._axes_by_index(0)
        if None not in (pars, ax):
            ax.getdist_pars = pars
        return ax

    def get_axes_for_params(self, *pars, **kwargs):
        """The axes whose associated parameters match the given names."""
        wanted = self._names_of(pars)
        shape = set if not kwargs.get("ordered", True) else list
        wanted = shape(wanted)
        for ax in self.subplots.flat:
            if not ax:
                continue
            tagged = getattr(ax, "getdist_params", None)
            if tagged is not None and shape(self._names_of(tagged)) == wanted:
                self._active_ax = ax
                return ax
        return None

    @staticmethod
    def _names_of(par_list):
        return [entry.name if isinstance(entry, ParamInfo) else entry for entry in par_list]

    # -- parameter / bounds resolution ---------------------------------------

    def param_names_for_root(self, root):
        """ParamNames for a root name (cached per plotter)."""
        got = self.param_name_sets.get(root)
        if got is None:
            got = self.sample_analyser.params_for_root(root, label_params=self.settings.param_names_for_labels)
            self.param_name_sets[root] = got
        return got

    def param_bounds_for_root(self, root):
        """Hard prior bounds object for a root name (cached)."""
        got = self.param_bounds_sets.get(root)
        if got is None:
            got = self.sample_analyser.bounds_for_root(root)
            self.param_bounds_sets[root] = got
        return got

    def _clip_to_priors(self, root, name, xmin, xmax):
        # clip a proposed (xmin, xmax) view range to the root's hard priors
        bounds = self.param_bounds_for_root(root)
        hard_low = bounds.getLower(name)
        hard_up = bounds.getUpper(name)
        if hard_low is not None:
            xmin = hard_low if xmin is None else max(xmin, hard_low)
        if hard_up is not None:
            xmax = hard_up if xmax is None else min(xmax, hard_up)
        return xmin, xmax

    def _prior_window(self, roots, name):
        lo, hi = None, None
        for root in roots:
            lo, hi = self._clip_to_priors(root, name, lo, hi)
        return lo, hi

    def param_latex_label(self, root, name, label_params=None):
        """Latex label for a parameter of a root."""
        if label_params is None:
            info = self._resolve_param(root, name)
        else:
            info = self.sample_analyser.params_for_root(root, label_params=label_params).parWithName(name)
        if not info:
            raise GetDistPlotError(f"no parameter named {name}")
        return info.latexLabel()

    def _resolve_param(self, root, param, renames=None):
        if isinstance(param, ParamInfo):
            name = param.name
            extra = getattr(param, "renames", None)
            if extra is not None:
                merged = makeList(renames.get(name, [])) if renames else []
                renames = {name: merged + list(extra)}
        else:
            name = param
        if isinstance(root, _list_like):
            if isinstance(param, ParamInfo):
                root = root[0]
            else:
                for candidate in root:
                    must_exist = candidate is root[-1]
                    hit = self.param_names_for_root(candidate).parWithName(name, error=must_exist, renames=renames)
                    if hit is not None:
                        return hit
        names = self.param_names_for_root(root)
        return names.parWithName(name, error=(name == param), renames=renames)

    def get_param_array(self, roots, params=None, renames: Mapping = None):
        """Resolve parameter name strings (or ParamInfo) for given root(s)
        (see reference ``plots.py:1951-2011``)."""
        if isinstance(roots, (list, tuple)):
            root = roots[0]
        else:
            root, roots = roots, [roots]
        for attr in ("param_names", "paramNames"):
            names = getattr(root, attr, None)
            if names is not None:
                break
        else:
            if hasattr(root, "names"):
                names = ParamNames(names=root.names, default=getattr(root, "dim", 0))
            else:
                names = self.param_names_for_root(root)

        if not params:
            return names.names
        if isinstance(params, str):
            return names.parsWithNames(params, error=True, renames=renames)

        given_info = [isinstance(p, ParamInfo) for p in params]
        info_renames = {p.name: getattr(p, "renames", []) for p, is_info in zip(params, given_info) if is_info}
        renames = mergeRenames(renames, info_renames) if renames else info_renames
        requested = [getattr(p, "name", p) for p in params]

        if len(roots) == 1:
            fallback = [(p if isinstance(p, ParamInfo) else ParamInfo(p)) for p in params]
            resolved = names.parsWithNames(requested, error=[not flag for flag in given_info], renames=renames)
            return [hit or fb for hit, fb in zip(resolved, fallback)]

        # multiple roots: resolve what the first root knows, recurse for the rest
        known = [i for i, name in enumerate(requested) if names.hasParam(name)]
        unknown = [i for i in range(len(params)) if i not in known]
        if not unknown:
            return names.parsWithNames(requested, renames=renames)
        from_first = names.parsWithNames([requested[i] for i in known], renames=renames)
        from_rest = self.get_param_array(roots[1:], [params[i] for i in unknown], renames)
        merged = list(params)
        for slot, hit in zip(known, from_first):
            merged[slot] = hit
        for slot, hit in zip(unknown, from_rest):
            merged[slot] = hit
        return merged

    @staticmethod
    def _derived_namespace(names, samples, obj=None):
        class SampleNames:
            pass

        obj = obj or SampleNames()
        for column, par in enumerate(names.names):
            setattr(obj, par.name, samples[:, column])
        return obj

    # -- line / contour style cycling ----------------------------------------

    @staticmethod
    def _palette_entry(colors, i=None):
        if isinstance(colors, str):
            palette = getattr(cm, colors, None)
            if palette is None:
                raise GetDistPlotError(f"matplotlib has no colormap called {colors}")
        else:
            palette = colors
        entries = getattr(palette, "colors", None) or palette
        if i is None:
            return entries
        if i >= len(entries):
            raise IndexError(f"no color at index {i}")
        return entries[i]

    def _cycle_entry(self, plotno=0):
        """(linestyle, color) pair from the settings.line_styles cycle."""
        try:
            entry = self._palette_entry(self.settings.line_styles, plotno)
        except IndexError:
            print("Error adding line " + str(plotno) + ": Add more default line style entries to settings.line_styles")
            raise
        if matplotlib.colors.is_color_like(entry):
            return "-", entry
        if isinstance(entry, str):
            # split a "--r"-style spec at the first non-dash character
            split = 0
            while split < len(entry) and entry[split] in "-.:":
                split += 1
            return entry[:split], entry[split:]
        if isinstance(entry, Sequence):
            return entry[0], entry[1]
        raise ValueError("Unknown format for color [%s]" % (entry,))

    def _dash_pattern(self, ls):
        return self.settings.line_dash_styles.get(ls)

    def _base_plot_args(self, plotno, **kwargs):
        configured = self.settings.plot_args
        if isinstance(configured, Mapping):
            args = configured
        elif isinstance(configured, (list, tuple)):
            args = (configured[plotno] or {}) if plotno < len(configured) else {}
        elif not configured:
            args = {}
        else:
            raise GetDistPlotError("plot_args must be list of dictionaries or dictionary: %s" % configured)
        args.update(kwargs)
        return args

    def _resolved_line_style(self, plotno, **kwargs):
        args = self._base_plot_args(plotno, **kwargs)
        for slot, fill in (("ls", lambda: self._cycle_entry(plotno)[0]),
                           ("color", lambda: self._cycle_entry(plotno)[1]),
                           ("lw", lambda: self._line_pts(self.settings.linewidth))):
            if slot not in args:
                args[slot] = fill()
        pattern = args.get("dashes", self._dash_pattern(args["ls"]))
        if pattern is not None:
            args["dashes"] = pattern
        return args

    def _line_style_of(self, plotno, **kwargs):
        return self._resolved_line_style(plotno, **kwargs)["ls"]

    def _color_of(self, plotno, **kwargs):
        return self._resolved_line_style(plotno, **kwargs)["color"]

    def _alpha_for_2d(self, plotno, **kwargs):
        fallback = self.settings.alpha_filled_add if kwargs.get("filled") and plotno > 0 else 1
        return self._base_plot_args(plotno, **kwargs).get("alpha", fallback)

    def _line_style_set(self, nroots, **kwargs):
        per_root = kwargs.get("line_args")
        if per_root is None:
            per_root = kwargs.get("contour_args")
        if per_root is None:
            per_root = [{}] * nroots
        elif isinstance(per_root, Mapping):
            per_root = [per_root] * nroots
        if len(per_root) < nroots:
            per_root = list(per_root) + [{}] * (nroots - len(per_root))
        colors = self._palette_entry(kwargs.get("colors"))

        def broadcast(tag):
            spec = kwargs.get(tag)
            if spec is None or isinstance(spec, (list, tuple)):
                return spec
            return [spec] * nroots

        widths, alphas, styles = broadcast("lws"), broadcast("alphas"), broadcast("ls")
        merged = []
        for i in range(nroots):
            entry = dict(per_root[i])
            for source, key, keep_none in ((colors, "color", False), (styles, "ls", False),
                                           (alphas, "alpha", True), (widths, "lw", False)):
                if source and i < len(source) and (source[i] is not None if keep_none else source[i]):
                    entry[key] = source[i]
            merged.append(entry)
        return merged

    def _contour_style_set(self, nroots, **kwargs):
        contour_args = self._line_style_set(nroots, **kwargs)
        filled = kwargs.get("filled")
        if filled and not isinstance(filled, bool):
            for entry, fill in zip(contour_args, filled):
                entry["filled"] = fill
        for entry in contour_args:
            if entry.get("filled") is None:
                entry["filled"] = filled or False
        return contour_args

    def _line_args_from_contours(self, cont_args, cont_colors):
        """1D line colors implied by the 2D contour style set."""
        styles = []
        for plotno, entry in enumerate(cont_args):
            if entry.get("filled"):
                color = entry.get("color") or self._palette_entry(
                    self.settings.solid_colors, len(cont_args) - plotno - 1
                )
            elif cont_colors is not None and plotno < len(cont_colors):
                color = cont_colors[plotno]
            else:
                styles.append({})
                continue
            if isinstance(color, (tuple, list)) and not matplotlib.colors.is_color_like(color):
                color = color[-1]
            styles.append({"color": color})
        return styles

    def _whitened_ramp(self, color_rgb, n_levels, pale_factor=None):
        """Ramp of progressively whitened copies of a color, palest first."""
        if not pale_factor:
            pale_factor = self.settings.solid_contour_palefactor
        ramp = [matplotlib.colors.colorConverter.to_rgb(color_rgb)]
        for _ in range(n_levels - 1):
            whitened = [channel * (1 - pale_factor) + pale_factor for channel in ramp[0]]
            ramp.insert(0, whitened)
        return ramp

    def _color_like(self, color):
        try:
            return matplotlib.colors.is_color_like(color)
        except Exception:
            return False

    def _line_pts(self, linewidth):
        return self.settings.scaled_linewidth(self._axis_inches, linewidth)

    def _font_pts(self, var, default=None):
        return self.settings.scaled_fontsize(self._axis_inches, var, default)

    # -- axis styling ----------------------------------------------------------

    def set_xlabel(self, param, ax=None):
        """Set x-axis label for a parameter."""
        size = self._font_pts(self.settings.axes_labelsize)
        self.get_axes(ax).set_xlabel(
            param.latexLabel(), fontsize=size, verticalalignment="baseline", labelpad=4 + size
        )

    def set_ylabel(self, param, ax=None, **kwargs):
        """Set y-axis label for a parameter."""
        size = self._font_pts(self.settings.axes_labelsize)
        self.get_axes(ax).set_ylabel(param.latexLabel(), fontsize=size, **kwargs)

    def set_zlabel(self, param, ax=None, **kwargs):
        """Set z-axis label for a parameter."""
        size = self._font_pts(self.settings.axes_labelsize)
        self.get_axes(ax).set_zlabel(param.latexLabel(), fontsize=size, **kwargs)

    def set_axes(
        self, params=(), lims=None, do_xlabel=True, do_ylabel=True, no_label_no_numbers=False, pos=None,
        color_label_in_axes=False, ax=None, **_other_args
    ):
        """Set axis labels, ticks, limits and styles (see reference
        ``plots.py:1576-1624``)."""
        ax = self.get_axes(ax)
        if lims is not None:
            ax.axis(lims)
        if do_xlabel or not no_label_no_numbers:
            self._style_main_axis(ax.xaxis, True)
        if pos is not None:
            ax.set_position(pos)
        has_x, has_y = len(params) >= 1, len(params) >= 2
        if do_xlabel and has_x:
            self.set_xlabel(params[0], ax)
        elif no_label_no_numbers:
            self._hide_x_tick_labels(ax)
        if do_ylabel or not no_label_no_numbers:
            self._style_main_axis(ax.yaxis, False)
        if has_y and do_ylabel:
            self.set_ylabel(params[1], ax)
        elif has_y and no_label_no_numbers:
            self._hide_y_tick_labels(ax)
        if color_label_in_axes and len(params) > 2:
            self.add_text(params[2].latexLabel(), ax=ax)
        return ax

    @staticmethod
    def _hide_y_tick_labels(ax):
        ax.tick_params(labelleft=False)
        ax.yaxis.offsetText.set_visible(False)

    @staticmethod
    def _hide_x_tick_labels(ax):
        ax.tick_params(labelbottom=False)
        ax.xaxis.offsetText.set_visible(False)

    @staticmethod
    def _ticks_inward(ax, top_and_left=True):
        for axis in (ax.get_xaxis(), ax.get_yaxis()):
            axis.set_tick_params(which="both", direction="in", right=top_and_left, top=top_and_left)

    def _bounded_locator(self, axis, max_ticks=None, prune=True):
        locator = BoundedMaxNLocator(
            nbins=max_ticks or self.settings.axis_tick_max_labels,
            prune=prune,
            step_groups=self.settings.axis_tick_step_groups,
        )
        axis.set_major_locator(locator)

    def _style_main_axis(self, axis, x):
        self._choose_axis_formatter(axis, x)
        rotation = self.settings.axis_tick_x_rotation if x else self.settings.axis_tick_y_rotation
        self._style_axis_ticks(axis, rotation)

    def _style_axis_ticks(self, axis, rotation: float = 0, tick_label_size=None):
        size = self._font_pts(tick_label_size, self.settings.axes_fontsize)
        axis.set_tick_params(which="major", labelrotation=rotation, labelsize=size)
        axis.get_offset_text().set_fontsize(size * 3 / 4 if size > 7 else size)
        vertical = isinstance(axis, matplotlib.axis.YAxis)
        shared_gap = "hspace" if vertical else "wspace"
        self._bounded_locator(axis, prune=self._grid_pads.get(shared_gap) is not None)
        if vertical and abs(rotation - 90) < 45:
            for label in axis.get_ticklabels():
                label.set_verticalalignment("center")

    def _choose_axis_formatter(self, axis, x):
        lo_pow, hi_pow = self.settings.axis_tick_powerlimits
        if not x:
            # avoid offset text on shared y axes
            extent = max(abs(v) for v in axis.get_view_interval())
            if extent <= 10 ** (lo_pow + 1) or extent >= 10**hi_pow:
                axis.set_major_formatter(SciFuncFormatter())
                return
        formatter = ScalarFormatter(useOffset=False, useMathText=True)
        formatter.set_powerlimits((lo_pow, hi_pow))
        axis.set_major_formatter(formatter)

    def rotate_yticklabels(self, ax=None, rotation=90, labelsize=None):
        """Rotate y tick labels."""
        self._style_axis_ticks(self.get_axes(ax).yaxis, rotation, labelsize)

    def rotate_xticklabels(self, ax=None, rotation=90, labelsize=None):
        """Rotate x tick labels."""
        self._style_axis_ticks(self.get_axes(ax).xaxis, rotation, labelsize)

    # -- limit bookkeeping ----------------------------------------------------

    def _merge_span(self, bounds, curbounds):
        # merge two (min, max) ranges into their union
        if not bounds:
            return curbounds
        if curbounds is not None and curbounds[0] is not None:
            bounds = (min(curbounds[0], bounds[0]), max(curbounds[1], bounds[1]))
        return bounds

    def _merge_spans(self, res, xlims, ylims, do_resize=True):
        if res is None or (not do_resize and (xlims is not None or ylims is not None)):
            return xlims, ylims
        if xlims is None and ylims is None:
            return res
        return self._merge_span(res[0], xlims), self._merge_span(res[1], ylims)

    # -- markers / bands / lines -----------------------------------------------

    def add_line(self, xdata, ydata, zorder=0, color=None, ls=None, ax=None, **kwargs):
        """Add a Line2D to the axes."""
        artist = matplotlib.lines.Line2D(
            xdata,
            ydata,
            color=color if color is not None else self.settings.axis_marker_color,
            ls=ls if ls is not None else self.settings.axis_marker_ls,
            zorder=zorder,
            **kwargs,
        )
        self.get_axes(ax).add_line(artist)

    def add_x_marker(self, marker, color=None, ls=None, lw=None, ax=None, **kwargs):
        """Vertical marker line(s) at x value(s)."""
        style = self._marker_style(color, ls, lw)
        target = self.get_axes(ax)
        for value in makeList(marker):
            target.axvline(value, **style, **kwargs)

    def add_y_marker(self, marker, color=None, ls=None, lw=None, ax=None, **kwargs):
        """Horizontal marker line(s) at y value(s)."""
        style = self._marker_style(color, ls, lw)
        target = self.get_axes(ax)
        for value in makeList(marker):
            target.axhline(value, **style, **kwargs)

    def _marker_style(self, color, ls, lw):
        knobs = self.settings
        return {
            "color": color if color is not None else knobs.axis_marker_color,
            "ls": ls if ls is not None else knobs.axis_marker_ls,
            "lw": lw if lw is not None else knobs.axis_marker_lw,
        }

    def add_param_markers(self, param_value_dict, *, color=None, ls=None, lw=None):
        """Mark parameter values across all subplots that plot them."""
        for ax in self.subplots.flat:
            tagged = getattr(ax, "getdist_params", None)
            if tagged is None:
                continue
            for name, add in zip(self._names_of(tagged), (self.add_x_marker, self.add_y_marker)):
                for value in makeList(param_value_dict.get(name, None)):
                    if value is not None:
                        add(value, color=color, ls=ls, lw=lw, ax=ax)

    def _draw_marker_set(self, markers, ax, marker_args, y=False, color=None):
        add = self.add_y_marker if y else self.add_x_marker
        if isinstance(marker_args, _list_like):
            for value, style in zip(makeList(markers), marker_args):
                if color:
                    style["color"] = color
                add(value, ax=ax, **style)
        else:
            if color:
                marker_args["color"] = color
            add(markers, ax=ax, **marker_args)

    @staticmethod
    def _marker_for(markers, index, name):
        if markers is not None:
            if isinstance(markers, Mapping):
                return markers.get(name)
            if index < len(markers):
                return markers[index]
        return None

    def add_bands(
        self, x, y, errors, color="gray", nbands=2, alphas=(0.25, 0.15, 0.1), lw=0.2, lw_center=None, linecolor="k", ax=None
    ):
        """Constraint band(s) of y +- n*errors as a function of x."""
        ax = self.get_axes(ax)
        if np.isscalar(y):
            y = np.full(len(x), y, dtype=float)
        for n_sigma in range(nbands, 0, -1):
            ax.fill_between(x, y - n_sigma * errors, y + n_sigma * errors, color=color, alpha=alphas[n_sigma - 1], lw=lw)
        if lw_center:
            ax.plot(x, y, color=linecolor or color, lw=lw_center)

    def add_y_bands(self, y, sigma, color="gray", ax=None, alpha1=0.15, alpha2=0.1, **kwargs):
        """Horizontal 1/2-sigma shaded bands."""
        ax = self.get_axes(ax)
        if alpha2 > 0:
            ax.axhspan(y - 2 * sigma, y + 2 * sigma, color=color, alpha=alpha2, **kwargs)
        if alpha1 > 0:
            ax.axhspan(y - sigma, y + sigma, color=color, alpha=alpha1, **kwargs)

    def add_x_bands(self, x, sigma, color="gray", ax=None, alpha1=0.15, alpha2=0.1, **kwargs):
        """Vertical 1/2-sigma shaded bands."""
        ax = self.get_axes(ax)
        if alpha2 > 0:
            ax.axvspan(x - 2 * sigma, x + 2 * sigma, color=color, alpha=alpha2, **kwargs)
        if alpha1 > 0:
            ax.axvspan(x - sigma, x + sigma, color=color, alpha=alpha1, **kwargs)

    # -- text / colorbars -------------------------------------------------------

    def add_text(self, text_label, x=0.95, y=0.06, ax=None, **kwargs):
        """Add a text label inside the axes."""
        style = {
            "horizontalalignment": "right" if x > 0.5 else "left",
            "verticalalignment": "center",
            "fontsize": self._font_pts(self.settings.fontsize),
        }
        style.update(kwargs)
        ax = self.get_axes(ax)
        ax.text(x, y, text_label, transform=ax.transAxes, **style)

    def add_text_left(self, text_label, x=0.05, y=0.06, ax=None, **kwargs):
        """Add a left-aligned text label."""
        self.add_text(text_label, x, y, ax, **{"horizontalalignment": "left", **kwargs})

    def add_colorbar(self, param, orientation="vertical", mappable=None, ax=None, colorbar_args=empty_dict, **ax_args):
        """Add a color bar labelled by a parameter."""
        cb = self.fig.colorbar(mappable, ax=self.get_axes(ax), **{"orientation": orientation, **colorbar_args})
        cb.set_alpha(1)
        if not ax_args.get("color_label_in_axes"):
            self.add_colorbar_label(cb, param)
        cb_axis = cb.ax.yaxis if orientation == "vertical" else cb.ax.xaxis
        self._style_axis_ticks(
            cb_axis, self.settings.colorbar_tick_rotation or 0, self.settings.colorbar_axes_fontsize
        )
        return cb

    def add_colorbar_label(self, cb, param, label_rotation=None):
        """Set the colorbar label from a parameter's latex label."""
        if not label_rotation:
            label_rotation = self.settings.colorbar_label_rotation
        extra = {"va": "bottom"} if label_rotation and 10 < -label_rotation < 170 else {}
        cb.set_label(
            param.latexLabel(),
            fontsize=self._font_pts(self.settings.axes_labelsize),
            rotation=label_rotation,
            labelpad=self.settings.colorbar_label_pad,
            **extra,
        )

    def export(self, fname=None, adir=None, watermark=None, tag=None, **kwargs):
        """Save the figure (extension determines the format)."""
        fname = fname or os.path.basename(sys.argv[0]).replace(".py", "")
        if tag:
            fname = f"{fname}_{tag}"
        if "." not in fname:
            fname = f"{fname}.{getdist_tpu_torch.default_plot_output}"
        bare = os.sep not in fname and "/" not in fname
        if adir is not None and bare:
            fname = os.path.join(adir, fname)
        target_dir = os.path.dirname(fname)
        if target_dir and not os.path.exists(target_dir):
            os.makedirs(target_dir)
        if watermark:
            style = dict(fontsize=30, color="gray", ha="center", va="center", alpha=0.2)
            self.fig.text(0.45, 0.5, escapeLatex(watermark), **style)
        self.fig.savefig(fname, bbox_extra_artists=self.extra_artists, bbox_inches="tight", **kwargs)

    # -- density drawing ---------------------------------------------------------

    def add_1d(self, root, param, plotno=0, normalized=None, ax=None, title_limit=None, **kwargs):
        """Add one marginalized 1D density line (see reference
        ``plots.py:982-1036``). Returns density bounds."""
        param = self._resolve_param(root, param)
        ax = self.get_axes(ax, pars=(param,))
        if normalized is None:
            normalized = self.settings.norm_1d_density
        analytic = isinstance(root, MixtureND)
        if analytic:
            density = root.density1D(param.name)
            if not normalized:
                density.normalize(by="max")
        else:
            want_likes = self.settings.plot_meanlikes
            density = self.sample_analyser.get_density(root, param, likes=want_likes)
            if density is None:
                return None
        if normalized:
            density.normalize()
        if title_limit is None:
            title_limit = self.settings.title_limit

        style = self._resolved_line_style(plotno, **kwargs)
        self.lines_added[plotno] = style
        (curve,) = ax.plot(density.x, density.P, **style)
        if style.get("dashes"):
            curve.set_dashes(style["dashes"])
        if self.settings.plot_meanlikes:
            style["lw"] = self._line_pts(self.settings.linewidth_meanlikes)
            ax.plot(density.x, density.likes, **style)
        if title_limit:
            self._set_1d_title_limit(ax, root, param, title_limit)
        return density.bounds()

    def _set_1d_title_limit(self, ax, root, param, title_limit):
        """Title the axes with the marginalized constraint at a given limit."""
        if isinstance(root, MixtureND):
            raise ValueError("MixtureND densities do not support title_limit")
        chain = self.sample_analyser.samples_for_root(root)
        if self.settings.title_limit_labels:
            tex = chain.getInlineLatex(param, limit=title_limit)
        else:
            tex = chain.getLatex([param], title_limit)[1][0]
        if "---" not in tex:
            size = self._font_pts(self.settings.title_limit_fontsize, self.settings.axes_fontsize)
            ax.set_title("$" + tex + "$", fontsize=size)

    def _contour_density(self, root, ax, param1, param2, param_pair, mask_function):
        """Resolve the Density2D to contour for a root (sample cache, an
        analytic mixture, or a masked recomputation)."""
        wanted = param_pair or [param1, param2]
        param1, param2 = self.get_param_array(root, wanted)
        ax.getdist_params = (param1, param2)
        n_levels, want_likes = self.settings.num_plot_contours, self.settings.shade_meanlikes
        if mask_function is not None:
            return self.samples_for_root(root).get2DDensityGridData(
                param1.name, param2.name, mask_function=mask_function,
                num_plot_contours=n_levels, meanlikes=want_likes,
            )
        if isinstance(root, MixtureND):
            marge = root.marginalizedMixture(params=[param1, param2])
            return marge.density2D()
        return self.sample_analyser.get_density_grid(root, param1, param2, conts=n_levels, likes=want_likes)

    def _reserve_proxy_slot(self, add_legend_proxy, plotno):
        """Slot index in contours_added this contour set should fill for the
        legend, or -1 when it should not register a proxy."""
        if add_legend_proxy:
            self.contours_added.append(None)
            return len(self.contours_added) - 1
        if None in self.contours_added and self.contours_added.index(None) == plotno:
            return plotno
        return -1

    @staticmethod
    def _without_line_style(args):
        return {k: v for k, v in args.items() if k not in ("color", "ls", "lw")}

    def _filled_contour_colors(self, cols, contour_levels, plotno, of, **kwargs):
        if cols is not None:
            return cols
        slot = (of - plotno - 1) if of is not None else plotno
        base = kwargs.get("color") or self._palette_entry(self.settings.solid_colors, slot)
        if isinstance(base, str) or self._color_like(base):
            return self._whitened_ramp(base, len(contour_levels))
        return base

    def _paint_filled_contours(self, ax, density, z, contour_levels, cols, alpha, proxy_ix, **kwargs):
        fill_levels = sorted(np.append([density.P.max() + 1], contour_levels))
        passthrough = self._without_line_style(kwargs)
        cs = ax.contourf(density.x, density.y, z, fill_levels, colors=cols, alpha=alpha, **passthrough)
        # outline in the deepest fill color; also the legend proxy color
        deepest = tuple(cs.to_rgba(cs.cvalues[-1], cs.alpha))
        if proxy_ix >= 0:
            self.contours_added[proxy_ix] = matplotlib.patches.Rectangle((0, 0), 1, 1, fc=deepest)
        outline_lw = kwargs["lw"] if kwargs.get("lw") is not None else self.settings.linewidth_contour
        ax.contour(
            density.x,
            density.y,
            z,
            fill_levels[:1],
            colors=(deepest,),
            linewidths=self._line_pts(outline_lw),
            linestyles=kwargs.get("ls"),
            alpha=alpha * self.settings.alpha_factor_contour_lines,
            **passthrough,
        )

    def _paint_line_contours(self, ax, density, z, contour_levels, alpha, proxy_ix, plotno, **kwargs):
        style = self._resolved_line_style(plotno, **kwargs)
        extra = self._base_plot_args(plotno, **kwargs)
        extra["alpha"] = alpha
        cs = ax.contour(
            density.x,
            density.y,
            z,
            sorted(contour_levels),
            colors=[style["color"]],
            linestyles=[style["ls"]],
            linewidths=style["lw"],
            **self._without_line_style(extra),
        )
        dashes = style.get("dashes")
        if dashes:
            if hasattr(cs, "collections"):
                for collection in cs.collections:
                    collection.set_dashes([(0, dashes)])
            else:
                cs.set_dashes([(0, dashes)] * len(cs.levels))
        if proxy_ix >= 0:
            proxy = matplotlib.lines.Line2D(
                [0, 1], [0, 1], ls=style["ls"], lw=style["lw"], color=style["color"], alpha=style.get("alpha")
            )
            if dashes:
                proxy.set_dashes(dashes)
            self.contours_added[proxy_ix] = proxy

    def add_2d_contours(
        self, root, param1=None, param2=None, plotno=0, of=None, cols=None, contour_levels=None,
        add_legend_proxy=True, param_pair=None, density=None, alpha=None, ax=None, mask_function: callable = None,
        **kwargs
    ):
        """Add 2D contours (filled or line) for one root / density (see
        reference ``plots.py:1063-1217``). Returns density bounds."""
        ax = self.get_axes(ax)
        if density is None:
            density = self._contour_density(root, ax, param1, param2, param_pair, mask_function)
        if density is None:
            if add_legend_proxy:
                self.contours_added.append(None)
            return None
        if alpha is None:
            alpha = self._alpha_for_2d(plotno, **kwargs)
        if contour_levels is None:
            contour_levels = self._contour_levels_for(density)

        proxy_ix = self._reserve_proxy_slot(add_legend_proxy, plotno)
        surface = density.P
        if density.mask is not None:
            surface = np.ma.masked_where(density.mask, surface)
        if kwargs.get("filled"):
            cols = self._filled_contour_colors(cols, contour_levels, plotno, of, **kwargs)
            self._paint_filled_contours(ax, density, surface, contour_levels, cols, alpha, proxy_ix, **kwargs)
        else:
            self._paint_line_contours(ax, density, surface, contour_levels, alpha, proxy_ix, plotno, **kwargs)
        return density.bounds()

    def _contour_levels_for(self, density):
        """Density's own contour levels, computing them from the configured
        confidence fractions on first use."""
        if not hasattr(density, "contours"):
            fractions = self.sample_analyser.ini.ndarray("contours")
            if fractions is not None:
                fractions = fractions[: self.settings.num_plot_contours]
            density.contours = density.getContourLevels(fractions)
        return density.contours

    def add_2d_density_contours(self, density, **kwargs):
        """Add contours from a provided Density2D."""
        return self.add_2d_contours(None, density=density, **kwargs)

    def add_2d_mixture_projection(self, mixture, param1, param2, **kwargs):
        marge = mixture.marginalizedMixture(params=[param1, param2])
        density = marge.density2D()
        return self.add_2d_density_contours(density, **kwargs)

    def add_2d_covariance(self, means, cov, xvals=None, yvals=None, def_width=4.0, samples_per_std=50.0, **kwargs):
        """Plot a 2D Gaussian-ellipse density from mean and covariance."""
        cov = np.asarray(cov)
        assert cov.shape == (2, 2)
        if xvals is None:
            sd = np.sqrt(cov[0, 0])
            xvals = np.arange(means[0] - def_width * sd, means[0] + def_width * sd, sd / samples_per_std)
        if yvals is None:
            sd = np.sqrt(cov[1, 1])
            yvals = np.arange(means[1] - def_width * sd, means[1] + def_width * sd, sd / samples_per_std)
        dx, dy = np.meshgrid(xvals - means[0], yvals - means[1])
        prec = np.linalg.inv(cov)
        chi2 = prec[0, 0] * dx**2 + 2 * prec[0, 1] * dx * dy + prec[1, 1] * dy**2
        density = Density2D(xvals, yvals, np.exp(-0.5 * chi2))
        density.contours = [0.32, 0.05]
        return self.add_2d_density_contours(density, **kwargs)

    def add_2d_shading(self, root, param1, param2, colormap=None, density=None, ax=None, **kwargs):
        """Add 2D density color shading (see reference ``plots.py:1219``)."""
        param1, param2 = self.get_param_array(root, [param1, param2])
        ax = self.get_axes(ax, pars=(param1, param2))
        if density is None:
            density = self.sample_analyser.get_density_grid(
                root,
                param1,
                param2,
                conts=self.settings.num_plot_contours,
                likes=self.settings.shade_meanlikes,
            )
        if density is None:
            return
        n_shades = self.settings.num_shades
        mapper = cm.ScalarMappable(cmap=colormap or self.settings.colormap)
        cols = mapper.to_rgba(np.linspace(0, 1, n_shades))
        # fade the lowest shades towards white so plot edges stay clean
        n_fade = min(n_shades // 3, 20)
        white = np.ones(4)
        for k in range(n_fade):
            cols[k + 1] = (white * (n_fade - k) + np.array(cols[k + 1]) * k) / float(n_fade)
        cols[0][3] = 0
        levels = np.linspace(0, 1, n_shades) ** self.settings.shade_level_scale
        surface = density.likes if self.settings.shade_meanlikes else density.P
        ax.contourf(density.x, density.y, surface, n_shades, colors=cols, levels=levels, **kwargs)
        ax.contour(density.x, density.y, surface, n_shades, colors=cols, levels=levels, **kwargs)

    # -- scatter plots -----------------------------------------------------------

    def add_3d_scatter(
        self, root, params, color_bar=True, alpha=1, extra_thin=1, scatter_size=None, ax=None, alpha_samples=False, **kwargs
    ):
        """Add a scatter colored by a third parameter (see reference
        ``plots.py:3227-3324``)."""
        ax = self.get_axes(ax)
        params = self.get_param_array(root, params)
        if alpha_samples:
            chain = self.sample_analyser.samples_for_root(root)
            pts, weights = chain.samples, chain.weights
        else:
            chain = None
            pts, weights = self.sample_analyser.load_single_samples(root), 1
        names = self.param_names_for_root(root)
        columns = [
            (p.getDerived(self._derived_namespace(names, pts)) if hasattr(p, "getDerived")
             else pts[:, names.numberOfName(p.name)])
            for p in params
        ]
        fixed_color = kwargs.get("fixed_color")
        point_size = scatter_size or self.settings.scatter_size
        if chain:
            self._alpha_weighted_scatter(ax, chain, columns, weights, fixed_color, alpha, point_size)
        else:
            if extra_thin > 1:
                columns = [col[::extra_thin] for col in columns]
            self.last_scatter = ax.scatter(
                columns[0],
                columns[1],
                edgecolors="none",
                s=point_size,
                c=fixed_color or columns[2],
                cmap=None if fixed_color else self.settings.colormap_scatter,
                alpha=alpha,
            )
        if color_bar and not fixed_color:
            cb = self.add_colorbar(params[2], mappable=self.last_scatter, ax=ax, **kwargs)
            self.last_colorbar = cb
        margins = []
        for col in columns[:2]:
            lo, hi = min(col), max(col)
            pad = (hi - lo) / 20
            margins.append([lo - pad, hi + pad])
        return margins

    def _alpha_weighted_scatter(self, ax, mcsamples, columns, weights, fixed_color, alpha, point_size):
        """Scatter most weighted samples, encoding multiplicity as alpha."""
        from matplotlib.cm import ScalarMappable
        from matplotlib.colors import Normalize, to_rgb

        top = np.max(weights)
        dup_fac = 4
        keep = weights > top / (100 * dup_fac)
        x, y, z = (col[keep] for col in columns[:3])
        scaled = weights[keep] / top * dup_fac
        repeats = np.ceil(scaled)
        chosen = mcsamples.thin_indices(1, repeats)
        x, y, z = x[chosen], y[chosen], z[chosen]
        residual = (scaled / repeats)[chosen]
        norm = Normalize(z.min(), z.max())
        mappable = ScalarMappable(norm, self.settings.colormap_scatter)
        mappable.set_array(z)
        rgba = mappable.to_rgba(z)
        if fixed_color:
            rgba[:, :3] = to_rgb(fixed_color)
        rgba[:, 3] = residual / dup_fac * alpha
        self.last_scatter = mappable
        ax.scatter(x, y, edgecolors="none", s=point_size, c=rgba, alpha=None)

    def add_2d_scatter(self, root, x, y, color="k", alpha=1, extra_thin=1, scatter_size=None, ax=None):
        """Add a plain 2D sample scatter."""
        return self.add_3d_scatter(root, [x, y], False, alpha, extra_thin, scatter_size, ax, fixed_color=color)

    def add_4d_scatter(
        self, root, params, ax, color_bar=False, max_scatter_points=None, lims=empty_dict, fixed_color=None,
        colorbar_args=empty_dict, **kwargs
    ):
        """Add a 3D (x,y,z) scatter colored by a fourth parameter."""
        chain = self.sample_analyser.samples_for_root(root)
        params = self.get_param_array(root, params)
        chosen = chain.random_single_samples_indices(max_samples=max_scatter_points or chain.max_scatter_points)
        if len(params) == 3:
            fixed_color = fixed_color or "k"
        if len(params) < (3 if fixed_color else 4):
            raise GetDistPlotError("plot_4d takes three or four parameter names")
        if fixed_color:
            params = params[:3]
        for name, window in lims.items():
            if not isinstance(window, Sequence) or len(window) != 2:
                raise GetDistPlotError("plot_4d lims must map parameter names to (lower, upper) tuples")
            if window[0] is not None:
                chosen = chosen[chain[name][chosen] > window[0]]
            if window[1] is not None:
                chosen = chosen[chain[name][chosen] < window[1]]
        columns = []
        for param in params:
            if hasattr(param, "getDerived"):
                columns.append(
                    param.getDerived(self._derived_namespace(self.param_names_for_root(root), chain.samples[chosen, :]))
                )
            else:
                columns.append(chain[param.name][chosen])
        x, y, z = columns[:3]
        color_values = fixed_color or columns[3]
        opts = {"marker": "o", "cmap": self.settings.colormap_scatter, "s": self.settings.scatter_size, **kwargs}
        if fixed_color:
            del opts["cmap"]
        ax.scatter(x, y, z, c=color_values, depthshade=True, **opts)
        if color_bar and not fixed_color:
            norm = matplotlib.colors.Normalize(color_values.min(), color_values.max())
            mappable = cm.ScalarMappable(norm, cmap=opts["cmap"])
            mappable.set_array(color_values)
            cb = self.add_colorbar(params[3], mappable=mappable, ax=ax, colorbar_args=colorbar_args)
            self.last_colorbar = cb
        return x, y, z

    # -- single-frame composite plots ---------------------------------------------

    def plot_1d(
        self, roots, param, marker=None, marker_color=None, label_right=False, title_limit=None, no_ylabel=False,
        no_ytick=False, no_zero=False, normalized=False, param_renames=None, ax=None, **kwargs
    ):
        """Single 1D plot of marginalized density lines (see reference
        ``plots.py:1664-1786``)."""
        roots = makeList(roots)
        ax = self.get_axes(ax, pars=(param,))
        want_range = kwargs.pop("_ret_range", None)
        skip_finish = kwargs.pop("_no_finish", False)
        styles = self._line_style_set(len(roots), **kwargs)
        lo = hi = None
        drawn_param = drawn_root = None
        for i, root in enumerate(roots):
            resolved = self._resolve_param(root, param, param_renames)
            if not resolved:
                continue
            first_title = title_limit if i == 0 else 0
            span = self.add_1d(root, resolved, i, normalized=normalized, title_limit=first_title, ax=ax, **styles[i])
            lo, hi = self._merge_span(span, (lo, hi))
            if span is not None and drawn_param is None:
                drawn_param, drawn_root = resolved, root
        if drawn_param is None:
            raise GetDistPlotError(f"parameter {param} appears in none of the roots")
        if marker is not None:
            self._draw_marker_set(marker, ax, kwargs.get("marker_args", {}), color=marker_color)
        if kwargs.get("lims") is not None:
            lo, hi = kwargs["lims"]
        else:
            lo, hi = self._clip_to_priors(drawn_root, drawn_param.name, lo, hi)
        top = ax.yaxis.get_view_interval()[-1] if normalized else 1.099
        kwargs["lims"] = [lo, hi, 0, top]
        self.set_axes([drawn_param], ax=ax, **kwargs)
        self._style_1d_y_axis(ax, normalized, no_ylabel, no_ytick, no_zero, label_right)
        if want_range:
            return lo, hi
        if not skip_finish and len(self.fig.axes) == 1:
            self.finish_plot()

    def _style_1d_y_axis(self, ax, normalized, no_ylabel, no_ytick, no_zero, label_right):
        """Probability-axis labeling and tick policy for a 1D density plot."""
        opts = self.settings
        y_label = opts.norm_prob_label if normalized else opts.prob_label
        if y_label and not no_ylabel:
            if label_right:
                ax.yaxis.set_label_position("right")
                ax.yaxis.tick_right()
            ax.set_ylabel(y_label, fontsize=self._font_pts(opts.axes_labelsize))
        if no_ytick or not opts.prob_y_ticks:
            ax.tick_params(left=False, labelleft=False)
        elif no_ylabel:
            self._hide_y_tick_labels(ax)
        elif no_zero and not normalized:
            # drop the 0 tick (and any tick above the 1.099 headroom)
            ticks = list(ax.get_yticks())
            if ticks[-1] > 1:
                ticks.pop()
            ax.set_yticks(ticks[1:])

    def plot_2d(
        self, roots, param1=None, param2=None, param_pair=None, shaded=False, add_legend_proxy=True, line_offset=0,
        proxy_root_exclude=(), ax=None, mask_function: callable = None, **kwargs
    ):
        """Single 2D line/contour/filled plot (see reference
        ``plots.py:1788-1888``)."""
        roots = makeList(roots)
        if isinstance(param1, _list_like):
            param_pair, param1 = param1, None
        skip_finish = kwargs.pop("_no_finish", False)
        pair = self.get_param_array(roots, param_pair or [param1, param2])
        ax = self.get_axes(ax, pars=pair)
        if self.settings.progress:
            print("plotting: ", [p.name for p in pair])
        if shaded is not False and not kwargs.get("filled"):
            self.add_2d_shading(roots[0 if shaded is True else shaded], *pair, ax=ax)
        contour_args = self._contour_style_set(len(roots), **kwargs)
        x_span = y_span = None
        for i, root in enumerate(roots):
            want_proxy = add_legend_proxy and root not in proxy_root_exclude
            span = self.add_2d_contours(
                root, pair[0], pair[1], line_offset + i, of=len(roots), ax=ax,
                mask_function=mask_function, add_legend_proxy=want_proxy, **contour_args[i],
            )
            x_span, y_span = self._merge_spans(span, x_span, y_span)
        if x_span is not None and "lims" not in kwargs:
            x_view = self._clip_to_priors(roots[0], pair[0].name, *x_span)
            y_view = self._clip_to_priors(roots[0], pair[1].name, *y_span)
            kwargs["lims"] = [x_view[0], x_view[1], y_view[0], y_view[1]]
        self.set_axes(pair, ax=ax, **kwargs)
        if x_span is None:
            return
        if not skip_finish and len(self.fig.axes) == 1:
            self.finish_plot()
        return x_span, y_span

    def plot_3d(
        self, roots, params=None, params_for_plots=None, color_bar=True, line_offset=0, add_legend_proxy=True,
        alpha_samples=False, ax=None, **kwargs
    ):
        """2D scatter colored by a third parameter, plus contours for any
        additional roots (see reference ``plots.py:3360-3444``)."""
        roots = makeList(roots)
        skip_finish = kwargs.pop("_no_finish", False)
        if params_for_plots:
            if params is not None:
                raise GetDistPlotError("give plot_3d params or params_for_plots, not both")
            per_root = [self.get_param_array(root, p) for p, root in zip(params_for_plots, roots)]
        else:
            if not params:
                raise GetDistPlotError("plot_3d got an empty parameter list")
            resolved = self.get_param_array(roots[0], params)
            per_root = [resolved] * len(roots)
        ax = self.get_axes(ax, pars=per_root[0])
        contour_args = self._contour_style_set(len(roots) - 1, **kwargs)
        x_span, y_span = self.add_3d_scatter(
            roots[0], per_root[0], color_bar=color_bar, alpha_samples=alpha_samples, ax=ax, **kwargs
        )
        for i, overlay_root in enumerate(roots[1:]):
            span = self.add_2d_contours(
                overlay_root,
                per_root[i + 1][0],
                per_root[i + 1][1],
                i + line_offset,
                add_legend_proxy=add_legend_proxy,
                zorder=i + 1,
                ax=ax,
                **contour_args[i],
            )
            x_span, y_span = self._merge_spans(span, x_span, y_span)
        if "lims" not in kwargs:
            xp, yp = per_root[0][:2]
            x_view = self._clip_to_priors(roots[0], xp.name, *x_span)
            y_view = self._clip_to_priors(roots[0], yp.name, *y_span)
            kwargs["lims"] = [x_view[0], x_view[1], y_view[0], y_view[1]]
        self.set_axes(per_root[0], ax=ax, **kwargs)
        if not skip_finish and self.plot_row == 1 and self.plot_col == 1:
            self.finish_plot()

    def plot_2d_scatter(self, roots, param1, param2, color="k", line_offset=0, add_legend_proxy=True, **kwargs):
        """2D scatter plot (extra roots plotted as contour lines)."""
        self.plot_3d(
            roots,
            [param1, param2],
            color_bar=False,
            line_offset=line_offset,
            add_legend_proxy=add_legend_proxy,
            **{**kwargs, "fixed_color": color},
        )

    def plot_4d(
        self, roots, params, color_bar=True, colorbar_args=empty_dict, ax=None, lims=empty_dict, azim=15, elev=None,
        dist=12, alpha=0.5, marker="o", max_scatter_points=None, shadow_color=None, shadow_alpha=0.1,
        fixed_color=None, compare_colors=None, animate=False, anim_angle_degrees=360, anim_step_degrees=0.6,
        anim_fps=15, mp4_filename=None, mp4_bitrate=-1, **kwargs
    ):
        """3D x-y-z scatter colored by a fourth parameter, with optional
        rotation animation / mp4 (see reference ``plots.py:3556-3737``)."""
        roots = makeList(roots)
        if not params:
            raise GetDistPlotError("plot_4d got an empty parameter list")
        params = self.get_param_array(roots[0], params)
        if not ax:
            if self.fig is None:
                self.make_figure()
            ax = self._cell_axes(0, 0, pars=(p.name for p in params[:3]), projection="3d")
            ax.dist = dist
        scatter_common = dict(
            kwargs, lims=lims, max_scatter_points=max_scatter_points, colorbar_args=colorbar_args
        )
        scattered = []
        for i, (root, alpha_i, marker_i) in enumerate(extend_list_zip(roots, alpha, marker)):
            if i == 0:
                root_color = fixed_color
            elif compare_colors is not None:
                root_color = compare_colors[i - 1]
            else:
                root_color = None
            pts = self.add_4d_scatter(
                root, params, ax, color_bar=color_bar and i == 0, fixed_color=root_color,
                alpha=alpha_i, marker=marker_i, **scatter_common,
            )
            scattered.append(pts)
        axes3 = (ax.xaxis, ax.yaxis, ax.zaxis)
        view = []
        for par, axis in zip(params, axes3):
            requested = lims.get(par.name, (None, None))
            current = axis.get_view_interval()
            view.append(tuple(cur if req is None else req for req, cur in zip(requested, current)))
            self._style_main_axis(axis, True)
        lim_x, lim_y, lim_z = view
        ax.set_xlim(*lim_x)
        ax.set_ylim(*lim_y)
        ax.set_zlim(*lim_z)

        if shadow_color:
            if shadow_color is True:
                shadow_color = ["gray"]
                if len(roots) > 1 and compare_colors is not None:
                    shadow_color.extend(compare_colors)
            if shadow_alpha is None:
                shadow_alpha = alpha
            for (x, y, z), shade, alpha_i, marker_i in extend_list_zip(scattered, shadow_color, shadow_alpha, marker):
                if shade is None:
                    continue
                opts = dict(
                    marker=marker_i or "o", zorder=-1, s=kwargs.get("s", self.settings.scatter_size), alpha=alpha_i
                )
                ax.scatter(x, y, zs=lim_z[0], c=shade, **opts)
                ax.scatter(y, z, zdir="x", zs=lim_x[0], c=shade, **opts)
                ax.scatter(x, z, zdir="y", zs=lim_y[0], c=shade, **opts)

        for set_label, par in zip((self.set_xlabel, self.set_ylabel, self.set_zlabel), params[:3]):
            set_label(par, ax)
        ax.view_init(azim=azim, elev=elev)

        if animate:
            from matplotlib import animation

            anim = animation.FuncAnimation(
                self.fig,
                lambda angle: ax.view_init(azim=azim + angle),
                frames=np.arange(0, anim_angle_degrees, anim_step_degrees),
                interval=1000 / anim_fps,
            )
            self.fig.rot_animation = anim
            if mp4_filename:
                encoder = animation.writers["ffmpeg"](fps=anim_fps, bitrate=mp4_bitrate)
                anim.save(mp4_filename, writer=encoder)

    # -- subplot-array composite plots ---------------------------------------------

    def plots_1d(
        self, roots, params=None, legend_labels=None, legend_ncol=None, label_order=None, nx=None, param_list=None,
        roots_per_param=False, share_y=None, markers=None, title_limit=None, xlims=None, param_renames=None, **kwargs
    ):
        """Array of 1D subplots (see reference ``plots.py:2298-2402``)."""
        roots = makeList(roots)
        if roots_per_param:
            params = [self._resolve_param(root, p, param_renames) for root, p in zip(roots, params)]
        else:
            params = self.get_param_array(roots, params, param_renames)
        if param_list is None:
            param_list = kwargs.pop("paramList", None)
        if param_list is not None:
            keep = ParamNames(param_list).list()
            params = [
                p for p in params
                if p.name in keep or param_renames and param_renames.get(p.name, "") in keep
            ]
        if share_y is None:
            share_y = self.settings.prob_label is not None and len(params) > 1
        elif nx is None and len(params) < 6:
            nx = len(params)
        shape = self.make_figure(len(params), nx=nx, sharey=share_y)
        common = dict(kwargs, param_renames=param_renames, title_limit=title_limit, _no_finish=True)
        for i, param in enumerate(params):
            share = None
            if i > 0 and share_y and not self.settings.norm_1d_density:
                share = self.subplots[0, 0]
            ax = self._axes_by_index(i, pars=(param,), sharey=share)
            interior = share_y and i % self.plot_col > 0
            per_root = roots[i] if roots_per_param else roots
            tick = self._marker_for(markers, i, param.name)
            self.plot_1d(per_root, param, no_ytick=interior, no_ylabel=interior, marker=tick, ax=ax, **common)
            if xlims is not None:
                ax.set_xlim(*xlims[i][:2])
        labels = self._legend_labels_for_roots(legend_labels, roots)
        self.finish_plot(labels, legend_ncol=legend_ncol, label_order=label_order)
        return shape

    def plots_2d(
        self, roots, param1=None, params2=None, param_pairs=None, nx=None, legend_labels=None, legend_ncol=None,
        label_order=None, filled=False, shaded=False, **kwargs
    ):
        """Array of 2D subplots (see reference ``plots.py:2404-2483``)."""
        roots = makeList(roots)
        if isinstance(param1, _list_like) and len(param1) == 2:
            param1, params2 = param1[0], [param1[1]]
        if param_pairs is not None:
            pairs = [(self._resolve_param(roots, a), self._resolve_param(roots, b)) for a, b in param_pairs]
        elif param1 is not None:
            anchor = self._resolve_param(roots, param1)
            others = self.get_param_array(roots, params2)
            pairs = [(anchor, p) for p in others if p.name != anchor.name]
        else:
            raise GetDistPlotError("plots_2d got nothing to plot (no parameters or pairs)")
        if filled and shaded:
            raise GetDistPlotError("filled and shaded are mutually exclusive")
        shape = self.make_figure(len(pairs), nx=nx)
        common = dict(kwargs, filled=filled, shaded=not filled and shaded, _no_finish=True)
        for i, pair in enumerate(pairs):
            cell = self._axes_by_index(i, pars=pair)
            self.plot_2d(roots, param_pair=pair, add_legend_proxy=i == 0, ax=cell, **common)
        labels = self._legend_labels_for_roots(legend_labels, roots)
        self.finish_plot(labels, legend_ncol=legend_ncol, label_order=label_order)
        return shape

    def plots_2d_triplets(self, root_params_triplets, nx=None, filled=False, x_lim=None):
        """Array of 2D plots with different samples/parameters per subplot."""
        plot_col, plot_row = self.make_figure(len(root_params_triplets), nx=nx)
        for i, (root, xpar, ypar) in enumerate(root_params_triplets):
            ax = self._axes_by_index(i, pars=(xpar, ypar))
            self.plot_2d(root, param_pair=[xpar, ypar], filled=filled, add_legend_proxy=i == 0, ax=ax, _no_finish=True)
            if x_lim is not None:
                ax.set_xlim(x_lim)
        self.finish_plot()
        return plot_col, plot_row

    def plots_3d(self, roots, param_sets, nx=None, legend_labels=None, **kwargs):
        """Multiple 3D (color-scatter) subplots."""
        roots = makeList(roots)
        triplets = [[self._resolve_param(roots[0], p) for p in group] for group in param_sets]
        plot_col, plot_row = self.make_figure(len(triplets), nx=nx, ystretch=1 / 1.3)
        for i, triplet in enumerate(triplets):
            self.plot_3d(roots, triplet, ax=self._axes_by_index(i, pars=triplet), _no_finish=True, **kwargs)
        self.finish_plot(self._legend_labels_for_roots(legend_labels, roots[1:]))
        return plot_col, plot_row

    def plots_3d_z(self, roots, param_x, param_y, param_z=None, max_z=None, **kwargs):
        """3D subplots of (x, y) colored by each parameter in param_z."""
        roots = makeList(roots)
        lead = roots[0]
        param_z = self.get_param_array(lead, param_z)
        if max_z is not None and len(param_z) > max_z:
            param_z = param_z[:max_z]
        param_x, param_y = self.get_param_array(lead, [param_x, param_y])
        triplets = [[param_x, param_y, z] for z in param_z if z not in (param_x, param_y)]
        return self.plots_3d(roots, triplets, **kwargs)

    # -- axis tying (shared ranges across triangle/rectangle cells) -----------------

    @staticmethod
    def _sync_x_from_y(_ax):
        # keep a diagonal/first-column partner's x range equal to our y range
        span = _ax.get_ylim()
        partner = _ax._shared_x_axis
        if partner is not None and span != partner.get_xlim():
            partner.set_xlim(span)

    @staticmethod
    def _sync_y_from_x(_ax):
        span = _ax.get_xlim()
        partner = _ax._shared_y_axis
        if partner is not None and span != partner.get_ylim():
            partner.set_ylim(span)

    def _tie_axis(self, ax, partner, via_x):
        """Register a lim-changed callback propagating to a partner axis."""
        if via_x:
            ax._shared_y_axis = partner
            ax.callbacks.connect("xlim_changed", self._sync_y_from_x)
        else:
            ax._shared_x_axis = partner
            ax.callbacks.connect("ylim_changed", self._sync_x_from_y)

    # -- rectangle plot --------------------------------------------------------------

    def rectangle_plot(
        self, xparams, yparams, yroots=None, roots=None, plot_roots=None, plot_texts=None, xmarkers=None,
        ymarkers=None, marker_args=empty_dict, param_limits=empty_dict, legend_labels=None, legend_ncol=None,
        label_order=None, **kwargs
    ):
        """Grid of 2D plots: all xparams against all yparams (see reference
        ``plots.py:2990-3115``)."""
        given = [src for src in (roots, yroots, plot_roots) if src]
        if len(given) > 1:
            raise GetDistPlotError("rectangle_plot needs roots, yroots or plot_roots")
        xparams, yparams = makeList(xparams), makeList(yparams)
        if roots:
            roots = makeList(roots)
        n_cols, n_rows = len(xparams), len(yparams)
        self.make_figure(nx=n_cols, ny=n_rows, sharex=bool(yparams), sharey=bool(xparams))
        union = {}
        row_owners = []  # first-column axes: y-range owner per row
        col_owners = []  # first-row axes: x-range owner per column
        grid = []
        for col, xparam in enumerate(xparams):
            if plot_roots:
                cell_root_lists = plot_roots[col]
            elif roots:
                cell_root_lists = [roots] * n_rows
            else:
                cell_root_lists = yroots
            xmarker = self._marker_for(xmarkers, col, xparam)
            this_column = []
            for row, (yparam, cell_roots) in enumerate(zip(yparams, cell_root_lists)):
                ax = self._cell_axes(
                    col,
                    row,
                    pars=(xparam, yparam),
                    sharex=this_column[0] if row else None,
                    sharey=row_owners[row] if col else None,
                )
                if row == 0:
                    col_owners.append(ax)
                if col == 0:
                    row_owners.append(ax)
                edge_flags = dict(do_xlabel=row == n_rows - 1, do_ylabel=col == 0)
                span = self.plot_2d(
                    cell_roots, param_pair=[xparam, yparam], ax=ax,
                    add_legend_proxy=col == 0 and row == 0, **edge_flags, **kwargs,
                )
                ymarker = self._marker_for(ymarkers, row, yparam)
                for value, draw in ((xmarker, self.add_x_marker), (ymarker, self.add_y_marker)):
                    if value is not None:
                        draw(value, ax=ax, **marker_args)
                union[xparam], union[yparam] = self._merge_spans(span, union.get(xparam), union.get(yparam))
                if row != n_rows - 1:
                    self._hide_x_tick_labels(ax)
                if col != 0:
                    self._hide_y_tick_labels(ax)
                if plot_texts and plot_texts[col][row]:
                    self.add_text_left(plot_texts[col][row], y=0.9, ax=ax)
                self._ticks_inward(ax)
                this_column.append(ax)
            grid.append(this_column)

        for xparam, owner in zip(xparams, col_owners):
            owner.set_xlim(param_limits.get(xparam, union[xparam]))
        for yparam, owner in zip(yparams, row_owners):
            owner.set_ylim(param_limits.get(yparam, union[yparam]))
        self._apply_share_spacing()
        if roots:
            legend_labels = self._legend_labels_for_roots(legend_labels, roots)
        ncol = legend_ncol or self.settings.figure_legend_ncol or len(legend_labels or [])
        self.finish_plot(legend_labels=legend_labels, label_order=label_order, legend_ncol=ncol)
        return grid

    # -- triangle plot -----------------------------------------------------------------

    def _triangle_upper_styles(self, upper_roots, upper_kwargs, filled, contour_args, contour_colors, contour_ls, contour_lws):
        """(contour args, line args) for the upper-triangle sample sets."""
        lower_defaults = dict(
            filled=filled, contour_args=contour_args, contour_colors=contour_colors,
            contour_ls=contour_ls, contour_lws=contour_lws,
        )
        pick = lambda key: upper_kwargs.get(key, lower_defaults[key])  # noqa: E731
        n = len(upper_roots)
        upper_contour_args = self._contour_style_set(
            n, filled=pick("filled"), contour_args=pick("contour_args"),
            colors=pick("contour_colors"), ls=pick("contour_ls"), lws=pick("contour_lws"),
        )
        implied = upper_kwargs.get("line_args") or self._line_args_from_contours(
            upper_contour_args, pick("contour_colors")
        )
        upper_line_args = self._line_style_set(n, line_args=implied, ls=pick("contour_ls"), lws=pick("contour_lws"))
        return upper_contour_args, upper_line_args

    def _triangle_upper_label_axis(self, params, lims, upper_label_right, bottom):
        """Axis carrying the first-row y label; a left twin unless labels go
        on the right."""
        if upper_label_right:
            return self.subplots[0, bottom]
        twin = self.subplots[0, 0].twinx()
        self._ticks_inward(twin)
        twin.yaxis.tick_left()
        twin.yaxis.set_label_position("left")
        twin.yaxis.set_offset_position("left")
        twin.set_ylim(lims[0])
        self.set_ylabel(params[0], ax=twin)
        self._style_main_axis(twin.yaxis, False)
        self.subplots[0, 0].yaxis.set_visible(False)
        return twin

    def _triangle_colorbar(self, n_params, col_param):
        cax = self.fig.add_axes([0.9, 0.6 if n_params == 2 else 0.5, 0.03, 0.35])
        cb = self.fig.colorbar(self.last_scatter, cax=cax)
        cb.ax.yaxis.set_ticks_position("left")
        cb.ax.yaxis.set_label_position("left")
        self.rotate_yticklabels(
            cb.ax,
            rotation=self.settings.colorbar_tick_rotation or 0,
            labelsize=self.settings.colorbar_axes_fontsize,
        )
        flipped = -self.settings.colorbar_label_rotation
        self.add_colorbar_label(cb, col_param, label_rotation=flipped)

    def triangle_plot(
        self, roots, params=None, legend_labels=None, plot_3d_with_param=None, filled=False, shaded=False,
        contour_args=None, contour_colors=None, contour_ls=None, contour_lws=None, line_args=None, label_order=None,
        legend_ncol=None, legend_loc=None, title_limit=None, upper_roots=None, upper_kwargs=empty_dict,
        upper_label_right=False, diag1d_kwargs=empty_dict, markers=None, marker_args=empty_dict,
        param_limits=empty_dict, **kwargs
    ):
        """Triangle (corner) plot: 1D densities on the diagonal, 2D contours
        below, optional second set of samples above (see reference
        ``plots.py:2613-2988`` for the full argument list)."""
        roots = makeList(roots)
        params = self.get_param_array(roots, params)
        n = len(params)
        bottom = n - 1
        col_param = self._resolve_param(roots[0], plot_3d_with_param) if plot_3d_with_param is not None else None
        share_all = self.settings.no_triangle_axis_labels
        self.make_figure(nx=n, ny=n, sharex=share_all, sharey=share_all)
        if kwargs.pop("filled_compare", False):
            filled = True

        upper_contour_args = upper_line_args = None
        if upper_roots is not None:
            if col_param is not None:
                logging.warning("upper_roots and plot_3d_with_param cannot be combined in triangle_plot")
            upper_contour_args, upper_line_args = self._triangle_upper_styles(
                upper_roots, upper_kwargs, filled, contour_args, contour_colors, contour_ls, contour_lws
            )

        style_spec = dict(colors=contour_colors, ls=contour_ls, lws=contour_lws)
        contour_args = self._contour_style_set(len(roots), filled=filled, contour_args=contour_args, **style_spec)
        if line_args is None:
            line_args = self._line_args_from_contours(contour_args, contour_colors)
        line_args = self._line_style_set(len(roots), line_args=line_args, ls=contour_ls, lws=contour_lws)

        # upper-triangle-only sample sets can also appear on the diagonal
        diag_roots = copy.copy(roots)
        if upper_roots is not None:
            show_1d = upper_kwargs.get("show_1d", True)
            if isinstance(show_1d, bool):
                show_1d = [show_1d] * len(upper_line_args)
            for extra_root, style, wanted in zip(upper_roots, upper_line_args, show_1d):
                if wanted and extra_root not in diag_roots:
                    diag_roots.append(extra_root)
                    line_args.append(style)

        lims = self._triangle_build_grid_and_diagonal(
            params, diag_roots, line_args, markers, marker_args, param_limits, title_limit, share_all, diag1d_kwargs
        )

        label_ax = None
        if upper_roots is not None:
            label_ax = self._triangle_upper_label_axis(params, lims, upper_label_right, bottom)
            self._triangle_create_upper_cells(params, label_ax, upper_label_right)

        for col, row in combinations(range(n), 2):
            self._triangle_lower_cell(
                roots, params, col, row, lims, markers, marker_args, contour_args,
                col_param, share_all, shaded, label_ax, kwargs,
            )
            if upper_roots is not None:
                self._triangle_upper_cell(
                    upper_roots,
                    params,
                    col,
                    row,
                    bottom,
                    lims,
                    self._marker_for(markers, col, params[col].name),
                    self._marker_for(markers, row, params[row].name),
                    marker_args,
                    upper_contour_args,
                    upper_label_right,
                    shaded,
                    plot_3d_with_param,
                    col_param,
                    roots,
                )

        self._apply_share_spacing()
        if col_param is not None:
            self._triangle_colorbar(n, col_param)
        self._triangle_legend(
            diag_roots, params, legend_labels, legend_loc, legend_ncol, label_order, title_limit, upper_roots
        )

    def _triangle_build_grid_and_diagonal(
        self, params, diag_roots, line_args, markers, marker_args, param_limits, title_limit, share_all, diag1d_kwargs
    ):
        """Create lower-triangle + diagonal axes column by column, draw the
        diagonal 1D densities, and return the per-parameter x ranges."""
        n = len(params)
        bottom = n - 1
        lims = {}
        for col, param in enumerate(params):
            # lower cells from the bottom row upward so the x-share anchor exists
            for row in range(bottom, col, -1):
                self._cell_axes(
                    col,
                    row,
                    pars=(param, params[row]),
                    sharex=self.subplots[bottom, col] if row != bottom else None,
                    sharey=self.subplots[row, 0] if col else None,
                )
            diag_ax = self._cell_axes(
                col, col, pars=(param,), sharex=self.subplots[bottom, col] if col != bottom else None
            )
            self._ticks_inward(diag_ax, False)
            lims[col] = self.plot_1d(
                diag_roots,
                param,
                marker=self._marker_for(markers, col, param.name),
                do_xlabel=col == bottom,
                no_label_no_numbers=share_all,
                title_limit=title_limit,
                label_right=True,
                no_zero=True,
                no_ylabel=True,
                no_ytick=True,
                line_args=line_args,
                lims=param_limits.get(param.name),
                ax=diag_ax,
                _ret_range=True,
                marker_args=marker_args,
                **diag1d_kwargs,
            )
            if col:
                self._tie_axis(diag_ax, self.subplots[col, 0], via_x=True)
        return lims

    def _triangle_create_upper_cells(self, params, label_ax, upper_label_right):
        """Create the mirrored axes above the diagonal with correct sharing."""
        bottom = len(params) - 1
        for row, param in enumerate(params[:-1]):
            for col in range(bottom, row, -1):
                if row:
                    share_y = self.subplots[row, 0]
                else:
                    share_y = label_ax if (row < bottom or not upper_label_right) else None
                self._cell_axes(col, row, pars=(params[col], param), sharex=self.subplots[bottom, col], sharey=share_y)

    def _triangle_lower_cell(
        self, roots, params, col, row, lims, markers, marker_args, contour_args,
        col_param, share_all, shaded, label_ax, kwargs,
    ):
        """Draw one cell below the diagonal and wire its range ties."""
        bottom = len(params) - 1
        xparam, yparam = params[col], params[row]
        ax = self.subplots[row, col]
        if col_param is not None:
            self.plot_3d(
                roots,
                [xparam, yparam, col_param],
                color_bar=False,
                line_offset=1,
                add_legend_proxy=False,
                do_xlabel=row == bottom,
                do_ylabel=col == 0,
                contour_args=contour_args,
                no_label_no_numbers=share_all,
                ax=ax,
                **kwargs,
            )
        else:
            self.plot_2d(
                roots,
                param_pair=[xparam, yparam],
                do_xlabel=row == bottom,
                do_ylabel=col == 0,
                no_label_no_numbers=share_all,
                shaded=shaded,
                add_legend_proxy=col == 0 and row == 1,
                contour_args=contour_args,
                ax=ax,
                **kwargs,
            )
        xmarker = self._marker_for(markers, col, xparam.name)
        ymarker = self._marker_for(markers, row, yparam.name)
        if xmarker is not None:
            self._draw_marker_set(xmarker, ax, marker_args)
        if ymarker is not None:
            self._draw_marker_set(ymarker, ax, marker_args, y=True)
        self._ticks_inward(ax)
        ax.set_ylim(lims[row])
        self._tie_axis(ax, self.subplots[bottom, row], via_x=False)
        if row == bottom:
            ax.set_xlim(lims[col])
        if col:
            self._tie_axis(ax, self.subplots[col, 0], via_x=True)
        elif label_ax is not None:
            self._tie_axis(ax, label_ax, via_x=True)

    def _triangle_upper_cell(
        self, upper_roots, params, i, i2, bottom, lims, marker, marker2, marker_args, upper_contour_args,
        upper_label_right, shaded, plot_3d_with_param, col_param, roots
    ):
        """One mirrored cell above the diagonal (second sample set)."""
        ax = self.subplots[i, i2]
        mirrored_pair = [params[i2], params[i]]
        right_edge_label = upper_label_right and i2 == bottom
        common = dict(
            ax=ax,
            do_xlabel=False,
            do_ylabel=right_edge_label,
            contour_args=upper_contour_args,
            no_label_no_numbers=self.settings.no_triangle_axis_labels,
        )
        if plot_3d_with_param is not None:
            self.plot_3d(upper_roots, mirrored_pair + [col_param], color_bar=False, line_offset=1,
                         add_legend_proxy=False, **common)
        else:
            reused = [root for root in upper_roots if root in roots]
            self.plot_2d(upper_roots, param_pair=mirrored_pair, shaded=shaded,
                         add_legend_proxy=i == 0 and i2 == 1, proxy_root_exclude=reused, **common)
        if marker is not None:
            self.add_y_marker(marker, ax=ax, **marker_args)
        if marker2 is not None:
            self.add_x_marker(marker2, ax=ax, **marker_args)
        if right_edge_label:
            yaxis = ax.yaxis
            yaxis.set_label_position("right")
            yaxis.set_offset_position("right")
            yaxis.set_tick_params(which="both", labelright=True, labelleft=False)
            self.set_ylabel(params[i], ax=ax, rotation=-90, va="bottom")
        ax.set_xlim(lims[i2])
        ax.set_ylim(lims[i])
        self._tie_axis(ax, self.subplots[bottom, i], via_x=False)
        self._ticks_inward(ax)

    def _triangle_legend(
        self, roots1d, params, legend_labels, legend_loc, legend_ncol, label_order, title_limit, upper_roots
    ):
        labels = self._legend_labels_for_roots(legend_labels, roots1d)
        no_upper = upper_roots is None
        default_loc = self.settings.figure_legend_loc
        if legend_loc:
            pass
        elif default_loc == "upper center" and len(params) < 4 and no_upper:
            legend_loc = "upper right"
        else:
            legend_loc = default_loc
        anchor_args = {}
        if no_upper and "upper" in legend_loc:
            x_anchor = self.plot_col / (2 if "center" in legend_loc else 1)
            anchor_args = dict(
                bbox_to_anchor=(x_anchor, 1), bbox_transform=self.subplots[0, 0].transAxes, borderaxespad=0
            )
        ncol = legend_ncol or self.settings.figure_legend_ncol or (None if no_upper else len(labels))
        self.finish_plot(
            labels,
            label_order=label_order,
            legend_ncol=ncol,
            legend_loc=legend_loc,
            no_extra_legend_space=no_upper,
            no_tight=title_limit or self.settings.title_limit,
            **anchor_args,
        )

    # -- legends / finishing -----------------------------------------------------------

    def samples_for_root(self, root, file_root=None, cache=True, settings=None):
        """MCSamples for a root name (delegates to the sample analyser)."""
        return self.sample_analyser.samples_for_root(root, file_root=file_root, cache=cache, settings=settings)

    def _display_label(self, root, i):
        for getter in ("get_label", "getLabel", "label"):
            if hasattr(root, getter):
                attr = getattr(root, getter)
                root = attr() if callable(attr) else attr
                break
        else:
            for getter in ("get_name", "getName"):
                if hasattr(root, getter):
                    root = escapeLatex(getattr(root, getter)())
                    break
            else:
                if isinstance(root, str):
                    label = self._display_label(self.sample_analyser.samples_for_root(root), i)
                    if label in root and "/" in root:
                        return escapeLatex(root)
                    return label
        return root or "samples" + str(i)

    def _legend_labels_for_roots(self, legend_labels, roots):
        if legend_labels is not None:
            return legend_labels
        if len(roots) < 2:
            return []
        return [self._display_label(root, i) for i, root in enumerate(roots) if root is not None]

    def finish_plot(
        self, legend_labels=None, legend_loc=None, line_offset=0, legend_ncol=None, label_order=None,
        no_extra_legend_space=False, no_tight=False, **legend_args
    ):
        """Finalize spacing and add the figure legend if required."""
        opts = self.settings
        if opts.tight_layout and not (opts.constrained_layout or no_tight):
            self._apply_tight_layout()
        if legend_labels and opts.line_labels:
            legend_args.update(
                label_order=label_order, figure=True, figure_legend_outside=not no_extra_legend_space
            )
            legend = self.add_legend(
                legend_labels, legend_loc or opts.figure_legend_loc, line_offset, legend_ncol, **legend_args
            )
            self.extra_artists = [legend]
        self._apply_share_spacing()

    def _apply_tight_layout(self, rect=None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.gridspec.tight_layout(
                self.fig, h_pad=self._grid_pads.get("h_pad"), w_pad=self._grid_pads.get("w_pad"), rect=rect
            )

    def _apply_share_spacing(self):
        if self._grid_pads and not self.settings.constrained_layout:
            self.fig.subplots_adjust(wspace=self._grid_pads.get("wspace"), hspace=self._grid_pads.get("hspace"))

    def add_legend(
        self, legend_labels, legend_loc=None, line_offset=0, legend_ncol=None, colored_text=None, figure=False,
        ax=None, label_order=None, align_right=False, fontsize=None, figure_legend_outside=True, **kwargs
    ):
        """Add a legend to the axes or figure (see reference
        ``plots.py:2065-2199``)."""
        opts = self.settings
        if legend_loc is None:
            legend_loc = opts.figure_legend_loc if figure else opts.legend_loc
        if colored_text is None:
            colored_text = opts.legend_colored_text
        handles = self._proxy_handles(legend_labels, line_offset, figure, ax)

        text_size = self._font_pts(fontsize or opts.legend_fontsize or opts.axes_labelsize)
        args = dict(kwargs, ncol=legend_ncol or opts.figure_legend_ncol or 1, prop={"size": text_size})
        if colored_text:
            args.update(handlelength=0, handletextpad=0)
        if label_order is not None:
            if str(label_order) == "-1":
                label_order = range(len(handles))[::-1]
            handles = [handles[i] for i in label_order]
            legend_labels = [legend_labels[k] for k in label_order]

        if not figure:
            args["frameon"] = opts.legend_frame and not colored_text
            self.legend = self.get_axes(ax).legend(handles, legend_labels, loc=legend_loc, **args)
        else:
            if figure_legend_outside and args.get("bbox_to_anchor") is None:
                legend_loc = self._outside_legend_anchor(legend_loc, args)
            self.legend = self.fig.legend(handles, legend_labels, loc=legend_loc, **args)
            if not opts.figure_legend_frame:
                self.legend.get_frame().set_edgecolor("none")
        self._finish_legend_style(colored_text, align_right)
        return self.legend

    def _proxy_handles(self, legend_labels, line_offset, figure, ax):
        """Proxy artists for the legend: registered contour proxies when any
        contours were drawn, otherwise per-line styles / existing axis lines."""
        if self.contours_added:
            handles = self.contours_added
            for slot, proxy in enumerate(handles):
                if proxy is None:
                    style = self.lines_added.get(slot)
                    if style:
                        style.pop("filled", None)
                        handles[slot] = matplotlib.lines.Line2D([0, 1], [0, 1], **style)
            return handles
        handles = []
        for slot in range(len(legend_labels)):
            style = self.lines_added.get(slot)
            if not style:
                if not figure:
                    drawn = self.get_axes(ax).lines
                    if slot < len(drawn):
                        handles.append(drawn[slot])
                        continue
                style = self._resolved_line_style(slot + line_offset)
            style.pop("filled", None)
            handles.append(matplotlib.lines.Line2D([0, 1], [0, 1], **style))
        return handles

    def _outside_legend_anchor(self, legend_loc, args):
        """Anchor an outside-the-subplots figure legend; mutates args and
        returns the flipped location string."""
        if legend_loc in ("best", "center"):
            legend_loc = "upper center"
        vert, horiz = legend_loc.split(" ")
        if vert == "center":
            raise ValueError("an outside figure legend cannot be centred")
        margin = self.settings.legend_frac_subplot_margin
        if vert == "upper":
            x = {"left": 0, "right": self.plot_col}.get(horiz, self.plot_col / 2)
            args["bbox_to_anchor"] = (x, 1 + margin)
            args["bbox_transform"] = self.subplots[0, 0].transAxes
        else:
            x = {"left": 0, "right": 1}.get(horiz, 0.5)
            args["bbox_to_anchor"] = (x, -margin / self.plot_row)
            args["bbox_transform"] = self.fig.transFigure
        args["borderaxespad"] = 0
        # anchor from the opposite edge so the box hangs outside the grid
        return {"upper": "lower", "lower": "upper"}[vert] + " " + horiz

    def _finish_legend_style(self, colored_text, align_right):
        if align_right:
            vpack = self.legend._legend_box._children[-1]._children[0]
            for child in vpack._children:
                child._children.reverse()
            vpack.align = "right"
        if not self.settings.legend_rect_border:
            for rect in self.legend.get_patches():
                rect.set_edgecolor(rect.get_facecolor())
        if colored_text:
            for handle, text in zip(self.legend.legend_handles, self.legend.get_texts()):
                handle.set_visible(False)
                if isinstance(handle, matplotlib.lines.Line2D):
                    text.set_color(handle.get_color())
                elif isinstance(handle, matplotlib.patches.Patch):
                    text.set_color(handle.get_facecolor())


style_name = "default"


class StyleManager:
    """Registry mapping style names to plotter classes + rcParams.

    Switching styles snapshots the pre-style rcParams once and restores that
    snapshot before applying the next style, so styles never stack.
    """

    def __init__(self):
        self._plot_styles = {style_name: GetDistPlotter}
        self.active_style = style_name
        self._orig_rc = None

    def active_class(self, style=None):
        if style:
            self.set_active_style(style)
        return self._plot_styles[self.active_style]

    def _restore_rc_snapshot(self):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rcParams.clear()
            rcParams.update(self._orig_rc)

    def set_active_style(self, name=None):
        name = name or style_name
        previous = self.active_style
        if name != previous:
            cls = self._plot_styles.get(name)
            if cls is None:
                raise ValueError(f"style {name} is not registered; import its style module first")
            if self._orig_rc is None:
                self._orig_rc = rcParams.copy()
            else:
                self._restore_rc_snapshot()
            self.active_style = name
            rcParams.update(cls._style_rc)
            if name == style_name:
                self._orig_rc = None
        return previous

    def add_plotter_style(self, name, cls, activate=False):
        self._plot_styles[name] = cls
        if activate:
            self.set_active_style(name)


_style_manager = StyleManager()


def set_active_style(name=None):
    """Set the active plotting style by name; returns the previous style."""
    return _style_manager.set_active_style(name)


def add_plotter_style(name, cls, activate=False):
    """Register a plotting style (plotter subclass), optionally activate."""
    _style_manager.add_plotter_style(name, cls, activate)
