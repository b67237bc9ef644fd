"""Toolkit-independent GUI session logic shared by the Qt and web GUIs.

The port's own copy of ``getdist_tpu/gui/app_logic.py``. The reference GUIs
(``getdist/gui/mainwindow.py``, ``gui/streamlit_app.py``) mix their state
machines into the rendering code; here the session state —
directory/grid navigation, root management, parameter sync, plot-spec
handling, stats text providers, settings schema — lives in plain objects so
both front ends stay thin and the whole flow is testable without PySide or
streamlit installed.

A :class:`GuiSession` works on a torch ``device`` (the card unless the
caller names the CPU). Its navigation, parameter lists and statistics views
reach the samples through one
:class:`~getdist_tpu_torch.sample_analysis.MCSampleAnalysis` on that device
(on the card, each root's densities come from one fused program), and
import no matplotlib; only :meth:`GuiSession.plotter`,
:meth:`~GuiSession.run_script` and :meth:`~GuiSession.make_figure` import
the plots, and the plotter works over the same loaded samples. Its text
outputs are the JAX session's. The parameter tables' tabs are keyed by
limit index, not by their rounded percent label (two limits that round
alike would collide: ROADMAP C5), and a plot style module is imported and
activated by its registered ``style_name`` (the JAX session passes the
module path, which no style registers: ROADMAP C22).
"""

import os
from dataclasses import dataclass, field

from getdist_tpu_torch.ops._cuda import resolve_device

__all__ = [
    "SettingField",
    "analysis_settings_schema",
    "plot_settings_schema",
    "update_script_plot_settings",
    "update_script_analysis_settings",
    "PlotSpec",
    "GuiSession",
    "load_recent_dirs",
    "remember_dir",
]

# the recent-directories file, read at each call (so it can be redirected)
RECENT_FILE = os.path.join(os.path.expanduser("~"), ".getdist_tpu_torch_recent_dirs")

PLOT_TYPES = (
    "triangle",
    "1d",
    "1d_grid",
    "2d_filled",
    "2d_line",
    "rectangle",
    "3d",
)


def load_recent_dirs(path=None):
    """Previously-opened chain directories that still exist (most recent
    first; role of reference streamlit_app.py:262-282 / QSettings dirs),
    from ``path`` (default :data:`RECENT_FILE`)."""
    try:
        with open(path or RECENT_FILE, encoding="utf-8") as handle:
            lines = [ln.strip() for ln in handle]
        return [ln for ln in lines if ln and os.path.isdir(ln)]
    except OSError:
        return []


def remember_dir(directory, path=None, keep=10):
    """Move ``directory`` to the front of the recent list in ``path``
    (default :data:`RECENT_FILE`)."""
    path = path or RECENT_FILE
    dirs = [directory] + [d for d in load_recent_dirs(path) if d != directory]
    try:
        with open(path, "w", encoding="utf-8") as handle:
            handle.write("\n".join(dirs[:keep]))
    except OSError:
        pass
    return dirs[:keep]


@dataclass
class SettingField:
    """One analysis setting: its ini name, python type, default, and the
    comment lines above it in analysis_defaults.ini (shown as help)."""

    name: str
    type: type
    default: object
    help: str = ""


_INT_KEY_HINTS = ("bins", "order", "points", "chain_num", "first_chain")


def _typed(value, key=""):
    """(typed default, form type) for an ini value; numeric keys edit as
    floats unless the key is a count/order (fractional smooth scales and
    burn-in fractions are common)."""
    if value in ("T", "F"):
        return value == "T", bool
    try:
        number = float(value)
    except ValueError:
        return value, str
    if any(hint in key for hint in _INT_KEY_HINTS):
        return int(number), int
    return number, float


def analysis_settings_schema(ini_file=None):
    """The full analysis-settings form schema, parsed from the packaged
    analysis_defaults.ini (name, type, default, help per key) — the GUIs
    expose every key the analysis engine accepts, as the reference's
    settings dialog does (mainwindow.py:950-1050)."""
    import getdist_tpu_torch
    from getdist_tpu_torch.inifile import IniFile

    ini = IniFile(ini_file or getdist_tpu_torch.default_getdist_settings)
    fields = []
    for key in ini.readOrder:
        raw = ini.params[key]
        value, caster = _typed(raw, key)
        help_text = "\n".join(ini.comments.get(key, []))
        fields.append(SettingField(key, caster, value, help_text))
    return fields


def plot_settings_schema():
    """The plot-settings form schema (name, type, default per knob of
    :class:`~getdist_tpu_torch.plots.GetDistPlotSettings`) — the GUIs expose the
    full style surface for editing, as the reference's plot-settings
    dialog does (``mainwindow.py:993-1021``). Container- and None-valued
    knobs edit as python-literal strings."""
    from getdist_tpu_torch.plots import _PLOT_SETTING_DEFAULTS

    fields = []
    for name in sorted(_PLOT_SETTING_DEFAULTS):
        default = _PLOT_SETTING_DEFAULTS[name]
        if isinstance(default, bool):
            caster = bool
        elif isinstance(default, int):
            caster = int
        elif isinstance(default, float):
            caster = float
        else:
            caster = str
            default = repr(default) if not isinstance(default, str) else default
        fields.append(SettingField(name, caster, default))
    return fields


def parse_plot_setting(field, text):
    """Typed value for a plot-settings form entry: numeric/bool fields cast
    directly; string fields accept python literals (lists, dicts, None) or
    bare words (the reference's eval-with-plain-string fallback,
    ``mainwindow.py:1041-1055``)."""
    if field.type is not str:
        return field.type(text)
    text = text.strip()
    import ast

    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # bare string such as a colormap name


def _is_plotter_line(line):
    return line.startswith("g=") or line.startswith("g = ")


def update_script_plot_settings(script_text, custom_plot_settings):
    """Rewrite the ``g.settings.<key> = <value>`` block of a generated plot
    script to match ``custom_plot_settings`` (the reference edits the script
    pane in place when plot settings change, ``mainwindow.py:1060-1090``)."""
    new_lines = [
        f"g.settings.{key} = {value!r}" for key, value in custom_plot_settings.items()
    ]
    first = None
    kept = []
    for line in script_text.split("\n"):
        if line.startswith("g.settings."):
            if first is None:
                first = len(kept)
            continue
        kept.append(line)
    if first is None:
        first = next(
            (i + 1 for i, line in enumerate(kept) if _is_plotter_line(line)),
            len(kept),
        )
    return "\n".join(kept[:first] + new_lines + kept[first:])


def update_script_analysis_settings(script_text, overrides):
    """Rewrite the ``analysis_settings = {...}`` block of a generated plot
    script (single-line dict form) and make the plotter constructor consume
    it (role of reference ``settingsChanged``, ``mainwindow.py:961-991``)."""
    # drop any existing assignment (the generator emits it as one line)
    lines = [ln for ln in script_text.split("\n") if not ln.startswith("analysis_settings =")]
    if overrides:
        insert_at = next((i for i, ln in enumerate(lines) if _is_plotter_line(ln)), 0)
        lines.insert(insert_at, f"analysis_settings = {overrides!r}")
        for i, ln in enumerate(lines):
            if _is_plotter_line(ln) and "analysis_settings" not in ln:
                lines[i] = ln.rstrip()[:-1] + ", analysis_settings=analysis_settings)"
                break
    return "\n".join(lines)


@dataclass
class PlotSpec:
    """Everything needed to produce one plot (and its script)."""

    plot_type: str = "triangle"
    x_params: list = field(default_factory=list)
    y_params: list = field(default_factory=list)
    color_param: str = None
    filled: bool = True
    shaded: bool = False
    normalized: bool = False
    subplot_size: float = 2.5
    width_inch: float = None
    plot_settings: dict = field(default_factory=dict)

    def required_x(self):
        return {"1d": 1, "2d_filled": 2, "2d_line": 2, "3d": 2}.get(self.plot_type, 1)

    def problems(self):
        """Human-readable validation messages (empty = plottable)."""
        issues = []
        if len(self.x_params) < self.required_x():
            issues.append(f"{self.plot_type} needs at least {self.required_x()} x parameter(s)")
        if self.plot_type == "rectangle" and not self.y_params:
            issues.append("rectangle plots need at least one y parameter")
        return issues


class GuiSession:
    """State machine behind both GUIs.

    Tracks the open chain location (plain directory or grid), the ordered
    list of selected roots, the cached sample analysis and plotter, and the
    current analysis settings; provides script/figure builders and stats
    text providers.
    """

    def __init__(self, device="cuda"):
        """
        :param device: torch device the roots load on (their densities are
            computed there), the card unless the caller names the CPU
            (raises without CUDA)
        """
        self.device = str(resolve_device(device))
        self.chain_dir = None
        self.grid = None  # ChainDirGrid when the directory is a grid
        self.root_order = []  # user-ordered selected roots
        self.analysis_settings = {}
        self.custom_plot_settings = {}  # GetDistPlotSettings overrides
        self.plot_module = None  # style module name, e.g. 'getdist_tpu_torch.styles.planck'
        self._analysis = None
        self._plotter = None

    # -- directory / grid navigation ---------------------------------------

    def open_directory(self, directory):
        """Open a plain chain directory or a grid hierarchy root; returns
        the list of available roots (grids: all roots across param tags)."""
        if not os.path.isdir(directory):
            raise FileNotFoundError(directory)
        from getdist_tpu_torch.chain_grid import ChainDirGrid, get_chain_root_files, load_supported_grid

        self.chain_dir = directory
        self.grid = load_supported_grid(directory)
        if self.grid is None and not get_chain_root_files(directory):
            # no chains at the top level: browse subdirectories as a grid
            tree = ChainDirGrid(directory)
            if tree.roots:
                self.grid = tree
        self.root_order = []
        self._analysis = self._plotter = None
        remember_dir(directory)
        return self.available_roots()

    def is_grid(self):
        return self.grid is not None

    def param_tags(self):
        """Grid navigation level 1: parameter-combination tags."""
        if not self.grid:
            return []
        return sorted(getattr(self.grid, "base_dir_names", []) or getattr(self.grid, "roots", {}))

    def roots_for_tag(self, paramtag, datatag=None):
        """Grid navigation level 2: roots available under one param tag,
        optionally narrowed to one data tag (level 3)."""
        if not self.grid:
            return []
        roots = sorted(self.grid.roots_for_dir(paramtag))
        if datatag:
            roots = [r for r in roots if self._data_tag(r, paramtag) == datatag]
        return roots

    @staticmethod
    def _data_tag(root, paramtag):
        """Data-combination tag of a root under a param tag (the root name
        with the param tag stripped — the reference GUI's paramtag/datatag
        two-level grid browsing, mainwindow.py:1477-1503)."""
        base = root.split("/")[-1]
        if base.startswith(paramtag + "_"):
            return base[len(paramtag) + 1 :]
        return base

    def data_tags(self, paramtag):
        """Distinct data tags available under one param tag."""
        return sorted({self._data_tag(r, paramtag) for r in self.roots_for_tag(paramtag)})

    def available_roots(self):
        """All selectable root names at the current location."""
        if self.grid:
            return sorted(getattr(self.grid, "roots", {}))
        if not self.chain_dir:
            return []
        from getdist_tpu_torch.chain_grid import file_root_to_root, get_chain_root_files

        return sorted(file_root_to_root(r) for r in get_chain_root_files(self.chain_dir))

    # -- root management ----------------------------------------------------

    def add_root(self, root):
        if root not in self.root_order:
            self.root_order.append(root)

    def remove_root(self, root):
        if root in self.root_order:
            self.root_order.remove(root)

    def move_root(self, root, delta):
        """Reorder a selected root up (delta < 0) or down the list."""
        if root not in self.root_order:
            return
        i = self.root_order.index(root)
        j = max(0, min(len(self.root_order) - 1, i + delta))
        self.root_order.insert(j, self.root_order.pop(i))

    def set_roots(self, roots):
        """Replace the selection, keeping existing order for repeats."""
        kept = [r for r in self.root_order if r in roots]
        self.root_order = kept + [r for r in roots if r not in kept]

    # -- sample analysis / plotter / params --------------------------------------

    def analysis(self):
        """The (cached) sample analysis bound to this location and
        settings: root names to samples loaded on the session's device, and
        their densities (no matplotlib)."""
        if self._analysis is None and self.chain_dir:
            from getdist_tpu_torch.sample_analysis import MCSampleAnalysis

            self._analysis = MCSampleAnalysis(
                self.chain_dir, dict(self.analysis_settings) or None, device=self.device
            )
        return self._analysis

    def plotter(self):
        """The (cached) plotter bound to this location and settings, over
        the session's sample analysis (a root loads once)."""
        if self._plotter is None and self.chain_dir:
            import importlib

            from getdist_tpu_torch import plots

            # a style module registers its plotter style under its style_name
            style = importlib.import_module(self.plot_module).style_name if self.plot_module else None
            plots.set_active_style(style)
            self._plotter = plots.get_subplot_plotter(
                chain_dir=self.chain_dir,
                analysis_settings=dict(self.analysis_settings) or None,
                auto_close=True,
                device=self.device,
            )
            self._plotter.sample_analyser = self.analysis()
        return self._plotter

    def reload_files(self):
        """Drop caches so chains re-read from disk (reference reload)."""
        self._analysis = self._plotter = None

    def param_names(self, root=None):
        root = root or (self.root_order[0] if self.root_order else None)
        if root is None:
            return None
        if self.plot_module:
            # a style module may relabel parameters (param_names_for_labels)
            return self.plotter().param_names_for_root(root)
        return self.analysis().params_for_root(root)

    def param_list(self, root=None):
        names = self.param_names(root)
        return names.list() if names else []

    def samples_for_root(self, root):
        return self.analysis().samples_for_root(root)

    # -- settings ---------------------------------------------------------------

    def apply_analysis_settings(self, settings):
        """Set analysis-setting overrides (non-defaults only) and invalidate
        cached sample analyses so they take effect."""
        self.analysis_settings = {k: v for k, v in settings.items() if v is not None}
        self._analysis = self._plotter = None

    def reset_analysis_settings(self):
        self.analysis_settings = {}
        self._analysis = self._plotter = None

    def apply_plot_settings(self, settings):
        """Set plot-style overrides applied to every generated script/figure
        (role of the reference's custom_plot_settings,
        ``mainwindow.py:1038-1058``); values differing from the defaults
        only."""
        self.custom_plot_settings = dict(settings)

    def reset_plot_settings(self):
        self.custom_plot_settings = {}

    def set_plot_module(self, module_name):
        self.plot_module = module_name or None
        self._plotter = None

    # -- plotting ---------------------------------------------------------------

    def script_for(self, spec):
        """The runnable script for a plot spec (always generated first, as
        the reference GUI does, so every figure is reproducible). Session
        plot-style overrides merge under any spec-level ones."""
        from getdist_tpu_torch.gui.plot_script import generate_plot_script

        merged_style = {**self.custom_plot_settings, **dict(spec.plot_settings)}
        return generate_plot_script(
            list(self.root_order),
            list(spec.x_params),
            spec.plot_type,
            chain_dir=self.chain_dir,
            filled=spec.filled,
            shaded=spec.shaded,
            normalized=spec.normalized,
            color_param=spec.color_param,
            y_params=list(spec.y_params),
            subplot_size=spec.subplot_size,
            width_inch=spec.width_inch,
            analysis_settings=dict(self.analysis_settings) or None,
            plot_module=self.plot_module,
            plot_settings=merged_style or None,
            device=self.device,
        )

    def run_script(self, script_text):
        """Execute (possibly user-edited) plot-script text and return the
        resulting figure — the reference GUI's editable-script preview
        (``mainwindow.py:plotData2``): edits in the script pane drive the
        next preview rather than being discarded."""
        env = {}
        exec(compile(script_text, "<gui plot script>", "exec"), env)  # noqa: S102 - the GUI's own script
        plotter = env.get("g")
        if plotter is None or getattr(plotter, "fig", None) is None:
            raise ValueError("script did not produce a plotter figure (expected a 'g' with g.fig)")
        return plotter.fig

    def make_figure(self, spec):
        """(figure, script): build the script, execute it, return both."""
        issues = spec.problems()
        if issues:
            raise ValueError("; ".join(issues))
        script = self.script_for(spec)
        return self.run_script(script), script

    # -- statistics views -----------------------------------------------------------

    def marge_stats(self, root):
        return str(self.samples_for_root(root).getMargeStats())

    def like_stats(self, root):
        stats = self.samples_for_root(root).getLikeStats()
        return str(stats) if stats else "No likelihood values in samples"

    def converge_stats(self, root):
        samples = self.samples_for_root(root)
        return samples.getConvergeTests(samples.converge_test_limit)

    def pca_report(self, root, params):
        return self.samples_for_root(root).PCA(list(params))

    def latex_table(self, root, params=None, limit=2):
        samples = self.samples_for_root(root)
        kwargs = {"limit": limit}
        if params:
            kwargs["paramList"] = list(params)
        return samples.getTable(columns=1, **kwargs).tableTex()

    def param_table_tabs(self, root, params=None):
        """[(limit label, LaTeX table)] for every confidence limit of the
        root's marge stats, in limit order — the reference's parameter-table
        dialog shows one tab per limit (mainwindow.py:893-931,
        DialogParamTables). Labels may repeat (two limits that round to the
        same percent): front ends key a tab by its index."""
        samples = self.samples_for_root(root)
        stats = samples.getMargeStats()
        tabs = []
        for i, lim in enumerate(stats.limits):
            label = f"{round(lim * 100) if lim <= 1 else lim:g}%"
            tabs.append((label, self.latex_table(root, params, limit=i + 1)))
        return tabs

    def changed_settings(self):
        """Current non-default option state, for display in the GUIs (the
        reference's changed-settings summaries, mainwindow.py:943-949)."""
        out = {}
        if self.analysis_settings:
            out["analysis"] = dict(self.analysis_settings)
        if self.custom_plot_settings:
            out["plot"] = dict(self.custom_plot_settings)
        if self.plot_module:
            out["style"] = self.plot_module
        return out
