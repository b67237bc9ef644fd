"""The port's GUIs (``getdist_tpu_torch.gui``) against the JAX package's.

``GuiSession(device="cpu")`` and ``getdist_tpu.gui.app_logic.GuiSession()``
run the flows of ``tests/test_gui_session.py`` on the same chain files
(written once by the JAX package's ``Gaussian2D``): a plain directory, a
grid with param tags, a grid with data tags, root ordering, settings
invalidation, the parameter-table tabs and ``changed_settings``. Their
values and text outputs (marginalized, likelihood and convergence stats,
PCA, LaTeX tables) are equal, the JAX side with x64 off (its numpy
statistics, as in ``tests/test_torch_host_api.py``). The port's session
reaches its samples through one ``MCSampleAnalysis`` on its device, which
its plotter shares (a root loads once). A generated plot script equals the
JAX package's but for the package name and the ``device=`` argument, and
it runs to a figure equal to the JAX script's artist by artist
(``tests/test_torch_plots.py``'s comparison). The streamlit app runs
through ``tests/test_gui_session.py``'s fake streamlit module to the JAX
app's texts and scripts. Two faults of the JAX GUIs are shown as not copied:
its LaTeX-table tabs are keyed by their rounded label, which collides
(ROADMAP C5), and its streamlit launcher passes an empty port for a
trailing ``--port`` (C6). The Qt window and the GUI launcher work without
PySide6 (guidance, exit code 1); the syntax highlighter's tables are the
JAX package's; the session's modules import no matplotlib and no yaml
until a figure is asked for. Every recent-directories file lives under
``tmp_path``.
"""

import contextlib
import os
import re
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import getdist_tpu  # noqa: E402
import getdist_tpu_torch  # noqa: E402
import jax  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import command_line as jcommand_line  # noqa: E402
from getdist_tpu.gaussian_mixtures import Gaussian2D  # noqa: E402
from getdist_tpu.gui import SyntaxHighlight as jsh  # noqa: E402
from getdist_tpu.gui import app_logic as japp  # noqa: E402
from getdist_tpu.gui.plot_script import generate_plot_script as jax_script  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import command_line  # noqa: E402
from getdist_tpu_torch import mcsamples as tmcsamples  # noqa: E402
from getdist_tpu_torch.gui import SyntaxHighlight as tsh  # noqa: E402
from getdist_tpu_torch.gui import app_logic as tapp  # noqa: E402
from getdist_tpu_torch.gui.plot_script import generate_plot_script  # noqa: E402
from test_gui_session import FakeStreamlit  # noqa: E402
from test_torch_plots import _compare_axes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def jax_numpy_stats():
    """The JAX package's host path with its numpy statistics (x64 off)."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(autouse=True)
def own_files(tmp_path, monkeypatch):
    """Both packages' pickle caches and the port's recent-directories file
    under tmp_path; the JAX session's recent-directory writes dropped (its
    ``remember_dir`` binds the home-directory file at definition); no load
    chatter; the fused route switch unset."""
    monkeypatch.setattr(getdist_tpu_torch, "cache_dir", str(tmp_path / "torch_cache"))
    monkeypatch.setattr(getdist_tpu, "cache_dir", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(tapp, "RECENT_FILE", str(tmp_path / "recent"))
    monkeypatch.setattr(japp, "RECENT_FILE", str(tmp_path / "jax_recent"))
    monkeypatch.setattr(japp, "remember_dir", lambda directory, *a, **k: [directory])
    monkeypatch.setattr(tchains, "print_load_details", False)
    monkeypatch.setattr(jchains, "print_load_details", False)
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    monkeypatch.delenv("GETDIST_TPU_FUSED", raising=False)


@pytest.fixture(scope="module")
def chain_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("gui_chains")
    s = Gaussian2D([0, 0], (1, 0.8, 0.5)).MCSamples(4000, logLikes=True, random_state=3)
    s.saveChainsAsText(str(d / "sess_chain"))
    return str(d)


@pytest.fixture(scope="module")
def grid_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("gui_grid")
    for tag, seed in (("tagA", 4), ("tagB", 5)):
        sub = base / tag / "chains"
        sub.mkdir(parents=True)
        s = Gaussian2D([0, 0], (1, 0.7, 0.3)).MCSamples(2500, logLikes=True, random_state=seed)
        s.saveChainsAsText(str(sub / f"run_{tag}"))
    return str(base)


@pytest.fixture(scope="module")
def tagged_grid_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("gui_grid_tagged")
    for name, seed in (("base_plikTT", 6), ("base_lowl", 7)):
        sub = base / "base" / "chains"
        sub.mkdir(parents=True, exist_ok=True)
        s = Gaussian2D([0, 0], (1, 0.7, 0.3)).MCSamples(2000, logLikes=True, random_state=seed)
        s.saveChainsAsText(str(sub / name))
    return str(base)


def _sessions(directory=None):
    """(port, JAX) sessions, each opened on ``directory`` if given."""
    port, jax_session = tapp.GuiSession(device="cpu"), japp.GuiSession()
    if directory:
        got = port.open_directory(directory)
        with jax_numpy_stats():
            want = jax_session.open_directory(directory)
        assert got == want
    return port, jax_session


def _stats(session, root, params=("x", "y")):
    """Every statistics view of a session on one root."""
    return {
        "marge": session.marge_stats(root),
        "like": session.like_stats(root),
        "converge": session.converge_stats(root),
        "pca": session.pca_report(root, list(params)),
        "latex": session.latex_table(root),
        "latex_x": session.latex_table(root, ["x"], limit=1),
        "tabs": session.param_table_tabs(root),
        "param_list": session.param_list(root),
        "labels": session.param_names(root).labels(),
    }


def _port_name(text):
    """The JAX package's text as the port writes it."""
    return text.replace("getdist_tpu.", "getdist_tpu_torch.")


def test_settings_schemas_match_jax():
    got, want = tapp.analysis_settings_schema(), japp.analysis_settings_schema()
    assert [(f.name, f.type, f.default, f.help) for f in got] == [(f.name, f.type, f.default, f.help) for f in want]
    got, want = tapp.plot_settings_schema(), japp.plot_settings_schema()
    assert [(f.name, f.type, f.default) for f in got] == [(f.name, f.type, f.default) for f in want]
    by_name = {f.name: f for f in got}
    jax_by_name = {f.name: f for f in want}
    for name, text in (("line_styles", "['-k', '--r']"), ("plot_args", "None"), ("colormap", "viridis"),
                       ("num_plot_contours", "3"), ("alpha_filled_add", "0.5"), ("line_labels", "")):
        assert tapp.parse_plot_setting(by_name[name], text) == japp.parse_plot_setting(jax_by_name[name], text)


def test_script_settings_rewrites_match_jax():
    script = ("import getdist_tpu_torch.plots as gplots\ng = gplots.get_subplot_plotter(chain_dir='/tmp', "
              "subplot_size=2.5, device='cpu')\nroots = ['a']\ng.triangle_plot(roots, ['x'])\n")
    for style in ({"num_plot_contours": 3, "colormap": "viridis"}, {}):
        assert tapp.update_script_plot_settings(script, style) == japp.update_script_plot_settings(script, style)
    for overrides in ({"fine_bins": 512}, {}):
        got = tapp.update_script_analysis_settings(script, overrides)
        assert got == japp.update_script_analysis_settings(script, overrides)
    assert "device='cpu', analysis_settings=analysis_settings)" in tapp.update_script_analysis_settings(
        script, {"fine_bins": 512})


def test_session_flow_plain_directory_matches_jax(chain_dir, tmp_path):
    port, jax_session = _sessions(chain_dir)
    assert not port.is_grid() and port.available_roots() == ["sess_chain"]
    assert (tmp_path / "recent").read_text() == chain_dir
    port.add_root("sess_chain")
    jax_session.add_root("sess_chain")
    got = _stats(port, "sess_chain")
    with jax_numpy_stats():
        want = _stats(jax_session, "sess_chain")
    assert got == want
    assert "Marginalized limits" in got["marge"] and "N_eff" in got["converge"]


def test_session_root_ordering_matches_jax():
    steps = (("move_root", "c", -1), ("move_root", "a", +5), ("remove_root", "b"), ("set_roots", ["a", "c", "d"]),
             ("add_root", "e"), ("add_root", "a"), ("move_root", "absent", 1))
    sessions = _sessions()
    for session in sessions:
        session.root_order = ["a", "b", "c"]
    for name, *args in steps:
        for session in sessions:
            getattr(session, name)(*args)
        assert sessions[0].root_order == sessions[1].root_order, name
    assert sessions[0].root_order == ["c", "a", "d", "e"]


def test_session_grid_browsing_matches_jax(grid_dir):
    port, jax_session = _sessions(grid_dir)
    assert port.is_grid() and port.param_tags() == jax_session.param_tags() == ["tagA", "tagB"]
    for tag in ("tagA", "tagB"):
        assert port.roots_for_tag(tag) == jax_session.roots_for_tag(tag)
        assert port.data_tags(tag) == jax_session.data_tags(tag)
    port.add_root("run_tagB")
    jax_session.add_root("run_tagB")
    got = _stats(port, "run_tagB")
    with jax_numpy_stats():
        want = _stats(jax_session, "run_tagB")
    assert got == want


def test_session_data_tag_browsing_matches_jax(tagged_grid_dir):
    port, jax_session = _sessions(tagged_grid_dir)
    assert port.param_tags() == jax_session.param_tags() == ["base"]
    assert port.data_tags("base") == jax_session.data_tags("base") == ["lowl", "plikTT"]
    for datatag in (None, "plikTT", "lowl", "absent"):
        assert port.roots_for_tag("base", datatag) == jax_session.roots_for_tag("base", datatag)
    got = port.marge_stats("base_lowl")
    with jax_numpy_stats():
        assert got == jax_session.marge_stats("base_lowl")


def test_param_table_tabs_and_changed_settings_match_jax(chain_dir):
    port, jax_session = _sessions(chain_dir)
    tabs = port.param_table_tabs("sess_chain")
    with jax_numpy_stats():
        assert tabs == jax_session.param_table_tabs("sess_chain")
    assert [label for label, _ in tabs] == ["68%", "95%", "99%"] and tabs[0][1] != tabs[1][1]
    assert port.changed_settings() == jax_session.changed_settings() == {}
    for session, package in ((port, "getdist_tpu_torch"), (jax_session, "getdist_tpu")):
        session.apply_analysis_settings({"fine_bins": 512, "ignore_rows": None})
        session.apply_plot_settings({"linewidth": 2.0})
        session.set_plot_module(f"{package}.styles.planck")
    got, want = port.changed_settings(), jax_session.changed_settings()
    assert got == dict(want, style=_port_name(want["style"]))
    assert got["analysis"] == {"fine_bins": 512}
    for session in (port, jax_session):
        session.reset_plot_settings()
        session.set_plot_module(None)
    assert port.changed_settings() == jax_session.changed_settings() == {"analysis": {"fine_bins": 512}}


def test_analysis_settings_invalidate_and_apply(chain_dir):
    """New analysis settings give a new analysis and plotter, whose stats
    equal the JAX session's at the same settings; the plotter works over
    the session's analysis, so a root loads once."""
    port, jax_session = _sessions(chain_dir)
    port.add_root("sess_chain")
    first_analysis, first_plotter = port.analysis(), port.plotter()
    assert first_plotter.sample_analyser is first_analysis
    for session in (port, jax_session):
        session.apply_analysis_settings({"fine_bins": 512, "smooth_scale_1D": 0.5})
    assert port.plotter() is not first_plotter and port.analysis() is not first_analysis
    got = port.marge_stats("sess_chain")
    with jax_numpy_stats():
        assert got == jax_session.marge_stats("sess_chain")
    port.reset_analysis_settings()
    assert port.analysis_settings == {} and port.analysis() is not first_analysis


def test_plotter_shares_the_session_samples(chain_dir, monkeypatch):
    port, _ = _sessions(chain_dir)
    reads = []
    saved = tmcsamples.MCSamples.readChains
    monkeypatch.setattr(tmcsamples.MCSamples, "readChains",
                        lambda self, *a, **k: reads.append(1) or saved(self, *a, **k))
    port.add_root("sess_chain")
    samples = port.samples_for_root("sess_chain")
    assert samples.device == torch.device("cpu")
    plotter = port.plotter()
    assert plotter.sample_analyser is port.analysis() and plotter.sample_analyser.device == "cpu"
    assert plotter.samples_for_root("sess_chain") is samples and port.param_list() == ["x", "y"]
    port.set_plot_module("getdist_tpu_torch.styles.tab10")
    assert port.plotter().samples_for_root("sess_chain") is samples and len(reads) == 1
    port.reload_files()
    assert port.samples_for_root("sess_chain") is not samples


SCRIPT_CASES = {
    "1d": dict(plot_type="1d", x_params=["x"], normalized=True),
    "1d_grid": dict(plot_type="1d_grid", x_params=["x", "y"]),
    "2d_filled": dict(plot_type="2d_filled", x_params=["x", "y"], width_inch=5.0),
    "2d_line": dict(plot_type="2d_line", x_params=["x", "y"], shaded=True),
    "triangle": dict(plot_type="triangle", x_params=["x", "y"], plot_settings={"num_plot_contours": 1}),
    "rectangle": dict(plot_type="rectangle", x_params=["x"], y_params=["y"]),
    "3d": dict(plot_type="3d", x_params=["x", "y"], color_param="x"),
}


@pytest.mark.parametrize("case", sorted(SCRIPT_CASES))
def test_generated_script_and_figure_match_jax(case, chain_dir, monkeypatch):
    """The port's script is the JAX script with the port's package and the
    session's device; both run to figures equal artist by artist (the 3D
    scatter's unit-weight samples, which ``makeSingleSamples`` draws from OS
    entropy, from one seed on both sides)."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: default_rng(5 if seed is None else seed))
    port, jax_session = _sessions(chain_dir)
    for session in (port, jax_session):
        session.add_root("sess_chain")
        session.apply_analysis_settings({"fine_bins_2D": 256})
    spec = tapp.PlotSpec(**SCRIPT_CASES[case])
    jax_spec = japp.PlotSpec(**SCRIPT_CASES[case])
    script = port.script_for(spec)
    want_script = jax_session.script_for(jax_spec)
    plotter_line = re.compile(r"^(g = gplots\.get_\w+_plotter\(.*)\)$", re.M)
    expected = plotter_line.sub(r"\1, device='cpu')", _port_name(want_script))
    assert script == expected and "device='cpu'" in script
    fig, made = port.make_figure(spec)
    assert made == script
    with jax_numpy_stats():
        want_fig, _ = jax_session.make_figure(jax_spec)
    try:
        assert len(fig.axes) == len(want_fig.axes)
        for k, (got_ax, want_ax) in enumerate(zip(fig.axes, want_fig.axes)):
            _compare_axes(got_ax, want_ax, f"{case} axes {k}")
    finally:
        plt.close(fig)
        plt.close(want_fig)


def test_script_reexec_and_validation(chain_dir):
    """Plot-style overrides reach the script, an edited script re-executes
    for the preview, and specs are validated as the JAX session does."""
    port, _ = _sessions(chain_dir)
    port.add_root("sess_chain")
    port.apply_plot_settings({"num_plot_contours": 1})
    fig, script = port.make_figure(tapp.PlotSpec(plot_type="2d_filled", x_params=["x", "y"]))
    assert "g.settings.num_plot_contours = 1" in script
    fig2 = port.run_script(script.replace("num_plot_contours = 1", "num_plot_contours = 3"))
    assert fig2 is not fig
    plt.close(fig)
    plt.close(fig2)
    with pytest.raises(ValueError, match="did not produce a plotter figure"):
        port.run_script("x = 1")
    for kwargs in ({"plot_type": "rectangle", "x_params": ["x"]}, {"plot_type": "2d_line", "x_params": ["x"]}):
        assert tapp.PlotSpec(**kwargs).problems() == japp.PlotSpec(**kwargs).problems() != []
        with pytest.raises(ValueError):
            port.make_figure(tapp.PlotSpec(**kwargs))
    assert generate_plot_script(["r"], ["x"], "1d", device="cuda") == _port_name(
        jax_script(["r"], ["x"], "1d")).replace("get_single_plotter()", "get_single_plotter(device='cuda')")
    with pytest.raises(ValueError, match="unknown plot_type"):
        generate_plot_script(["r"], ["x"], "pie")


def test_style_module_c22(chain_dir):
    """A plot style module chosen in the session is imported and activated
    by its registered name: the port's plotter and script draw in the
    tab10 style; the JAX session passes the module path to
    ``set_active_style``, which no style registers, so its plotter raises
    (ROADMAP C22)."""
    from getdist_tpu_torch import plots as tplots

    port, jax_session = _sessions(chain_dir)
    module = "getdist_tpu_torch.styles.tab10"
    try:
        for session in (port, jax_session):
            session.add_root("sess_chain")
        port.set_plot_module(module)
        jax_session.set_plot_module("getdist_tpu.styles.tab10")
        with pytest.raises(ValueError, match="not registered"):
            jax_session.plotter()
        plotter = port.plotter()
        assert tplots._style_manager.active_style == "tab10" and type(plotter).__name__ == "DefaultColorsPlotter"
        fig, script = port.make_figure(tapp.PlotSpec(plot_type="1d", x_params=["x"]))
        plt.close(fig)
        assert f"import {module}\n" in script and f"gplots.set_active_style({module}.style_name)" in script
        port.set_plot_module(None)
        port.plotter()
        assert tplots._style_manager.active_style == "default"
    finally:
        tplots.set_active_style(None)


class RecordingStreamlit(FakeStreamlit):
    """``tests/test_gui_session.py``'s fake streamlit, also recording the
    download buttons' widget keys."""

    def __init__(self, answers, pressed):
        super().__init__(answers, pressed)
        self.keys = []

    def download_button(self, *a, **kw):
        self.keys.append(kw.get("key"))
        return False


def _drive(app_module, answers, pressed, monkeypatch, argv, session=None):
    fake = RecordingStreamlit(answers, pressed)
    if session is not None:
        fake.session_state["gui_session"] = session
    monkeypatch.setitem(sys.modules, "streamlit", fake)
    monkeypatch.setattr(sys, "argv", argv)
    app_module.main()
    for fig in fake.rec.figures:
        plt.close(fig)
    return fake


APP_FLOWS = {
    "triangle_and_marge": (
        "chain_dir", {"Roots": ["sess_chain"], "X parameters": ["x", "y"], "Plot type": "triangle",
                      "Root": "sess_chain", "View": "Marginalized stats"}, {"Open directory", "Make plot"}),
    "convergence": ("chain_dir", {"Roots": ["sess_chain"], "X parameters": ["x"], "Plot type": "1d",
                                  "Root": "sess_chain", "View": "Convergence"}, {"Open directory"}),
    "pca": ("chain_dir", {"Roots": ["sess_chain"], "X parameters": ["x"], "Plot type": "1d", "Root": "sess_chain",
                          "View": "PCA", "PCA parameters": ["x", "y"]}, {"Open directory"}),
    "latex_tabs": ("chain_dir", {"Roots": ["sess_chain"], "X parameters": ["x"], "Plot type": "1d",
                                 "Root": "sess_chain", "View": "LaTeX table"}, {"Open directory"}),
    "grid_data_tag": ("tagged_grid_dir", {"Parameter tag": "base", "Data tag": "plikTT", "Roots": ["base_plikTT"],
                                          "X parameters": ["x"], "Plot type": "1d",
                                          "Figure width (inch, 0=auto)": 8.0, "Root": "base_plikTT",
                                          "View": "Likelihood stats"}, {"Open directory", "Make plot"}),
    "multi_root": ("grid_dir", {"Parameter tag": "(all)", "Roots": ["run_tagA", "run_tagB"], "X parameters": ["x"],
                                "Plot type": "1d", "Root": "(compare all roots)", "View": "Marginalized stats"},
                   {"Open directory"}),
}


@pytest.mark.parametrize("flow", sorted(APP_FLOWS))
def test_streamlit_app_matches_jax(flow, request, monkeypatch):
    """The port's app (``--device cpu``) and the JAX app on the same
    scripted answers: the same texts, scripts (but the port's package and
    device) and figure count, and no error."""
    import getdist_tpu.gui.streamlit_app as jax_app

    import getdist_tpu_torch.gui.streamlit_app as app

    fixture, answers, pressed = APP_FLOWS[flow]
    answers = dict(answers, **{"Chain directory or grid path": request.getfixturevalue(fixture)})
    got = _drive(app, answers, pressed, monkeypatch, ["streamlit_app.py", "--device", "cpu"])
    with jax_numpy_stats():
        want = _drive(jax_app, answers, pressed, monkeypatch, ["streamlit_app.py"])
    assert not [e for e in got.rec.errors if e[0] == "error"], got.rec.errors
    assert got.session_state["gui_session"].device == "cpu"
    assert got.rec.texts == want.rec.texts and (got.rec.texts or flow == "latex_tabs")
    assert len(got.rec.figures) == len(want.rec.figures) == (1 if "Make plot" in pressed else 0)
    scripts = [c for c in want.rec.codes if "gplots" in c]
    assert [c for c in got.rec.codes if "gplots" in c] == [
        re.sub(r"^(g = gplots\.get_\w+_plotter\(.*)\)$", r"\1, device='cpu')", _port_name(c), flags=re.M)
        for c in scripts]
    assert [c for c in got.rec.codes if "gplots" not in c] == [c for c in want.rec.codes if "gplots" not in c]


def test_streamlit_tabs_keyed_by_limit_index_c5(chain_dir, monkeypatch):
    """Two confidence limits that round to the same label: the JAX app
    keys both tabs' download buttons ``textab_68%`` (streamlit's
    DuplicateWidgetID, ROADMAP C5); the port's keys are the limit
    indices."""
    import getdist_tpu.gui.streamlit_app as jax_app

    import getdist_tpu_torch.gui.streamlit_app as app

    answers = {"Chain directory or grid path": chain_dir, "Roots": ["sess_chain"], "X parameters": ["x"],
               "Plot type": "1d", "Root": "sess_chain", "View": "LaTeX table"}
    settings = {"contours": "0.681 0.684"}
    port, jax_session = _sessions()
    port.apply_analysis_settings(settings)
    jax_session.apply_analysis_settings(settings)
    got = _drive(app, answers, {"Open directory"}, monkeypatch, ["streamlit_app.py", "--device", "cpu"], port)
    with jax_numpy_stats():
        want = _drive(jax_app, answers, {"Open directory"}, monkeypatch, ["streamlit_app.py"], jax_session)
    assert [label for label, _ in port.param_table_tabs("sess_chain")] == ["68%", "68%"]
    assert [k for k in want.keys if k] == ["textab_68%", "textab_68%"]
    assert [k for k in got.keys if k] == ["textab_0", "textab_1"]
    tables = [c for c in got.rec.codes if "\\begin{tabular}" in c]
    assert tables == [c for c in want.rec.codes if "\\begin{tabular}" in c] and len(tables) == 2


def test_streamlit_app_arguments():
    from getdist_tpu_torch.gui.streamlit_app import app_arguments

    assert app_arguments([]) == (None, "cuda")
    assert app_arguments([REPO, "--device", "cpu"]) == (REPO, "cpu")
    assert app_arguments(["/no/such/dir", "--theme.base", "dark"]) == (None, "cuda")


class _FakePopen:
    launched = []

    def __init__(self, args, **kwargs):
        self.launched.append(args)

    def wait(self):
        return 0


@pytest.fixture
def fake_streamlit_install(monkeypatch):
    """``find_spec('streamlit')`` found and ``subprocess.Popen`` recorded,
    in both packages' launchers."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: object() if name == "streamlit"
                        else real(name, *a))
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    _FakePopen.launched = []
    return _FakePopen.launched


def test_streamlit_launcher_c6(fake_streamlit_install, capsys):
    """``--port N`` and the server flags go to streamlit, the chain
    directory and ``--device`` to the app. A trailing ``--port`` is a usage
    error in the port (exit code 1, nothing launched); the JAX launcher
    passes ``--server.port ''`` (ROADMAP C6)."""
    launched = fake_streamlit_install
    app = os.path.join(os.path.dirname(command_line.__file__), "gui", "streamlit_app.py")
    assert command_line.getdist_streamlit(["chains", "--port", "8600", "--device", "cpu",
                                           "--server.headless", "true", "--theme.base=dark"]) == 0
    assert launched.pop() == ["streamlit", "run", app, "--server.port", "8600", "--server.headless", "true",
                              "--theme.base=dark", "--", "chains", "--device", "cpu"]
    assert command_line.getdist_streamlit(["--port=8700"]) == 0
    assert launched.pop() == ["streamlit", "run", app, "--server.port", "8700", "--"]
    for bad in (["chains", "--port"], ["--port", "--device", "cpu"], ["--server.port"]):
        assert command_line.getdist_streamlit(bad) == 1
        assert not launched
        assert "needs a value" in capsys.readouterr().err
        with pytest.raises(ValueError, match="needs a value"):
            command_line.streamlit_arguments(bad)
    jcommand_line.getdist_streamlit(["chains", "--port"])
    assert launched.pop()[3:5] == ["--server.port", ""]


def test_gui_launcher_and_window_without_qt(monkeypatch, capsys):
    """With PySide6 missing, ``mainwindow`` imports (no window classes),
    ``run_gui`` and ``getdist-tpu-torch-gui`` print the guidance and return
    1, as the JAX package's ``run_gui`` does."""
    monkeypatch.setitem(sys.modules, "PySide6", None)
    monkeypatch.delitem(sys.modules, "getdist_tpu_torch.gui.mainwindow", raising=False)
    import getdist_tpu_torch.gui.mainwindow as mw

    assert not mw._HAVE_QT and mw.QMainWindow is object and not hasattr(mw, "MainWindow")
    assert mw.run_gui(device="cpu") == 1
    assert "requires PySide6" in capsys.readouterr().out
    assert command_line.getdist_gui(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "requires PySide6" in out and "getdist-tpu-torch-streamlit" in out
    monkeypatch.delitem(sys.modules, "getdist_tpu.gui.mainwindow", raising=False)
    import getdist_tpu.gui.mainwindow as jmw

    assert jmw.run_gui() == 1


def test_syntax_highlight_tables_match_jax():
    import re as regex

    for name in ("KEYWORDS", "CONSTANTS", "BUILTINS", "RULES", "TRIPLE_DELIMS", "STYLES"):
        assert getattr(tsh, name) == getattr(jsh, name), name
    sample = "def f(x):\n    return str(x) + 'a'  # comment"
    hits = {name for name, rx, _ in tsh.RULES if regex.search(rx, sample)}
    assert {"keyword", "defname", "builtin", "string1", "comment"} <= hits


def test_recent_dirs_file(tmp_path, chain_dir, grid_dir):
    """Recent directories go to the module's file (read at each call), most
    recent first, existing directories only, at most ``keep``."""
    assert tapp.load_recent_dirs() == []
    tapp.remember_dir(chain_dir)
    tapp.remember_dir(grid_dir)
    tapp.remember_dir(str(tmp_path / "gone"))
    assert tapp.load_recent_dirs() == [grid_dir, chain_dir]
    assert tapp.remember_dir(chain_dir, keep=1) == [chain_dir]
    assert tapp.load_recent_dirs() == [chain_dir]
    own = tmp_path / "own_recent"
    tapp.remember_dir(grid_dir, path=str(own))
    assert tapp.load_recent_dirs(str(own)) == [grid_dir]


def test_session_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py covers the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.GuiSession()


BLOCKED = """
import sys
sys.modules["matplotlib"] = None
sys.modules["yaml"] = None
sys.modules["pandas"] = None
import importlib
for name in ("getdist_tpu_torch.command_line", "getdist_tpu_torch.sample_analysis",
             "getdist_tpu_torch.cobaya_interface", "getdist_tpu_torch.arviz_wrapper",
             "getdist_tpu_torch.gui.app_logic", "getdist_tpu_torch.gui.plot_script",
             "getdist_tpu_torch.gui.streamlit_app", "getdist_tpu_torch.gui.mainwindow",
             "getdist_tpu_torch.gui.SyntaxHighlight"):
    importlib.import_module(name)
from getdist_tpu_torch.gui.app_logic import GuiSession, PlotSpec
session = GuiSession(device="cpu")
assert session.open_directory(sys.argv[1]) == ["sess_chain"]
session.add_root("sess_chain")
assert session.param_list() == ["x", "y"]
assert "Marginalized limits" in session.marge_stats("sess_chain")
assert len(session.param_table_tabs("sess_chain")) == 3
assert "device='cpu'" in session.script_for(PlotSpec(plot_type="triangle", x_params=["x", "y"]))
try:
    session.plotter()
except ImportError as error:
    assert "matplotlib" in str(error), error
else:
    raise AssertionError("a plotter without matplotlib")
import numpy as np
from getdist_tpu_torch.cobaya_interface import MCSamplesFromCobaya
class Frame:
    def __init__(self, columns):
        self.columns = columns
    def __iter__(self):
        return iter(self.columns)
class Values:
    def __init__(self, values):
        self.values = values
class Collection:
    def __init__(self, cols):
        self.cols, self.data = cols, Frame(list(cols))
    def __getitem__(self, key):
        if isinstance(key, list):
            return Values(np.column_stack([self.cols[k] for k in key]))
        return Values(np.asarray(self.cols[key]))
a = np.random.default_rng(0).random(2000)
cols = {"weight": np.ones(2000), "minuslogpost": a, "a": a, "minuslogprior": a * 0, "minuslogprior__0": a * 0,
        "chi2": a, "chi2__l": a}
info = {"params": {"a": {"prior": [0, 1]}}, "likelihood": {"l": None}, "sampler": {"mcmc": {}}}
mc = MCSamplesFromCobaya(info, Collection(cols), device="cpu")
assert mc.paramNames.list() == ["a", "chi2", "chi2__l"], mc.paramNames.list()
assert "Marginalized limits" in str(mc.getMargeStats())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "getdist_tpu")]
assert not bad, bad
print("ok")
"""


def test_session_imports_no_matplotlib_or_yaml(chain_dir, tmp_path):
    """In a fresh process with matplotlib, yaml and pandas blocked, the
    batch command's, the data layer's, the interop and the GUI modules
    import; a CPU session browses, lists parameters, gives its statistics
    and tables and writes a script (only its plotter needs matplotlib); and
    ``MCSamplesFromCobaya`` builds an object from numpy stand-in
    collections. Neither JAX nor the JAX package is imported."""
    env = dict(os.environ, PYTHONPATH=REPO, HOME=str(tmp_path), XDG_CACHE_HOME=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-c", BLOCKED, chain_dir], capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
    assert (tmp_path / ".getdist_tpu_torch_recent_dirs").read_text() == chain_dir
