"""The port's plots (``getdist_tpu_torch.plots``) against the JAX package's
(``getdist_tpu.plots``), drawn on the CPU with matplotlib's Agg backend.

The same inputs go to both plotters: the ``Mixture2D`` / ``Gaussian2D``
samples of ``tests/test_plots.py`` (4000 rows each, seeds 10 and 11, with
loglikes), drawn by each package's own ``gaussian_mixtures`` (bit for bit
the same samples), the port's on ``device="cpu"``. The JAX side runs with
x64 off, where its densities take their numpy host path, as the port's CPU
objects do. Each figure is compared artist by artist:

* every ``Line2D``'s data within 1e-10 of the axis's largest line value;
* every contour set's levels within 1e-10 relative, and its path vertices
  (and a scatter's offsets) within 1e-8 of the axis span;
* axis limits within 1e-12 relative;
* tick label texts, axis labels, titles, texts and legend texts equal.

Then the plotter's request sequence: a recording ``MCSampleAnalysis``
under ``triangle_plot`` sees the same 1D and 2D requests in the port and
the JAX package, the ones ``chip_smoke.py``'s plot-data phase gathers on
the card (:func:`chip_smoke.triangle_requests`); and the data layer's
modules import with matplotlib and yaml blocked, while the plots module
raises an ImportError naming matplotlib.
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import gaussian_mixtures as jgm  # noqa: E402
from getdist_tpu import plots as jplots  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import gaussian_mixtures as tgm  # noqa: E402
from getdist_tpu_torch import plots as tplots  # noqa: E402
from getdist_tpu_torch import sample_analysis  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

LINE_TOL = 1e-10
LEVEL_RTOL = 1e-10
VERTEX_TOL = 1e-8
LIMIT_RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def quiet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchains, "print_load_details", False)
        mp.setattr(jchains, "print_load_details", False)
        for name in ("GETDIST_TPU_TORCH_FUSED", "GETDIST_TPU_FUSED", "GETDIST_TPU_TORCH_DEVICE_OPS"):
            mp.delenv(name, raising=False)
        yield


def _inputs(gm, **device):
    """The test_plots.py samples and mixture of one package."""
    mix = gm.Mixture2D([[-1, 0], [1, 0]], [(2 / 3, 2 / 3, 0), (2 / 3, 2 / 3, 0)], label="bimodal",
                       names=["x", "y"])
    gauss = gm.Gaussian2D([0, 0], (0.9, 1.1, 0.3), label="gauss")
    s1 = mix.MCSamples(4000, logLikes=True, random_state=10, names=["x", "y"], labels=["x", "y"], **device)
    s2 = gauss.MCSamples(4000, logLikes=True, random_state=11, names=["x", "y"], labels=["x", "y"], **device)
    return {"s1": s1, "s2": s2, "mix": mix}


@pytest.fixture(scope="module")
def inputs():
    with jax.enable_x64(False):
        jax_side = _inputs(jgm)
    return {"port": _inputs(tgm, device="cpu"), "jax": jax_side}


def test_mixture_samples_bitwise(inputs):
    for key in ("s1", "s2"):
        got, want = inputs["port"][key], inputs["jax"][key]
        assert np.array_equal(got.samples, want.samples) and np.array_equal(got.loglikes, want.loglikes)
        assert np.array_equal(got.weights, want.weights)


def _single(mod, which):
    return mod.get_single_plotter(**({"device": "cpu"} if which == "port" else {}))


def _subplot(mod, which):
    return mod.get_subplot_plotter(**({"device": "cpu"} if which == "port" else {}))


def _seed_single_samples(g, root):
    """The scatter's unit-weight samples drawn with one seed on both sides
    (``makeSingleSamples`` draws from OS entropy by default)."""
    g.sample_analyser.single_samples[root] = root.makeSingleSamples(random_state=5)


# each case: (plotter kind, draw(g, objects))
CASES = {
    "plot_1d": ("single", lambda g, o: g.plot_1d([o["s1"], o["s2"]], "x")),
    "plot_2d_filled": ("single", lambda g, o: g.plot_2d([o["s1"], o["s2"]], "x", "y", filled=True)),
    "plot_2d_lines": ("single", lambda g, o: g.plot_2d([o["s1"], o["s2"]], "x", "y", filled=False,
                                                       colors=["red", "blue"])),
    "triangle": ("subplot", lambda g, o: g.triangle_plot([o["s1"], o["s2"]], ["x", "y"], filled=True,
                                                         legend_labels=["A", "B"], markers={"x": 0.0},
                                                         title_limit=1)),
    "triangle_upper": ("subplot", lambda g, o: g.triangle_plot([o["s1"]], ["x", "y"], upper_roots=[o["s2"]],
                                                               filled=True)),
    "rectangle": ("subplot", lambda g, o: g.rectangle_plot(["x"], ["y"], roots=[o["s1"], o["s2"]], filled=True)),
    "plot_3d": ("single", lambda g, o: (_seed_single_samples(g, o["s1"]), g.plot_3d(o["s1"], ["x", "y", "x"]))),
    "plots_1d": ("subplot", lambda g, o: g.plots_1d([o["s1"], o["s2"]], ["x", "y"], legend_labels=["A", "B"])),
    "plots_2d": ("subplot", lambda g, o: g.plots_2d([o["s1"], o["s2"]], param_pairs=[["x", "y"], ["y", "x"]],
                                                    filled=True)),
    "mixture_overlay": ("single", lambda g, o: g.plot_2d([o["s1"], o["mix"]], "x", "y", filled=[True, False])),
    "add_2d_covariance": ("single", lambda g, o: (g.plot_2d(o["s2"], "x", "y"),
                                                  g.add_2d_covariance([0, 0], [[0.81, 0.297], [0.297, 1.21]],
                                                                      color="g"))),
}


def _draw(which, case, inputs, export=None):
    mod = tplots if which == "port" else jplots
    kind, draw = CASES[case]
    with jax.enable_x64(False):
        g = _single(mod, which) if kind == "single" else _subplot(mod, which)
        draw(g, inputs[which])
        g.fig.canvas.draw()
        if export:
            g.export(str(export))
    return g


def _texts(ax):
    legends = [ax.get_legend()] if ax.get_legend() else []
    return {
        "xticks": [t.get_text() for t in ax.get_xticklabels()],
        "yticks": [t.get_text() for t in ax.get_yticklabels()],
        "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
        "texts": [t.get_text() for t in ax.texts],
        "legend": [t.get_text() for leg in legends for t in leg.get_texts()],
    }


def _paths(collection):
    return [p.vertices for p in collection.get_paths()]


def _compare_axes(got, want, where):
    for lim in ("get_xlim", "get_ylim"):
        np.testing.assert_allclose(getattr(got, lim)(), getattr(want, lim)(), rtol=LIMIT_RTOL, atol=0,
                                   err_msg=f"{where} {lim}")
    assert _texts(got) == _texts(want), where
    assert len(got.lines) == len(want.lines), where
    values = [np.abs(np.asarray(d, float)) for ln in want.lines for d in ln.get_data()]
    scale = max((v.max() for v in values if v.size), default=0.0)
    for i, (lg, lw) in enumerate(zip(got.lines, want.lines)):
        for dg, dw in zip(lg.get_data(), lw.get_data()):
            dg, dw = np.asarray(dg, float), np.asarray(dw, float)
            assert dg.shape == dw.shape and np.max(np.abs(dg - dw), initial=0) <= LINE_TOL * scale, (where, i)
    span = np.array([np.ptp(want.get_xlim()), np.ptp(want.get_ylim())])
    assert [type(c).__name__ for c in got.collections] == [type(c).__name__ for c in want.collections], where
    for i, (cg, cw) in enumerate(zip(got.collections, want.collections)):
        if hasattr(cw, "levels"):
            np.testing.assert_allclose(cg.levels, cw.levels, rtol=LEVEL_RTOL, atol=0, err_msg=f"{where} levels {i}")
        pg, pw = _paths(cg), _paths(cw)
        assert [p.shape for p in pg] == [p.shape for p in pw], (where, i)
        for vg, vw in zip(pg, pw):
            assert np.all(np.abs(vg - vw) <= VERTEX_TOL * span), (where, i)
        og, ow = cg.get_offsets(), cw.get_offsets()
        if len(ow) and len(cw.get_paths()) <= 1 and type(cw).__name__ == "PathCollection":
            assert np.shape(og) == np.shape(ow) and np.all(np.abs(np.asarray(og) - ow) <= VERTEX_TOL * span), where
            if cw.get_array() is not None:
                np.testing.assert_allclose(cg.get_array(), cw.get_array(), rtol=LEVEL_RTOL, atol=0, err_msg=where)


@pytest.mark.parametrize("case", sorted(CASES))
def test_figure_matches_jax(inputs, case):
    got, want = (_draw(w, case, inputs) for w in ("port", "jax"))
    try:
        assert len(got.fig.axes) == len(want.fig.axes)
        for k, (ag, aw) in enumerate(zip(got.fig.axes, want.fig.axes)):
            _compare_axes(ag, aw, f"{case} axes {k}")
        got_legends, want_legends = ([[t.get_text() for t in leg.get_texts()] for leg in g.fig.legends]
                                     for g in (got, want))
        assert got_legends == want_legends
    finally:
        plt.close(got.fig)
        plt.close(want.fig)


def test_export_writes_both(inputs, tmp_path):
    for which in ("port", "jax"):
        out = tmp_path / f"{which}.png"
        g = _draw(which, "triangle", inputs, export=out)
        plt.close(g.fig)
        assert out.exists() and out.stat().st_size > 2000


def _recording(base):
    class Recording(base):
        def reset(self, *args, **kwargs):
            super().reset(*args, **kwargs)
            self.requests = []

        def get_density(self, root, param, likes=False):
            self.requests.append(("1d", getattr(param, "name", param), likes))
            return super().get_density(root, param, likes=likes)

        def get_density_grid(self, root, param1, param2, conts=2, likes=False):
            self.requests.append(("2d", param1.name, param2.name, conts, likes))
            return super().get_density_grid(root, param1, param2, conts=conts, likes=likes)

    return Recording


def _triangle_root(gm, **device):
    names = [f"x{i}" for i in range(4)]
    return gm.RandomTestMixtureND(4, 1, names, seed=3).MCSamples(4000, logLikes=True, random_state=4, **device)


@pytest.fixture(scope="module")
def triangle_roots():
    with jax.enable_x64(False):
        jax_root = _triangle_root(jgm)
    return {"port": _triangle_root(tgm, device="cpu"), "jax": jax_root}


@pytest.mark.parametrize("meanlikes", [False, True])
def test_triangle_request_sequence(triangle_roots, meanlikes):
    """The requests triangle_plot makes of its data layer, the port's and
    the JAX package's, are the ones chip_smoke.py's plot-data phase
    gathers."""
    seen = {}
    for which, mod, analysis in (("port", tplots, sample_analysis.MCSampleAnalysis),
                                 ("jax", jplots, jplots.MCSampleAnalysis)):
        root = triangle_roots[which]
        with jax.enable_x64(False):
            g = mod.get_subplot_plotter(**({"device": "cpu"} if which == "port" else {}))
            g.sample_analyser = _recording(analysis)(None)
            g.settings.shade_meanlikes = meanlikes
            g.triangle_plot([root], filled=True)
        plt.close(g.fig)
        seen[which] = g.sample_analyser.requests
    names = triangle_roots["port"].getParamNames().list()
    assert seen["port"] == seen["jax"] == chip_smoke.triangle_requests(names, shade_meanlikes=meanlikes)


def test_plotter_device_reaches_the_analyser():
    g = tplots.get_subplot_plotter(device="cpu")
    assert g.sample_analyser.device == "cpu"
    assert tplots.GetDistPlotter().sample_analyser.device == "cuda"
    assert tplots.MCSampleAnalysis is sample_analysis.MCSampleAnalysis
    assert tplots.GetDistPlotError is sample_analysis.GetDistPlotError


BLOCKED_IMPORTS = """
import sys
sys.modules["matplotlib"] = None
sys.modules["yaml"] = None
import importlib
for name in ("getdist_tpu_torch", "getdist_tpu_torch.sample_analysis", "getdist_tpu_torch.chain_grid",
             "getdist_tpu_torch.gaussian_mixtures", "getdist_tpu_torch.models", "getdist_tpu_torch.covscale",
             "getdist_tpu_torch.covcomb", "getdist_tpu_torch.utils.profiling", "getdist_tpu_torch.command_line"):
    importlib.import_module(name)
try:
    import getdist_tpu_torch.plots
except ImportError as error:
    assert "matplotlib" in str(error), error
else:
    raise AssertionError("getdist_tpu_torch.plots imported without matplotlib")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "getdist_tpu")]
assert not bad, bad
print("ok")
"""


def test_data_layer_imports_without_matplotlib_or_yaml(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
