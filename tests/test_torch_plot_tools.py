"""The port's small tools against the JAX package's, on the CPU.

* ``matplotlib_ext``: ``BoundedMaxNLocator`` ticks and tick labels equal
  to the JAX package's on the axis bounds of ``tests/test_matplotlib_ext.py``,
  and ``SciFuncFormatter``'s strings;
* ``gaussian_mixtures``: ``pdf``, the analytic ``density1D`` /
  ``density2D`` grids and ``marginalizedMixture`` within 1e-12, and
  ``MCSamples(size, random_state=s)`` samples bitwise equal;
* ``models.fisher``: every function within 1e-12;
* ``covscale`` / ``covcomb``: output files byte-identical on the same
  ``.covmat`` files;
* ``utils.profiling``: ``device_timer`` on CPU tensors fills ``seconds``,
  and ``trace_to`` writes a trace.
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
import getdist_tpu.covcomb as jcovcomb  # noqa: E402
import getdist_tpu.covscale as jcovscale  # noqa: E402
import getdist_tpu.gaussian_mixtures as jgm  # noqa: E402
import getdist_tpu.matplotlib_ext as jext  # noqa: E402
import getdist_tpu.models.fisher as jfisher  # noqa: E402
import getdist_tpu_torch.covcomb as tcovcomb  # noqa: E402
import getdist_tpu_torch.covscale as tcovscale  # noqa: E402
import getdist_tpu_torch.gaussian_mixtures as tgm  # noqa: E402
import getdist_tpu_torch.matplotlib_ext as text  # noqa: E402
import getdist_tpu_torch.models.fisher as tfisher  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch.utils import profiling  # noqa: E402

TOL = 1e-12

# the axis bounds of tests/test_matplotlib_ext.py, each on a 4 x 1 inch and a 1.5 x 1 inch axis
BOUNDS = ([-5.2, 5.2], [0.0219, 0.02232], [3, 3000], [-0.009, 0.009], [1, 1.0004], [0.0253, 0.02915],
          [-1e-4, 14], [7.3, 7.9], [0, 8.2])


def _ticks(ext, bounds, width, prune):
    fig, ax = plt.subplots(1, 1, figsize=(width, 1))
    try:
        ax.plot(bounds, [0, 1])
        ax.xaxis.set_major_locator(ext.BoundedMaxNLocator(prune=prune))
        ax.xaxis.get_major_formatter().useOffset = False
        ax.set_xlim(bounds)
        fig.canvas.draw()
        return list(ax.get_xticks()), [t.get_text() for t in ax.get_xticklabels()]
    finally:
        plt.close(fig)


@pytest.mark.parametrize("bounds", BOUNDS, ids=[str(b) for b in BOUNDS])
@pytest.mark.parametrize("width,prune", [(4, True), (1.5, False)])
def test_locator_matches_jax(bounds, width, prune):
    got, want = _ticks(text, bounds, width, prune), _ticks(jext, bounds, width, prune)
    assert got == want and got[0]


@pytest.mark.parametrize("value", [2e5, 1e-7, 0.5, -3.5e-4, 1.0, 123456.0])
def test_sci_formatter_matches_jax(value):
    got, want = text.SciFuncFormatter(), jext.SciFuncFormatter()
    assert got(value) == want(value) and got.format_data(value) == want.format_data(value)


def _mixture(gm):
    covs = [gm.make_2D_Cov(1.0, 0.6, 0.4), gm.make_2D_Cov(0.5, 1.2, -0.3)]
    return gm.Mixture2D([[0.0, 0.2], [1.1, -0.4]], covs, weights=[0.3, 0.7], names=["a", "b"], label="m")


def _nd(gm):
    return gm.RandomTestMixtureND(4, 2, ["p0", "p1", "p2", "p3"], seed=8)


MIXTURE_CASES = {
    "pdf_2d": lambda gm: _mixture(gm).pdf(np.linspace(-2, 2, 50), np.linspace(-1.5, 2.5, 50)),
    "pdf_nd": lambda gm: _nd(gm).pdf(np.random.default_rng(1).normal(size=(64, 4))),
    "density1D": lambda gm: (lambda d: np.concatenate([d.x, d.P]))(_nd(gm).density1D(2, num_points=256)),
    "density2D": lambda gm: (lambda d: np.concatenate([d.x, d.y, d.P.ravel()]))(_mixture(gm).density2D(
        num_points=128)),
    "marginalizedMixture": lambda gm: (lambda m: np.concatenate([np.ravel(m.means), np.ravel(m.covs),
                                                                 np.ravel(m.weights)]))(
        _nd(gm).marginalizedMixture(["p1", "p3"])),
    "conditionalMixture": lambda gm: (lambda m: np.concatenate([np.ravel(m.means), np.ravel(m.covs)]))(
        _nd(gm).conditionalMixture(["p0"], [0.3])),
    "Gaussian1D": lambda gm: gm.Gaussian1D(0.2, 1.3).pdf(np.linspace(-3, 3, 40)),
}


@pytest.mark.parametrize("case", sorted(MIXTURE_CASES))
def test_mixture_matches_jax(case):
    got, want = (np.asarray(MIXTURE_CASES[case](gm), float) for gm in (tgm, jgm))
    scale = np.max(np.abs(want))
    assert got.shape == want.shape and np.max(np.abs(got - want)) <= TOL * scale


@pytest.mark.parametrize("seed", [10, 11])
def test_mixture_samples_bitwise(seed, monkeypatch):
    monkeypatch.setattr(tchains, "print_load_details", False)
    monkeypatch.setattr(jchains, "print_load_details", False)
    got = _nd(tgm).MCSamples(3000, logLikes=True, random_state=seed, device="cpu")
    with jax.enable_x64(False):
        want = _nd(jgm).MCSamples(3000, logLikes=True, random_state=seed)
    assert np.array_equal(got.samples, want.samples) and np.array_equal(got.loglikes, want.loglikes)
    assert got.getParamNames().list() == want.getParamNames().list() and got.device == torch.device("cpu")


def _fisher(p=4, seed=0):
    a = np.random.default_rng(seed).normal(size=(p, p))
    return a @ a.T + p * np.eye(p)


FISHER_CASES = {
    "fisher_to_cov": lambda f: f.fisher_to_cov(_fisher()),
    "marginalize_fisher": lambda f: f.marginalize_fisher(_fisher(), [0, 2]),
    "condition_fisher": lambda f: f.condition_fisher(_fisher(), [1, 3]),
    "combine_fishers": lambda f: f.combine_fishers(_fisher(seed=1), _fisher(seed=2)),
    "fisher_sigma": lambda f: f.fisher_sigma(_fisher()),
    "fisher_sigma_conditional": lambda f: f.fisher_sigma(_fisher(), marginalized=False),
    "figure_of_merit": lambda f: f.figure_of_merit(_fisher(), 1, 2),
    "confidence_ellipse": lambda f: np.concatenate([np.ravel(v) for v in f.confidence_ellipse(_fisher(), 0, 3)]),
    "gaussian_from_fisher": lambda f: (lambda g: np.concatenate([np.ravel(g.means), np.ravel(g.covs)]))(
        f.gaussian_from_fisher(_fisher(), means=[1, 2, 3, 4])),
}


@pytest.mark.parametrize("case", sorted(FISHER_CASES))
def test_fisher_matches_jax(case):
    got, want = (np.atleast_1d(np.asarray(FISHER_CASES[case](f), float)) for f in (tfisher, jfisher))
    assert got.shape == want.shape and np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def _write_covmats(folder):
    folder.mkdir()
    rng = np.random.default_rng(4)
    for k, names in enumerate((["a", "b", "c"], ["b", "d"], ["c", "e", "a", "f"])):
        a = rng.normal(size=(len(names), len(names)))
        matrix = a @ a.T + np.eye(len(names))
        with open(folder / f"m{k}.covmat", "w", encoding="utf-8") as handle:
            handle.write("# " + " ".join(names) + "\n")
            np.savetxt(handle, matrix, fmt="%15.7E")
    return folder


@pytest.mark.parametrize("tool", ["covscale", "covcomb"])
def test_covmat_tools_byte_identical(tool, tmp_path, capsys):
    source = _write_covmats(tmp_path / "in")
    out = {}
    for which, scale, comb in (("port", tcovscale, tcovcomb), ("jax", jcovscale, jcovcomb)):
        folder = tmp_path / which
        if tool == "covscale":
            assert scale.main([str(source), str(folder), "a:c", "2.0:0.5"]) == 0
        else:
            folder.mkdir()
            paths = [str(source / f"m{k}.covmat") for k in range(3)]
            assert comb.main([str(folder / "merged.covmat")] + paths) == 0
        out[which] = {name: (folder / name).read_bytes() for name in sorted(os.listdir(folder))}
    assert out["port"] == out["jax"] and out["port"]
    assert all(out["port"].values())


@pytest.mark.parametrize("sync", ["argument", "holder", "none"])
def test_device_timer_fills_seconds(sync):
    x = torch.arange(10_000, dtype=torch.float64)
    with profiling.device_timer("sum", sync_value=x if sync == "argument" else None) as holder:
        y = (x * x).sum()
        if sync == "holder":
            holder["sync"] = [y, x]
    assert holder["seconds"] > 0 and float(y) > 0


def test_trace_to_writes_a_trace(tmp_path):
    with profiling.trace_to(str(tmp_path)):
        torch.ones(100).sum()
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))
