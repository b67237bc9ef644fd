"""getdist_tpu_torch's ``MCSamples.fastTriangleDensities`` on the reference
zoo's 2D shapes, against the JAX method.

All 17 shapes of ``tests/zoo.py:shapes_2d``: the 14 unbounded ones and the
three with hard limits ("bending", "cut correlated", "flat"), at N = 40000
(``random_state=7``, as ``tests/test_zoo_fidelity.py`` draws them).
The JAX method runs in 32-bit mode (``jax.enable_x64(False)``, the f32
program a device runs; its reruns then reuse the 256-bin histograms as on
a device), the port on the CPU. Both must take the same route (single
dispatch or two programs), regrid the same pairs at the same fine size,
and serve grids (the regrid's where there is one) within the zoo's
budget (``TOL_2D``, else 5e-3).

Knife edges (``KNIFE_EDGE``): on the CPU the JAX side's f32 odd
functionals psi_31 / psi_13 come out above their Cauchy-Schwarz bound on
these shapes, so it flags the pair FRAGILE, and with its cumulant score
above 0.25 the pair is rerun with f64 host bandwidths; the port's f32
values agree with f64 to ~1e-6, stay within the bound, and it serves its
in-program grid. There the regrid keys differ, and the port's grid is also
held against the reference parity path (``get2DDensityGridData``) at the
zoo's own tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
from getdist_tpu.ops import batched as jb  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from test_zoo_fidelity import DEFAULT_TOL_2D, N_2D, TOL_2D, _max_grid_delta_2d  # noqa: E402
from zoo import shapes_2d  # noqa: E402

_SHAPES = shapes_2d()
BOUNDED = {label for label, shape in _SHAPES.items() if any(v is not None for lim in shape.lims for v in lim)}
KNIFE_EDGE = {"skew": (0, 1), "rotating": (0, 1), "trimodal WJ3": (0, 1), "quadrimodal": (0, 1)}


def _port(samps, lims=None):
    return MCSamples(samples=samps.samples, weights=samps.weights, names=[p.name for p in samps.paramNames.names],
                     ranges=lims, device="cpu")


def _jax_run(samps, monkeypatch):
    """The JAX method in 32-bit mode: (served grids by pair, regrid sizes,
    single-dispatch route taken)."""
    calls = []
    orig = jb._triangle_program

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(jb, "_triangle_program", counted)
    with jax.enable_x64(False):
        _, d2, pairs = samps.fastTriangleDensities(use_pallas=False)
        grids = {key: np.asarray(d2["P"][k]) for k, key in enumerate(pairs)}
        sizes = {}
        for key, entry in d2["regrid"].items():
            grids[key] = np.asarray(entry["P"])
            sizes[key] = grids[key].shape[0]
    return grids, sizes, bool(calls)


def test_zoo_covers_the_unbounded_shapes():
    """All 17 shapes are covered, the three bounded ones among them."""
    assert len(_SHAPES) == 17
    assert BOUNDED == {"bending", "cut correlated", "flat"}
    assert set(KNIFE_EDGE) <= set(_SHAPES) - BOUNDED


@pytest.mark.parametrize("label", list(_SHAPES), ids=[k.replace(" ", "_") for k in _SHAPES])
def test_fast_triangle_tracks_jax_across_unbounded_zoo(label, monkeypatch):
    samps = _SHAPES[label].MCSamples(N_2D, random_state=7)
    want, want_sizes, jax_single = _jax_run(samps, monkeypatch)
    mc = _port(samps, _SHAPES[label].lims)
    _, d2, pairs = mc.fastTriangleDensities()
    assert ("program" in mc.fast_profile) == jax_single, "same route"
    got_sizes = {key: int(entry["P"].shape[0]) for key, entry in d2["regrid"].items()}
    if label in KNIFE_EDGE:
        assert set(got_sizes) <= set(want_sizes) and set(want_sizes) - set(got_sizes) <= {KNIFE_EDGE[label]}
    else:
        assert set(got_sizes) == set(want_sizes)
    for key, size in got_sizes.items():
        assert want_sizes.get(key, 256) == size, "regrid at the same fine size"
    tol = TOL_2D.get(label, DEFAULT_TOL_2D)
    for k, key in enumerate(pairs):
        got = (d2["regrid"][key]["P"] if key in d2["regrid"] else d2["P"][k]).numpy()
        assert got.shape == want[key].shape
        delta = float(np.max(np.abs(got - want[key])))
        assert delta < tol, (label, key, delta)
    if label in KNIFE_EDGE:
        delta = _max_grid_delta_2d(_FastDensitiesView(mc, samps))
        assert delta < tol, (label, "against the parity path", delta)


class _FastDensitiesView:
    """The parity path of the JAX chain beside the port's fastDensities, in
    the interface ``test_zoo_fidelity._max_grid_delta_2d`` reads."""

    def __init__(self, port, samps):
        self.port, self.samps = port, samps

    def get2DDensityGridData(self, i, j):
        return self.samps.get2DDensityGridData(i, j)

    def fastDensities(self, **_):
        return self.port.fastDensities()

    def parName(self, i):
        return self.samps.parName(i)


def test_fragile_assist_engages_on_blind_correlation_searches():
    """'trimodal WJ2': the f32 correlation search runs blind (odd-psi clamp
    binds) and makes no progress, so the port's fused program flags the
    pair and the regrid pass serves f64 host bandwidths."""
    mc = _port(_SHAPES["trimodal WJ2"].MCSamples(N_2D, random_state=7))
    _, d2, pairs = mc.fastTriangleDensities()
    assert bool(d2["fragile"][0]), "fused program no longer flags the pair"
    assert pairs[0] in d2["regrid"], "fragile pair was not host-assisted"
    assert "fragile_regrid" in mc.fast_profile


def test_fragile_assist_skips_gaussian_chains():
    """Gaussian-ish pairs may flag blind searches too, but the host
    cross-cumulant gate must keep them off the (host-priced) assist path."""
    rng = np.random.RandomState(5)
    cols = rng.standard_normal((30000, 4))
    mc = MCSamples(samples=cols, names=[f"p{i}" for i in range(4)], device="cpu")
    _, d2, _ = mc.fastTriangleDensities()
    assert not d2["regrid"], d2["regrid"].keys()
