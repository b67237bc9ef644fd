"""The port's last public pieces against the JAX package, on the CPU.

Inputs come from numpy seeds; both packages run here. The pieces: the
package config and logging (one subprocess per package), ``ParamNames``'
keyword I/O, ``KernelOptimizer2D``'s recursive functionals, the
module-level ``convolve1D`` / ``convolve2D``, the native ``bin_columns``
and the 2D optimizer's fragile-signal diagnostics (``ops.batched.fragile_signal``,
the JAX package's ``GETDIST_TPU_FRAGILE_SIGNAL=debug`` stack).
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from getdist_tpu import _native as jax_native  # noqa: E402
from getdist_tpu import kde_bandwidth as jax_kde  # noqa: E402
from getdist_tpu import mcsamples as jax_mcsamples  # noqa: E402
from getdist_tpu import paramnames as jax_paramnames  # noqa: E402
from getdist_tpu.ops import batched as jb  # noqa: E402
from getdist_tpu_torch import _native, mcsamples  # noqa: E402
from getdist_tpu_torch import kde_bandwidth as kde  # noqa: E402
from getdist_tpu_torch import paramnames  # noqa: E402
from getdist_tpu_torch.ops import batched as tb  # noqa: E402
from test_zoo_fidelity import N_2D  # noqa: E402
from zoo import shapes_2d  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# -- package config and logging ----------------------------------------------------------

_CONFIG_KEYS = ("cache_dir", "default_plot_output", "default_grid_root", "output_base_dir", "loglevel")
_READ_CONFIG = """
import json, logging, sys
import {pkg} as g
print(json.dumps({{
    "values": {{k: getattr(g, k) for k in {keys!r}}},
    "params": dict(g.get_config().params),
    "use_plot_data": g.use_plot_data,
    "root_level": logging.getLogger().level,
    "torch_imported": "torch" in sys.modules,
    "set_logging": callable(g.set_logging),
}}))
"""


def _read_config(pkg, env_name, config, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GETDIST_TPU")}
    env.update({"PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu", "GETDIST_TPU_COMPILE_CACHE": "0",
                "HOME": str(tmp_path), env_name: str(config)})
    out = subprocess.run([sys.executable, "-c", _READ_CONFIG.format(pkg=pkg, keys=_CONFIG_KEYS)], env=env,
                         cwd=tmp_path, capture_output=True, text=True, timeout=240, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def config_runs(tmp_path_factory):
    """Both packages read one config file that sets all five keys, and a
    path with no file."""
    tmp = tmp_path_factory.mktemp("config")
    config = tmp / "config.ini"
    config.write_text(f"cache_dir = {tmp / 'cache'}\ndefault_plot_output = png\ndefault_grid_root = {tmp / 'grids'}\n"
                      f"output_base_dir = {tmp / 'out'}\nlogging = INFO\n")
    runs = {}
    for pkg, env_name in (("getdist_tpu", "GETDIST_TPU_CONFIG"), ("getdist_tpu_torch", "GETDIST_TPU_TORCH_CONFIG")):
        runs[pkg] = _read_config(pkg, env_name, config, tmp)
        runs[pkg, "none"] = _read_config(pkg, env_name, tmp / "absent.ini", tmp)
    return runs


@pytest.mark.parametrize("what", [*_CONFIG_KEYS, "params", "use_plot_data", "root_level"])
def test_config_matches_the_jax_package(config_runs, what):
    jax_run, port_run = config_runs["getdist_tpu"], config_runs["getdist_tpu_torch"]
    if what in _CONFIG_KEYS:
        assert port_run["values"][what] == jax_run["values"][what]
        assert port_run["values"][what] is not None
    else:
        assert port_run[what] == jax_run[what]
    assert port_run["params"]["logging"] == "INFO" and port_run["root_level"] == logging.INFO


def test_config_without_a_file(config_runs):
    """No file: an empty ``get_config()``, the default values, no logging
    set; the bare import imports no torch."""
    jax_run, port_run = config_runs["getdist_tpu", "none"], config_runs["getdist_tpu_torch", "none"]
    assert port_run["params"] == jax_run["params"] == {}
    for key in ("default_plot_output", "default_grid_root", "output_base_dir", "loglevel"):
        assert port_run["values"][key] == jax_run["values"][key]
    assert port_run["root_level"] == jax_run["root_level"] == logging.WARNING
    assert not port_run["torch_imported"] and port_run["set_logging"]


# -- ParamNames keyword I/O ----------------------------------------------------------------


class _Keywords:
    """A dict-backed keyword provider (the interface of a FITS-style header)."""

    def __init__(self, entries=None):
        self.entries = dict(entries or {})

    def keyWord_int(self, key):
        return int(self.entries[key][0])

    def keyWordAndComment(self, key):
        return self.entries[key]

    def setKeyWord_int(self, key, value):
        self.entries[key] = (int(value), "")

    def setKeyWord(self, key, value, comment):
        self.entries[key] = (value, comment)


_NAME_SETS = {
    "plain": ["omegabh2\t\\Omega_b h^2\t#baryon density", "omegach2\t\\Omega_c h^2", "tau\t\\tau"],
    "derived": ["ns\tn_s\t#tilt", "H0*\tH_0\t#Hubble rate", "sigma8*\t\\sigma_8", "S8*\tS_8 = \\sigma_8 \\sqrt{\\Omega_m}"],
    "one": ["x*\t\\alpha_{\\rm s}\t#running"],
}


def _names(module, lines):
    names = module.ParamNames()
    names.names = [module.ParamInfo(line) for line in lines]
    return names


def _fields(names):
    return [(p.name, p.label, p.comment, p.isDerived) for p in names.names]


@pytest.mark.parametrize("case", list(_NAME_SETS))
def test_keyword_round_trip_matches_the_jax_package(case):
    saved = {}
    for module in (jax_paramnames, paramnames):
        provider = _Keywords()
        _names(module, _NAME_SETS[case]).saveKeyWords(provider)
        saved[module] = provider.entries
    assert saved[paramnames] == saved[jax_paramnames]
    assert "\\" not in "".join(str(v[0]) for v in saved[paramnames].values())
    loaded = {}
    for module in (jax_paramnames, paramnames):
        names = module.ParamNames()
        assert names.loadFromKeyWords(_Keywords(saved[module])) == len(_NAME_SETS[case])
        loaded[module] = _fields(names)
    assert loaded[paramnames] == loaded[jax_paramnames] == _fields(_names(paramnames, _NAME_SETS[case]))


@pytest.mark.parametrize("comment", ["NULL", "a new comment", ""])
def test_set_from_string_with_comment(comment):
    """``"NULL"`` leaves the line's comment; any other replaces it."""
    port, ref = paramnames.ParamInfo(), jax_paramnames.ParamInfo()
    port.setFromStringWithComment(("w*\tw_0!\t#old", comment))
    ref.setFromStringWithComment(("w*\tw_0!\t#old", comment))
    assert (port.name, port.label, port.comment, port.isDerived) == (ref.name, ref.label, ref.comment, ref.isDerived)
    assert port.comment == ("old" if comment == "NULL" else comment) and port.label == "w_0\\"


# -- KernelOptimizer2D's recursive functionals ------------------------------------------------


@pytest.fixture(scope="module")
def optimizers():
    """``tests/test_bandwidth.py``'s histogram: 40000 correlated normals at
    256 bins, in both packages' optimizers."""
    rng = np.random.RandomState(4)
    pts = rng.multivariate_normal([0, 0], [[1, 0.5], [0.5, 1]], 40000)
    hist, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=256)
    return kde.KernelOptimizer2D(hist, 40000.0, 0.5), jax_kde.KernelOptimizer2D(hist, 40000.0, 0.5)


_EVEN = [(0, 2), (2, 0), (1, 1), (0, 4), (2, 2), (0, 0), (5, 0)]
_ODD = [(1, 3), (3, 1), (3, 3), (1, 7), (5, 5)]


@pytest.mark.parametrize("s", _EVEN + _ODD, ids=str)
def test_functionals_match_the_jax_package(optimizers, s):
    ours, theirs = optimizers
    assert ours.t_star == theirs.t_star
    for t in (ours.t_star, 2e-4):
        fn = "func2d" if s in _EVEN else "func2d_odd"
        a, b = getattr(ours, fn)(s, t), getattr(theirs, fn)(s, t)
        assert abs(a - b) <= 1e-12 * abs(b), (s, t, a, b)
        psi = "psi" if s in _EVEN else "psi_odd"
        assert getattr(ours, psi)(s, t) == getattr(theirs, psi)(s, t)


def test_functionals_equal_the_batched_tables():
    """At t*, the recursion gives the level tables' entries bit for bit; the
    odd one takes p00 from psi_00 at t* until ``get_h`` sets it."""
    pts = np.random.RandomState(9).multivariate_normal([0, 1], [[1, -0.3], [-0.3, 2]], 50000)
    hist, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=128)
    ours = kde.KernelOptimizer2D(hist, 50000.0, -0.3)
    t = ours.t_star
    even = kde._even_table(ours._modes, ours.N, t)
    for s in (key for level in range(5) for key in kde._EVEN_LEVELS[level]):
        assert ours.func2d(s, t) == even[s], s
    p00 = ours._modes.psi(0, 0, t)
    odd = kde._odd_table(ours._power, ours.N, p00, t)
    for s in (key for level in (4, 6, 8) for key in kde._ODD_LEVELS[level]):
        assert ours.func2d_odd(s, t) == odd[s], s
    ours.get_h()
    assert ours.p00 == even[(0, 0)]
    odd = kde._odd_table(ours._power, ours.N, ours.p00, t)
    for s in kde._ODD_LEVELS[4]:
        assert ours.func2d_odd(s, t) == odd[s], s


# -- module-level convolutions -------------------------------------------------------------------

_MODES = [(1, m) for m in ("same", "full", "valid", "periodic")] + [
    (2, m) for m in ("same", "full", "valid", "periodic", "periodic_both", "periodic_x", "periodic_y")
]


def _conv_inputs(dim, seed):
    rng = np.random.default_rng(seed)
    if dim == 1:
        return rng.random(301), np.exp(-0.5 * np.linspace(-4, 4, 41) ** 2)
    return rng.random((97, 83)), np.outer(np.exp(-0.5 * np.linspace(-3, 3, 15) ** 2), np.hanning(11))


def _conv(module, dim):
    return module.convolve1D if dim == 1 else module.convolve2D


@pytest.mark.parametrize("dim,mode", _MODES, ids=[f"{d}d-{m}" for d, m in _MODES])
def test_convolutions_match_the_jax_package(dim, mode, monkeypatch):
    """The host route bitwise the JAX package's; the device-ops route on CPU
    tensors within 1e-12 of the largest value of the JAX device route;
    ``cache=`` changes nothing."""
    x, y = _conv_inputs(dim, seed=dim * 10 + len(mode))
    monkeypatch.delenv("GETDIST_TPU_TORCH_DEVICE_OPS", raising=False)
    monkeypatch.setattr(jax_mcsamples, "_use_device_ops", False)
    host = _conv(mcsamples, dim)(x, y, mode, largest_size=0)
    np.testing.assert_array_equal(host, _conv(jax_mcsamples, dim)(x, y, mode, largest_size=0))
    np.testing.assert_array_equal(_conv(mcsamples, dim)(x, y, mode, cache={}, cache_args=(1,)), host)

    monkeypatch.setenv("GETDIST_TPU_TORCH_DEVICE_OPS", "1")
    monkeypatch.setattr(jax_mcsamples, "_use_device_ops", True)
    dev = _conv(mcsamples, dim)(x, y, mode, device="cpu")
    want = _conv(jax_mcsamples, dim)(x, y, mode)
    assert isinstance(dev, np.ndarray) and dev.dtype == np.float64 and dev.shape == want.shape
    scale = np.max(np.abs(want))
    assert np.max(np.abs(dev - want)) <= 1e-12 * scale
    assert np.max(np.abs(dev - host)) <= 1e-12 * scale
    np.testing.assert_array_equal(_conv(mcsamples, dim)(x, y, mode, cache={}, cache_args=(1,), device="cpu"), dev)
    # the default device is the card: without CUDA the route raises, it never falls back
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _conv(mcsamples, dim)(x, y, mode)


def test_ops_convolutions_take_cache_keywords():
    from getdist_tpu_torch.ops import convolve

    x, y = _conv_inputs(1, seed=3)
    want = convolve.convolve1D_host(x, y, "same")
    np.testing.assert_array_equal(convolve.convolve1D_host(x, y, "same", cache={}, cache_args=(0,)), want)
    got = convolve.convolve1D(torch.from_numpy(x), torch.from_numpy(y), "same", cache={}, cache_args=(0,))
    assert np.max(np.abs(got.numpy() - want)) <= 1e-12 * np.max(np.abs(want))
    x2, y2 = _conv_inputs(2, seed=4)
    want2 = convolve.convolve2D_host(x2, y2, "periodic", cache={})
    got2 = convolve.convolve2D(torch.from_numpy(x2), torch.from_numpy(y2), "periodic", cache={}, cache_args=(0,))
    assert np.max(np.abs(got2.numpy() - want2)) <= 1e-12 * np.max(np.abs(want2))


def test_mcsamples_convolutions_use_the_module_route(monkeypatch):
    """``MCSamples._convolve1D`` / ``_convolve2D`` are the module functions
    on the object's device: one dispatch."""
    calls = []
    monkeypatch.setattr(mcsamples, "convolve1D", lambda *a, **k: calls.append(("1d", str(k["device"]))))
    monkeypatch.setattr(mcsamples, "convolve2D", lambda *a, **k: calls.append(("2d", str(k["device"]))))
    mc = mcsamples.MCSamples(samples=np.random.default_rng(0).normal(size=(50, 2)), names=["a", "b"], device="cpu")
    mc._convolve1D(np.ones(5), np.ones(3), "same")
    mc._convolve2D(np.ones((5, 5)), np.ones((3, 3)), "same")
    assert calls == [("1d", "cpu"), ("2d", "cpu")]


# -- native bin_columns --------------------------------------------------------------------------


def _bin_case(case):
    rng = np.random.default_rng(11)
    if case == "N=0":
        return np.empty((0, 3)), np.zeros(3), np.full(3, 0.1), 16
    p = 1 if case == "P=1" else 7
    samples = rng.normal(size=(5003, p)) * np.arange(1, p + 1)
    lo = samples.min(axis=0) + 0.3  # values below range_min
    nbins = 97
    dx = (samples.max(axis=0) - 0.2 - lo) / (nbins - 1)  # values past the top edge
    samples[:p, :] = lo + dx * np.arange(p)[:, None] * 7  # values on bin edges
    samples[p, :] = lo + dx * nbins  # at the top edge
    samples[p + 1, :] = lo  # at range_min
    return samples, lo, dx, nbins


@pytest.mark.parametrize("case", ["normal", "P=1", "N=0"])
def test_bin_columns_bitwise(case):
    samples, lo, dx, nbins = _bin_case(case)
    got = _native.bin_columns(samples, lo, dx, nbins)
    want = np.clip(((samples - lo) / dx).astype(int), 0, nbins - 1).T.astype(np.int32)
    assert got.dtype == np.int32 and got.shape == (samples.shape[1], samples.shape[0])
    np.testing.assert_array_equal(got, want)
    jax_got = jax_native.bin_columns(samples, lo, dx, nbins)
    assert jax_got is not None
    np.testing.assert_array_equal(got, jax_got)
    if case == "normal":
        assert got.min() == 0 and got.max() == nbins - 1


def test_bin_columns_raises_on_a_bad_call():
    """A non-zero return code raises, where the JAX package returns None."""
    samples, lo, dx, _ = _bin_case("normal")
    assert jax_native.bin_columns(samples, lo, dx, 0) is None
    with pytest.raises(RuntimeError, match="gdt_bin_columns failed with rc 1"):
        _native.bin_columns(samples, lo, dx, 0)
    with pytest.raises(ValueError, match="one range_min and dx per column"):
        _native.bin_columns(samples, lo[:-1], dx, 16)


def test_bin_columns_raises_on_a_failed_build(tmp_path, monkeypatch):
    broken = tmp_path / "pairhist.cpp"
    broken.write_text('extern "C" int gdt_bin_columns( { syntax error\n')
    monkeypatch.setattr(_native, "SOURCE", broken)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    _native.library.cache_clear()
    try:
        samples, lo, dx, nbins = _bin_case("P=1")
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _native.bin_columns(samples, lo, dx, nbins)
    finally:
        _native.library.cache_clear()


# -- the fragile-signal diagnostics ----------------------------------------------------------------

_SHAPES = shapes_2d()


def _optimizer_inputs(label):
    """A zoo chain's 256-bin pair histogram (f64) with its N_eff, sample
    correlation and a plug-in fallback width."""
    samps = _SHAPES[label].MCSamples(N_2D, random_state=7)
    x, y, w = samps.samples[:, 0], samps.samples[:, 1], samps.weights
    hist, _, _ = np.histogram2d(y, x, bins=256, weights=w)
    neff = w.sum() ** 2 / (w**2).sum()
    return hist, neff, np.corrcoef(x, y)[0, 1], (0.25 / neff ** (1 / 6)) ** 2


@pytest.fixture(scope="module")
def debug_stacks():
    """The JAX optimizer's debug stack and bandwidths, the port's
    :func:`fragile_signal` and its optimizer's outputs, on the 17 zoo shapes
    in f64 (the f32 odd functionals are a knife edge between the packages:
    ROADMAP C, knife edges)."""
    hist, neff, corr, fb = (np.array(v) for v in zip(*[_optimizer_inputs(label) for label in _SHAPES]))
    do_corr = np.ones(len(_SHAPES), bool)
    saved = os.environ.get("GETDIST_TPU_FRAGILE_SIGNAL")
    os.environ["GETDIST_TPU_FRAGILE_SIGNAL"] = "debug"
    try:
        jax.clear_caches()  # the JAX switch is read when its program is traced
        want = jax.vmap(jb._kernel_bandwidth_2d)(*(jnp.asarray(v) for v in (hist, neff, corr, do_corr, fb)))
    finally:
        os.environ.pop("GETDIST_TPU_FRAGILE_SIGNAL")
        if saved is not None:
            os.environ["GETDIST_TPU_FRAGILE_SIGNAL"] = saved
        jax.clear_caches()
    args = [torch.from_numpy(v) for v in (hist, neff, corr, do_corr, fb)]
    got = tb.fragile_signal(*args)
    plain = tb._kernel_bandwidth_2d(*args)
    return np.asarray(want[4]), got.numpy(), [np.asarray(w) for w in want[:4]], plain


@pytest.mark.parametrize("k,label", list(enumerate(_SHAPES)), ids=[s.replace(" ", "_") for s in _SHAPES])
def test_fragile_debug_stack_matches_the_jax_package(debug_stacks, k, label):
    """Each entry of rows rho, rho2 and val2 / best within 1e-5 of
    max(1, |JAX's|), rho2 and val2 / best only where the free search
    converged (a failed search leaves them arbitrary); the flag rows equal;
    the port's optimizer, which builds no stack, gives the JAX debug run's
    bandwidths within 1e-5 relative (1e-8 absolute for rho), and its rho is
    rho2 where taken, else rho."""
    want, got, widths, plain = debug_stacks
    assert want.shape == got.shape == (len(_SHAPES), 6)
    np.testing.assert_array_equal(got[k, 3:], want[k, 3:])
    assert set(np.unique(got[k, 3:])) <= {0.0, 1.0}
    for row in (0, 1, 2) if want[k, 4] else (0,):
        assert abs(got[k, row] - want[k, row]) <= 1e-5 * max(1.0, abs(want[k, row])), (label, row, got[k], want[k])
    for a, b in zip(widths[:3], plain[:3]):  # wx, wy, rho
        np.testing.assert_allclose(b[k].item(), a[k], rtol=1e-5, atol=1e-8)
    assert plain[3][k].item() == bool(widths[3][k])  # ok
    assert plain[4].dtype == torch.bool
    assert plain[2][k].item() == (got[k, 1] if got[k, 5] else got[k, 0])


@pytest.mark.parametrize("label", ["Gaussian", "bimodal WJ3", "trimodal WJ2"])
def test_fragile_debug_entry(label, monkeypatch):
    """:func:`fragile_signal` on the inputs of the entry's own optimizer
    call: a (K, 6) stack whose rho rows give the rho the optimizer returned,
    and whose clamp row is set wherever the optimizer flagged a pair
    fragile; on 'trimodal WJ2' the entry rescues such a pair. Setting
    ``GETDIST_TPU_TORCH_FRAGILE_SIGNAL`` changes nothing: the port has no
    such switch."""
    samps = _SHAPES[label].MCSamples(N_2D, random_state=7)
    calls = []
    optimizer = tb._kernel_bandwidth_2d

    def recorded(*args):
        out = optimizer(*args)
        calls.append((args, out))
        return out

    def run():
        mc = mcsamples.MCSamples(samples=samps.samples, weights=samps.weights,
                                 names=[p.name for p in samps.paramNames.names], device="cpu")
        _, d2, pairs = mc.fastTriangleDensities()
        return mc, d2, pairs

    monkeypatch.setattr(tb, "_kernel_bandwidth_2d", recorded)
    mc0, plain, pairs = run()
    monkeypatch.setattr(tb, "_kernel_bandwidth_2d", optimizer)
    assert calls, "the entry ran the optimizer"
    for args, (_, _, rho, _, fragile) in calls:
        stack = tb.fragile_signal(*args)
        assert tuple(stack.shape) == (len(rho), 6) and bool(torch.isfinite(stack[:, [0, 3, 4, 5]]).all())
        assert set(torch.unique(stack[:, 3:]).tolist()) <= {0.0, 1.0}
        assert torch.equal(torch.where(stack[:, 5] == 1, stack[:, 1], stack[:, 0]), rho)
        assert bool((stack[fragile, 3] == 1).all())
    flagged = plain["diag"][: len(pairs)] > 0.5
    rescued = {tuple(p) for g in mc0.fast_regrid_groups if g["bandwidths"] == "fragile" for p in g["pairs"]}
    assert rescued <= {tuple(p) for p, f in zip(pairs, flagged.tolist()) if f}
    if label == "trimodal WJ2":
        assert rescued, "the default run rescues the pair as fragile"

    monkeypatch.setenv("GETDIST_TPU_TORCH_FRAGILE_SIGNAL", "debug")
    _, again, _ = run()
    torch.testing.assert_close(again["diag"], plain["diag"], rtol=0, atol=0)
    torch.testing.assert_close(again["P"], plain["P"], rtol=0, atol=0)
    assert set(again["regrid"]) == set(plain["regrid"])
    for key, entry in again["regrid"].items():
        torch.testing.assert_close(entry["P"], plain["regrid"][key]["P"], rtol=0, atol=0)
