"""Every public piece of the JAX package has a counterpart in the port.

Both packages' sources are read with ``ast``; neither is imported. For each
module of ``getdist_tpu/`` (one test case a module), every public top-level
function and class, every public method of those classes and every
parameter of those functions and methods must have a counterpart of the
same name in the port's module of the same path
(``ops/pallas_kernels.py`` maps to ``ops/pair_hist.py``). A name the port's
module imports counts as its own (``plots.py`` re-exports
``MCSampleAnalysis`` from ``sample_analysis.py``), and a method may come
from a base class defined anywhere in the port. Two more cases hold the
package's lazy exports (``_LAZY_EXPORTS``) and its environment switches:
each ``GETDIST_TPU_<X>`` string the JAX package reads needs a
``GETDIST_TPU_TORCH_<X>`` in the port.

What the port leaves out on purpose stands in :data:`DELIBERATE`, each
with its reason. An entry whose piece the port has after all fails too,
so that the list stays true.
"""

import ast
import functools
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "getdist_tpu"
PORT_PKG = ROOT / "getdist_tpu_torch"
# a JAX module whose port has another path
RENAMED = {"ops/pallas_kernels.py": "ops/pair_hist.py"}

_TPU = "a TPU or XLA switch; the card always runs its own kernels (ROADMAP: TPU workarounds deliberately not ported)"
_MESH = "a jax.sharding mesh or its axis; the port takes a torch.distributed process group, parallel.init_group (ROADMAP A9)"
_DEV = "parity's device copies of the chain; the port uploads the object's arrays itself (ROADMAP: TPU workarounds deliberately not ported)"
_PALLAS = "a Pallas-only helper; K1's entry is ops/pair_hist.py:pair_histograms (ROADMAP B, K1)"
_XLA_TWIN = "an XLA twin of a Pallas kernel; the port's plain version is ops/dft_conv.py's *_plain (ROADMAP B, K2/K3)"
_RENAME = "renamed in the port to torch's name for it (ROADMAP A12: renames)"
_XLA_ENV = "an XLA-only switch; nothing in the port reads it (ROADMAP: TPU workarounds deliberately not ported)"

# What the port leaves out on purpose. Keys: "<module>::<name>",
# "<module>::<Class>.<method>", either with "(<parameter>)",
# "exports::<name>" (``__init__.py``'s lazy exports) and "env::<switch>".
DELIBERATE = {
    # TPU and XLA switches
    "mcsamples.py::MCSamples.fastDensities(use_pallas)": _TPU,
    "mcsamples.py::MCSamples.fastTriangleDensities(use_pallas)": _TPU,
    "ops/batched.py::all_1d_densities(exact_weights)": _TPU,
    "ops/batched.py::all_2d_densities(use_pallas)": _TPU,
    "ops/batched.py::all_2d_densities(static_pairs)": _TPU,
    "ops/batched.py::all_2d_densities(exact_weights)": _TPU,
    "ops/batched.py::all_2d_densities(dft_precision)": _TPU,
    "ops/batched.py::triangle_densities(use_pallas)": _TPU,
    "ops/batched.py::triangle_densities(exact_weights)": _TPU,
    "ops/dft_conv.py::dft_conv_spectrum(precision)": _TPU,
    "ops/dft_conv.py::dft_conv_spectrum(interpret)": _TPU,
    "ops/dft_conv.py::dft_conv2d(precision)": _TPU,
    "ops/dft_conv.py::dft_conv2d(interpret)": _TPU,
    "ops/pallas_kernels.py::pair_histograms(block)": _TPU,
    "ops/pallas_kernels.py::pair_histograms(group)": _TPU,
    "ops/pallas_kernels.py::pair_histograms(interpret)": _TPU,
    "ops/pallas_kernels.py::pair_histograms_grouped(block)": _TPU,
    "ops/pallas_kernels.py::pair_histograms_grouped(group)": _TPU,
    "ops/pallas_kernels.py::pair_histograms_grouped(interpret)": _TPU,
    "ops/parity_device.py::weight_parts": _TPU,
    "ops/parity_device.py::group_pair_hists(parts)": _TPU,
    "ops/parity_device.py::group_pair_hists(use_pallas)": _TPU,
    "ops/parity_device.py::group_pair_hists(int8_ok)": _TPU,
    "parallel/reductions.py::sharded_pair_hists(interpret)": _TPU,
    "parallel/reductions.py::sharded_triangle_densities(use_pallas)": _TPU,
    "parallel/reductions.py::sharded_triangle_densities(interpret)": _TPU,
    "parallel/reductions.py::sharded_triangle_densities(exact_weights)": _TPU,
    # the mesh and its axis
    "ops/batched.py::all_1d_densities(axis_name)": _MESH,
    "ops/batched.py::all_1d_densities(axis_size)": _MESH,
    "ops/batched.py::all_2d_densities(axis_name)": _MESH,
    "parallel/mesh.py::SAMPLE_AXIS": _MESH,
    "parallel/mesh.py::make_mesh": _MESH,
    "parallel/mesh.py::shard_samples(mesh)": _MESH,
    "parallel/reductions.py::sharded_all_1d_densities(mesh)": _MESH,
    "parallel/reductions.py::sharded_all_2d_densities(mesh)": _MESH,
    "parallel/reductions.py::sharded_moments(mesh)": _MESH,
    "parallel/reductions.py::sharded_hist_1d(mesh)": _MESH,
    "parallel/reductions.py::sharded_pair_hists(mesh)": _MESH,
    "parallel/reductions.py::sharded_triangle_step(mesh)": _MESH,
    "parallel/reductions.py::sharded_triangle_densities(mesh)": _MESH,
    # parity's device arguments
    "ops/parity_device.py::acl_batch(dev_samples_f32)": _DEV,
    "ops/parity_device.py::acl_batch(dev_weights_f32)": _DEV,
    "ops/parity_device.py::kde_neff_batch(dev_samples)": _DEV,
    "ops/parity_device.py::kde_neff_batch(dev_weights)": _DEV,
    # Pallas-only helpers and XLA twins
    "ops/pallas_kernels.py::pair_histograms_tiled": _PALLAS,
    "ops/pallas_kernels.py::tile_plan": _PALLAS,
    "ops/dft_conv.py::dft_conv_spectrum_xla": _XLA_TWIN,
    "ops/dft_conv.py::dft_conv2d_xla": _XLA_TWIN,
    "ops/dft_conv.py::dft_conv2d_ref": _XLA_TWIN,
    # renames
    "ops/fft.py::dct(axis)": _RENAME,
    "ops/fft.py::idct(axis)": _RENAME,
    "ops/pallas_kernels.py::pair_histograms(ix_pm)": _RENAME,
    "ops/pallas_kernels.py::pair_histograms_grouped(ix_pm)": _RENAME,
    # exports and switches
    "exports::loadCobayaSamples": "names a function the JAX package does not have (C19)",
    "env::GETDIST_TPU_NO_NATIVE": "the port's native passes raise and never fall back to numpy (ROADMAP A12)",
    "env::GETDIST_TPU_COMPILE_CACHE": _XLA_ENV,
    "env::GETDIST_TPU_DFT_CONV": _XLA_ENV,
    "env::GETDIST_TPU_DFT_PRECISION": _XLA_ENV,
    "env::GETDIST_TPU_PARITY_CONV_DTYPE": _XLA_ENV,
    "env::GETDIST_TPU_PARITY_DFT": _XLA_ENV,
    "env::GETDIST_TPU_FRAGILE_SIGNAL": "a trace-time switch for XLA's f32 knife edge (ROADMAP: Knife edges); the port gives the same stack from ops/batched.py:fragile_signal, which no path calls",
    "env::GETDIST_TPU_PARITY_PROFILE": "parity's stage times are always in MCSamples.parity_profile (ROADMAP: TPU workarounds deliberately not ported)",
}


# -- reading the sources -----------------------------------------------------------------


def _modules(pkg):
    return sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py") if "_build" not in p.parts)


@functools.cache
def _tree(pkg, rel):
    return ast.parse((pkg / rel).read_text(encoding="utf-8"))


def _params(fn):
    a = fn.args
    names = [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs) if x.arg not in ("self", "cls")]
    if a.vararg is not None:
        names.append("*" + a.vararg.arg)
    if a.kwarg is not None:
        names.append("**" + a.kwarg.arg)
    return names


def _is_public(name):
    return not name.startswith("_") or name == "__init__"


def _top_level(tree):
    """(functions, classes, assigned names, imported names) bound at a
    module's top level, looking into ``if`` / ``try`` blocks."""
    funcs, classes, assigned, imported = {}, {}, set(), set()

    def visit(body):
        for node in body:
            match node:
                case ast.FunctionDef() | ast.AsyncFunctionDef():
                    funcs[node.name] = node
                case ast.ClassDef():
                    classes[node.name] = node
                case ast.Import() | ast.ImportFrom():
                    for alias in node.names:
                        imported.add((alias.asname or alias.name).split(".")[0])
                case ast.Assign():
                    for target in node.targets:
                        assigned.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
                case ast.AnnAssign() | ast.AugAssign() if isinstance(node.target, ast.Name):
                    assigned.add(node.target.id)
                case ast.If():
                    visit(node.body)
                    visit(node.orelse)
                case ast.Try():
                    visit(node.body)
                    for handler in node.handlers:
                        visit(handler.body)
                    visit(node.orelse)
                    visit(node.finalbody)

    visit(tree.body)
    return funcs, classes, assigned, imported


def _class_members(cls):
    """{name: FunctionDef or None} of a class body's methods and attributes."""
    members = {}
    for node in cls.body:
        match node:
            case ast.FunctionDef() | ast.AsyncFunctionDef():
                members[node.name] = node
            case ast.Assign():
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        members[target.id] = None
            case ast.AnnAssign() if isinstance(node.target, ast.Name):
                members[node.target.id] = None
    return members


@functools.cache
def _port_classes():
    """Every class the port defines, by name (bases are found by name)."""
    classes = {}
    for rel in _modules(PORT_PKG):
        for name, node in _top_level(_tree(PORT_PKG, rel))[1].items():
            classes.setdefault(name, []).append(node)
    return classes


def _base_name(base):
    match base:
        case ast.Name():
            return base.id
        case ast.Attribute():
            return base.attr
    return None


def _port_member(cls_nodes, method, classes, seen=None):
    """The port's member ``method`` of a class (its own body, or a base
    class's found by name), or False when it has none."""
    seen = set() if seen is None else seen
    for node in cls_nodes:
        members = _class_members(node)
        if method in members:
            return members[method]
        for base in node.bases:
            name = _base_name(base)
            if name and name not in seen and name in classes:
                seen.add(name)
                found = _port_member(classes[name], method, classes, seen)
                if found is not False:
                    return found
    return False


def _port_function(rel, name, classes):
    """The port's definition of a name its module binds: the module's own
    function or class, or, for an imported name, one of the same name
    elsewhere in the port."""
    funcs, cls = _top_level(_tree(PORT_PKG, rel))[:2]
    if name in funcs:
        return funcs[name]
    if name in cls:
        return cls[name]
    for other in _modules(PORT_PKG):
        f2, c2 = _top_level(_tree(PORT_PKG, other))[:2]
        if name in f2:
            return f2[name]
        if name in c2:
            return c2[name]
    return None


def _missing(rel):
    """Keys of the public pieces of JAX module ``rel`` the port lacks."""
    port_rel = RENAMED.get(rel, rel)
    if not (PORT_PKG / port_rel).exists():
        return [f"{rel}::<module>"]
    jax_funcs, jax_classes, jax_assigned, _ = _top_level(_tree(JAX_PKG, rel))
    port_funcs, port_cls_here, port_assigned, port_imported = _top_level(_tree(PORT_PKG, port_rel))
    bound = set(port_funcs) | set(port_cls_here) | port_assigned | port_imported
    classes = _port_classes()
    missing = []

    def check_params(key, jax_fn, port_fn):
        if port_fn is None:
            return
        have = set(_params(port_fn))
        have_var = {"**" if p.startswith("**") else "*" for p in have if p.startswith("*")}
        for p in _params(jax_fn):
            if p.startswith("**"):
                ok = "**" in have_var
            elif p.startswith("*"):
                ok = "*" in have_var
            else:
                ok = p in have
            if not ok:
                missing.append(f"{key}({p})")

    for name in sorted(jax_assigned):
        if _is_public(name) and name not in bound:
            missing.append(f"{rel}::{name}")

    for name, fn in jax_funcs.items():
        if not _is_public(name):
            continue
        if name not in bound:
            missing.append(f"{rel}::{name}")
            continue
        port_fn = _port_function(port_rel, name, classes)
        if isinstance(port_fn, ast.FunctionDef | ast.AsyncFunctionDef):
            check_params(f"{rel}::{name}", fn, port_fn)

    for name, cls in jax_classes.items():
        if not _is_public(name):
            continue
        if name not in bound:
            missing.append(f"{rel}::{name}")
            continue
        port_cls = classes.get(name)
        if not port_cls:
            missing.append(f"{rel}::{name}")
            continue
        for method, node in _class_members(cls).items():
            if not _is_public(method):
                continue
            port_node = _port_member(port_cls, method, classes)
            if port_node is False:
                if method == "__init__":
                    continue  # a dataclass or an inherited constructor
                missing.append(f"{rel}::{name}.{method}")
            elif node is not None and isinstance(port_node, ast.FunctionDef):
                check_params(f"{rel}::{name}.{method}", node, port_node)
    return missing


def _lazy_exports(pkg):
    for node in _tree(pkg, "__init__.py").body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "_LAZY_EXPORTS" for t in node.targets
        ):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"{pkg.name}/__init__.py has no _LAZY_EXPORTS")


def _switches(pkg, prefix):
    """Environment switch names (whole string constants) in a package's code."""
    pattern = re.compile(re.escape(prefix) + r"[A-Z0-9_]+")
    found = set()
    for rel in _modules(pkg):
        for node in ast.walk(_tree(pkg, rel)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and pattern.fullmatch(node.value):
                found.add(node.value)
    return found


def _check(scope, missing):
    """Missing pieces of one scope against :data:`DELIBERATE`'s entries for it."""
    allowed = {k for k in DELIBERATE if k.startswith(scope)}
    unexplained = sorted(set(missing) - allowed)
    stale = sorted(allowed - set(missing))
    assert not unexplained, f"public pieces of getdist_tpu without a counterpart in the port: {unexplained}"
    assert not stale, f"DELIBERATE entries the port has after all (take them out): {stale}"


# -- the cases ----------------------------------------------------------------------------


@pytest.mark.parametrize("rel", _modules(JAX_PKG))
def test_module_has_its_counterpart(rel):
    _check(f"{rel}::", _missing(rel))


def test_lazy_exports_have_counterparts():
    missing = sorted(f"exports::{name}" for name in _lazy_exports(JAX_PKG) - _lazy_exports(PORT_PKG))
    _check("exports::", missing)


def test_environment_switches_have_counterparts():
    port = _switches(PORT_PKG, "GETDIST_TPU_TORCH_")
    missing = sorted(
        f"env::{name}"
        for name in _switches(JAX_PKG, "GETDIST_TPU_")
        if "GETDIST_TPU_TORCH_" + name[len("GETDIST_TPU_"):] not in port
    )
    _check("env::", missing)


def test_deliberate_entries_name_real_pieces_and_give_reasons():
    """Every entry names a JAX module (or the exports or the switches) and
    gives a one-line reason that cites ROADMAP.md or a C label."""
    modules = set(_modules(JAX_PKG))
    for key, reason in DELIBERATE.items():
        scope = key.split("::")[0]
        assert scope in ("env", "exports") or scope in modules, key
        assert reason and "\n" not in reason, key
        assert "ROADMAP" in reason or re.search(r"\bC\d+\b", reason), (key, reason)
