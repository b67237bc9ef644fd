"""PyTorch + CUDA port of getdist_tpu.

Its paths, each on a torch device (the card unless the caller names the
CPU):

* ``getdist_tpu_torch.loadMCSamples(root, settings=..., device=...)``:
  an ``MCSamples`` from a chain root on disk (``root_1.txt ...``,
  ``root.paramnames``, ``root.ranges``, ``root.properties.ini``), parsed
  by the port's native loader and cached as a pickle in
  :data:`cache_dir`;
* ``getdist_tpu_torch.ops.batched.triangle_densities``: all 1D and
  all-pairs 2D marginalized densities of a weighted chain, the fused path
  (hard limits, periodic parameters, mean-likelihood grids);
* ``getdist_tpu_torch.mcsamples.MCSamples(...).fastTriangleDensities()``:
  the public fused entry with its host rescues, on one device or sharded
  over a ``torch.distributed`` process group (``mesh=``);
* ``MCSamples(...).fastParityDensities(device=True / False)``:
  reference-exact densities (device parity mode, and the host variant for
  any weights), with the port's own jax-free host layer (``chains``,
  ``mcsamples``, ``kde_bandwidth``, ...);
* ``getdist_tpu_torch.parallel``: the sharded sample reductions and the
  fused program over a process group.

Plain tensor code is PyTorch; the TPU's Pallas kernels on those paths are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use,
and the chain loader and the host variant's pair histograms C++ passes
(``_native/``), built with ``g++`` at first use. The package never imports
JAX or ``getdist_tpu``, which stays the reference.

Configuration (counterpart of ``getdist_tpu/__init__.py``, reference
``getdist/__init__.py:26-67``): the pickle cache of ``loadMCSamples``
lives in ``$XDG_CACHE_HOME`` (else ``~/.cache``, ``%LOCALAPPDATA%`` on
Windows) ``/getdist_tpu_torch_cache``, apart from the JAX package's, whose
pickles would import it; ``$GETDIST_TPU_TORCH_CONFIG`` or a ``config.ini``
beside this file may set another ``cache_dir``.
"""

import os

__version__ = "0.3.0"


def _get_cache_dir():
    if os.name == "nt":
        base = os.environ.get("LOCALAPPDATA") or os.path.join(os.path.expanduser("~"), "AppData", "Local")
    else:
        base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "getdist_tpu_torch_cache")


def make_cache_dir():
    """Create (if needed) and return the analysis cache directory, or None on failure."""
    if not cache_dir:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        return cache_dir
    except OSError:
        return None


_config_file = os.environ.get("GETDIST_TPU_TORCH_CONFIG") or os.path.join(os.path.dirname(__file__), "config.ini")

cache_dir = _get_cache_dir()
if os.path.exists(_config_file):
    from getdist_tpu_torch.inifile import IniFile

    cache_dir = IniFile(_config_file).string("cache_dir", "") or cache_dir


def get_defaults_file(name="analysis_defaults.ini"):
    """Path of a packaged defaults ini (reference getdist/__init__.py:16-17)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


default_getdist_settings = get_defaults_file()

# re-exports, imported at first use (a bare import stays cheap and jax-free)
_LAZY_EXPORTS = {
    "WeightedSamples": "getdist_tpu_torch.chains",
    "MCSamples": "getdist_tpu_torch.mcsamples",
    "loadMCSamples": "getdist_tpu_torch.mcsamples",
    "chains": "getdist_tpu_torch.chains",
    "IniFile": "getdist_tpu_torch.inifile",
    "ParamInfo": "getdist_tpu_torch.paramnames",
    "ParamNames": "getdist_tpu_torch.paramnames",
    "ParamBounds": "getdist_tpu_torch.parampriors",
    "densities": "getdist_tpu_torch.densities",
    "types": "getdist_tpu_torch.types",
}
_MODULE_EXPORTS = {"chains", "densities", "types"}


def __getattr__(name):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'getdist_tpu_torch' has no attribute {name!r}")
    import importlib

    module = importlib.import_module(mod)
    if name in _MODULE_EXPORTS:
        return module
    return getattr(module, name)
