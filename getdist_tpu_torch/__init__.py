"""PyTorch + CUDA port of getdist_tpu.

Its paths, each on a torch device (the card unless the caller names the
CPU):

* ``getdist_tpu_torch.loadMCSamples(root, settings=..., device=...)``:
  an ``MCSamples`` from a chain root on disk (``root_1.txt ...``,
  ``root.paramnames``, ``root.ranges``, ``root.properties.ini``, or a
  Cobaya root's ``root.updated.yaml``), parsed by the port's native
  loader and cached as a pickle in :data:`cache_dir`;
* interop: ``MCSamplesFromCobaya(info, collections, device=...)``
  (:mod:`~getdist_tpu_torch.cobaya_interface`) and
  ``arviz_wrapper.arviz_to_mcsamples(idata, device=...)``: an
  ``MCSamples`` from a Cobaya run's collections or an ArviZ
  ``InferenceData``;
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
  fused program over a process group;
* the batch command ``getdist-tpu-torch`` (:mod:`getdist_tpu_torch.command_line`):
  a chain root's text outputs (``.margestats``, ``.likestats``,
  ``.converge``, ``.covmat``, ``.corr``, ``.PCA``, ``_thin.txt`` and the
  plot scripts, run with ``--make_plots``), on the card unless ``--device
  cpu`` is given;
* the plots (:mod:`getdist_tpu_torch.plots`, matplotlib on the host) over
  the data layer :mod:`getdist_tpu_torch.sample_analysis` (no matplotlib),
  whose density queries run on the plotter's ``device``; chain directory
  trees and grids (:mod:`~getdist_tpu_torch.chain_grid`), Gaussian
  mixtures and Fisher models (:mod:`~getdist_tpu_torch.gaussian_mixtures`,
  :mod:`~getdist_tpu_torch.models`), and the covmat tools ``covscale`` /
  ``covcomb``;
* the GUIs (:mod:`getdist_tpu_torch.gui`): the session logic
  ``gui.app_logic.GuiSession(device=...)`` under a streamlit app and a Qt
  window, launched by ``getdist-tpu-torch-streamlit`` and
  ``getdist-tpu-torch-gui``.

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
beside this file may set another ``cache_dir``, ``default_plot_output``
(the plot scripts' figure format, ``pdf`` by default),
``default_grid_root`` (where a plotter with no ``chain_dir`` looks for
roots), ``output_base_dir`` and ``logging`` (a level given to
:func:`set_logging` at import); :func:`get_config` returns the file as an
``IniFile``. Importing the package imports neither torch, nor the plots,
nor matplotlib.
"""

import logging
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
default_plot_output = "pdf"
default_grid_root = None
output_base_dir = None
loglevel = None
if os.path.exists(_config_file):
    from getdist_tpu_torch.inifile import IniFile

    _ini = IniFile(_config_file)
    cache_dir = _ini.string("cache_dir", "") or cache_dir
    default_plot_output = _ini.string("default_plot_output", default_plot_output)
    default_grid_root = _ini.string("default_grid_root", "") or None
    output_base_dir = _ini.string("output_base_dir", "") or None
    loglevel = _ini.string("logging", "") or None


def set_logging(log_level):
    """Configure package logging (reference getdist/__init__.py:20-23)."""
    logging.basicConfig(level=log_level)


def get_defaults_file(name="analysis_defaults.ini"):
    """Path of a packaged defaults ini (reference getdist/__init__.py:16-17)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


def get_config():
    """The package config as an IniFile: ``$GETDIST_TPU_TORCH_CONFIG`` or the
    packaged config.ini, empty if neither exists (reference
    getdist/__init__.py:26-33)."""
    from getdist_tpu_torch.inifile import IniFile

    return IniFile(_config_file) if os.path.exists(_config_file) else IniFile()


# legacy-compatibility flag carried by the reference (getdist/__init__.py:63)
use_plot_data = False

if loglevel:
    set_logging(loglevel)

default_getdist_settings = get_defaults_file()
distparam_template = get_defaults_file("distparam_template.ini")

# re-exports, imported at first use (a bare import stays cheap and jax-free)
_LAZY_EXPORTS = {
    "WeightedSamples": "getdist_tpu_torch.chains",
    "MCSamples": "getdist_tpu_torch.mcsamples",
    "loadMCSamples": "getdist_tpu_torch.mcsamples",
    "MCSamplesFromCobaya": "getdist_tpu_torch.cobaya_interface",
    "chains": "getdist_tpu_torch.chains",
    "IniFile": "getdist_tpu_torch.inifile",
    "ParamInfo": "getdist_tpu_torch.paramnames",
    "ParamNames": "getdist_tpu_torch.paramnames",
    "ParamBounds": "getdist_tpu_torch.parampriors",
    "densities": "getdist_tpu_torch.densities",
    "types": "getdist_tpu_torch.types",
    "covmat": "getdist_tpu_torch.covmat",
    "CovMat": "getdist_tpu_torch.covmat",
    "plots": "getdist_tpu_torch.plots",
    "get_single_plotter": "getdist_tpu_torch.plots",
    "get_subplot_plotter": "getdist_tpu_torch.plots",
    "gaussian_mixtures": "getdist_tpu_torch.gaussian_mixtures",
}
_MODULE_EXPORTS = {"chains", "densities", "types", "covmat", "plots", "gaussian_mixtures"}


def __getattr__(name):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'getdist_tpu_torch' has no attribute {name!r}")
    import importlib

    module = importlib.import_module(mod)
    if name in _MODULE_EXPORTS:
        return module
    return getattr(module, name)
