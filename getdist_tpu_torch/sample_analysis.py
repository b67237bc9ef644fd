"""The plotter's data layer: root names to loaded samples and their cached
1D / 2D densities (the port's copy of ``RootInfo``, ``MCSampleAnalysis``
and ``GetDistPlotError`` of ``getdist_tpu/plots.py:55``, ``:257-448``).

A module of its own so that it imports neither matplotlib nor yaml: the
plotter (:mod:`getdist_tpu_torch.plots`, which re-exports these names)
draws on the host, while this layer's density queries go to the port's
``MCSamples.get1DDensityGridData`` / ``get2DDensityGridData``. On a CUDA
object those are served by one fused program run (``fastDensities``:
K1, K2 and K3 on the card, cached on the object), so a triangle plot of
30 parameters costs one program, not 30 + 435 host KDEs. Samples load on
``device``, the card unless the caller names the CPU.
"""

import os
from collections.abc import Iterable, Mapping

import getdist_tpu_torch
from getdist_tpu_torch._base import _BaseObject
from getdist_tpu_torch.chain_grid import ChainDirGrid, get_chain_root_files, is_grid_object, load_supported_grid
from getdist_tpu_torch.chains import findChainFileRoot
from getdist_tpu_torch.gaussian_mixtures import MixtureND
from getdist_tpu_torch.inifile import IniFile
from getdist_tpu_torch.mcsamples import MCSamples, loadMCSamples
from getdist_tpu_torch.paramnames import ParamInfo

__all__ = ["GetDistPlotError", "RootInfo", "MCSampleAnalysis"]


class GetDistPlotError(Exception):
    """Error raised while plotting."""


class RootInfo:
    """Information about a set of samples on disk."""

    __slots__ = ["batch", "path", "root"]

    def __init__(self, root: str, path: str, batch=None):
        self.root = root
        self.batch = batch
        self.path = path


class MCSampleAnalysis(_BaseObject):
    """Maps root names to cached MCSamples and cached 1D/2D densities.

    Accessed as plotter.sample_analyser; the seam where root-name strings
    become loaded samples on ``device``.
    """

    def __init__(self, chain_locations, settings=None, device="cuda"):
        """
        :param chain_locations: directory/grid path (or list searched in order)
        :param settings: IniFile, .ini filename, or settings dict
        :param device: torch device of the loaded samples (their density
            queries run there), the card unless the caller names the CPU
        """
        self.device = device
        self.chain_dirs, self.chain_locations = [], []
        self.ini = None
        self.chain_settings_have_priority = True
        if chain_locations is not None:
            single = isinstance(chain_locations, str) or not isinstance(chain_locations, Iterable)
            for location in [chain_locations] if single else chain_locations:
                self.add_chain_dir(location)
        self.reset(settings)

    def add_chain_dir(self, chain_dir):
        """Add a directory or grid to search for chain roots."""
        if isinstance(chain_dir, str):
            chain_dir = os.path.normpath(chain_dir)
        if chain_dir in self.chain_locations:
            return
        self.chain_locations.append(chain_dir)
        grid = load_supported_grid(chain_dir)
        if grid:
            self.chain_dirs.append(grid)
            self._fold_in_grid_common_ini(grid)
        else:
            has_loose_chains = bool(get_chain_root_files(chain_dir))
            self.chain_dirs.append(chain_dir if has_loose_chains else ChainDirGrid(chain_dir))

    def _fold_in_grid_common_ini(self, grid):
        # a grid hierarchy may carry shared analysis settings at its top level
        common = getattr(grid, "commonPath", None)
        if not common or not os.path.exists(common + "getdist_common.ini"):
            return
        shared_ini = IniFile(common + "getdist_common.ini")
        if self.ini:
            self.ini.params.update(shared_ini.params)
        else:
            self.ini = shared_ini

    def reset(self, settings=None, chain_settings_have_priority=True):
        """Clear caches; optionally set new analysis settings."""
        self.analysis_settings = {}
        if isinstance(settings, IniFile) or type(settings).__name__ == "IniFile":
            fresh = settings
        elif isinstance(settings, Mapping):
            fresh = IniFile(getdist_tpu_torch.default_getdist_settings)
            fresh.params.update(settings)
        else:
            fresh = IniFile(settings or getdist_tpu_torch.default_getdist_settings)
        if self.ini is None:
            self.ini = fresh
        else:
            self.ini.params.update(fresh.params)
        self.mcsamples = {}
        self.densities_1D = {}
        self.densities_2D = {}
        self.single_samples = {}
        self.chain_settings_have_priority = chain_settings_have_priority

    def samples_for_root(self, root, file_root=None, cache=True, settings=None):
        """MCSamples for a root name (passes through MCSamples instances)."""
        if isinstance(root, MCSamples):
            return root
        if isinstance(root, MixtureND):
            raise GetDistPlotError("a MixtureND is an analytic distribution, not loadable samples")
        if not isinstance(root, str):
            raise GetDistPlotError("roots must be name strings or MCSamples objects")
        cached = self.mcsamples.get(root) if cache else None
        if cached is not None:
            return cached
        if os.path.isabs(root):
            file_root = root
        overrides = dict(settings) if (settings and self.chain_settings_have_priority) else {}
        grid_item = None
        if not file_root:
            file_root, grid_item = self._locate_root(root, overrides)
            if not file_root:
                raise GetDistPlotError(f"no chain found for {root}")
        if not self.chain_settings_have_priority:
            overrides.update(self.ini.params)
            overrides.update(settings or {})
        loaded = loadMCSamples(file_root, self.ini, grid_item, settings=overrides, device=self.device)
        self.mcsamples[root] = loaded
        return loaded

    def _locate_root(self, root, dist_settings):
        """Locate a root in the registered chain dirs / grid objects,
        folding any per-grid or per-directory settings into dist_settings.
        Returns (file_root or None, grid job item or None)."""
        for location in self.chain_dirs:
            if is_grid_object(location):
                resolve = getattr(location, "resolve_root", None) or location.resolveRoot
                item = resolve(root)
                if item:
                    dist_settings.update(getattr(location, "getdist_options", {}))
                    dist_settings.update(getattr(item, "dist_settings", {}))
                    return item.chainRoot, item
            else:
                found = findChainFileRoot(location, root)
                per_dir_ini = os.path.join(location, "getdist.ini")
                if os.path.exists(per_dir_ini):
                    dist_settings.update(IniFile(per_dir_ini).params)
                if found:
                    return found, None
        return None, None

    def add_root(self, file_root):
        """Register samples for a file root (path string or RootInfo). A
        RootInfo of a grid (``batch`` set) is found by name in the chain
        directories; otherwise it loads from ``path``/``root``."""
        if not isinstance(file_root, RootInfo):
            return self.samples_for_root(os.path.basename(file_root), file_root)
        if file_root.batch:
            return self.samples_for_root(file_root.root)
        full = os.path.normpath(os.path.join(file_root.path, file_root.root))
        return self.samples_for_root(file_root.root, full)

    def add_roots(self, roots):
        """Add multiple file roots (see :meth:`add_root`)."""
        for root in roots:
            self.add_root(root)

    def remove_root(self, root):
        """Drop a root from the caches."""
        for store in (self.mcsamples, self.single_samples, self.densities_1D, self.densities_2D):
            store.pop(root, None)

    def bounds_for_root(self, root):
        """Object exposing getUpper/getLower for a root's hard bounds."""
        if any(hasattr(root, attr) for attr in ("get_upper", "getUpper")):
            return root
        return self.samples_for_root(root)

    def params_for_root(self, root, label_params=None):
        """ParamNames for a root, with optional label override file."""
        names = root.paramNames if hasattr(root, "paramNames") else self.samples_for_root(root).getParamNames()
        if label_params is not None:
            names.setLabelsAndDerivedFromParamNames(label_params)
        return names

    def load_single_samples(self, root):
        """Cached unit-weight scatter samples for a root."""
        got = self.single_samples.get(root)
        if got is None:
            got = self.single_samples[root] = self.samples_for_root(root).makeSingleSamples()
        return got

    def get_density(self, root, param, likes=False):
        """Cached Density1D for (root, parameter)."""
        per_root = self.densities_1D.setdefault(root, {})
        name = param.name if isinstance(param, ParamInfo) else param
        per_root.pop((name, not likes), None)  # likes flag flips invalidate
        hit = per_root.get((name, likes))
        if hit is not None:
            return hit
        density = self.samples_for_root(root).get1DDensityGridData(name, meanlikes=likes)
        if density is not None:
            per_root[(name, likes)] = density
        return density

    def get_density_grid(self, root, param1, param2, conts=2, likes=False):
        """Cached Density2D for (root, x, y)."""
        per_root = self.densities_2D.setdefault(root, {})
        key = (param1.name, param2.name, likes, conts)
        hit = per_root.get(key)
        if hit:
            return hit
        density = self.samples_for_root(root).get2DDensityGridData(
            param1.name, param2.name, num_plot_contours=conts, meanlikes=likes
        )
        if density is not None:
            per_root[key] = density
        return density
