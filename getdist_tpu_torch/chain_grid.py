"""Chain directory grids: root discovery over directory trees.

Duck-type compatible with CosmoMC/Cobaya ``batchjob`` grid objects (role of
reference ``getdist/chain_grid.py``): finds chain roots anywhere under a
base folder, disambiguates duplicate root names by their shortest unique
path suffix, and exposes per-grid ``getdist.ini`` analysis options.
"""

import os

from getdist_tpu_torch.inifile import IniFile

__all__ = ["ChainDirGrid", "ChainItem", "get_chain_root_files", "load_supported_grid", "is_grid_object"]

_COBAYA_INFO_SUFFIX = "updated.yaml"


def file_root_to_root(root):
    """Path-or-directory chain root -> bare root name (dir roots keep a trailing sep)."""
    if root.endswith(("/", os.sep)):
        return os.path.basename(root.rstrip("/" + os.sep)) + os.sep
    return os.path.basename(root)


def _sidecar_root(filename):
    """Chain root implied by a sidecar file name, or None."""
    if filename.endswith(".paramnames"):
        return filename[: -len(".paramnames")]
    if filename.endswith(_COBAYA_INFO_SUFFIX) and ".minimize." not in filename:
        return filename[: -len(_COBAYA_INFO_SUFFIX)].rstrip("_.")
    return None


def get_chain_root_files(rootdir):
    """Root names of all chains in one directory, identified by a
    ``.paramnames`` or Cobaya ``*updated.yaml`` sidecar plus at least one
    actual chain file. Returns sorted root paths (with directory)."""
    from getdist_tpu_torch.chains import hasChainFiles

    candidates = set()
    try:
        entries = os.listdir(rootdir)
    except OSError:
        return []
    for filename in entries:
        root = _sidecar_root(filename)
        if root:
            # keep rootdir (relative or absolute) on the returned roots
            candidates.add(os.path.join(rootdir, root))
    return sorted(root for root in candidates if hasChainFiles(root))


def is_grid_object(obj):
    """True for anything that can resolve root names itself (batchjob duck type)."""
    return hasattr(obj, "resolve_root") or hasattr(obj, "resolveRoot")


def _read_cobaya_grid(chain_dir):
    from cobaya.grid_tools import batchjob

    return batchjob.readobject(chain_dir)


def _read_cosmomc_grid(chain_dir):
    from paramgrid import batchjob, gridconfig

    if gridconfig.pathIsGrid(chain_dir):
        return batchjob.readobject(chain_dir)
    return None


def load_supported_grid(chain_dir):
    """Load a CosmoMC/Cobaya grid object for a directory when the relevant
    package is installed, else None (a plain ChainDirGrid is used instead)."""
    if is_grid_object(chain_dir):
        return chain_dir
    ini_path = os.path.join(chain_dir, "config", "config.ini")
    if not os.path.exists(ini_path):
        return None
    reader = _read_cobaya_grid if IniFile(ini_path).hasKey("cobaya_version") else _read_cosmomc_grid
    try:
        return reader(chain_dir)
    except ImportError:
        return None


def _tagged_chain_dirs(base):
    """Yield (first_level_dir_name, directory) for every directory at or
    below a first-level subdirectory of ``base`` (the tag groups chains by
    their top folder, as grid UIs expect)."""
    try:
        top_entries = sorted(e for e in os.listdir(base) if os.path.isdir(os.path.join(base, e)))
    except OSError:
        return
    for tag in top_entries:
        start = os.path.join(base, tag)
        yield tag, start
        for parent, subdirs, _ in os.walk(start):
            for sub in subdirs:
                yield tag, os.path.join(parent, sub)


def _distinct_suffix_depth(paths):
    """Smallest number of trailing path components that tells all paths apart."""
    split = [p.split(os.sep) for p in paths]
    depth = 2
    while all(parts[-depth] == split[0][-depth] for parts in split[1:]):
        depth += 1
    return depth


class ChainItem:
    """One chain root on disk; duck-types BatchJob's JobItem."""

    def __init__(self, batchPath, chainRoot, paramtag, name=None):
        directory, basename = os.path.split(chainRoot)
        self.__dict__.update(
            batchPath=batchPath,
            chainRoot=chainRoot,
            paramtag=paramtag,
            name=name if name else basename,
            chainPath=directory,
        )


class ChainDirGrid:
    """All chains found under a folder tree, indexed by (unique) root name.

    A ``getdist.ini`` in the base directory supplies default analysis
    settings for every chain in the tree.
    """

    def __init__(self, base):
        self.batchPath = base
        self.roots = {}
        self.base_dir_names = set()
        self._sorted_names = {}
        options = os.path.join(base, "getdist.ini")
        self.getdist_options = IniFile(options).params if os.path.exists(options) else {}
        found = {}  # root name -> [ChainItem]
        for tag, directory in _tagged_chain_dirs(base):
            for root_path in get_chain_root_files(directory):
                name = file_root_to_root(root_path)
                self.base_dir_names.add(tag)
                item = ChainItem(base, os.path.join(directory, name), tag, name)
                found.setdefault(name, []).append(item)
        self._index(found)

    @staticmethod
    def normed_name(root):
        """Order-insensitive normalization of a root name (tag-set key)."""
        cleaned = root.replace("_post", "").replace(".post.", "_")
        return "_".join(sorted(tag for tag in cleaned.split("_") if tag))

    def _index(self, found):
        for name, items in found.items():
            self._sorted_names.setdefault(self.normed_name(name), []).extend(items)
            if len(items) == 1:
                self.roots[name] = items[0]
                continue
            # same root name in several folders: extend names leftward with
            # path components until they differ
            depth = _distinct_suffix_depth([item.chainRoot for item in items])
            for item in items:
                parts = item.chainRoot.split(os.sep)
                item.name = "/".join(parts[-depth:])
                item.chainPath = os.sep.join(parts[:-depth])
                self.roots[item.name] = item

    def roots_for_dir(self, paramtag):
        """Unique root names whose top-level folder is ``paramtag``."""
        return sorted(name for name, item in self.roots.items() if item.paramtag == paramtag)

    def resolve_root(self, root):
        """ChainItem for a root name (normalized-name fallback), or None."""
        direct = self.roots.get(root)
        if direct:
            return direct
        matches = self._sorted_names.get(self.normed_name(root)) or []
        if len(matches) > 1:
            ambiguous = [i.chainRoot for i in matches]
            raise ValueError(
                f"No exact match for {root} and normalized name {self.normed_name(root)}"
                f" is ambiguous: {ambiguous!r}"
            )
        return matches[0] if matches else None

    def resolveRoot(self, root):
        return self.resolve_root(root)
