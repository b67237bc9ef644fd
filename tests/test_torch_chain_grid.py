"""Chain directory trees and grid job items in the port
(``getdist_tpu_torch.chain_grid``, ``sample_analysis.MCSampleAnalysis``,
``loadMCSamples(jobItem=...)``) against the JAX package's, on the CPU.

A tree of realchain roots (``tests/fixtures/realchain.py``) in subfolders,
one root name in two folders: ``ChainDirGrid`` resolves every root as the
JAX package's does; the port's ``MCSampleAnalysis.samples_for_root`` loads
a root as a grid job item (``jobItem`` set, ``batch_path`` equal to the JAX
package's) whose ``getMargeStats()`` text is byte-identical to the JAX
package's (x64 off: its numpy statistics), with the tree's
``getdist.ini`` and a grid's ``getdist_common.ini`` folded in as there.
``MCSampleAnalysis.add_root(RootInfo(...))`` raises ``UnboundLocalError``
in the JAX package (ROADMAP C17) and loads the root in the port, equal to
``add_root(<path string>)``.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import getdist_tpu  # noqa: E402
import getdist_tpu_torch  # noqa: E402
import jax  # noqa: E402
from fixtures import realchain  # noqa: E402
from getdist_tpu import chain_grid as jgrid  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import plots as jplots  # noqa: E402
from getdist_tpu_torch import chain_grid as tgrid  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import sample_analysis  # noqa: E402
from getdist_tpu_torch.sample_analysis import MCSampleAnalysis, RootInfo  # noqa: E402

# (folder under the base, root name) of each copy of the realchain root
LAYOUT = (("base_A", "planck_like"), ("base_B/plik", "other_like"), ("base_C/deep/er", "planck_like"))


@pytest.fixture(autouse=True)
def fresh_caches(tmp_path, monkeypatch):
    """Each test's pickle caches of its own: a cache hit returns the object
    as it was pickled, job item included (in both packages)."""
    monkeypatch.setattr(getdist_tpu_torch, "cache_dir", str(tmp_path / "cache_torch"))
    monkeypatch.setattr(getdist_tpu, "cache_dir", str(tmp_path / "cache_jax"))


@pytest.fixture(scope="module", autouse=True)
def quiet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchains, "print_load_details", False)
        mp.setattr(jchains, "print_load_details", False)
        for name in ("GETDIST_TPU_TORCH_FUSED", "GETDIST_TPU_FUSED", "GETDIST_TPU_TORCH_DEVICE_OPS"):
            mp.delenv(name, raising=False)
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A base folder holding the realchain root three times in subfolders,
    and a getdist.ini with analysis settings for the whole tree."""
    source = realchain.generate(tmp_path_factory.mktemp("grid_source"))
    base = tmp_path_factory.mktemp("grid_tree")
    for folder, name in LAYOUT:
        os.makedirs(base / folder)
        for path in os.listdir(os.path.dirname(source)):
            suffix = path[len("planck_like"):]
            shutil.copy(os.path.join(os.path.dirname(source), path), base / folder / (name + suffix))
    (base / "getdist.ini").write_text("contours = 0.68 0.9 0.99\n")
    return str(base)


def _items(grid):
    return {name: (item.name, item.chainRoot, item.chainPath, item.paramtag, item.batchPath)
            for name, item in grid.roots.items()}


def test_chain_dir_grid_resolves_as_jax(tree):
    got, want = tgrid.ChainDirGrid(tree), jgrid.ChainDirGrid(tree)
    assert _items(got) == _items(want) and len(got.roots) == 3
    assert got.getdist_options == want.getdist_options == {"contours": "0.68 0.9 0.99"}
    assert got.base_dir_names == want.base_dir_names
    for name in list(got.roots) + ["like_other", "absent"]:
        hit, ref = got.resolve_root(name), want.resolve_root(name)
        assert (hit is None and ref is None) or (hit.chainRoot == ref.chainRoot and hit.name == ref.name)
    for directory in (os.path.join(tree, "base_A"), os.path.join(tree, "base_B", "plik"), tree):
        assert tgrid.get_chain_root_files(directory) == jgrid.get_chain_root_files(directory)
    assert tgrid.load_supported_grid(tree) is jgrid.load_supported_grid(tree) is None
    assert tgrid.is_grid_object(got) and not tgrid.is_grid_object(tree)


def _jax_marge(analyser, name):
    with jax.enable_x64(False):
        mc = analyser.samples_for_root(name)
        return mc, str(mc.getMargeStats())


@pytest.mark.parametrize("name", ["other_like", "base_A/planck_like", "er/planck_like"])
def test_grid_item_loads_as_jax(tree, name):
    port = MCSampleAnalysis(tree, device="cpu").samples_for_root(name)
    jax_mc, jax_text = _jax_marge(jplots.MCSampleAnalysis(tree), name)
    assert isinstance(port.jobItem, tgrid.ChainItem) and port.jobItem.chainRoot == jax_mc.jobItem.chainRoot
    assert port.batch_path == jax_mc.batch_path == tree
    assert port.device == torch.device("cpu") and np.array_equal(port.samples, jax_mc.samples)
    assert list(port.contours) == list(jax_mc.contours) == [0.68, 0.9, 0.99]
    assert str(port.getMargeStats()) == jax_text


def test_grid_common_ini_folds_in(tree, tmp_path):
    """A grid object's ``getdist_common.ini`` (at its ``commonPath``) joins
    the analyser's settings, under the packaged defaults, which the
    analyser's reset lays over it (as in the JAX package and the
    reference), and the grid's items load through it."""
    common = tmp_path / "common"
    common.mkdir()
    (common / "getdist_common.ini").write_text("num_bins = 50\ngrid_note = common\n")
    grids = []
    for module in (tgrid, jgrid):
        grid = module.ChainDirGrid(tree)
        grid.commonPath = str(common) + os.sep
        grids.append(grid)
    port_analyser = MCSampleAnalysis([grids[0]], device="cpu")
    jax_analyser = jplots.MCSampleAnalysis([grids[1]])
    assert port_analyser.ini.params == jax_analyser.ini.params
    assert port_analyser.ini.params["grid_note"] == "common" and port_analyser.ini.params["num_bins"] == "100"
    port = port_analyser.samples_for_root("other_like")
    jax_mc, jax_text = _jax_marge(jax_analyser, "other_like")
    assert port.jobItem is grids[0].roots["other_like"] and port.batch_path == jax_mc.batch_path == tree
    assert str(port.getMargeStats()) == jax_text


def test_loose_root_directory(tree):
    """A directory holding chain files itself is searched as such, with no
    job item, in both packages."""
    folder = os.path.join(tree, "base_A")
    port = MCSampleAnalysis(folder, device="cpu").samples_for_root("planck_like")
    with jax.enable_x64(False):
        want = jplots.MCSampleAnalysis(folder).samples_for_root("planck_like")
    assert port.jobItem is None and want.jobItem is None and port.batch_path == want.batch_path == ""
    assert np.array_equal(port.samples, want.samples)


def test_add_root_rootinfo_c17(tree, tmp_path, monkeypatch):
    """ROADMAP C17: the JAX package's add_root(RootInfo) reaches an unbound
    name; the port takes the RootInfo branches."""
    folder = os.path.join(tree, "base_B", "plik")
    with pytest.raises(UnboundLocalError):
        jplots.MCSampleAnalysis(None).add_root(jplots.RootInfo("other_like", folder))
    analyser = MCSampleAnalysis(None, device="cpu")
    got = analyser.add_root(RootInfo("other_like", folder))
    want = MCSampleAnalysis(None, device="cpu").add_root(os.path.join(folder, "other_like"))
    assert analyser.mcsamples == {"other_like": got}
    assert np.array_equal(got.samples, want.samples) and got.root == want.root and got.jobItem is None
    monkeypatch.setattr(getdist_tpu_torch, "cache_dir", str(tmp_path / "cache_batch"))
    batch = MCSampleAnalysis(tree, device="cpu")
    item = batch.add_root(RootInfo("other_like", "", batch=True))
    assert item.jobItem.chainRoot == os.path.join(folder, "other_like") and item.batch_path == tree


def test_unknown_root_raises(tree):
    with pytest.raises(sample_analysis.GetDistPlotError, match="no chain found"):
        MCSampleAnalysis(tree, device="cpu").samples_for_root("absent_root")
