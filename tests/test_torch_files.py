"""Loading chains from files into getdist_tpu_torch, against the JAX package.

``getdist_tpu_torch.loadMCSamples`` on chain roots written here (the
27-parameter, 4-chain ``tests/fixtures/realchain.py`` root, and a small
root with a fixed column, a periodic parameter, a derived one and no
``.properties.ini``) gives the arrays, names, labels, renames and ranges
of ``getdist_tpu.loadMCSamples`` bit for bit, at three burn-in settings;
the chain-file matching, ``.ini`` inheritance, ``.ranges`` and
``.paramnames`` readers match their JAX counterparts; malformed files
raise in both packages; the pickle cache is hit, invalidated and moved to
the caller's device; and the public fused entry on a loaded root equals
the entry on the same arrays in memory bit for bit, and JAX's entry on
JAX's loaded root within ``tests/test_torch_fast_triangle.py``'s
tolerances. Every cache lives under ``tmp_path``.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import getdist_tpu  # noqa: E402
import getdist_tpu_torch  # noqa: E402
import jax  # noqa: E402
from fixtures import realchain  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import mcsamples as jmcsamples  # noqa: E402
from getdist_tpu.inifile import IniFile as JaxIniFile  # noqa: E402
from getdist_tpu.paramnames import ParamNames as JaxParamNames  # noqa: E402
from getdist_tpu.parampriors import ParamBounds as JaxParamBounds  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import mcsamples as tmcsamples  # noqa: E402
from getdist_tpu_torch.inifile import IniFile  # noqa: E402
from getdist_tpu_torch.paramnames import ParamNames  # noqa: E402
from getdist_tpu_torch.parampriors import ParamBounds  # noqa: E402
from test_zoo_fidelity import DEFAULT_TOL_2D  # noqa: E402

SMALL_PARAMNAMES = "a\t\\alpha_1\nb\tb!_2  #a comment\nfixed\tf\nphi\t\\phi\ntau\t\\tau\nd*\tD_{\\rm derived}\n"
SMALL_RANGES = "a N N\nphi 0 6.283185307179586 periodic\ntau 0 N\nfixed 1.5 1.5\n"
# a Cobaya info file's parameters: two-sided, one-sided, periodic and
# scipy.stats priors, a fixed value, a renamed one and a derived one
COBAYA_YAML = """\
params:
  a: {prior: {min: 0, max: 1}, latex: \\alpha}
  b: {prior: [-5, 5], renames: [bee]}
  lo: {prior: {min: 0}}
  phi: {prior: {min: 0, max: 6.283185307179586}, periodic: true, latex: \\phi}
  g: {prior: {dist: norm, loc: 0.0, scale: 2.0}}
  f: 0.5
  c: {derived: true, latex: c_d}
likelihood: {like1: null}
sampler: {mcmc: {}}
label: a Cobaya run
"""


@pytest.fixture
def jax_cobaya_keys(monkeypatch):
    """The reference's label and renames keys on the JAX package's
    ``cobaya_interface``, which its ``ParamNames`` reads there for a Cobaya
    yaml but which that module does not define (ROADMAP C20)."""
    from getdist_tpu import cobaya_interface

    monkeypatch.setattr(cobaya_interface, "_p_label", "latex", raising=False)
    monkeypatch.setattr(cobaya_interface, "_p_renames", "renames", raising=False)


@pytest.fixture(autouse=True)
def own_caches(tmp_path, monkeypatch):
    """Both packages' pickle caches under this test's tmp_path."""
    monkeypatch.setattr(getdist_tpu_torch, "cache_dir", str(tmp_path / "torch_cache"))
    monkeypatch.setattr(getdist_tpu, "cache_dir", str(tmp_path / "jax_cache"))


@pytest.fixture(scope="module")
def real_root(tmp_path_factory):
    """The realchain root (its .properties.ini says the burn-in is removed)."""
    return realchain.generate(tmp_path_factory.mktemp("realchain"))


@pytest.fixture(scope="module")
def burn_root(real_root, tmp_path_factory):
    """The realchain files without the .properties.ini, so ``ignore_rows``
    removes burn-in, and with a .ranges of ``N`` bounds and a periodic
    parameter."""
    folder = tmp_path_factory.mktemp("burn")
    for fname in os.listdir(os.path.dirname(real_root)):
        if not fname.endswith((".properties.ini", ".ranges")):
            shutil.copy(os.path.join(os.path.dirname(real_root), fname), folder / fname)
    (folder / "planck_like.ranges").write_text("omegabh2 N N\ntau 0.01 N\nxi 0 1 periodic\naksz 0 N\nH0 N 100\n")
    return str(folder / "planck_like")


def _small_root(folder, sep="_", n=2500, chains=4):
    """A root of ``chains`` files of ``n`` rows: weight, -log(like) and the
    six parameters of SMALL_PARAMNAMES (a constant column, a periodic one on
    [0, 2 pi), one bounded below at 0, one derived), with .paramnames and
    .ranges."""
    rng = np.random.default_rng(41)
    folder.mkdir(parents=True, exist_ok=True)
    root = str(folder / "small")
    for c in range(chains):
        x = rng.standard_normal((n, 6))
        x[:, 1] = 0.6 * x[:, 0] + 0.8 * x[:, 1]
        x[:, 2] = 1.5
        x[:, 3] = np.mod(x[:, 3] + 1.0, 2 * np.pi)
        x[:, 4] = np.abs(x[:, 4])
        x[:, 5] = x[:, 0] + x[:, 4]
        table = np.column_stack([rng.integers(1, 4, n).astype(float), 0.5 * np.sum(x[:, :2] ** 2, axis=1), x])
        np.savetxt(f"{root}{sep}{c + 1}.txt", table, fmt="%.10e")
    (folder / "small.paramnames").write_text(SMALL_PARAMNAMES)
    (folder / "small.ranges").write_text(SMALL_RANGES)
    return root


def _load_both(root, **kw):
    port = getdist_tpu_torch.loadMCSamples(root, device="cpu", **kw)
    jax_mc = getdist_tpu.loadMCSamples(root, **kw)
    return port, jax_mc


def _assert_same_load(port, jax_mc):
    for name in ("samples", "weights", "loglikes"):
        got, want = getattr(port, name), getattr(jax_mc, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.paramNames.list() == jax_mc.paramNames.list()
    assert port.paramNames.labels() == jax_mc.paramNames.labels()
    assert [p.isDerived for p in port.paramNames.names] == [p.isDerived for p in jax_mc.paramNames.names]
    assert [p.comment for p in port.paramNames.names] == [p.comment for p in jax_mc.paramNames.names]
    assert port.getRenames() == jax_mc.getRenames()
    assert port.ranges.names == jax_mc.ranges.names
    assert port.ranges.lower == jax_mc.ranges.lower and port.ranges.upper == jax_mc.ranges.upper
    assert port.ranges.periodic == jax_mc.ranges.periodic
    if jax_mc.chain_offsets is None:
        assert port.chain_offsets is None
    else:
        np.testing.assert_array_equal(port.chain_offsets, jax_mc.chain_offsets)
    assert (port.ignore_rows, port.ignore_lines, port.ignore_frac) == (
        jax_mc.ignore_rows, jax_mc.ignore_lines, jax_mc.ignore_frac)
    assert port.properties.params == jax_mc.properties.params
    assert port.name_tag == jax_mc.name_tag and port.rootname == jax_mc.rootname
    for got, want in zip(port.paramNames.names, jax_mc.paramNames.names):
        assert (got.limmin, got.limmax, got.periodic) == (want.limmin, want.limmax, want.periodic)


@pytest.mark.parametrize("ignore_rows", [0, 100, 0.3])
@pytest.mark.parametrize("which", ["realchain", "burn"])
def test_load_matches_jax(real_root, burn_root, which, ignore_rows):
    """Samples, weights, loglikes, names, labels, renames, ranges, periodic
    set and chain offsets bit for bit, at ``ignore_rows`` 0, 100 rows and a
    0.3 fraction (the realchain root's .properties.ini removes no burn-in:
    its chains say it is removed)."""
    root = real_root if which == "realchain" else burn_root
    port, jax_mc = _load_both(root, settings={"ignore_rows": ignore_rows}, no_cache=True)
    _assert_same_load(port, jax_mc)
    rows = 4 * realchain.NSAMP
    if which == "burn" and ignore_rows:
        assert port.numrows < rows
    else:
        assert port.numrows == rows
    assert port.ranges.periodic == ({"xi"} if which == "burn" else set())


@pytest.mark.parametrize("sep", ["_", "."])
@pytest.mark.parametrize("ignore_rows", [0, 100, 0.3])
def test_small_root_matches_jax(tmp_path, sep, ignore_rows):
    """Both separators; the fixed column is deleted from the samples, the
    names and the ranges (fixed at its value); a derived parameter and a
    label with ``!``; renames through ``updateRenames``."""
    root = _small_root(tmp_path / "chains", sep=sep)
    port, jax_mc = _load_both(root, settings={"ignore_rows": ignore_rows}, no_cache=True)
    _assert_same_load(port, jax_mc)
    assert "fixed" not in port.paramNames.list() and port.ranges.fixedValue("fixed") == 1.5
    assert port.samples.shape[1] == 5 and port.paramNames.names[-1].isDerived
    assert port.paramNames.parWithName("b").label == "b\\_2"
    for mc in (port, jax_mc):
        mc.updateRenames({"a": ["alpha"], "b": "beta"})
    assert port.getRenames() == jax_mc.getRenames()
    assert port.paramNames.parWithName("alpha").name == "a"
    assert port.paramNames.parWithName("x", renames={"tau": "x"}).name == "tau"


def test_chain_files_match_jax(tmp_path):
    """``chainFiles`` on both separators, with ``chain_exclude``, first and
    last chain, and on a directory root of bare ``N.txt`` files;
    ``hasChainFiles`` and ``findChainFileRoot`` in a tree."""
    under = _small_root(tmp_path / "u", sep="_", chains=3)
    dotted = _small_root(tmp_path / "d", sep=".", chains=3)
    (tmp_path / "u" / "small.txt").write_text("1 0 1 2 3 4 5 6\n")  # root.txt: chain 0
    bare = tmp_path / "bare"
    bare.mkdir()
    for i in (1, 2, 10):
        (bare / f"{i}.txt").write_text("1 0 1\n")
    cases = [
        (under, {}), (under, {"chain_exclude": [2]}), (under, {"first_chain": 1, "last_chain": 2}),
        (under, {"chain_indices": [0, 3]}), (dotted, {"separator": "."}), (dotted, {}),
        (dotted, {"separator": ".", "chain_exclude": [1, 3]}), (str(bare) + os.sep, {}),
        (str(bare) + os.sep, {"chain_exclude": [10]}),
    ]
    for root, kw in cases:
        assert tchains.chainFiles(root, **kw) == jchains.chainFiles(root, **kw), (root, kw)
    assert tchains.chainFiles(under) == [f"{under}.txt"] + [f"{under}_{i}.txt" for i in (1, 2, 3)]
    for root in (under, dotted, str(tmp_path / "none")):
        assert tchains.hasChainFiles(root) == jchains.hasChainFiles(root)
    assert tchains.findChainFileRoot(str(tmp_path), "small") == jchains.findChainFileRoot(str(tmp_path), "small")
    assert tchains.findChainFileRoot(str(tmp_path), "absent") is None
    assert tmcsamples.getRootFileName(str(tmp_path / "u")) == jmcsamples.getRootFileName(str(tmp_path / "u"))


def test_ini_inheritance_matches_jax(tmp_path, monkeypatch):
    """``INCLUDE`` / ``DEFAULT`` inheritance (nested, relative and absolute
    paths), ``$(VAR)`` expansion (``$$``, unknown variables), typed getters
    and saving, against the JAX package's IniFile."""
    monkeypatch.setenv("GDT_TEST_DIR", "/data/chains")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "base.ini").write_text("num_bins = 40\nsmooth = 0.5\nshared = from_base\nflags = T F T\n")
    (tmp_path / "defaults.ini").write_text("INCLUDE(sub/base.ini)\nfallback = 7\nshared = from_defaults\n")
    (tmp_path / "main.ini").write_text(
        "# a comment kept with its key\nINCLUDE(sub/base.ini)\n"
        f"DEFAULT({tmp_path / 'defaults.ini'})\n"
        "chain_dir = $(GDT_TEST_DIR)/run1\nprice = $$5 and $(GDT_UNSET_VAR)x\n"
        "contours = 0.68 0.95 0.99\nignore_rows = 0.3\nmarker[a] = 1.5\nEND\nafter_end = 1\n"
    )
    got, want = IniFile(str(tmp_path / "main.ini")), JaxIniFile(str(tmp_path / "main.ini"))
    assert got.params == want.params and got.readOrder == want.readOrder and got.comments == want.comments
    assert got.params["chain_dir"] == "/data/chains/run1" and got.params["price"] == "$5 and x"
    assert got.params["shared"] == "from_base" and got.int("fallback") == 7 and "after_end" not in got.params
    assert got.float_list("contours") == want.float_list("contours") == [0.68, 0.95, 0.99]
    assert got.bool_list("flags") == want.bool_list("flags")
    np.testing.assert_array_equal(got.ndarray("contours"), want.ndarray("contours"))
    kept, kept_jax = (cls(str(tmp_path / "main.ini"), keep_includes=True) for cls in (IniFile, JaxIniFile))
    assert kept.includes == kept_jax.includes == ["sub/base.ini"] and kept.defaults == kept_jax.defaults
    assert str(kept) == str(kept_jax)
    raw = IniFile(str(tmp_path / "main.ini"), expand_environment_variables=False)
    assert raw.params["chain_dir"] == "$(GDT_TEST_DIR)/run1"
    got.saveFile(str(tmp_path / "saved.ini"))
    want.saveFile(str(tmp_path / "saved_jax.ini"))
    assert (tmp_path / "saved.ini").read_text() == (tmp_path / "saved_jax.ini").read_text()
    assert IniFile(str(tmp_path / "saved.ini")).params == got.params
    (tmp_path / "dup.ini").write_text("a = 1\na = 2\n")
    with pytest.raises(Exception, match="duplicate key"):
        IniFile(str(tmp_path / "dup.ini"))


def test_param_bounds_match_jax(tmp_path):
    """``.ranges`` / ``.bounds`` with ``N`` bounds, periodic flags (T and
    ``periodic``), short and malformed lines, written back; a Cobaya yaml's
    priors (two-sided, one-sided, periodic, scipy.stats, fixed) read as the
    JAX package reads them."""
    text = "a N N\nb 0 N\nc N 3.5\nphi 0 6.283185307179586 T\npsi -1 1 periodic\nshort 1\nfix 2 2\n"
    for ext in (".ranges", ".bounds"):
        path = tmp_path / f"x{ext}"
        path.write_text(text)
        got, want = ParamBounds(str(path)), JaxParamBounds(str(path))
        assert (got.names, got.lower, got.upper, got.periodic) == (want.names, want.lower, want.upper, want.periodic)
        assert str(got) == str(want) and got.fixedValueDict() == want.fixedValueDict() == {"fix": 2.0}
        got.saveToFile(str(tmp_path / "saved.ranges"))
        want.saveToFile(str(tmp_path / "saved_jax.ranges"))
        assert (tmp_path / "saved.ranges").read_text() == (tmp_path / "saved_jax.ranges").read_text()
        again = ParamBounds(str(tmp_path / "saved.ranges"))  # %15.7E: the text round-trips
        assert str(again) == str(got) and again.periodic == got.periodic
    (tmp_path / "bad.ranges").write_text("p N 1 periodic\n")
    with pytest.raises(ValueError, match="Periodic parameter must have lower and upper"):
        ParamBounds(str(tmp_path / "bad.ranges"))
    for ext in (".yaml", ".yml"):
        (tmp_path / f"r{ext}").write_text(COBAYA_YAML)
        got, want = ParamBounds(str(tmp_path / f"r{ext}")), JaxParamBounds(str(tmp_path / f"r{ext}"))
        assert (got.names, got.lower, got.upper, got.periodic) == (want.names, want.lower, want.upper, want.periodic)
        assert str(got) == str(want) and got.periodic == {"phi"} and got.fixedValueDict() == {"f": 0.5}
        assert got.getLower("lo") == 0 and got.getUpper("lo") is None and got.getLower("g") is None
    with pytest.raises(ValueError, match="must load from"):
        ParamBounds(str(tmp_path / "x.txt"))


def test_param_names_match_jax(tmp_path, jax_cobaya_keys):
    """``.paramnames`` with derived parameters, ``!`` labels and comments;
    lookups with renames and globs; labels from another file; filtered
    copies; ``addDerived``; text output read back; a Cobaya yaml's
    parameters (sampled first, then derived and the chi2 / minuslogprior
    blocks; labels, renames, the raw info) as the JAX package reads them."""
    path = tmp_path / "x.paramnames"
    path.write_text(SMALL_PARAMNAMES + "\nomegam*\t\\Omega_m\n")
    got, want = ParamNames(str(path)), JaxParamNames(str(path))
    assert str(got) == str(want) and got.list() == want.list() and got.labels() == want.labels()
    assert got.getDerivedNames() == want.getDerivedNames() and got.numNonDerived() == want.numNonDerived()
    for names in (["a", "tau"], ["*a*"], ["p?i"], "b"):
        assert [p.name for p in got.parsWithNames(names)] == [p.name for p in want.parsWithNames(names)]
    for pn in (got, want):
        pn.updateRenames({"a": ["alpha", "A"], "omegam": "Om"})
    assert got.getRenames() == want.getRenames()
    assert got.parWithName("Om").name == want.parWithName("Om").name == "omegam"
    assert got.parWithName("nope") is None and got.numberOfName("tau") == want.numberOfName("tau")
    with pytest.raises(Exception, match="not found"):
        got.parWithName("nope", error=True)
    labels = tmp_path / "labels.paramnames"
    labels.write_text("tau\t\\tau_{\\rm reio}\nphi*\t\\varphi\n")
    got.setLabelsAndDerivedFromParamNames(str(labels))
    want.setLabelsAndDerivedFromParamNames(str(labels))
    assert str(got) == str(want)
    assert str(got.filteredCopy(["a", "phi"])) == str(want.filteredCopy(["a", "phi"]))
    assert got.addDerived("s8", label="S_8").string() == want.addDerived("s8", label="S_8").string()
    got.saveAsText(str(tmp_path / "saved.paramnames"))
    assert str(ParamNames(str(tmp_path / "saved.paramnames"))) == str(got)
    (tmp_path / "x.yaml").write_text(COBAYA_YAML)
    got, want = ParamNames(str(tmp_path / "x.yaml")), JaxParamNames(str(tmp_path / "x.yaml"))
    assert str(got) == str(want) and got.getRenames() == want.getRenames() and got.info_dict == want.info_dict
    assert got.list() == ["a", "b", "lo", "phi", "g", "c", "minuslogprior", "minuslogprior__0", "chi2",
                          "chi2__like1"]
    assert got.parWithName("bee").name == "b" and got.parWithName("phi").label == "\\phi"


def test_malformed_chain_file_raises_in_both(tmp_path):
    """A ragged chain file ends in ValueError in both packages (the JAX
    package through ``np.loadtxt``, the port from its own loader, naming
    the file); an empty one is skipped by both."""
    root = _small_root(tmp_path / "c", chains=2)
    with open(f"{root}_2.txt", "a") as handle:
        handle.write("1 2 3\n")
    for load in (getdist_tpu.loadMCSamples, lambda r, **kw: getdist_tpu_torch.loadMCSamples(r, device="cpu", **kw)):
        with pytest.raises(ValueError):
            load(root, no_cache=True)
    with pytest.raises(ValueError, match="small_2.txt"):
        tchains.WeightedSamples(f"{root}_2.txt")
    open(f"{root}_2.txt", "w").close()
    port, jax_mc = _load_both(root, no_cache=True)
    _assert_same_load(port, jax_mc)
    assert port.chain_offsets is not None and len(port.chain_offsets) == 2


def _counted_reads(monkeypatch):
    calls = []
    orig = tmcsamples.MCSamples.readChains

    def counted(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(tmcsamples.MCSamples, "readChains", counted)
    return calls


def _densities(mc):
    d1, d2, pairs = mc.fastTriangleDensities(meanlikes=True)
    out = {f"1d/{k}": v for k, v in d1.items() if isinstance(v, torch.Tensor)}
    out.update({f"2d/{k}": v for k, v in d2.items() if isinstance(v, torch.Tensor)})
    for key, entry in d2["regrid"].items():
        out.update({f"regrid/{key}/{k}": v for k, v in entry.items() if isinstance(v, torch.Tensor)})
    return out, pairs


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("source", ["none", "chain", ".ranges", ".paramnames", ".properties.ini", "ignore_rows"])
def test_pickle_cache(tmp_path, monkeypatch, source):
    """A second load hits the cache (no chain is read) and its densities
    equal the cold load's bit for bit; touching any source file
    (``_source_files``: chains, .ranges, .paramnames, .properties.ini) or
    changing ``ignore_rows`` reads the chains again. The cache file has the
    port's own name, apart from the JAX package's."""
    root = _small_root(tmp_path / "c")
    with open(root + ".properties.ini", "w") as handle:
        handle.write("label = small run\n")
    calls = _counted_reads(monkeypatch)
    cold = getdist_tpu_torch.loadMCSamples(root, settings={"ignore_rows": 0.1}, device="cpu")
    cachefile = tmcsamples._cache_path(root)
    assert calls == [1] and os.path.exists(cachefile) and cachefile.endswith(".torch_mcsamples")
    assert cachefile.startswith(getdist_tpu_torch.cache_dir) and cold.label == "small run"
    settings = {"ignore_rows": 0.1}
    if source == "ignore_rows":
        settings = {"ignore_rows": 200}
    elif source != "none":
        target = f"{root}_3.txt" if source == "chain" else root + source
        stamp = os.path.getmtime(cachefile) + 10
        os.utime(target, (stamp, stamp))
    warm = getdist_tpu_torch.loadMCSamples(root, settings=settings, device="cpu")
    assert calls == ([1] if source == "none" else [1, 1])
    if source == "none":
        _assert_same_load(warm, cold)
        got, pairs = _densities(warm)
        want, want_pairs = _densities(cold)
        assert pairs == want_pairs
        _assert_bitwise(got, want)
    elif source == "ignore_rows":
        assert warm.numrows == cold.numrows + 4 * 250 - 4 * 200


def test_cache_returns_the_callers_device(tmp_path):
    """A cached object comes back on the device of the call that loads it,
    not the one it was pickled on; its pickle holds no tensor."""
    root = _small_root(tmp_path / "c")
    first = getdist_tpu_torch.loadMCSamples(root, device="cpu")
    assert first.device == torch.device("cpu")
    again = getdist_tpu_torch.loadMCSamples(root, device="meta")
    assert again.device == torch.device("meta") and again is not first
    np.testing.assert_array_equal(again.samples, first.samples)


# a pickle of a class in a module that does not exist (protocol 0 GLOBAL)
_FOREIGN_PICKLE = b"cno_such_module_for_a_cache\nThing\n."


@pytest.mark.parametrize("content", [b"", b"not a pickle", _FOREIGN_PICKLE], ids=["empty", "malformed", "foreign"])
def test_unreadable_cache_reloads(tmp_path, monkeypatch, content):
    """A cache file newer than every source that cannot be unpickled (empty,
    malformed, or naming a module that is absent) is a miss: the chains are
    read again and the cache is written anew."""
    root = _small_root(tmp_path / "c")
    calls = _counted_reads(monkeypatch)
    cold = getdist_tpu_torch.loadMCSamples(root, device="cpu")
    cachefile = tmcsamples._cache_path(root)
    with open(cachefile, "wb") as handle:
        handle.write(content)
    stamp = os.path.getmtime(cachefile) + 10
    os.utime(cachefile, (stamp, stamp))
    again = getdist_tpu_torch.loadMCSamples(root, device="cpu")
    assert calls == [1, 1]
    _assert_same_load(again, cold)
    assert os.path.getsize(cachefile) > len(content)


def test_cache_settings_error_propagates(tmp_path, monkeypatch):
    """An error while a readable cached object takes the caller's settings is
    raised, not taken for a cache miss."""
    root = _small_root(tmp_path / "c")
    getdist_tpu_torch.loadMCSamples(root, device="cpu")
    samples = tmcsamples.MCSamples(root, device="cpu")
    sources = tmcsamples._source_files(root, tchains.chainFiles(root))

    def broken(self, *args, **kwargs):
        raise RuntimeError("settings failed")

    monkeypatch.setattr(tmcsamples.MCSamples, "updateSettings", broken)
    with pytest.raises(RuntimeError, match="settings failed"):
        tmcsamples._load_valid_cache(tmcsamples._cache_path(root), sources, samples, None, None)


def _tensors_in(obj, seen=None):
    """Every torch tensor or process group reachable from ``obj`` through
    dicts, sequences, sets and object attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor) or type(obj).__name__ == "ProcessGroup":
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values()) + list(obj.keys())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return []
    return [t for item in items for t in _tensors_in(item, seen)]


def test_pickle_drops_device_state(tmp_path):
    """After the fused entry (with meanlikes) and device parity, the
    object holds its f32 chain, like weights and cumulant score on the
    device; its pickle holds none of them, and the unpickled object gives
    the same densities."""
    root = _small_root(tmp_path / "c")
    mc = getdist_tpu_torch.loadMCSamples(root, device="cpu", no_cache=True)
    want, _ = _densities(mc)
    mc.fastParityDensities(device=True)
    assert _tensors_in(vars(mc))
    assert not _tensors_in(mc.__getstate__())
    mc.savePickle(str(tmp_path / "x.pkl"))
    with open(tmp_path / "x.pkl", "rb") as handle:
        back = pickle.load(handle)
    got, _ = _densities(back)
    _assert_bitwise(got, want)


FAST_PARAMS = ["omegabh2", "tau", "xi", "aksz", "omegal", "sigma8"]


def _served(d2, pairs):
    """{pair: (P, contours)} of the grids the entry serves: its rerun where
    there is one, else the fused program's."""
    out = {}
    for k, pair in enumerate(pairs):
        entry = d2["regrid"].get(pair)
        grid, levels = (entry["P"], entry["contours"]) if entry is not None else (d2["P"][k], d2["contours"][k])
        out[pair] = (np.asarray(grid), np.asarray(levels))
    return out


def test_fast_entry_on_a_loaded_root(real_root):
    """The public fused entry on the loaded realchain root (six parameters
    with lower, two-sided and no limits and the 0.93-correlated pair, with
    meanlikes) equals the entry on an ``MCSamples`` built in memory from the
    loaded arrays, names and ranges, bit for bit; and, without meanlikes
    (the JAX package's f32 like grids are ROADMAP C10), JAX's entry on
    JAX's loaded root: 1D within 1e-4, served 2D grids within the zoo's
    budget, contours within 2% (tests/test_torch_fast_triangle.py)."""
    loaded = getdist_tpu_torch.loadMCSamples(real_root, no_cache=True, device="cpu")
    memory = tmcsamples.MCSamples(samples=loaded.samples, weights=loaded.weights, loglikes=loaded.loglikes,
                                  names=loaded.paramNames.list(), ranges=loaded.ranges, device="cpu")
    got = loaded.fastTriangleDensities(params=FAST_PARAMS, meanlikes=True)
    want = memory.fastTriangleDensities(params=FAST_PARAMS, meanlikes=True)
    assert got[2] == want[2] and set(got[1]["regrid"]) == set(want[1]["regrid"])
    for part in (0, 1):
        for key, value in want[part].items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(got[part][key], value), key
    for key, entry in want[1]["regrid"].items():
        for name, value in entry.items():
            assert torch.equal(torch.as_tensor(got[1]["regrid"][key][name]), torch.as_tensor(value)), (key, name)
    assert loaded.fast_regrid_groups == memory.fast_regrid_groups

    t1, t2, tpairs = loaded.fastTriangleDensities(params=FAST_PARAMS)
    with jax.enable_x64(False):
        j1, j2, jpairs = getdist_tpu.loadMCSamples(real_root, no_cache=True).fastTriangleDensities(
            params=FAST_PARAMS, use_pallas=False)
        j1 = {k: np.asarray(v) for k, v in j1.items() if k in ("P", "neff")}
        jreg = {key: {n: np.asarray(v) for n, v in e.items()} for key, e in j2["regrid"].items()}
        j2 = {"P": np.asarray(j2["P"]), "contours": np.asarray(j2["contours"]), "regrid": jreg}
    assert tpairs == jpairs
    np.testing.assert_allclose(t1["neff"].numpy(), j1["neff"], rtol=1e-4)
    np.testing.assert_allclose(t1["P"].numpy(), j1["P"], rtol=0, atol=1e-4)
    t2 = {"P": t2["P"].numpy(), "contours": t2["contours"].numpy(),
          "regrid": {k: {n: np.asarray(v) for n, v in e.items()} for k, e in t2["regrid"].items()}}
    served, served_jax = _served(t2, tpairs), _served(j2, jpairs)
    for pair, (grid, levels) in served_jax.items():
        assert served[pair][0].shape == grid.shape, pair
        np.testing.assert_allclose(served[pair][0], grid, rtol=0, atol=DEFAULT_TOL_2D, err_msg=str(pair))
        np.testing.assert_allclose(served[pair][1], levels, rtol=0.02, err_msg=str(pair))


def test_root_reads_sidecars_and_settings(tmp_path):
    """``MCSamples(root)`` reads .paramnames, .ranges and .properties.ini,
    then ``readChains(files)``; ``limits[x]``, ``all_limits`` and
    ``marker[x]`` come from the ini, as in the JAX package."""
    root = _small_root(tmp_path / "c")
    with open(root + ".properties.ini", "w") as handle:
        handle.write("sampler = nested\nlabel = from properties\n")
    files = tchains.chainFiles(root)
    settings = {"limits[a]": "-3 N", "marker[b]": "0.25"}
    port = tmcsamples.MCSamples(root, settings=settings, device="cpu").readChains(files)
    jax_mc = jmcsamples.MCSamples(root, settings=settings).readChains(files)
    _assert_same_load(port, jax_mc)
    assert port.sampler == jax_mc.sampler == "nested" and port.label == jax_mc.label == "from properties"
    assert port.markers == jax_mc.markers == {"b": 0.25}
    assert port.ranges.getLower("a") == -3.0 and port.paramNames.parWithName("a").has_limits_bot
    shared = tmcsamples.MCSamples(root, settings={"all_limits": "-9 9"}, device="cpu").readChains(files)
    assert all(p.limmin == -9.0 and p.limmax == 9.0 for p in shared.paramNames.names)
    assert tmcsamples.MCSamples(root, device="cpu", temperature=2.5).properties.params == {
        "sampler": "nested", "label": "from properties"}
    assert tmcsamples.MCSamples(device="cpu", temperature=2.5).properties.params == {"temperature": 2.5}


def test_unported_roots_raise(tmp_path, jax_cobaya_keys):
    """Every kind of root loads (none is left unported): a Cobaya root
    (``root.updated.yaml`` beside ``root.N.txt``) gives the JAX package's
    names, ranges, sampler, label and samples bit for bit
    (``tests/test_torch_cobaya.py`` holds the rest); grid job items load
    (their ``batchPath`` becomes ``batch_path``;
    ``tests/test_torch_chain_grid.py`` holds them against the JAX package);
    only a root without chain files raises, OSError."""
    from getdist_tpu_torch.chain_grid import ChainItem

    item = ChainItem(str(tmp_path), str(tmp_path / "x"), "tag")
    mc = tmcsamples.MCSamples(jobItem=item, device="cpu")
    assert mc.jobItem is item and mc.batch_path == str(tmp_path)
    with pytest.raises(OSError, match="no chain files"):
        getdist_tpu_torch.loadMCSamples(str(tmp_path / "x"), jobItem=item, device="cpu", no_cache=True)
    (tmp_path / "cob.updated.yaml").write_text(COBAYA_YAML)
    rng = np.random.default_rng(7)
    for i in (1, 2):
        columns = [rng.integers(1, 3, 800), rng.random(800), rng.random(800), rng.standard_normal(800),
                   np.abs(rng.standard_normal(800)), rng.random(800) * 6.283185307179586, rng.standard_normal(800)]
        columns += [columns[2] + columns[3], columns[4], columns[4], columns[1], columns[1]]
        np.savetxt(tmp_path / f"cob.{i}.txt", np.column_stack(columns), fmt="%.17g")
    cob = getdist_tpu_torch.loadMCSamples(str(tmp_path / "cob"), device="cpu", no_cache=True)
    want = getdist_tpu.loadMCSamples(str(tmp_path / "cob"), no_cache=True)
    assert cob.paramNames.list() == want.paramNames.list() and str(cob.paramNames) == str(want.paramNames)
    assert (cob.ranges.lower, cob.ranges.upper, cob.ranges.periodic) == (
        want.ranges.lower, want.ranges.upper, want.ranges.periodic)
    assert (cob.sampler, cob.label, cob.properties.params) == (want.sampler, want.label, want.properties.params)
    assert cob.label == "a Cobaya run" and cob.numrows == 1600
    for attr in ("samples", "weights", "loglikes"):
        assert np.array_equal(getattr(cob, attr), getattr(want, attr)), attr
    with pytest.raises(OSError, match="no chain files"):
        getdist_tpu_torch.loadMCSamples(str(tmp_path / "absent"), device="cpu", no_cache=True)


def test_loading_imports_no_jax(tmp_path):
    """In a fresh process, importing the port, loading a root on the CPU
    and running its host analysis API (marginalized and likelihood
    statistics, the convergence tests, a latex table: the result types of
    ``getdist_tpu_torch.types``) imports neither JAX nor the JAX
    package."""
    root = _small_root(tmp_path / "c")
    code = (
        "import sys, getdist_tpu_torch, getdist_tpu_torch.types\n"
        f"mc = getdist_tpu_torch.loadMCSamples({root!r}, device='cpu')\n"
        "assert mc.samples.shape == (10000, 5), mc.samples.shape\n"
        "text = str(mc.getMargeStats()) + str(mc.getLikeStats()) + mc.getConvergeTests() + mc.getTable().tableTex()\n"
        "assert isinstance(mc.getMargeStats(), getdist_tpu_torch.types.MargeStats) and 'phi' in text\n"
        "assert 'jax' not in sys.modules and 'getdist_tpu' not in sys.modules, sorted(sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path / "xdg"))
    env.pop("GETDIST_TPU_TORCH_CONFIG", None)
    env.pop("GETDIST_TPU_TORCH_FUSED", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo, env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
    assert os.path.isdir(tmp_path / "xdg" / "getdist_tpu_torch_cache")
