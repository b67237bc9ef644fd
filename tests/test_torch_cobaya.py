"""The port's Cobaya interoperability against the JAX package's.

Every function of ``getdist_tpu_torch.cobaya_interface`` returns what
``getdist_tpu.cobaya_interface`` returns on ``tests/test_cobaya.py``'s
info fixture and its variants (post-processing blocks, polychord mapped to
nested, a declared sampler type, temperatures, labels, the scipy.stats
intervals and periodic flags, the prior format error). ``MCSamplesFromCobaya``
on numpy-backed stand-in collections (two chains, parameters with
two-sided, one-sided, periodic and unbounded ``norm`` priors, a derived
one, the ``minuslogprior*`` / ``chi2*`` columns) gives the JAX package's
names, labels, renames, ranges, samples, weights and loglikes bit for bit,
its ``.margestats`` text byte for byte and its host 1D grids within 1e-12;
a pandas ``DataFrame`` gives the same object. An on-disk Cobaya root
(``root.updated.yaml`` or ``root__full.yaml`` beside ``root.N.txt`` chains)
loaded by ``loadMCSamples`` in both packages gives the same samples bit for
bit, names, labels, renames, ranges, sampler, label and burn-in state, and
the same ``.margestats`` bytes; an edited yaml rebuilds the port's pickle
cache. (``tests/test_torch_gui.py`` builds ``MCSamplesFromCobaya`` in a
process with yaml, pandas and matplotlib blocked.)

The JAX side runs with x64 off (its numpy statistics, as in
``tests/test_torch_host_api.py``). Two faults of the JAX module are shown
as not copied: its ``ParamNames`` reads ``cobaya_interface._p_label`` and
``_p_renames``, which the JAX module does not define, so its on-disk Cobaya
roots raise ``AttributeError`` (ROADMAP C20: these tests give the JAX
module the reference's two keys for the comparison); and its
``get_burn_removed`` reads ``post: skip`` from the parameter table instead
of the info, so a post-processed root's burn-in is never marked removed
(C21). ``getdist_tpu.loadCobayaSamples`` is a lazy export of a name that
does not exist (C19); the port exports ``MCSamplesFromCobaya`` only.
"""

import contextlib
import copy
import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import getdist_tpu  # noqa: E402
import getdist_tpu_torch  # noqa: E402
import jax  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import cobaya_interface as jci  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import cobaya_interface as tci  # noqa: E402
from getdist_tpu_torch import mcsamples as tmcsamples  # noqa: E402
from test_cobaya import info_fixture  # noqa: E402

GRID_TOL = 1e-12


@pytest.fixture(autouse=True)
def quiet_and_own_caches(tmp_path, monkeypatch):
    """Both packages' pickle caches under this test's tmp_path, no load
    chatter, the fused route switch unset (a CPU object takes the host
    path)."""
    monkeypatch.setattr(getdist_tpu_torch, "cache_dir", str(tmp_path / "torch_cache"))
    monkeypatch.setattr(getdist_tpu, "cache_dir", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(tchains, "print_load_details", False)
    monkeypatch.setattr(jchains, "print_load_details", False)
    monkeypatch.delenv("GETDIST_TPU_TORCH_FUSED", raising=False)
    monkeypatch.delenv("GETDIST_TPU_FUSED", raising=False)


@contextlib.contextmanager
def jax_numpy_stats():
    """The JAX package's host path with its numpy statistics (x64 off)."""
    with jax.enable_x64(False):
        yield


@pytest.fixture
def jax_reference_keys(monkeypatch):
    """The reference's label and renames keys on the JAX module, so that its
    ``ParamNames`` can read a Cobaya yaml (ROADMAP C20)."""
    assert not hasattr(jci, "_p_label") and not hasattr(jci, "_p_renames")
    monkeypatch.setattr(jci, "_p_label", "latex", raising=False)
    monkeypatch.setattr(jci, "_p_renames", "renames", raising=False)


def _variants():
    """Named info dicts: the fixture and the variants its tests use."""
    base = info_fixture()
    post = copy.deepcopy(base)
    post["post"] = {
        "remove": {"likelihood": "like2", "params": ["d"]},
        "add": {"likelihood": {"like3": None}, "params": {"g": {"derived": True}}},
        "skip": 100,
    }
    polychord = copy.deepcopy(base)
    polychord["sampler"] = {"polychord": {}}
    hot = copy.deepcopy(base)
    hot["sampler"] = {"mcmc": {"temperature": 2.0}}
    hot["label"] = "hot run"
    declared = copy.deepcopy(base)
    declared["sampler"] = {"my_sampler": {"sampler_type": "nested"}}
    no_sampler = copy.deepcopy(base)
    del no_sampler["sampler"]
    null_block = copy.deepcopy(base)
    null_block["sampler"] = {"mcmc": None}
    priors = copy.deepcopy(base)
    priors["prior"] = {"extra_prior": "lambda a: 0"}
    priors["params"]["h"] = {"prior": {"dist": "uniform", "loc": -1.0, "scale": 3.0}}
    priors["params"]["k"] = {"prior": {"min": 0}}
    priors["params"]["m"] = {"value": "lambda a: a", "min": 0, "max": 2}
    priors["params"]["n"] = None
    return {"base": base, "post": post, "polychord": polychord, "hot": hot, "declared": declared,
            "no_sampler": no_sampler, "null_block": null_block, "priors": priors}


VARIANTS = sorted(_variants())


def _answer(fn, *args):
    """fn(*args), or the type and message of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception is the answer compared
        return ("raises", type(e).__name__, str(e))


def _summary(ci, info):
    """Everything the module answers about one info dict."""
    table = ci.get_info_params(info)
    return {
        "info_params": table,
        "ranges": {name: ci.get_range(spec) for name, spec in table.items()},
        "sampled": {name: ci.is_sampled_param(spec) for name, spec in table.items()},
        "derived": {name: ci.is_derived_param(spec) for name, spec in table.items()},
        "expanded": {name: ci.expand_info_param(spec) for name, spec in table.items()},
        "label": ci.get_sample_label(info),
        "temperature": _answer(ci.get_sampler_temperature, info),
        "sampler_type": _answer(ci.get_sampler_type, info),
    }


@pytest.mark.parametrize("variant", VARIANTS)
def test_info_functions_match_jax(variant):
    info = _variants()[variant]
    got, want = _summary(tci, copy.deepcopy(info)), _summary(jci, copy.deepcopy(info))
    assert got == want


def test_sampler_and_prior_answers():
    """The answers the JAX tests pin, in the port: polychord is nested, a
    post-processed chain has temperature 1, scipy's ``norm`` interval is
    unbounded, periodic flags survive, and an unrecognised prior raises as
    the JAX module's does."""
    variants = _variants()
    assert tci.get_sampler_type(variants["polychord"]) == "nested"
    assert tci.get_sampler_type(variants["declared"]) == "nested"
    assert tci.get_sampler_temperature(variants["post"]) == 1
    assert tci.get_sampler_temperature(variants["hot"]) == 2.0
    params = variants["base"]["params"]
    assert tci.get_range(params["e"]) == (None, None, False)
    assert tci.get_range(params["f"]) == (0, 6.28, True)
    assert tci.get_range(variants["priors"]["params"]["h"]) == (-1.0, 2.0, False)
    for ci in (tci, jci):
        with pytest.raises(ValueError, match="Format of prior not recognised"):
            ci.get_range({"prior": [1, 2, 3]})
        with pytest.raises(ValueError, match="dictionary or filename"):
            ci.get_info_params(3)


def test_burn_removed_reads_the_info_c21():
    """``post: skip`` is the burn-in a post-processing run removed: the port
    reads it from the info; the JAX module reads the parameter table, where
    it never is (ROADMAP C21)."""
    variants = _variants()
    assert tci.get_burn_removed(variants["post"]) == 100
    assert jci.get_burn_removed(variants["post"]) == 0
    assert tci.get_burn_removed(variants["base"]) == jci.get_burn_removed(variants["base"]) == 0


def test_cobaya_params_file_and_yaml_info_match_jax(tmp_path):
    """Yaml discovery next to a root (``.updated.yaml``, ``__full.yaml``, a
    directory root) and every function on a yaml file name instead of a
    dict."""
    import yaml

    info = _variants()["hot"]
    (tmp_path / "run.updated.yaml").write_text(yaml.safe_dump(info))
    (tmp_path / "old__full.yaml").write_text(yaml.safe_dump(info))
    (tmp_path / "dir").mkdir()
    (tmp_path / "dir" / "updated.yaml").write_text(yaml.safe_dump(info))
    for root in ("run", "old", "dir/", "absent"):
        path = str(tmp_path / root)
        assert tci.cobaya_params_file(path) == jci.cobaya_params_file(path)
    name = str(tmp_path / "run.updated.yaml")
    assert _summary(tci, name) == _summary(jci, name) == _summary(tci, info)


class _NumpyFrame:
    """A DataFrame's columns (iterating yields column names)."""

    def __init__(self, cols):
        self.columns = cols

    def __iter__(self):
        return iter(self.columns)


class _NumpyCollection:
    """A Cobaya SampleCollection stand-in on a dict of numpy columns:
    ``c.data.columns``, and ``c[name].values`` / ``c[[names]].values``."""

    def __init__(self, columns):
        self._columns = columns
        self.data = _NumpyFrame(list(columns))

    def __getitem__(self, key):
        if isinstance(key, list):
            return types.SimpleNamespace(values=np.column_stack([self._columns[k] for k in key]))
        return types.SimpleNamespace(values=np.asarray(self._columns[key]))


COBAYA_INFO = {
    "params": {
        "a": {"prior": {"min": 0, "max": 1}, "latex": r"\alpha"},
        "b": {"prior": [-5, 5], "renames": ["bee"]},
        "lo": {"prior": {"min": 0}, "latex": "l_o"},
        "phi": {"prior": {"min": 0, "max": 6.283185307179586}, "periodic": True, "latex": r"\phi"},
        "g": {"prior": {"dist": "norm", "loc": 0.0, "scale": 2.0}},
        "c": {"derived": True, "latex": "c_d"},
    },
    "likelihood": {"like1": None},
    "sampler": {"mcmc": {}},
    "label": "stand-in run",
}


def _cobaya_columns(n, seed):
    """One chain's columns as Cobaya orders them: weight, minuslogpost, the
    info's parameters, the minuslogprior and chi2 blocks."""
    rng = np.random.default_rng(seed)
    a = rng.random(n)
    b = rng.standard_normal(n)
    lo = np.abs(rng.standard_normal(n))
    phi = rng.random(n) * 6.283185307179586
    g = 2.0 * rng.standard_normal(n)
    chi2 = a**2 + b**2
    return {
        "weight": rng.integers(1, 4, n).astype(float),
        "minuslogpost": 0.5 * chi2 + lo,
        "a": a, "b": b, "lo": lo, "phi": phi, "g": g, "c": a + b,
        "minuslogprior": lo, "minuslogprior__0": lo,
        "chi2": chi2, "chi2__like1": chi2,
    }


@pytest.fixture(scope="module")
def cobaya_chains():
    return [_cobaya_columns(3000, seed) for seed in (1, 2)]


def _from_cobaya(ci, chains, **kwargs):
    collections = [_NumpyCollection(columns) for columns in chains]
    with warnings_quiet():
        if ci is tci:
            return ci.MCSamplesFromCobaya(copy.deepcopy(COBAYA_INFO), collections, device="cpu", **kwargs)
        with jax_numpy_stats():
            return ci.MCSamplesFromCobaya(copy.deepcopy(COBAYA_INFO), collections, **kwargs)


@contextlib.contextmanager
def warnings_quiet():
    import logging

    logger = logging.getLogger()
    level = logger.level
    logger.setLevel(logging.ERROR)
    try:
        yield
    finally:
        logger.setLevel(level)


def _assert_same_samples(got, want):
    """Names, labels, renames, ranges and arrays bit for bit."""
    assert got.paramNames.list() == want.paramNames.list()
    assert got.paramNames.labels() == want.paramNames.labels()
    assert [p.isDerived for p in got.paramNames.names] == [p.isDerived for p in want.paramNames.names]
    assert got.getRenames() == want.getRenames()
    assert (got.ranges.names, got.ranges.lower, got.ranges.upper, got.ranges.periodic) == (
        want.ranges.names, want.ranges.lower, want.ranges.upper, want.ranges.periodic)
    for attr in ("samples", "weights", "loglikes"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    assert got.sampler == want.sampler and got.label == want.label
    assert got.properties.params == want.properties.params


def _marge_text(mc, tmp_path, tag):
    path = tmp_path / f"{tag}.margestats"
    mc.getMargeStats().saveAsText(str(path))
    return path.read_bytes()


def test_mcsamples_from_cobaya_matches_jax(cobaya_chains, tmp_path):
    got, want = _from_cobaya(tci, cobaya_chains, name_tag="run1"), _from_cobaya(jci, cobaya_chains, name_tag="run1")
    assert got.device == torch.device("cpu") and isinstance(got, tmcsamples.MCSamples)
    _assert_same_samples(got, want)
    assert got.name_tag == want.name_tag == "run1"
    assert got.paramNames.list()[:6] == ["a", "b", "lo", "phi", "g", "c"]
    assert got.ranges.periodic == {"phi"} and got.ranges.getLower("lo") == 0 and got.ranges.getUpper("lo") is None
    with jax_numpy_stats():
        want_text = _marge_text(want, tmp_path, "jax")
        want_grids = {name: want.get1DDensityGridData(name) for name in ("a", "b", "lo", "phi", "g", "c")}
    assert _marge_text(got, tmp_path, "port") == want_text
    for name, dens in want_grids.items():
        mine = got.get1DDensityGridData(name)
        assert np.array_equal(mine.x, dens.x), name
        np.testing.assert_allclose(mine.P, dens.P, rtol=0, atol=GRID_TOL * np.max(dens.P), err_msg=name)


def test_mcsamples_from_cobaya_pandas_and_burn_in(cobaya_chains):
    """A pandas DataFrame gives the stand-in's object; burn-in (a fraction
    and a row count) and a temperature reach both packages alike."""
    import pandas as pd

    class PandasCollection:
        """A Cobaya SampleCollection's surface: ``data`` is a DataFrame,
        indexing goes to it."""

        def __init__(self, frame):
            self.data = frame

        def __getitem__(self, key):
            return self.data[key]

    frames = [PandasCollection(pd.DataFrame(columns)) for columns in cobaya_chains]
    with warnings_quiet():
        from_pandas = tci.MCSamplesFromCobaya(copy.deepcopy(COBAYA_INFO), frames, device="cpu")
    _assert_same_samples(from_pandas, _from_cobaya(tci, cobaya_chains))
    for ignore_rows in (0.3, 500):
        _assert_same_samples(_from_cobaya(tci, cobaya_chains, ignore_rows=ignore_rows),
                             _from_cobaya(jci, cobaya_chains, ignore_rows=ignore_rows))
    hot = dict(copy.deepcopy(COBAYA_INFO), sampler={"mcmc": {"temperature": 2.0}})
    collections = [_NumpyCollection(columns) for columns in cobaya_chains]
    with warnings_quiet():
        got = tci.MCSamplesFromCobaya(hot, collections, device="cpu")
        with jax_numpy_stats():
            want = jci.MCSamplesFromCobaya(copy.deepcopy(hot), collections)
    _assert_same_samples(got, want)
    assert got.properties.params == {"temperature": 2.0}


def test_mcsamples_from_cobaya_errors_match_jax(cobaya_chains):
    """Info and collection columns that differ, collections whose columns
    differ from each other, and a non-collection raise alike."""
    collections = [_NumpyCollection(columns) for columns in cobaya_chains]
    narrow = copy.deepcopy(COBAYA_INFO)
    del narrow["params"]["c"]
    other = dict(cobaya_chains[1])
    other["extra"] = other.pop("c")
    cases = {
        AssertionError: (narrow, collections),
        ValueError: (COBAYA_INFO, [collections[0], _NumpyCollection(other)]),
        TypeError: (COBAYA_INFO, [object()]),
    }
    for error, (info, colls) in cases.items():
        messages = []
        for ci, kwargs in ((tci, {"device": "cpu"}), (jci, {})):
            with pytest.raises(error) as caught:
                ci.MCSamplesFromCobaya(copy.deepcopy(info), colls, **kwargs)
            messages.append(str(caught.value))
        assert messages[0] == messages[1]


def test_exports_c19():
    """``MCSamplesFromCobaya`` is exported from the package and from
    ``mcsamples``; the JAX package's dead ``loadCobayaSamples`` export
    (ROADMAP C19) is not copied."""
    assert getdist_tpu_torch.MCSamplesFromCobaya is tci.MCSamplesFromCobaya
    assert tmcsamples.MCSamplesFromCobaya is tci.MCSamplesFromCobaya
    assert "loadCobayaSamples" in getdist_tpu._LAZY_EXPORTS
    with pytest.raises(AttributeError, match="cobaya_interface"):
        getattr(getdist_tpu, "loadCobayaSamples")
    assert "loadCobayaSamples" not in getdist_tpu_torch._LAZY_EXPORTS
    with pytest.raises(AttributeError, match="'getdist_tpu_torch' has no attribute 'loadCobayaSamples'"):
        getattr(getdist_tpu_torch, "loadCobayaSamples")


ROOT_YAML = """\
params:
  a:
    prior: {min: 0, max: 1}
    latex: \\alpha
  b:
    prior: [-5, 5]
    renames: [bee]
  lo:
    prior: {min: 0}
    latex: l_o
  phi:
    prior: {min: 0, max: 6.283185307179586}
    periodic: true
  g:
    prior: {dist: norm, loc: 0.0, scale: 2.0}
  c:
    derived: true
    latex: c_d
likelihood:
  like1: null
"""
# name -> (yaml file suffix, yaml tail, (port, JAX) burn_removed property)
ROOTS = {
    "mcmc": (".updated.yaml", "sampler:\n  mcmc: {}\nlabel: on-disk run\n", (None, None)),
    "full": ("__full.yaml", "sampler:\n  polychord: {}\n", (None, None)),
    "post": (".updated.yaml", "sampler:\n  mcmc: {}\npost:\n  skip: 0.3\n", (True, True)),
}


def _write_cobaya_root(folder, name, kind):
    suffix, tail, _ = ROOTS[kind]
    root = str(folder / name)
    with open(root + suffix, "w", encoding="utf-8") as handle:
        handle.write(ROOT_YAML + tail)
    order = ["weight", "minuslogpost", "a", "b", "lo", "phi", "g", "c", "minuslogprior", "minuslogprior__0",
             "chi2", "chi2__like1"]
    for i, seed in enumerate((3, 4)):
        columns = _cobaya_columns(2500, seed)
        with open(f"{root}.{i + 1}.txt", "w", encoding="utf-8") as handle:
            handle.write("# " + " ".join(order) + "\n")
            np.savetxt(handle, np.column_stack([columns[k] for k in order]), fmt="%.17g")
    return root


@pytest.mark.parametrize("kind", sorted(ROOTS))
def test_cobaya_root_on_disk_matches_jax(kind, tmp_path, jax_reference_keys):
    root = _write_cobaya_root(tmp_path, "run", kind)
    settings = {"ignore_rows": 0.2} if kind == "post" else None
    got = getdist_tpu_torch.loadMCSamples(root, settings=settings, device="cpu", no_cache=True)
    with jax_numpy_stats():
        want = getdist_tpu.loadMCSamples(root, settings=settings, no_cache=True)
    port_burn, jax_burn = ROOTS[kind][2]
    assert got.properties.params.get("burn_removed") == port_burn
    assert want.properties.params.get("burn_removed") == jax_burn
    if kind == "post":
        # C21: the port keeps every row of a post-processed root (its skip
        # already removed the burn-in); the JAX package removes 20% again
        assert got.numrows == 5000 and want.numrows < got.numrows
        assert tci.get_burn_removed(got.paramNames.info_dict) == 0.3
        return
    _assert_same_samples(got, want)
    assert got.paramNames.info_dict == want.paramNames.info_dict
    assert got.sampler == ("nested" if kind == "full" else "mcmc")
    assert got.label == ("on-disk run" if kind == "mcmc" else None)
    assert got.ranges.periodic == {"phi"}
    with jax_numpy_stats():
        want_text = _marge_text(want, tmp_path, "jax")
    assert _marge_text(got, tmp_path, "port") == want_text


def test_cobaya_root_cache_follows_the_yaml(tmp_path, monkeypatch):
    """A Cobaya root's pickle cache is hit, then rebuilt after its yaml is
    edited (the yaml is one of the cache's sources), carrying the edit."""
    root = _write_cobaya_root(tmp_path, "run", "mcmc")
    reads = []
    saved = tmcsamples.MCSamples.readChains

    def counted(self, *a, **k):
        reads.append(1)
        return saved(self, *a, **k)

    monkeypatch.setattr(tmcsamples.MCSamples, "readChains", counted)
    first = getdist_tpu_torch.loadMCSamples(root, device="cpu")
    again = getdist_tpu_torch.loadMCSamples(root, device="cpu")
    assert len(reads) == 1 and again.paramNames.list() == first.paramNames.list()
    assert tmcsamples._source_files(root, []) == [root + ".updated.yaml"]
    yaml_file = root + ".updated.yaml"
    with open(yaml_file, encoding="utf-8") as handle:
        text = handle.read()
    with open(yaml_file, "w", encoding="utf-8") as handle:
        handle.write(text.replace("latex: \\alpha", "latex: \\alpha_{\\rm new}"))
    later = time.time() + 10
    os.utime(yaml_file, (later, later))
    edited = getdist_tpu_torch.loadMCSamples(root, device="cpu")
    assert len(reads) == 2
    assert edited.paramNames.parWithName("a").label == r"\alpha_{\rm new}"
    assert np.array_equal(edited.samples, first.samples)


def test_cobaya_names_and_ranges_files_match_jax(tmp_path, jax_reference_keys):
    """``ParamNames`` and ``ParamBounds`` of a Cobaya yaml file equal the
    JAX package's (sampled parameters first, then derived; renames; the
    prior-derived bounds)."""
    from getdist_tpu.paramnames import ParamNames as JaxParamNames
    from getdist_tpu.parampriors import ParamBounds as JaxParamBounds
    from getdist_tpu_torch.paramnames import ParamNames
    from getdist_tpu_torch.parampriors import ParamBounds

    root = _write_cobaya_root(tmp_path, "run", "mcmc")
    for ext in (".updated.yaml",):
        got, want = ParamNames(root + ext), JaxParamNames(root + ext)
        assert str(got) == str(want) and got.list() == want.list() and got.getRenames() == want.getRenames()
        assert got.info_dict == want.info_dict and got.info_dict["label"] == "on-disk run"
        got_b, want_b = ParamBounds(root + ext), JaxParamBounds(root + ext)
        assert (got_b.names, got_b.lower, got_b.upper, got_b.periodic) == (
            want_b.names, want_b.lower, want_b.upper, want_b.periodic)
        assert str(got_b) == str(want_b)
