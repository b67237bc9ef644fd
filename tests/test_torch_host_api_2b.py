"""The rest of the port's host MCSamples API (ROADMAP A10 slice 2b)
against the JAX package.

A chain root written with ``tests/fixtures/realchain.py`` (27 parameters,
4 chains of 12000 rows, integer weights, loglikes; ``tau`` and ``aksz``
lower-limited, ``xi`` periodic) is loaded by both packages, the port on
``device="cpu"``, the JAX side with x64 off (its statistics then take
their numpy branches, the port's arithmetic). Held byte for byte: the
``.PCA`` report (automatic and explicit ``L`` / ``M`` maps, a
normalization parameter, conditional parameters), ``.covmat``, ``.corr``
and ``_thin.txt`` (cooled and not), the chain files and sidecars of
``saveChainsAsText``, the single-sample file; bit for bit: the N-D
histogram density of three parameters (integer weights) with its mean and
profile likelihoods, contours and written files, on the host and through
``GETDIST_TPU_TORCH_DEVICE_OPS=1``, ``makeSingleSamples`` rows, the
combined samples, the correlated pairs, ``gaussian_kde_bandwidth`` and
``KernelOptimizer2D.get_hdiag``; and ``CovMat``'s round trip and merge.
"""

import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import getdist_tpu  # noqa: E402
import getdist_tpu_torch  # noqa: E402
import jax  # noqa: E402
from fixtures import realchain  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import kde_bandwidth as jkde  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import kde_bandwidth as tkde  # noqa: E402
from getdist_tpu_torch.covmat import CovMat  # noqa: E402

RANGES = "tau 0.01 N\nxi 0 1 periodic\naksz 0 N\n"
ND_PARAMS = ["omegabh2", "tau", "ns"]


@contextlib.contextmanager
def jax_numpy_stats():
    """The JAX package's host path with its numpy statistics (x64 off)."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = realchain.generate(tmp_path_factory.mktemp("api_2b"))
    with open(root + ".ranges", "w", encoding="utf-8") as handle:
        handle.write(RANGES)
    return root


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    caches = tmp_path_factory.mktemp("caches")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(getdist_tpu_torch, "cache_dir", str(caches / "torch"))
        mp.setattr(getdist_tpu, "cache_dir", str(caches / "jax"))
        mp.setattr(tchains, "print_load_details", False)
        mp.setattr(jchains, "print_load_details", False)
        for name in ("GETDIST_TPU_TORCH_FUSED", "GETDIST_TPU_FUSED", "GETDIST_TPU_TORCH_DEVICE_OPS"):
            mp.delenv(name, raising=False)
        yield mp


@pytest.fixture(scope="module")
def loaded(root, env):
    """(port, jax) MCSamples of the root."""
    port = getdist_tpu_torch.loadMCSamples(root, device="cpu", no_cache=True)
    with jax_numpy_stats():
        jax_mc = getdist_tpu.loadMCSamples(root, no_cache=True)
    return port, jax_mc


def both(loaded, fn):
    """fn applied to the port's and the JAX package's object."""
    port, jax_mc = loaded
    got = fn(port)
    with jax_numpy_stats():
        want = fn(jax_mc)
    return got, want


def written(loaded, tmp_path, fn, suffix):
    """The bytes fn(mc, path) writes, for the port and the JAX package."""
    out = []
    for which, mc in zip(("port", "jax"), loaded):
        path = str(tmp_path / (which + suffix))
        with jax_numpy_stats():
            fn(mc, path)
        with open(path, "rb") as handle:
            out.append(handle.read())
    assert out[0]
    return out


PCA_CASES = {
    "auto_map": dict(params=["omegabh2", "omegach2", "theta", "logA"]),
    "explicit_L_normparam": dict(params=["omegabh2", "omegach2", "ns"], param_map="LLN", normparam="omegach2"),
    "conditional": dict(params=["omegabh2", "omegach2", "theta"], param_map="NLN",
                        conditional_params=("tau", "logA")),
    "M_map": dict(params=["neg", "omegach2", "ns"], param_map="MNN"),
    "n_best_only": dict(params=["omegabh2", "omegach2", "theta"], n_best_only=2),
}


@pytest.mark.parametrize("case", sorted(PCA_CASES))
def test_pca_report_byte_identical(loaded, tmp_path, case):
    """PCA's report (and ``.PCA`` file): automatic N/L maps, explicit L
    with a normalization parameter, conditional parameters marginalized
    out, an M (ln(-x)) map on a negative derived parameter, the best
    modes only."""
    kwargs = dict(PCA_CASES[case])
    params = kwargs.pop("params")
    if case == "M_map":
        loaded = tuple(mc.copy() for mc in loaded)
        for mc in loaded:
            mc.addDerived(-1.5 - mc.samples[:, mc.index["omegabh2"]] ** 2, "neg", label="n")
            with jax_numpy_stats():
                mc.updateBaseStatistics()
    got, want = both(loaded, lambda mc: mc.PCA(params, **kwargs))
    assert got == want and got
    if case == "auto_map":
        files = written(loaded, tmp_path, lambda mc, path: mc.PCA(params, writeDataToFile=True, filename=path), ".PCA")
        assert files[0] == files[1] and files[0].decode() == got


@pytest.mark.parametrize("what", ["covmat", "corr"])
def test_covmat_and_corr_files_byte_identical(loaded, tmp_path, what):
    writer = {"covmat": lambda mc, path: mc.writeCovMatrix(path),
              "corr": lambda mc, path: mc.writeCorrelationMatrix(path)}
    got, want = written(loaded, tmp_path, writer[what], "." + what)
    assert got == want
    if what == "covmat":
        cov = CovMat(str(tmp_path / "port.covmat"))
        assert cov.paramNames == loaded[0].paramNames.list()[: loaded[0].paramNames.numNonDerived()]


@pytest.mark.parametrize("cool", [1, 0.5])
def test_thin_data_byte_identical(loaded, tmp_path, cool):
    """writeThinData at a thinning factor of 10 (fewer rows than the chain),
    uncooled and cooled."""
    ix = loaded[0].thin_indices(10)
    np.testing.assert_array_equal(ix, loaded[1].thin_indices(10))
    got, want = written(loaded, tmp_path, lambda mc, path: mc.writeThinData(path, ix, cool), "_thin.txt")
    assert got == want


def test_thin_data_past_the_chain_length_raises_as_jax(loaded, tmp_path):
    """At a thinning factor below the mean weight there are more thinned
    rows than samples, and the JAX package's writer, which writes sample i
    on row i (ROADMAP C15), runs off the end; the port's does the same."""
    ix = loaded[0].thin_indices(2)
    assert len(ix) > loaded[0].numrows
    for which, mc in zip(("port", "jax"), loaded):
        with pytest.raises(IndexError), jax_numpy_stats():
            mc.writeThinData(str(tmp_path / f"{which}_thin.txt"), ix)


def _nd(mc, **kwargs):
    return mc.getRawNDDensityGridData(ND_PARAMS, meanlikes=True, maxlikes=True, **kwargs)


@pytest.mark.parametrize("route", ["host", "device_ops"])
def test_nd_density_bitwise(loaded, env, route):
    """The N-D histogram density of three parameters (one lower-limited:
    its edge cells at half width), its contours, mean and profile
    likelihoods and their contours, bit for bit with integer weights; the
    port's histograms through ``_bincount`` on the host, and through the
    device route (``GETDIST_TPU_TORCH_DEVICE_OPS=1``, torch on the CPU)."""
    port, jax_mc = loaded
    with jax_numpy_stats():
        want = _nd(jax_mc)
    if route == "device_ops":
        env.setenv("GETDIST_TPU_TORCH_DEVICE_OPS", "1")
    try:
        got = _nd(port)
    finally:
        env.delenv("GETDIST_TPU_TORCH_DEVICE_OPS", raising=False)
    for name in ("P", "contours", "likes", "maxlikes", "maxcontours"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for a, b in zip(got.xs, want.xs):
        np.testing.assert_array_equal(a, b)
    assert got.P.shape == (12, 12, 12) and got.P.max() == 1.0
    raw = port.getRawNDDensity(ND_PARAMS, normalized=True)
    with jax_numpy_stats():
        np.testing.assert_array_equal(raw.P, jax_mc.getRawNDDensity(ND_PARAMS, normalized=True).P)
    point = np.array([[raw.xs[0][5], raw.xs[1][7], raw.xs[2][2]], [raw.xs[0][5], raw.xs[1][7], raw.xs[2][2]]])
    np.testing.assert_allclose(raw.Prob(point), raw.P[2, 7, 5], rtol=1e-12)


def test_nd_density_files_byte_identical(loaded, tmp_path):
    """writeDataToFile: the posterior, meanlike and maxlike tables and the
    contour file."""
    files = {}
    for which, mc in zip(("port", "jax"), loaded):
        folder = tmp_path / which
        folder.mkdir()
        saved = mc.plot_data_dir
        mc.plot_data_dir = str(folder)
        try:
            with jax_numpy_stats():
                _nd(mc, writeDataToFile=True)
        finally:
            mc.plot_data_dir = saved
        files[which] = {name: (folder / name).read_bytes() for name in sorted(os.listdir(folder))}
    assert sorted(files["port"]) == ["planck_like_maxlike_3D.dat", "planck_like_meanlike_3D.dat",
                                     "planck_like_posterior_3D.dat", "planck_like_posterior_3D_cont.dat"]
    assert files["port"] == files["jax"]


def test_make_single_samples_same_rows(loaded, tmp_path):
    got, want = both(loaded, lambda mc: mc.makeSingleSamples(random_state=7))
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < loaded[0].numrows
    thin, _ = both(loaded, lambda mc: mc.makeSingleSamples(single_thin=3, random_state=8))
    assert len(thin) > len(got)
    files = written(loaded, tmp_path, lambda mc, path: mc.makeSingleSamples(path, random_state=7), "_single.txt")
    assert files[0] == files[1] and len(files[0].splitlines()) == len(got)


def test_save_chains_as_text_round_trip(loaded, tmp_path, env):
    """saveChainsAsText writes the four chains and the .paramnames, .ranges
    and .properties.ini sidecars byte-identical to the JAX package's, and
    the port's loadMCSamples reads them back equal to the JAX package's
    load of the same files."""
    port, jax_mc = loaded
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port.saveChainsAsText(str(tmp_path / "port" / "copy"), properties={"note": "x"})
    with jax_numpy_stats():
        jax_mc.saveChainsAsText(str(tmp_path / "jax" / "copy"), properties={"note": "x"})
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["copy.paramnames", "copy.properties.ini", "copy.ranges"] + [f"copy_{i}.txt" for i in range(1, 5)]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    back = getdist_tpu_torch.loadMCSamples(str(tmp_path / "port" / "copy"), device="cpu", no_cache=True)
    with jax_numpy_stats():
        want = getdist_tpu.loadMCSamples(str(tmp_path / "port" / "copy"), no_cache=True)
    np.testing.assert_array_equal(back.samples, want.samples)
    np.testing.assert_array_equal(back.weights, want.weights)
    assert back.paramNames.list() == port.paramNames.list() and back.ranges.periodic == {"xi"}
    np.testing.assert_allclose(back.samples, port.samples, rtol=1e-7, atol=0)
    single = getdist_tpu_torch.mcsamples.MCSamples(samples=port.samples[:500], names=port.paramNames.list(),
                                                   device="cpu")
    single.saveChainsAsText(str(tmp_path / "single"))
    assert os.path.exists(tmp_path / "single.txt") and not os.path.exists(tmp_path / "single.properties.ini")


def test_combined_samples_match_jax(loaded):
    """getCombinedSamplesWithSamples with a copy holding a subset of the
    parameters: the shared parameters, balanced weights, loglikes, and the
    port's result on the first object's device."""
    port, jax_mc = loaded

    def subset(mc, module):
        keep = ["omegabh2", "tau", "ns", "H0"]
        cols = [mc.index[name] for name in keep]
        extra = dict(device="cpu") if module is getdist_tpu_torch.mcsamples else {}
        return module.MCSamples(samples=mc.samples[::3, cols] + 0.01, weights=mc.weights[::3] * 2,
                                loglikes=mc.loglikes[::3], names=keep, **extra)

    got = port.getCombinedSamplesWithSamples(subset(port, getdist_tpu_torch.mcsamples))
    with jax_numpy_stats():
        want = jax_mc.getCombinedSamplesWithSamples(subset(jax_mc, getdist_tpu.mcsamples))
    assert got.paramNames.list() == want.paramNames.list() == ["omegabh2", "tau", "ns", "H0"]
    for name in ("samples", "weights", "loglikes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.device == port.device
    assert got.ranges.getLower("tau") == 0.01


def test_correlated_pairs_match_jax(loaded):
    """The most correlated pairs, after the correlation matrix is computed
    (the JAX package's method reads it without computing it; the port's
    computes it)."""
    both(loaded, lambda mc: mc.getCorrelationMatrix())
    got, want = both(loaded, lambda mc: mc.getCorrelatedVariable2DPlots())
    assert got == want and len(got) == 12
    got3, want3 = both(loaded, lambda mc: mc.getCorrelatedVariable2DPlots(num_plots=3, nparam=6))
    assert got3 == want3 and len(got3) == 3


@pytest.mark.parametrize("column", [0, 3, 8])
def test_gaussian_kde_bandwidth_matches_jax(loaded, column):
    values = loaded[0].samples[:, column]
    got = tkde.gaussian_kde_bandwidth(values)
    assert got == jkde.gaussian_kde_bandwidth(values) and got > 0
    assert tkde.gaussian_kde_bandwidth(values, Neff=5000, nbins=1024) == jkde.gaussian_kde_bandwidth(
        values, Neff=5000, nbins=1024)


@pytest.mark.parametrize("pair", [("omegabh2", "omegach2"), ("H0", "omegal")])
def test_get_hdiag_matches_jax(loaded, pair):
    port = loaded[0]
    ix, iy = (port.samples[:, port.index[name]] for name in pair)
    hist, _, _ = np.histogram2d(iy, ix, bins=128, weights=port.weights)
    corr = np.corrcoef(ix, iy)[0, 1]
    got = tkde.KernelOptimizer2D(hist, 20000, corr).get_hdiag()
    want = jkde.KernelOptimizer2D(hist, 20000, corr).get_hdiag()
    assert got == want
    assert got[2] == 0


def test_covmat_round_trip_and_merge(tmp_path):
    mat = np.array([[2.0, 0.5], [0.5, 1.0]])
    fname = tmp_path / "t.covmat"
    CovMat(matrix=mat, paramNames=["a", "b"]).saveToFile(str(fname))
    loaded = CovMat(str(fname))
    assert loaded.paramNames == ["a", "b"] and loaded.paramNameString() == "a b"
    np.testing.assert_allclose(loaded.matrix, mat)
    corr = loaded.correlation()
    np.testing.assert_allclose(np.diag(corr), [1, 1])
    np.testing.assert_allclose(corr[0, 1], 0.5 / np.sqrt(2))
    merged = CovMat(matrix=np.eye(2) * 2, paramNames=["a", "b"]).mergeCovmatWhereNew(
        CovMat(matrix=np.eye(2) * 3, paramNames=["b", "c"]))
    assert merged.paramNames == ["a", "b", "c"]
    np.testing.assert_allclose(np.diag(merged.matrix), [2, 2, 3])
    assert merged.matrix[0, 2] == 0
    sub = merged.subMatrix(["c", "a"])
    np.testing.assert_allclose(sub.matrix, np.diag([3.0, 2.0]))
    loaded.rescaleParameter("b", 2.0)
    np.testing.assert_allclose(loaded.matrix, [[2.0, 1.0], [1.0, 4.0]])
    from getdist_tpu.covmat import CovMat as JaxCovMat

    JaxCovMat(matrix=mat, paramNames=["a", "b"]).saveToFile(str(tmp_path / "j.covmat"))
    assert (tmp_path / "j.covmat").read_bytes() == fname.read_bytes()
