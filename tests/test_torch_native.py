"""The port's native passes (``getdist_tpu_torch._native``).

The pair-histogram pass bit for bit against its plain version (one
``np.bincount`` per pair) and against the JAX package's copy
(``getdist_tpu._native.pair_histograms``) on the same inputs; the chain
text loader bit for bit against ``np.loadtxt`` and the JAX package's
loader (``tests/test_native.py``'s cases); a failed build and a bad call
or file raise.
"""

import numpy as np
import pytest

from getdist_tpu_torch import _native


def _case(p, n, nbins, weights, seed):
    rng = np.random.default_rng(seed)
    ix = rng.integers(0, nbins, (p, n)).astype(np.int32)
    w = {
        "integer": rng.integers(1, 5, n).astype(np.float64),
        "fractional": np.exp(-0.5 * rng.uniform(0, 6, n)),
        "negative": rng.normal(1.0, 2.0, n),
    }[weights]
    pairs = [(a, b) for a in range(p) for b in range(a + 1, p)] + [(p - 1, 0)]
    return ix, w, pairs


@pytest.mark.parametrize("weights", ["integer", "fractional", "negative"])
@pytest.mark.parametrize("nbins", [64, 256, 960])
def test_pair_histograms_bit_exact(nbins, weights):
    ix, w, pairs = _case(6, 20_011, nbins, weights, seed=nbins)
    got = _native.pair_histograms(ix, w, pairs, nbins)
    assert got.shape == (len(pairs), nbins, nbins) and got.dtype == np.float64
    np.testing.assert_array_equal(got, _native.pair_histograms_plain(ix, w, pairs, nbins))


def test_pair_histograms_match_the_jax_package():
    from getdist_tpu import _native as jax_native

    ix, w, pairs = _case(5, 30_000, 256, "fractional", seed=7)
    want = jax_native.pair_histograms(ix, w, pairs, 256)
    assert want is not None
    np.testing.assert_array_equal(_native.pair_histograms(ix, w, pairs, 256), want)


def test_library_is_keyed_by_the_source(tmp_path):
    """Two sources build two libraries under the build directory; the same
    source again reuses its library."""
    src = tmp_path / "pairhist.cpp"
    src.write_bytes(_native.SOURCE.read_bytes())
    first = _native.build(src, tmp_path / "build")
    assert _native.build(src, tmp_path / "build") == first
    src.write_bytes(_native.SOURCE.read_bytes() + b"\n// another source\n")
    second = _native.build(src, tmp_path / "build")
    assert second != first and first.exists() and second.exists()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback to numpy: a source g++ rejects raises at the first call."""
    broken = tmp_path / "pairhist.cpp"
    broken.write_text("extern \"C\" int gdt_pair_hists( { syntax error\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.build(broken, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(_native, "SOURCE", broken)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    _native.library.cache_clear()
    try:
        ix, w, pairs = _case(3, 100, 16, "integer", seed=1)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _native.pair_histograms(ix, w, pairs, 16)
    finally:
        _native.library.cache_clear()


def test_a_bad_call_raises():
    ix, w, pairs = _case(3, 100, 16, "integer", seed=2)
    with pytest.raises(RuntimeError, match="rc 2"):
        _native.pair_histograms(ix, w, [(0, 3)], 16)
    with pytest.raises(ValueError, match="one weight per sample"):
        _native.pair_histograms(ix, w[:-1], pairs, 16)


# -- the chain text loader ------------------------------------------------------


@pytest.fixture(scope="module")
def chain_file(tmp_path_factory):
    """tests/test_native.py's chain: 50k rows of weight, -log(like) and 4
    parameters in %.8e, plus one in %.17g (every bit of an f64)."""
    folder = tmp_path_factory.mktemp("loader")
    rng = np.random.RandomState(0)
    data = np.column_stack(
        [rng.randint(1, 9, 50000).astype(float), rng.rand(50000) * 10, rng.standard_normal((50000, 4))]
    )
    short, full = folder / "chain.txt", folder / "chain_full.txt"
    np.savetxt(short, data, fmt="%.8e")
    np.savetxt(full, data * np.pi, fmt="%.17g")
    return str(short), str(full), data


def test_loader_matches_loadtxt_and_the_jax_package(chain_file):
    from getdist_tpu import _native as jax_native

    for path in chain_file[:2]:
        got = _native.load_chain_text(path)
        assert got.shape == chain_file[2].shape and got.dtype == np.float64
        np.testing.assert_array_equal(got, np.loadtxt(path))
        np.testing.assert_array_equal(got, jax_native.load_chain_text(path))


@pytest.mark.parametrize("skip", [1, 100, 49_999])
def test_loader_skiprows(chain_file, skip):
    path = chain_file[0]
    want = np.loadtxt(path, skiprows=skip, ndmin=2)
    np.testing.assert_array_equal(_native.load_chain_text(path, skiprows=skip), want)


def test_loader_handles_comments_and_blank_lines(tmp_path):
    path = tmp_path / "messy.txt"
    path.write_text("# header comment\n1 2 3\n\n4 5 6  # trailing comment\n# trailing\n\t7 8 9\r\n")
    got = _native.load_chain_text(str(path))
    np.testing.assert_array_equal(got, [[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    np.testing.assert_array_equal(got, np.loadtxt(path))


def test_loader_empty_file(tmp_path):
    """An empty file (or one of comments only) gives no rows, as the JAX
    loader does; ``WeightedSamples`` then reports no samples."""
    for name, text in (("empty.txt", ""), ("comments.txt", "# nothing\n\n")):
        path = tmp_path / name
        path.write_text(text)
        assert _native.load_chain_text(str(path)).size == 0


@pytest.mark.parametrize("text,what", [("1 2 3\n4 5\n", "ragged"), ("1 2 3\n4 x 6\n", "unparseable")])
def test_loader_malformed_file_raises_naming_it(tmp_path, text, what):
    """No fallback parser: ragged rows or a bad number raise ValueError
    naming the file, where np.loadtxt raises ValueError too."""
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"bad.txt: .*{what}"):
        _native.load_chain_text(str(path))
    with pytest.raises(ValueError):
        np.loadtxt(path)


def test_loader_missing_file_raises(tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        _native.load_chain_text(str(tmp_path / "absent.txt"))


def test_loader_parses_large_files_in_chunks(tmp_path):
    """Past 1 MB the file is split over threads at line boundaries: the
    rows come back in file order."""
    data = np.arange(300_000 * 3, dtype=np.float64).reshape(-1, 3) / 7.0
    path = tmp_path / "big.txt"
    np.savetxt(path, data, fmt="%.17g")
    assert path.stat().st_size > 1 << 20
    np.testing.assert_array_equal(_native.load_chain_text(str(path)), data)
