"""The port's native pair-histogram pass (``getdist_tpu_torch._native``).

Bit for bit against its plain version (one ``np.bincount`` per pair) and
against the JAX package's copy (``getdist_tpu._native.pair_histograms``)
on the same inputs; a failed build and a bad call raise.
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
