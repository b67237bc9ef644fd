"""Host C++ passes of the port, built with ``g++`` at first use and called
through ``ctypes``.

Three passes, each the port's own copy of one of ``getdist_tpu/_native``'s:
the multi-threaded chain text loader of ``loadMCSamples``
(``fastloader.cpp``, :func:`load_chain_text`), and in ``pairhist.cpp`` the
exact f64 pair histograms of the host parity variant
(:func:`pair_histograms`) and the column binning into int32 bin indices
(:func:`bin_columns`). Each library is compiled with ``g++ -O3
-std=c++17 -shared -fPIC -pthread`` on its first call into
``getdist_tpu_torch/_build``, keyed by a hash of the source and the
flags, and nothing is built at import. A failed build, or a non-zero
return code, raises: there is no fallback to numpy.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from getdist_tpu_torch._compile import build_once

__all__ = ["bin_columns", "load_chain_text", "pair_histograms", "pair_histograms_plain"]

SOURCE = Path(__file__).resolve().parent / "pairhist.cpp"
LOADER_SOURCE = Path(__file__).resolve().parent / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


def build(source, build_dir):
    """Compile ``source`` into ``build_dir`` (once per source hash,
    :func:`getdist_tpu_torch._compile.build_once`) and return the
    library's path; raises ``RuntimeError`` with the compiler's output
    when ``g++`` fails."""
    source = Path(source)

    def steps(out, tag):
        return [[["g++", *CXX_FLAGS, str(source), "-o", str(out)]]], []

    return build_once(source.stem, [source], CXX_FLAGS, build_dir, steps)[0]


@functools.lru_cache(maxsize=None)
def library():
    """The pair-histogram library, built on first call."""
    lib = ctypes.CDLL(str(build(SOURCE, BUILD_DIR)))
    lib.gdt_pair_hists.restype = ctypes.c_int
    lib.gdt_pair_hists.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64, _F64P, _I64P, _I64P, ctypes.c_int64,
        ctypes.c_int64, _F64P, ctypes.c_int,
    ]
    lib.gdt_bin_columns.restype = ctypes.c_int
    lib.gdt_bin_columns.argtypes = [
        _F64P, ctypes.c_int64, ctypes.c_int64, _F64P, _F64P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def loader_library():
    """The chain text loader's library, built on first call."""
    lib = ctypes.CDLL(str(build(LOADER_SOURCE, BUILD_DIR)))
    lib.gdt_parse_chain.restype = ctypes.c_int
    lib.gdt_parse_chain.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(_F64P), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.c_char_p, ctypes.c_long,
    ]
    lib.gdt_free.restype = None
    lib.gdt_free.argtypes = [_F64P]
    return lib


def load_chain_text(fname, skiprows=0):
    """(rows, cols) f64 array of a whitespace-separated numeric text file,
    its first ``skiprows`` lines skipped; ``#`` comments and blank lines
    ignored. Bit for bit ``np.loadtxt(fname, skiprows=skiprows)`` (numbers
    parsed with correctly rounded ``std::from_chars``); an empty file gives
    a (0, 0) array. Ragged rows or a bad number raise ``ValueError`` naming
    the file, an unreadable file ``OSError``."""
    lib = loader_library()
    data = _F64P()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    err = ctypes.create_string_buffer(256)
    rc = lib.gdt_parse_chain(os.fsencode(fname), int(skiprows or 0), ctypes.byref(data), ctypes.byref(rows),
                             ctypes.byref(cols), err, 256)
    if rc == 1:
        raise ValueError(f"{fname}: {err.value.decode()}")
    if rc != 0:
        raise OSError(f"{fname}: {err.value.decode()}")
    if rows.value == 0 or cols.value == 0:
        return np.empty((0, 0))
    try:
        return np.array(np.ctypeslib.as_array(data, shape=(rows.value, cols.value)))  # an owning copy
    finally:
        lib.gdt_free(data)


def _n_threads():
    return max(1, min(8, os.cpu_count() or 1))


def pair_histograms(ixs, weights, pairs, nbins):
    """Exact f64 pair histograms (K, nbins, nbins), rows = b, cols = a, of
    (P, N) bin-index rows in [0, nbins) and (N,) weights, the pairs fanned
    out across threads. Bit-identical to :func:`pair_histograms_plain`
    (the same f64 additions in the same sample order per pair)."""
    ixs = np.ascontiguousarray(ixs, np.int32)
    weights = np.ascontiguousarray(weights, np.float64)
    pair_arr = np.asarray(pairs, np.int64).reshape(-1, 2)
    pa, pb = np.ascontiguousarray(pair_arr[:, 0]), np.ascontiguousarray(pair_arr[:, 1])
    p, n = ixs.shape
    k = pair_arr.shape[0]
    if weights.shape != (n,):
        raise ValueError(f"need one weight per sample: {weights.shape} weights for {n} samples")
    out = np.zeros((k, nbins * nbins), np.float64)
    rc = library().gdt_pair_hists(
        ixs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, p, weights.ctypes.data_as(_F64P),
        pa.ctypes.data_as(_I64P), pb.ctypes.data_as(_I64P), k, nbins, out.ctypes.data_as(_F64P), _n_threads(),
    )
    if rc != 0:
        raise RuntimeError(f"gdt_pair_hists failed with rc {rc} (P={p}, N={n}, K={k}, nbins={nbins})")
    return out.reshape(k, nbins, nbins)


def bin_columns(samples, range_min, dx, nbins):
    """(P, N) int32 bin indices of (N, P) f64 samples, the columns fanned
    out across threads: bit for bit ``((x - range_min) / dx).astype(int)``
    clipped to [0, nbins), column by column. A failed build or a non-zero
    return code raises."""
    samples = np.ascontiguousarray(samples, np.float64)
    n, p = samples.shape
    range_min = np.ascontiguousarray(range_min, np.float64)
    dx = np.ascontiguousarray(dx, np.float64)
    if range_min.shape != (p,) or dx.shape != (p,):
        raise ValueError(f"need one range_min and dx per column: {range_min.shape}, {dx.shape} for {p} columns")
    out = np.empty((p, n), np.int32)
    rc = library().gdt_bin_columns(
        samples.ctypes.data_as(_F64P), n, p, range_min.ctypes.data_as(_F64P), dx.ctypes.data_as(_F64P), nbins,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _n_threads(),
    )
    if rc != 0:
        raise RuntimeError(f"gdt_bin_columns failed with rc {rc} (N={n}, P={p}, nbins={nbins})")
    return out


def pair_histograms_plain(ixs, weights, pairs, nbins):
    """The plain version of :func:`pair_histograms`: one ``np.bincount``
    of ``b * nbins + a`` per pair (the reference's ``_make2Dhist``). Its
    oracle; no path calls it."""
    ixs = np.asarray(ixs, np.int64)
    return np.stack(
        [
            np.bincount(ixs[b] * nbins + ixs[a], weights=weights, minlength=nbins * nbins).reshape(nbins, nbins)
            for a, b in np.asarray(pairs, np.int64).reshape(-1, 2)
        ]
    )
