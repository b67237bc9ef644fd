"""Host C++ passes of the port, built with ``g++`` at first use and called
through ``ctypes``.

One pass so far: the exact f64 pair histograms of the host parity variant
(``pairhist.cpp``; counterpart of ``getdist_tpu/_native``'s
``pair_histograms``). The library is compiled with ``g++ -O3 -std=c++17
-shared -fPIC -pthread`` on the first call into
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

__all__ = ["pair_histograms", "pair_histograms_plain"]

SOURCE = Path(__file__).resolve().parent / "pairhist.cpp"
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
    return lib


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
