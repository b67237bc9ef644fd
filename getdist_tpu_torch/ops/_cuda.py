"""Build and load the hand-written CUDA kernels of ``getdist_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, run in parallel) and linked into one shared library
with a plain C interface, cached under
``getdist_tpu_torch/_build`` by a hash of the sources
(:func:`getdist_tpu_torch._compile.build_once`), and loaded with
``ctypes``.  Nothing here runs at import time: machines without ``nvcc``
(and the CPU tests) import the package and never build.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import torch

from getdist_tpu_torch._compile import build_once

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # pa, pb, K, host (pinned, 2 K int32), event
    "pair_hist_readback": (_I, _P, _P, _I, _P, _P, _P),
    # ix, index bytes, P, w, weight bytes, pa, pb, n, K, nbins, route, rows, chunks, part, split slots,
    # integer_weights, wmax, n_scale, raw, acc, out, workspace, entries, split
    "pair_hist_wide_launch": (
        _I, _P, _I, _I, _P, _I, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong,
        _I, _P, ctypes.c_longlong, _I, _P, _P, _P, _P, _P, _P,
    ),
    # ix, P, w, weight bytes, pa, pb, inv, slots, n, K, nbins, n_split, integer_weights, wmax, n_scale, raw,
    # acc, out
    "pair_hist_uint8_launch": (
        _I, _P, _I, _P, _I, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P, ctypes.c_longlong, _I, _P, _P, _P,
    ),
    # acc, out, count, wmax, n_scale
    "pair_hist_fixed_convert": (_I, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P),
    # kernels, K, m, kernels' row stride, the route's planes (f64: f64_planes; f32: tf32_planes),
    # scratch T (re, im, ld), spectra (re, im), P
    "dft_spectrum_launch": (_I, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P),
    # grids, K, I, the route's planes, spectra (re, im), scratch T (re, im, ld), E (re, im), T2 (re, im,
    # ld), out, out_size, offset, P
    "dft_conv_launch": (_I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P),
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    log: str  # ptxas resource usage (registers, spills) of a fresh build


def _nvcc():
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")
    return found


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The kernels' shared library, built on first call."""
    sources = sorted(CSRC.glob("*.cu"))

    def steps(out, tag):
        # one nvcc per source, all started together, then one link
        objects = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
        nvcc = _nvcc()
        compiles = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects)]
        return [compiles, [[nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objects)]]], objects

    path, seconds, log = build_once("getdist_kernels", sources, NVCC_FLAGS, BUILD_DIR, steps)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, path, seconds, log)


def call(name, device: torch.device, *args):
    """Launch entry point ``name`` on ``device``'s current stream; raise on a
    non-zero ``cudaError_t``."""
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    err = getattr(library().lib, name)(index, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")


def require_cuda(*tensors, dtype):
    """Check that every tensor is a contiguous CUDA tensor of ``dtype``."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")


def resolve_device(device):
    """``device`` as a torch.device; a CUDA device must exist (the port's
    entry points run on the card unless the caller names the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the host")
    return device


@contextlib.contextmanager
def full_fp32_matmuls():
    """Run float32 matrix products in full FP32 (cuBLAS keeps TF32, about
    three decimal digits, out): ``torch.backends.cuda.matmul.allow_tf32``
    is False inside and the caller's value comes back on exit, exception or
    not. Also a decorator: ``@full_fp32_matmuls()``."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
