#!/usr/bin/env python
"""Time the port's DFT-convolution kernels K2/K3 on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_dft_conv_torch.py            # times and errors
    python3 scripts/time_dft_conv_torch.py --depths   # also the f32 partial depths
    python3 scripts/time_dft_conv_torch.py --no-products  # also the f32 stages without their products

At the main paths' shapes (the fused path's f32 'same' and 'valid'
convolutions, the bounded chain's 316-wide ones at frame 384 and the
clamped rescue's at 768, parity's f64 bucket), on random inputs made from a
seed: prints each kernel's error against its plain version, a repeat call's
bitwise equality, the f32 convolution's error against an f64 chain (the
kernel's and the plain f32 chain's), CUDA-event times of K2, K3 and
``torch.fft.fft2`` (mean of 5 calls after a warm-up), and the device time of
each f32 stage kernel (``torch.profiler``, mean of 3 calls).

``--depths`` builds copies of ``csrc/dft_conv.cu`` whose f32 kernels add
their truncating tensor-core partial sums into the tile's sum every 8, 16
or 32 of depth, or only at the end (``kAccSteps``), under
``getdist_tpu_torch/_build/``, and prints each one's K2/K3 errors at the
bounded shapes and their times. ``--no-products`` builds a copy whose wgmma
instructions are left out (the results are garbage; the copies, fragment
loads, barriers and epilogues all run) and prints its K2 and K3 times
(CUDA events) at the bounded shapes beside the full kernels': what they
cost without the tensor cores. Imports nothing of JAX.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from getdist_tpu_torch.ops import _cuda, dft_conv  # noqa: E402

# (dtype, pairs, kernel support m, frame, grid size I, offset), out_size 256
SHAPES = (
    (torch.float32, 435, 61, 384, 256, 30),
    (torch.float32, 435, 61, 384, 316, 60),
    (torch.float32, 110, 253, 768, 256, 126),
    (torch.float32, 110, 253, 768, 508, 252),
    (torch.float64, 435, 69, 512, 256, 34),
)
# the f32 kernel's stages by template arguments (A operand, epilogue)
STAGES = {"<0, 0>": "S1/C1", "<2, 1>": "S2", "<2, 2>": "C2", "<3, 3>": "C3", "<1, 4>": "C4"}
DEPTHS = {"8": 1, "16": 2, "32": 4, "full": 1 << 20}  # depth of a partial: its steps of 8


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stage_ms(fn, reps=3):
    """Device ms of each f32 stage kernel in one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "dft_wgmma_kernel" in e.key:
            name = next((v for k, v in STAGES.items() if k in e.key), e.key[:40])
            out[name] = out.get(name, 0.0) + (getattr(e, "device_time_total", 0) or e.cuda_time_total) / 1e3 / reps
    return out


def rel(got, want):
    return float((got.double() - want.double()).abs().max()) / float(want.abs().max())


def inputs(k, m, size, dtype):
    rng = np.random.RandomState(1)
    grids = torch.from_numpy(rng.rand(k, size, size) * 50).to("cuda", dtype)
    kernels = torch.from_numpy(rng.rand(k, m, m)).to("cuda", dtype)
    return grids, kernels


def errors(kernels, grids, off, pad):
    """(K2 of max|plain|, K3 of max|plain|, K3 of max|f64|, plain f32 K3 of max|f64|, repeat bitwise)."""
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    out = dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad)
    out0 = dft_conv.dft_conv2d_plain(grids, ur0, ui0, 256, off, pad)
    same = torch.equal(out, dft_conv.dft_conv2d(grids, *dft_conv.dft_conv_spectrum(kernels, pad), 256, off, pad))
    f64 = f64_plain = float("nan")
    if kernels.dtype == torch.float32:
        ref = dft_conv.dft_conv2d_plain(grids.double(), *dft_conv.dft_conv_spectrum_plain(kernels.double(), pad),
                                        256, off, pad)
        f64, f64_plain = rel(out, ref), rel(out0, ref)
    return max(rel(ur, ur0), rel(ui, ui0)), rel(out, out0), f64, f64_plain, same


def depth_library(tag, steps):
    """A copy of the kernels' library whose f32 partial sums span ``steps`` steps of depth 8."""
    return patched_library(f"depth_{tag}", r"constexpr int kAccSteps = \d+;", f"constexpr int kAccSteps = {steps};")


def patched_library(tag, pattern, replacement):
    """The kernels' library built from csrc/dft_conv.cu with ``pattern`` (once) replaced."""
    src = open(os.path.join(ROOT, "getdist_tpu_torch/csrc/dft_conv.cu"), encoding="utf-8").read()
    patched, n = re.subn(pattern, replacement, src)
    if n != 1:
        raise RuntimeError(f"{pattern!r} not found once in csrc/dft_conv.cu")
    folder = os.path.join(_cuda.BUILD_DIR, tag)
    os.makedirs(folder, exist_ok=True)
    cu, so = os.path.join(folder, "dft_conv.cu"), os.path.join(folder, "libdft_conv.so")
    with open(cu, "w", encoding="utf-8") as handle:
        handle.write(patched)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", so, cu], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for name in ("dft_spectrum_launch", "dft_conv_launch"):
        fn = getattr(lib, name)
        fn.argtypes = list(_cuda._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return _cuda.KernelLibrary(lib, so, 0.0, "")


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    lib = _cuda.library()
    print(f"build {lib.build_seconds:.1f} s")
    for dtype, k, m, pad, size, off in SHAPES:
        grids, kernels = inputs(k, m, size, dtype)
        k2, k3, f64, f64_plain, same = errors(kernels, grids, off, pad)
        print(f"{dtype} K={k} m={m} P={pad} I={size} offset={off}: error of max|plain| K2 {k2:.3g}, K3 {k3:.3g}; "
              f"repeat bitwise equal {same}")
        if dtype == torch.float32:
            print(f"   K3 against an f64 chain: kernel {f64:.3g}, plain f32 chain {f64_plain:.3g}")
        ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
        t2 = cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
        t3 = cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
        tf = cuda_ms(lambda: torch.fft.fft2(kernels, s=(pad, pad)))
        print(f"   K2 {t2:.3f} ms (torch.fft.fft2 {tf:.3f} ms), K3 {t3:.3f} ms")
        if dtype == torch.float32:
            s2 = stage_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
            s3 = stage_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
            print("   stage kernels (device ms): K2 " + ", ".join(f"{n} {t:.3f}" for n, t in s2.items())
                  + "; K3 " + ", ".join(f"{n} {t:.3f}" for n, t in s3.items()))
        del grids, kernels, ur, ui
        torch.cuda.empty_cache()
    if "--depths" in sys.argv[1:]:
        saved = _cuda.library
        for tag, steps in DEPTHS.items():
            variant = depth_library(tag, steps)
            _cuda.library = lambda v=variant: v
            try:
                for _, k, m, pad, size, off in SHAPES[1:4:2]:
                    grids, kernels = inputs(k, m, size, torch.float32)
                    k2, k3, f64, _, _ = errors(kernels, grids, off, pad)
                    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
                    t2 = cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
                    t3 = cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
                    print(f"partial sums over depth {tag}, K={k} P={pad} I={size}: K2 {k2:.3g}, K3 {k3:.3g} of "
                          f"max|plain|; K3 {f64:.3g} of max|f64|; K2 {t2:.3f} ms, K3 {t3:.3f} ms")
                    del grids, kernels, ur, ui
                    torch.cuda.empty_cache()
            finally:
                _cuda.library = saved
    if "--no-products" in sys.argv[1:]:
        variant = patched_library("no_products", r"(void wgmma_tf32\(.*int scale_d\) \{\n)",
                                  r"\1  if (scale_d >= 0) return;  // left out\n")
        saved = _cuda.library
        for _, k, m, pad, size, off in SHAPES[1:4]:
            grids, kernels = inputs(k, m, size, torch.float32)
            ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
            times = []
            for lib in (saved, lambda v=variant: v):
                _cuda.library = lib
                try:
                    times.append((cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad)),
                                  cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))))
                finally:
                    _cuda.library = saved
            (k2, k3), (k2_bare, k3_bare) = times
            print(f"without products, K={k} P={pad} I={size}: K2 {k2:.3f} / {k2_bare:.3f} ms ({k2_bare / k2:.0%}), "
                  f"K3 {k3:.3f} / {k3_bare:.3f} ms ({k3_bare / k3:.0%}) (with / without)")
            del grids, kernels, ur, ui
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
