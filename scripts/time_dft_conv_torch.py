#!/usr/bin/env python
"""Time the port's DFT-convolution kernels K2/K3 on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_dft_conv_torch.py            # times and errors
    python3 scripts/time_dft_conv_torch.py --depths   # also the f32 partial depths
    python3 scripts/time_dft_conv_torch.py --no-products  # also the stages without their products
    python3 scripts/time_dft_conv_torch.py --f64      # the f64 shapes only
    python3 scripts/time_dft_conv_torch.py --f64 --f64-parts  # f64 stages without a part

At the main paths' shapes (the fused path's f32 'same' and 'valid'
convolutions, the bounded chain's 316-wide ones at frame 384 and the
clamped rescue's at 768; in f64 parity's 435 x 256^2 at 512, bounded
parity's 324-wide extensions at 512 and its K2 buckets, the meanlikes
smoothing's 316- and 508-wide inputs), on random inputs made from a seed:
prints each kernel's error against its plain version, a repeat call's
bitwise equality, the f32 convolution's error against an f64 chain (the
kernel's and the plain f32 chain's), CUDA-event times of K2, K3 and
``torch.fft.fft2`` (mean of 5 calls after a warm-up), the host time of one
K2 call (enqueue only, mean of 20), the device time of one K2 call and of
one ``torch.fft.fft2`` call (``torch.profiler``: every kernel, memcpy and
memset, mean of 5 calls; and CUDA events around 20 calls queued behind
a sleep kernel, which hide the host's enqueue), and the device time of
each stage kernel (``torch.profiler``, mean of 3 calls).

``--depths`` builds copies of ``csrc/dft_conv.cu`` whose f32 kernels add
their truncating tensor-core partial sums into the tile's sum every 8, 16
or 32 of depth, or only at the end (``kAccSteps``), under
``getdist_tpu_torch/_build/``, and prints each one's K2/K3 errors at the
bounded shapes and their times. ``--no-products`` builds a copy whose wgmma
and DMMA instructions are left out (the results are garbage; the copies,
fragment loads, barriers and epilogues all run) and prints its K2 and K3
times (CUDA events) at the bounded shapes (f32 and f64) beside the full
kernels': what they cost without the tensor cores. ``--f64-parts`` builds copies of the f64 kernel
without its products, without its epilogue stores or without its data
loads (the results are garbage) and prints their stage times at parity's
and the bounded f64 shapes. Imports nothing of JAX.
"""

import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from getdist_tpu_torch.ops import _cuda, dft_conv  # noqa: E402

# (dtype, pairs, kernel support m, frame, grid size I, offset), out_size 256; I None: K2 only
SHAPES = (
    (torch.float32, 435, 61, 384, 256, 30),
    (torch.float32, 435, 61, 384, 316, 60),
    (torch.float32, 110, 253, 768, 256, 126),
    (torch.float32, 110, 253, 768, 508, 252),
    (torch.float64, 435, 69, 512, 256, 34),  # parity
    (torch.float64, 310, 69, 512, 324, 68),  # bounded parity's periodic extensions
    (torch.float64, 435, 61, 384, 316, 60),  # the meanlikes smoothing at 384
    (torch.float64, 110, 253, 768, 508, 252),  # and at 768 (the clamped rescue's pairs)
    (torch.float64, 15, 37, 384, None, None),  # bounded parity's other K2 buckets
    (torch.float64, 105, 133, 640, None, None),
    (torch.float64, 2, 197, 768, None, None),
    (torch.float64, 3, 253, 768, None, None),
)
BOUNDED = SHAPES[1:4] + SHAPES[5:8]  # the --no-products shapes
# the stage kernels by name and template arguments (A operand, epilogue)
STAGES = {
    "dft_wgmma_kernel": {"<0, 0>": "S1/C1", "<2, 1>": "S2", "<2, 2>": "C2", "<3, 3>": "C3", "<1, 4>": "C4"},
    "dft_dmma_kernel": {"<0, 0>": "S1/C1", "<2, 1>": "S2", "<2, 2>": "C2", "<3, 3>": "C3", "<1, 4>": "C4"},
}
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


def host_ms(fn, reps=20):
    """Host ms per call of ``fn`` (the enqueue: no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def stage_ms(fn, reps=3):
    """Device ms of each stage kernel in one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        kernel = next((k for k in STAGES if k in e.key), None)
        if kernel is not None:
            name = next((v for k, v in STAGES[kernel].items() if k in e.key), e.key[:40])
            out[name] = out.get(name, 0.0) + (getattr(e, "device_time_total", 0) or e.cuda_time_total) / 1e3 / reps
    return out


def device_ms(fn, reps=5):
    """Device ms of one call of ``fn``: all its kernels, memcpys and memsets."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer")]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps


def queued_ms(fn, reps=20):
    """Device ms of one call of ``fn``: ``reps`` calls queued behind a sleep
    kernel, so that CUDA events time them back to back without the host."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    return variant_library(f"depth_{tag}", ((r"constexpr int kAccSteps = \d+;", f"constexpr int kAccSteps = {steps};"),))


def _build_patched(tag, patched):
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


def variant_library(tag, patches):
    """A copy of the kernels' library built from csrc/dft_conv.cu with each
    (pattern, replacement) of ``patches`` applied once."""
    src = open(os.path.join(ROOT, "getdist_tpu_torch/csrc/dft_conv.cu"), encoding="utf-8").read()
    for pattern, replacement in patches:
        src, n = re.subn(pattern, replacement, src)
        if n != 1:
            raise RuntimeError(f"{pattern!r} not found once in csrc/dft_conv.cu")
    return _build_patched(tag, src)


# the f64 kernel without its products: each DMMA keeps its fragments (their loads stay) and does nothing
F64_NO_PRODUCTS = (r"(void dmma\(.*\) \{\n)",
                   r'\1  asm volatile("" : "+d"(d[0]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), '
                   r'"d"(b[1]));  // left out\n  return;\n')
# what the f64 stages cost without a part (--f64-parts): a runtime condition that is never true
F64_PARTS = {
    "no products": (F64_NO_PRODUCTS,),
    "no epilogue": ((r"(\n +)(store_tile<kEpi, kP>\()", r"\1if (p.m < 0) \2"),),
    "no data loads": (
        (r"(\n +)(load_at\()", r"\1if (p.m < 0) \2"),
        (r"(\n +)(f32::tma_load\(st \+ kTileB \+ pl)", r"\1if (p.m < 0) \2"),
        (r"kTileB \+ \(kA == kRealT \? 0 : kP \* kTileA\)", "kTileB + (kA == kRealT || p.m >= 0 ? 0 : kP * kTileA)"),
    ),
}


def no_products_library():
    """A copy of the kernels' library without its tensor-core products: each
    wgmma returns at once, each DMMA keeps its fragments and does nothing."""
    return variant_library("no_products", (
        (r"(void wgmma_tf32\(.*int scale_d\) \{\n)", r"\1  if (scale_d >= 0) return;  // left out\n"),
        F64_NO_PRODUCTS,
    ))


def time_shape(dtype, k, m, pad, size, off):
    """Errors, times and (f32, f64) stage times of one shape with the library
    in use."""
    kernels = inputs(k, m, size or 2, dtype)[1]
    if size is None:
        ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
        ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
        again = dft_conv.dft_conv_spectrum(kernels, pad)
        same = torch.equal(again[0], ur) and torch.equal(again[1], ui)
        print(f"{dtype} K={k} m={m} P={pad} (K2 only): error of max|plain| K2 {max(rel(ur, ur0), rel(ui, ui0)):.3g}; "
              f"repeat bitwise equal {same}")
    else:
        grids = inputs(k, m, size, dtype)[0]
        k2, k3, f64, f64_plain, same = errors(kernels, grids, off, pad)
        print(f"{dtype} K={k} m={m} P={pad} I={size} offset={off}: error of max|plain| K2 {k2:.3g}, K3 {k3:.3g}; "
              f"repeat bitwise equal {same}")
        if dtype == torch.float32:
            print(f"   K3 against an f64 chain: kernel {f64:.3g}, plain f32 chain {f64_plain:.3g}")
    t2 = cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
    tf = cuda_ms(lambda: torch.fft.fft2(kernels, s=(pad, pad)))
    h2 = host_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
    d2 = device_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
    df = device_ms(lambda: torch.fft.fft2(kernels, s=(pad, pad)))
    s2 = stage_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
    q2 = queued_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
    qf = queued_ms(lambda: torch.fft.fft2(kernels, s=(pad, pad)))
    line = (f"   K2 {t2:.3f} ms (torch.fft.fft2 {tf:.3f} ms; host {h2:.3f} ms a call; device time under the "
            f"profiler: K2 {d2:.4f} ms, torch.fft.fft2 {df:.4f} ms; queued behind a sleep kernel: K2 {q2:.4f} ms, "
            f"torch.fft.fft2 {qf:.4f} ms)")
    if size is not None:
        ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
        t3 = cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
        s3 = stage_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
        line += f", K3 {t3:.3f} ms"
    print(line)
    stages = "   stage kernels (device ms): K2 " + ", ".join(f"{n} {t:.3f}" for n, t in s2.items())
    if size is not None:
        stages += "; K3 " + ", ".join(f"{n} {t:.3f}" for n, t in s3.items())
    print(stages)
    torch.cuda.empty_cache()


def stage_line(shape, tag):
    """Device ms of each f64 stage at ``shape`` (the results are not checked)."""
    dtype, k, m, pad, size, off = shape
    grids, kernels = inputs(k, m, size, dtype)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    s2 = stage_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
    s3 = stage_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
    print(f"{dtype} K={k} m={m} P={pad} I={size}: stage kernels (device ms): K2 "
          + ", ".join(f"{n} {t:.3f}" for n, t in s2.items()) + "; K3 " + ", ".join(f"{n} {t:.3f}" for n, t in s3.items()))
    del grids, kernels, ur, ui
    torch.cuda.empty_cache()


def with_library(variant, fn):
    saved = _cuda.library
    _cuda.library = lambda: variant
    try:
        return fn()
    finally:
        _cuda.library = saved


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    lib = _cuda.library()
    print(f"build {lib.build_seconds:.1f} s")
    shapes = [s for s in SHAPES if s[0] == torch.float64] if "--f64" in args else SHAPES
    for shape in shapes:
        time_shape(*shape)
    if "--f64-parts" in args:
        for tag, patches in F64_PARTS.items():
            variant = variant_library(tag.replace(" ", "_"), patches)
            for shape in (SHAPES[4],) + BOUNDED[3:]:
                with_library(variant, lambda: stage_line(shape, f"{tag}: "))
    if "--depths" in args:
        for tag, steps in DEPTHS.items():
            variant = depth_library(tag, steps)

            def run():
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

            with_library(variant, run)
    if "--no-products" in args:
        variant = no_products_library()
        for dtype, k, m, pad, size, off in BOUNDED:
            if "--f64" in args and dtype != torch.float64:
                continue
            grids, kernels = inputs(k, m, size, dtype)
            ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)

            def times():
                return (cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad)),
                        cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad)))

            (k2, k3), (k2_bare, k3_bare) = times(), with_library(variant, times)
            print(f"without products, {dtype} K={k} P={pad} I={size}: K2 {k2:.3f} / {k2_bare:.3f} ms "
                  f"({k2_bare / k2:.0%}), K3 {k3:.3f} / {k3_bare:.3f} ms ({k3_bare / k3:.0%}) (with / without)")
            del grids, kernels, ur, ui
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
