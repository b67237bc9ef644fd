#!/usr/bin/env python
"""Time the port's DFT-convolution kernels K2/K3 on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_dft_conv_torch.py

At the main paths' shapes (the fused path's f32 'same' and 'valid'
convolutions, parity's f64 bucket), on random inputs made from a seed:
prints each kernel's error against its plain version, a repeat call's
bitwise equality, the f32 convolution's error against an f64 chain (the
kernel's and the plain f32 chain's), and CUDA-event times of K2, K3 and
``torch.fft.fft2`` (mean of 5 calls after a warm-up). Imports nothing of
JAX.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from getdist_tpu_torch.ops import _cuda, dft_conv  # noqa: E402

# (dtype, pairs, kernel support m, frame, grid size I, offset), out_size 256
SHAPES = (
    (torch.float32, 435, 61, 384, 256, 30),
    (torch.float32, 435, 61, 384, 316, 60),
    (torch.float64, 435, 69, 512, 256, 34),
)


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


def rel(got, want):
    return float((got.double() - want.double()).abs().max()) / float(want.abs().max())


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    lib = _cuda.library()
    print(f"build {lib.build_seconds:.1f} s")
    for dtype, k, m, pad, size, off in SHAPES:
        rng = np.random.RandomState(1)
        grids = torch.from_numpy(rng.rand(k, size, size) * 50).to("cuda", dtype)
        kernels = torch.from_numpy(rng.rand(k, m, m)).to("cuda", dtype)
        ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
        ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
        out = dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad)
        out0 = dft_conv.dft_conv2d_plain(grids, ur0, ui0, 256, off, pad)
        spec_err = max(rel(ur, ur0), rel(ui, ui0))
        same = torch.equal(out, dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
        print(f"{dtype} K={k} m={m} P={pad} I={size} offset={off}: error of max|plain| K2 {spec_err:.3g}, "
              f"K3 {rel(out, out0):.3g}; repeat bitwise equal {same}")
        if dtype == torch.float32:
            ref = dft_conv.dft_conv2d_plain(grids.double(), *dft_conv.dft_conv_spectrum_plain(kernels.double(), pad),
                                            256, off, pad)
            print(f"   K3 against an f64 chain: kernel {rel(out, ref):.3g}, plain f32 chain {rel(out0, ref):.3g}")
            del ref
        t2 = cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad))
        t3 = cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, 256, off, pad))
        tf = cuda_ms(lambda: torch.fft.fft2(kernels, s=(pad, pad)))
        print(f"   K2 {t2:.3f} ms (torch.fft.fft2 {tf:.3f} ms), K3 {t3:.3f} ms")
        del grids, kernels, ur, ui, ur0, ui0, out, out0
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
