#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port (getdist_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases: require CUDA and print the card's name and power limit; build the
CUDA kernels from ``getdist_tpu_torch/csrc``; run the main path,
``triangle_densities`` on ``bench.make_chain(1_000_000, 30)`` (30 1D and 435
2D densities), counting each kernel's launches in one run and timing warm
runs; profile one run (the top of the kernel-time table is printed);
check its outputs; hold each kernel against its plain PyTorch version
on the main path's own inputs (timing both); compare the slice on the card
with the port on the CPU at 100k x 8. Prints one JSON line of kernel
results, then ``{"ok": true, "device": {...}}`` as the last line. Any
failure exits non-zero without the ok line. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps):
    """Mean device milliseconds per call of ``fn`` after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def check_outputs(d1, d2, p, k):
    import torch

    check(tuple(d1["P"].shape) == (p, 1024) and tuple(d2["P"].shape) == (k, 256, 256), "output shapes")
    check(tuple(d2["contours"].shape) == (k, 2), "contour shape")
    for name, grid in (("1D", d1["P"]), ("2D", d2["P"])):
        check(bool(torch.isfinite(grid).all()), f"{name} grids finite")
        peaks = grid.flatten(1).amax(1)
        check(bool(((peaks - 1).abs() < 1e-6).all()), f"{name} grids peak at 1")
    levels = d2["contours"]
    check(bool(((levels > 0) & (levels <= 1)).all()), "contour levels in (0, 1]")
    check(bool((levels[:, 0] > levels[:, 1]).all()), "68% level above the 95% level")
    for key in ("neff", "bandwidth", "host_pack"):
        check(bool(torch.isfinite(d1[key]).all()), f"1D {key} finite")
    for key in ("rx", "ry", "corr", "diag"):
        check(bool(torch.isfinite(d2[key]).all()), f"2D {key} finite")


def cross_device(make_chain, triangle_densities):
    """The slice on the card against the port on the CPU (plain versions),
    at the tolerances of tests/test_torch_batched.py."""
    import numpy as np

    samples, weights = make_chain(100_000, 8)
    g1, g2 = triangle_densities(samples, weights, device="cuda")
    c1, c2 = triangle_densities(samples, weights, device="cpu")
    g1 = {k: v for k, v in g1.items() if v is not None}
    report = {}

    def close(name, got, want, rtol=0.0, atol=0.0):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = np.abs(got - want)
        report[name] = float(err.max())
        check(bool(np.all(err <= atol + rtol * np.abs(want))), f"cross-device {name}: max abs diff {err.max()}")

    for key in ("neff", "bandwidth"):
        close(f"1D {key}", g1[key], c1[key], rtol=1e-4)
    for i in range(2):
        close(f"1D range[{i}]", g1["range"][i], c1["range"][i], rtol=1e-4)
    close("1D P", g1["P"], c1["P"], atol=1e-4)
    for key in ("rx", "ry", "corr"):
        close(f"2D {key}", g2[key], c2[key], rtol=1e-3)
    close("2D P", g2["P"], c2["P"], atol=5e-4)
    close("2D contours", g2["contours"], c2["contours"], rtol=0.02)
    return report


def profile_slice(run):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi failed"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    sys.path.insert(0, ROOT)
    from bench import make_chain
    from getdist_tpu_torch.ops import _cuda, batched, dft_conv, pair_hist

    lib = _cuda.library()
    print(f"build: {lib.build_seconds:.2f} s with nvcc -> {os.path.relpath(lib.path, ROOT)}")

    # main path at full size
    t0 = time.perf_counter()
    samples, weights = make_chain(1_000_000, 30)
    print(f"chain 1,000,000 x 30 made in {time.perf_counter() - t0:.1f} s")
    p = samples.shape[1]
    k = p * (p - 1) // 2

    def run():
        return batched.triangle_densities(samples, weights, device="cuda")

    cold_s, _ = wall_s(run)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    for fn in counters:
        fn.launches = 0
    _, (d1, d2) = wall_s(run)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in one main-path run: {launches}")
    check(launches == {"pair_histograms": 1, "dft_conv_spectrum": 1, "dft_conv2d": 2}, "kernel launch counts")
    check_outputs(d1, d2, p, k)
    warm = min(wall_s(run)[0] for _ in range(3))
    torch.cuda.reset_peak_memory_stats()
    wall_s(run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def run_1d():
        return batched.all_1d_densities(*batched.prepare_chain(samples, weights, "cuda"))

    t1d = min(wall_s(run_1d)[0] for _ in range(3))
    print(
        f"slice 30 x 1M: first call {cold_s * 1e3:.1f} ms, warm {warm * 1e3:.1f} ms (min of 3; 1D stage "
        f"{t1d * 1e3:.1f} ms incl. upload), peak device memory {peak_gb:.2f} GB"
    )
    profile_slice(run)

    # each kernel against its plain version on the main path's inputs
    s_dev, w_dev = batched.prepare_chain(samples, weights, "cuda")
    binmin, binmax = d1["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    pairs = torch.tensor([(i, j) for i in range(p) for j in range(i + 1, p)], dtype=torch.int32, device="cuda")
    pa, pb = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
    hists = pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=True)
    ref_h = pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True)
    err_h = float((hists - ref_h).abs().max())
    check(err_h == 0.0, f"K1 bit-exact (max abs diff {err_h})")
    check(float(hists.double().sum()) == float(weights.sum()) * k, "K1 total mass")
    results = [
        {
            "name": "pair_histograms",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            "replaces": "getdist_tpu/ops/pallas_kernels.py:309",
            "launches": launches["pair_histograms"],
            "max_abs_err": err_h,
            "ms": cuda_ms(lambda: pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=True), 10),
            "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True), 2),
        }
    ]
    kernels = batched._gauss_kernel_2d(d2["rx"], d2["ry"], d2["corr"], 30)
    ur, ui = dft_conv.dft_conv_spectrum(kernels)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels)
    scale = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    err_s = max(float((ur - ur0).abs().max()), float((ui - ui0).abs().max()))
    check(err_s <= 1e-4 * scale, f"K2 within 1e-4 max|ref| ({err_s} vs {scale})")
    conv = dft_conv.dft_conv2d(hists, ur, ui, 256, 30)
    conv0 = dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, 30)
    err_c = float((conv - conv0).abs().max())
    check(err_c <= 1e-4 * float(conv0.abs().max()), f"K3 within 1e-4 max|ref| ({err_c} vs {float(conv0.abs().max())})")
    results += [
        {
            "name": "dft_conv_spectrum",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:155",
            "launches": launches["dft_conv_spectrum"],
            "max_abs_err": err_s,
            "ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels), 5),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum_plain(kernels), 5),
        },
        {
            "name": "dft_conv2d",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:190",
            "launches": launches["dft_conv2d"],
            "max_abs_err": err_c,
            "ms": cuda_ms(lambda: dft_conv.dft_conv2d(hists, ur, ui, 256, 30), 5),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, 30), 5),
        },
    ]
    for r in results:
        print(f"{r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, max abs err {r['max_abs_err']:.3g}")

    report = cross_device(make_chain, batched.triangle_densities)
    print(f"cross-device 100k x 8 (cuda vs cpu), max abs diffs: {json.dumps(report)}")

    print(card)
    print(json.dumps({"kernels": results}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - the smoke run reports every failure and exits non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
