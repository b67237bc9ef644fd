#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port (getdist_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases: require CUDA and print the card's name and power limit; build the
CUDA kernels from ``getdist_tpu_torch/csrc``. Then three paths on
``bench.make_chain(1_000_000, 30)`` (30 1D and 435 2D densities):

1. the fused path, ``triangle_densities``: count each kernel's launches in
   one run, time warm runs, profile one run (the top of the kernel-time
   table is printed), check its outputs, hold K1/K2/K3 against their plain
   PyTorch versions on its own inputs (timing both; f32 K2/K3 within 1e-5
   of the largest value at this production frame, two calls bitwise
   equal, both against an f64 chain; each beside the library call and its
   bytes and operations bounds), and compare the path on the card with the
   port on the CPU at 100k x 8;
2. device parity mode, ``MCSamples(...).fastParityDensities(device=True)``:
   one cold and two warm runs (stage profile, peak memory, launch counts of
   one run), checks of its outputs, bin indices of all 30 columns against
   numpy's formula, K4 on this run's sheared stack and f64 K2/K3 on its
   largest bucket against their plain versions (two calls bitwise equal),
   and parity on the card
   against the port on the CPU at 20k x 6 (a bounded parameter and a
   pair with |corr| > 0.87);
3. the sharded path (``getdist_tpu_torch.parallel``) in a one-rank NCCL
   group: ``sharded_triangle_densities`` (first call, warm runs, peak
   memory and launch counts of one run, beside ``triangle_densities`` on
   the same device tensors, and agreement with it), then
   ``sharded_pair_hists`` over all 435 pairs through K5 (both weight
   modes, bit-exact against K1 and the plain version) and without a pair
   plan through K4; last, 4 gloo ranks on the CPU run the sharded path on
   a 40k x 6 chain, held against the one-rank run on the card (the only
   run where the N_eff halo exchange and the card meet).

K1 and K5 are timed with the weights their paths pass (integer weights
as uint8, ``pair_hist.narrow_weights``); K1, K4 and K5 each beside one
``torch.bincount`` over flat pair keys, the yardstick no path calls. The
build's ptxas lines of the uint8 pair-histogram kernel are printed.

Prints one JSON line of kernel results (with each kernel's bound on the
card and, where one exists, a single PyTorch call's time), the card line
again, then ``{"ok": true, "device": {...}}`` as the last line. Any
failure exits non-zero without the ok line. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s; FP32
# outside the tensor cores; f32-accurate products on the tensor cores as
# three TF32 passes (495 / 3); FP64 on the tensor cores (DMMA; 34 TFLOP/s
# outside)
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
FP64_FLOPS = 67e12


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


def bound_terms(nbytes, ops, rate):
    """(bytes ms, operations ms): bytes over the HBM rate, operations over
    the peak rate for their type."""
    return nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by): the larger of the two bound_terms."""
    t_bytes, t_ops = bound_terms(nbytes, ops, rate)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hist_bound(ix, weights, k, nbins):
    """K1/K4/K5: index rows and weights read once, f32 histograms written
    once; one add per sample and pair, at the FP32 rate (the published
    table has no integer scalar rate)."""
    n = ix.shape[1]
    nbytes = ix.numel() * ix.element_size() + weights.numel() * weights.element_size() + 4 * k * nbins * nbins
    return bound(nbytes, k * n, FP32_FLOPS)


def library_hist_ms(ix, weights, pa, pb, nbins, reps):
    """One PyTorch call computing K1/K4/K5's function: ``torch.bincount`` of
    flat keys k * nbins^2 + b * nbins + a with the weights repeated per pair
    (the keys and weights are built outside the timed window; ~5 GB at 30 x
    1M, 435 pairs, freed before returning). No index lies outside [0, nbins)
    on the paths' rows."""
    import torch

    k = pa.shape[0]
    pair = torch.arange(k, device=ix.device)[:, None] * (nbins * nbins)
    keys = (pair + ix[pb.long()].long() * nbins + ix[pa.long()].long()).reshape(-1)
    repeated = weights.repeat(k)
    ms = cuda_ms(lambda: torch.bincount(keys, weights=repeated, minlength=k * nbins * nbins), reps)
    del pair, keys, repeated
    torch.cuda.empty_cache()
    return ms


def ptxas_lines(log, name):
    """ptxas's register and spill report of each kernel whose (mangled) name
    holds ``name``, from a fresh build's ``-Xptxas -v`` log."""
    lines, kernel, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel, spill = line.split("'")[1], ""
        elif kernel and "spill" in line:
            spill = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            if name in kernel:
                lines.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spill}")
            kernel = None
    return lines


def _dft_rate(e):
    """K2/K3 operations: f32 at the 3xTF32 tensor-core rate (the fastest
    f32-accurate products), f64 at the DMMA rate."""
    return FP64_FLOPS if e == 8 else TF32X3_FLOPS


def spectrum_work(kernels, pad):
    """K2's (bytes, flops): kernels and two DFT matrices read, two spectra
    written. Flops per pair of U = F K F contract over the m x m kernel
    support only (the frame's zero padding needs none), and U of a real
    kernel is Hermitian, so rows 0..P/2 (h of them) determine it: (h x m)
    real x complex, then (h x m) x (m x P) complex x complex."""
    k, m, _ = kernels.shape
    e = kernels.element_size()
    h = pad // 2 + 1
    return e * (k * m * m + 2 * pad * pad + 2 * k * pad * pad), k * (4 * h * m * m + 8 * h * pad * m)


def conv_work(grids, pad, out_size):
    """K3's (bytes, flops): grids, two spectra and four DFT matrices read,
    the slice written. Flops per pair, with h = P/2 + 1 rows of the
    Hermitian spectrum of real grids: the forward transform contracts over
    the I x I grid (h rows), the spectrum product is 6 per point of those
    rows, and the inverse computes only the out_size rows and, of the real
    part, the out_size columns of the slice; the rows of the first inverse
    product are Hermitian too, so it needs h of their columns and the
    second product a depth of h."""
    k, size, _ = grids.shape
    e = grids.element_size()
    h = pad // 2 + 1
    nbytes = e * (k * size * size + 2 * k * pad * pad + 4 * pad * pad + k * out_size * out_size)
    forward = 4 * h * size * size + 8 * h * pad * size
    inverse = 8 * out_size * pad * h + 4 * out_size * out_size * h
    return nbytes, k * (forward + 6 * h * pad + inverse)


def spectrum_bound(kernels, pad):
    nbytes, flops = spectrum_work(kernels, pad)
    return bound(nbytes, flops, _dft_rate(kernels.element_size()))


def conv_bound(grids, pad, out_size):
    nbytes, flops = conv_work(grids, pad, out_size)
    return bound(nbytes, flops, _dft_rate(grids.element_size()))


def dft_report(name, r, work, rate):
    """One line: K2/K3 beside the full-frame plain chain, the library call
    and both bounds."""
    t_bytes, t_ops = bound_terms(*work, rate)
    print(
        f"{name}: kernel {r['ms']:.3f} ms, plain full-frame matmul chain {r['plain_ms']:.3f} ms, library "
        f"{r['library_ms']:.3f} ms; bounds: bytes {t_bytes:.3f} ms ({work[0] / 1e9:.3f} GB), operations "
        f"{t_ops:.3f} ms ({work[1] / 1e9:.1f} GFLOP at {rate / 1e12:.0f} TFLOP/s); kernel at "
        f"{max(t_bytes, t_ops) / r['ms']:.1%} of the bound, {r['library_ms'] / r['ms']:.2f}x the library's speed"
    )


def dft_checks(kernels, grids, ur, ui, conv, out_size, offset, pad, label):
    """Two calls give bitwise-equal K2/K3 results; the f32 error against the
    plain chain, and both against an f64 chain, are printed."""
    import torch

    from getdist_tpu_torch.ops import dft_conv

    ur2, ui2 = dft_conv.dft_conv_spectrum(kernels, pad)
    conv2 = dft_conv.dft_conv2d(grids, ur2, ui2, out_size, offset, pad)
    check(torch.equal(ur, ur2) and torch.equal(ui, ui2) and torch.equal(conv, conv2), f"{label}: two calls bitwise equal")
    if kernels.dtype == torch.float32:
        u64 = dft_conv.dft_conv_spectrum_plain(kernels.double(), pad)
        ref = dft_conv.dft_conv2d_plain(grids.double(), *u64, out_size, offset, pad)
        plain = dft_conv.dft_conv2d_plain(grids, *dft_conv.dft_conv_spectrum_plain(kernels, pad), out_size, offset, pad)
        scale = float(ref.abs().max())
        print(f"{label}: two calls bitwise equal; K3 against an f64 chain (of max|ref|): kernel "
              f"{float((conv.double() - ref).abs().max()) / scale:.3g}, plain f32 chain "
              f"{float((plain.double() - ref).abs().max()) / scale:.3g}")
    else:
        print(f"{label}: two calls bitwise equal")


def library_conv_ms(grids, kernels, out_size, offset, reps):
    """One PyTorch call computing K3's function: a grouped cuDNN convolution
    (TF32 off) of each grid with its own kernel, full size, then the slice."""
    import torch
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    k, m, _ = kernels.shape
    weight = torch.flip(kernels, dims=(1, 2))[:, None]

    def run():
        full = F.conv2d(grids[None], weight, padding=m - 1, groups=k)[0]
        return full[:, offset : offset + out_size, offset : offset + out_size]

    return cuda_ms(run, reps)


def library_spectrum_ms(kernels, pad, reps):
    """One PyTorch call computing K2's function: the 2D FFT of the
    zero-padded kernels (U = F K F)."""
    import torch

    return cuda_ms(lambda: torch.fft.fft2(kernels, s=(pad, pad)), reps)


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


def check_parity_outputs(dens1, dens2, p, k):
    import numpy as np

    check(len(dens1) == p and len(dens2) == k, f"parity returns {len(dens1)} 1D and {len(dens2)} 2D densities")
    for name, d in list(dens1.items()) + list(dens2.items()):
        check(bool(np.isfinite(d.P).all()), f"parity grid {name} finite")
        check(abs(float(d.P.max()) - 1) < 1e-12, f"parity grid {name} peaks at 1")
    for name, d in dens2.items():
        levels = np.asarray(d.contours)
        check(bool(np.all((levels > 0) & (levels <= 1))), f"parity contour levels of {name} in (0, 1]")


def cross_device(make_chain, triangle_densities):
    """The fused path on the card against the port on the CPU (plain
    versions), at the tolerances of tests/test_torch_batched.py."""
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


def parity_cross_device(MCSamples):
    """Parity mode on the card against the port on the CPU, at the slice
    tests' tolerances, on a 20k x 6 chain with a bounded parameter and one
    pair with |corr| > 0.87 (a 384-bin fine group)."""
    import numpy as np

    rng = np.random.RandomState(17)
    n = 20_000
    base = rng.standard_normal((n, 6))
    samples = base.copy()
    samples[:, 1] = 0.9 * base[:, 0] + np.sqrt(1 - 0.81) * base[:, 1]
    samples[:, 2] = 0.4 * base[:, 0] + base[:, 2]
    samples[:, 5] = np.abs(base[:, 5])
    kwargs = dict(samples=samples, weights=rng.randint(1, 5, n).astype(np.float64),
                  names=[f"q{i}" for i in range(6)], ranges={"q5": [0, None]})
    g1, g2 = MCSamples(device="cuda", **kwargs).fastParityDensities(device=True)
    c1, c2 = MCSamples(device="cpu", **kwargs).fastParityDensities(device=True)
    check(set(g2) == set(c2) and set(g1) == set(c1), "parity cross-device keys")
    d1 = max(float(np.abs(g1[key].P - c1[key].P).max()) for key in c1)
    d2 = max(float(np.abs(g2[key].P / g2[key].P.max() - c2[key].P / c2[key].P.max()).max()) for key in c2)
    dc = max(float(np.abs(np.asarray(g2[key].contours) - np.asarray(c2[key].contours)).max()) for key in c2)
    fines = sorted({d.P.shape[0] for d in c2.values()})
    check(d1 <= 1e-10, f"parity cross-device 1D P {d1}")
    check(d2 <= 1e-5 and dc <= 1e-5, f"parity cross-device 2D P {d2}, contours {dc}")
    check(len(fines) > 1, f"a stretched fine group ({fines})")
    return {"1D P": d1, "2D P / peak": d2, "2D contours": dc, "fine grids": fines}


def profile_slice(run):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def profile_device_busy(run):
    """(device busy ms, wall ms) of one call under torch.profiler: the sum
    of CUDA kernel, memcpy and memset times, printed with the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer")
    ]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    return busy_ms, wall_ms


def fused_path(samples, weights, batched, dft_conv, pair_hist, make_chain):
    """Phase 1: the fused triangle-densities path (PR 1's phases)."""
    import torch

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
    # the weights as the path passes them: integer weights narrowed to uint8
    w_path = pair_hist.narrow_weights(w_dev)
    check(w_path.dtype == torch.uint8, "the path's integer weights go to K1 as uint8")
    hists = pair_hist.pair_histograms(ix, w_path, pa, pb, integer_weights=True)
    ref_h = pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True)
    err_h = float((hists - ref_h).abs().max())
    check(err_h == 0.0, f"K1 bit-exact (max abs diff {err_h})")
    check(float(hists.double().sum()) == float(weights.sum()) * k, "K1 total mass")
    b_h, by_h = hist_bound(ix, w_path, k, 256)
    results = [
        {
            "name": "pair_histograms",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            "replaces": "getdist_tpu/ops/pallas_kernels.py:309",
            "launches": launches["pair_histograms"],
            "max_abs_err": err_h,
            "ms": cuda_ms(lambda: pair_hist.pair_histograms(ix, w_path, pa, pb, integer_weights=True), 10),
            "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True), 2),
            "bound_ms": b_h,
            "bound_by": by_h,
            "library_ms": library_hist_ms(ix, w_dev, pa, pb, 256, 3),
        }
    ]
    kernels = batched._gauss_kernel_2d(d2["rx"], d2["ry"], d2["corr"], 30)
    ur, ui = dft_conv.dft_conv_spectrum(kernels)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels)
    scale = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    err_s = max(float((ur - ur0).abs().max()), float((ui - ui0).abs().max()))
    # the production frame (384, m 61, 256 grids, offset 30): 1e-5, which one TF32 pass would miss
    check(err_s <= 1e-5 * scale, f"K2 within 1e-5 max|ref| ({err_s} vs {scale})")
    conv = dft_conv.dft_conv2d(hists, ur, ui, 256, 30)
    conv0 = dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, 30)
    err_c = float((conv - conv0).abs().max())
    check(err_c <= 1e-5 * float(conv0.abs().max()), f"K3 within 1e-5 max|ref| ({err_c} vs {float(conv0.abs().max())})")
    dft_checks(kernels, hists, ur, ui, conv, 256, 30, 384, "K2/K3 f32, fused path")
    b_s, by_s = spectrum_bound(kernels, 384)
    b_c, by_c = conv_bound(hists, 384, 256)
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
            "bound_ms": b_s,
            "bound_by": by_s,
            "library_ms": library_spectrum_ms(kernels, 384, 5),
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
            "bound_ms": b_c,
            "bound_by": by_c,
            "library_ms": library_conv_ms(hists, kernels, 256, 30, 3),
        },
    ]
    dft_report("K2 f32", results[1], spectrum_work(kernels, 384), TF32X3_FLOPS)
    dft_report("K3 f32", results[2], conv_work(hists, 384, 256), TF32X3_FLOPS)
    report = cross_device(make_chain, batched.triangle_densities)
    print(f"cross-device 100k x 8 (cuda vs cpu), max abs diffs: {json.dumps(report)}")
    return results


def parity_path(samples, weights, batched, dft_conv, pair_hist):
    """Phase 2: device parity mode at full size."""
    import numpy as np
    import torch

    from getdist_tpu_torch.mcsamples import MCSamples
    from getdist_tpu_torch.ops import parity_device as pdev

    p = samples.shape[1]
    k = p * (p - 1) // 2
    names = [f"p{i}" for i in range(p)]

    def fresh():
        t0 = time.perf_counter()
        mc = MCSamples(samples=samples, weights=weights, names=names, device="cuda")
        return mc, time.perf_counter() - t0

    mc, build_s = fresh()
    cold_s, _ = wall_s(lambda: mc.fastParityDensities(device=True))
    counters = (pair_hist.pair_histograms, pair_hist.pair_histograms_dynamic, dft_conv.dft_conv_spectrum,
                dft_conv.dft_conv2d)
    warm = []
    for rep in range(2):
        mc, _ = fresh()
        if rep == 0:
            for fn in counters:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
        seconds, (dens1, dens2) = wall_s(lambda: mc.fastParityDensities(device=True))
        if rep == 0:
            launches = {fn.__name__: fn.launches for fn in counters}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        warm.append(seconds)
    print(f"launches in one parity run: {launches}")
    check(all(v >= 1 for v in launches.values()), "parity run launched K1, K4, K2 and K3")
    check_parity_outputs(dens1, dens2, p, k)
    profile = ", ".join(f"{key} {sec:.3f}" for key, sec in mc.parity_profile.items())
    print(
        f"parity 30 x 1M: MCSamples built in {build_s:.2f} s; fastParityDensities first call {cold_s:.2f} s, "
        f"warm {warm[0]:.2f} s and {warm[1]:.2f} s; peak device memory {peak_gb:.2f} GB"
    )
    print(f"parity stages (s, last warm run): {profile}")
    print(f"parity buckets: {json.dumps(mc.parity_buckets)}")
    mc, _ = fresh()
    busy_ms, wall_ms = profile_device_busy(lambda: mc.fastParityDensities(device=True))
    print(f"parity device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall under the profiler "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")

    # bin indices of all columns at 1M, against numpy's formula
    idx = list(range(p))
    infos = [mc._initParamRanges(j) for j in idx]
    binmin = np.array([min(i.param_min, i.range_min) - (0 if i.has_limits_bot else (i.range_max - i.range_min) * 0.1)
                       for i in infos])
    binmax = np.array([max(i.param_max, i.range_max) + (0 if i.has_limits_top else (i.range_max - i.range_min) * 0.1)
                       for i in infos])
    fw = (binmax - binmin) / 255
    st = mc._parity_chain()
    got = pdev.bin_indices(st["samples"], binmin, fw).cpu().numpy()
    want = ((samples - binmin) / fw + 0.5).astype(np.int64).T
    flips = int(np.count_nonzero(got != want))
    check(flips == 0, f"bin indices bit-exact against numpy ({flips} of {want.size} differ)")
    print(f"bin indices 30 x 1M on the card: 0 of {want.size} differ from numpy's formula")

    # K4 on this run's sheared stack
    _, sheared_jobs = mc._parity_pairs(idx, infos)
    stack = mc._sheared_stack(idx, infos, sheared_jobs, st["samples"])
    ix = stack["ix"].to(torch.uint8).contiguous()
    sa = torch.tensor(stack["pair_a"], dtype=torch.int32, device="cuda")
    sb = torch.tensor(stack["pair_b"], dtype=torch.int32, device="cuda")
    check(not pdev.static_route(ix.shape[0], len(sheared_jobs)), "the sheared stack takes K4's route")
    w32 = st["weights32"]
    h4 = pair_hist.pair_histograms_dynamic(ix, w32, sa, sb, integer_weights=True)
    ref4 = pair_hist.pair_histograms_plain(ix, w32, sa, sb, integer_weights=True)
    err4 = float((h4 - ref4).abs().max())
    check(err4 == 0.0, f"K4 bit-exact (max abs diff {err4})")
    b4, by4 = hist_bound(ix, w32, len(sheared_jobs), 256)
    results = [
        {
            "name": "pair_histograms_dynamic",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            "replaces": "getdist_tpu/ops/pallas_kernels.py:65",
            "launches": launches["pair_histograms_dynamic"],
            "max_abs_err": err4,
            "ms": cuda_ms(lambda: pair_hist.pair_histograms_dynamic(ix, w32, sa, sb, integer_weights=True), 10),
            "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w32, sa, sb, integer_weights=True), 2),
            "bound_ms": b4,
            "bound_by": by4,
            "library_ms": library_hist_ms(ix, w32, sa, sb, 256, 3),
        }
    ]
    print(f"sheared stack: {ix.shape[0]} index rows, {len(sheared_jobs)} pairs")

    # f64 K2/K3 on the run's largest bucket (at fine 256): K1 histograms of
    # the bucket's pair count, kernels at the bucket's window
    bucket = max((b for b in mc.parity_buckets if b["fine"] == 256), key=lambda b: b["pairs"])
    kb, winw = bucket["pairs"], bucket["winw"]
    pad = dft_conv.frame_for(256 + 4 * winw + 1)
    ix256 = np.ascontiguousarray(got, dtype=np.uint8)
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)][:kb], np.int32)
    hists = pair_hist.pair_histograms(
        torch.from_numpy(ix256).cuda(), w32, torch.from_numpy(pairs[:, 0].copy()).cuda(),
        torch.from_numpy(pairs[:, 1].copy()).cuda(), integer_weights=True,
    ).double()
    widths = torch.linspace(0.8, winw / 2.5, kb, dtype=torch.float64, device="cuda")
    kernels = batched._gauss_kernel_2d(widths, widths.flip(0), torch.full_like(widths, 0.3), winw)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    scale = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    err_s = max(float((ur - ur0).abs().max()), float((ui - ui0).abs().max()))
    check(err_s <= 1e-12 * scale, f"K2 f64 within 1e-12 max|ref| ({err_s} vs {scale})")
    conv = dft_conv.dft_conv2d(hists, ur, ui, 256, winw, pad)
    conv0 = dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, winw, pad)
    err_c = float((conv - conv0).abs().max())
    check(err_c <= 1e-12 * float(conv0.abs().max()), f"K3 f64 within 1e-12 max|ref| ({err_c})")
    print(f"f64 K2/K3 on the largest bucket: {kb} pairs, winw {winw}, frame {pad}")
    dft_checks(kernels, hists, ur, ui, conv, 256, winw, pad, "K2/K3 f64, parity bucket")
    b_s, by_s = spectrum_bound(kernels, pad)
    b_c, by_c = conv_bound(hists, pad, 256)
    results += [
        {
            "name": "dft_conv_spectrum_f64",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:155",
            "launches": launches["dft_conv_spectrum"],
            "max_abs_err": err_s,
            "ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad), 3),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum_plain(kernels, pad), 3),
            "bound_ms": b_s,
            "bound_by": by_s,
            "library_ms": library_spectrum_ms(kernels, pad, 3),
        },
        {
            "name": "dft_conv2d_f64",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:190",
            "launches": launches["dft_conv2d"],
            "max_abs_err": err_c,
            "ms": cuda_ms(lambda: dft_conv.dft_conv2d(hists, ur, ui, 256, winw, pad), 3),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, winw, pad), 3),
            "bound_ms": b_c,
            "bound_by": by_c,
            "library_ms": library_conv_ms(hists, kernels, 256, winw, 1),
        },
    ]
    dft_report("K2 f64", results[1], spectrum_work(kernels, pad), FP64_FLOPS)
    dft_report("K3 f64", results[2], conv_work(hists, pad, 256), FP64_FLOPS)
    report = parity_cross_device(MCSamples)
    print(f"parity cross-device 20k x 6 (cuda vs cpu), max abs diffs: {json.dumps(report)}")
    return results


SHARDED_TOL = {"neff": ("rtol", 1e-3), "1D P": ("atol", 1e-5), "2D P": ("atol", 3e-5), "contours": ("rtol", 1e-3)}


def sharded_diffs(got, want, label):
    """Max differences of (d1, d2) against (d1, d2) at the tolerances of
    tests/test_parallel.py (SHARDED_TOL); fails past them."""
    import numpy as np

    (g1, g2), (w1, w2) = got, want
    pairs = {"neff": (g1["neff"], w1["neff"]), "1D P": (g1["P"], w1["P"]), "2D P": (g2["P"], w2["P"]),
             "contours": (g2["contours"], w2["contours"])}
    report = {}
    for name, (g, w) in pairs.items():
        g, w = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64) for x in (g, w))
        kind, tol = SHARDED_TOL[name]
        err = np.abs(g - w)
        report[name] = float(err.max())
        limit = tol * np.abs(w) if kind == "rtol" else tol
        check(bool(np.all(err <= limit)), f"{label} {name}: max abs diff {err.max()} ({kind} {tol})")
    return report


def cross_rank_worker(group, samples, weights):
    """One gloo rank of the cross-check: its block through the sharded path
    on the CPU."""
    from getdist_tpu_torch.parallel import shard_samples, sharded_triangle_densities

    d1, d2 = sharded_triangle_densities(group, *shard_samples(group, samples, weights, device="cpu"),
                                        n_samples=len(samples))
    return {k: d1[k].numpy() for k in ("neff", "P")}, {k: d2[k].numpy() for k in ("P", "contours")}


def sharded_path(samples, weights, batched, dft_conv, pair_hist, make_chain):
    """Phase 3: the sharded path, one NCCL rank on the card."""
    import torch.distributed as dist

    from getdist_tpu_torch.ops._cuda import BUILD_DIR
    from getdist_tpu_torch.parallel import init_group

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = BUILD_DIR / f"nccl_store_{os.getpid()}"
    store.unlink(missing_ok=True)
    group = init_group("nccl", rank=0, world_size=1, init_method=f"file://{store}")
    try:
        return sharded_runs(group, samples, weights, batched, dft_conv, pair_hist, make_chain)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def sharded_runs(group, samples, weights, batched, dft_conv, pair_hist, make_chain):
    import numpy as np
    import torch

    from getdist_tpu_torch.parallel import shard_samples, sharded_pair_hists, sharded_triangle_densities, spawn_ranks

    p = samples.shape[1]
    k = p * (p - 1) // 2
    local = shard_samples(group, samples, weights, device="cuda")

    def run():
        return sharded_triangle_densities(group, *local, n_samples=len(samples))

    def run_fused():
        return batched.triangle_densities(*local, int8_weights=False, enable_shear=True)

    cold_s, _ = wall_s(run)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    for fn in counters:
        fn.launches = 0
    _, (d1, d2) = wall_s(run)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in one sharded run: {launches}")
    check(launches == {"pair_histograms": 1, "dft_conv_spectrum": 1, "dft_conv2d": 2}, "sharded launch counts")
    check_outputs(d1, d2, p, k)
    # warm walls in turns (S, T, T, S, S, T), then each peak with no other run's output alive
    fns = {"sharded": run, "triangle_densities": run_fused}
    walls = {name: [] for name in fns}
    for name in ("sharded", "triangle_densities", "triangle_densities", "sharded", "sharded", "triangle_densities"):
        walls[name].append(wall_s(fns[name])[0])
    peaks = {}
    for name, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        _, out = wall_s(fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        if name == "triangle_densities":
            fused = out
        del out
    warm = {name: min(ws) for name, ws in walls.items()}
    print(
        f"sharded 30 x 1M (one-rank NCCL group): first call {cold_s * 1e3:.1f} ms, warm {warm['sharded'] * 1e3:.1f}"
        f" ms (min of 3), peak device memory {peaks['sharded']:.2f} GB; triangle_densities on the same device "
        f"tensors: warm {warm['triangle_densities'] * 1e3:.1f} ms, peak {peaks['triangle_densities']:.2f} GB; "
        f"walls in turns (ms): {json.dumps({k: [round(x * 1e3, 1) for x in v] for k, v in walls.items()})}"
    )
    report = sharded_diffs((d1, d2), fused, "sharded vs triangle_densities")
    print(f"sharded vs triangle_densities on the card, max abs diffs: {json.dumps(report)}")

    # K5 through sharded_pair_hists over all pairs, both weight modes; K4 without a pair plan
    s_dev, w_dev = local
    binmin, binmax = d1["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    counters = (pair_hist.pair_histograms_grouped, pair_hist.pair_histograms_dynamic)
    for fn in counters:
        fn.launches = 0
    grouped = {mode: sharded_pair_hists(group, ix, w_dev, pa, pb, static_pairs=pairs, int8_weights=mode)
               for mode in (True, False)}
    dynamic = sharded_pair_hists(group, ix, w_dev, pa, pb)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in the sharded pair-histogram calls: {launches}")
    check(launches == {"pair_histograms_grouped": 2, "pair_histograms_dynamic": 1}, "K5/K4 launch counts")
    plan = [torch.from_numpy(x).cuda() for x in pair_hist.group_pairs(pairs)]
    err5 = 0.0
    for mode, hists in grouped.items():
        ref = pair_hist.pair_histograms_grouped_plain(ix, w_dev, *plan, int8_weights=mode)
        k1 = pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=mode)
        err5 = max(err5, float((hists - ref).abs().max()))
        check(torch.equal(hists, ref) and torch.equal(hists, k1), f"K5 (int8_weights={mode}) bit-exact vs plain and K1")
    check(float(grouped[True].double().sum()) == float(weights.sum()) * k, "K5 total mass")
    check(torch.equal(dynamic, grouped[True]), "K4 route of sharded_pair_hists equals K5's")
    # the weights as sharded_pair_hists passes them: uint8 for integer weights
    w_in = {True: pair_hist.narrow_weights(w_dev), False: w_dev}
    t5 = {mode: cuda_ms(lambda m=mode: pair_hist.pair_histograms_grouped(ix, w_in[m], *plan, int8_weights=m), 10)
          for mode in (True, False)}
    t1 = cuda_ms(lambda: pair_hist.pair_histograms(ix, w_in[True], pa, pb, integer_weights=True), 10)
    print(f"K5 on 30 x 1M, 435 pairs in {plan[0].shape[0]} groups of {plan[0].shape[1]}: int32 {t5[True]:.3f} ms, "
          f"f32 {t5[False]:.3f} ms; K1 on the same rows, int32 {t1:.3f} ms (K5 / K1 {t5[True] / t1:.3f})")
    b5, by5 = hist_bound(ix, w_in[True], k, 256)
    result = {
        "name": "pair_histograms_grouped",
        "route": "cuda",
        "source": "getdist_tpu_torch/csrc/pair_hist.cu",
        "replaces": "getdist_tpu/ops/pallas_kernels.py:170",
        "launches": launches["pair_histograms_grouped"],
        "max_abs_err": err5,
        "ms": t5[True],
        "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_grouped_plain(ix, w_dev, *plan, int8_weights=True), 2),
        "bound_ms": b5,
        "bound_by": by5,
        "library_ms": library_hist_ms(ix, w_dev, pa, pb, 256, 3),
    }

    # 4 gloo ranks on the CPU against the one-rank run on the card
    base, cw = make_chain(40_000, 6, seed=19)
    cs = base.copy()
    cs[:, 1] = 0.8 * base[:, 0] + 0.6 * base[:, 1]
    corr = np.corrcoef(cs.T)[0, 1]
    check(abs(corr) > 0.5, f"cross-rank chain has a correlated pair ({corr})")
    t0 = time.perf_counter()
    ranks = spawn_ranks(cross_rank_worker, 4, "gloo", args=(cs, cw), timeout_s=600)
    spawn_s = time.perf_counter() - t0
    for rank, got in enumerate(ranks[1:], start=1):
        for mine, first in zip(got, ranks[0]):
            check(all(np.array_equal(mine[key], first[key]) for key in first), f"rank {rank} bitwise equal to rank 0")
    card = sharded_triangle_densities(group, *shard_samples(group, cs, cw, device="cuda"), n_samples=len(cs))
    report = sharded_diffs(ranks[0], card, "4 gloo ranks vs one NCCL rank")
    print(f"cross-rank 40k x 6 (|corr| {abs(corr):.2f}): 4 gloo ranks on the CPU ({spawn_s:.1f} s, bitwise equal "
          f"across ranks) vs one NCCL rank on the card, max abs diffs: {json.dumps(report)}")
    return [result]


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
    usage = [line.strip() for line in lib.log.splitlines() if "registers" in line or "spill" in line]
    print("ptxas: " + " | ".join(usage))
    for line in ptxas_lines(lib.log, "pair_hist_uint8_kernel"):
        print(f"ptxas, K1/K5 uint8 kernel: {line}")

    t0 = time.perf_counter()
    samples, weights = make_chain(1_000_000, 30)
    print(f"chain 1,000,000 x 30 made in {time.perf_counter() - t0:.1f} s")

    results = fused_path(samples, weights, batched, dft_conv, pair_hist, make_chain)
    results += parity_path(samples, weights, batched, dft_conv, pair_hist)
    results += sharded_path(samples, weights, batched, dft_conv, pair_hist, make_chain)
    for r in results:
        # a bound is a least time: no measured way of computing the function may beat it
        measured = [t for t in (r["ms"], r["plain_ms"], r["library_ms"]) if t is not None]
        check(r["bound_ms"] <= min(measured), f"{r['name']}: bound {r['bound_ms']} ms above a measured {min(measured)} ms")
        print(
            f"{r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), library {r['library_ms']}, max abs err {r['max_abs_err']:.3g}, "
            f"launches {r['launches']}"
        )

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
