#!/usr/bin/env python
"""Time the port's pair-histogram kernels K1, K4 and K5 on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_pair_hist_torch.py

Two stacks of uint8 index rows from ``bench.make_chain(1_000_000, 30)``:

* K1's and K5's: the fused path's fine indices at 256 bins over the 1D
  stage's ranges, 30 rows (30 MB, inside the 50 MB L2), all 435 pairs;
* K4's: parity mode's sheared stack (lead rows and one Cholesky-residual
  row per sheared pair, as ``MCSamples.fastParityDensities(device=True)``
  builds it): 139 rows (139 MB, beyond L2), 112 pairs whose a rows repeat.

Checks every timed route bit-exact against the plain version (integer
weights as uint8, as the paths pass them, and as f32), then prints CUDA-event
times (mean of 10 calls after a warm-up, taken in two turns of opposite
order) of the wrappers: K1 and K5 in each weight mode; K4 in each weight
mode, at N = 1,000,003 (columns off 16-byte boundaries), with its pairs
shuffled, and with its samples split over 2 and 4 chunks a pair (the split
route's global-atomic flush); the slab kernel on K4's pairs (K4's kernel
before it moved to the uint8 kernel). Then the uint8 kernel alone
(launches on prepared buffers, without the wrapper's checks) on both
stacks, the device time per K4 call under torch.profiler by kernel, and
the ``torch.bincount`` yardstick of ``chip_smoke.py`` beside each stack's
bound. Prints the pair-histogram kernels' ptxas lines of a fresh build.
Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bench import make_chain  # noqa: E402
from chip_smoke import cuda_ms, hist_bound, library_hist_ms, ptxas_lines  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from getdist_tpu_torch.ops import _cuda, batched, pair_hist  # noqa: E402


def sheared_stack(samples, weights):
    """Parity's sheared stack of the chain: (ix (R, N) uint8, pair_a, pair_b)."""
    p = samples.shape[1]
    mc = MCSamples(samples=samples, weights=weights, names=[f"p{i}" for i in range(p)], device="cuda")
    idx = list(range(p))
    infos = [mc._initParamRanges(j) for j in idx]
    _, jobs = mc._parity_pairs(idx, infos)
    stack = mc._sheared_stack(idx, infos, jobs, mc._parity_chain()["samples"])
    ix = pair_hist.narrow_rows(stack["ix"], 256)
    pa, pb = (torch.tensor(stack[key], dtype=torch.int32, device="cuda") for key in ("pair_a", "pair_b"))
    return ix, pa, pb


def forced_split(n_split, fn):
    """``fn`` with ``pair_hist.split_plan`` fixed at ``n_split`` chunks a pair."""

    def run():
        saved = pair_hist.split_plan
        pair_hist.split_plan = lambda k, n, sms: n_split
        try:
            return fn()
        finally:
            pair_hist.split_plan = saved

    return run


def kernel_alone(ix, w, pa, pb):
    """Launches of the uint8 kernel on prepared buffers (one chunk a pair,
    integer weights, pairs already checked): the kernel without its
    wrapper."""
    out = torch.empty((pa.shape[0], 256, 256), dtype=torch.float32, device="cuda")

    def run():
        _cuda.call(
            "pair_hist_uint8_launch", ix.device, ix.data_ptr(), ix.shape[0], w.data_ptr(), w.element_size(),
            pa.data_ptr(), pb.data_ptr(), 0, 0, ix.shape[1], pa.shape[0], 256, 1, 1, out.data_ptr(),
        )
        return out

    return run


def device_breakdown(fn, reps=10):
    """{kernel name: mean device us per call} of ``reps`` calls of ``fn`` under
    torch.profiler, with the total device time per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name[:100]] = per.get(e.name[:100], 0.0) + e.time_range.elapsed_us() / reps
    per = {k: round(v, 2) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}
    per["total device us per call"] = round(sum(per.values()), 2)
    return per


def in_turns(runs):
    """{name: [ms, ms]}: each run timed twice, in two turns of opposite order."""
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(cuda_ms(runs[name], 10))
    return times


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(smi, capture_output=True, text=True).stdout.strip()
    print(card)
    lib = _cuda.library()
    print(f"build {lib.build_seconds:.1f} s")
    for line in ptxas_lines(lib.log, "pair_hist"):
        print(f"ptxas: {line}")

    samples, weights = make_chain(1_000_000, 30)
    s_dev, w_dev = batched.prepare_chain(samples, weights, "cuda")
    w8 = pair_hist.narrow_weights(w_dev)
    w_frac = w_dev * 0.37
    checks = {}

    # K1 / K5: the fused path's rows
    binmin, binmax = batched.all_1d_densities(s_dev, w_dev)["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    p = ix.shape[0]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    plan = [torch.from_numpy(x).cuda() for x in pair_hist.group_pairs(pairs)]
    k1_ref = pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True)
    for name, w, mode in (("uint8", w8, True), ("f32 integer", w_dev, True), ("f32", w_dev, False)):
        checks[f"K1 {name} weights"] = torch.equal(pair_hist.pair_histograms(ix, w, pa, pb, mode), k1_ref)
        checks[f"K5 {name} weights"] = torch.equal(
            pair_hist.pair_histograms_grouped(ix, w, *plan, int8_weights=mode), k1_ref
        )
    k1_runs = {
        "K1 uint8 weights": lambda: pair_hist.pair_histograms(ix, w8, pa, pb, integer_weights=True),
        "K1 f32 integer weights": lambda: pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=True),
        "K1 f32 fractional weights": lambda: pair_hist.pair_histograms(ix, w_frac, pa, pb, integer_weights=False),
        "K5 uint8 weights": lambda: pair_hist.pair_histograms_grouped(ix, w8, *plan, int8_weights=True),
        "K5 f32 weights": lambda: pair_hist.pair_histograms_grouped(ix, w_dev, *plan, int8_weights=False),
    }

    # K4: parity's sheared stack
    sx, sa, sb = sheared_stack(samples, weights)
    print(f"sheared stack: {tuple(sx.shape)} {sx.dtype}, {sa.shape[0]} pairs over {len(set(sa.tolist()))} a rows")
    sx_odd = torch.cat([sx, sx[:, :3]], dim=1).contiguous()  # columns off 16-byte boundaries
    w_odd = torch.cat([w8, w8[:3]]).contiguous()
    shuffle = torch.randperm(sa.shape[0], generator=torch.Generator().manual_seed(5)).cuda()
    sa_mixed, sb_mixed = sa[shuffle].contiguous(), sb[shuffle].contiguous()
    ref4 = pair_hist.pair_histograms_plain(sx, w_dev, sa, sb, integer_weights=True)
    k4 = {
        "K4 uint8 weights": lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, integer_weights=True),
        "K4 f32 integer weights": lambda: pair_hist.pair_histograms_dynamic(sx, w_dev, sa, sb, integer_weights=True),
        "K4 split 2, uint8 weights": forced_split(2, lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, True)),
        "K4 split 4, uint8 weights": forced_split(4, lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, True)),
        "K4 uint8 kernel alone": kernel_alone(sx, w8, sa, sb),
        "slab kernel, K4's pairs, f32 integer weights": lambda: pair_hist._launch_slab(sx, w_dev, sa, sb, True, 256),
    }
    for name, fn in k4.items():
        checks[name] = torch.equal(fn(), ref4)
    checks["K4 pairs shuffled"] = torch.equal(
        pair_hist.pair_histograms_dynamic(sx, w8, sa_mixed, sb_mixed, True), ref4[shuffle]
    )
    checks["K4 N=1000003"] = torch.equal(
        pair_hist.pair_histograms_dynamic(sx_odd, w_odd, sa, sb, True),
        pair_hist.pair_histograms_plain(sx_odd, w_odd, sa, sb, integer_weights=True),
    )
    checks["K1 uint8 kernel alone"] = torch.equal(kernel_alone(ix, w8, pa, pb)(), k1_ref)
    got = pair_hist.pair_histograms_dynamic(sx, w_frac, sa, sb)
    want = pair_hist.pair_histograms_plain(sx, w_frac, sa, sb)
    frac_err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    del ref4, got, want, k1_ref
    print(f"bit-exact against the plain version: {json.dumps(checks)}; K4 fractional weights: max error "
          f"{frac_err:.3g} of max(1, |plain|)")
    breakdown = device_breakdown(lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, True))
    print(f"K4 (uint8 weights) device time per call under torch.profiler (us): {json.dumps(breakdown)}")

    k4_runs = {
        **k4,
        "K4 fractional weights": lambda: pair_hist.pair_histograms_dynamic(sx, w_frac, sa, sb),
        "K4 uint8 weights, pairs shuffled":
            lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa_mixed, sb_mixed, True),
        "K4 uint8 weights, N=1000003": lambda: pair_hist.pair_histograms_dynamic(sx_odd, w_odd, sa, sb, True),
        "K1 uint8 kernel alone": kernel_alone(ix, w8, pa, pb),
    }
    times = in_turns({**k1_runs, **k4_runs})
    times["library bincount, K1's stack"] = [library_hist_ms(ix, w_dev, pa, pb, 256, 3)]
    times["library bincount, K4's stack"] = [library_hist_ms(sx, w_dev, sa, sb, 256, 3)]
    bound1, by1 = hist_bound(ix, w8, len(pairs), 256)
    bound4, by4 = hist_bound(sx, w8, sa.shape[0], 256)
    print(f"{card}: ms per call, two turns each: {json.dumps(times)}")
    print(f"bounds: K1's stack {bound1:.4f} ms ({by1}), K4's stack {bound4:.4f} ms ({by4}), uint8 weights")
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
