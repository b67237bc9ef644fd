#!/usr/bin/env python
"""Time the port's pair-histogram kernels K1, K4 and K5, and the wide
kernels past 256 bins, on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_pair_hist_torch.py          # all of it
    python3 scripts/time_pair_hist_torch.py --wide   # the wide kernels only

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
route's global-atomic flush). Then the uint8 kernel alone
(launches on prepared buffers, without the wrapper's checks) on both
stacks, the device time per K4 call under torch.profiler by kernel, and
the ``torch.bincount`` yardstick of ``chip_smoke.py`` beside each stack's
bound. Prints the pair-histogram kernels' ptxas lines of a fresh build.

The wide kernels (int16 rows past 256 bins) on the shapes their paths
give them: the three fine groups of ``chip_smoke.degenerate_chain(1M)``'s
blocks and ``chip_smoke.hard_chain(1M)``'s 0.99 pair, binned over each
column's range widened by a tenth on both sides (parity's convention), with
uint8 integer weights as the paths pass them. Each is checked bit-exact
against the plain version and timed (CUDA events, mean of 10 calls, two
turns of opposite order) by the route rule, by each design alone (the
direct and bucket routes of ``pair_hist.wide_plan``) and with f32 weights,
beside ``torch.bincount`` and the bound; then each design's device time per
call by kernel under torch.profiler, also for the bucket route with the most
rows a slab's tile holds and with half and twice the rule's entries per bin
block, and the host time per call of the rule's route. Copied with ``chip_smoke.py`` into an
older tree whose ``pair_hist`` has no ``wide_plan``, ``--wide`` times that
tree's kernel for int16 rows (f32 weights) on the same rows instead, so that
two trees compare in one call. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bench import make_chain  # noqa: E402
from chip_smoke import (  # noqa: E402
    DEGENERATE_BLOCKS, cuda_ms, degenerate_chain, hard_chain, hist_bound, library_hist_ms, ptxas_lines,
)
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
        pair_hist.split_plan = lambda k, n, sms, parts=2: n_split
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
            pa.data_ptr(), pb.data_ptr(), 0, 0, ix.shape[1], pa.shape[0], 256, 1, 1, 0, 0, 0, 0, out.data_ptr(),
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


def wide_shapes():
    """{name: (int16 rows (P, N), nbins, f32 weights)} of the wide kernels' shapes,
    the rows at each group's fine grid (see the module's docstring)."""
    import numpy as np

    samples, weights = degenerate_chain(1_000_000)
    hard, hard_w = hard_chain(1_000_000)
    shapes, start = {}, 0
    for (size, _), (label, fine) in zip(DEGENERATE_BLOCKS, (("A", 960), ("B", 576), ("C", 384))):
        shapes[f"{label}: degenerate block, {fine} bins x {size * (size - 1) // 2} pairs"] = (
            samples[:, start : start + size], fine, weights)
        start += size
    shapes["hard chain's 0.99 pair, 960 bins x 1 pair"] = (hard[:, 4:6], 960, hard_w)
    rows = {}
    for name, (cols, fine, w) in shapes.items():
        lo, hi = cols.min(0), cols.max(0)
        lo, hi = lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo)
        ix = ((cols - lo) / ((hi - lo) / (fine - 1)) + 0.5).astype(np.int16).T.copy()
        rows[name] = (torch.from_numpy(ix).cuda(), fine, torch.from_numpy(w.astype(np.float32)).cuda())
    return rows


def device_by_kernel(fn, reps=10):
    """{kernel: mean device us per call} under torch.profiler, with the total."""
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
            name = e.name.split("pair_hist_wide_")[-1].split("(")[0].split("<")[0][:40]
            per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / reps
    per = {k: round(v, 1) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}
    per["total"] = round(sum(per.values()), 1)
    return per


def time_wide(card):
    """The wide kernels (or an older tree's kernel for int16 rows) on
    :func:`wide_shapes`; True when every route is bit-exact."""
    older = not hasattr(pair_hist, "wide_plan")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for name, (ix, fine, w) in wide_shapes().items():
        p = ix.shape[0]
        pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
        pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
        pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
        k, n = len(pairs), ix.shape[1]
        w8 = pair_hist.narrow_weights(w)
        ref = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True, nbins=fine)

        def entry(weights, **forced):
            def run():
                if not forced:
                    return pair_hist.pair_histograms(ix, weights, pa, pb, integer_weights=True, nbins=fine)
                plan = pair_hist.wide_plan
                pair_hist.wide_plan = lambda *args: plan(*args)._replace(**forced)
                try:
                    return pair_hist.pair_histograms(ix, weights, pa, pb, integer_weights=True, nbins=fine)
                finally:
                    pair_hist.wide_plan = plan

            return run

        if older:
            runs = {"older tree's kernel, f32 weights": entry(w)}
        else:
            runs = {
                "rule, uint8 weights": entry(w8),
                "direct alone, uint8 weights": entry(w8, route="direct"),
                "bucket alone, uint8 weights": entry(w8, route="bucket"),
                "rule, f32 weights": entry(w),
            }
        checks = {key: torch.equal(fn(), ref) for key, fn in runs.items()}
        ok = ok and all(checks.values())
        times = in_turns(runs)
        times["library bincount"] = [round(library_hist_ms(ix, w, pa, pb, fine, 10), 4)]
        times["plain"] = [round(cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w, pa, pb, True, fine), 2), 4)]
        bound, by = hist_bound(ix, w8, k, fine)
        route = "" if older else f", rule's plan {pair_hist.wide_plan(k, n, fine, sms)}"
        print(f"{card}: wide, {name} (int16 rows x {n}{route}); bit-exact {json.dumps(checks)}; ms per call: "
              f"{json.dumps({key: [round(x, 4) for x in v] for key, v in times.items()})}; bound {bound:.4f} ms ({by}, "
              "uint8 weights)")
        designs = {key: fn for key, fn in runs.items() if "alone" in key or older}
        if not older:
            # the bucket route beside the rule's choices of rows and part: the most rows a
            # slab's tile holds, and half and twice the entries a bin block takes
            plan = pair_hist.wide_plan(k, n, fine, sms)
            rows = min(fine, pair_hist.TILE_WORDS // fine)
            slabs = -(-fine // rows)
            designs[f"bucket, {rows} rows a slab"] = entry(
                w8, route="bucket", rows=rows, slabs=slabs, split_slots=min(k * slabs, k * n // plan.part))
            for scale in (0.5, 2):
                part = int(plan.part * scale)
                designs[f"bucket, part {part}"] = entry(
                    w8, route="bucket", part=part, split_slots=min(k * plan.slabs, k * n // part))
        for key, fn in designs.items():
            ok = ok and torch.equal(fn(), ref)
            print(f"  device us per call by kernel, {key}: {json.dumps(device_by_kernel(fn))}")
        fn = runs["older tree's kernel, f32 weights" if older else "rule, uint8 weights"]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        print(f"  host us per call (100 calls, each reading its pair indices back): "
              f"{(time.perf_counter() - t0) * 1e4:.1f}")
    return ok


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
    if "--wide" in sys.argv[1:]:
        return 0 if time_wide(card) else 1

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
    wide_ok = time_wide(card)
    return 0 if all(checks.values()) and wide_ok else 1


if __name__ == "__main__":
    sys.exit(main())
