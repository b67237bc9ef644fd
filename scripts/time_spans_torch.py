#!/usr/bin/env python
"""Host time inside the port's stages, from the span recorder
(``getdist_tpu_torch.tracing``), on a benchmark cell's pool of chains.

Run from the root of a tree on a machine with a CUDA card:

    python3 scripts/time_spans_torch.py --workload bench_30x1M.triangle --seed 7

Builds the cell's chains and objects as ``perfbench/run.py`` does (its
cell, chains and analysis), the ``MCSamples`` builds under the recorder,
and warms each object with one analysis. Then 16 turns of one analysis
with the recorder off and one with it on (off first in even turns), each
analysis ended by a synchronize as the benchmark's are: the recorder's
on-cost, and from the recorded analyses the host
milliseconds of each span per analysis (a stage's spans summed over a
call, then averaged over the calls). Last, 2 analyses under
``torch.profiler`` (CPU and CUDA activity): the launches of the 2D
bandwidth optimizer, the host runtime calls that issue a device operation
(``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaMemcpyAsync``,
``cudaMemsetAsync``) made inside a ``2d:bandwidths`` range and joined to
their device operation by correlation id, by the innermost range open at
the call, with the device-to-host copies among them; and beside it
perfbench's ``bandwidth_launches`` reading of the same trace, which this
join checks.

Prints its lines and last one JSON line. A rehearsal on the CPU:
``--device cpu --samples 20000 --params 4`` (the cell's chains cut to
that many samples and its first that many parameters; no launches are
counted there). Imports nothing of JAX.

Once ``perfbench`` records the spans and the launch calls in its traced
runs, it reads all of this itself, and this script can go.
"""

import argparse
import copy
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from getdist_tpu_torch import tracing  # noqa: E402
from perfbench import harness  # noqa: E402
from perfbench import trace as perfbench_trace  # noqa: E402
from perfbench.chains import chain_seed, make_chain  # noqa: E402

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
STAGES = ("fast:", "1d:", "2d:")
TURNS = 16
PROFILED = 2


def cut(cell, samples, params):
    """``cell`` with its chains cut to ``samples`` x its first ``params`` parameters."""
    cell.config = copy.deepcopy(cell.config)
    chain = cell.config["chain"]
    chain["samples"] = samples
    if chain.get("columns"):
        chain["columns"] = chain["columns"][:params]
    else:
        chain["params"] = params
    return cell


def per_call_ms(spans):
    """{name: mean over calls of the span's summed milliseconds in a call}."""
    calls = sorted({s.call for s in spans if s.parent is None and s.name == "fast:triangle"})
    out = {}
    for name in sorted({s.name for s in spans}):
        sums = [sum(s.t1_ns - s.t0_ns for s in spans if s.call == c and s.name == name) / 1e6 for c in calls]
        out[name] = statistics.fmean(sums) if sums else 0.0
    return out


def launches(prof):
    """{innermost range: [launches, device-to-host copies]} of the launches
    made inside a ``2d:bandwidths`` range, the range count, and the names
    of the device-side annotations that perfbench leaves out of the
    device's busy time."""
    device, host, ranges, annotations = {}, [], [], set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(("Activity Buffer",) + STAGES + (perfbench_trace.ANALYSIS_RANGE,)):
                annotations.add(name)
            else:
                device[e.correlation_id()] = name
        elif name.startswith(LAUNCH_CALLS):
            host.append((e.start_ns(), e.correlation_id()))
        elif name.startswith(STAGES):
            ranges.append((name, e.start_ns(), e.end_ns()))
    outer = [(s, e) for name, s, e in ranges if name == "2d:bandwidths"]
    split = {}
    for t, corr in host:
        if corr not in device or not any(s <= t < e for s, e in outer):
            continue
        name = max((s, name) for name, s, e in ranges if s <= t < e)[1]
        row = split.setdefault(name, [0, 0])
        row[0] += 1
        row[1] += device[corr].startswith("Memcpy DtoH")
    return split, len(outer), sorted(annotations)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--samples", type=int, default=None)
    parser.add_argument("--params", type=int, default=None)
    args = parser.parse_args(argv)

    cell = harness.Cell(args.workload)
    if args.samples:
        cell = cut(cell, args.samples, args.params or 4)
    device = torch.device(args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    pool = int(cell.traffic["pool"])
    chains = [make_chain(cell.config, chain_seed(args.seed, i), device) for i in range(pool)]
    analysis = cell.analysis.Analysis(cell.config, cell.traffic, chains, device, args.seed)
    with tracing.recording() as built:
        analysis.setup()
    sync()
    inits = [s for s in built if s.name == "mc:init"]
    constructor = {name: statistics.fmean((s.t1_ns - s.t0_ns) / 1e6 for s in built if s.name == name)
                   for name in sorted({s.name for s in built if s.name.startswith("mc:")})}
    print(f"{args.workload}: {len(inits)} MCSamples builds, ms each (mean): "
          + ", ".join(f"{k} {v:.3f}" for k, v in constructor.items()), flush=True)

    walls = {"off": [], "on": []}
    recorded = []
    i = 0
    for turn in range(TURNS):
        for mode in (("off", "on") if turn % 2 == 0 else ("on", "off")):
            if mode == "on":
                with tracing.recording() as spans:
                    t0 = time.perf_counter()
                    analysis.run(i)
                    sync()
                    t1 = time.perf_counter()
                recorded.extend(spans)
            else:
                t0 = time.perf_counter()
                analysis.run(i)
                sync()
                t1 = time.perf_counter()
            walls[mode].append((t1 - t0) * 1e3)
            i += 1
    mean = {mode: statistics.fmean(w) for mode, w in walls.items()}
    print(f"triangle ms, recorder off / on (mean of {len(walls['off'])} each, in turns): "
          f"{mean['off']:.3f} / {mean['on']:.3f} ({100 * (mean['on'] / mean['off'] - 1):+.2f}%); "
          f"medians {statistics.median(walls['off']):.3f} / {statistics.median(walls['on']):.3f}", flush=True)
    stages = per_call_ms(recorded)
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  span {name}: {ms:.3f} ms/analysis", flush=True)
    bw = stages.get("2d:bandwidths", 0.0)
    if bw:
        print(f"bandwidths_ms {bw:.3f}; 2d:tstar {100 * stages.get('2d:tstar', 0.0) / bw:.1f}% of it, "
              f"2d:amise_fixed + 2d:amise_free "
              f"{100 * (stages.get('2d:amise_fixed', 0.0) + stages.get('2d:amise_free', 0.0)) / bw:.1f}%", flush=True)

    counted = {}
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        read = harness.load_module(harness.HERE / "metrics" / "bandwidth_launches.py").read
        traced = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                with perfbench_trace.analysis_range():
                    traced.append(analysis.run(i))
                    sync()
                i += 1
        split, nranges, annotations = launches(prof)
        print(f"device-side annotations left out of the busy time: {', '.join(annotations)}", flush=True)
        print(f"span names outside {STAGES}: {sorted({s.name for s in recorded if not s.name.startswith(STAGES)})}",
              flush=True)
        window = perfbench_trace.reduce(prof, [analysis.info(r) for r in traced], {})
        n = PROFILED
        total = sum(v[0] for v in split.values()) / n
        counted = {"by_range": {k: [v[0] / n, v[1] / n] for k, v in split.items()}, "joined": total,
                   "reader": read(window), "ranges_per_analysis": nranges / n, "annotations": annotations}
        print(f"launches in 2d:bandwidths per analysis, joined by correlation id: {total:.2f} "
              f"(perfbench bandwidth_launches: {counted['reader']}); {nranges / n:.1f} ranges an analysis", flush=True)
        for name, (count, dtoh) in sorted(counted["by_range"].items(), key=lambda kv: -kv[1][0]):
            print(f"  innermost {name}: {count:.2f} launches, {dtoh:.2f} device-to-host copies", flush=True)
        del prof, window, traced

    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": card, "constructor_ms": constructor,
                      "triangle_ms": walls, "spans_ms": stages, "launches": counted}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
