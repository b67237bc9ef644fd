"""One run of one benchmark cell.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration's file (``configs``' ``file``); its
traffic mix, ``perfbench/traffic/<traffic>.json``, which names its
analysis, ``perfbench/analyses/<analysis>.py``; each end-to-end metric's
reader, ``perfbench/end_to_end/<name>.py``; each per-layer metric's reader,
``perfbench/metrics/<name>.py``; and the limits of the check,
``perfbench/limits/<cell>.json``. A later cell, mix, configuration or
metric is added by adding files and entries.

A run: make the pool of chains from the seed, build and warm the
program's objects (set-up), run analyses back to back for the window (one
client in a closed loop), or with tracing a few analyses under the
profiler, then read the peak memory, free the program's state and check
a sample of the window's answers against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "getdist_tpu")


def process_start():
    """This process's start on the ``time.perf_counter`` clock (from the
    kernel's start time of the process; the harness's own import time
    where that cannot be read)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - max(uptime - start_ticks / ticks, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A module of the harness's own files, by path (names may hold dots)."""
    name = "perfbench_" + path.relative_to(HERE).with_suffix("").as_posix().replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` and everything it names."""

    def __init__(self, name, bench=None):
        bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.spec = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / configs[self.spec["config"]]["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.spec['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.analysis = load_module(HERE / "analyses" / f"{self.traffic['analysis']}.py")

    def reader(self, kind, name):
        return load_module(HERE / kind / f"{name}.py").read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reservoir(kept, item, seen, k, rng):
    """Keep a uniform sample of ``k`` of the items seen so far."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = int(rng.integers(0, seen + 1))
        if j < k:
            kept[j] = item


def run(cell, seed, seconds, trace, device="cuda", t_start=None, log=sys.stderr):
    """One run of ``cell`` (a :class:`Cell`); returns the result line's
    dict. ``device``: "cuda" on the card; the CPU only for tests of the
    harness (no device metric is measured there)."""
    import torch

    from perfbench.chains import chain_seed, make_chain

    t_start = process_start() if t_start is None else t_start
    device = torch.device(device)
    traffic = cell.traffic
    pool = int(traffic["pool"])
    marks = [("start", t_start), ("imports", time.perf_counter())]
    chains = [make_chain(cell.config, chain_seed(seed, i), device) for i in range(pool)]
    marks.append(("chains", time.perf_counter()))
    analysis = cell.analysis.Analysis(cell.config, traffic, chains, device, seed)
    analysis.setup(lambda stage: marks.append((stage, time.perf_counter())))
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    check_rng = np.random.default_rng([int(seed) % 2**64, 1])
    kept, traced, walls, attempted, failed = [], [], [], 0, 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from perfbench import trace as tr

        counts_before = tr.counters()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print("set-up (s): " + ", ".join(f"{name} {t - prev:.3f}" for (_, prev), (name, t) in zip(marks, marks[1:])),
          file=log)
    i = 0
    while True:
        a0 = time.perf_counter()
        attempted += 1
        try:
            if trace:
                with tr.analysis_range():
                    result = analysis.run(i)
                    _sync(device)
            else:
                result = analysis.run(i)
                _sync(device)
        except Exception as exc:  # noqa: BLE001 - a failed analysis is counted and reported, and the run goes on
            failed += 1
            print(f"analysis {i} failed: {exc!r}", file=log)
            result = None
        a1 = time.perf_counter()
        walls.append(a1 - a0)
        if result is not None:
            _reservoir(kept, result, attempted - failed - 1, int(traffic["checked"]), check_rng)
            if trace:
                traced.append(result)
        i += 1
        # the window ends after ``seconds`` (traced: ``traced`` analyses) once
        # it holds as many answers as the check samples, or a failure
        done = i >= int(traffic["traced"]) if trace else a1 - t0 >= seconds
        if done and (attempted - failed >= int(traffic["checked"]) or failed):
            break
    window_s = a1 - t0
    if trace:
        prof.__exit__(None, None, None)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    if trace:
        r0 = time.perf_counter()
        window = tr.reduce(prof, [analysis.info(r) for r in traced], tr.counter_delta(counts_before, tr.counters()))
        del prof
        print(f"trace read in {time.perf_counter() - r0:.3f} s: {len(window.device_ops)} device operations", file=log)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")

    # the check, once the window has closed and the program's state is freed
    served = [analysis.served(r) for r in kept]
    del kept, result, traced
    analysis.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, notes = {}, []
    for got in served:
        nums, note = analysis.compare(got, analysis.reference(got))
        notes.append(note)
        for key, value in nums.items():
            numbers[key] = max(numbers.get(key, 0.0), value)
    missing = sorted(set(numbers) - set(cell.limits))
    if missing:
        raise SystemExit(f"no limit for {missing} in perfbench/limits/{cell.name}.json")
    checks = {key: {"value": value, "limit": cell.limits[key]} for key, value in sorted(numbers.items())}
    correct = bool(served) and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    run_info = {"setup_s": setup_s, "window_s": window_s, "walls": walls, "completed": attempted - failed}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader("metrics", m["name"])(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = cell.reader("end_to_end", m["name"])(run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        out["device"]["busy_s"] = window.busy_seconds()
        out["device"]["window_s"] = window.seconds
        out["breakdown"] = {"device_ops": window.top_device_ops(), "idle_gaps": window.idle_gaps()}
        print(f"counters over the traced window: {json.dumps(window.counters)}", file=log)
        print(f"analyses traced: {len(window.analyses)}; host window {window_s:.6f} s", file=log)
    else:
        quart = statistics.quantiles(walls, n=4) if len(walls) > 1 else walls * 3
        print(f"analyses: {attempted - failed} completed of {attempted} in {window_s:.6f} s; walls (s) quartiles "
              f"{quart[0]:.6f} {quart[1]:.6f} {quart[2]:.6f}, max {max(walls):.6f}", file=log)
    print(f"check notes: {json.dumps(notes)}", file=log)
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=log)
    out["checks"] = checks
    return out
