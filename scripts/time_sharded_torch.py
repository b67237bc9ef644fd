#!/usr/bin/env python
"""The sharded path on several CUDA cards of one host, one NCCL rank per card.

Run from the root of the repository on a machine with that many cards and
``nvcc``:

    python3 scripts/time_sharded_torch.py --ranks 4 [--rows 1000000] [--columns 30] [--turns 3]

Spawns the ranks with ``getdist_tpu_torch.parallel.spawn_ranks``. Every rank
makes ``bench.make_chain(rows, columns)`` and ``chip_smoke.bounded_chain(rows,
columns)`` from their seeds and runs on its block (``shard_samples``):

* ``sharded_triangle_densities`` on the bench chain;
* the same on the bounded chain with its limits, periodic flags and like
  weights (``shard_values``);
* ``MCSamples(...).fastTriangleDensities(mesh=group, meanlikes=True)`` on
  the bounded chain (every rank holds the whole ``MCSamples``).

Each workload runs once cold, then ``--turns`` times warm. A call's wall is
the host clock around it, the card synchronized and the ranks released
together by a barrier; the slowest rank's wall is reported, with each
workload's device memory on the busiest card (``torch.cuda``'s allocator:
what the rank held before it and its peak during it; rank 0's unsharded
entry beside the mesh entry, whose ranks upload only their blocks). Each rank
returns a digest of every output tensor; rank 0 also runs the unsharded
counterparts on its card (``triangle_densities`` on the whole chain, the
entry without ``mesh``) and returns the largest differences. The parent
checks every rank's digests against rank 0's and the differences against
tests/test_parallel.py's tolerances (neff rtol 1e-3, 1D P 1e-5, 2D P 3e-5
and 2e-5 for the entry's served grids, contours rtol 1e-3; 1D like curves
1e-4, 2D like grids where P > 1e-2 at 5e-3: the ranks' f32 partial sums
are all-reduced in another order than one card's, ROADMAP C13; the whole
grid's difference is printed beside), then prints the card line and one
JSON line. Imports nothing of JAX.

``--backend gloo --device cpu --rows 20000 --columns 10`` runs the same on
the CPU.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bench import make_chain  # noqa: E402
from chip_smoke import BOUNDED_KINDS, bounded_chain, like_weights_of, limit_arrays  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from getdist_tpu_torch.ops import batched  # noqa: E402
from getdist_tpu_torch.parallel import (  # noqa: E402
    shard_samples,
    shard_values,
    sharded_triangle_densities,
    spawn_ranks,
)

TOL = {"neff": ("rtol", 1e-3), "1D P": ("atol", 1e-5), "2D P": ("atol", 3e-5), "contours": ("rtol", 1e-3),
       "1D likes": ("atol", 1e-4), "2D likes where P > 0.01": ("atol", 5e-3), "served 2D P": ("atol", 2e-5)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _memory(device, fn):
    """(``fn()``, {"held_mb", "peak_mb"}): the allocator's bytes in use on
    ``device`` before the call and their peak during it (None on the CPU)."""
    if device.type != "cuda":
        return fn(), None
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    return out, {"held_mb": held / 2**20, "peak_mb": torch.cuda.max_memory_allocated(device) / 2**20}


def _timed(group, device, fn, turns):
    """(cold ms, [warm ms], last output) of ``fn``, each call started after a
    barrier and timed to a synchronized end."""
    walls = []
    for _ in range(1 + turns):
        dist.barrier(group)
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls[0], walls[1:], out


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, v in tree.items() for k2, v in _tensors(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v for i, v in enumerate(tree) for k2, v in _tensors(v, f"{prefix}{i}/").items()}
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def _digest(tree):
    return {key: hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for key, t in _tensors(tree).items()}


def _max_diffs(got, want, entry=False):
    """Largest differences of (d1, d2) against (d1, d2), by TOL's names."""
    (g1, g2), (w1, w2) = got, want

    def err(a, b, kind):
        a, b = a.double().cpu(), b.double().cpu()
        diff = (a - b).abs()
        return float((diff / b.abs().clamp_min(1e-30)).max() if kind == "rtol" else diff.max())

    out = {"neff": err(g1["neff"], w1["neff"], "rtol"), "1D P": err(g1["P"], w1["P"], "atol"),
           "contours": err(g2["contours"], w2["contours"], "rtol")}
    if entry:
        out["served 2D P"] = max(float((g["P"].cpu() - w["P"].cpu()).abs().max()) for g, w in entry)
    else:
        out["2D P"] = err(g2["P"], w2["P"], "atol")
    if g1.get("likes") is not None:
        out["1D likes"] = err(g1["likes"], w1["likes"], "atol")
        bulk = (g2["P"] > 1e-2) & (w2["P"] > 1e-2)
        out["2D likes where P > 0.01"] = float((g2["likes"][bulk] - w2["likes"][bulk]).abs().max())
        out["2D likes, whole grid"] = err(g2["likes"], w2["likes"], "atol")
    return out


def _rank(group, rows, columns, turns, device_name):
    rank = dist.get_rank(group)
    device = torch.device(f"cuda:{rank}" if device_name == "cuda" else "cpu")
    samples, weights = make_chain(rows, columns)
    b_samples, b_weights, loglikes, names, ranges = bounded_chain(rows, p=columns)
    lo, hi, per = limit_arrays(names, ranges)
    like = like_weights_of(b_weights, loglikes)
    local = shard_samples(group, samples, weights, device=device)
    b_local = shard_samples(group, b_samples, b_weights, device=device)
    b_like = shard_values(group, like, device=device)
    bounded_kw = dict(limits_lo=lo, limits_hi=hi, periodic=per, int8_weights=True, enable_shear=True)
    mc = MCSamples(samples=b_samples, weights=b_weights, loglikes=loglikes, names=names, ranges=ranges, device=device)

    def entry(**kw):
        d1, d2, pairs = mc.fastTriangleDensities(meanlikes=True, **kw)
        served = [d2["regrid"][key] if key in d2["regrid"] else {"P": d2["P"][k]} for k, key in enumerate(pairs)]
        return (d1, {key: v for key, v in d2.items() if key != "regrid"}), served, sorted(d2["regrid"])

    workloads = {
        "bench chain, sharded_triangle_densities": lambda: sharded_triangle_densities(
            group, *local, n_samples=rows),
        "bounded chain, sharded_triangle_densities (limits, periodic, like weights)": lambda: sharded_triangle_densities(
            group, *b_local, like_weights=b_like, n_samples=rows, **bounded_kw),
        "bounded chain, fastTriangleDensities(mesh=group, meanlikes=True)": lambda: entry(mesh=group),
    }
    result = {"rank": rank, "walls_ms": {}, "digests": {}, "diffs": {}, "memory": {}}
    outs = {}
    for name, fn in workloads.items():
        (cold, warm, out), result["memory"][name] = _memory(device, lambda: _timed(group, device, fn, turns))
        result["walls_ms"][name] = {"cold": cold, "warm": warm}
        result["digests"][name] = _digest(out)
        outs[name] = out
    if rank == 0:
        whole = batched.prepare_chain(samples, weights, device=device)
        b_whole = batched.prepare_chain(b_samples, b_weights, device=device)
        names_ = list(workloads)
        result["diffs"][names_[0]] = _max_diffs(
            outs[names_[0]], batched.triangle_densities(*whole, int8_weights=False, enable_shear=True, device=device))
        result["diffs"][names_[1]] = _max_diffs(outs[names_[1]], batched.triangle_densities(
            *b_whole, like_weights=like, device=device, **bounded_kw))
        (u, u_served, u_keys), result["memory"]["unsharded entry"] = _memory(device, entry)
        g, g_served, g_keys = outs[names_[2]]
        result["diffs"][names_[2]] = _max_diffs(g, u, entry=list(zip(g_served, u_served)))
        result["regrid_keys_equal"] = g_keys == u_keys
        result["regrid_keys"] = len(u_keys)
    return result


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--columns", type=int, default=30)
    parser.add_argument("--turns", type=int, default=3)
    parser.add_argument("--backend", default="nccl")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"needs {args.ranks} CUDA cards, found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        card = subprocess.run(smi, capture_output=True, text=True).stdout.strip().replace("\n", "; ")
        from getdist_tpu_torch.ops import _cuda

        print(f"build {_cuda.library().build_seconds:.1f} s", flush=True)
    else:
        card = "cpu"
    t0 = time.perf_counter()
    results = spawn_ranks(_rank, args.ranks, args.backend, args=(args.rows, args.columns, args.turns, args.device), timeout_s=1200)
    print(f"{args.ranks} ranks ran in {time.perf_counter() - t0:.1f} s (bounded chain kinds {BOUNDED_KINDS})")
    first = results[0]
    failures = []
    for res in results[1:]:
        for name, digest in res["digests"].items():
            if digest != first["digests"][name]:
                bad = [key for key in digest if digest[key] != first["digests"][name].get(key)]
                failures.append(f"rank {res['rank']}, {name}: outputs differ from rank 0's ({bad[:4]})")
    for name, diffs in first["diffs"].items():
        for key, value in diffs.items():
            if key not in TOL:  # reported only
                continue
            kind, tol = TOL[key]
            if value > tol:
                failures.append(f"{name} against the unsharded run: {key} {value} ({kind} {tol})")
    if not first["regrid_keys_equal"]:
        failures.append("the mesh entry's regrid keys differ from the unsharded entry's")
    walls = {name: {"cold": max(r["walls_ms"][name]["cold"] for r in results),
                    "warm": [max(r["walls_ms"][name]["warm"][i] for r in results) for i in range(args.turns)]}
             for name in first["walls_ms"]}
    for name, w in walls.items():
        print(f"{name}: cold {w['cold']:.1f} ms, warm {min(w['warm']):.1f} ms (min of {args.turns}: "
              f"{', '.join(f'{x:.1f}' for x in w['warm'])}; slowest rank per call); against the unsharded run "
              f"on rank 0's device: {json.dumps(first['diffs'][name])}")
    memory = {name: max((r["memory"].get(name) for r in results), key=lambda m: -1 if m is None else m["peak_mb"])
              for name in first["memory"]}
    print(f"device memory (MiB, busiest card; 'unsharded entry': rank 0's): {json.dumps(memory)}")
    print(f"every rank's outputs bitwise equal to rank 0's: {not any('rank ' in f for f in failures)}; "
          f"regrid keys of the mesh entry equal to the unsharded entry's ({first['regrid_keys']}): "
          f"{first['regrid_keys_equal']}")
    for failure in failures:
        print(f"FAILED: {failure}", file=sys.stderr)
    print(card)
    print(json.dumps({"ranks": args.ranks, "rows": args.rows, "columns": args.columns, "card": card, "walls_ms": walls,
                      "diffs": first["diffs"], "memory_mb": memory, "ok": not failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
