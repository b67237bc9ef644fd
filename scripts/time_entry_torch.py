#!/usr/bin/env python
"""Warm walls of the port's public fused entry and fused program on one
CUDA card, for comparing two trees of the repository in one machine.

Run from the root of a tree on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_entry_torch.py --label change [--turns 5]

To compare with an older commit, unpack that commit into an ignored
directory of the repository (``git archive <commit> | tar -x -C
scratch_tree/parent``), copy this script into its ``scripts/`` and run the
two in turns (parent, change, change, parent), each process timing its
own tree's package.

Builds the tree's kernels, makes the unbounded chains of ``chip_smoke.py``
(``bench.make_chain(1_000_000, 30)`` and ``chip_smoke.degenerate_chain(
1_000_000)``), then times three workloads: ``MCSamples(...)
.fastTriangleDensities()`` on the bench chain, ``triangle_densities`` on
the bench chain and ``fastTriangleDensities()`` on the degenerate chain.
One cold call each, then ``--turns`` rounds of one warm call of each
workload in turn (host wall around a synchronized call). Prints each
workload's walls and the stage split (``fast_profile``) of its last
call, then one JSON line ``{"label", "card", "walls_ms": {workload:
[...]}}``. Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bench import make_chain  # noqa: E402
from chip_smoke import degenerate_chain  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from getdist_tpu_torch.ops import _cuda, batched  # noqa: E402


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=ROOT)
    parser.add_argument("--turns", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(smi, capture_output=True, text=True).stdout.strip()
    lib = _cuda.library()
    print(f"{args.label}: {card}; build {lib.build_seconds:.1f} s")

    samples, weights = make_chain(1_000_000, 30)
    dsamples, dweights = degenerate_chain(1_000_000)
    bench_mc = MCSamples(samples=samples, weights=weights, names=[f"p{i}" for i in range(30)], device="cuda")
    deg_mc = MCSamples(samples=dsamples, weights=dweights, names=[f"d{i}" for i in range(dsamples.shape[1])],
                       device="cuda")
    dev_s, dev_w = batched.prepare_chain(samples, weights, "cuda")
    workloads = {
        "bench_entry": (bench_mc.fastTriangleDensities, bench_mc),
        "triangle_densities": (lambda: batched.triangle_densities(dev_s, dev_w, device="cuda"), None),
        "degenerate_entry": (deg_mc.fastTriangleDensities, deg_mc),
    }
    cold = {name: wall_ms(fn) for name, (fn, _) in workloads.items()}
    walls = {name: [] for name in workloads}
    for _ in range(args.turns):
        for name, (fn, _) in workloads.items():
            walls[name].append(wall_ms(fn))
    for name, (_, mc) in workloads.items():
        split = "" if mc is None else "; stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in mc.fast_profile.items())
        print(f"{args.label} {name}: cold {cold[name]:.1f} ms, warm min {min(walls[name]):.1f} ms (all: "
              f"{', '.join(f'{x:.1f}' for x in walls[name])}){split}")
    print(json.dumps({"label": args.label, "card": card, "walls_ms": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
