#!/usr/bin/env python
"""The fused entry's sums over samples (moments, N_eff lag sums, cumulant
score) and its stage walls, for two checkouts of the port, on one CUDA card in
one call.

Run from the root of the repository on a machine with a card and ``nvcc``:

    python3 scripts/time_reductions_torch.py --trees PARENT CHANGE [--rows 1000000] [--turns 3] [--reps 10]

Each tree's ``getdist_tpu_torch`` runs in a process of its own, in the order
PARENT CHANGE CHANGE PARENT, so that neither always runs first. Every process
makes ``chip_smoke.bounded_chain(rows)`` (30 columns with limits, periodic
axes and loglikes; the entry with ``meanlikes``) and
``chip_smoke.hard_chain(rows)`` from their seeds, and for each chain:

* the public entry ``MCSamples(...).fastTriangleDensities`` once cold, then
  ``--turns`` times warm on the same object: the least warm wall (host clock,
  card synchronized) and that call's ``fast_profile`` stages;
* with CUDA events, the mean of ``--reps`` calls on the chain on the card:
  the 1D stage's N_eff (the tree's ``_neff_kde_batch`` at
  ``all_1d_densities``' lags), the pair cumulant score (the tree's
  ``pair_cumulant_score``), the 1D moments and the 2D optimizer's covariance
  (the tree's ``_weighted_moments`` where it has one; else the f32 lines its
  ``all_1d_densities`` and ``_optimized_bandwidths`` run, repeated here), and
  the tree's ``all_1d_densities`` whole.

Prints the card line, one JSON line per process, then one JSON line with
every process's numbers. Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree, rows, turns, reps):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import getdist_tpu_torch
    from getdist_tpu_torch.mcsamples import MCSamples
    from getdist_tpu_torch.ops import batched
    from getdist_tpu_torch.ops import collectives as coll

    if not os.path.abspath(getdist_tpu_torch.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {getdist_tpu_torch.__file__}, not the tree {tree}")
    sys.path.append(ROOT)
    from chip_smoke import bounded_chain, cuda_ms, hard_chain

    def moments_1d(cols, w):
        if hasattr(batched, "_weighted_moments"):
            return batched._weighted_moments(cols, w)
        norm = coll.psum(torch.sum(w), None)
        means = coll.psum(torch.matmul(cols, w), None) / norm
        return norm, means, coll.psum(torch.matmul((cols - means[:, None]) ** 2, w), None) / norm

    def covariance(cols, w):
        if hasattr(batched, "_weighted_moments"):
            return batched._weighted_moments(cols, w, full_cov=True)[2]
        norm = coll.psum(torch.sum(w), None)
        means = coll.psum(torch.matmul(cols, w), None) / norm
        diffs = cols - means[:, None]
        return coll.psum(torch.matmul(diffs * w[None, :], diffs.T), None) / norm

    out = {"tree": tree}
    samples, weights, loglikes, names, ranges = bounded_chain(rows)
    hard, hard_w = hard_chain(rows)
    chains = {
        "bounded": (dict(samples=samples, weights=weights, loglikes=loglikes, names=names, ranges=ranges), True),
        "hard": (dict(samples=hard, weights=hard_w, names=[f"h{i}" for i in range(hard.shape[1])]), False),
    }
    for label, (kwargs, meanlikes) in chains.items():
        mc = MCSamples(device="cuda", **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mc.fastTriangleDensities(meanlikes=meanlikes)
        torch.cuda.synchronize()
        row = {"entry cold ms": (time.perf_counter() - t0) * 1e3}
        best = None
        for _ in range(turns):
            t0 = time.perf_counter()
            mc.fastTriangleDensities(meanlikes=meanlikes)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if best is None or wall < best[0]:
                best = (wall, {k: v * 1e3 for k, v in mc.fast_profile.items()})
        row["entry warm ms"], row["fast_profile ms"] = best
        s, w = batched.prepare_chain(kwargs["samples"], kwargs["weights"], device="cuda")
        cols = s.T.contiguous()
        n = s.shape[0]
        _, means, variances = moments_1d(cols, w)
        sigmas = torch.sqrt(variances)
        lags = batched._lag_grid(n, max_lag=None)
        with torch.no_grad():
            row["N_eff lag sums ms"] = cuda_ms(lambda: batched._neff_kde_batch(cols, w, sigmas, lags, None, n), reps)
            row["cumulant score ms"] = cuda_ms(lambda: batched.pair_cumulant_score(s, w), reps)
            row["1D moments ms"] = cuda_ms(lambda: moments_1d(cols, w), reps)
            row["2D covariance ms"] = cuda_ms(lambda: covariance(cols, w), reps)
            row["all_1d_densities ms"] = cuda_ms(lambda: batched.all_1d_densities(s, w), reps)
        row["lags"] = len(lags)
        out[label] = row
        del mc, s, w, cols
        torch.cuda.empty_cache()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs=2, metavar=("PARENT", "CHANGE"))
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--turns", type=int, default=3)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.rows, args.turns, args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_reductions_torch: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi failed")
    parent, change = args.trees
    runs = []
    for tree in (parent, change, change, parent):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree, "--rows", str(args.rows),
               "--turns", str(args.turns), "--reps", str(args.reps)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            sys.stderr.write(done.stderr[-4000:])
            return done.returncode
        line = done.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
