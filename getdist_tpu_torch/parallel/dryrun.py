"""A multi-rank dry run of the sharded pipeline on the CPU (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``).

    python -m getdist_tpu_torch.parallel.dryrun 8

spawns 8 gloo ranks (:func:`~getdist_tpu_torch.parallel.mesh.spawn_ranks`)
that run :func:`~getdist_tpu_torch.parallel.reductions.
sharded_triangle_densities` on one bounded, periodic and correlated chain
and checks the shapes and flags of every rank's result.
"""

from __future__ import annotations

import sys

import numpy as np
import torch.distributed as dist

__all__ = ["dryrun_chain", "dryrun_multirank"]


def dryrun_chain(n_ranks):
    """(samples, weights, limits_lo, limits_hi, periodic) of the dry run:
    512 samples per rank of 4 parameters from seed 1, a pair at corr ~0.8
    (the sheared bandwidths), one parameter hard-bounded at 0 and one
    periodic on [0, 2)."""
    rng = np.random.RandomState(1)
    n, p = 512 * n_ranks, 4
    samples = rng.standard_normal((n, p)).astype(np.float32)
    samples[:, 1] = 0.8 * samples[:, 0] + 0.6 * samples[:, 1]
    samples[:, 2] = np.abs(samples[:, 2])
    samples[:, 3] = np.mod(samples[:, 3], 2.0)
    weights = rng.randint(1, 3, n).astype(np.float32)
    limits_lo = np.array([np.nan, np.nan, 0.0, 0.0], np.float32)
    limits_hi = np.array([np.nan, np.nan, np.nan, 2.0], np.float32)
    periodic = np.array([False, False, False, True])
    return samples, weights, limits_lo, limits_hi, periodic


def _rank(group, n_ranks):
    from getdist_tpu_torch.parallel import shard_samples, sharded_triangle_densities

    samples, weights, limits_lo, limits_hi, periodic = dryrun_chain(n_ranks)
    d1, d2 = sharded_triangle_densities(
        group, *shard_samples(group, samples, weights, device="cpu"), limits_lo=limits_lo, limits_hi=limits_hi,
        periodic=periodic, enable_shear=True, n_samples=len(samples),
    )
    return {
        "rank": dist.get_rank(group),
        "P1": d1["P"].numpy(),
        "P2": d2["P"].numpy(),
        "contours": d2["contours"].numpy(),
        "active_lo": d1["active_lo"].numpy(),
        "periodic": d1["periodic"].numpy(),
    }


def dryrun_multirank(n_ranks, timeout_s=600.0):
    """Run the sharded triangle pipeline on ``n_ranks`` gloo ranks on the
    CPU and check every rank's output: (4, 1024) 1D and (6, 256, 256) 2D
    grids, finite, (6, 2) contours, the hard limit active and the periodic
    flag kept, and every rank's grids equal to rank 0's bit for bit.
    Returns rank 0's result."""
    from getdist_tpu_torch.parallel.mesh import spawn_ranks

    results = spawn_ranks(_rank, n_ranks, "gloo", args=(n_ranks,), timeout_s=timeout_s)
    p = 4
    n_pairs = p * (p - 1) // 2
    for rank, out in enumerate(results):
        if out["rank"] != rank:
            raise AssertionError(f"result {rank} came from rank {out['rank']}")
        if out["P1"].shape != (p, 1024) or not np.all(np.isfinite(out["P1"])):
            raise AssertionError(f"rank {rank}: 1D grids {out['P1'].shape}, finite {np.isfinite(out['P1']).all()}")
        if out["P2"].shape != (n_pairs, 256, 256) or not np.all(np.isfinite(out["P2"])):
            raise AssertionError(f"rank {rank}: 2D grids {out['P2'].shape}, finite {np.isfinite(out['P2']).all()}")
        if out["contours"].shape != (n_pairs, 2):
            raise AssertionError(f"rank {rank}: contours {out['contours'].shape}")
        if not out["active_lo"][2] or not out["periodic"][3]:
            raise AssertionError(f"rank {rank}: the hard limit or the periodic flag was lost")
        for key in ("P1", "P2", "contours"):
            if not np.array_equal(out[key], results[0][key]):
                raise AssertionError(f"rank {rank}: {key} differs from rank 0's")
    print(f"dryrun_multirank OK on {n_ranks} gloo ranks: d1 {results[0]['P1'].shape}, d2 {results[0]['P2'].shape} "
          "(bounded + periodic + correlated)")
    return results[0]


if __name__ == "__main__":
    dryrun_multirank(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
