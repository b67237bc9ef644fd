"""Sharded sample reductions over ``torch.distributed`` (counterpart of
``getdist_tpu.parallel``).

A chain is split on the sample axis into one contiguous block per rank,
one rank per process and device. Every sample-linear reduction (fine
histograms, weighted moments, N_eff lag sums) runs on each block and is
combined by one all-reduce of the small binned state; the post-binning
KDE work is grid-local and runs on every rank. NCCL joins CUDA cards,
gloo joins CPU processes.
"""

from getdist_tpu_torch.parallel.mesh import init_group, shard_samples, shard_values, spawn_ranks
from getdist_tpu_torch.parallel.reductions import (
    sharded_all_1d_densities,
    sharded_all_2d_densities,
    sharded_hist_1d,
    sharded_moments,
    sharded_pair_hists,
    sharded_triangle_densities,
    sharded_triangle_step,
)

__all__ = [
    "init_group",
    "shard_samples",
    "shard_values",
    "spawn_ranks",
    "sharded_moments",
    "sharded_hist_1d",
    "sharded_pair_hists",
    "sharded_triangle_step",
    "sharded_triangle_densities",
    "sharded_all_1d_densities",
    "sharded_all_2d_densities",
]
