"""Collectives over a ``torch.distributed`` process group, named after the
JAX ones they replace (``jax.lax.psum`` / ``pmin`` / ``pmax`` /
``ppermute`` over a ``shard_map`` axis).

``group=None`` is the unsharded path: every function returns its input.
Each rank of a group holds one contiguous block of the samples; these
functions combine the ranks' local values and return the result on every
rank. The tensors lie where the group's backend wants them (CUDA for NCCL,
the CPU for gloo).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["size", "psum", "psum_", "pmin", "pmax", "ppermute"]


def size(group):
    """Number of ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x, group, op):
    if group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x, group):
    """Sum of ``x`` over the ranks (``dist.all_reduce(SUM)``)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def psum_(x, group):
    """:func:`psum` in place: ``x`` (contiguous) becomes the sum and is
    returned, with no copy; for a caller that no longer needs its own
    value."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def pmin(x, group):
    return _all_reduce(x, group, dist.ReduceOp.MIN)


def pmax(x, group):
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def ppermute(x, group, perm):
    """``jax.lax.ppermute``: for each (src, dst) in ``perm`` (group ranks),
    rank dst receives src's ``x``; a rank that is no destination gets
    zeros. One ``dist.batch_isend_irecv`` per call."""
    if group is None:
        raise ValueError("ppermute needs a process group")
    rank = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == rank:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        if dst == rank:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
