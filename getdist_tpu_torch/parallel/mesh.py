"""Process groups and chain sharding (counterpart of
``getdist_tpu/parallel/mesh.py``).

The JAX package shards a chain over a ``Mesh`` of the devices of one
process. Here every rank is a process of its own with one device, joined
to the others by a ``torch.distributed`` process group: NCCL across CUDA
cards, gloo across CPU processes (the tests). Each rank holds one
contiguous block of the samples.

Starting ranks: on cards, one process per card, each calling
:func:`init_group` with its rank, the world size and a shared
``init_method`` (``tcp://127.0.0.1:<port>`` on one host, or
``file://<path>``); :func:`spawn_ranks` starts them as child processes
of one parent (``spawn_ranks(fn, 4, "gloo")`` on the CPU, as the tests
do).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from getdist_tpu_torch.ops._cuda import resolve_device
from getdist_tpu_torch.ops.batched import _tensor

__all__ = ["init_group", "shard_samples", "spawn_ranks"]


def init_group(
    backend="nccl", rank=0, world_size=1, init_method=None, device=None, timeout=datetime.timedelta(seconds=300)
):
    """Join this process to the default process group as ``rank`` of
    ``world_size`` and return the group.

    NCCL on ``cuda:<rank>`` by default (made this process's current CUDA
    device); gloo and the CPU only when the caller names them.
    ``init_method``: ``file://<path>`` (a file every rank reaches, absent
    before the first rank starts) or ``tcp://<host>:<port>``; None reads
    torch's ``env://`` variables. ``timeout`` bounds the rendezvous and
    every collective, so a rank that never arrives fails the others instead
    of hanging them."""
    device = resolve_device(device if device is not None else (f"cuda:{rank}" if backend == "nccl" else "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, timeout=timeout)
    return dist.group.WORLD


def shard_samples(group, samples, weights, device="cuda", dtype=torch.float32):
    """This rank's block of a (N, P) chain and its (N,) weights, as
    ``dtype`` tensors on ``device``.

    Every block has ceil(N / W) samples: the last ranks are padded with
    zero-weight samples that repeat the chain's last sample, so no moment,
    histogram or range moves (the JAX package trims up to W - 1 samples
    instead). ``group=None`` returns the whole chain."""
    rank = 0 if group is None else dist.get_rank(group)
    world = 1 if group is None else dist.get_world_size(group)
    device = resolve_device(device)
    n_total = samples.shape[0]
    if n_total == 0 or weights.shape[0] != n_total:
        raise ValueError(f"need a non-empty chain with one weight per sample, got {n_total} and {weights.shape[0]}")
    n = -(-n_total // world)
    lo, hi = min(rank * n, n_total), min((rank + 1) * n, n_total)
    block = _tensor(samples[lo:hi], device, dtype)
    block_w = _tensor(weights[lo:hi], device, dtype)
    pad = n - (hi - lo)
    if pad:
        last = _tensor(samples[n_total - 1 :], device, dtype)
        block = torch.cat([block, last.expand(pad, -1)])
        block_w = torch.cat([block_w, torch.zeros(pad, dtype=dtype, device=device)])
    return block, block_w


def _rank_main(fn, rank, world_size, backend, init_method, args, results):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        group = init_group(backend, rank, world_size, init_method, device="cpu" if backend == "gloo" else None)
        try:
            value = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, value))
    except Exception:  # noqa: BLE001 - the parent reports the traceback
        results.put((rank, traceback.format_exc(), None))


def spawn_ranks(fn, world_size, backend, args=(), timeout_s=600.0):
    """Run ``fn(group, *args)`` on ``world_size`` new processes, one rank
    each, joined by a fresh ``backend`` process group ("nccl": rank r on
    ``cuda:r``; "gloo": on the CPU), its store a file in a temporary
    directory; return the results by rank.

    ``fn`` and its arguments and results must pickle (``fn`` a module-level
    function). Raises if a rank fails or if the ranks do not finish within
    ``timeout_s``; every process is ended before this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, args=(fn, rank, world_size, backend, init_method, args, results), daemon=True)
            for rank in range(world_size)
        ]
        for proc in procs:
            proc.start()
        try:
            deadline = time.monotonic() + timeout_s
            while len(out) < world_size:
                try:
                    rank, error, value = results.get(timeout=max(1.0, deadline - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(f"{world_size - len(out)} of {world_size} ranks ran past {timeout_s} s") from None
                if error is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{error}")
                out[rank] = value
        finally:
            for proc in procs:
                proc.join(timeout=30)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    return [out[rank] for rank in range(world_size)]
