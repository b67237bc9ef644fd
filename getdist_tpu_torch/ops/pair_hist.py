"""All-pairs 256x256 weighted histograms (kernel K1 of the port).

Counterpart of ``getdist_tpu/ops/pallas_kernels.py:pair_histograms_tiled``
(the TPU's tiled one-hot MXU kernel, which ``ops/batched.py`` calls on its
static-pair route). The pair list is an argument, so the same kernel also
serves the dynamic-pair (``pair_histograms``) and b-anchored
(``pair_histograms_grouped``) TPU schedules. The CUDA kernel is
``csrc/pair_hist.cu``. On the H100 it is bound by shared-memory atomics
(one per sample and pair) and by index reads that stay in L2; it bins
directly instead of building the TPU's one-hot stacks (7.7 GB of traffic
at 30 x 1M), with one 128-row half of a pair's histogram per block, since
a full 256 KB int32 tile exceeds a block's shared memory.

Convention (``getdist_tpu/ops/batched.py:_pair_hist_256``): ``out[k, b, a]``
sums the weights of samples with ``ix[pair_b[k]] == b`` and
``ix[pair_a[k]] == a`` (rows = b, cols = a). No padding of N is needed.
"""

from __future__ import annotations

import torch

from getdist_tpu_torch.ops import _cuda

__all__ = ["NBINS", "pair_histograms", "pair_histograms_plain"]

NBINS = 256


def pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights=False):
    """Plain PyTorch version: one f64 ``bincount`` of ``b * 256 + a`` per
    pair, then cast to f32. f64 sums of integer weights are exact and
    order independent. ``integer_weights`` rounds the weights first, as
    the kernel does."""
    w = torch.round(weights) if integer_weights else weights
    w = w.to(torch.float64)
    cols = ix.to(torch.int64)
    out = torch.empty((pair_a.shape[0], NBINS, NBINS), dtype=torch.float32, device=ix.device)
    for k, (a, b) in enumerate(zip(pair_a.tolist(), pair_b.tolist())):
        flat = cols[b] * NBINS + cols[a]
        out[k] = torch.bincount(flat, weights=w, minlength=NBINS * NBINS).view(NBINS, NBINS).to(torch.float32)
    return out


def pair_histograms(ix, weights, pair_a, pair_b, integer_weights=False):
    """(K, 256, 256) f32 weighted pair histograms.

    ix: (P, N) uint8 fine-bin indices; weights: (N,) f32; pair_a, pair_b:
    (K,) int32 parameter indices. With ``integer_weights`` (every weight an
    integer and the total below 2^31) the CUDA kernel accumulates in int32
    and the result is bit-exact; otherwise it accumulates f32 weights with
    atomics. CPU tensors take :func:`pair_histograms_plain`; CUDA tensors
    launch ``csrc/pair_hist.cu``.
    """
    if ix.device.type == "cpu":
        return pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights)
    _cuda.require_cuda(ix, dtype=torch.uint8)
    _cuda.require_cuda(weights, dtype=torch.float32)
    _cuda.require_cuda(pair_a, pair_b, dtype=torch.int32)
    if ix.dim() != 2 or weights.shape != (ix.shape[1],) or pair_a.dim() != 1 or pair_a.shape != pair_b.shape:
        raise ValueError(f"bad shapes: ix {tuple(ix.shape)}, weights {tuple(weights.shape)}, pairs {tuple(pair_a.shape)}")
    p, n = ix.shape
    k = pair_a.shape[0]
    if k > 65535:
        raise ValueError(f"at most 65535 pairs per launch, got {k}")
    acc = torch.int32 if integer_weights else torch.float32
    out = torch.zeros((k, NBINS, NBINS), dtype=acc, device=ix.device)
    if k == 0 or n == 0:
        return out.to(torch.float32)
    lo = min(int(pair_a.min()), int(pair_b.min()))
    hi = max(int(pair_a.max()), int(pair_b.max()))
    if lo < 0 or hi >= p:
        raise ValueError(f"pair indices must lie in [0, {p}), got [{lo}, {hi}]")
    # enough (chunk, half, pair) blocks for ~4 blocks per SM; a block
    # holds 128 KB of shared memory, so one block runs per SM at a time
    sms = torch.cuda.get_device_properties(ix.device).multi_processor_count
    n_chunks = max(1, min(-(-4 * sms // (2 * k)), -(-n // 65536)))
    _cuda.call(
        "pair_hist_launch", ix.device, ix.data_ptr(), weights.data_ptr(), pair_a.data_ptr(), pair_b.data_ptr(),
        n, k, n_chunks, int(bool(integer_weights)), out.data_ptr(),
    )
    pair_histograms.launches += 1
    return out.to(torch.float32) if integer_weights else out


pair_histograms.launches = 0
