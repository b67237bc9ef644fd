"""Weighted pair histograms (kernels K1 and K4 of the port).

Counterparts of two TPU schedules of the same computation in
``getdist_tpu/ops/pallas_kernels.py``:

* K1, ``pair_histograms_tiled`` (the tiled one-hot MXU kernel for a static
  all-pairs list, which ``ops/batched.py`` calls): :func:`pair_histograms`;
* K4, ``pair_histograms`` (the dynamic pair-list kernel, which parity
  mode calls for pair lists whose tile plan would mostly pad, such as the
  sheared lead/residual stacks where every b row is unique):
  :func:`pair_histograms_dynamic`.

Both entries launch the one CUDA kernel of ``csrc/pair_hist.cu`` and keep
their own launch counters. On the H100 it is bound by shared-memory
atomics (one per sample, pair and slab pass) and by index reads that stay
in L2; it bins directly instead of building the TPU's one-hot stacks (7.7
GB of traffic at 30 x 1M), with one slab of R rows of a pair's histogram
per block (R * nbins * 4 bytes <= 128 KB of shared memory), since a full
histogram tile exceeds a block's shared memory. Bin counts up to 1024 and
uint8, int16 or int32 index rows are taken as the caller has them.

Convention (``getdist_tpu/ops/batched.py:_pair_hist_256``): ``out[k, b, a]``
sums the weights of samples with ``ix[pair_b[k]] == b`` and
``ix[pair_a[k]] == a`` (rows = b, cols = a); samples with an index outside
``[0, nbins)`` are dropped. No padding of N is needed.
"""

from __future__ import annotations

import torch

from getdist_tpu_torch.ops import _cuda

__all__ = ["NBINS", "MAX_BINS", "pair_histograms", "pair_histograms_dynamic", "pair_histograms_plain"]

NBINS = 256
MAX_BINS = 1024
_SLAB_BYTES = 128 * 1024
_INDEX_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS):
    """Plain PyTorch version: one f64 ``bincount`` of ``b * nbins + a`` per
    pair, then cast to f32. f64 sums of integer weights are exact and
    order independent. ``integer_weights`` rounds the weights first, as
    the kernel does."""
    w = torch.round(weights) if integer_weights else weights
    w = w.to(torch.float64)
    cols = ix.to(torch.int64)
    out = torch.empty((pair_a.shape[0], nbins, nbins), dtype=torch.float32, device=ix.device)
    for k, (a, b) in enumerate(zip(pair_a.tolist(), pair_b.tolist())):
        ca, cb = cols[a], cols[b]
        inside = (ca >= 0) & (ca < nbins) & (cb >= 0) & (cb < nbins)
        flat = cb[inside] * nbins + ca[inside]
        out[k] = torch.bincount(flat, weights=w[inside], minlength=nbins * nbins).view(nbins, nbins).to(torch.float32)
    return out


def _launch(ix, weights, pair_a, pair_b, integer_weights, nbins):
    """Check the arguments and launch ``csrc/pair_hist.cu``."""
    _cuda.require_cuda(ix, dtype=ix.dtype)
    if ix.dtype not in _INDEX_BYTES or (ix.dtype == torch.uint8 and nbins > 256):
        raise TypeError(f"index rows must be uint8 (at most 256 bins), int16 or int32, got {ix.dtype} at {nbins} bins")
    _cuda.require_cuda(weights, dtype=torch.float32)
    _cuda.require_cuda(pair_a, pair_b, dtype=torch.int32)
    if ix.dim() != 2 or weights.shape != (ix.shape[1],) or pair_a.dim() != 1 or pair_a.shape != pair_b.shape:
        raise ValueError(f"bad shapes: ix {tuple(ix.shape)}, weights {tuple(weights.shape)}, pairs {tuple(pair_a.shape)}")
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"nbins must lie in [1, {MAX_BINS}], got {nbins}")
    p, n = ix.shape
    k = pair_a.shape[0]
    if k > 65535:
        raise ValueError(f"at most 65535 pairs per launch, got {k}")
    acc = torch.int32 if integer_weights else torch.float32
    out = torch.zeros((k, nbins, nbins), dtype=acc, device=ix.device)
    if k == 0 or n == 0:
        return out.to(torch.float32), False
    lo = min(int(pair_a.min()), int(pair_b.min()))
    hi = max(int(pair_a.max()), int(pair_b.max()))
    if lo < 0 or hi >= p:
        raise ValueError(f"pair indices must lie in [0, {p}), got [{lo}, {hi}]")
    rows = min(nbins, _SLAB_BYTES // (4 * nbins))
    slabs = -(-nbins // rows)
    # enough (chunk, slab, pair) blocks for ~4 blocks per SM; a block holds
    # up to 128 KB of shared memory, so one block runs per SM at a time
    sms = torch.cuda.get_device_properties(ix.device).multi_processor_count
    n_chunks = max(1, min(-(-4 * sms // (slabs * k)), -(-n // 65536)))
    _cuda.call(
        "pair_hist_launch", ix.device, ix.data_ptr(), _INDEX_BYTES[ix.dtype], weights.data_ptr(), pair_a.data_ptr(),
        pair_b.data_ptr(), n, k, nbins, rows, n_chunks, int(bool(integer_weights)), out.data_ptr(),
    )
    return (out.to(torch.float32) if integer_weights else out), True


def pair_histograms(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS):
    """(K, nbins, nbins) f32 weighted pair histograms, K1's entry (a static
    all-pairs list).

    ix: (P, N) fine-bin indices, uint8 (at most 256 bins), int16 or int32;
    weights: (N,) f32; pair_a, pair_b: (K,) int32 parameter indices. With
    ``integer_weights`` (every weight an integer and the total below 2^31)
    the CUDA kernel accumulates in int32 and the result is bit-exact;
    otherwise it accumulates f32 weights with atomics. CPU tensors take
    :func:`pair_histograms_plain`; CUDA tensors launch ``csrc/pair_hist.cu``.
    """
    if ix.device.type == "cpu":
        return pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights, nbins)
    out, launched = _launch(ix, weights, pair_a, pair_b, integer_weights, nbins)
    pair_histograms.launches += int(launched)
    return out


def pair_histograms_dynamic(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS):
    """K4's entry: the same histograms for an arbitrary pair list (repeated
    a rows, unique b rows), as :func:`pair_histograms` computes them."""
    if ix.device.type == "cpu":
        return pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights, nbins)
    out, launched = _launch(ix, weights, pair_a, pair_b, integer_weights, nbins)
    pair_histograms_dynamic.launches += int(launched)
    return out


pair_histograms.launches = 0
pair_histograms_dynamic.launches = 0
