"""Weighted pair histograms (kernels K1, K4 and K5 of the port).

Counterparts of three TPU schedules of the same computation in
``getdist_tpu/ops/pallas_kernels.py``:

* K1, ``pair_histograms_tiled`` (the tiled one-hot MXU kernel for a static
  all-pairs list, which ``ops/batched.py`` calls): :func:`pair_histograms`;
* K4, ``pair_histograms`` (the dynamic pair-list kernel, which parity
  mode calls for pair lists whose tile plan would mostly pad, such as the
  sheared lead/residual stacks where every b row is unique):
  :func:`pair_histograms_dynamic`;
* K5, ``pair_histograms_grouped`` (b-anchored groups of a static pair
  list, which the sharded path bins each shard with):
  :func:`pair_histograms_grouped`, with :func:`group_pairs`.

K1 and K4 launch the first CUDA kernel of ``csrc/pair_hist.cu``, K5 the
second; each entry keeps its own launch counter. On the H100 both kernels
are bound by shared-memory atomics (one per sample, pair and slab pass)
and by index reads that stay in L2; they bin directly instead of building
the TPU's one-hot stacks (7.7 GB of traffic at 30 x 1M), with one slab of
R rows of a pair's histogram per block (R * nbins * 4 bytes <= 128 KB of
shared memory; K5 holds the slab of all G pairs of a group), since a full
histogram tile exceeds a block's shared memory. K1/K4 take bin counts up
to 1024 and uint8, int16 or int32 index rows as the caller has them; K5
takes uint8 rows at 256 bins, as the TPU kernel did.

Convention (``getdist_tpu/ops/batched.py:_pair_hist_256``): ``out[k, b, a]``
sums the weights of samples with ``ix[pair_b[k]] == b`` and
``ix[pair_a[k]] == a`` (rows = b, cols = a); samples with an index outside
``[0, nbins)`` are dropped. No padding of N is needed.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from getdist_tpu_torch.ops import _cuda

__all__ = [
    "GROUP",
    "NBINS",
    "MAX_BINS",
    "group_pairs",
    "pair_histograms",
    "pair_histograms_dynamic",
    "pair_histograms_grouped",
    "pair_histograms_grouped_plain",
    "pair_histograms_plain",
]

NBINS = 256
MAX_BINS = 1024
GROUP = 8  # K5's pairs per group (csrc/pair_hist.cu kGroup)
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


def group_pairs(pairs, group=GROUP):
    """Group pairs by their b (row) parameter for the b-anchored kernel.

    Returns numpy (grp_a (Kg, group), grp_b (Kg,), inv_perm (K,)): each
    group shares one b; short groups are padded with a = b slots that the
    inverse permutation drops. Host-side, for static pair lists (the JAX
    package's ``pallas_kernels.group_pairs``)."""
    byb = defaultdict(list)
    for k, (a, b) in enumerate(pairs):
        byb[int(b)].append((int(a), k))
    grp_a, grp_b, orig = [], [], []
    for b, items in sorted(byb.items()):
        for c in range(0, len(items), group):
            chunk = items[c : c + group]
            pad = group - len(chunk)
            grp_b.append(b)
            grp_a.append([a for a, _ in chunk] + [b] * pad)
            orig.append([k for _, k in chunk] + [-1] * pad)
    inv = np.zeros(len(pairs), np.int32)
    for pos, k in enumerate(np.array(orig, np.int32).reshape(-1)):
        if k >= 0:
            inv[k] = pos
    return np.array(grp_a, np.int32), np.array(grp_b, np.int32), inv


def _slot_pairs(grp_a, grp_b, inv_perm):
    """(pair_a, pair_b) in output order: the slots ``inv_perm`` picks."""
    slots_a = grp_a.reshape(-1)
    slots_b = grp_b.repeat_interleave(grp_a.shape[1])
    return slots_a[inv_perm.long()], slots_b[inv_perm.long()]


def pair_histograms_grouped_plain(ix, weights, grp_a, grp_b, inv_perm, int8_weights=False):
    """Plain PyTorch version of K5: the histograms of the slots ``inv_perm``
    picks, by :func:`pair_histograms_plain`."""
    pa, pb = _slot_pairs(grp_a, grp_b, inv_perm)
    return pair_histograms_plain(ix, weights, pa, pb, integer_weights=int8_weights)


def pair_histograms_grouped(ix, weights, grp_a, grp_b, inv_perm, int8_weights=False):
    """(K, 256, 256) f32 weighted pair histograms in the original pair order
    (rows = b, cols = a), K5's entry: b-anchored groups from
    :func:`group_pairs`, whose slots share one read of the b column.

    ix: (P, N) uint8 fine-bin indices; weights: (N,) f32; grp_a (Kg, 8),
    grp_b (Kg,), inv_perm (K,) int32 with distinct entries. The kernel is
    built for groups of :data:`GROUP` = 8 pairs; other widths raise, on
    every device. ``int8_weights`` (every weight an integer, the total
    below 2^31): int32 accumulation, bit-exact; otherwise f32 atomics. No padding of N is needed. CPU tensors
    take :func:`pair_histograms_grouped_plain`; CUDA tensors launch the
    grouped kernel of ``csrc/pair_hist.cu``, which writes each slot straight
    to its pair's place (the a = b padding slots never reach the output).
    """
    if grp_a.dim() != 2 or grp_a.shape[1] != GROUP:
        raise ValueError(f"K5 bins groups of {GROUP} pairs, got grp_a of shape {tuple(grp_a.shape)}")
    if ix.device.type == "cpu":
        return pair_histograms_grouped_plain(ix, weights, grp_a, grp_b, inv_perm, int8_weights)
    _cuda.require_cuda(ix, dtype=torch.uint8)
    _cuda.require_cuda(weights, dtype=torch.float32)
    _cuda.require_cuda(grp_a, grp_b, inv_perm, dtype=torch.int32)
    if ix.dim() != 2 or weights.shape != (ix.shape[1],) or grp_b.shape != grp_a.shape[:1]:
        raise ValueError(
            f"bad shapes: ix {tuple(ix.shape)}, weights {tuple(weights.shape)}, grp_a {tuple(grp_a.shape)}, "
            f"grp_b {tuple(grp_b.shape)}"
        )
    p, n = ix.shape
    kg = grp_a.shape[0]
    k = inv_perm.shape[0]
    if kg > 65535:
        raise ValueError(f"at most 65535 groups per launch, got {kg}")
    acc = torch.int32 if int8_weights else torch.float32
    out = torch.zeros((k, NBINS, NBINS), dtype=acc, device=ix.device)
    if k == 0 or n == 0:
        return out.to(torch.float32)
    lo_a, lo_b, lo_inv, hi_a, hi_b, hi_inv = torch.stack(
        [grp_a.min(), grp_b.min(), inv_perm.min(), grp_a.max(), grp_b.max(), inv_perm.max()]
    ).tolist()
    if min(lo_a, lo_b) < 0 or max(hi_a, hi_b) >= p:
        raise ValueError(f"group parameter indices must lie in [0, {p})")
    # the output pair of each slot; distinct slots fill k of them
    slot_pair = torch.full((kg * GROUP,), -1, dtype=torch.int32, device=ix.device)
    if lo_inv >= 0 and hi_inv < kg * GROUP:
        slot_pair[inv_perm.long()] = torch.arange(k, dtype=torch.int32, device=ix.device)
    if lo_inv < 0 or hi_inv >= kg * GROUP or int((slot_pair >= 0).sum()) != k:
        raise ValueError(f"inv_perm must hold {k} distinct slots in [0, {kg * GROUP})")
    rows = _SLAB_BYTES // (4 * NBINS * GROUP)
    slabs = -(-NBINS // rows)
    sms = torch.cuda.get_device_properties(ix.device).multi_processor_count
    n_chunks = max(1, min(-(-4 * sms // (slabs * kg)), -(-n // 65536)))
    _cuda.call(
        "pair_hist_grouped_launch", ix.device, ix.data_ptr(), weights.data_ptr(), grp_a.data_ptr(), grp_b.data_ptr(),
        slot_pair.data_ptr(), n, kg, rows, n_chunks, int(bool(int8_weights)), out.data_ptr(),
    )
    pair_histograms_grouped.launches += 1
    return out.to(torch.float32) if int8_weights else out


pair_histograms.launches = 0
pair_histograms_dynamic.launches = 0
pair_histograms_grouped.launches = 0
