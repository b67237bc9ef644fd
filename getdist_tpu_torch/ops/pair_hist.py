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

All three bin directly with shared-memory atomics instead of building the
TPU's one-hot stacks (7.7 GB of traffic at 30 x 1M), from index rows that
stay in the H100's L2. Each entry keeps its own launch counter.

* K1 on uint8 rows (the three paths' case) and K5 launch the uint8 kernel
  of ``csrc/pair_hist.cu``: two blocks per pair, each owning half of the
  pair's rows (128 KB of shared memory at 256 bins) and writing them as f32
  (no zero fill, no flush, no conversion pass). It is bound by reading a, b
  and w of every sample twice (once per half) from L2: each thread reads 16
  samples of each as 16-byte vectors, and callers that know their weights
  are integers pass them as uint8 where they fit (:func:`narrow_weights`),
  a quarter of the f32 stream. Few pairs take the split route
  (:func:`split_plan`).
  K5 runs it on :func:`grouped_work_list`: its padding slots are never
  scanned, and the TPU's grouping (one weighted b one-hot per step shared
  by 8 pairs on the MXU) would save only the b reads here (``PERF.md``).
* K4, and K1 on int16/int32 rows (parity's fine grids past 256 bins),
  launch the slab kernel: one block per slab of R rows
  (R * nbins * 4 bytes <= 128 KB) and chunk of samples, flushed with
  global atomics into a zeroed output.

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
    "grouped_work_list",
    "narrow_weights",
    "pair_histograms",
    "pair_histograms_dynamic",
    "pair_histograms_grouped",
    "pair_histograms_grouped_plain",
    "pair_histograms_plain",
]

NBINS = 256
MAX_BINS = 1024
GROUP = 8  # K5's pairs per group (the TPU kernel's group width)
_SLAB_BYTES = 128 * 1024
SPLIT_MIN_SAMPLES = 1 << 16  # least samples per chunk on the split route
_INDEX_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS):
    """Plain PyTorch version: one f64 ``bincount`` of ``b * nbins + a`` per
    pair, then cast to f32. f64 sums of integer weights are exact and
    order independent. ``integer_weights`` rounds the weights first, as
    the kernel does."""
    w = torch.round(weights) if integer_weights and weights.is_floating_point() else weights
    w = w.to(torch.float64)
    cols = ix.to(torch.int64)
    out = torch.empty((pair_a.shape[0], nbins, nbins), dtype=torch.float32, device=ix.device)
    for k, (a, b) in enumerate(zip(pair_a.tolist(), pair_b.tolist())):
        ca, cb = cols[a], cols[b]
        inside = (ca >= 0) & (ca < nbins) & (cb >= 0) & (cb < nbins)
        flat = cb[inside] * nbins + ca[inside]
        out[k] = torch.bincount(flat, weights=w[inside], minlength=nbins * nbins).view(nbins, nbins).to(torch.float32)
    return out


def split_plan(k, n, sms):
    """Sample chunks per pair of the uint8 kernel: 1 (each of a pair's two
    blocks owns half of its histogram and writes it) when the pairs' blocks
    fill the card's ``sms`` multiprocessors, else enough to fill it, each
    of at least :data:`SPLIT_MIN_SAMPLES` samples (the split route, which
    flushes with global atomics)."""
    if 2 * k >= sms:
        return 1
    return max(1, min(-(-sms // (2 * k)), n // SPLIT_MIN_SAMPLES))


def _check_rows(ix, weights, pair_a, pair_b, nbins, slab):
    """Check what the kernels take; (P, N, K)."""
    _cuda.require_cuda(ix, dtype=ix.dtype)
    if ix.dtype not in _INDEX_BYTES or (ix.dtype == torch.uint8 and nbins > 256):
        raise TypeError(f"index rows must be uint8 (at most 256 bins), int16 or int32, got {ix.dtype} at {nbins} bins")
    uint8_weights = weights.dtype == torch.uint8 and ix.dtype == torch.uint8 and not slab
    _cuda.require_cuda(weights, dtype=torch.uint8 if uint8_weights else torch.float32)
    _cuda.require_cuda(pair_a, pair_b, dtype=torch.int32)
    if ix.dim() != 2 or weights.shape != (ix.shape[1],) or pair_a.dim() != 1 or pair_a.shape != pair_b.shape:
        raise ValueError(f"bad shapes: ix {tuple(ix.shape)}, weights {tuple(weights.shape)}, pairs {tuple(pair_a.shape)}")
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"nbins must lie in [1, {MAX_BINS}], got {nbins}")
    p, n = ix.shape
    k = pair_a.shape[0]
    if k > 65535:
        raise ValueError(f"at most 65535 pairs per launch, got {k}")
    return p, n, k


def narrow_weights(weights):
    """Integer weights for the uint8 kernel: a uint8 copy when every rounded
    weight lies in [0, 255] (the values the kernel would take from f32: it
    rounds as ``torch.round`` does), else ``weights`` itself. The kernel
    reads uint8 weights at a quarter of the f32 stream, which is 4 of the 6
    bytes it reads a sample. One readback; for callers that know their
    weights are integers."""
    lo, hi = torch.stack(list(torch.aminmax(weights))).tolist()
    if -0.5 <= lo and hi < 255.5:
        return torch.round(weights).to(torch.uint8)
    return weights


def _launch_then_check(checks, launch):
    """(values of the scalar tensors ``checks``, ``launch()``): their
    readback is queued before the launch and waited for after it, so the
    card does not idle for it. ``launch`` must be safe on the unchecked
    arguments (the uint8 kernel clamps its indices); the caller raises on
    what the values show. (Checks on a side stream, beside the kernel,
    measured slower: the kernel holds every SM's registers.)"""
    values = torch.stack([c.double() for c in checks])
    host = torch.empty(values.shape, dtype=torch.float64, pin_memory=True)
    host.copy_(values, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    out = launch()
    copied.synchronize()
    return host.tolist(), out


def _launch_uint8(ix, weights, pair_a, pair_b, integer_weights, nbins, inv_perm=None):
    """Launch the uint8 kernel of ``csrc/pair_hist.cu`` on checked uint8
    rows; (K, nbins, nbins) f32. uint8 weights are integer weights. With
    ``inv_perm``, ``pair_a`` / ``pair_b`` are a K5 plan's grp_a / grp_b and
    the kernel builds :func:`grouped_work_list` itself."""
    p, n = ix.shape
    k = pair_a.shape[0] if inv_perm is None else inv_perm.shape[0]
    integer = bool(integer_weights) or weights.dtype == torch.uint8
    if weights.data_ptr() % 16:
        weights = weights.clone()  # the kernel reads the weights as 16-byte vectors
    n_split = split_plan(k, n, torch.cuda.get_device_properties(ix.device).multi_processor_count)
    if n_split == 1:
        out = torch.empty((k, nbins, nbins), dtype=torch.float32, device=ix.device)
    else:
        out = torch.zeros((k, nbins, nbins), dtype=torch.int32 if integer else torch.float32, device=ix.device)
    inv, slots = (0, 0) if inv_perm is None else (inv_perm.data_ptr(), pair_a.numel())
    _cuda.call(
        "pair_hist_uint8_launch", ix.device, ix.data_ptr(), p, weights.data_ptr(), weights.element_size(),
        pair_a.data_ptr(), pair_b.data_ptr(), inv, slots, n, k, nbins, n_split, int(integer), out.data_ptr(),
    )
    return out.to(torch.float32)


def _launch_slab(ix, weights, pair_a, pair_b, integer_weights, nbins):
    """Launch the slab kernel of ``csrc/pair_hist.cu`` on checked rows and
    in-range pairs; (K, nbins, nbins) f32."""
    n = ix.shape[1]
    k = pair_a.shape[0]
    acc = torch.int32 if integer_weights else torch.float32
    out = torch.zeros((k, nbins, nbins), dtype=acc, device=ix.device)
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
    return out.to(torch.float32)


def _launch(ix, weights, pair_a, pair_b, integer_weights, nbins, slab):
    """Check the arguments and launch ``csrc/pair_hist.cu``: the slab kernel
    when ``slab`` or for int16/int32 rows (pair indices checked before the
    launch), else the uint8 kernel (checked after it). Returns (out,
    launched)."""
    p, n, k = _check_rows(ix, weights, pair_a, pair_b, nbins, slab)
    if k == 0 or n == 0:
        return torch.zeros((k, nbins, nbins), dtype=torch.float32, device=ix.device), False
    checks = torch.aminmax(torch.cat([pair_a, pair_b]))
    if slab or ix.dtype != torch.uint8:
        (lo, hi), out = torch.stack(checks).tolist(), None
    else:
        (lo, hi), out = _launch_then_check(
            checks, lambda: _launch_uint8(ix, weights, pair_a, pair_b, integer_weights, nbins)
        )
    if lo < 0 or hi >= p:
        raise ValueError(f"pair indices must lie in [0, {p}), got [{int(lo)}, {int(hi)}]")
    if out is None:
        out = _launch_slab(ix, weights, pair_a, pair_b, integer_weights, nbins)
    return out, True


def pair_histograms(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS):
    """(K, nbins, nbins) f32 weighted pair histograms, K1's entry (a static
    all-pairs list).

    ix: (P, N) fine-bin indices, uint8 (at most 256 bins), int16 or int32;
    weights: (N,) f32, or uint8 (integer weights) with uint8 rows; pair_a,
    pair_b: (K,) int32 parameter indices. With ``integer_weights`` (every
    weight an integer and the total below 2^31) the CUDA kernel accumulates
    in int32 and the result is bit-exact; otherwise it accumulates f32
    weights with atomics. CPU tensors take :func:`pair_histograms_plain`;
    CUDA tensors launch ``csrc/pair_hist.cu``: the uint8 kernel for uint8
    rows, the slab kernel for int16/int32 rows.
    """
    if ix.device.type == "cpu":
        return pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights, nbins)
    out, launched = _launch(ix, weights, pair_a, pair_b, integer_weights, nbins, slab=False)
    pair_histograms.launches += int(launched)
    return out


def pair_histograms_dynamic(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS):
    """K4's entry: the same histograms for an arbitrary pair list (repeated
    a rows, unique b rows), as :func:`pair_histograms` computes them, by the
    slab kernel (f32 weights)."""
    if ix.device.type == "cpu":
        return pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights, nbins)
    out, launched = _launch(ix, weights, pair_a, pair_b, integer_weights, nbins, slab=True)
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


def grouped_work_list(grp_a, grp_b, inv_perm):
    """K5's work list: (pair_a, pair_b) int32 (K,), the (a, b) of the slot
    ``inv_perm`` picks for each output pair, so the padding slots (a = b,
    picked by no pair) never enter it. Slot indices outside the plan are
    clamped into it (the caller checks them)."""
    slots = inv_perm.long().clamp(0, max(grp_a.numel() - 1, 0))
    return grp_a.reshape(-1)[slots], grp_b[slots // grp_a.shape[1]]


def pair_histograms_grouped_plain(ix, weights, grp_a, grp_b, inv_perm, int8_weights=False):
    """Plain PyTorch version of K5: the histograms of the slots ``inv_perm``
    picks, by :func:`pair_histograms_plain`."""
    pa, pb = grouped_work_list(grp_a, grp_b, inv_perm)
    return pair_histograms_plain(ix, weights, pa, pb, integer_weights=int8_weights)


def pair_histograms_grouped(ix, weights, grp_a, grp_b, inv_perm, int8_weights=False):
    """(K, 256, 256) f32 weighted pair histograms in the original pair order
    (rows = b, cols = a), K5's entry: b-anchored groups from
    :func:`group_pairs`.

    ix: (P, N) uint8 fine-bin indices; weights: (N,) f32 or uint8; grp_a
    (Kg, 8), grp_b (Kg,), inv_perm (K,) int32 with distinct entries. Plans
    of groups of :data:`GROUP` = 8 pairs only; other widths raise, on every
    device. ``int8_weights`` (every weight an integer, the total below
    2^31): int32 accumulation, bit-exact; otherwise f32 atomics. CPU
    tensors take :func:`pair_histograms_grouped_plain`; CUDA tensors launch
    K1's uint8 kernel, which builds :func:`grouped_work_list` itself (one
    pair per picked slot, so the a = b padding slots are neither scanned
    nor written).
    """
    if grp_a.dim() != 2 or grp_a.shape[1] != GROUP:
        raise ValueError(f"K5 bins groups of {GROUP} pairs, got grp_a of shape {tuple(grp_a.shape)}")
    if ix.device.type == "cpu":
        return pair_histograms_grouped_plain(ix, weights, grp_a, grp_b, inv_perm, int8_weights)
    _cuda.require_cuda(ix, dtype=torch.uint8)
    _cuda.require_cuda(weights, dtype=torch.uint8 if weights.dtype == torch.uint8 else torch.float32)
    _cuda.require_cuda(grp_a, grp_b, inv_perm, dtype=torch.int32)
    if ix.dim() != 2 or weights.shape != (ix.shape[1],) or grp_b.shape != grp_a.shape[:1] or inv_perm.dim() != 1:
        raise ValueError(
            f"bad shapes: ix {tuple(ix.shape)}, weights {tuple(weights.shape)}, grp_a {tuple(grp_a.shape)}, "
            f"grp_b {tuple(grp_b.shape)}, inv_perm {tuple(inv_perm.shape)}"
        )
    p, n = ix.shape
    k = inv_perm.shape[0]
    slots = grp_a.numel()
    if k > 65535:
        raise ValueError(f"at most 65535 pairs per launch, got {k}")
    if k == 0 or n == 0:
        return torch.zeros((k, NBINS, NBINS), dtype=torch.float32, device=ix.device)
    if slots == 0:
        raise ValueError(f"inv_perm picks {k} slots of an empty plan")
    # how often each slot is picked (slots out of range are counted at the ends: they raise anyway)
    picked = torch.zeros(slots, dtype=torch.int32, device=ix.device)
    picked.index_add_(0, inv_perm.clamp(0, slots - 1), torch.ones_like(inv_perm))
    checks = [*torch.aminmax(torch.cat([grp_a.reshape(-1), grp_b])), *torch.aminmax(inv_perm), picked.max()]
    (lo, hi, lo_inv, hi_inv, most), out = _launch_then_check(
        checks, lambda: _launch_uint8(ix, weights, grp_a, grp_b, int8_weights, NBINS, inv_perm=inv_perm)
    )
    if lo < 0 or hi >= p:
        raise ValueError(f"group parameter indices must lie in [0, {p})")
    if lo_inv < 0 or hi_inv >= slots or most > 1:
        raise ValueError(f"inv_perm must hold {k} distinct slots in [0, {slots})")
    pair_histograms_grouped.launches += 1
    return out


pair_histograms.launches = 0
pair_histograms_dynamic.launches = 0
pair_histograms_grouped.launches = 0
