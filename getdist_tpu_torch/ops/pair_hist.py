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
TPU's one-hot stacks (7.7 GB of traffic at 30 x 1M). Each entry keeps its
own launch counter.

* On uint8 rows (at most 256 bins, the three paths' case) all three launch
  the uint8 kernel of ``csrc/pair_hist.cu``: two blocks per pair, each
  owning half of its rows (128 KB of shared memory at 256 bins) and writing
  them as f32 (no zero fill, no flush, no conversion pass); four blocks of
  a quarter each for fractional weights, which add in 64-bit fixed point
  (:func:`fixed_scale`: a multiple of 2^-62 of max |w| * N, then integer
  adds, each as two native 32-bit shared adds with the low word's carry:
  the same bits on every call and every route, where f32 atomics would
  vary with the order), reading a and w only for the vectors whose b
  indices meet their rows. Each block reads a, b and w of every sample as 16-byte vectors;
  callers that know their weights are integers pass them as uint8 where
  they fit (:func:`narrow_weights`), a quarter of the f32 stream. Few pairs take the
  split route (:func:`split_plan`). K1's rows (30 MB at 30 x 1M) stay in
  L2; K4's sheared stack (139 MB at 1M) does not. K5 runs the kernel on
  :func:`grouped_work_list`: its padding slots are never scanned, and the
  TPU's grouping (one weighted b one-hot per step shared by 8 pairs on the
  MXU) would save only the b reads here (``PERF.md``).
* Rows that are not uint8 (int16 / int32: the fine grids past 256 bins of
  the public entry's regrids and of parity mode, or rows that a caller
  cannot narrow) take the wide kernels, by one of two routes that
  :func:`wide_plan` picks by shape. "bucket": a counting pass, a plan, a
  scatter pass that writes each sample once as a 16-bit in-slab key and its
  weight into its slab's segment, and one owner block per slab of R rows
  (R * nbins * 4 bytes <= 232,000 of shared memory) that bins its segment
  and writes its rows as f32; long segments split over several blocks,
  whose last writes the rows. "direct": one global atomic per sample into
  a zeroed accumulator, for few pair samples. Integer
  weights go in as uint8 where the caller narrows them; fractional ones add
  in the same fixed point as the uint8 kernel's (8-byte bins: half the rows
  a slab). The JAX package
  bins these grids with XLA one-hot matmuls
  (``getdist_tpu/ops/batched.py:_pair_hist_256(..., nbins=fine)``), not a
  Pallas kernel.

Fixed point across a process group: every entry takes ``scale`` = (max |w|
over every rank, the chain's length) from :func:`group_scale` and, with
``raw``, returns the int64 sums; the ranks all-reduce those exactly and
:func:`fixed_to_f32` converts once, so W ranks give one card's bits.

Convention (``getdist_tpu/ops/batched.py:_pair_hist_256``): ``out[k, b, a]``
sums the weights of samples with ``ix[pair_b[k]] == b`` and
``ix[pair_a[k]] == a`` (rows = b, cols = a); samples with an index outside
``[0, nbins)`` are dropped. A narrowing of rows never wraps such an index
into range (:func:`narrow_rows` keeps a row that holds one wider, and the
wide kernels drop it). No padding of N is needed.
"""

from __future__ import annotations

import functools
import threading
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from getdist_tpu_torch.ops import _cuda
from getdist_tpu_torch.ops import collectives as coll

__all__ = [
    "GROUP",
    "NBINS",
    "MAX_BINS",
    "fixed_scale",
    "fixed_to_f32",
    "group_pairs",
    "group_scale",
    "grouped_work_list",
    "narrow_rows",
    "narrow_weights",
    "pair_histograms",
    "pair_histograms_dynamic",
    "pair_histograms_grouped",
    "pair_histograms_grouped_plain",
    "pair_histograms_plain",
    "wide_plan",
]

NBINS = 256
MAX_BINS = 1024
GROUP = 8  # K5's pairs per group (the TPU kernel's group width)
SPLIT_MIN_SAMPLES = 1 << 16  # least samples per chunk on the split route
TILE_WORDS = 58000  # a wide slab's int32 / f32 words (csrc/pair_hist.cu kTileWords)
WIDE_MIN_CHUNK = 4096  # least samples per block of the wide scans
WIDE_MIN_PART = 8192  # least entries per bin block of the bucket route
WIDE_SLABS = 12  # slabs per pair histogram on the bucket route (fewer where a slab's tile would not fit)
DIRECT_MAX_SAMPLES = 1 << 21  # most pair samples (K * N) of the direct route
_WIDE_ROUTES = {"direct": 0, "bucket": 1}
_INDEX_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}


def _pow2(e):
    """2^e (an integer tensor) as f64, from its bits: exact, no libm."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def fixed_scale(scale):
    """(2^(62 - e), 2^(e - 62)) as f64 tensors, the fixed-point scale of
    ``scale`` = (wmax, count) and its inverse: max |w| * count < 2^e, so no
    sum of at most ``count`` weights rounded to multiples of 2^(e - 62)
    leaves int64, in any order (``csrc/pair_hist.cu:fixed_scale``). No host
    sync: ``wmax`` is a 0-d f32 tensor on the weights' device."""
    wmax, count = scale
    _, e = torch.frexp(wmax.to(torch.float64) * float(count))
    return _pow2(62 - e), _pow2(e - 62)


def group_scale(weights, count, group=None):
    """The fixed-point scale of ``weights`` in a group: (max |w| over the
    ranks (one ``pmax``; this rank's without a group), ``count``, the
    chain's length). Every rank of the group, and one card holding the
    whole chain, take the same scale, so their raw sums add up exactly."""
    return coll.pmax(torch.amax(torch.abs(weights.to(torch.float32))).reshape(()), group), int(count)


def _fixed_to_f32_plain(acc, scale):
    return (acc.to(torch.float64) * fixed_scale(scale)[1].to(acc.device)).to(torch.float32)


def fixed_to_f32(acc, scale):
    """int64 fixed-point sums of ``scale`` (:func:`fixed_scale`) as f32: the
    kernels' one conversion (``csrc/pair_hist.cu:out_value``; each sum
    rounded to f64, scaled by an exact power of two, rounded to f32 once).
    A CPU tensor takes this torch twin, a CUDA one launches
    ``pair_hist_fixed_convert``; both give the same bits."""
    if acc.device.type == "cpu":
        return _fixed_to_f32_plain(acc, scale)
    _cuda.require_cuda(acc, dtype=torch.int64)
    wmax = scale[0].to(torch.float32).reshape(1).contiguous()
    _cuda.require_cuda(wmax, dtype=torch.float32)
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    _cuda.call("pair_hist_fixed_convert", acc.device, acc.data_ptr(), out.data_ptr(), acc.numel(), wmax.data_ptr(),
               int(scale[1]))
    fixed_to_f32.launches += 1
    return out


def pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS, scale=None, raw=False):
    """Plain PyTorch version: one f64 ``bincount`` of ``b * nbins + a`` per
    pair for integer weights (exact and order independent), then cast to
    f32; ``integer_weights`` rounds the weights first, as the kernel does.
    Fractional weights add in the kernels' 64-bit fixed point: each weight
    rounded once to a multiple of 2^-62 of max |w| * N (or of ``scale``'s
    (wmax, count)), int64 sums, then :func:`fixed_to_f32`, or with ``raw``
    the int64 sums themselves."""
    integer = integer_weights or weights.dtype == torch.uint8
    if raw and integer:
        raise ValueError("raw fixed-point sums are for fractional weights")
    w = torch.round(weights) if integer_weights and weights.is_floating_point() else weights
    if integer:
        w = w.to(torch.float64)
    else:
        scale = scale if scale is not None else group_scale(weights, ix.shape[1])
        w = torch.round(w.to(torch.float32).to(torch.float64) * fixed_scale(scale)[0]).to(torch.int64)
    cols = ix.to(torch.int64)
    out = torch.empty((pair_a.shape[0], nbins, nbins), dtype=torch.float32 if integer else torch.int64,
                      device=ix.device)
    for k, (a, b) in enumerate(zip(pair_a.tolist(), pair_b.tolist())):
        ca, cb = cols[a], cols[b]
        inside = (ca >= 0) & (ca < nbins) & (cb >= 0) & (cb < nbins)
        flat = cb[inside] * nbins + ca[inside]
        if integer:
            sums = torch.bincount(flat, weights=w[inside], minlength=nbins * nbins).to(torch.float32)
        else:
            sums = torch.zeros(nbins * nbins, dtype=torch.int64, device=ix.device).index_add_(0, flat, w[inside])
        out[k] = sums.view(nbins, nbins)
    return out if integer or raw else _fixed_to_f32_plain(out, scale)


def split_plan(k, n, sms, parts=2):
    """Sample chunks per pair of the uint8 kernel: 1 (each of a pair's
    ``parts`` blocks, 2 with int32 bins and 4 with fixed-point ones, owns
    its part of the histogram and writes it) when the pairs' blocks fill
    the card's ``sms`` multiprocessors, else enough to fill it, each of at
    least :data:`SPLIT_MIN_SAMPLES` samples (the split route, which flushes
    with global atomics)."""
    if parts * k >= sms:
        return 1
    return max(1, min(-(-sms // (parts * k)), n // SPLIT_MIN_SAMPLES))


class WidePlan(NamedTuple):
    route: str  # "bucket" or "direct"
    rows: int  # R, histogram rows per slab
    slabs: int  # S = ceil(nbins / R)
    chunks: int  # sample chunks per pair of the count, scatter and direct kernels
    part: int  # most entries per block of the bucket route's bin kernel
    split_slots: int  # accumulator slabs: the most slabs that can hold more than `part` entries


@functools.lru_cache(maxsize=256)
def wide_plan(k, n, nbins, sms, bin_bytes=4):
    """The wide kernels' launch for K pairs of N samples at ``nbins`` on a
    card of ``sms`` multiprocessors, with bins of ``bin_bytes`` (4: int32,
    8: fixed point). The direct route for at most
    :data:`DIRECT_MAX_SAMPLES` pair samples (K * N), else the bucket route:
    about :data:`WIDE_SLABS` slabs of at most :data:`TILE_WORDS` 4-byte words
    (half as many 8-byte bins), about four scan blocks per multiprocessor,
    and bin blocks of at least :data:`WIDE_MIN_PART` entries, about two per
    multiprocessor's share of the K * N entries."""
    rows = max(1, min(TILE_WORDS * 4 // bin_bytes // nbins, -(-nbins // WIDE_SLABS)))
    slabs = -(-nbins // rows)
    chunks = max(1, min(-(-4 * sms // k), -(-n // WIDE_MIN_CHUNK)))
    part = max(WIDE_MIN_PART, 2 * -(-k * n // sms))
    route = "direct" if k * n <= DIRECT_MAX_SAMPLES else "bucket"
    return WidePlan(route, rows, slabs, chunks, part, min(k * slabs, k * n // part))


def _check_rows(ix, weights, pair_a, pair_b, nbins):
    """Check what the kernels take; (P, N, K)."""
    _cuda.require_cuda(ix, dtype=ix.dtype)
    if ix.dtype not in _INDEX_BYTES or (ix.dtype == torch.uint8 and nbins > 256):
        raise TypeError(f"index rows must be uint8 (at most 256 bins), int16 or int32, got {ix.dtype} at {nbins} bins")
    _cuda.require_cuda(weights, dtype=torch.uint8 if weights.dtype == torch.uint8 else torch.float32)
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
    """Integer weights for the kernels: a uint8 copy when every rounded
    weight lies in [0, 255] (the values the kernels would take from f32:
    they round as ``torch.round`` does), else ``weights`` itself. The
    uint8 kernel reads uint8 weights at a quarter of the f32 stream, which
    is 4 of the 6 bytes it reads a sample; the wide kernels' bucket route
    stores each sample in 4 bytes instead of 8. One readback; for callers
    that know their weights are integers."""
    lo, hi = torch.stack(list(torch.aminmax(weights))).tolist()
    if -0.5 <= lo and hi < 255.5:
        return torch.round(weights).to(torch.uint8)
    return weights


def narrow_rows(ix, nbins):
    """``ix`` in the narrowest index type of the kernels that holds every
    value: uint8 at most 256 bins, else int16, else int32 (one readback,
    none for uint8 rows). A narrowing never wraps an index outside
    ``[0, nbins)`` into range: a row that holds one at 256 bins stays int16,
    and the wide kernels drop the index."""
    if ix.dtype == torch.uint8 and nbins <= 256:
        return ix.contiguous()
    lo, hi = torch.stack(list(torch.aminmax(ix))).tolist() if ix.numel() else (0, 0)
    if nbins <= 256 and 0 <= lo and hi <= 255:
        return ix.to(torch.uint8).contiguous()
    if -(2**15) <= lo and hi < 2**15:
        return ix.to(torch.int16).contiguous()
    return ix.to(torch.int32).contiguous()


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


_local = threading.local()


def _pair_readback(device, k):
    """This thread's pinned host buffer (of at least 2 K int32, and its numpy
    view) and event for the pair indices' readback on ``device``."""
    cache = _local.__dict__.setdefault("readback", {})
    entry = cache.get(device.index)
    if entry is None or entry[0].numel() < 2 * k:
        host = torch.empty(max(2 * k, 1024), dtype=torch.int32, pin_memory=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))  # creates the event
        entry = cache[device.index] = (host, host.numpy(), event)
    return entry


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fixed_args(weights, n, integer, scale, raw):
    """(wmax tensor or None, count) of the kernels' fixed point: ``scale``,
    or this call's max |w| (a device ``amax``, no host sync) and ``n``; raw
    sums need fractional weights."""
    if integer:
        if raw:
            raise ValueError("raw fixed-point sums are for fractional weights")
        return None, 0
    wmax, count = scale if scale is not None else group_scale(weights, n)
    wmax = wmax.to(torch.float32).reshape(1).contiguous()
    _cuda.require_cuda(wmax, dtype=torch.float32)
    if int(count) < 1:
        raise ValueError(f"the fixed-point scale needs a positive sample count, got {count}")
    return wmax, int(count)


def _launch_uint8(ix, weights, pair_a, pair_b, integer_weights, nbins, inv_perm=None, scale=None, raw=False):
    """Launch the uint8 kernel of ``csrc/pair_hist.cu`` on checked uint8
    rows; (K, nbins, nbins) f32. uint8 weights are integer weights (int32
    bins); fractional ones go into 64-bit fixed point bins, order
    independent, so every call gives the same bits (scaled by ``scale``, or
    by this call's max |w| and N; with ``raw`` the int64 sums). With
    ``inv_perm``, ``pair_a`` / ``pair_b`` are a K5 plan's grp_a / grp_b and
    the kernel builds :func:`grouped_work_list` itself."""
    p, n = ix.shape
    k = pair_a.shape[0] if inv_perm is None else inv_perm.shape[0]
    integer = bool(integer_weights) or weights.dtype == torch.uint8
    wmax, count = _fixed_args(weights, n, integer, scale, raw)
    if weights.data_ptr() % 16:
        weights = weights.clone()  # the kernel reads the weights as 16-byte vectors
    n_split = split_plan(k, n, _sms(ix.device.index), parts=2 if integer else 4)
    shape = (k, nbins, nbins)
    acc = None
    if raw:  # the int64 sums are the result (the split route accumulates into them)
        out = (torch.zeros if n_split > 1 else torch.empty)(shape, dtype=torch.int64, device=ix.device)
        acc = out if n_split > 1 else None
    else:
        if not integer and n_split > 1:
            acc = torch.zeros(shape, dtype=torch.int64, device=ix.device)
        if n_split == 1 or not integer:
            out = torch.empty(shape, dtype=torch.float32, device=ix.device)
        else:
            out = torch.zeros(shape, dtype=torch.int32, device=ix.device)
    inv, slots = (0, 0) if inv_perm is None else (inv_perm.data_ptr(), pair_a.numel())
    _cuda.call(
        "pair_hist_uint8_launch", ix.device, ix.data_ptr(), p, weights.data_ptr(), weights.element_size(),
        pair_a.data_ptr(), pair_b.data_ptr(), inv, slots, n, k, nbins, n_split, int(integer),
        0 if wmax is None else wmax.data_ptr(), count, int(raw), 0 if acc is None else acc.data_ptr(),
        out.data_ptr(),
    )
    return out if raw else out.to(torch.float32)


def _launch_wide(ix, weights, pair_a, pair_b, integer_weights, nbins, scale=None, raw=False):
    """Launch the wide kernels of ``csrc/pair_hist.cu`` on checked int16 /
    int32 rows (pair indices are clamped in the kernels); (K, nbins, nbins)
    f32 (int64 with ``raw``) and the route taken. uint8 weights are integer
    weights; fractional ones add in the uint8 kernel's fixed point."""
    p, n = ix.shape
    k = pair_a.shape[0]
    integer = bool(integer_weights) or weights.dtype == torch.uint8
    wmax, count = _fixed_args(weights, n, integer, scale, raw)
    if weights.data_ptr() % 16:
        weights = weights.clone()  # the kernels read the weights as 16-byte vectors
    bin_bytes = 4 if integer else 8
    plan = wide_plan(k, n, nbins, _sms(ix.device.index), bin_bytes)
    out = torch.empty((k, nbins, nbins), dtype=torch.int64 if raw else torch.float32, device=ix.device)
    acc = None
    if not integer and plan.route == "direct":
        acc = out if raw else torch.empty((k, nbins, nbins), dtype=torch.int64, device=ix.device)
    pointers = (0, 0, 0)
    if plan.route == "bucket":
        # one buffer: the workspace, the entries (4 bytes with uint8 weights,
        # else 8) and the split slabs' accumulators, each 16-byte aligned
        ks = k * plan.slabs
        sizes = (8 * ks * (plan.chunks + 1) + 4 * (4 * ks + 2), k * n * (4 if weights.dtype == torch.uint8 else 8),
                 bin_bytes * plan.split_slots * plan.rows * nbins)
        offsets = [0]
        for size in sizes:
            offsets.append(offsets[-1] + -(-size // 16) * 16)
        scratch = torch.empty(offsets[-1], dtype=torch.uint8, device=ix.device)
        pointers = tuple(scratch.data_ptr() + off for off in offsets[:3])
    _cuda.call(
        "pair_hist_wide_launch", ix.device, ix.data_ptr(), _INDEX_BYTES[ix.dtype], p, weights.data_ptr(),
        weights.element_size(), pair_a.data_ptr(), pair_b.data_ptr(), n, k, nbins, _WIDE_ROUTES[plan.route],
        plan.rows, plan.chunks, plan.part, plan.split_slots, int(integer), 0 if wmax is None else wmax.data_ptr(),
        count, int(raw), 0 if acc is None else acc.data_ptr(), out.data_ptr(), *pointers,
    )
    return out, plan.route


def _launch(ix, weights, pair_a, pair_b, integer_weights, nbins, scale=None, raw=False):
    """Check the arguments and launch ``csrc/pair_hist.cu``: the uint8 kernel
    for uint8 rows, else the wide kernels. Returns (out, the route taken:
    "uint8", "bucket", "direct" or None)."""
    p, n, k = _check_rows(ix, weights, pair_a, pair_b, nbins)
    if k == 0 or n == 0:
        dtype = torch.int64 if raw else torch.float32
        return torch.zeros((k, nbins, nbins), dtype=dtype, device=ix.device), None
    # the pair indices' readback is queued before the launch and waited for
    # after it (the kernels clamp them)
    host, view, event = _pair_readback(ix.device, k)
    _cuda.call("pair_hist_readback", ix.device, pair_a.data_ptr(), pair_b.data_ptr(), k, host.data_ptr(),
               event.cuda_event)
    try:
        if ix.dtype == torch.uint8:
            out = _launch_uint8(ix, weights, pair_a, pair_b, integer_weights, nbins, scale=scale, raw=raw)
            route = "uint8"
        else:
            out, route = _launch_wide(ix, weights, pair_a, pair_b, integer_weights, nbins, scale=scale, raw=raw)
    finally:
        event.synchronize()
    lo, hi = int(view[: 2 * k].min()), int(view[: 2 * k].max())
    if lo < 0 or hi >= p:
        raise ValueError(f"pair indices must lie in [0, {p}), got [{lo}, {hi}]")
    return out, route


def _count(entry, route, nbins, integer_weights, k):
    """An entry's launch counters: ``launches`` (every launch),
    ``float_launches`` (those accumulating f32 weights, without
    ``integer_weights``; ``float_pairs`` counts them by pair count),
    ``wide_launches`` (the wide kernels') and ``wide_bins`` (the wide
    kernels' by bin count)."""
    entry.launches += int(route is not None)
    if route is not None and not integer_weights:
        entry.float_launches += 1
        entry.float_pairs[k] = entry.float_pairs.get(k, 0) + 1
    if route in ("bucket", "direct"):
        entry.wide_launches += 1
        entry.wide_bins[nbins] = entry.wide_bins.get(nbins, 0) + 1


def pair_histograms(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS, scale=None, raw=False):
    """(K, nbins, nbins) f32 weighted pair histograms, K1's entry (a static
    all-pairs list).

    ix: (P, N) fine-bin indices, uint8 (at most 256 bins), int16 or int32;
    weights: (N,) f32, or uint8 (integer weights); pair_a,
    pair_b: (K,) int32 parameter indices. With ``integer_weights`` (every
    weight an integer and the total below 2^31) the CUDA kernel accumulates
    in int32 and the result is bit-exact; otherwise it accumulates f32
    weights in 64-bit fixed point (the same bits on every call and route),
    scaled by ``scale`` (:func:`group_scale`; default this call's max |w|
    and N), and with ``raw`` returns the int64 sums (for a group's
    all-reduce, then :func:`fixed_to_f32`). CPU tensors take
    :func:`pair_histograms_plain`; CUDA tensors launch
    ``csrc/pair_hist.cu``: the uint8 kernel for uint8 rows, the wide
    kernels (:func:`wide_plan`) for int16/int32 rows. ``launches`` counts
    both, ``float_launches`` those with f32 weights (``float_pairs`` by pair
    count), ``wide_launches`` the wide kernels' and ``wide_bins`` theirs by
    bin count.
    """
    if ix.device.type == "cpu":
        return pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights, nbins, scale, raw)
    out, route = _launch(ix, weights, pair_a, pair_b, integer_weights, nbins, scale, raw)
    _count(pair_histograms, route, nbins, integer_weights, pair_a.shape[0])
    return out


def pair_histograms_dynamic(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS, scale=None, raw=False):
    """K4's entry: the same histograms for an arbitrary pair list (repeated
    a rows, unique b rows, in any order), with the arguments and kernels of
    :func:`pair_histograms`."""
    if ix.device.type == "cpu":
        return pair_histograms_plain(ix, weights, pair_a, pair_b, integer_weights, nbins, scale, raw)
    out, route = _launch(ix, weights, pair_a, pair_b, integer_weights, nbins, scale, raw)
    _count(pair_histograms_dynamic, route, nbins, integer_weights, pair_a.shape[0])
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


def pair_histograms_grouped_plain(ix, weights, grp_a, grp_b, inv_perm, int8_weights=False, scale=None, raw=False):
    """Plain PyTorch version of K5: the histograms of the slots ``inv_perm``
    picks, by :func:`pair_histograms_plain`."""
    pa, pb = grouped_work_list(grp_a, grp_b, inv_perm)
    return pair_histograms_plain(ix, weights, pa, pb, integer_weights=int8_weights, scale=scale, raw=raw)


def pair_histograms_grouped(ix, weights, grp_a, grp_b, inv_perm, int8_weights=False, scale=None, raw=False):
    """(K, 256, 256) f32 weighted pair histograms in the original pair order
    (rows = b, cols = a), K5's entry: b-anchored groups from
    :func:`group_pairs`.

    ix: (P, N) uint8 fine-bin indices; weights: (N,) f32 or uint8; grp_a
    (Kg, 8), grp_b (Kg,), inv_perm (K,) int32 with distinct entries. Plans
    of groups of :data:`GROUP` = 8 pairs only; other widths raise, on every
    device. ``int8_weights`` (every weight an integer, the total below
    2^31): int32 accumulation, bit-exact; otherwise fixed point (``scale``
    and ``raw`` as in :func:`pair_histograms`). CPU
    tensors take :func:`pair_histograms_grouped_plain`; CUDA tensors launch
    K1's uint8 kernel, which builds :func:`grouped_work_list` itself (one
    pair per picked slot, so the a = b padding slots are neither scanned
    nor written).
    """
    if grp_a.dim() != 2 or grp_a.shape[1] != GROUP:
        raise ValueError(f"K5 bins groups of {GROUP} pairs, got grp_a of shape {tuple(grp_a.shape)}")
    if ix.device.type == "cpu":
        return pair_histograms_grouped_plain(ix, weights, grp_a, grp_b, inv_perm, int8_weights, scale, raw)
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
        return torch.zeros((k, NBINS, NBINS), dtype=torch.int64 if raw else torch.float32, device=ix.device)
    if slots == 0:
        raise ValueError(f"inv_perm picks {k} slots of an empty plan")
    # how often each slot is picked (slots out of range are counted at the ends: they raise anyway)
    picked = torch.zeros(slots, dtype=torch.int32, device=ix.device)
    picked.index_add_(0, inv_perm.clamp(0, slots - 1), torch.ones_like(inv_perm))
    checks = [*torch.aminmax(torch.cat([grp_a.reshape(-1), grp_b])), *torch.aminmax(inv_perm), picked.max()]
    (lo, hi, lo_inv, hi_inv, most), out = _launch_then_check(
        checks, lambda: _launch_uint8(ix, weights, grp_a, grp_b, int8_weights, NBINS, inv_perm=inv_perm, scale=scale,
                                      raw=raw)
    )
    if lo < 0 or hi >= p:
        raise ValueError(f"group parameter indices must lie in [0, {p})")
    if lo_inv < 0 or hi_inv >= slots or most > 1:
        raise ValueError(f"inv_perm must hold {k} distinct slots in [0, {slots})")
    pair_histograms_grouped.launches += 1
    return out


pair_histograms.launches = 0
pair_histograms.float_launches = 0
pair_histograms.float_pairs = {}
pair_histograms.wide_launches = 0
pair_histograms.wide_bins = {}
pair_histograms_dynamic.launches = 0
pair_histograms_dynamic.float_launches = 0
pair_histograms_dynamic.float_pairs = {}
pair_histograms_dynamic.wide_launches = 0
pair_histograms_dynamic.wide_bins = {}
pair_histograms_grouped.launches = 0
fixed_to_f32.launches = 0
