"""Sharded sample reductions over a ``torch.distributed`` process group
(counterpart of ``getdist_tpu/parallel/reductions.py``).

Every function takes the group and this rank's LOCAL block of samples
(from :func:`getdist_tpu_torch.parallel.mesh.shard_samples`) and returns
the replicated result on every rank, as the JAX functions' ``shard_map``
with ``out_specs=P()`` does. Each rank reduces its block to the small
binned state (moments, 1D histograms, per-pair 2D histograms) and one
all-reduce combines them; the grid-local stages then run on every rank on
identical inputs. The collectives map as ``psum`` -> ``all_reduce(SUM)``,
``pmin`` / ``pmax`` -> ``all_reduce(MIN / MAX)`` and ``ppermute`` ->
``batch_isend_irecv`` (:mod:`getdist_tpu_torch.ops.collectives`).

The JAX module's ``_build_sharded`` / ``_PROGRAM_CACHE`` have no
counterpart: PyTorch runs eagerly and there is no program to compile or
cache. ``use_pallas`` / ``interpret`` have none either: CUDA tensors
always launch the port's kernels, CPU tensors take their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from getdist_tpu_torch.ops import batched
from getdist_tpu_torch.ops import collectives as coll
from getdist_tpu_torch.ops.batched import _gauss_kernel_2d, _hist_rows, _tensor
from getdist_tpu_torch.ops.pair_hist import (
    NBINS,
    fixed_to_f32,
    group_pairs,
    group_scale,
    narrow_rows,
    narrow_weights,
    pair_histograms,
    pair_histograms_dynamic,
    pair_histograms_grouped,
)

__all__ = [
    "sharded_moments",
    "sharded_hist_1d",
    "sharded_pair_hists",
    "sharded_triangle_step",
    "sharded_triangle_densities",
    "sharded_all_1d_densities",
    "sharded_all_2d_densities",
]


def _present(kwargs):
    return {k: v for k, v in kwargs.items() if v is not None}


def sharded_all_1d_densities(group, samples, weights, **kwargs):
    """:func:`getdist_tpu_torch.ops.batched.all_1d_densities` of a sharded
    chain, same keywords and result (on every rank); ``n_samples`` (the
    chain's length) is required. ``like_weights`` is this rank's block,
    sharded with the samples; every other array is the whole (replicated)
    one."""
    return batched.all_1d_densities(samples, weights, group=group, **_present(kwargs))


def sharded_all_2d_densities(group, samples, weights, pair_a, pair_b, neff, binmin, binmax, contours, **kwargs):
    """:func:`getdist_tpu_torch.ops.batched.all_2d_densities` of a sharded
    chain, same keywords and result (on every rank): each rank bins its
    block (K1) and the pair histograms, like-weighted ones included
    (``like_weights`` is this rank's block), are all-reduced."""
    return batched.all_2d_densities(
        samples, weights, pair_a, pair_b, neff, binmin, binmax, contours, group=group, **_present(kwargs)
    )


def sharded_moments(group, samples, weights):
    """Global weighted (norm, means (P,), cov (P, P)) of a sharded chain,
    the same values on any split (f64 partial sums cast once)."""
    return batched._weighted_moments(samples.T, weights, group, full_cov=True)


def sharded_hist_1d(group, ix, weights, nbins):
    """Global (P, nbins) weighted histograms of (P, N_local) index rows."""
    return _hist_rows(ix, weights, nbins, group)


def sharded_pair_hists(group, ix, weights, pair_a, pair_b, static_pairs=None, int8_weights=False):
    """Global (K, 256, 256) pair histograms (rows = b, cols = a) of
    (P, N_local) index rows in [0, 256).

    With ``static_pairs`` (a sequence of (a, b), the order of ``pair_a`` /
    ``pair_b``), each rank bins its block with the b-anchored kernel K5
    (:func:`group_pairs` plans the groups on the host); without, with the
    dynamic pair-list kernel K4 (rows narrowed by :func:`narrow_rows`).
    ``int8_weights``: every weight an integer (int32 accumulation,
    bit-exact), passed to the kernels as uint8 where they fit. Otherwise
    each rank bins in 64-bit fixed point on the group's scale (max |w| over
    the ranks and the ranks' samples, padding included) and returns the raw
    sums; one all-reduce, in place, combines the ranks (exactly: one card's
    bits) and one conversion gives f32."""
    device = ix.device
    weights = weights.to(torch.float32).contiguous()
    scale = None
    if not int8_weights:
        scale = group_scale(weights, batched._scale_count(ix.shape[1], group, None, device), group)
    if static_pairs is not None:
        grp_a, grp_b, inv = (_tensor(x, device, torch.int32) for x in group_pairs(static_pairs))
        w_hist = narrow_weights(weights) if int8_weights else weights
        hists = pair_histograms_grouped(ix.to(torch.uint8).contiguous(), w_hist, grp_a, grp_b, inv, int8_weights,
                                        scale=scale, raw=not int8_weights)
    else:
        pa, pb = (_tensor(x, device, torch.int32) for x in (pair_a, pair_b))
        index = narrow_rows(ix, NBINS)
        w_hist = narrow_weights(weights) if int8_weights and index.dtype == torch.uint8 else weights
        hists = pair_histograms_dynamic(index, w_hist, pa, pb, integer_weights=int8_weights, scale=scale,
                                        raw=not int8_weights)
    hists = coll.psum_(hists, group)
    return hists if int8_weights else fixed_to_f32(hists, scale)


def _conv2d_same_batch(grids, kernels, pad):
    """Batched 'same' linear convolution of (K, n, n) grids with centered
    (K, m, m) kernels by rFFT at (pad, pad); pad >= n + m // 2 keeps it
    free of wrap-around."""
    n, m = grids.shape[-1], kernels.shape[-1]
    half = (m - 1) // 2
    spec = torch.fft.rfft2(grids, s=(pad, pad)) * torch.fft.rfft2(kernels, s=(pad, pad))
    return torch.fft.irfft2(spec, s=(pad, pad))[:, half : half + n, half : half + n]


def sharded_triangle_step(group, samples, weights, pair_a, pair_b, fine_bins=128, winw=12):
    """One light triangle-density step (the JAX dry-run target): global
    ranges (min / max), fine binning with all-reduced 1D and pair
    histograms (K1 at ``fine_bins``), then rule-of-thumb smoothing on every
    rank. Returns peak-normalized (P, fine_bins) and (K, fine_bins,
    fine_bins) densities."""
    device, dtype = samples.device, samples.dtype
    pa, pb = (_tensor(x, device, torch.int64) for x in (pair_a, pair_b))
    cols = samples.T.contiguous()
    mins = coll.pmin(torch.amin(cols, dim=1), group)
    maxs = coll.pmax(torch.amax(cols, dim=1), group)
    norm, _, variances = batched._weighted_moments(cols, weights, group)
    sigmas = torch.sqrt(variances)

    span = maxs - mins
    binmin = mins - 0.1 * span
    width = (maxs + 0.1 * span - binmin) / (fine_bins - 1)
    ix = batched._fine_indices(cols, binmin, width, fine_bins)
    hist1 = _hist_rows(ix, weights, fine_bins, group)
    hist2 = pair_histograms(
        ix.to(torch.uint8 if fine_bins <= 256 else torch.int32), weights.to(torch.float32).contiguous(),
        pa.to(torch.int32), pb.to(torch.int32), nbins=fine_bins,
    )
    hist2 = coll.psum(hist2, group).to(dtype)

    neff_proxy = norm**2 / batched._psum64(torch.sum(weights * weights, dtype=torch.float64), group, dtype)
    h1_bins = torch.clamp(1.06 * sigmas / span * neff_proxy ** (-0.2) * fine_bins, 1.0, fine_bins / 4)
    pad = 2 * fine_bins
    freqs = torch.arange(pad // 2 + 1, dtype=dtype, device=device)
    mult = torch.exp(-2.0 * (np.pi * h1_bins[:, None] / pad) ** 2 * freqs[None, :] ** 2)
    dens1 = torch.fft.irfft(torch.fft.rfft(hist1, n=pad, dim=1) * mult, n=pad, dim=1)[:, :fine_bins]
    dens1 = dens1 / torch.amax(dens1, dim=1, keepdim=True)

    rx = torch.clamp(h1_bins[pa] * 0.8, 0.8, winw / 2.5)
    ry = torch.clamp(h1_bins[pb] * 0.8, 0.8, winw / 2.5)
    kernels = _gauss_kernel_2d(rx, ry, torch.zeros_like(rx), winw)
    pad2 = 1 << int(np.ceil(np.log2(fine_bins + 2 * winw)))
    dens2 = _conv2d_same_batch(hist2, kernels, pad2)
    dens2 = dens2 / torch.amax(dens2, dim=(1, 2), keepdim=True)
    return dens1, dens2


def sharded_triangle_densities(
    group,
    samples,
    weights,
    contours=(0.68, 0.95),
    limits_lo=None,
    limits_hi=None,
    periodic=None,
    like_weights=None,
    int8_weights=False,
    bandwidth_scale_1d=None,
    bandwidth_scale_2d=None,
    max_corr=0.95,
    enable_shear=True,
    export_hists=False,
    n_samples=None,
):
    """The fused triangle pipeline of a sharded chain: the algorithm of
    :func:`getdist_tpu_torch.ops.batched.triangle_densities` (ISJ
    bandwidths, N_eff from the halo-exchanged lag sums, sheared
    bandwidths, DFT convolutions, bias correction, contours) with every
    sample reduction all-reduced over ``group`` and the grid-local stages
    run on every rank. ``samples`` (N_local, P) and ``weights`` are this
    rank's block as tensors (numpy arrays go to the card). Weights
    accumulate as f32, or int32 with ``int8_weights`` (no bf16 split).
    ``n_samples``: the chain's length, required (:func:`shard_samples` pads
    the last blocks; see :func:`all_1d_densities`). Returns the (d1, d2)
    dicts, the same on every rank.

    ``limits_lo`` / ``limits_hi`` ((P,) hard prior bounds, NaN = none) and
    ``periodic`` ((P,) bools) are the whole chain's; ``like_weights``
    ((N_local,) per-sample likelihood weights) is this rank's block, as
    :func:`shard_samples` cuts the samples (a padding sample's like weight
    is 0). Their ranges (global min / max), active limits, histograms and
    moments are all-reduced before any grid-local stage reads them."""
    if not isinstance(samples, torch.Tensor):
        samples, weights = batched.prepare_chain(samples, weights)
    p = samples.shape[1]
    limits_lo, limits_hi, periodic = batched._limit_arrays(p, limits_lo, limits_hi, periodic)
    if like_weights is not None:
        like_weights = _tensor(like_weights, samples.device)
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)], np.int64).reshape(-1, 2)
    return batched._triangle_program(
        samples,
        weights,
        pairs[:, 0],
        pairs[:, 1],
        np.asarray(contours, np.float32),
        int8_weights,
        max_corr,
        enable_shear,
        bandwidth_scale_1d=bandwidth_scale_1d,
        bandwidth_scale_2d=bandwidth_scale_2d,
        group=group,
        n_samples=n_samples,
        export_hists=export_hists,
        limits_lo=limits_lo,
        limits_hi=limits_hi,
        periodic=periodic,
        like_weights=like_weights,
    )
