"""Weighted histograms on a torch device (counterpart of
``getdist_tpu/ops/binning.py``).

Scatter-adds of sample weights into fine bins, on the device of the
tensors given: the host density paths' ``np.bincount`` (``MCSamples``
``_bincount`` / ``_bincount2d`` under ``GETDIST_TPU_TORCH_DEVICE_OPS=1``)
and the N-D histograms. Integer weights held in f64 sum exactly in any
order, so their histograms equal ``np.bincount``'s bit for bit.
"""

import torch

__all__ = ["weighted_bincount", "weighted_bincount_2d", "bin_indices_1d"]


def weighted_bincount(indices, weights, length):
    """Sum of weights per bin, ``np.bincount(indices, weights,
    minlength=length)`` (the indices must lie in ``[0, length)``)."""
    out = torch.zeros(length, dtype=weights.dtype, device=weights.device)
    return out.index_add_(0, indices.to(torch.int64), weights)


def weighted_bincount_2d(ix, iy, weights, xsize, ysize):
    """2D weighted histogram, (ysize, xsize) with y the leading axis."""
    flat = ix.to(torch.int64) + iy.to(torch.int64) * xsize
    return weighted_bincount(flat, weights, xsize * ysize).reshape(ysize, xsize)


def bin_indices_1d(values, binmin, fine_width, nbins):
    """Fine-bin index per sample, ``int((v - binmin) / width + 0.5)``
    clipped into ``[0, nbins)``."""
    ix = ((values - binmin) / fine_width + 0.5).to(torch.int32)
    return ix.clamp(0, nbins - 1)
