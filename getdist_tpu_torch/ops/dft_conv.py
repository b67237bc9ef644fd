"""Batched 2D linear convolution as DFT matrix products (kernels K2, K3).

Counterparts of ``getdist_tpu/ops/dft_conv.py:dft_conv_spectrum`` and
``dft_conv2d``, with the same API and semantics. For pair k with grid G
and kernel W (both placed at the origin of a P x P frame) the full linear
convolution is

    full = Re(B ((F G F) o (F W F)) B),   B = conj(F) / P,

with F the symmetric P x P DFT matrix; the result is the slice
``full[offset : offset + out_size]`` on both axes. P = 384 covers every
frame of the fused 2D program (256 + 4 * 30 + 1 = 377).

The CUDA kernels are ``csrc/dft_conv.cu``: FP32 FFMA throughput bounds
them (12 products of 2 P^3 flops per pair and convolution, against ~1 GB
of intermediates), so each stage is a shared-memory tiled SGEMM, with the
frame's zero padding in the operand loads and the output slice in the
last product's epilogue. The TPU kept the chain in VMEM; here the
intermediates go through device memory. The plain versions run the same
chain as batched ``torch.matmul`` in full FP32:
``torch.backends.cuda.matmul.allow_tf32`` is set to False before they run,
since TF32 keeps about three decimal digits.
The TPU's bf16 precision modes ("default", "split3") have no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from getdist_tpu_torch.ops import _cuda

__all__ = [
    "DEFAULT_PAD",
    "dft_matrices",
    "dft_conv_spectrum",
    "dft_conv_spectrum_plain",
    "dft_conv2d",
    "dft_conv2d_plain",
]

DEFAULT_PAD = 384


@functools.lru_cache(maxsize=8)
def _dft_mats_np(pad):
    j = np.arange(pad)
    ang = -2.0 * np.pi * np.outer(j, j) / pad
    fr = np.cos(ang)
    fi = np.sin(ang)
    return tuple(a.astype(np.float32) for a in (fr, fi, fr / pad, -fi / pad))


@functools.lru_cache(maxsize=8)
def _dft_mats_on(pad, device):
    return tuple(torch.from_numpy(a).to(device) for a in _dft_mats_np(pad))


def dft_matrices(pad, device):
    """(Fr, Fi, Br, Bi) f32 (pad, pad) on ``device``: F = Fr + i Fi is the
    symmetric DFT matrix and Br + i Bi = conj(F) / pad (computed in f64 and
    rounded, as the JAX package does)."""
    return _dft_mats_on(int(pad), torch.device(device))


def _fp32_matmuls():
    # the plain chain is the kernels' oracle: keep cuBLAS out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False


def _padded(x, pad):
    size = x.shape[-1]
    return F.pad(x.to(torch.float32), (0, pad - size, 0, pad - size))


def dft_conv_spectrum_plain(kernels, pad=DEFAULT_PAD):
    """Plain PyTorch version of :func:`dft_conv_spectrum`."""
    _fp32_matmuls()
    fr, fi, _, _ = dft_matrices(pad, kernels.device)
    kp = _padded(kernels, pad)
    tr = fr @ kp
    ti = fi @ kp
    return tr @ fr - ti @ fi, tr @ fi + ti @ fr


def dft_conv2d_plain(grids, ur, ui, out_size, offset, pad=DEFAULT_PAD):
    """Plain PyTorch version of :func:`dft_conv2d`."""
    _fp32_matmuls()
    fr, fi, br, bi = dft_matrices(pad, grids.device)
    gp = _padded(grids, pad)
    tr = fr @ gp
    ti = fi @ gp
    uhr = tr @ fr - ti @ fi
    uhi = tr @ fi + ti @ fr
    er = uhr * ur - uhi * ui
    ei = uhr * ui + uhi * ur
    t2r = br @ er - bi @ ei
    t2i = br @ ei + bi @ er
    full = t2r @ br - t2i @ bi
    return full[:, offset : offset + out_size, offset : offset + out_size].contiguous()


def _check_frame(pad, size, what):
    if pad % 128:
        raise ValueError(f"the CUDA kernels need a frame that is a multiple of 128, got {pad}")
    if size > pad:
        raise ValueError(f"{what} of size {size} does not fit the {pad} frame")


def dft_conv_spectrum(kernels, pad=DEFAULT_PAD):
    """Per-pair kernel spectra (ur, ui), each (K, pad, pad) f32.

    kernels: (K, m, m) f32 with the kernel origin at element [0, 0] of the
    frame (the convolution offset handles centering). CPU tensors take
    :func:`dft_conv_spectrum_plain`; CUDA tensors launch ``csrc/dft_conv.cu``.
    """
    if kernels.device.type == "cpu":
        return dft_conv_spectrum_plain(kernels, pad)
    _cuda.require_cuda(kernels, dtype=torch.float32)
    if kernels.dim() != 3 or kernels.shape[1] != kernels.shape[2]:
        raise ValueError(f"kernels must be (K, m, m), got {tuple(kernels.shape)}")
    k, m, _ = kernels.shape
    _check_frame(pad, m, "kernel")
    fr, fi, _, _ = dft_matrices(pad, kernels.device)
    tr, ti, ur, ui = (torch.empty((k, pad, pad), dtype=torch.float32, device=kernels.device) for _ in range(4))
    _cuda.call(
        "dft_spectrum_launch", kernels.device, kernels.data_ptr(), k, m, fr.data_ptr(), fi.data_ptr(),
        tr.data_ptr(), ti.data_ptr(), ur.data_ptr(), ui.data_ptr(), pad,
    )
    dft_conv_spectrum.launches += 1
    return ur, ui


def dft_conv2d(grids, ur, ui, out_size, offset, pad=DEFAULT_PAD):
    """Batched linear convolution against precomputed kernel spectra.

    grids: (K, I, I) f32 with I + m - 1 <= pad; ur, ui: (K, pad, pad) from
    :func:`dft_conv_spectrum`. Returns the (K, out_size, out_size) slice
    ``full[offset : offset + out_size]`` of each full convolution. CPU
    tensors take :func:`dft_conv2d_plain`; CUDA tensors launch
    ``csrc/dft_conv.cu``.
    """
    if grids.device.type == "cpu":
        return dft_conv2d_plain(grids, ur, ui, out_size, offset, pad)
    _cuda.require_cuda(grids, ur, ui, dtype=torch.float32)
    if grids.dim() != 3 or grids.shape[1] != grids.shape[2]:
        raise ValueError(f"grids must be (K, I, I), got {tuple(grids.shape)}")
    k, in_size, _ = grids.shape
    if ur.shape != (k, pad, pad) or ui.shape != (k, pad, pad):
        raise ValueError(f"spectra must be ({k}, {pad}, {pad}), got {tuple(ur.shape)} and {tuple(ui.shape)}")
    _check_frame(pad, in_size, "grid")
    if offset < 0 or out_size < 0 or offset + out_size > pad:
        raise ValueError(f"slice [{offset}, {offset + out_size}) outside the {pad} frame")
    fr, fi, br, bi = dft_matrices(pad, grids.device)
    scratch = [torch.empty((k, pad, pad), dtype=torch.float32, device=grids.device) for _ in range(4)]
    out = torch.empty((k, out_size, out_size), dtype=torch.float32, device=grids.device)
    _cuda.call(
        "dft_conv_launch", grids.device, grids.data_ptr(), k, in_size, fr.data_ptr(), fi.data_ptr(), br.data_ptr(),
        bi.data_ptr(), ur.data_ptr(), ui.data_ptr(), *(s.data_ptr() for s in scratch), out.data_ptr(), out_size,
        offset, pad,
    )
    dft_conv2d.launches += 1
    return out


dft_conv_spectrum.launches = 0
dft_conv2d.launches = 0
