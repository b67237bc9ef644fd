"""Batched 2D linear convolution as DFT matrix products (kernels K2, K3).

Counterparts of ``getdist_tpu/ops/dft_conv.py:dft_conv_spectrum`` and
``dft_conv2d``, with the same API and semantics. For pair k with grid G
and kernel W (both placed at the origin of a P x P frame) the full linear
convolution is

    full = Re(B ((F G F) o (F W F)) B),   B = conj(F) / P,

with F the symmetric P x P DFT matrix; the result is the slice
``full[offset : offset + out_size]`` on both axes. P = 384 covers every
frame of the fused 2D program (256 + 4 * 30 + 1 = 377); parity mode sizes
the frame to its convolution, any multiple of 128 (up to ~2944 for a
960-bin group at its widest window).

The CUDA kernels are ``csrc/dft_conv.cu``: each stage is a shared-memory
tiled GEMM over the whole frame (6 products of 2 P^3 flops per pair for
the spectra, 12 for a convolution), with the frame's zero padding in the
operand loads and the output slice in the last product's epilogue. They
multiply through that padding: the function itself needs only the
contractions over the kernel's or grid's support and the output window
(about 1/9 of the spectrum's flops and 3/5 of the convolution's at the
fused path's shapes). Inputs are f32 (the fused path,
FFMA) or f64 (parity mode, DFMA); the DFT matrices are built in f64 on the
host and rounded to the input type. The TPU kept the chain in VMEM; here
the intermediates go through device memory, and a batch whose four
(K, P, P) scratch arrays exceed :data:`SCRATCH_BYTES` is split over K.
The plain versions run the same chain as batched ``torch.matmul`` in the
input type with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` is set
to False before they run, since TF32 keeps about three decimal digits).
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
    "SCRATCH_BYTES",
    "frame_for",
    "dft_matrices",
    "dft_conv_spectrum",
    "dft_conv_spectrum_plain",
    "dft_conv2d",
    "dft_conv2d_plain",
]

DEFAULT_PAD = 384
SCRATCH_BYTES = 4 << 30  # the conv's four (K, P, P) scratch arrays, per launch

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def frame_for(size):
    """The DFT frame for a linear convolution of ``size`` samples: at least
    :data:`DEFAULT_PAD`, rounded up to a multiple of 128."""
    return max(DEFAULT_PAD, -(-int(size) // 128) * 128)


@functools.lru_cache(maxsize=8)
def _dft_mats_np(pad):
    j = np.arange(pad)
    ang = -2.0 * np.pi * np.outer(j, j) / pad
    fr = np.cos(ang)
    fi = np.sin(ang)
    return fr, fi, fr / pad, -fi / pad


@functools.lru_cache(maxsize=8)
def _dft_mats_on(pad, device, dtype):
    return tuple(torch.from_numpy(a.astype(_NP[dtype])).to(device) for a in _dft_mats_np(pad))


def dft_matrices(pad, device, dtype=torch.float32):
    """(Fr, Fi, Br, Bi) (pad, pad) of ``dtype`` on ``device``: F = Fr + i Fi is
    the symmetric DFT matrix and Br + i Bi = conj(F) / pad (computed in f64
    and rounded, as the JAX package does)."""
    return _dft_mats_on(int(pad), torch.device(device), dtype)


def _highest_matmuls():
    # the plain chain is the kernels' oracle: keep cuBLAS out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False


def _padded(x, pad):
    size = x.shape[-1]
    return F.pad(x, (0, pad - size, 0, pad - size))


def dft_conv_spectrum_plain(kernels, pad=DEFAULT_PAD):
    """Plain PyTorch version of :func:`dft_conv_spectrum`."""
    _highest_matmuls()
    fr, fi, _, _ = dft_matrices(pad, kernels.device, kernels.dtype)
    kp = _padded(kernels, pad)
    tr = fr @ kp
    ti = fi @ kp
    return tr @ fr - ti @ fi, tr @ fi + ti @ fr


def dft_conv2d_plain(grids, ur, ui, out_size, offset, pad=DEFAULT_PAD):
    """Plain PyTorch version of :func:`dft_conv2d`."""
    _highest_matmuls()
    fr, fi, br, bi = dft_matrices(pad, grids.device, grids.dtype)
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


def _require_float(*tensors):
    dtype = tensors[0].dtype
    if dtype not in _NP:
        raise TypeError(f"expected f32 or f64 tensors, got {dtype}")
    _cuda.require_cuda(*tensors, dtype=dtype)
    return int(dtype == torch.float64)


def _chunks(k, pad, itemsize):
    """Batch slices whose four (K, P, P) scratch arrays fit SCRATCH_BYTES."""
    step = max(1, SCRATCH_BYTES // (4 * pad * pad * itemsize))
    return [(s, min(s + step, k)) for s in range(0, k, step)]


def dft_conv_spectrum(kernels, pad=DEFAULT_PAD):
    """Per-pair kernel spectra (ur, ui), each (K, pad, pad) of the input type.

    kernels: (K, m, m) f32 or f64 with the kernel origin at element [0, 0]
    of the frame (the convolution offset handles centering). CPU tensors
    take :func:`dft_conv_spectrum_plain`; CUDA tensors launch
    ``csrc/dft_conv.cu``.
    """
    if kernels.device.type == "cpu":
        return dft_conv_spectrum_plain(kernels, pad)
    is_double = _require_float(kernels)
    if kernels.dim() != 3 or kernels.shape[1] != kernels.shape[2]:
        raise ValueError(f"kernels must be (K, m, m), got {tuple(kernels.shape)}")
    k, m, _ = kernels.shape
    _check_frame(pad, m, "kernel")
    dtype, device = kernels.dtype, kernels.device
    fr, fi, _, _ = dft_matrices(pad, device, dtype)
    ur, ui = (torch.empty((k, pad, pad), dtype=dtype, device=device) for _ in range(2))
    for lo, hi in _chunks(k, pad, kernels.element_size()):
        tr, ti = (torch.empty((hi - lo, pad, pad), dtype=dtype, device=device) for _ in range(2))
        _cuda.call(
            "dft_spectrum_launch", device, is_double, kernels[lo:hi].data_ptr(), hi - lo, m, fr.data_ptr(),
            fi.data_ptr(), tr.data_ptr(), ti.data_ptr(), ur[lo:hi].data_ptr(), ui[lo:hi].data_ptr(), pad,
        )
        dft_conv_spectrum.launches += 1
    return ur, ui


def dft_conv2d(grids, ur, ui, out_size, offset, pad=DEFAULT_PAD):
    """Batched linear convolution against precomputed kernel spectra.

    grids: (K, I, I) f32 or f64 with I + m - 1 <= pad; ur, ui: (K, pad, pad)
    from :func:`dft_conv_spectrum`, of the same type. Returns the
    (K, out_size, out_size) slice ``full[offset : offset + out_size]`` of
    each full convolution. CPU tensors take :func:`dft_conv2d_plain`; CUDA
    tensors launch ``csrc/dft_conv.cu``.
    """
    if grids.device.type == "cpu":
        return dft_conv2d_plain(grids, ur, ui, out_size, offset, pad)
    is_double = _require_float(grids, ur, ui)
    if grids.dim() != 3 or grids.shape[1] != grids.shape[2]:
        raise ValueError(f"grids must be (K, I, I), got {tuple(grids.shape)}")
    k, in_size, _ = grids.shape
    if ur.shape != (k, pad, pad) or ui.shape != (k, pad, pad):
        raise ValueError(f"spectra must be ({k}, {pad}, {pad}), got {tuple(ur.shape)} and {tuple(ui.shape)}")
    _check_frame(pad, in_size, "grid")
    if offset < 0 or out_size < 0 or offset + out_size > pad:
        raise ValueError(f"slice [{offset}, {offset + out_size}) outside the {pad} frame")
    dtype, device = grids.dtype, grids.device
    fr, fi, br, bi = dft_matrices(pad, device, dtype)
    out = torch.empty((k, out_size, out_size), dtype=dtype, device=device)
    for lo, hi in _chunks(k, pad, grids.element_size()):
        scratch = [torch.empty((hi - lo, pad, pad), dtype=dtype, device=device) for _ in range(4)]
        _cuda.call(
            "dft_conv_launch", device, is_double, grids[lo:hi].data_ptr(), hi - lo, in_size, fr.data_ptr(),
            fi.data_ptr(), br.data_ptr(), bi.data_ptr(), ur[lo:hi].data_ptr(), ui[lo:hi].data_ptr(),
            *(s.data_ptr() for s in scratch), out[lo:hi].data_ptr(), out_size, offset, pad,
        )
        dft_conv2d.launches += 1
    return out


dft_conv_spectrum.launches = 0
dft_conv2d.launches = 0
