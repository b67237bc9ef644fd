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

The CUDA kernels are ``csrc/dft_conv.cu``, on the tensor cores, and
every stage contracts over the kernel's or grid's support, or over the
frame only for the output window's rows and columns:

    spectrum:  T = F[:h, :m] W,  U = T F[:m, :]
    conv:      T = F[:h, :I] G,  E = (T F[:I, :]) o U,
               T2 = (B[w, :] E)[:, :h],  out = Re(T2 B[:h, w])

with w the window ``[offset, offset + out_size)`` and h = P/2 + 1: the
spectra of real inputs are Hermitian, so their rows 0..P/2 determine
them (the kernels write the other rows as the conjugate mirror), and so
are the rows of T2, whose columns 0..P/2 carry the real part (the inner
ones doubled). Inputs are f32 (the fused path) or f64 (parity mode); the
DFT matrices are built in f64 on the host and rounded to the input type.
f32 runs on ``wgmma`` as three TF32 passes, the data split in registers
and the DFT matrices split once per frame into tf32 hi and lo planes
(:func:`tf32_planes`) that TMA loads as they are; f64 runs on DMMA.
The TPU kept the chain in VMEM; here the intermediates go through device
memory: per pair, the spectrum's T (h x m) and the convolution's T
(h x I), E and T2, each complex, with leading dimensions rounded up to a
multiple of 4 (16-byte rows). In f32 E is kept as the next stage's
operand, E's rows k and P - k paired (h x 2 s, s = h rounded up to a
multiple of 32), and T2 is out_size x h; in f64 E is P x P and T2 is
stored as T2^T (h x out_size). A batch whose scratch exceeds
:data:`SCRATCH_BYTES` (counted as f64's, the larger) is split over K.

The plain versions run the full-frame chain (through the zero padding) as
batched ``torch.matmul`` in the input type with TF32 off
(inside ``_cuda.full_fp32_matmuls``, which turns
``torch.backends.cuda.matmul.allow_tf32`` off and restores the caller's
value, since TF32 keeps about three decimal digits).
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
    "spectrum_scratch",
    "conv_scratch",
    "frame_for",
    "dft_matrices",
    "tf32_planes",
    "dft_conv_spectrum",
    "dft_conv_spectrum_plain",
    "dft_conv2d",
    "dft_conv2d_plain",
]

DEFAULT_PAD = 384
SCRATCH_BYTES = 4 << 30  # a launch's intermediates (spectrum_scratch / conv_scratch per pair)

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


def _tf32(x):
    """Round f32 to TF32 (10 stored mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    return ((x.view(np.int32) + 0x1000) & -0x2000).view(np.float32)


@functools.lru_cache(maxsize=8)
def _tf32_planes_on(pad, device):
    mats = [a.astype(np.float32) for a in _dft_mats_np(pad)]
    fi_nyquist = mats[1].copy()
    fi_nyquist[0] = mats[0][pad // 2]
    planes = []
    for x in mats + [fi_nyquist]:
        hi = _tf32(x)
        planes += [hi, _tf32(x - hi)]
    return torch.from_numpy(np.stack(planes)).to(device)


def tf32_planes(pad, device):
    """(10, pad, pad) f32 on ``device``: the TF32 hi and lo parts (hi =
    rna(x), lo = rna(x - hi)) of Fr, Fi, Br and Bi of :func:`dft_matrices`
    in f32, in that order (Fr hi, Fr lo, Fi hi, ...), then of Fi with its
    row 0 (zeros) replaced by Fr's row P/2, which lets the kernels form
    the DFT's column P/2 in column 0's place. The f32 kernels' constant
    operand, split once per frame."""
    return _tf32_planes_on(int(pad), torch.device(device))


def _constants(pad, device, is_double):
    """A route's one constant operand, as pointers: Fr, Fi, Br, Bi of
    :func:`dft_matrices` in f64 (no planes), or none of them and the f32
    route's :func:`tf32_planes`."""
    if is_double:
        return tuple(a.data_ptr() for a in dft_matrices(pad, device, torch.float64)), None
    return (None,) * 4, tf32_planes(pad, device).data_ptr()


def _padded(x, pad):
    size = x.shape[-1]
    return F.pad(x, (0, pad - size, 0, pad - size))


@_cuda.full_fp32_matmuls()  # the plain chain is the kernels' oracle
def dft_conv_spectrum_plain(kernels, pad=DEFAULT_PAD):
    """Plain PyTorch version of :func:`dft_conv_spectrum`."""
    fr, fi, _, _ = dft_matrices(pad, kernels.device, kernels.dtype)
    kp = _padded(kernels, pad)
    tr = fr @ kp
    ti = fi @ kp
    return tr @ fr - ti @ fi, tr @ fi + ti @ fr


@_cuda.full_fp32_matmuls()
def dft_conv2d_plain(grids, ur, ui, out_size, offset, pad=DEFAULT_PAD):
    """Plain PyTorch version of :func:`dft_conv2d`."""
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


def _ld(n):
    """Leading dimension of a scratch row of n values: 16-byte aligned."""
    return -(-int(n) // 4) * 4


def _half(pad):
    """Rows 0..P/2 of a Hermitian spectrum (real inputs) determine it."""
    return pad // 2 + 1


def spectrum_scratch(pad, m):
    """Elements of the spectrum's scratch per pair: T (P/2 + 1 x m), complex."""
    return 2 * _half(pad) * _ld(m)


def conv_scratch(pad, in_size, out_size):
    """Elements of the f64 convolution's scratch per pair: T (P/2 + 1 x I),
    E (P x P) and T2^T (P/2 + 1 x out_size), each complex. The f32 route's
    (E[:, :h]^T of P/2 + 1 x P, T2 of out_size x P/2 + 1) is smaller."""
    return 2 * (_half(pad) * (_ld(in_size) + _ld(out_size)) + pad * pad)


def _chunks(k, pair_bytes):
    """Batch slices whose scratch fits SCRATCH_BYTES."""
    step = max(1, SCRATCH_BYTES // pair_bytes)
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
    (fr, fi, _, _), planes = _constants(pad, device, is_double)
    ur, ui = (torch.empty((k, pad, pad), dtype=dtype, device=device) for _ in range(2))
    t_ld = _ld(m)
    # f32: rows of 16 bytes' multiple, so the kernel copies them 16 bytes at a time
    k_ld = m if is_double else t_ld
    rows = kernels if k_ld == m else F.pad(kernels, (0, k_ld - m))
    for lo, hi in _chunks(k, spectrum_scratch(pad, m) * kernels.element_size()):
        tr, ti = (torch.empty((hi - lo, _half(pad), t_ld), dtype=dtype, device=device) for _ in range(2))
        _cuda.call(
            "dft_spectrum_launch", device, is_double, rows[lo:hi].data_ptr(), hi - lo, m, k_ld, fr, fi, planes, tr.data_ptr(), ti.data_ptr(), t_ld, ur[lo:hi].data_ptr(), ui[lo:hi].data_ptr(),
            pad,
        )
        dft_conv_spectrum.launches += 1
        dft_conv_spectrum.frames[pad] = dft_conv_spectrum.frames.get(pad, 0) + 1
        dft_conv_spectrum.kernels[(pad, m)] = dft_conv_spectrum.kernels.get((pad, m), 0) + 1
        if is_double:
            dft_conv_spectrum.f64_frames[pad] = dft_conv_spectrum.f64_frames.get(pad, 0) + 1
    return ur, ui


def dft_conv2d(grids, ur, ui, out_size, offset, pad=DEFAULT_PAD):
    """Batched linear convolution against precomputed kernel spectra.

    grids: (K, I, I) f32 or f64 with I + m - 1 <= pad; ur, ui: (K, pad, pad)
    from :func:`dft_conv_spectrum`, of the same type (the CUDA route relies
    on their Hermitian symmetry, which the spectra of real kernels have).
    Returns the (K, out_size, out_size) slice ``full[offset : offset +
    out_size]`` of each full convolution. CPU tensors take
    :func:`dft_conv2d_plain`; CUDA tensors launch ``csrc/dft_conv.cu``.
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
    (fr, fi, br, bi), planes = _constants(pad, device, is_double)
    out = torch.empty((k, out_size, out_size), dtype=dtype, device=device)
    half = _half(pad)
    t_ld = _ld(in_size)
    # f64: E (P x P), T2^T (h x out_size); f32: C3's operand [S | i D] (h x 2 s, s = h rounded
    # up to a multiple of 32: E's rows k and P - k paired), T2 (out_size x h)
    e_shape, t2_shape = ((pad, pad), (half, _ld(out_size))) if is_double else \
        ((half, 2 * (-(-half // 32) * 32)), (out_size, _ld(half)))
    for lo, hi in _chunks(k, conv_scratch(pad, in_size, out_size) * grids.element_size()):
        n = hi - lo
        t, e, t2 = (
            torch.empty((2, n, rows, ld), dtype=dtype, device=device)
            for rows, ld in ((half, t_ld), e_shape, t2_shape)
        )
        _cuda.call(
            "dft_conv_launch", device, is_double, grids[lo:hi].data_ptr(), n, in_size, fr, fi, br, bi, planes,
            ur[lo:hi].data_ptr(), ui[lo:hi].data_ptr(),
            t[0].data_ptr(), t[1].data_ptr(), t_ld, e[0].data_ptr(), e[1].data_ptr(), t2[0].data_ptr(),
            t2[1].data_ptr(), t2_shape[1], out[lo:hi].data_ptr(), out_size, offset, pad,
        )
        dft_conv2d.launches += 1
        dft_conv2d.inputs[(pad, in_size)] = dft_conv2d.inputs.get((pad, in_size), 0) + 1
        if is_double:
            dft_conv2d.f64_inputs[(pad, in_size)] = dft_conv2d.f64_inputs.get((pad, in_size), 0) + 1
    return out


# launches, in all and by DFT frame (K2 also by (frame, kernel size); K3 by
# (frame, input size)); f64_*: those of them in f64
dft_conv_spectrum.launches = 0
dft_conv_spectrum.frames = {}
dft_conv_spectrum.kernels = {}
dft_conv_spectrum.f64_frames = {}
dft_conv2d.launches = 0
dft_conv2d.inputs = {}
dft_conv2d.f64_inputs = {}
