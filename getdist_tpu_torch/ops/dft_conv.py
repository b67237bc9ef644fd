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
ones doubled). The products against F take its columns c and P - c from
one set of real products (F[k][P - c] = conj(F[k][c])), and E's rows k
and P - k are paired the same way. Inputs are f32 (the fused path) or f64
(parity mode and, in every path, the meanlikes run's like-weighted
smoothing); the DFT matrices are built in f64 on the host and rounded to
the input type. f32 runs on ``wgmma`` as three TF32 passes, the data split
in registers and the DFT matrices split once per frame into tf32 hi and lo
planes (:func:`tf32_planes`) that TMA loads as they are; f64 runs on DMMA
(``mma.sync``) against :func:`f64_planes`, loaded by TMA too.
The TPU kept the chain in VMEM; here the intermediates go through device
memory: per pair, the spectrum's T (h x m) and the convolution's T
(h x I), E and T2, each complex, with leading dimensions rounded up to a
multiple of 4 (16-byte rows). E is kept only as the next stage's operand,
E's rows k and P - k paired: in f32 h x 2 s (s = h rounded up to a
multiple of 32, two segments), in f64 h x P (the paired rows' sums, then
their differences for 0 < k < P/2); T2 is out_size x h in f32 and, in f64,
the real out_size x P operand of the last stage. A batch whose scratch
exceeds :data:`SCRATCH_BYTES` (:func:`conv_scratch`) is split over K.

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
    "f64_planes",
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


@functools.lru_cache(maxsize=8)
def _f64_planes_on(pad, device):
    fr, fi, br, bi = _dft_mats_np(pad)
    fi_nyquist = fi.copy()
    fi_nyquist[0] = fr[pad // 2]
    split = np.concatenate([br[:, : _half(pad)], bi[:, 1 : pad // 2]], axis=1)
    return torch.from_numpy(np.stack([fr, fi_nyquist, split])).to(device)


def f64_planes(pad, device):
    """(3, pad, pad) f64 on ``device``: Fr, Fi with its row 0 (zeros)
    replaced by Fr's row P/2 (the kernels form the DFT's column P/2 in
    column 0's place), and B split by rows, row r = [Br[r, 0..P/2],
    Bi[r, 1..P/2 - 1]] (against the paired rows' sums, then their
    differences). The f64 kernels' constant operand."""
    return _f64_planes_on(int(pad), torch.device(device))


def _planes(pad, device, is_double):
    """A route's constant operand, as a pointer."""
    return (f64_planes if is_double else tf32_planes)(pad, device).data_ptr()


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


def _conv_shapes(pad, in_size, out_size, is_double):
    """The convolution's scratch per pair, (rows, ld, planes) of T, E and T2."""
    half = _half(pad)
    if is_double:
        # E as C3's operand (h x P), T2 as C4's real operand (out_size x P)
        return (half, _ld(in_size), 2), (half, pad, 2), (out_size, pad, 1)
    # E as C3's operand [S | i D] (h x 2 s, s = h rounded up to a multiple of 32), T2 (out_size x h)
    return (half, _ld(in_size), 2), (half, 2 * (-(-half // 32) * 32), 2), (out_size, _ld(half), 2)


def conv_scratch(pad, in_size, out_size):
    """Elements of the convolution's scratch per pair: T (P/2 + 1 x I), E
    as the next stage's operand and T2, the larger of the f32 and f64
    routes' counts."""
    return max(sum(r * ld * n for r, ld, n in _conv_shapes(pad, in_size, out_size, d)) for d in (False, True))


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
    planes = _planes(pad, device, is_double)
    spectra = torch.empty((2, k, pad, pad), dtype=dtype, device=device)
    t_ld = _ld(m)
    # f32: rows of 16 bytes' multiple, so the kernel copies them 16 bytes at a time
    k_ld = m if is_double else t_ld
    rows = kernels if k_ld == m else F.pad(kernels, (0, k_ld - m))
    # the launch's pointers by arithmetic on the buffers (no views: the host time of a call counts
    # at the small buckets)
    size = kernels.element_size()
    rows_ptr, u_ptr, frame = rows.data_ptr(), spectra.data_ptr(), pad * pad * size
    for lo, hi in _chunks(k, spectrum_scratch(pad, m) * size):
        t = torch.empty((2, hi - lo, _half(pad), t_ld), dtype=dtype, device=device)
        t_ptr = t.data_ptr()
        _cuda.call(
            "dft_spectrum_launch", device, is_double, rows_ptr + lo * m * k_ld * size, hi - lo, m, k_ld, planes,
            t_ptr, t_ptr + t.numel() // 2 * size, t_ld, u_ptr + lo * frame, u_ptr + (k + lo) * frame, pad,
        )
        dft_conv_spectrum.launches += 1
        dft_conv_spectrum.frames[pad] = dft_conv_spectrum.frames.get(pad, 0) + 1
        dft_conv_spectrum.kernels[(pad, m)] = dft_conv_spectrum.kernels.get((pad, m), 0) + 1
        if is_double:
            dft_conv_spectrum.f64_frames[pad] = dft_conv_spectrum.f64_frames.get(pad, 0) + 1
    return spectra[0], spectra[1]


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
    planes = _planes(pad, device, is_double)
    out = torch.empty((k, out_size, out_size), dtype=dtype, device=device)
    shapes = _conv_shapes(pad, in_size, out_size, is_double)
    size = grids.element_size()
    g_ptr, ur_ptr, ui_ptr, o_ptr = grids.data_ptr(), ur.data_ptr(), ui.data_ptr(), out.data_ptr()
    for lo, hi in _chunks(k, conv_scratch(pad, in_size, out_size) * size):
        n = hi - lo
        t, e, t2 = (torch.empty((planes_, n, rows, ld), dtype=dtype, device=device) for rows, ld, planes_ in shapes)
        # each scratch's planes (re, im; f64's T2 is real: its one plane twice)
        (t_re, t_im), (e_re, e_im), (t2_re, t2_im) = ((x[0].data_ptr(), x[-1].data_ptr()) for x in (t, e, t2))
        _cuda.call(
            "dft_conv_launch", device, is_double, g_ptr + lo * in_size * in_size * size, n, in_size, planes,
            ur_ptr + lo * pad * pad * size, ui_ptr + lo * pad * pad * size, t_re, t_im, shapes[0][1], e_re, e_im,
            t2_re, t2_im, shapes[2][1], o_ptr + lo * out_size * out_size * size, out_size, offset, pad,
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
