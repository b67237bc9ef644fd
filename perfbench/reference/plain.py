"""Plain PyTorch versions of the port's hand-written kernels and helpers, as
the frozen fused pipeline (:mod:`perfbench.reference.fused`) calls them.

Copies of the plain twins the port keeps beside its kernels (the pair
histograms K1/K4/K5 with their 64-bit fixed point for fractional weights,
the DFT-matmul kernel spectrum K2 and convolution K3, the type-II DCT),
the same on every device: a CUDA tensor runs the same matrix products and
``bincount``\\ s as a CPU one. The collectives are those of one device: a
process group is refused. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_PAD = 384
NBINS = 256

_NP = {torch.float32: np.float32, torch.float64: np.float64}


# -- one device: the collectives' identities -------------------------------------------------------


def _no_group(group):
    if group is not None:
        raise ValueError("the reference runs on one device: no process group")


def size(group):
    _no_group(group)
    return 1


def psum(x, group):
    _no_group(group)
    return x


psum_ = pmin = pmax = psum


def ppermute(x, group, perm):
    _no_group(group)
    raise ValueError("the reference runs on one device: nothing to permute")


class _stage(contextlib.ContextDecorator):
    """The program's profiler ranges, as no-ops: a reference run is never traced."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@contextlib.contextmanager
def full_fp32_matmuls():
    """float32 matrix products in full FP32 inside (TF32 off), the caller's
    setting restored on exit. Also a decorator."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def resolve_device(device):
    return torch.device(device)


# -- the type-II DCT ----------------------------------------------------------------------------------


def _complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def dct(x, dim=-1):
    """Unnormalized type-II DCT along ``dim``:
    ``y[k] = 2 * sum_n x[n] cos(pi k (2n+1) / (2N))``."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    big_v = torch.fft.fft(v.to(_complex_dtype(x.dtype)), dim=-1)
    k = torch.arange(n, dtype=x.dtype, device=x.device).to(big_v.dtype)
    w = torch.exp(-1j * (math.pi / (2 * n)) * k)
    y = 2 * torch.real(w * big_v)
    return y.to(x.dtype).movedim(-1, dim)


# -- K2 / K3: DFT-matmul kernel spectra and convolutions ----------------------------------------------


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
    """(Fr, Fi, Br, Bi) (pad, pad): F = Fr + i Fi is the symmetric DFT
    matrix and Br + i Bi = conj(F) / pad, computed in f64 and rounded."""
    return _dft_mats_on(int(pad), torch.device(device), dtype)


def _padded(x, pad):
    size = x.shape[-1]
    return F.pad(x, (0, pad - size, 0, pad - size))


@full_fp32_matmuls()
def dft_conv_spectrum(kernels, pad=DEFAULT_PAD):
    """(Ur, Ui), the DFT of each (K, m, m) kernel zero-padded to the frame."""
    fr, fi, _, _ = dft_matrices(pad, kernels.device, kernels.dtype)
    kp = _padded(kernels, pad)
    tr = fr @ kp
    ti = fi @ kp
    return tr @ fr - ti @ fi, tr @ fi + ti @ fr


@full_fp32_matmuls()
def dft_conv2d(grids, ur, ui, out_size, offset, pad=DEFAULT_PAD):
    """The (K, out_size, out_size) slice at ``offset`` of each grid's circular
    convolution with its kernel, whose spectrum is (ur, ui)."""
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


# -- K1 / K4 / K5: pair histograms -------------------------------------------------------------------


def _pow2(e):
    """2^e (an integer tensor) as f64, from its bits: exact."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def fixed_scale(scale):
    """(2^(62 - e), 2^(e - 62)) as f64 tensors for ``scale`` = (wmax, count),
    max |w| * count < 2^e: no sum of at most ``count`` weights rounded to
    multiples of 2^(e - 62) leaves int64, in any order."""
    wmax, count = scale
    _, e = torch.frexp(wmax.to(torch.float64) * float(count))
    return _pow2(62 - e), _pow2(e - 62)


def group_scale(weights, count, group=None):
    _no_group(group)
    return torch.amax(torch.abs(weights.to(torch.float32))).reshape(()), int(count)


def fixed_to_f32(acc, scale):
    """int64 fixed-point sums as f32: each sum rounded to f64, scaled by an
    exact power of two, rounded to f32 once."""
    return (acc.to(torch.float64) * fixed_scale(scale)[1].to(acc.device)).to(torch.float32)


def pair_histograms(ix, weights, pair_a, pair_b, integer_weights=False, nbins=NBINS, scale=None, raw=False):
    """(K, nbins, nbins) histograms of the index rows' pairs (rows = b): one
    f64 ``bincount`` per pair for integer weights (exact, order
    independent), cast to f32; fractional weights in 64-bit fixed point
    (each weight rounded once to a multiple of 2^-62 of max |w| * N), int64
    sums, then :func:`fixed_to_f32`, or with ``raw`` the sums. Indices
    outside [0, nbins) are dropped."""
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
    return out if integer or raw else fixed_to_f32(out, scale)


def narrow_weights(weights):
    """Integer weights as uint8 when every rounded weight lies in [0, 255],
    else ``weights`` itself."""
    lo, hi = torch.stack(list(torch.aminmax(weights))).tolist()
    if -0.5 <= lo and hi < 255.5:
        return torch.round(weights).to(torch.uint8)
    return weights


def narrow_rows(ix, nbins):
    """``ix`` in the narrowest index type that holds every value (uint8 at
    most 256 bins, else int16, else int32), never wrapping an index outside
    ``[0, nbins)`` into range."""
    if ix.dtype == torch.uint8 and nbins <= 256:
        return ix.contiguous()
    lo, hi = torch.stack(list(torch.aminmax(ix))).tolist() if ix.numel() else (0, 0)
    if nbins <= 256 and 0 <= lo and hi <= 255:
        return ix.to(torch.uint8).contiguous()
    if -(2**15) <= lo and hi < 2**15:
        return ix.to(torch.int16).contiguous()
    return ix.to(torch.int32).contiguous()
