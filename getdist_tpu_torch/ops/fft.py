"""FFT / DCT primitives (counterpart of ``getdist_tpu/ops/fft.py``).

``dct`` is the unnormalized type-II DCT of ``scipy.fftpack.dct(x, type=2)``
and ``idct`` the unnormalized type-III of ``scipy.fftpack.idct(y, type=2)``
(``idct(dct(x)) == 2 N x``), each built from one complex FFT by Makhoul's
even-odd permutation, as the JAX package builds them, so the two agree to
rounding; ``dct2d`` / ``idct2d`` apply them along both axes.
"""

from __future__ import annotations

import math

import torch

__all__ = ["next_fast_len", "dct", "idct", "dct2d", "idct2d"]


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth number (2^a * 3^b * 5^c) >= n."""
    n = int(n)
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            q = -(-n // p35)
            best = min(best, (1 << max(0, (q - 1).bit_length())) * p35)
            p35 *= 3
        p5 *= 5
    return best


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


def idct(y, dim=-1):
    """Unnormalized type-III DCT along ``dim``:
    ``x[n] = y[0] + 2 * sum_{k>=1} y[k] cos(pi k (2n+1) / (2N))``: undo
    the twiddle, inverse FFT, undo the even-odd permutation."""
    y = y.movedim(dim, -1)
    n = y.shape[-1]
    cdtype = _complex_dtype(y.dtype)
    k = torch.arange(n, dtype=y.dtype, device=y.device).to(cdtype)
    w = torch.exp(1j * (math.pi / (2 * n)) * k)
    # V[k] = (y[k] - i y[N-k]) w[k] with y[N] = 0; v = N ifft(V)
    y_rev = torch.cat([torch.zeros_like(y[..., :1]), y[..., 1:].flip(-1)], dim=-1)
    big_v = (y.to(cdtype) - 1j * y_rev.to(cdtype)) * w
    v = torch.real(torch.fft.ifft(big_v, dim=-1)).to(y.dtype) * n
    n_even = (n + 1) // 2
    x = torch.empty_like(v)
    x[..., ::2] = v[..., :n_even]
    x[..., 1::2] = v[..., n_even:].flip(-1)
    return x.movedim(-1, dim)


def dct2d(a):
    """2D unnormalized type-II DCT (axis 0, then axis 1)."""
    return dct(dct(a, dim=0), dim=1)


def idct2d(a):
    """2D unnormalized type-III DCT (axis 1, then axis 0)."""
    return idct(idct(a, dim=1), dim=0)
