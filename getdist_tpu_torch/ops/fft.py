"""FFT / DCT primitives (counterpart of ``getdist_tpu/ops/fft.py``).

``dct`` is the unnormalized type-II DCT of ``scipy.fftpack.dct(x, type=2)``,
built from one complex FFT by Makhoul's even-odd permutation, as the JAX
package builds it, so the two agree to f32 rounding.
"""

from __future__ import annotations

import math

import torch

__all__ = ["next_fast_len", "dct"]


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
