"""Host (numpy) FFT convolution of the parity path's 1D densities.

The port's own copy of ``convolveFFT_host`` from
``getdist_tpu/ops/convolve.py``, with the same padding, slicing and
arithmetic. It acts on grids of a few thousand bins, where numpy on the
host is the right tool; the 2D densities go through the CUDA DFT kernels
of :mod:`getdist_tpu_torch.ops.dft_conv` instead, and periodic parameters
are not ported yet (ROADMAP A3).
"""

import numpy as np

from getdist_tpu_torch.ops.fft import next_fast_len

__all__ = ["convolveFFT_host"]


def convolveFFT_host(x, y, mode="same", largest_size=0):
    """1D linear convolution by real FFT at a 5-smooth size ('same', 'full'
    or 'valid')."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    size = x.shape[0] + y.shape[0] - 1
    fsize = next_fast_len(max(largest_size, size))
    res = np.fft.irfft(np.fft.rfft(x, fsize) * np.fft.rfft(y, fsize), fsize)[:size]
    if mode == "same":
        start = (y.shape[0] - 1) // 2
        return res[start : start + x.shape[0]]
    elif mode == "full":
        return res
    elif mode == "valid":
        return res[y.shape[0] - 1 : x.shape[0]]
    raise ValueError(f"unknown convolution mode {mode!r}")
