"""Host (numpy) FFT convolution of the host 1D densities.

The port's own copies of ``convolveFFT_host``, ``convolve1D_periodic_host``
and the dispatcher ``convolve1D_host`` from ``getdist_tpu/ops/convolve.py``,
with the same padding, slicing and arithmetic. They act on grids of a few
thousand bins, where numpy on the host is the right tool; the 2D densities
go through the CUDA DFT kernels of :mod:`getdist_tpu_torch.ops.dft_conv`
instead.
"""

import numpy as np

from getdist_tpu_torch.ops.fft import next_fast_len

__all__ = ["convolveFFT_host", "convolve1D_periodic_host", "convolve1D_host"]


def convolve1D_host(x, y, mode, largest_size=0):
    """1D convolution: circular for ``mode="periodic"``, else
    :func:`convolveFFT_host` in ``mode``."""
    if mode == "periodic":
        return convolve1D_periodic_host(x, y)
    return convolveFFT_host(x, y, mode, largest_size=largest_size)


def convolve1D_periodic_host(x, y):
    """Circular 1D convolution of ``x``, whose last bin duplicates its first
    (the two ends of a period): fold the last bin into the first, convolve
    circularly with the roll-centered kernel, re-append the first bin."""
    x_circ = np.array(x[:-1], float)
    x_circ[0] += x[-1]
    n = x_circ.shape[0]
    m = y.shape[0]
    hpad = np.zeros(n, dtype=np.asarray(y).dtype)
    hpad[:m] = y
    hpad = np.roll(hpad, -(m // 2))
    res = np.fft.irfft(np.fft.rfft(x_circ) * np.fft.rfft(hpad), n)
    return np.concatenate([res, res[:1]])


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
