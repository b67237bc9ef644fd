"""Host (numpy) FFT convolution of the host 1D and 2D densities.

The port's own copies of the host twins of ``getdist_tpu/ops/convolve.py``
(``convolveFFT_host``, ``convolveFFTn_host``, the periodic 1D and 2D
convolutions and the dispatchers ``convolve1D_host`` / ``convolve2D_host``),
with the same padding, slicing and arithmetic. They serve the host density
path (``MCSamples.get1DDensityGridData`` / ``get2DDensityGridData`` on the
CPU or with the fused route off): one grid of a few thousand bins, or one
pair's grid of a few hundred squared, where numpy on the host is the right
tool. The fused program's batched 2D convolutions run through the CUDA DFT
kernels of :mod:`getdist_tpu_torch.ops.dft_conv` instead.
"""

import numpy as np

from getdist_tpu_torch.ops.fft import next_fast_len

__all__ = [
    "convolveFFT_host",
    "convolveFFTn_host",
    "convolve1D_periodic_host",
    "convolve2D_periodic_host",
    "convolve1D_host",
    "convolve2D_host",
]


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


def convolveFFTn_host(in1, in2, mode="same", largest_size=0):
    """N-D linear convolution by real FFT at 5-smooth sizes ('same', 'full'
    or 'valid')."""
    s1, s2 = in1.shape, in2.shape
    size = tuple(a + b - 1 for a, b in zip(s1, s2))
    fsize = tuple(next_fast_len(max(largest_size, s)) for s in size)
    axes = tuple(range(-len(fsize), 0))
    ret = np.fft.irfftn(np.fft.rfftn(in1, fsize, axes) * np.fft.rfftn(in2, fsize, axes), fsize, axes)[
        tuple(slice(0, s) for s in size)
    ]
    if mode == "full":
        return ret
    elif mode == "same":
        slices = tuple(slice((cur - new) // 2, (cur - new) // 2 + new) for cur, new in zip(ret.shape, s1))
        return ret[slices]
    elif mode == "valid":
        newshape = tuple(a - b + 1 for a, b in zip(s1, s2))
        slices = tuple(slice((cur - new) // 2, (cur - new) // 2 + new) for cur, new in zip(ret.shape, newshape))
        return ret[slices]
    raise ValueError(f"unknown convolution mode {mode!r}")


def convolve2D_periodic_host(x, y, periodic_x=True, periodic_y=True):
    """2D convolution, circular along the periodic axes (whose last row or
    column duplicates the first: folded in, convolved with the roll-centered
    kernel, re-appended), linear 'same' along the others."""
    if not (periodic_x or periodic_y):
        return convolveFFTn_host(x, y, "same")
    ky, kx = y.shape
    if periodic_x and periodic_y:
        x_circ = np.array(x[:-1, :-1])
        x_circ[0, :] += x[-1, :-1]
        x_circ[:, 0] += x[:-1, -1]
        x_circ[0, 0] += x[-1, -1]
    elif periodic_x:
        x_circ = np.array(x[:, :-1])
        x_circ[:, 0] += x[:, -1]
    else:
        x_circ = np.array(x[:-1, :])
        x_circ[0, :] += x[-1, :]
    n_y, n_x = x_circ.shape
    hpad = np.zeros((n_y, n_x), dtype=np.asarray(y).dtype)
    hpad[:ky, :kx] = y
    hpad = np.roll(hpad, -(ky // 2), axis=0)
    hpad = np.roll(hpad, -(kx // 2), axis=1)
    res = np.fft.irfftn(np.fft.rfftn(x_circ) * np.fft.rfftn(hpad), (n_y, n_x), axes=(0, 1))
    if periodic_x:
        res = np.concatenate([res, res[:, :1]], axis=1)
    if periodic_y:
        res = np.concatenate([res, res[:1, :]], axis=0)
    return res


def convolve2D_host(x, y, mode, largest_size=0):
    """2D convolution: circular along the axes ``mode`` names periodic
    ("periodic" / "periodic_both", "periodic_x", "periodic_y"), else
    :func:`convolveFFTn_host` in ``mode``."""
    if mode in ("periodic", "periodic_both"):
        return convolve2D_periodic_host(x, y, periodic_x=True, periodic_y=True)
    elif mode == "periodic_x":
        return convolve2D_periodic_host(x, y, periodic_x=True, periodic_y=False)
    elif mode == "periodic_y":
        return convolve2D_periodic_host(x, y, periodic_x=False, periodic_y=True)
    return convolveFFTn_host(np.asarray(x, float), np.asarray(y, float), mode, largest_size)
