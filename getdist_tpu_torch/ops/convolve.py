"""FFT convolution engines (counterpart of ``getdist_tpu/ops/convolve.py``).

Two halves, with the same padding, slicing and arithmetic as the JAX
package's:

* the device half, on ``torch.fft`` on the tensors' device:
  :func:`convolveFFT` / :func:`convolveFFTn` (linear 'same', 'full' or
  'valid' at 5-smooth sizes), the periodic 1D and 2D convolutions (the
  last bin of a periodic axis duplicates its first: folded in, convolved
  with the roll-centered kernel, re-appended), the dispatchers
  :func:`convolve1D` / :func:`convolve2D`, the autocorrelation
  (:func:`autoConvolve`, :func:`autoCorrelation`) and the Gaussian
  smoothings (:func:`convolveGaussianDCT`, :func:`convolveGaussian`,
  :func:`convolveGaussianTrunc`). They serve the chains' autocorrelation
  and the host densities' convolutions under
  ``GETDIST_TPU_TORCH_DEVICE_OPS=1``;
* the host twins (``convolveFFT_host``, ``convolveFFTn_host``, the
  periodic ones and the dispatchers ``convolve1D_host`` /
  ``convolve2D_host``) in numpy, which serve the host density path by
  default: one grid of a few thousand bins, or one pair's grid of a few
  hundred squared.

The dispatchers take ``cache`` / ``cache_args`` and ignore them, as the
JAX package's do. The fused program's batched 2D convolutions run through the CUDA DFT
kernels of :mod:`getdist_tpu_torch.ops.dft_conv` instead.
"""

import numpy as np
import torch
import torch.nn.functional as F

from getdist_tpu_torch.ops.fft import dct, dct2d, idct, idct2d, next_fast_len

__all__ = [
    "nearestFFTnumber",
    "convolveFFT",
    "convolveFFTn",
    "convolve1D_periodic",
    "convolve2D_periodic",
    "convolve1D",
    "convolve2D",
    "autoConvolve",
    "autoCorrelation",
    "convolveGaussianDCT",
    "convolveGaussian",
    "convolveGaussianTrunc",
    "dct2d",
    "idct2d",
    "convolveFFT_host",
    "convolveFFTn_host",
    "convolve1D_periodic_host",
    "convolve2D_periodic_host",
    "convolve1D_host",
    "convolve2D_host",
]


def nearestFFTnumber(x):
    """Smallest 5-smooth FFT size >= x, for a scalar or an array."""
    if np.ndim(x) == 0:
        return next_fast_len(int(x))
    return np.asarray([next_fast_len(int(v)) for v in np.ravel(x)]).reshape(np.shape(x))


def _slice_mode(res, mode, nx, ny):
    """A full 1D linear convolution of lengths nx and ny cut to ``mode``."""
    if mode == "same":
        start = (ny - 1) // 2
        return res[start : start + nx]
    elif mode == "full":
        return res
    elif mode == "valid":
        return res[ny - 1 : nx]
    raise ValueError(f"unknown convolution mode {mode!r}")


def convolveFFT(x, y, mode="same", largest_size=0):
    """1D linear convolution of tensors ``x`` and ``y`` by real FFT at a
    5-smooth size >= len(x) + len(y) - 1."""
    size = x.shape[0] + y.shape[0] - 1
    fsize = next_fast_len(max(largest_size, size))
    res = torch.fft.irfft(torch.fft.rfft(x, fsize) * torch.fft.rfft(y, fsize), fsize)[:size]
    return _slice_mode(res, mode, x.shape[0], y.shape[0])


def _centered(arr, newshape):
    slices = tuple(slice((cur - new) // 2, (cur - new) // 2 + new) for cur, new in zip(arr.shape, newshape))
    return arr[slices]


def _nd_mode(ret, mode, s1, s2):
    """A full N-D linear convolution of shapes s1 and s2 cut to ``mode``."""
    if mode == "full":
        return ret
    elif mode == "same":
        return _centered(ret, s1)
    elif mode == "valid":
        return _centered(ret, tuple(a - b + 1 for a, b in zip(s1, s2)))
    raise ValueError(f"unknown convolution mode {mode!r}")


def convolveFFTn(in1, in2, mode="same", largest_size=0):
    """N-D linear convolution of tensors by real FFTs at 5-smooth sizes."""
    s1, s2 = in1.shape, in2.shape
    size = tuple(a + b - 1 for a, b in zip(s1, s2))
    fsize = tuple(next_fast_len(max(largest_size, s)) for s in size)
    dims = tuple(range(-len(fsize), 0))
    spectrum = torch.fft.rfftn(in1, fsize, dim=dims) * torch.fft.rfftn(in2, fsize, dim=dims)
    ret = torch.fft.irfftn(spectrum, fsize, dim=dims)[tuple(slice(0, s) for s in size)]
    return _nd_mode(ret, mode, s1, s2)


def convolve1D_periodic(x, y):
    """Circular 1D convolution of ``x``, whose last bin duplicates its
    first: fold the last bin into the first, convolve circularly with the
    roll-centered kernel, re-append the first bin."""
    x_circ = x[:-1].clone()
    x_circ[0] += x[-1]
    n = x_circ.shape[0]
    m = y.shape[0]
    hpad = torch.zeros(n, dtype=y.dtype, device=y.device)
    hpad[:m] = y
    hpad = torch.roll(hpad, -(m // 2))
    res = torch.fft.irfft(torch.fft.rfft(x_circ) * torch.fft.rfft(hpad), n)
    return torch.cat([res, res[:1]])


def convolve2D_periodic(x, y, periodic_x=True, periodic_y=True):
    """2D convolution, circular along the periodic axes (axis 0 is y,
    axis 1 is x), linear 'same' along the others."""
    if not (periodic_x or periodic_y):
        return convolveFFTn(x, y, "same")
    ky, kx = y.shape
    if periodic_x and periodic_y:
        x_circ = x[:-1, :-1].clone()
        x_circ[0, :] += x[-1, :-1]
        x_circ[:, 0] += x[:-1, -1]
        x_circ[0, 0] += x[-1, -1]
    elif periodic_x:
        x_circ = x[:, :-1].clone()
        x_circ[:, 0] += x[:, -1]
    else:
        x_circ = x[:-1, :].clone()
        x_circ[0, :] += x[-1, :]
    n_y, n_x = x_circ.shape
    hpad = torch.zeros((n_y, n_x), dtype=y.dtype, device=y.device)
    hpad[:ky, :kx] = y
    hpad = torch.roll(hpad, (-(ky // 2), -(kx // 2)), dims=(0, 1))
    res = torch.fft.irfftn(torch.fft.rfftn(x_circ) * torch.fft.rfftn(hpad), (n_y, n_x), dim=(0, 1))
    if periodic_x:
        res = torch.cat([res, res[:, :1]], dim=1)
    if periodic_y:
        res = torch.cat([res, res[:1, :]], dim=0)
    return res


def convolve1D(x, y, mode, largest_size=0, cache=None, cache_args=None):
    """1D convolution of tensors: circular for ``mode="periodic"``, else
    :func:`convolveFFT` in ``mode``."""
    if mode == "periodic":
        return convolve1D_periodic(x, y)
    return convolveFFT(x, y, mode, largest_size=largest_size)


def convolve2D(x, y, mode, largest_size=0, cache=None, cache_args=None):
    """2D convolution of tensors: circular along the axes ``mode`` names
    periodic ("periodic" / "periodic_both", "periodic_x", "periodic_y"),
    else :func:`convolveFFTn` in ``mode``."""
    if mode in ("periodic", "periodic_both"):
        return convolve2D_periodic(x, y, periodic_x=True, periodic_y=True)
    elif mode == "periodic_x":
        return convolve2D_periodic(x, y, periodic_x=True, periodic_y=False)
    elif mode == "periodic_y":
        return convolve2D_periodic(x, y, periodic_x=False, periodic_y=True)
    return convolveFFTn(x, y, mode, largest_size)


def autoConvolve(x, n=None, normalize=True):
    """Auto-covariance ``result[k] = sum_i x_i x_{i+k}`` for k = 0..n-1,
    from the real-FFT power spectrum; with ``normalize`` each lag divided
    by its number of overlapping terms."""
    n = n or x.shape[0]
    s = next_fast_len(2 * x.shape[0])
    xt = torch.fft.rfft(x, s)
    res = torch.fft.irfft(xt * torch.conj(xt), s)[:n]
    if normalize:
        res = res / torch.arange(x.shape[0], x.shape[0] - n, -1, dtype=x.dtype, device=x.device)
    return res


def autoCorrelation(x, n=None, normalized=True, start_index=0):
    """Autocorrelation of ``x`` about its mean (lag 0 scaled to 1 with
    ``normalized``)."""
    result = autoConvolve(x - torch.mean(x), n, normalize=True)
    if normalized:
        result = result / result[0]
    return result[start_index:]


def convolveGaussianDCT(x, sigma, pad_sigma=4.0, mode="same"):
    """1D Gaussian smoothing by a DCT multiplier, zero-padded by
    ``pad_sigma`` widths; ``sigma`` in pixels."""
    sigma = float(sigma)
    fill = int(pad_sigma * sigma)
    if fill > 0:
        s = next_fast_len(x.shape[0] + 2 * fill)
        fill2 = s - x.shape[0] - fill
        padded_x = F.pad(x, (fill, fill2))
    else:
        padded_x = x
    s = padded_x.shape[0]
    hnorm = sigma / float(s)
    gauss = torch.exp(-((torch.arange(s, dtype=x.dtype, device=x.device) * (np.pi * hnorm)) ** 2) / 2.0)
    res = idct(dct(padded_x) * gauss) / (2 * s)
    if fill == 0:
        return res
    elif mode == "same":
        return res[fill:-fill2]
    elif mode == "valid":
        return res[fill * 2 : -fill2 - fill]
    raise ValueError("mode not supported for convolveGaussianDCT")


def convolveGaussian(x, sigma, sigma_range=4.0):
    """Gaussian smoothing with periodic boundaries by a real-FFT
    multiplier, padded by ``sigma_range`` widths."""
    sigma = float(sigma)
    fill = int(sigma_range * sigma)
    actual_size = x.shape[0] + 2 * fill
    s = next_fast_len(actual_size) if fill > 0 else actual_size
    hnorm = sigma / float(s)
    k = torch.arange(s // 2 + 1, dtype=x.dtype, device=x.device)
    gauss = torch.exp(-((k * (np.pi * hnorm)) ** 2) * 2)
    res = torch.fft.irfft(torch.fft.rfft(x, s) * gauss, s)
    return res[: x.shape[0]]


def convolveGaussianTrunc(x, sigma, sigma_range=4.0, mode="same"):
    """Convolution with a Gaussian kernel truncated at ``sigma_range``
    widths and renormalized."""
    sigma_f = float(sigma)
    fill = int(sigma_range * sigma_f)
    actual_size = x.shape[0] + 2 * fill
    s = next_fast_len(actual_size)
    points = torch.arange(-fill, fill + 1, dtype=x.dtype, device=x.device)
    win = torch.exp(-((points / sigma) ** 2) / 2.0)
    win = win / torch.sum(win)
    res = torch.fft.irfft(torch.fft.rfft(x, s) * torch.fft.rfft(win, s), s)[:actual_size]
    if mode == "same":
        return res[fill:-fill] if fill else res
    elif mode == "full":
        return res
    elif mode == "valid":
        return res[2 * fill : -2 * fill] if fill else res
    raise ValueError(f"unknown convolution mode {mode!r}")


# -- host (numpy) twins ---------------------------------------------------------


def convolve1D_host(x, y, mode, largest_size=0, cache=None, cache_args=None):
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
    return _slice_mode(res, mode, x.shape[0], y.shape[0])


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
    return _nd_mode(ret, mode, s1, s2)


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


def convolve2D_host(x, y, mode, largest_size=0, cache=None, cache_args=None):
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
