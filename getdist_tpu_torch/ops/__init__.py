"""Tensor operations of the port; module names mirror ``getdist_tpu/ops``.

The FFT / DCT primitives and the device convolution engines are exported
here, as ``getdist_tpu.ops`` exports them.
"""

from getdist_tpu_torch.ops.fft import dct, idct, dct2d, idct2d, next_fast_len
from getdist_tpu_torch.ops.convolve import (
    convolve1D,
    convolve2D,
    convolveFFT,
    convolveFFTn,
    convolve1D_periodic,
    convolve2D_periodic,
    autoConvolve,
    autoCorrelation,
    convolveGaussian,
    convolveGaussianDCT,
    convolveGaussianTrunc,
)

__all__ = [
    "dct",
    "idct",
    "dct2d",
    "idct2d",
    "next_fast_len",
    "convolve1D",
    "convolve2D",
    "convolveFFT",
    "convolveFFTn",
    "convolve1D_periodic",
    "convolve2D_periodic",
    "autoConvolve",
    "autoCorrelation",
    "convolveGaussian",
    "convolveGaussianDCT",
    "convolveGaussianTrunc",
]
