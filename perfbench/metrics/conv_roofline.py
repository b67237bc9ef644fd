"""conv_roofline (%), layer kernels (DFT-matmul convolutions): the least time
of the analyses' convolution work (``work.analysis_conv_ms``: the kernel
spectra and convolutions each served pair needs at a frozen DFT frame,
f32 at 3xTF32 and f64 at the DMMA peak) over the device time of the
kernels that compute them, matched by name below."""

from perfbench.work import analysis_conv_ms

KERNELS = ("dft_wgmma_kernel", "dft_dmma_kernel")


def read(window):
    busy = window.device_seconds(lambda name: any(k in name for k in KERNELS))
    if busy <= 0 or not window.analyses:
        return None
    return 100.0 * sum(analysis_conv_ms(a) for a in window.analyses) / (busy * 1e3)
