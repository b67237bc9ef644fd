"""getdist_tpu_torch DFT-matmul convolution (kernels K2, K3) against JAX.

The port's plain versions run against the JAX package's Pallas kernels in
interpret mode at "highest" precision, to 1e-4 of the largest reference
value (the bar of tests/test_dft_conv.py). The CUDA kernels are held
against the plain versions by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from getdist_tpu.ops import dft_conv as jdft  # noqa: E402
from getdist_tpu_torch.ops import dft_conv  # noqa: E402


def _jax_conv(grids, kernels, out_size, offset, pad):
    with jax.enable_x64(False):
        ur, ui = jdft.dft_conv_spectrum(jnp.asarray(kernels), pad=pad, precision="highest", interpret=True)
        out = jdft.dft_conv2d(
            jnp.asarray(grids), ur, ui, out_size, offset, pad=pad, precision="highest", interpret=True
        )
        return np.asarray(ur), np.asarray(ui), np.asarray(out)


def _port_conv(grids, kernels, out_size, offset, pad):
    ur, ui = dft_conv.dft_conv_spectrum(torch.from_numpy(kernels), pad)
    out = dft_conv.dft_conv2d(torch.from_numpy(grids), ur, ui, out_size, offset, pad)
    return ur.numpy(), ui.numpy(), out.numpy()


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.max(np.abs(want))))


@pytest.mark.parametrize("offset_mode", ["same", "ext"])
def test_plain_matches_pallas_pad128(offset_mode):
    k, n, m = 2, 48, 13
    half = (m - 1) // 2
    rng = np.random.RandomState(1)
    kernels = rng.rand(k, m, m).astype(np.float32)
    if offset_mode == "same":
        grids = (rng.rand(k, n, n) * 20.0).astype(np.float32)
        offset = half
    else:
        # the padded-extension variant: input n + 2 half wide, sliced at 2 half
        grids = (rng.rand(k, n + 2 * half, n + 2 * half) * 20.0).astype(np.float32)
        offset = 2 * half
    want = _jax_conv(grids, kernels, n, offset, 128)
    got = _port_conv(grids, kernels, n, offset, 128)
    for g, w in zip(got, want):
        _assert_close(g, w)


def test_plain_matches_pallas_production_frame():
    """The main path's geometry: 256 grids, 61 x 61 kernels, offset 30, pad 384."""
    rng = np.random.RandomState(2)
    grids = (rng.rand(2, 256, 256) * 50.0).astype(np.float32)
    kernels = rng.rand(2, 61, 61).astype(np.float32)
    want = _jax_conv(grids, kernels, 256, 30, dft_conv.DEFAULT_PAD)
    got = _port_conv(grids, kernels, 256, 30, dft_conv.DEFAULT_PAD)
    for g, w in zip(got, want):
        _assert_close(g, w)


def test_plain_matches_fft_convolution():
    """An independent oracle: the same slice of an rFFT linear convolution."""
    rng = np.random.RandomState(3)
    grids = torch.from_numpy((rng.rand(3, 64, 64) * 10).astype(np.float32))
    kernels = torch.from_numpy(rng.rand(3, 21, 21).astype(np.float32))
    ur, ui = dft_conv.dft_conv_spectrum(kernels, 128)
    got = dft_conv.dft_conv2d(grids, ur, ui, 64, 10, 128)
    full = torch.fft.irfft2(torch.fft.rfft2(grids, (128, 128)) * torch.fft.rfft2(kernels, (128, 128)), (128, 128))
    want = full[:, 10:74, 10:74]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_wrappers_refuse_non_cuda_devices():
    kernels = torch.zeros((1, 5, 5), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dft_conv.dft_conv_spectrum(kernels, 128)
    spec = torch.zeros((1, 128, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dft_conv.dft_conv2d(torch.zeros((1, 8, 8), device="meta"), spec, spec, 8, 2, 128)

