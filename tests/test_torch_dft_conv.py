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


def _tf32(x):
    """Round f32 to TF32 (10 stored mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does: add the rounding bit, mask the rest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the CUDA kernels form it: hi = tf32(x), lo = tf32(x - hi),
    lo.hi + hi.lo + hi.hi in f32 (lo.lo dropped)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _support_chain(grids, kernels, out_size, offset, pad, mm):
    """The CUDA route's stages, contracted over the supports and the window
    only, with every real product formed by ``mm``."""
    fr, fi, br, bi = dft_conv.dft_matrices(pad, "cpu", torch.float32)
    m, size = kernels.shape[-1], grids.shape[-1]
    w = slice(offset, offset + out_size)

    def cmul(ar, ai, xr, xi):
        return mm(ar, xr) - mm(ai, xi), mm(ar, xi) + mm(ai, xr)

    tr, ti = mm(fr[:, :m], kernels), mm(fi[:, :m], kernels)
    ur, ui = cmul(tr, ti, fr[:m], fi[:m])
    tr, ti = mm(fr[:, :size], grids), mm(fi[:, :size], grids)
    hr, hi = cmul(tr, ti, fr[:size], fi[:size])
    er, ei = hr * ur - hi * ui, hr * ui + hi * ur
    t2r, t2i = cmul(br[w], bi[w], er, ei)
    out = mm(t2r, br[:, w]) - mm(t2i, bi[:, w])
    return ur, ui, out


def test_3xtf32_support_chain_within_1e5_of_plain():
    """The precision design of the CUDA kernels, emulated on the CPU at the
    fused path's geometry (frame 384, 61 x 61 kernels, 256 grids, offset
    30): three TF32 passes stay within 1e-5 of the largest value of the
    plain f32 chain; one TF32 pass does not."""
    rng = np.random.RandomState(5)
    grids = torch.from_numpy((rng.rand(2, 256, 256) * 50).astype(np.float32))
    kernels = torch.from_numpy(rng.rand(2, 61, 61).astype(np.float32))
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, 384)
    want = dft_conv.dft_conv2d_plain(grids, ur0, ui0, 256, 30, 384)
    scale_u = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    ur, ui, out = _support_chain(grids, kernels, 256, 30, 384, _mm_3xtf32)
    assert float(torch.maximum((ur - ur0).abs().max(), (ui - ui0).abs().max())) <= 1e-5 * scale_u
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    _, _, one_pass = _support_chain(grids, kernels, 256, 30, 384, _mm_tf32)
    assert float((one_pass - want).abs().max()) > 1e-5 * float(want.abs().max())
