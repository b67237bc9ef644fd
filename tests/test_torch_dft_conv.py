"""getdist_tpu_torch DFT-matmul convolution (kernels K2, K3) against JAX.

The port's plain versions run against the JAX package's Pallas kernels in
interpret mode at "highest" precision, to 1e-4 of the largest reference
value (the bar of tests/test_dft_conv.py). The CUDA kernels are held
against the plain versions by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

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


# ---- the wgmma kernels' accumulation, emulated at the bounded chain's geometry ----
# The tensor cores add each depth-8 product of a wgmma into its f32 sum with
# a truncating (round toward zero) add. The f32 kernels sum each ACC_STEPS
# steps of depth 8 into a partial started afresh, and add the partials into
# the tile's sum with IEEE (round to nearest) adds.
ACC_STEPS = 2


def _rz_(x):
    """Round f64 values toward zero to f32's 24 significant bits, in place
    (kept as f64): the 29 low mantissa bits cleared."""
    x.view(torch.int64).bitwise_and_(-(1 << 29))
    return x


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_wgmma(terms, steps):
    """sum_s sign_s A_s @ B_s as the kernels form it: per depth-8 step, the
    terms (sign, A, B) in order, each block product exact (f64) and added
    with a truncating f32 add into a partial of ``steps`` steps; partials
    added in order with f32 round-to-nearest adds. A (M, K), B (K, N) f32,
    already TF32."""
    k = terms[0][1].shape[-1]
    chunks = -(-k // (8 * steps))
    pad = chunks * 8 * steps - k
    blocks = []
    for sign, a, b in terms:
        # (chunks, steps, M, 8) and (chunks, steps, 8, N), the sign in A (exact)
        a = (sign * F.pad(a.double(), (0, pad))).reshape(-1, chunks, steps, 8).permute(1, 2, 0, 3).contiguous()
        b = F.pad(b.double(), (0, 0, 0, pad)).reshape(chunks, steps, 8, b.shape[-1])
        blocks.append((a, b))
    part = None
    for s in range(steps):
        for a, b in blocks:
            prod = torch.bmm(a[:, s], b[:, s])
            part = _rz_(prod if part is None else part.add_(prod))
    part = part.float().reshape(chunks, *terms[0][1].shape[:-1], -1)
    acc = part[0]
    for c in range(1, chunks):
        acc = acc + part[c]
    return acc


def _cmm_wgmma(ar, ai, br, bi, steps, imag=True):
    """(ar + i ai)(br + i bi) (ai None: real A) in the kernels' 3xTF32 pass
    order: lo.hi, hi.lo, hi.hi (lo.lo dropped), each A part against the
    matching B part. Returns (re, im) (im None when not ``imag``)."""
    arh, arl = _split(ar)
    brh, brl = _split(br)
    bih, bil = _split(bi)
    if ai is None:
        re = [(1, arl, brh), (1, arh, brl), (1, arh, brh)]
        im = [(1, arl, bih), (1, arh, bil), (1, arh, bih)]
    else:
        aih, ail = _split(ai)
        re = [(1, arl, brh), (1, arh, brl), (-1, ail, bih), (-1, aih, bil), (1, arh, brh), (-1, aih, bih)]
        im = [(1, arl, bih), (1, arh, bil), (1, ail, brh), (1, aih, brl), (1, arh, bih), (1, aih, brh)]
    return _mm_wgmma(re, steps), _mm_wgmma(im, steps) if imag else None


def _conj_wgmma(ar, ai, fr, fi, steps):
    """(ar + i ai) (fr + i fi) over all P columns as the kernels' S2 and C2
    form it: the four real products against [Fr | Fi] of DFT columns
    0..P/2 in two partial sums (Tr, Ti), combined in f32 into columns c and
    P - c (F[k][P - c] = conj(F[k][c]))."""
    pad = fr.shape[-1]
    h = pad // 2 + 1
    bh, bl = _split(torch.cat([fr[:, :h], fi[:, :h]], dim=-1))
    arh, arl = _split(ar)
    aih, ail = _split(ai)
    p1 = _mm_wgmma([(1, arl, bh), (1, arh, bl), (1, arh, bh)], steps)
    p2 = _mm_wgmma([(1, ail, bh), (1, aih, bl), (1, aih, bh)], steps)
    a1, a3, a4, a2 = p1[..., :h], p1[..., h:], p2[..., :h], p2[..., h:]
    inner = torch.arange(pad // 2 - 1, 0, -1)  # columns P - c for c = P/2 - 1 .. 1
    hr = torch.cat([a1 - a2, (a1 + a2)[..., inner]], dim=-1)
    hi = torch.cat([a3 + a4, (a4 - a3)[..., inner]], dim=-1)
    return hr, hi


def _split_wgmma(er, ei, br, bi, steps):
    """E[:, :h]^T (br + i bi) (E P x P, B P x n) as the kernels' C3 forms it:
    rows k and P - k of E paired, S = a + b, D = a - b (a = E[k], b =
    E[P - k], 0 < k < P/2; S = a, D = 0 at k = 0, P/2), formed in f32, then
    [S | i D] (two segments of h columns, each padded with zeros to a
    multiple of 32) against the real [Br[:h]; Bi[:h]] in three TF32 passes."""
    pad = er.shape[-1]
    h = pad // 2 + 1
    seg = -(-h // 32) * 32
    k = torch.arange(h)
    inner = (k > 0) & (2 * k < pad)
    partner = (pad - k) % pad
    a_r, a_i = er[..., :h, :h].transpose(-1, -2), ei[..., :h, :h].transpose(-1, -2)  # E^T[c][k], c, k < h
    b_r = torch.where(inner, er[..., partner, :h].transpose(-1, -2), 0.0)  # E^T[c][P - k]
    b_i = torch.where(inner, ei[..., partner, :h].transpose(-1, -2), 0.0)
    s_r, s_i = a_r + b_r, a_i + b_i
    d_r, d_i = torch.where(inner, a_r - b_r, 0.0), torch.where(inner, a_i - b_i, 0.0)

    def segments(x, y):
        return torch.cat([F.pad(x, (0, seg - h)), F.pad(y, (0, seg - h))], dim=-1)

    ar, ai = segments(s_r, -d_i), segments(s_i, d_r)  # [S | i D]
    bh, bl = _split(torch.cat([F.pad(br[:h], (0, 0, 0, seg - h)), F.pad(bi[:h], (0, 0, 0, seg - h))], dim=-2))
    arh, arl = _split(ar)
    aih, ail = _split(ai)
    return (_mm_wgmma([(1, arl, bh), (1, arh, bl), (1, arh, bh)], steps),
            _mm_wgmma([(1, ail, bh), (1, aih, bl), (1, aih, bh)], steps))


def _mirror(xr, xi, pad):
    """Full P x P Hermitian arrays from rows 0..P/2: X[P - r][(P - c) % P] = conj(X[r][c])."""
    h = pad // 2 + 1
    cols = (-torch.arange(pad)) % pad
    rows = torch.arange(h, pad)
    src = pad - rows
    full_r = torch.cat([xr, xr[..., src, :][..., :, cols]], dim=-2)
    full_i = torch.cat([xi, -xi[..., src, :][..., :, cols]], dim=-2)
    return full_r, full_i


def _wgmma_chain(grids, kernels, out_size, offset, pad, steps):
    """The f32 kernels' six stages (csrc/dft_conv.cu) with their arithmetic
    emulated: S1, S2 the spectrum; C1-C4 the convolution."""
    fr, fi, br, bi = dft_conv.dft_matrices(pad, "cpu", torch.float32)
    m, size = kernels.shape[-1], grids.shape[-1]
    h = pad // 2 + 1
    w = slice(offset, offset + out_size)
    tr, ti = _cmm_wgmma(kernels.transpose(-1, -2), None, fr[:m, :h], fi[:m, :h], steps)  # S1: T^T
    ur, ui = _mirror(*_conj_wgmma(tr.transpose(-1, -2), ti.transpose(-1, -2), fr[:m], fi[:m], steps), pad)  # S2
    tr, ti = _cmm_wgmma(grids.transpose(-1, -2), None, fr[:size, :h], fi[:size, :h], steps)  # C1: T^T
    hr, hi = _conj_wgmma(tr.transpose(-1, -2), ti.transpose(-1, -2), fr[:size], fi[:size], steps)  # C2
    er, ei = hr * ur[..., :h, :] - hi * ui[..., :h, :], hr * ui[..., :h, :] + hi * ur[..., :h, :]
    er, ei = _mirror(er, ei, pad)
    t2r, t2i = _split_wgmma(er, ei, br[:, w], bi[:, w], steps)  # C3: T2^T, then the fold
    fold = torch.ones(h, 1)
    fold[1 : pad // 2] = 2.0
    t2r, t2i = t2r * fold, t2i * fold
    out, _ = _cmm_wgmma(t2r.transpose(-1, -2), t2i.transpose(-1, -2), br[:h, w], bi[:h, w], steps, imag=False)  # C4
    return ur, ui, out


# (pad, m, input size, offset): the clamped rescue's 508-wide 'valid'
# convolution at frame 768 (winw 126, 253^2 kernels), the 316-wide one at 384
BOUNDED = {"rescue768": (768, 253, 508, 252), "ext384": (384, 61, 316, 60)}


def _bounded_inputs(case, seed):
    pad, m, size, offset = BOUNDED[case]
    rng = np.random.RandomState(seed)
    grids = (rng.rand(1, size, size) * 50).astype(np.float32)
    kernels = rng.rand(1, m, m).astype(np.float32)
    return grids, kernels, offset, pad


def _bar_errors(got, want):
    ur, ui, out = got
    ur0, ui0, out0 = want
    scale_u = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    spec = float(torch.maximum((ur - ur0).abs().max(), (ui - ui0).abs().max())) / scale_u
    return spec, float((out - out0).abs().max()) / float(out0.abs().max())


@pytest.mark.parametrize("case", list(BOUNDED))
def test_wgmma_accumulation_within_1e5_at_the_bounded_shapes(case):
    """The f32 kernels' arithmetic at the bounded chain's shapes: TF32
    splits, truncating sums within each depth-16 partial, round-to-nearest
    adds between partials. K2 and K3 stay within 1e-5 of the largest value
    of the plain f32 chain, and within 1e-5 of the JAX package's
    ``dft_conv2d_ref``. K3 also stays within 2e-6 of an f64 chain, nearer
    than the plain f32 chain (2.3e-6 and 3.5e-6 here); partials of depth 32
    drift to 2.0-2.4e-6."""
    grids, kernels, offset, pad = _bounded_inputs(case, seed=11)
    g, k = torch.from_numpy(grids), torch.from_numpy(kernels)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(k, pad)
    want = (ur0, ui0, dft_conv.dft_conv2d_plain(g, ur0, ui0, 256, offset, pad))
    got = _wgmma_chain(g, k, 256, offset, pad, ACC_STEPS)
    spec, conv = _bar_errors(got, want)
    assert spec <= 1e-5 and conv <= 1e-5, (spec, conv)
    ref = dft_conv.dft_conv2d_plain(g.double(), *dft_conv.dft_conv_spectrum_plain(k.double(), pad), 256, offset, pad)
    assert float((got[2].double() - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    with jax.enable_x64(False):
        ref = np.asarray(jdft.dft_conv2d_ref(jnp.asarray(grids), jnp.asarray(kernels), 256, offset, pad=pad))
    np.testing.assert_allclose(got[2].numpy(), ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))


def test_wgmma_truncating_over_the_full_depth_misses_1e5():
    """Why the partials: the same arithmetic with one truncating sum over a
    stage's whole depth (no round-to-nearest adds) drifts past 1e-5 of the
    largest value of the 316-wide convolution at frame 384."""
    grids, kernels, offset, pad = _bounded_inputs("ext384", seed=11)
    g, k = torch.from_numpy(grids), torch.from_numpy(kernels)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(k, pad)
    want = (ur0, ui0, dft_conv.dft_conv2d_plain(g, ur0, ui0, 256, offset, pad))
    _, conv = _bar_errors(_wgmma_chain(g, k, 256, offset, pad, pad // 8), want)
    assert conv > 1e-5, conv


# ---- the f64 kernels' paired stages, emulated in f64 ----
# csrc/dft_conv.cu's f64 route: S1/C1 against [Fr | Fi'] of DFT columns
# c < P/2 (Fi' holds Fr's column P/2 in column 0's zero slot), S2/C2 take
# the columns c and P - c from one set of four real products, C2 writes C3's
# operand with E's rows k and P - k paired ([S | i D], h x P a pair), and C3
# and C4 multiply by the real rows of Bsplit ([Br[:, :h] | Bi[:, 1:P/2]]).


def _f64_s1(x, planes, pad):
    """S1/C1: T (K, h, n) from x (K, depth, n) as T^T = x^T [Fr | Fi']."""
    half, depth = pad // 2, x.shape[-2]
    xt = x.transpose(-1, -2)
    re = xt @ planes[0][:half, :depth].T  # B[k][c] = plane[c][k]
    im = xt @ planes[1][:half, :depth].T
    tr = torch.cat([re, im[..., :1]], dim=-1)  # column 0's Fi' slot: the real DFT column P/2
    ti = torch.cat([im[..., :1] * 0, im[..., 1:], im[..., :1] * 0], dim=-1)
    return tr.transpose(-1, -2), ti.transpose(-1, -2)


def _f64_conj(tr, ti, planes, pad):
    """S2/C2: (T F[:depth, :]) (K, h, P) from four real products against [Fr | Fi'] of c < P/2."""
    half, depth = pad // 2, tr.shape[-1]
    bf, bi = planes[0][:half, :depth].T, planes[1][:half, :depth].T
    a1, a3, a4, a2 = tr @ bf, tr @ bi, ti @ bf, ti @ bi
    inner = torch.arange(half - 1, 0, -1)  # columns P - c for c = P/2 - 1 .. 1
    hr = torch.cat([a1[..., :1], a1[..., 1:] - a2[..., 1:], a3[..., :1], (a1 + a2)[..., inner]], dim=-1)
    hi = torch.cat([a4[..., :1], a3[..., 1:] + a4[..., 1:], a2[..., :1], (a4 - a3)[..., inner]], dim=-1)
    return hr, hi


def _f64_paired_chain(grids, kernels, out_size, offset, pad):
    planes = dft_conv.f64_planes(pad, "cpu")
    h = pad // 2 + 1
    w = slice(offset, offset + out_size)
    ur, ui = _mirror(*_f64_conj(*_f64_s1(kernels, planes, pad), planes, pad), pad)  # S1, S2
    hr, hi = _f64_conj(*_f64_s1(grids, planes, pad), planes, pad)  # C1, C2
    er, ei = hr * ur[..., :h, :] - hi * ui[..., :h, :], hr * ui[..., :h, :] + hi * ur[..., :h, :]
    # C2's epilogue: row c of [S | i D] from a = E[k][c], b = conj(E[k][P - c]) = E[P - k][c]
    cols = torch.arange(h)
    ar, ai = er[..., :, :h].transpose(-1, -2), ei[..., :, :h].transpose(-1, -2)  # (K, c, k)
    br, bi = er[..., :, (pad - cols) % pad].transpose(-1, -2), -ei[..., :, (pad - cols) % pad].transpose(-1, -2)
    inner = (cols > 0) & (2 * cols < pad)
    s_r, s_i = torch.where(inner, ar + br, ar), torch.where(inner, ai + bi, ai)
    a3r = torch.cat([s_r, (bi - ai)[..., 1 : pad // 2]], dim=-1)  # i D = i (a - b) at column h + k - 1
    a3i = torch.cat([s_i, (ar - br)[..., 1 : pad // 2]], dim=-1)
    bsplit = planes[2][w].T  # (P, out_size)
    t2r, t2i = a3r @ bsplit, a3i @ bsplit  # C3: T2^T (K, h, out_size)
    fold = torch.where(inner, 2.0, 1.0).to(torch.float64)[:, None]
    a4 = torch.cat([fold * t2r, -(fold * t2i)[..., 1 : pad // 2, :]], dim=-2).transpose(-1, -2)  # (K, out, P)
    return ur, ui, a4 @ bsplit  # C4


# (pad, m, input size, offset): bounded parity's 324-wide periodic extensions at
# 512 (69^2 kernels, the slice at 2 winw = 68) and the 2-pair bucket at 768
# (197^2 kernels, 452-wide extensions, the slice at 196)
F64_PAIRED = {"ext324-512": (512, 69, 324, 68, 3), "bucket197-768": (768, 197, 452, 196, 2)}


@pytest.mark.parametrize("case", list(F64_PAIRED))
def test_f64_paired_stages_within_1e12_of_plain_and_jax(case):
    """The f64 kernels' algebra: conjugate-pair columns, the Nyquist column in
    column 0's slot, E's rows k and P - k paired into C3's operand, C3 and C4
    against Bsplit; within 1e-12 of the largest value of the plain chain
    and of the JAX package's f64 XLA chain (spectra and convolution)."""
    pad, m, size, offset, k = F64_PAIRED[case]
    rng = np.random.RandomState(17)
    grids = rng.rand(k, size, size) * 50
    kernels = rng.rand(k, m, m)
    g, w = torch.from_numpy(grids), torch.from_numpy(kernels)
    ur, ui, out = _f64_paired_chain(g, w, 256, offset, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(w, pad)
    out0 = dft_conv.dft_conv2d_plain(g, ur0, ui0, 256, offset, pad)
    with jax.enable_x64(True):
        j_ur, j_ui = jdft.dft_conv_spectrum_xla(jnp.asarray(kernels, jnp.float64), pad=pad, precision="f64")
        j_out = jdft.dft_conv2d_xla(jnp.asarray(grids, jnp.float64), j_ur, j_ui, 256, offset, pad=pad, precision="f64")
        j_ur, j_ui, j_out = (np.asarray(a, np.float64) for a in (j_ur, j_ui, j_out))
    for want_u, want_out in (((ur0.numpy(), ui0.numpy()), out0.numpy()), ((j_ur, j_ui), j_out)):
        scale = max(np.abs(want_u[0]).max(), np.abs(want_u[1]).max())
        for got, want in zip((ur.numpy(), ui.numpy()), want_u):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-12 * np.abs(want_out).max())
