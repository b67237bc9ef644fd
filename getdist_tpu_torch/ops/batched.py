"""Fused all-params / all-pairs KDE pipeline on a torch device.

Counterpart of ``getdist_tpu/ops/batched.py``: all 1D and all-pairs 2D
marginalized densities of a weighted chain, with the same stages, the same
f32 arithmetic and the same output dicts. Plain tensor code is PyTorch
(eager, batched over parameters and pairs where JAX used ``vmap``); the
two Pallas kernels on this path are CUDA kernels:

* pair histograms -> :func:`getdist_tpu_torch.ops.pair_hist.pair_histograms`
* 2D convolutions -> :mod:`getdist_tpu_torch.ops.dft_conv`

The fused path's branches are ported: hard limits, periodic parameters,
like weights (mean-likelihood grids) and prior masks in both stages,
in-program pair histograms at any fine grid up to 1024 bins (the regrid
reruns of ``MCSamples.fastTriangleDensities``), the 2D stage's
parity-mode branches (``exact_mult_bias``, ``hists_in`` at any fine
grid, f64), and the sharded hooks (``group=``, a ``torch.distributed``
process group, used by :mod:`getdist_tpu_torch.parallel`, with every
branch above). The TPU workarounds are
not carried over: there is no bf16 weight split (the histogram kernel
accumulates int32 or f32 weights directly), no chunked inverse FFT, no
x64 toggling and no VMEM/HBM sizing of histogram tiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from getdist_tpu_torch.ops import collectives as coll
from getdist_tpu_torch.ops._cuda import full_fp32_matmuls, resolve_device
from getdist_tpu_torch.ops.dft_conv import dft_conv2d, dft_conv_spectrum, frame_for
from getdist_tpu_torch.ops.fft import dct
from getdist_tpu_torch.ops.pair_hist import narrow_rows, narrow_weights, pair_histograms

# profiler ranges of the stages ("1d:...", "2d:..."); microseconds each while no profiler runs
_stage = torch.profiler.record_function

__all__ = [
    "prepare_chain",
    "pair_cumulant_score",
    "all_1d_densities",
    "all_2d_densities",
    "triangle_densities",
]

_ROOT_PI = math.sqrt(math.pi)
_PI_SQ = math.pi**2
_ISJ_LMAX = 7
# stage constants for the 1D ISJ recursion, j = lmax-1 .. 2
_ISJ_CONSTS = tuple(
    float((1 + 0.5 ** (j + 0.5)) / 3 * np.prod(np.arange(1, 2 * j, 2)) / (_ROOT_PI / np.sqrt(2.0)))
    for j in range(_ISJ_LMAX - 1, 1, -1)
)
# 2D even-order kernel constants K[j] = phi^(2j)(0)
_K_EVEN = tuple(
    [1 / math.sqrt(2 * math.pi)]
    + [float((-1) ** j * np.prod(np.arange(1, 2 * j, 2)) / np.sqrt(2 * np.pi)) for j in range(1, 5)]
)
# odd-order kernel constants phi-odd[j]
_K_ODD = tuple([1.0] + [float(np.prod(np.arange(1, 2 * j, 2)) / 2.0 ** (j + 1) / _ROOT_PI) for j in range(1, 9)])
_EVEN_LEVELS = {lv: [(i, lv - i) for i in range(lv + 1)] for lv in range(6)}
_ODD_LEVELS = {
    10: ((7, 3), (5, 5), (3, 7), (1, 9), (9, 1)),
    8: ((5, 3), (3, 5), (1, 7), (7, 1)),
    6: ((3, 3), (1, 5), (5, 1)),
    4: ((1, 3), (3, 1)),
}
_QBINS = 1024  # histogram resolution for quantile estimation
_W_LO, _W_HI = 1e-3, 0.3
# a bisection whose bracket stops shrinking (NaN-free f32 can stall one ulp
# above its tolerance) ends here instead of spinning; JAX would loop forever
_MAX_BISECT = 200


def _tensor(x, device, dtype=torch.float32):
    """A numpy array, list or tensor as a contiguous tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    arr = np.ascontiguousarray(np.asarray(x), dtype=_NP_DTYPES[dtype])
    if not arr.flags.writeable:  # torch.from_numpy shares memory and needs a writable buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


_NP_DTYPES = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.int64: np.int64,
    torch.int32: np.int32,
    torch.bool: np.bool_,
}


def prepare_chain(samples, weights, device="cuda", dtype=torch.float32):
    """Move a chain to ``device``: samples (N, P), weights (N,), as ``dtype``
    (numpy chains are rounded to f32 on the host, as the JAX package does).
    Raises when ``device`` is CUDA and no card is present."""
    device = resolve_device(device)
    return _tensor(samples, device, dtype), _tensor(weights, device, dtype)


@full_fp32_matmuls()
def pair_cumulant_score(samples, weights, group=None):
    """|k31| + |k13| + |k22| standardized joint cumulants for every param
    pair, as a (P, P) tensor on the samples' device. These vanish for
    jointly-Gaussian pairs, so the host uses them to gate the fragile-
    bandwidth f64 assist (``MCSamples._fast_regrid_plan``): genuinely
    non-Gaussian zoo shapes measure 0.4-3.4 where Gaussian chains stay
    below ~0.11. The products run in full FP32 (no TF32). With ``group``,
    ``samples`` / ``weights`` are this rank's block and every sum over
    samples is all-reduced: each rank returns the same score."""
    wn = weights / coll.psum(torch.sum(weights), group)
    zc = samples - coll.psum(torch.matmul(wn, samples), group)
    zc = zc / torch.sqrt(coll.psum(torch.matmul(wn, zc * zc), group))
    z2 = zc * zc
    zw = zc * wn[:, None]
    rho = coll.psum(torch.matmul(zw.T, zc), group)
    k31 = coll.psum(torch.matmul((z2 * zw).T, zc), group) - 3 * rho
    k22 = coll.psum(torch.matmul((z2 * wn[:, None]).T, z2), group) - 1 - 2 * rho * rho
    return torch.abs(k31) + torch.abs(k31).T + torch.abs(k22)


# ---------------------------------------------------------------------------
# histograms, ranges, N_eff
# ---------------------------------------------------------------------------


def _hist_rows(ix_rows, weights, nbins, group=None):
    """(P, nbins) weighted histograms of (P, N) integer index rows, summed
    in f64 (exact for integer weights, order independent), over the ranks
    of ``group`` too, and then cast to the weights' type; the role of the
    JAX package's one-hot ``_onehot_hist_rows`` (and its psum)."""
    p = ix_rows.shape[0]
    out = torch.zeros((p, nbins), dtype=torch.float64, device=ix_rows.device)
    out.scatter_add_(1, ix_rows.to(torch.int64), weights.to(torch.float64).expand(p, -1))
    return coll.psum(out, group).to(weights.dtype)


def _quantiles_from_hist(hist, edges_lo, width, probs):
    """Approximate weighted quantiles from fine histograms (P, Q): linear
    interpolation on the cumulative mass. probs: (nq,). Returns (P, nq)."""
    cum = torch.cumsum(hist, dim=1)
    targets = probs[None, :] * cum[:, -1:]
    ix = torch.clamp(torch.searchsorted(cum, targets), 0, _QBINS - 1)
    prev = torch.where(ix > 0, cum.gather(1, torch.clamp(ix - 1, min=0)), 0.0)
    h_ix = hist.gather(1, ix)
    frac = torch.where(h_ix > 0, (targets - prev) / torch.clamp(h_ix, min=1e-30), 0.0)
    return edges_lo[:, None] + (ix + frac) * width[:, None]


def _lag_grid(n, max_lag=None, num=40):
    """Static log-spaced lag grid for the N_eff estimator, lags 1 .. n//10."""
    top = max(n // 10, 2)
    if max_lag is not None:
        top = min(max_lag, top)
    ks = np.unique(np.geomspace(1, top, num).astype(np.int64))
    return tuple(int(k) for k in ks)


@_stage("1d:neff")
def _neff_kde_batch(values, weights, sigmas, lags, group=None, n_samples=None):
    """Gaussian-KDE effective sample numbers for all parameters: corr_k
    pair sums on the lag grid with an uncorrelated far-lag baseline,
    trapezoid-integrated until the first drop below 0.05 corr0.
    values: (P, N) local columns. Returns (P,).

    ``group`` (replaces the JAX hooks ``axis_name``/``axis_size``): each
    rank holds one contiguous block of N samples. It receives the next
    rank's first max(lags) columns (the last rank gets zeros, whose zero
    weights drop the pairs past the chain's end), so the short-lag sums are
    the true global sums. The uncorrelated baseline pairs each sample with
    the one a global lag L + j away (j < 5): from the block L // n ranks
    on, and the blocks after it as far as the window reaches. Every sum is
    all-reduced. By default L = (ranks // 2) x block, and the exchanges are
    the JAX package's permutations (a full block from half a group away,
    the head of the next), which also hold for an odd rank count.
    ``n_samples``: the chain's length when the last blocks end in
    zero-weight padding; the pair counts and L = n_samples // 2 are then
    the unsharded estimator's, so the sums run over its pairs."""
    n = values.shape[1]
    world = coll.size(group)
    min_corr = 0.05
    kernel_std = sigmas * 0.2
    inv2 = 1.0 / (4.0 * kernel_std**2)

    def pair_sum(left, left_w, right, right_w):
        diff2 = (left - right) ** 2 * inv2[:, None]
        return torch.sum(torch.exp(-diff2) * left_w[None, :] * right_w[None, :], dim=1)

    n_base = 5
    if world > 1:
        perm = [(d, d - 1) for d in range(1, world)]
        max_lag = max(lags)
        ext = torch.cat([values, coll.ppermute(values[:, :max_lag], group, perm)], dim=1)
        ext_w = torch.cat([weights, coll.ppermute(weights[:max_lag], group, perm)])

        def lag_sum(k):  # pairs (i, i + k) for every local i; past n the partner is in the halo
            return pair_sum(values, weights, ext[:, k : k + n], ext_w[k : k + n])

        uncorr_len = (world // 2) * n if n_samples is None else n_samples // 2
        ranks_away, offset = divmod(uncorr_len, n)
        # columns [offset, offset + n + n_base) of the blocks from ranks_away
        # ranks on (plus 2 spare, as the JAX head of n_base + 2 has); ranks
        # past the last one send zeros
        need = offset + n + n_base + 2
        parts, parts_w = [], []
        while sum(part.shape[1] for part in parts) < need:
            take = min(n, need - sum(part.shape[1] for part in parts))
            away = ranks_away + len(parts)
            perm_away = [(d, d - away) for d in range(away, world)]
            parts.append(coll.ppermute(values[:, :take], group, perm_away))
            parts_w.append(coll.ppermute(weights[:take], group, perm_away))
        base = torch.cat(parts, dim=1)
        base_w = torch.cat(parts_w)

        def base_sum(j):
            return pair_sum(values, weights, base[:, offset + j : offset + j + n], base_w[offset + j : offset + j + n])

    else:

        def lag_sum(k):  # pairs (i, i + k) for i < n - k
            return pair_sum(values[:, : n - k], weights[: n - k], values[:, k:], weights[k:])

        uncorr_len = n // 2

        def base_sum(j):
            return lag_sum(uncorr_len + j)

    n_global = world * n if n_samples is None else n_samples
    uncorr = coll.psum(sum(base_sum(j) for j in range(n_base)), group)
    nav = sum(n_global - (uncorr_len + j) for j in range(n_base))
    uncorr_term = uncorr / nav

    corr0 = coll.psum(torch.sum(weights * weights), group)
    corr_k = coll.psum(torch.stack([lag_sum(k) for k in lags]), group)  # (L, P)
    n_pairs_k = torch.tensor([n_global - k for k in lags], dtype=values.dtype, device=values.device)[:, None]
    corr_k = corr_k - n_pairs_k * uncorr_term[None, :]
    alive = torch.cumprod((corr_k >= min_corr * corr0).to(corr_k.dtype), dim=0)  # stop at first drop
    contrib = corr_k * alive
    steps = np.diff(np.concatenate([[0], np.asarray(lags)])).astype(np.float64)
    weights_lag = torch.tensor(
        (steps + np.append(np.diff(np.asarray(lags)), 0)) / 2.0, dtype=values.dtype, device=values.device
    )
    total = corr0 + 2.0 * torch.sum(contrib * weights_lag[:, None], dim=0)
    return coll.psum(torch.sum(weights), group) ** 2 / total


# ---------------------------------------------------------------------------
# 1D ISJ bandwidth
# ---------------------------------------------------------------------------


def _bisect(fn, lo, hi, tol):
    """Per-row bisection for the root of ``fn`` (negative below it), with the
    semantics of a vmapped ``lax.while_loop``: a row freezes once its own
    bracket is narrower than ``tol``, and the loop runs until every row is
    done. Returns the final (lo, hi)."""
    active = (hi - lo) > tol
    for _ in range(_MAX_BISECT):
        if not bool(active.any()):
            break
        mid = 0.5 * (lo + hi)
        below = fn(mid) < 0
        lo = torch.where(active & below, mid, lo)
        hi = torch.where(active & ~below, mid, hi)
        active = (hi - lo) > tol
    return lo, hi


def _isj_log_gamma(h2_pi2, big_i, log_i, log_a2, neff):
    """log of the gamma functional chain of the 1D ISJ fixed point, in
    log space (log-sum-exp over the DCT modes). h2_pi2: (R, S) = pi^2 h^2
    for S trial widths per row; log_a2: (R, F); neff: (R,). Returns (R, S)."""

    def log_f(j, t):
        e = j * log_i - big_i * t[..., None] + log_a2[:, None, :]
        m = torch.amax(e, dim=-1)
        return torch.log(torch.sum(torch.exp(e - m[..., None]), dim=-1)) + m + math.log(2.0) + 2 * j * math.log(math.pi)

    lf = log_f(float(_ISJ_LMAX), h2_pi2)
    log_neff = torch.log(neff)[:, None]
    for j, const in zip(range(_ISJ_LMAX - 1, 1, -1), _ISJ_CONSTS):
        log_t = (2.0 / (3.0 + 2 * j)) * (math.log(const) - log_neff - lf)
        lf = log_f(float(j), _PI_SQ * torch.exp(log_t))
    return lf


@_stage("1d:isj_bandwidth")
def _isj_bandwidth_1d(bins, neff):
    """ISJ bandwidths (fractions of the bin range) of (R, nb) histograms by
    bisection on f(h) = h - (2 N sqrt(pi) gamma(h))^{-1/5}, bracketed by a
    16-seed log grid. Returns (h, ok), each (R,)."""
    nb = bins.shape[1]
    dtype, device = bins.dtype, bins.device
    big_i = torch.arange(1, nb, dtype=dtype, device=device) ** 2
    log_i = torch.log(big_i)
    a = dct(bins / torch.sum(bins, dim=1, keepdim=True), dim=1)
    log_a2 = torch.log((a[:, 1:] / 2) ** 2)  # -inf (zero coefficients) drop out of the LSE
    log_norm = torch.log(2 * neff * _ROOT_PI)[:, None]

    def residual(h):  # h: (R, S)
        lf = _isj_log_gamma(_PI_SQ * h**2, big_i, log_i, log_a2, neff)
        return h - torch.exp(-0.2 * (log_norm + lf))

    n_scale = neff ** (-1.0 / 5)
    lo0 = 0.019 * n_scale
    hi0 = 0.6
    seeds = lo0[:, None] * (hi0 / lo0[:, None]) ** torch.linspace(0.0, 1.0, 16, dtype=dtype, device=device)[None, :]
    rs = residual(seeds)
    cross = (rs[:, :-1] < 0) & (rs[:, 1:] >= 0)
    ok = torch.any(cross, dim=1)
    first = torch.argmax(cross.to(torch.int32), dim=1, keepdim=True)
    lo = seeds.gather(1, first)[:, 0]
    hi = seeds.gather(1, first + 1)[:, 0]
    lo, hi = _bisect(lambda h: residual(h[:, None])[:, 0], lo, hi, 1e-7 * n_scale)
    return 0.5 * (lo + hi), ok


# ---------------------------------------------------------------------------
# 2D kernel optimizer (batched over pairs)
# ---------------------------------------------------------------------------


def _even_table_2d(psi_multi, neff, t_star, min_level=0):
    """Level-by-level plug-in table of the even psi functionals; each level's
    functionals are evaluated in one ``psi_multi(keys, ts)`` pass."""
    keys = _EVEN_LEVELS[5]
    table = dict(zip(keys, psi_multi(keys, [t_star] * len(keys)).unbind(-1)))
    for level in range(4, min_level - 1, -1):
        const = (1 + 0.5 ** (level + 1)) / 3
        keys = _EVEN_LEVELS[level]
        ts = []
        for sx, sy in keys:
            children = table[(sx + 1, sy)] + table[(sx, sy + 1)]
            ts.append((-2 * const * _K_EVEN[sx] * _K_EVEN[sy] / neff / children) ** (1.0 / (2 + level)))
        table.update(zip(keys, psi_multi(keys, ts).unbind(-1)))
    return table


def _psi_multi_dct(a2, big_i, log_i, orders, ts):
    """Even psi functionals on squared-DCT spectra a2 (K, F, F) for the
    ``orders`` at widths ``ts`` (each (K,)): one pass over a2. Returns (K, k)."""
    t_vec = torch.stack(ts, dim=-1)  # (K, k)
    damp = -big_i * (_PI_SQ * t_vec[..., None])  # (K, k, F)
    sx = torch.tensor([s[0] for s in orders], dtype=a2.dtype, device=a2.device)[:, None]
    sy = torch.tensor([s[1] for s in orders], dtype=a2.dtype, device=a2.device)[:, None]
    wx = torch.exp(damp + log_i * sx)
    wy = torch.exp(damp + log_i * sy)
    g = torch.matmul(a2, wx.transpose(-1, -2))  # (K, F, k)
    vals = torch.sum(wy.transpose(-1, -2) * g, dim=-2)
    scale = [(-1) ** (s[0] + s[1]) * np.pi ** (2 * (s[0] + s[1])) / 4 for s in orders]
    return vals * torch.tensor(scale, dtype=a2.dtype, device=a2.device)


def _psi_multi_pow(power, freqs, exponents, ts, signs):
    """psi functionals on FFT power spectra (K, F_y, F_x): weights
    damp * f^exponent per axis, one pass over the power. Returns (K, k)."""
    t_vec = torch.stack(ts, dim=-1)  # (K, k)
    damp = torch.exp(-(freqs**2) * (4 * _PI_SQ) * t_vec[..., None])  # (K, k, F)
    wx = damp * torch.stack([freqs ** s[0] for s in exponents])
    wy = damp * torch.stack([freqs ** s[1] for s in exponents])
    g = torch.matmul(power, wx.transpose(-1, -2))  # (K, F, k)
    vals = torch.sum(wy.transpose(-1, -2) * g, dim=-2)
    scale = [sg * (2 * np.pi) ** (s[0] + s[1]) for s, sg in zip(exponents, signs)]
    return vals * torch.tensor(scale, dtype=power.dtype, device=power.device)


def _odd_table_2d(power, freqs, neff, p00, t_star):
    """Plug-in table of the odd functionals psi_13 / psi_31, level-batched.
    The power is antisymmetrized pairwise in each frequency sign first, so
    the near-total +-f cancellation happens elementwise, not across the f32
    accumulation."""

    def negate_axis(m, dim):
        return torch.roll(torch.flip(m, dims=(dim,)), 1, dims=dim)

    power = 0.5 * (power - negate_axis(power, 1))
    power = 0.5 * (power - negate_axis(power, 2))
    keys = _ODD_LEVELS[10]
    ones = [1.0] * len(keys)
    table = dict(zip(keys, _psi_multi_pow(power, freqs, keys, [t_star] * len(keys), ones).unbind(-1)))
    for level in (8, 6, 4):
        const = 8 * (1 - 2.0 ** (-level - 1)) / 3.0
        keys = _ODD_LEVELS[level]
        ts = []
        for sx, sy in keys:
            children = table[(sx + 2, sy)] + table[(sx, sy + 2)]
            ts.append((const * p00 * _K_ODD[sx] * _K_ODD[sy] / neff**2 / children**2) ** (1.0 / (3 + level)))
        table.update(zip(keys, _psi_multi_pow(power, freqs, keys, ts, [1.0] * len(keys)).unbind(-1)))
    return table


def _amise_2d(wx, wy, rho, p, neff):
    """Asymptotic MISE of a correlated Gaussian kernel and its bias part;
    p = (p40, p04, p22, p31, p13)."""
    p40, p04, p22, p31, p13 = p
    variance = 1.0 / (4 * np.pi * wx * wy * torch.sqrt(1 - rho**2) * neff)
    quartic = (
        wx**4 * p40
        + wy**4 * p04
        + 2 * wx**2 * wy**2 * p22 * (2 * rho**2 + 1)
        + 4 * rho * wx * wy * (wx**2 * p31 + wy**2 * p13)
    )
    return variance + 0.25 * quartic, 0.25 * quartic


def _amise_grad(wx, wy, rho, p, neff):
    """Analytic d(AMISE)/d(wx, wy, rho) (rows are independent, so this is
    the per-row gradient ``jax.grad`` gives the JAX package)."""
    p40, p04, p22, p31, p13 = p
    variance = 1.0 / (4 * np.pi * wx * wy * torch.sqrt(1 - rho**2) * neff)
    c22 = p22 * (2 * rho**2 + 1)
    d_wx = -variance / wx + 0.25 * (
        4 * wx**3 * p40 + 4 * wx * wy**2 * c22 + 4 * rho * wy * (3 * wx**2 * p31 + wy**2 * p13)
    )
    d_wy = -variance / wy + 0.25 * (
        4 * wy**3 * p04 + 4 * wx**2 * wy * c22 + 4 * rho * wx * (wx**2 * p31 + 3 * wy**2 * p13)
    )
    d_rho = variance * rho / (1 - rho**2) + 0.25 * (
        8 * wx**2 * wy**2 * p22 * rho + 4 * wx * wy * (wx**2 * p31 + wy**2 * p13)
    )
    return d_wx, d_wy, d_rho


def _amise_minimize(p, neff, wx0, wy0, rho0, free_rho, iters=60):
    """Fixed-iteration bounded AMISE minimization, batched over pairs and
    over five correlation seeds: widths through a logistic transform,
    correlation through 0.99 tanh (only when ``free_rho``), backtracking
    gradient descent. Returns (wx, wy, rho, val, ok), each (K,)."""
    span = _W_HI - _W_LO
    rho_cap = 0.99

    def to_u(w):
        frac = torch.clamp((w - _W_LO) / span, 1e-6, 1 - 1e-6)
        return torch.log(frac / (1 - frac))

    pk = tuple(q[:, None] for q in p)
    nk = neff[:, None]
    r0 = rho0[:, None]

    def unpack(z):
        wx = _W_LO + span * torch.sigmoid(z[0])
        wy = _W_LO + span * torch.sigmoid(z[1])
        rho = rho_cap * torch.tanh(z[2]) if free_rho else r0.expand_as(wx)
        return wx, wy, rho

    def objective(z):
        return _amise_2d(*unpack(z), pk, nk)[0]

    def gradient(z):
        wx, wy, rho = unpack(z)
        d_wx, d_wy, d_rho = _amise_grad(wx, wy, rho, pk, nk)
        sx = torch.sigmoid(z[0])
        sy = torch.sigmoid(z[1])
        g_rho = d_rho * rho_cap * (1 - torch.tanh(z[2]) ** 2) if free_rho else torch.zeros_like(z[2])
        return d_wx * span * sx * (1 - sx), d_wy * span * sy * (1 - sy), g_rho

    u0 = torch.atanh(torch.clamp(rho0 / rho_cap, -0.999, 0.999))
    seeds = [u0] + [torch.full_like(u0, math.atanh(r / rho_cap)) for r in (-0.75, -0.35, 0.35, 0.75)]
    z2 = torch.stack(seeds, dim=1)  # (K, 5)
    z = (to_u(wx0)[:, None].expand_as(z2), to_u(wy0)[:, None].expand_as(z2), z2)
    step = torch.full_like(z2, 0.25)
    for _ in range(iters):
        g = gradient(z)
        cand = tuple(zi - step * gi for zi, gi in zip(z, g))
        better = objective(cand) < objective(z)
        z = tuple(torch.where(better, ci, zi) for ci, zi in zip(cand, z))
        step = torch.where(better, step * 1.2, step * 0.5)
    best = torch.argmin(objective(z), dim=1, keepdim=True)
    z = tuple(zi.gather(1, best)[:, 0] for zi in z)
    wx = _W_LO + span * torch.sigmoid(z[0])
    wy = _W_LO + span * torch.sigmoid(z[1])
    rho = rho_cap * torch.tanh(z[2]) if free_rho else rho0
    val, bias = _amise_2d(wx, wy, rho, p, neff)
    ok = torch.isfinite(val) & (bias > 0)
    return wx, wy, rho, val, ok


def _kernel_bandwidth_2d(hist, neff, sample_corr, do_correlation, fallback_t, power_override=None, use_override=None):
    """(wx, wy, rho, ok, fragile) per pair: the full 2D bandwidth-matrix
    optimization, batched over the (K, F, F) histograms.

    t* by bisection on the 2D fixed point (``fallback_t`` replacing a failed
    or badly overshooting one), closed-form diagonal widths, then, where
    ``do_correlation``, AMISE searches at the sample correlation and with
    free correlation (the latter accepted only on a >10% win). Rows with
    ``use_override`` evaluate the functionals on ``power_override`` (their
    sheared FFT power spectrum) instead of the histogram's own spectra."""
    k, size, _ = hist.shape
    dtype, device = hist.dtype, hist.device
    normed = hist / torch.sum(hist, dim=(1, 2), keepdim=True)
    big_i = torch.arange(1, size, dtype=dtype, device=device) ** 2
    log_i = torch.log(big_i)
    a2 = dct(dct(normed, dim=1), dim=2)[:, 1:, 1:] ** 2
    freqs = torch.fft.fftfreq(size, d=1.0 / size, device=device).to(dtype)
    spec = torch.fft.fft2(normed)
    power = torch.real(spec * torch.conj(spec)).contiguous()
    power[:, 0, :] = 0.0
    power[:, :, 0] = 0.0
    if power_override is not None:
        power = torch.where(use_override[:, None, None], power_override, power)

    def psi_even_multi(keys, ts):
        ts = [torch.as_tensor(t, dtype=dtype, device=device).expand(k) for t in ts]
        from_dct = _psi_multi_dct(a2, big_i, log_i, keys, ts)
        if power_override is None:
            return from_dct
        doubled = [(2 * s[0], 2 * s[1]) for s in keys]
        signs = [(-1.0) ** (s[0] + s[1]) for s in keys]
        from_pow = _psi_multi_pow(power, freqs, doubled, ts, signs)
        return torch.where(use_override[:, None], from_pow, from_dct)

    def fixed_point(t):
        table = _even_table_2d(psi_even_multi, neff, t, min_level=2)
        curvature = table[(0, 2)] + table[(2, 0)] + 2 * table[(1, 1)]
        implied = (2 * np.pi * neff * curvature) ** (-1.0 / 3)
        return (t - implied) / implied

    lo = torch.full((k,), 1e-8, dtype=dtype, device=device)
    hi = torch.full((k,), 0.1, dtype=dtype, device=device)
    ok = (fixed_point(lo) < 0) & (fixed_point(hi) > 0)
    lo, hi = _bisect(fixed_point, lo, hi, 1e-6)
    t_star = 0.5 * (lo + hi)
    # replace a failed bracket or a badly overshooting fixed point with the
    # plug-in width
    overshoot = (t_star > 0.01) & (t_star > 2 * fallback_t)
    t_star = torch.where(ok & ~overshoot, t_star, fallback_t)

    table = _even_table_2d(psi_even_multi, neff, t_star)
    pyy, pxx, pxy = table[(0, 2)], table[(2, 0)], table[(1, 1)]
    cross = pxy + torch.sqrt(pxx * pyy)
    denom = 4 * np.pi * neff * cross
    wx = (pyy ** (3.0 / 4) / (denom * pxx ** (3.0 / 4))) ** (1.0 / 6)
    wy = (pxx ** (3.0 / 4) / (denom * pyy ** (3.0 / 4))) ** (1.0 / 6)
    ok = torch.isfinite(wx) & torch.isfinite(wy) & (wx > 0) & (wy > 0)
    wx = torch.where(ok, wx, 0.05)
    wy = torch.where(ok, wy, 0.05)

    # odd functionals from the (possibly sheared) FFT power, clamped to the
    # Cauchy-Schwarz bound |psi_31| <= sqrt(psi_40 psi_22); a binding clamp
    # means the correlation search below runs blind in f32
    odd = _odd_table_2d(power, freqs, neff, table[(0, 0)], t_star)
    bound_31 = torch.sqrt(pxx * pxy)
    bound_13 = torch.sqrt(pyy * pxy)
    clamp_bind = (torch.abs(odd[(3, 1)]) > bound_31) | (torch.abs(odd[(1, 3)]) > bound_13)
    p = (
        pxx,
        pyy,
        pxy,
        torch.minimum(torch.maximum(odd[(3, 1)], -bound_31), bound_31),
        torch.minimum(torch.maximum(odd[(1, 3)], -bound_13), bound_13),
    )

    best, _ = _amise_2d(wx, wy, torch.zeros_like(wx), p, neff)
    rho = torch.zeros_like(wx)
    # search 1: kernel correlation fixed at the sample correlation
    has_corr = torch.abs(sample_corr) > 1e-12
    shrink = torch.sqrt(1 - torch.abs(sample_corr))
    wx1, wy1, rho1, val1, ok1 = _amise_minimize(p, neff, wx / shrink, wy / shrink, sample_corr, False)
    take1 = do_correlation & has_corr & ok1 & (val1 < best)
    wxc = torch.where(take1, wx1, wx)
    wyc = torch.where(take1, wy1, wy)
    rho = torch.where(take1, rho1, rho)
    best = torch.where(take1, val1, best)
    # search 2: free correlation, accepted only on a clear (10%) win
    wx2, wy2, rho2, val2, ok2 = _amise_minimize(p, neff, wxc, wyc, sample_corr, True)
    take2 = do_correlation & ok2 & (val2 < best * 0.9)
    # FRAGILE: the search ran blind (clamp bound) and the free search failed,
    # made no progress, or sat in the band around the 10%-win threshold
    edge_band = (val2 > best * 0.88) & (val2 < best * 0.92)
    good2 = ok2 & (val2 > 0) & (val2 <= best * 0.98) & ~edge_band
    fragile = do_correlation & clamp_bind & ~good2
    wxc = torch.where(take2, wx2, wxc)
    wyc = torch.where(take2, wy2, wyc)
    rho = torch.where(take2, rho2, rho)
    return wxc, wyc, rho, ok, fragile


# ---------------------------------------------------------------------------
# shearing of correlated pairs
# ---------------------------------------------------------------------------


def _shear_plan_2d(cov_aa, cov_ab, cov_bb, swap):
    """Per-pair shear decomposition: (r0, r1, S) with sheared second
    coordinate p2 = r0 p_i + r1 p_j and S (K, 2, 2) the scaled Cholesky root
    mapping kernel covariances back; ``swap`` exchanges (a, b) first."""
    caa = torch.where(swap, cov_bb, cov_aa)
    cbb = torch.where(swap, cov_aa, cov_bb)
    s00 = torch.sqrt(caa)
    s10 = cov_ab / s00
    s11 = torch.sqrt(cbb - s10**2)
    i00 = 1.0 / s00
    r0 = (-s10 / (s00 * s11)) / i00
    r1 = (1.0 / s11) / i00
    s_mat = torch.stack([torch.stack([s00, torch.zeros_like(s00)], -1), torch.stack([s10, s11], -1)], -2)
    return r0, r1, s_mat * i00[:, None, None]


def _shear_kernel_back(hx, hy, c, s_mat, swap):
    """Map sheared-space kernels (hx, hy, c) back through S (data units)."""
    k00 = hx**2
    k01 = hx * hy * c
    k11 = hy**2
    kmat = torch.stack([torch.stack([k00, k01], -1), torch.stack([k01, k11], -1)], -2)
    kc = torch.matmul(torch.matmul(s_mat, kmat), s_mat.transpose(-1, -2))
    out_hx = torch.sqrt(kc[:, 0, 0])
    out_hy = torch.sqrt(kc[:, 1, 1])
    out_c = kc[:, 0, 1] / (out_hx * out_hy)
    return torch.where(swap, out_hy, out_hx), torch.where(swap, out_hx, out_hy), out_c


def _sheared_power(hist, xc_a, xc_b, r0, r1, swap):
    """Power spectra of the sheared pair densities (S, F, F), computed
    exactly in frequency space: shearing is a linear change of frequency,
    so the sheared spectrum is the histogram's non-uniform DFT, two complex
    matrix products per pair. Returns (power [f_p2, f_p1] with the DC lines
    zeroed, range1, range2)."""
    size = hist.shape[-1]
    dtype, device = hist.dtype, hist.device
    h = torch.where(swap[:, None, None], hist.transpose(1, 2), hist)
    first = torch.where(swap[:, None], xc_b, xc_a)  # centers of p1 (columns)
    second = torch.where(swap[:, None], xc_a, xc_b)  # centers of the other coord (rows)
    p2 = r0[:, None, None] * first[:, None, :] + r1[:, None, None] * second[:, :, None]
    step1 = first[:, 1] - first[:, 0]
    step2 = second[:, 1] - second[:, 0]
    # both ranges: occupied extent padded 10% per side (the NUDFT is
    # periodic with period range, so a tight range would alias mass)
    occupied = h > 0
    p2_lo = torch.amin(torch.where(occupied, p2, math.inf), dim=(1, 2))
    p2_hi = torch.amax(torch.where(occupied, p2, -math.inf), dim=(1, 2))
    second_range = 1.2 * (p2_hi - p2_lo)
    first_range = first[:, -1] - first[:, 0] + step1
    tot = torch.sum(h, dim=(1, 2))

    f = torch.fft.fftfreq(size, d=1.0 / size, device=device).to(dtype)[None, :, None]
    x = torch.arange(size, dtype=dtype, device=device)[None, None, :]
    two_pi = 2 * np.pi

    def phase_matrix(coef):  # (S,) -> (S, F, x) complex64
        return torch.exp(-1j * (two_pi * coef)[:, None, None] * f * x)

    cmat = phase_matrix(r1 * step2 / second_range)  # (F2, y)
    g = torch.matmul(cmat, h.to(cmat.dtype))  # (F2, x)
    bmat = phase_matrix(r0 * step1 / second_range)  # (F2, x)
    amat = phase_matrix(step1 / first_range)  # (F1, x)
    s_hat = torch.matmul(amat, (bmat * g).transpose(-1, -2))  # (F1, F2)
    power = torch.real(s_hat * torch.conj(s_hat)) / tot[:, None, None] ** 2
    power = power.transpose(-1, -2).contiguous()
    power[:, 0, :] = 0.0
    power[:, :, 0] = 0.0
    return power, first_range, second_range


# ---------------------------------------------------------------------------
# kernels, convolution, contours
# ---------------------------------------------------------------------------


def _gauss_kernel_2d(rx, ry, corr, winw, support=None):
    """(K, 2 winw + 1, 2 winw + 1) anisotropic correlated Gaussian windows,
    zeroed outside the per-pair support (2.5 max(rx, ry) by default) and
    normalized to unit sum."""
    idx = torch.arange(-winw, winw + 1, dtype=rx.dtype, device=rx.device)
    iy = idx[None, :, None]
    ix = idx[None, None, :]
    rx, ry, corr = rx[:, None, None], ry[:, None, None], corr[:, None, None]
    det = (rx * ry) ** 2 * (1 - corr**2)
    c00 = rx**2 / det
    c11 = ry**2 / det
    c01 = -rx * ry * corr / det
    q = iy**2 * c00 + ix**2 * c11 + 2 * c01 * iy * ix
    support = torch.maximum(rx, ry) * 2.5 if support is None else support[:, None, None]
    win = torch.exp(-q / 2) * ((torch.abs(iy) <= support) & (torch.abs(ix) <= support))
    return win / torch.sum(win, dim=(1, 2), keepdim=True)


@_stage("2d:contours")
def _contour_levels_batch(grids, contours, iters=40):
    """Water-level contour levels by bisection: t per (grid, contour) with
    sum(P[P > t]) = contour * total, edges half-weighted. Returns (K, C)."""
    edge_weight = torch.ones(grids.shape[-2:], dtype=grids.dtype, device=grids.device)
    edge_weight[0, :] *= 0.5
    edge_weight[-1, :] *= 0.5
    edge_weight[:, 0] *= 0.5
    edge_weight[:, -1] *= 0.5
    weighted = grids * edge_weight
    targets = contours[None, :] * torch.sum(weighted, dim=(1, 2))[:, None]  # (K, C)
    lo = torch.zeros_like(targets)
    hi = torch.amax(grids, dim=(1, 2))[:, None] * torch.ones_like(targets)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.sum(torch.where(grids[:, None] > mid[:, :, None, None], weighted[:, None], 0.0), dim=(2, 3))
        too_much = mass > targets
        lo = torch.where(too_much, mid, lo)
        hi = torch.where(too_much, hi, mid)
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# the two stages
# ---------------------------------------------------------------------------


def _chain_length(n, group, n_samples):
    """The chain's length: ``n`` unsharded; under ``group`` the caller's
    ``n_samples``, which blocks of ``n`` = ceil(n_samples / ranks) must
    hold (a missing or wrong length would move N_eff silently)."""
    world = coll.size(group)
    if group is None and n_samples is None:
        return n
    if n_samples is None or -(-n_samples // world) != n:
        raise ValueError(
            f"n_samples (the chain's length) is required with a process group and must give blocks of {n} samples "
            f"on {world} ranks, got {n_samples}"
        )
    return n_samples


def _fine_indices(cols, lo, width, nbins):
    """(P, N) int32 bin indices clip((x - lo) / width + 0.5, 0, nbins - 1)."""
    return torch.clamp((((cols - lo[:, None]) / width[:, None]) + 0.5).to(torch.int32), 0, nbins - 1)


@_stage("1d:all")
@full_fp32_matmuls()
def all_1d_densities(
    samples,
    weights,
    fine_bins=1024,
    mult_bias_order=1,
    limits_lo=None,
    limits_hi=None,
    periodic=None,
    group=None,
    n_samples=None,
    neff_override=None,
    range_override=None,
    bandwidth_override=None,
    like_weights=None,
    bandwidth_scale=None,
):
    """All marginalized 1D densities of a (N, P) chain on its device.

    Returns a dict with 'x' (P, fine_bins) grids, 'P' peak-normalized
    densities, 'neff', 'bandwidth' (parameter units), 'sigma',
    'sigma_range', 'mean', 'range' (binmin, binmax) and 'host_pack'.
    Pipeline per parameter: histogram-quantile ranges -> binning -> KDE
    N_eff -> ISJ bandwidth with rule-of-thumb fallback -> rFFT Gaussian
    smoothing -> multiplicative bias correction -> peak normalization.

    ``group`` (a ``torch.distributed`` process group; replaces the JAX
    hooks ``axis_name``/``axis_size``): the samples are this rank's block;
    moments, histograms (sum) and ranges (min/max) are all-reduced, the
    N_eff lag sums use the halo exchange of :func:`_neff_kde_batch`, and
    every rank returns the same result. ``n_samples``: the chain's length,
    required with ``group`` (``shard_samples`` pads the last blocks with
    zero-weight samples, and the N_eff lag grid and pair counts follow the
    real chain, as unsharded); it must fit blocks of this rank's length,
    ceil(n_samples / ranks).

    Hooks for stage isolation: ``neff_override`` (P,), ``range_override``
    (binmin, binmax) and ``bandwidth_override`` (P,) fractions of the range.

    ``limits_lo`` / ``limits_hi``: (P,) hard prior bounds (NaN = none). A
    limit is active where it cuts the padded range (periodic parameters
    always snap to their full period); active limits snap the grid edge to
    the bound and take a first-order boundary-kernel correction from
    frequency-domain kernel moments. ``periodic``: (P,) bools; periodic
    parameters (with both limits) smooth circularly with period
    fine_bins - 1 (the duplicated wrap bin folded) and take no boundary
    correction. ``like_weights`` (N,): per-sample likelihood weights; adds
    the peak-normalized mean-likelihood curves as 'likes'.
    """
    n, p = samples.shape
    dtype, device = samples.dtype, samples.device
    n_global = _chain_length(n, group, n_samples)
    has_limits = limits_lo is not None or limits_hi is not None or periodic is not None

    cols = samples.T.contiguous()  # (P, N)
    norm = coll.psum(torch.sum(weights), group)
    means = coll.psum(torch.matmul(cols, weights), group) / norm
    variances = coll.psum(torch.matmul((cols - means[:, None]) ** 2, weights), group) / norm
    sigmas = torch.sqrt(variances)

    # ranges from histogram quantiles
    mins = coll.pmin(torch.amin(cols, dim=1), group)
    maxs = coll.pmax(torch.amax(cols, dim=1), group)
    qwidth = (maxs - mins) / _QBINS
    qix = torch.clamp(((cols - mins[:, None]) / qwidth[:, None]).to(torch.int32), 0, _QBINS - 1)
    qhists = _hist_rows(qix, weights, _QBINS, group)
    range_conf = 0.001
    probs = torch.cat(
        [
            torch.tensor([range_conf, 1 - range_conf], dtype=dtype, device=device),
            torch.linspace(0.1, 0.9, 9, dtype=dtype, device=device),
        ]
    )
    quants = _quantiles_from_hist(qhists, mins, qwidth, probs)
    # sigma_range: quantile-based structure scale (min over 4-apart gaps of
    # [param_min, q(0.1..0.9), param_max])
    ladder = torch.cat([mins[:, None], quants[:, 2:], maxs[:, None]], dim=1)  # (P, 11)
    gaps = ladder[:, 4:] - ladder[:, :-4]
    scale = torch.amin(gaps, dim=1) / 1.049
    very_flat = torch.all(gaps > sigmas[:, None] * 1.049, dim=1) & torch.all(gaps < scale[:, None] * 1.5, dim=1)
    sigma_range = torch.where(very_flat, scale, torch.minimum(sigmas, scale))
    smooth_est = sigma_range * 0.4
    range_min = quants[:, 0] - smooth_est * 2
    range_max = quants[:, 1] + smooth_est * 2
    binmin = torch.minimum(mins, range_min) - (range_max - range_min) * 0.1
    binmax = torch.maximum(maxs, range_max) + (range_max - range_min) * 0.1
    if range_override is not None:
        binmin, binmax = (_tensor(r, device, dtype) for r in range_override)
    if has_limits:
        # hard limits cut the padded range; a limit is active where it binds
        # (periodic parameters always snap to their full period)
        nan = np.full(p, np.nan, np.float32)
        lim_lo = _tensor(nan if limits_lo is None else limits_lo, device, dtype)
        lim_hi = _tensor(nan if limits_hi is None else limits_hi, device, dtype)
        per = _tensor(np.zeros(p, bool) if periodic is None else periodic, device, torch.bool)
        lo_nan, hi_nan = torch.isnan(lim_lo), torch.isnan(lim_hi)
        active_lo = ~lo_nan & (per | (torch.where(lo_nan, -math.inf, lim_lo) > binmin))
        active_hi = ~hi_nan & (per | (torch.where(hi_nan, math.inf, lim_hi) < binmax))
        binmin = torch.where(active_lo, torch.where(lo_nan, binmin, lim_lo), binmin)
        binmax = torch.where(active_hi, torch.where(hi_nan, binmax, lim_hi), binmax)
        # boundary-kernel corrections apply only to non-periodic parameters
        active_lo = active_lo & ~per
        active_hi = active_hi & ~per
    else:
        active_lo = active_hi = per = torch.zeros(p, dtype=torch.bool, device=device)
    fine_width = (binmax - binmin) / (fine_bins - 1)

    fine_ix = _fine_indices(cols, binmin, fine_width, fine_bins)
    bins = _hist_rows(fine_ix, weights, fine_bins, group)  # (P, fine_bins)
    like_bins = None
    if like_weights is not None:
        like_bins = _hist_rows(fine_ix, _tensor(like_weights, device, dtype), fine_bins, group)
    del fine_ix

    if neff_override is not None:
        neff = _tensor(neff_override, device, dtype)
    else:
        # the halo is at most one block long, so a sharded run caps the lags at it
        lags = _lag_grid(n_global, max_lag=None if group is None else n)
        neff = _neff_kde_batch(cols, weights, sigma_range, lags, group, n_global)
    if bandwidth_override is not None:
        h_frac = _tensor(bandwidth_override, device, dtype)
    else:
        h_frac, ok = _isj_bandwidth_1d(bins, neff)
        fallback = 1.06 * sigma_range * neff ** (-1.0 / 5) / (binmax - binmin)
        h_frac = torch.where(ok & (h_frac > 0.01 * neff ** (-0.2) * 0.5), h_frac, fallback)
    if mult_bias_order:
        h_frac = h_frac * neff ** (1.0 / 5 - 1.0 / (4 * mult_bias_order + 5))
    if bandwidth_override is None:
        # the reference caps the auto bandwidth at a quarter of the range
        h_frac = torch.minimum(h_frac, torch.tensor(0.25, dtype=dtype, device=device))
    if bandwidth_scale is not None:
        h_frac = h_frac * bandwidth_scale
    smooth_bins = torch.clamp(h_frac * fine_bins, 1.0, fine_bins // 2)  # kernel sigma in bins

    # Gaussian smoothing by a frequency-domain multiplier (the 10% empty
    # borders make the periodic pad safe; with hard limits the data sits at
    # a centered offset, so the regions outside each edge stay distinct)
    pad = int(2 ** np.ceil(np.log2(fine_bins * 1.25)))
    off = (pad - fine_bins) // 2 if has_limits else 0
    k = torch.arange(pad // 2 + 1, dtype=dtype, device=device)
    if has_limits:
        smooth_bins = torch.where(per, torch.clamp(smooth_bins, max=off / 4.0), smooth_bins)
    mult = torch.exp(-2.0 * (np.pi * smooth_bins[:, None] / pad) ** 2 * k[None, :] ** 2)

    def smooth(b):  # b: (P, fine_bins), or (P, pad) rows already extended
        return torch.fft.irfft(torch.fft.rfft(b, n=pad, dim=1) * mult, n=pad, dim=1)[:, off : off + fine_bins]

    if has_limits:
        # circular smoothing of periodic parameters: fold the duplicated
        # wrap bin and tile the data into the pad borders (period
        # fine_bins - 1), so one linear FFT convolution serves both kinds
        rel = torch.arange(pad, device=device) - off
        mod_idx = torch.remainder(rel, fine_bins - 1)

        def extend(rows):
            folded = rows.clone()
            folded[:, 0] += rows[:, -1]
            folded[:, -1] = 0.0
            plain = torch.zeros((p, pad), dtype=rows.dtype, device=device)
            plain[:, off : off + fine_bins] = rows
            return torch.where(per[:, None], folded[:, mod_idx], plain)

        def rewrap(c):  # grid points 0 and fine_bins - 1 are one periodic point
            c = c.clone()
            c[:, -1] = torch.where(per, c[:, 0], c[:, -1])
            return c

        def smooth_lim(rows):
            return rewrap(smooth(extend(rows)))

    else:
        smooth_lim = smooth
    conv = smooth_lim(bins)
    raw_conv = conv  # before the corrections: the mean-likelihood denominator

    if has_limits:
        # first-order boundary-kernel correction (the linear boundary kernel
        # of the reference's order-1 branch): moments of the Gaussian against
        # the prior mask from analytic frequency-domain kernel moments
        # FT[x^m g]
        pos = torch.arange(pad, device=device)[None, :]
        one = torch.ones((), dtype=dtype, device=device)
        mask_rows = (
            torch.where(active_lo[:, None] & (pos < off), 0.0, one)
            * torch.where(active_lo[:, None] & (pos == off), 0.5, one)
            * torch.where(active_hi[:, None] & (pos >= off + fine_bins), 0.0, one)
            * torch.where(active_hi[:, None] & (pos == off + fine_bins - 1), 0.5, one)
        )
        c_g = 2.0 * (np.pi * smooth_bins[:, None] / pad) ** 2
        g = torch.exp(-c_g * k[None, :] ** 2)
        g1 = (-1j * (c_g * pad / np.pi) * k[None, :]) * g
        g2 = (-((pad / (2 * np.pi)) ** 2) * (4 * c_g**2 * k[None, :] ** 2 - 2 * c_g)) * g
        mspec = torch.fft.rfft(mask_rows, dim=1)
        sl = slice(off, off + fine_bins)

        def inverse(spec):
            return torch.fft.irfft(spec, n=pad, dim=1)[:, sl]

        a0 = inverse(mspec * g)
        a1 = inverse(mspec * g1)
        a2 = inverse(mspec * g2)
        xp = inverse(torch.fft.rfft(extend(bins), dim=1) * g1)
        good = (a0 > 1e-12) & (conv > 0)
        normed = torch.where(good, conv / torch.where(good, a0, 1.0), conv)
        denom = a0 * a2 - a1**2
        corrected = torch.where(
            good & (torch.abs(denom) > 1e-30),
            (conv * a2 - xp * a1) / torch.where(denom == 0, 1.0, denom),
            normed,
        )
        fixed = normed * torch.exp(torch.clamp(corrected / torch.where(normed == 0, 1.0, normed), max=4) - 1)
        corrected = torch.where(good, fixed, conv)
        conv = torch.where((active_lo | active_hi)[:, None], corrected, conv)

    if mult_bias_order:
        a0_mb = None
        if has_limits:
            # each bias round divides by the window-cut mask a0 (the edge bin
            # half-weighted at an active limit, no mass outside the grid)
            inside = (pos >= off) & (pos < off + fine_bins)
            mask_mb = (
                torch.where(inside, one, 0.0)
                * torch.where(active_lo[:, None] & (pos == off), 0.5, one)
                * torch.where(active_hi[:, None] & (pos == off + fine_bins - 1), 0.5, one)
            )
            a0_mb = smooth(mask_mb)
            a0_mb = torch.where(a0_mb <= 1e-12, 1.0, a0_mb)
            a0_mb = torch.where(per[:, None], 1.0, a0_mb)  # no edges on periodic axes
        for _ in range(mult_bias_order):
            prob1 = torch.where(conv <= 0, 1.0, conv)
            flattened = bins / prob1
            if has_limits:
                conv = rewrap(conv * smooth(extend(flattened)) / a0_mb)
            else:
                conv = conv * smooth(flattened)

    likes = None
    if like_bins is not None:
        # mean-likelihood curves (the reference's meanlikes block): flatten
        # by the corrected density, re-smooth, rescale by corrected / raw
        # density, peak-normalize
        live = conv > 0
        flat_likes = torch.where(live, like_bins / torch.where(live, conv, 1.0), like_bins)
        blikes = smooth_lim(flat_likes)
        blikes = torch.where(live, blikes * conv / torch.where(raw_conv == 0, 1.0, raw_conv), blikes)
        likes = blikes / torch.amax(blikes, dim=1, keepdim=True)

    density = conv / torch.amax(conv, dim=1, keepdim=True)
    x = binmin[:, None] + fine_width[:, None] * torch.arange(fine_bins, dtype=dtype, device=device)[None, :]
    bandwidth = h_frac * (binmax - binmin)
    return {
        "x": x,
        "P": density,
        "neff": neff,
        "bandwidth": bandwidth,
        "sigma": sigmas,
        "sigma_range": sigma_range,
        "mean": means,
        "range": (binmin, binmax),
        "active_lo": active_lo,
        "active_hi": active_hi,
        "periodic": per,
        "likes": likes,
        "host_pack": torch.cat([neff, sigma_range, binmin, binmax, bandwidth]),
    }


def _extend_periodic(grids, per_x, per_y, winw):
    """(K, fine + 2 winw, fine + 2 winw) grids for a 'valid' convolution:
    on each periodic axis (``per_x`` columns, ``per_y`` rows; (K,) bools)
    the duplicated wrap line is folded into the first and the grid tiles
    periodically (period fine - 1) into the winw-wide borders; the borders
    of the other axes are zero."""
    k, fine, _ = grids.shape
    ext = fine + 2 * winw
    rel = torch.arange(ext, device=grids.device) - winw
    wrap_idx, clip_idx = torch.remainder(rel, fine - 1), torch.clamp(rel, 0, fine - 1)
    inside = (rel >= 0) & (rel < fine)
    h = grids.clone()
    h[:, 0, :] += torch.where(per_y[:, None], h[:, -1, :], 0.0)
    h[:, -1, :] = torch.where(per_y[:, None], 0.0, h[:, -1, :])
    h[:, :, 0] += torch.where(per_x[:, None], h[:, :, -1], 0.0)
    h[:, :, -1] = torch.where(per_x[:, None], 0.0, h[:, :, -1])
    src_y = torch.where(per_y[:, None], wrap_idx[None, :], clip_idx[None, :])  # (K, ext)
    src_x = torch.where(per_x[:, None], wrap_idx[None, :], clip_idx[None, :])
    msk_y = (per_y[:, None] | inside[None, :]).to(grids.dtype)
    msk_x = (per_x[:, None] | inside[None, :]).to(grids.dtype)
    g = torch.gather(h, 1, src_y[:, :, None].expand(-1, -1, fine)) * msk_y[:, :, None]
    return torch.gather(g, 2, src_x[:, None, :].expand(-1, ext, -1)) * msk_x[:, None, :]


def _edge_masks(lo_a, hi_a, lo_b, hi_b, fine_bins, winw, dtype):
    """(K, fine + 2 winw, fine + 2 winw) prior masks of the order-0 edge
    normalization (reference mcsamples.py:1921-1933): ones beyond an
    unbounded edge, zero beyond an active limit with a half-weight limit
    line; ``lo_a`` ... ``hi_b`` (K,) bools, the pairs' active limits (a:
    columns, b: rows)."""
    ext = fine_bins + 2 * winw
    idx = torch.arange(ext, device=lo_a.device)
    lo_edge = torch.where(idx < winw, 0.0, torch.where(idx == winw, 0.5, 1.0)).to(dtype)
    hi_edge = torch.where(idx >= ext - winw, 0.0, torch.where(idx == ext - winw - 1, 0.5, 1.0)).to(dtype)

    def axis_mask(act_l, act_h):
        m = torch.ones((act_l.shape[0], ext), dtype=dtype, device=lo_a.device)
        m = torch.where(act_l[:, None], lo_edge[None, :] * m, m)
        return torch.where(act_h[:, None], hi_edge[None, :] * m, m)

    return axis_mask(lo_b, hi_b)[:, :, None] * axis_mask(lo_a, hi_a)[:, None, :]


def _shear_subset(enable_shear, k):
    """(shearing on?, None or the pair positions that may shear)."""
    if isinstance(enable_shear, (tuple, list)):
        subset = [int(i) for i in enable_shear]
        if not subset:
            return False, None
        return True, (None if len(subset) == k else subset)
    return bool(enable_shear), None


@full_fp32_matmuls()  # the plain matrix products (psi functionals) need full FP32
def all_2d_densities(
    samples,
    weights,
    pair_a,
    pair_b,
    neff,
    binmin,
    binmax,
    contours,
    fine_bins=256,
    mult_bias_order=1,
    winw=30,
    active_lo=None,
    active_hi=None,
    periodic=None,
    group=None,
    int8_weights=False,
    bandwidth_scale=None,
    sigma_range=None,
    boundary_order=1,
    max_corr=0.95,
    enable_shear=True,
    bandwidth_override=None,
    kernel_support=None,
    prior_mask=None,
    like_weights=None,
    exact_mult_bias=False,
    hists_in=None,
    export_hists=False,
):
    """All-pairs marginalized 2D densities on the chain's device.

    pair_a / pair_b: (K,) parameter indices; neff, binmin, binmax: (P,)
    from :func:`all_1d_densities`. Returns a dict with 'P' (K, fine, fine)
    peak-normalized densities (rows = y = b), 'contours' (K, C), the kernel
    parameters 'rx', 'ry', 'corr', 'neff', 'fragile' and the packed 'diag'.
    Pipeline: pair histograms (CUDA kernel K1) -> bandwidth optimizer
    (sheared spectra for correlated pairs) -> correlated Gaussian kernels ->
    DFT-matmul convolutions (K2, K3) -> boundary correction at hard limits
    -> multiplicative bias round -> contour levels. Everything runs in the
    samples' type: f32 on the fused path, f64 in parity mode.

    ``int8_weights``: every weight is an integer (the histogram kernel then
    accumulates exactly in int32). The bin indices go to K1 as uint8 rows
    up to 256 bins and as int16 rows past that (its wide kernels; at most
    ``pair_hist.MAX_BINS`` on the card). ``enable_shear``: bool, or the pair
    positions that may shear (host pre-sniffed, :func:`_sniff_shear`).
    Hooks for stage isolation: ``hists_in`` (K, fine, fine) replaces the
    binning, ``bandwidth_override`` (hx, hy, c) in data units replaces the
    optimizer, ``kernel_support`` (K,) sets the window half-widths;
    ``export_hists`` adds the histograms to the output.

    ``group`` (a ``torch.distributed`` process group; replaces the JAX hook
    ``axis_name``): the samples are this rank's block; the pair histograms
    of each block and the optimizer's moments (norm, means, covariance) are
    all-reduced, so every grid-local stage sees the same global inputs on
    every rank and every rank returns the same result.

    Hard limits, ``active_lo`` / ``active_hi`` (P,) from
    :func:`all_1d_densities` (``getdist_tpu/ops/batched.py:1756-1895``):
    the order-0 edge normalization and, at ``boundary_order=1``, the linear
    boundary kernel, with each bias round divided by the edge mass; the
    in-program optimizer follows the reference's limit rules (no shear and
    the rule of thumb above 0.8 for two limited parameters, no kernel
    correlation for one). ``prior_mask`` (K, fine + 2 winw, fine + 2 winw)
    multiplies the edge masks (a non-rectangular prior). ``periodic`` (P,)
    bools: periodic axes fold their wrap line, extend periodically (period
    fine - 1) into winw-wide borders and take a 'valid' convolution (K3 on
    the extended grid), then duplicate the wrap line. ``like_weights`` (N,)
    f32: the like-weighted pair histograms (K1 with f32 weights), smoothed,
    flattened by one bias round and divided by the smoothed density, as
    'likes'. ``exact_mult_bias`` (parity mode): the reference's full edge
    mask in the multiplicative bias round.
    The DFT frame is sized to the largest convolution (a multiple of 128).
    """
    if boundary_order not in (0, 1):
        raise ValueError(f"boundary_order must be 0 or 1, got {boundary_order}")
    dtype, device = samples.dtype, samples.device
    pa = _tensor(pair_a, device, torch.int64)
    pb = _tensor(pair_b, device, torch.int64)
    k_all = pa.shape[0]
    p = samples.shape[1]
    neff, binmin, binmax = (_tensor(v, device, dtype) for v in (neff, binmin, binmax))
    contours = _tensor(contours, device, dtype)
    fine_width = (binmax - binmin) / (fine_bins - 1)
    need_cols = hists_in is None or bandwidth_override is None or like_weights is not None
    cols = samples.T.contiguous() if need_cols else None
    has_limits = active_lo is not None or active_hi is not None
    if has_limits:
        unlimited = np.zeros(p, bool)
        lim_lo = _tensor(unlimited if active_lo is None else active_lo, device, torch.bool)
        lim_hi = _tensor(unlimited if active_hi is None else active_hi, device, torch.bool)

    hists = None if hists_in is None else _tensor(hists_in, device, dtype)
    like_hists = None
    if hists is None or like_weights is not None:
        with _stage("2d:histograms"):
            # uint8 rows up to 256 bins (K1's uint8 kernel), int16 past that
            # (its wide kernels)
            ix_all = narrow_rows(_fine_indices(cols, binmin, fine_width, fine_bins), fine_bins)

            def pair_hists(w_hist, integer):
                out = pair_histograms(ix_all, w_hist, pa.to(torch.int32), pb.to(torch.int32),
                                      integer_weights=integer, nbins=fine_bins)
                return coll.psum(out, group).to(dtype)

            if hists is None:
                w_hist = weights.to(torch.float32)
                # integer weights go in as uint8 for every row type
                hists = pair_hists(narrow_weights(w_hist) if int8_weights else w_hist, int8_weights)
            if like_weights is not None:
                # fractional like weights: K1 accumulates them in f32
                like_hists = pair_hists(_tensor(like_weights, device, torch.float32), False)
            del ix_all

    pair_neff = torch.minimum(neff[pa], neff[pb])
    if bandwidth_override is not None:
        hx, hy, c = (_tensor(v, device, dtype) for v in bandwidth_override)
        fragile = torch.zeros(k_all, dtype=torch.bool, device=device)
    else:
        hx, hy, c, fragile = _optimized_bandwidths(
            cols, weights, pa, pb, hists, pair_neff, binmin, binmax, fine_width, fine_bins, sigma_range, max_corr,
            enable_shear, mult_bias_order, group, lim=(lim_lo | lim_hi) if has_limits else None,
        )
    del cols
    if bandwidth_scale is not None:
        hx = hx * bandwidth_scale
        hy = hy * bandwidth_scale
    rx = torch.clamp(hx / fine_width[pa], 0.8, winw / 2.5)  # bin units
    ry = torch.clamp(hy / fine_width[pb], 0.8, winw / 2.5)
    support = None if kernel_support is None else _tensor(kernel_support, device, dtype)
    kernels = _gauss_kernel_2d(rx, ry, c, winw, support=support)

    # one frame covers every convolution below: 'same' convolutions of the
    # (fine, fine) grids and 'valid' ones of the (fine + 2 winw)^2 masks and
    # periodically extended grids
    pad = frame_for(fine_bins + 4 * winw + 1)
    spec = dft_conv_spectrum(kernels, pad)

    def conv_same(grids, sp=spec):
        return dft_conv2d(grids, *sp, fine_bins, winw, pad)

    def conv_valid_ext(grids, sp=spec):
        return dft_conv2d(grids, *sp, fine_bins, 2 * winw, pad)

    ext = fine_bins + 2 * winw
    idx = torch.arange(ext, device=device)
    no_axis = torch.zeros(k_all, dtype=torch.bool, device=device)
    if periodic is not None:
        per = _tensor(periodic, device, torch.bool)
        per_x, per_y = per[pa], per[pb]

        def conv_main(grids):
            out = conv_valid_ext(_extend_periodic(grids, per_x, per_y, winw))
            # the wrap line duplicates its partner row / column
            out[:, -1, :] = torch.where(per_y[:, None], out[:, 0, :], out[:, -1, :])
            out[:, :, -1] = torch.where(per_x[:, None], out[:, :, 0], out[:, :, -1])
            return out

    else:
        per_x = per_y = no_axis
        conv_main = conv_same

    smoothed = conv_main(hists)

    likes = None
    if like_hists is not None:
        # mean-likelihood grids (reference mcsamples.py:1888-1901): smooth
        # the like-weighted bins, one bias round, then divide by the smoothed
        # density where it carries mass
        bin2dlikes = conv_main(like_hists)
        if mult_bias_order:
            live = bin2dlikes > 0
            flat_l = torch.where(live, like_hists / torch.where(live, bin2dlikes, 1.0), like_hists)
            likes2 = conv_main(flat_l)
            # the JAX package keeps likes2 where bin2dlikes <= 0; exactly, both
            # vanish together there, but in f32 a tail value of bin2dlikes
            # (like weights span many decades) rounds below zero while
            # likes2 does not, and that unscaled likes2 over a 1e-4 density
            # floor becomes the grid's peak (ROADMAP C10): scale by
            # bin2dlikes clamped at 0
            bin2dlikes = likes2 * torch.clamp(bin2dlikes, min=0.0)
        above = smoothed > 1e-4 * torch.amax(smoothed, dim=(1, 2), keepdim=True)
        bin2dlikes = torch.where(above, bin2dlikes / torch.where(above, smoothed, 1.0), 0.0)
        likes = bin2dlikes / torch.amax(bin2dlikes, dim=(1, 2), keepdim=True)
        del like_hists, bin2dlikes

    if has_limits:
        lo_a, hi_a, lo_b, hi_b = lim_lo[pa], lim_hi[pa], lim_lo[pb], lim_hi[pb]
    else:
        lo_a = hi_a = lo_b = hi_b = no_axis

    if has_limits:
        # order-0 edge normalization (reference mcsamples.py:1921-1933): the
        # prior mask is ones beyond unbounded edges, zero beyond an active
        # limit with a half-weight limit line; a00 = conv(mask) is the
        # kernel mass inside the prior
        masks = _edge_masks(lo_a, hi_a, lo_b, hi_b, fine_bins, winw, dtype)
        if prior_mask is not None:
            # a non-rectangular prior support (the reference's mask_function)
            masks = masks * _tensor(prior_mask, device, dtype)
        a00 = conv_valid_ext(masks)
        pair_limited = lo_a | hi_a | lo_b | hi_b
        good = pair_limited[:, None, None] & (a00 > 1e-12)
        a00 = torch.where(good, a00, 1.0)
        maxes0 = torch.amax(smoothed, dim=(1, 2), keepdim=True)
        apply_ix = good & (a00 * smoothed > maxes0 * 1e-8)
        normed = torch.where(apply_ix, smoothed / a00, smoothed)
        if boundary_order == 1:
            # linear boundary-kernel correction (reference mcsamples.py:1933-1961)
            moment = torch.arange(-winw, winw + 1, dtype=dtype, device=device)
            win_x = kernels * moment[None, None, :]
            win_y = kernels * moment[None, :, None]
            spec_wx = dft_conv_spectrum(win_x, pad)
            spec_wy = dft_conv_spectrum(win_y, pad)
            a10 = conv_valid_ext(masks, spec_wx)
            a01 = conv_valid_ext(masks, spec_wy)
            x_p = conv_same(hists, spec_wx)
            y_p = conv_same(hists, spec_wy)
            del spec_wx, spec_wy
            a20 = conv_valid_ext(masks, dft_conv_spectrum(win_x * moment[None, None, :], pad))
            a02 = conv_valid_ext(masks, dft_conv_spectrum(win_y * moment[None, :, None], pad))
            a11 = conv_valid_ext(masks, dft_conv_spectrum(win_y * moment[None, None, :], pad))
            denom = a20 * a01**2 + a10**2 * a02 - a00 * a02 * a20 + a11**2 * a00 - 2 * a01 * a10 * a11
            lin_a = a11**2 - a02 * a20
            lin_x = a10 * a02 - a01 * a11
            lin_y = a01 * a20 - a10 * a11
            safe_denom = torch.where(denom == 0, 1.0, denom)
            corrected = (smoothed * lin_a + x_p * lin_x + y_p * lin_y) / safe_denom
            safe_normed = torch.where(normed == 0, 1.0, normed)
            lifted = normed * torch.exp(torch.clamp(corrected / safe_normed, max=4) - 1)
            smoothed = torch.where(apply_ix & (denom != 0), lifted, normed)
            del a10, a01, a20, a02, a11, x_p, y_p, denom, lin_a, lin_x, lin_y, corrected, lifted
        else:
            smoothed = normed
        del masks

    a00_mb = None
    if mult_bias_order and exact_mult_bias:
        # the reference's full mask (mcsamples.py _setAllEdgeMask2D after
        # _setEdgeMask2D): ones with zeroed winw borders on non-periodic
        # axes, half-weight limit lines on hard-limited directions, convolved
        # with the pair kernel
        border = (idx < winw) | (idx >= ext - winw)

        def mb_axis_mask(act_l, act_h, per_ax):
            m = torch.where(~per_ax[:, None] & border[None, :], 0.0, 1.0).to(dtype)
            m = torch.where((act_l & ~per_ax)[:, None] & (idx == winw)[None, :], m * 0.5, m)
            return torch.where((act_h & ~per_ax)[:, None] & (idx == ext - winw - 1)[None, :], m * 0.5, m)

        mb_masks = mb_axis_mask(lo_b, hi_b, per_y)[:, :, None] * mb_axis_mask(lo_a, hi_a, per_x)[:, None, :]
        if prior_mask is not None:
            mb_masks = mb_masks * _tensor(prior_mask, device, dtype)
        a00_mb = conv_valid_ext(mb_masks)
        a00_mb = torch.where((per_x & per_y)[:, None, None] | (a00_mb <= 1e-12), 1.0, a00_mb)
    # multiplicative bias rounds; without limits or the exact mask the
    # reference's edge normalization is ~1 wherever there is mass
    for _ in range(mult_bias_order):
        maxes = torch.amax(smoothed, dim=(1, 2), keepdim=True)
        flat = torch.where(smoothed > maxes * 1e-8, hists / torch.where(smoothed == 0, 1.0, smoothed), hists)
        round_conv = conv_main(flat)
        if a00_mb is not None:
            round_conv = round_conv / a00_mb
        elif has_limits:
            round_conv = torch.where(pair_limited[:, None, None], round_conv / a00, round_conv)
        smoothed = smoothed * round_conv

    density = smoothed / torch.amax(smoothed, dim=(1, 2), keepdim=True)
    out = {
        "P": density,
        "contours": _contour_levels_batch(density, contours),
        "rx": rx,
        "ry": ry,
        "corr": c,
        "neff": pair_neff,
        "likes": likes,
        # pairs whose f32 correlation search sat on a knife edge
        "fragile": fragile,
        # packed host-facing diagnostics [fragile, rx, ry]
        "diag": torch.cat([fragile.to(rx.dtype), rx, ry]),
    }
    if export_hists:
        out["hists"] = hists
    return out


@_stage("2d:bandwidths")
def _optimized_bandwidths(
    cols, weights, pa, pb, hists, pair_neff, binmin, binmax, fine_width, fine_bins, sigma_range, max_corr,
    enable_shear, mult_bias_order, group=None, lim=None,
):
    """(hx, hy, c, fragile) in data units from the in-program optimizer:
    sheared spectra for correlated pairs, pure rule of thumb at extreme
    correlation, the plain optimizer otherwise. The moments are global
    (all-reduced over ``group``), so every rank plans the same shears.
    ``lim``: (P,) bools, the parameters with an active hard limit."""
    dtype, device = cols.dtype, cols.device
    k_all = pa.shape[0]
    norm = coll.psum(torch.sum(weights), group)
    means = coll.psum(torch.matmul(cols, weights), group) / norm
    diffs = cols - means[:, None]
    cov = coll.psum(torch.matmul(diffs * weights[None, :], diffs.T), group) / norm
    sd = torch.sqrt(torch.diagonal(cov))
    corr_mat = cov / torch.outer(sd, sd)
    range_a = (binmax - binmin)[pa]
    range_b = (binmax - binmin)[pb]
    sr = sd if sigma_range is None else _tensor(sigma_range, device, dtype)
    sr_a, sr_b = sr[pa], sr[pb]

    c_s = corr_mat[pa, pb]
    c_cap = torch.clamp(c_s, -max_corr, max_corr)
    c_eff = torch.where(torch.abs(c_cap) < 0.1, 0.0, c_cap)
    # hard limits (reference mcsamples.py:1334-1412): no shear and the rule
    # of thumb above 0.8 when both parameters are limited, no kernel
    # correlation when either is, and a limited parameter goes first in the
    # shear so that it keeps its bounds
    if lim is None:
        lim_a = lim_b = torch.zeros(k_all, dtype=torch.bool, device=device)
    else:
        lim_a, lim_b = lim[pa], lim[pb]
    do_correlated = ~(lim_a & lim_b)
    shear_sel = (torch.abs(c_eff) > 0.2) & (torch.abs(c_eff) <= max_corr) & do_correlated
    rule_sel = (torch.abs(c_s) > max_corr) | (~do_correlated & (c_s > 0.8))
    do_corr = ~(lim_a | lim_b)
    fb_t = (torch.minimum(sr_a / range_a, sr_b / range_b) / pair_neff ** (1.0 / 6)) ** 2
    shear_on, subset = _shear_subset(enable_shear, k_all)
    if shear_on:
        # the sheared spectrum feeds the optimizer only; the density
        # convolution runs on the original grid
        xc = binmin[:, None] + fine_width[:, None] * torch.arange(fine_bins, dtype=dtype, device=device)[None, :]
        swap = lim_b
        r0, r1, s_mats = _shear_plan_2d(cov[pa, pa], cov[pa, pb], cov[pb, pb], swap)
        sub = torch.arange(k_all, device=device) if subset is None else torch.tensor(subset, device=device)
        sh_p, sh_r1, sh_r2 = _sheared_power(hists[sub], xc[pa[sub]], xc[pb[sub]], r0[sub], r1[sub], swap[sub])
        sh_power = torch.zeros_like(hists)
        sh_power[sub] = sh_p
        sh_range1 = range_a.clone()
        sh_range1[sub] = sh_r1
        sh_range2 = range_b.clone()
        sh_range2[sub] = sh_r2
        in_sub = torch.zeros(k_all, dtype=torch.bool, device=device)
        in_sub[sub] = True
        shear_sel = shear_sel & in_sub
        opt_range1 = torch.where(shear_sel, sh_range1, range_a)
        opt_range2 = torch.where(shear_sel, sh_range2, range_b)
        opt_corr = torch.where(shear_sel, 0.0, c_eff)
        wx, wy, c_k, ok, fragile = _kernel_bandwidth_2d(hists, pair_neff, opt_corr, do_corr, fb_t, sh_power, shear_sel)
    else:
        opt_range1, opt_range2 = range_a, range_b
        wx, wy, c_k, ok, fragile = _kernel_bandwidth_2d(hists, pair_neff, c_eff, do_corr, fb_t)
    hx = wx * opt_range1
    hy = wy * opt_range2
    c = c_k
    if shear_on:
        # sheared-space kernels back through the scaled Cholesky root
        hx_sh, hy_sh, c_sh = _shear_kernel_back(hx, hy, c_k, s_mats, swap)
        hx = torch.where(shear_sel, hx_sh, hx)
        hy = torch.where(shear_sel, hy_sh, hy)
        c = torch.where(shear_sel, c_sh, c)
    # rule-of-thumb branch and optimizer-failure fallback (data units)
    use_rule = rule_sel | ~ok
    fragile = fragile & ~use_rule
    hx = torch.where(use_rule, sr_a / pair_neff ** (1.0 / 6), hx)
    hy = torch.where(use_rule, sr_b / pair_neff ** (1.0 / 6), hy)
    c = torch.clamp(torch.where(use_rule, c_cap, c), -0.99, 0.99)
    if mult_bias_order:
        scale = 1.1 * pair_neff ** (1.0 / 6 - 1.0 / (2 + 4 * (1 + mult_bias_order)))
        hx = hx * scale
        hy = hy * scale
    return hx, hy, c, fragile


# ---------------------------------------------------------------------------
# the fused program
# ---------------------------------------------------------------------------


@full_fp32_matmuls()  # every plain matrix product runs in full FP32
def _triangle_program(
    samples, weights, pair_a, pair_b, contours, int8_weights, max_corr=0.95, enable_shear=True,
    bandwidth_scale_1d=None, bandwidth_scale_2d=None, group=None, n_samples=None, export_hists=False,
    limits_lo=None, limits_hi=None, periodic=None, like_weights=None, fine_bins_2d=256,
):
    """The 1D stage, then the all-pairs 2D stage on its ranges, N_eff and
    active limits; ``group`` / ``n_samples`` shard both stages (see
    :func:`all_1d_densities`)."""
    has_limits = limits_lo is not None or limits_hi is not None or periodic is not None
    with torch.no_grad():
        d1 = all_1d_densities(
            samples, weights, limits_lo=limits_lo, limits_hi=limits_hi, periodic=periodic, group=group,
            n_samples=n_samples, like_weights=like_weights, bandwidth_scale=bandwidth_scale_1d,
        )
        d2 = all_2d_densities(
            samples,
            weights,
            pair_a,
            pair_b,
            d1["neff"],
            d1["range"][0],
            d1["range"][1],
            contours,
            fine_bins=fine_bins_2d,
            active_lo=d1["active_lo"] if has_limits else None,
            active_hi=d1["active_hi"] if has_limits else None,
            periodic=periodic,
            int8_weights=int8_weights,
            bandwidth_scale=bandwidth_scale_2d,
            sigma_range=d1["sigma_range"],
            max_corr=max_corr,
            enable_shear=enable_shear,
            group=group,
            like_weights=like_weights,
            export_hists=export_hists,
        )
    return d1, d2


def _limit_arrays(p, limits_lo, limits_hi, periodic):
    """The fused program's (limits_lo, limits_hi, periodic) of caller
    arguments: (P,) f32 bounds with NaN for none, both set when any of the
    three is given, and (P,) bools or None."""
    if limits_lo is not None or limits_hi is not None or periodic is not None:
        nan = np.full(p, np.nan, np.float32)
        limits_lo = nan if limits_lo is None else np.asarray(limits_lo, np.float32)
        limits_hi = nan if limits_hi is None else np.asarray(limits_hi, np.float32)
    return limits_lo, limits_hi, None if periodic is None else np.asarray(periodic, bool)


def _sniff_shear(samples, max_corr, pairs=None, weights=None):
    """Host pre-check: which pairs may want bandwidth shearing (0.2 < |corr|)?

    Only inspects numpy samples; anything else returns True (correct, pays
    the shear cost) rather than forcing a device->host copy. Without
    ``pairs`` returns a bool; with a (K, 2) ``pairs`` list returns the tuple
    of pair positions whose |corr| clears 0.15 (a margin under the 0.2
    threshold), or True/False for all/none.
    """
    if not isinstance(samples, np.ndarray):
        return True
    if samples.shape[1] < 2:
        return False
    step = max(1, samples.shape[0] // 100000)
    sub = samples[::step]
    if weights is not None and isinstance(weights, np.ndarray) and weights.shape[:1] == samples.shape[:1]:
        cv = np.cov(sub.T, aweights=weights[::step])
        sd = np.sqrt(np.diag(cv))
        corr = cv / np.outer(sd, sd)
    else:
        corr = np.corrcoef(sub.T)
    if pairs is None:
        off = corr[~np.eye(corr.shape[0], dtype=bool)]
        return bool(np.any(np.abs(off) > 0.18))
    sel = [k for k, (a, b) in enumerate(np.asarray(pairs)) if abs(corr[a, b]) > 0.15]
    if not sel:
        return False
    if len(sel) == len(pairs):
        return True
    return tuple(sel)


def triangle_densities(
    samples,
    weights,
    contours=(0.68, 0.95),
    fine_bins_2d=256,
    limits_lo=None,
    limits_hi=None,
    periodic=None,
    int8_weights=None,
    max_corr=0.95,
    enable_shear=None,
    like_weights=None,
    bandwidth_scale_1d=None,
    bandwidth_scale_2d=None,
    device="cuda",
):
    """All 1D and all-pairs 2D densities of a chain on ``device``.

    samples (N, P) and weights (N,) as numpy arrays or tensors. Returns the
    two output dicts of :func:`all_1d_densities` and
    :func:`all_2d_densities`, as tensors on ``device``. ``int8_weights``
    (exact int32 histogram accumulation) is sniffed from numpy weights when
    None: integers in [0, 127] with a total below 2^31, the JAX package's
    rule. ``enable_shear`` is sniffed from numpy samples when None.
    Float weights are accumulated in f32 directly (no bf16 split).
    ``limits_lo`` / ``limits_hi``: (P,) hard prior bounds (NaN = none);
    ``periodic``: (P,) bools; ``like_weights``: (N,) per-sample likelihood
    weights (mean-likelihood 'likes' in both outputs); ``fine_bins_2d``:
    the 2D grid (past 256 bins the pair histograms run on K1's wide
    kernels). Runs on the card unless ``device`` names the CPU; raises
    without CUDA.
    """
    sniffable = isinstance(weights, np.ndarray) or np.isscalar(weights) or isinstance(weights, (list, tuple))
    host_weights = np.asarray(weights) if sniffable else None
    if int8_weights is None:
        int8_weights = bool(
            sniffable
            and host_weights.size
            and np.all(host_weights == np.round(host_weights))
            and 0 <= host_weights.min()
            and host_weights.max() <= 127
            and host_weights.size * float(host_weights.max()) < 2**31
        )
    device = resolve_device(device)
    p = samples.shape[1]
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)], np.int64).reshape(-1, 2)
    if enable_shear is None:
        enable_shear = _sniff_shear(samples, max_corr, pairs=pairs, weights=host_weights)
    samples, weights = prepare_chain(samples, weights, device=device)
    limits_lo, limits_hi, periodic = _limit_arrays(p, limits_lo, limits_hi, periodic)
    if like_weights is not None:
        like_weights = _tensor(like_weights, device)
    return _triangle_program(
        samples,
        weights,
        pairs[:, 0],
        pairs[:, 1],
        np.asarray(contours, np.float32),
        int8_weights,
        max_corr,
        enable_shear,
        bandwidth_scale_1d=bandwidth_scale_1d,
        bandwidth_scale_2d=bandwidth_scale_2d,
        limits_lo=limits_lo,
        limits_hi=limits_hi,
        periodic=periodic,
        like_weights=like_weights,
        fine_bins_2d=fine_bins_2d,
    )
