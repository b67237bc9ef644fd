"""Device passes of parity mode's O(N) stages, as f64 tensor code.

Counterpart of ``getdist_tpu/ops/parity_device.py``: bin indices (the
``_binSamples`` and ``kde_bandwidth.bin_samples`` conventions), exact
weighted pair histograms (kernels K1 and K4), sheared Cholesky residual
rows, batched autocorrelation lengths and the KDE-N_eff lag pair sums,
on f64 tensors on the chain's device (the CPU runs the same code, with
the histogram kernels' plain versions).

TPU workarounds that Hopper does not need, and that are not carried over:
``_div_refined`` and ``_trunc_exact`` (f64 division on the card is
correctly rounded and f64 -> int truncation exact), the bf16
``weight_parts`` split (the histogram kernel accumulates integer weights
in int32), tracing under ``jax.enable_x64(False)``, and the f32 FFT of
``acl_batch`` with its absolute guard bands: the autocorrelation curve is
computed in f64 here, with a relative guard band sized to f64 error.

Bin indices divide by a tensor, never by a Python scalar, so that every
quotient is the correctly rounded one numpy computes.
"""

from __future__ import annotations

import numpy as np
import torch

from getdist_tpu_torch.ops.fft import next_fast_len
from getdist_tpu_torch.ops.pair_hist import pair_histograms, pair_histograms_dynamic

__all__ = [
    "ACL_BAND",
    "LAG_CHUNK_BYTES",
    "acl_batch",
    "bin_indices",
    "bin_rows",
    "sheared_rows_minmax",
    "group_pair_hists",
    "kde_neff_batch",
    "lag_terms",
]

# relative guard band of acl_batch: ~1e4 times the f64 FFT error of the
# curve (~1e-13 of curve[0] at 1M samples)
ACL_BAND = 1e-9
# bound on the (jobs, N) f64 intermediates of one lag_terms chunk
LAG_CHUNK_BYTES = 256 << 20


def _f64(x, device):
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def bin_indices(samples, binmin, fine_width):
    """(P, N) int32 fine-bin indices of (N, P) f64 samples, the
    ``_binSamples`` convention ``((x - binmin) / fine_width + 0.5)``
    truncated per column."""
    device = samples.device
    cols = samples.T
    return ((cols - _f64(binmin, device)[:, None]) / _f64(fine_width, device)[:, None] + 0.5).to(torch.int32)


def bin_rows(rows, rmin, dx):
    """(J, N) int32 indices of (J, N) f64 rows, the ``kde_bandwidth.
    bin_samples`` convention ``((x - rmin) / dx)`` truncated."""
    device = rows.device
    return ((rows - _f64(rmin, device)[:, None]) / _f64(dx, device)[:, None]).to(torch.int32)


def sheared_rows_minmax(samples, other_ix, lead_ix, r00, r10, r11):
    """Sheared residual rows for the host 2D bandwidth optimizer's
    correlated branch plus their data extents:
    rows[j] = (r00[j] * samples[:, other[j]] - r10[j] * samples[:, lead[j]]) / r11[j].
    Returns (rows (J, N), min (J,), max (J,))."""
    device = samples.device
    other = samples[:, torch.as_tensor(np.asarray(other_ix, np.int64), device=device)].T
    lead = samples[:, torch.as_tensor(np.asarray(lead_ix, np.int64), device=device)].T
    rows = (_f64(r00, device)[:, None] * other - _f64(r10, device)[:, None] * lead) / _f64(r11, device)[:, None]
    return rows, torch.amin(rows, dim=1), torch.amax(rows, dim=1)


def _tile_group_for(p):
    """The TPU tiled histogram kernel's group size at ``p`` index rows
    (``getdist_tpu/ops/batched.py:_tile_group_for``): the fewest dot
    slots, larger groups on ties."""

    def slots(g):
        ng = -(-p // g)
        return ng * (ng - 1) // 2 * g * g + ng * g * (g - 1) // 2

    return -min((slots(g), -g) for g in (4, 5, 6, 8, 10) if g <= max(p, 4))[1]


def static_route(r, k):
    """True when a K-pair list over R index rows takes K1's static entry:
    the TPU tile plan would not mostly pad (``parity_device.py:146-149``)."""
    group = _tile_group_for(r)
    ng = -(-r // group)
    slots = ng * (ng - 1) // 2 * group * group + ng * group * (group - 1) // 2
    return slots <= max(2 * k, k + 64)


def group_pair_hists(ix, pa, pb, weights32, fine, integer_weights):
    """(K, fine, fine) f32 weighted pair histograms (rows = b, cols = a,
    the ``_make2Dhist`` convention), exact for integer weights with bin sums
    below 2^24. ``ix``: (R, N) int32 index rows; ``pa``/``pb``: (K,) row
    positions (host arrays); ``weights32``: (N,) f32. Pair lists whose TPU
    tile plan would not pad take K1's entry, the others (the sheared
    lead/residual stacks) K4's."""
    device = ix.device
    pa = torch.as_tensor(np.asarray(pa, np.int32), device=device)
    pb = torch.as_tensor(np.asarray(pb, np.int32), device=device)
    rows = ix.to(torch.uint8 if fine <= 256 else torch.int16).contiguous()
    entry = pair_histograms if static_route(ix.shape[0], pa.shape[0]) else pair_histograms_dynamic
    return entry(rows, weights32, pa, pb, integer_weights=integer_weights, nbins=fine)


def acl_batch(samples, weights, means, variances, col_ix, maxlag, min_corr=0.05):
    """Batched autocorrelation lengths for the parity pipeline.

    Twin of the host chain ``getAutocorrelation(maxOff) -> acl_from_curve``
    (reference ``chains.py:423-466``) for every parameter in one f64 FFT
    pass: curve[k] = sum_i d_i d_{i+k} / overlap / var with d = (x - mean) w,
    acl = curve[0] + 2 * the sum of the leading run above min_corr * curve[0].
    Returns (acl (P,) f64, safe (P,) bool): ``safe`` is False where f64
    rounding could change the integer lag horizon the caller derives (a
    threshold comparison within :data:`ACL_BAND` of curve[0], or 1.5 * acl
    within that band, relatively, of an integer); the caller recomputes
    those parameters on the exact host path."""
    device = samples.device
    cols = samples[:, torch.as_tensor(np.asarray(col_ix, np.int64), device=device)].T
    n = cols.shape[1]
    fft_size = next_fast_len(2 * n)
    d = (cols - _f64(means, device)[:, None]) * weights[None, :]
    spec = torch.fft.rfft(d, fft_size, dim=1)
    lags = torch.fft.irfft(spec * torch.conj(spec), fft_size, dim=1)[:, :maxlag]
    overlap = n - torch.arange(maxlag, dtype=torch.float64, device=device)
    corr = lags / overlap[None, :] / _f64(variances, device)[:, None]
    c0 = corr[:, :1]
    t = min_corr * c0
    above = corr > t
    cut = torch.argmin(above.to(torch.int8), dim=1)  # first below-threshold lag (0 if none)
    k = torch.arange(maxlag, device=device)[None, :]
    tail = torch.sum(torch.where((k >= 1) & (k < cut[:, None]), corr, 0.0), dim=1)
    acl = (corr[:, 0] + 2.0 * tail).cpu().numpy()
    margin = (torch.amin(torch.abs(corr - t), dim=1) / torch.abs(c0[:, 0])).cpu().numpy()
    frac = np.mod(1.5 * acl, 1.0)
    tol = ACL_BAND * np.maximum(1.0, 1.5 * np.abs(acl))
    safe = (margin > ACL_BAND) & (frac > tol) & (frac < 1.0 - tol) & np.isfinite(acl)
    return acl, safe


def kde_neff_batch(samples, weights, host_weights, kernel_stds, maxoffs, numrows, min_corr=0.05, col_ix=None):
    """Batched KDE effective-sample denominators N (the caller divides
    ``norm**2 / N``), reproducing the host adaptive-lag driver
    (``samplemath.kde_pair_sum_adaptive``, reference ``chains.py:477-574``)
    for every parameter in two device passes: first the five baseline lags
    near numrows//2, lags 1 and 2 and the coarse-probe chain
    maxoff//3, //9, ...; then, after the host replays the driver's branch
    logic on those values, the strided lags each parameter still needs.
    Values match the host pair sums to reduction order (~1e-15)."""
    p_count = len(kernel_stds)
    cols = list(range(p_count)) if col_ix is None else list(col_ix)
    far = numrows // 2
    lag0 = float(np.dot(host_weights, host_weights))
    floor = min_corr * lag0

    jobs_a, keys_a = [], []
    for p in range(p_count):
        for lag in (far, far + 1, far + 2, far + 3, far + 4, 1, 2):
            jobs_a.append((cols[p], lag, kernel_stds[p]))
            keys_a.append((p, lag))
        h = int(maxoffs[p])
        while h > 10:
            jobs_a.append((cols[p], h // 3, kernel_stds[p]))
            keys_a.append((p, h // 3))
            h //= 3
    table = dict(zip(keys_a, lag_terms(samples, weights, jobs_a)))

    n_out = np.empty(p_count)
    jobs_b = []
    plan_b = {}
    for p in range(p_count):
        base = sum(table[(p, far + i)] for i in range(5)) / sum(numrows - (far + i) for i in range(5))

        def excess(lag, p=p, base=base):
            return table[(p, lag)] - (numrows - lag) * base

        first = excess(1)
        if first < floor:
            n_out[p] = lag0
            continue
        second = excess(2)
        if second <= floor:
            n_out[p] = lag0 + 2 * first
            continue
        horizon = int(maxoffs[p])
        while horizon > 10 and excess(horizon // 3) < floor:
            horizon //= 3
        stride = 1 if horizon < 20 else horizon // 10
        lags = list(range(3, int(maxoffs[p]) + 1, stride))
        plan_b[p] = (first, second, stride, lags, base)
        jobs_b.extend(((cols[p], lag, kernel_stds[p]), (p, lag)) for lag in lags)

    if jobs_b:
        vals_b = lag_terms(samples, weights, [job for job, _ in jobs_b])
        table.update({key: v for (_, key), v in zip(jobs_b, vals_b)})
    for p, (first, second, stride, lags, base) in plan_b.items():
        acc = first + second
        for k in lags:
            val = table[(p, k)] - (numrows - k) * base
            if val < floor:
                break
            acc += val * stride if k > 3 else val * stride / 2
        n_out[p] = lag0 + 2 * acc
    return n_out


def lag_terms(samples, weights, jobs):
    """KDE lag pair sums: ``jobs`` is a list of (column, lag, kernel_std);
    job j sums exp(-(d[n + lag] - d[n])^2 / (4 kstd^2)) w[n + lag] w[n] over
    n < N - lag (host twin ``samplemath.kde_lag_term_1d``). Jobs run in
    chunks whose (jobs, N) f64 intermediates stay within
    :data:`LAG_CHUNK_BYTES`. Returns a host f64 array."""
    if not jobs:
        return np.zeros(0)
    device = samples.device
    n = samples.shape[0]
    out = np.empty(len(jobs))
    step = max(1, LAG_CHUNK_BYTES // (8 * n))
    pos = torch.arange(n, device=device)
    for s in range(0, len(jobs), step):
        chunk = jobs[s : s + step]
        col = torch.as_tensor([j[0] for j in chunk], dtype=torch.int64, device=device)
        lag = torch.as_tensor([j[1] for j in chunk], dtype=torch.int64, device=device)
        inv4k2 = _f64([0.25 / float(j[2]) ** 2 for j in chunk], device)
        shifted = torch.clamp(pos[None, :] + lag[:, None], max=n - 1)  # (J, N)
        d = samples.T[col]  # (J, N)
        diff = torch.gather(d, 1, shifted) - d
        terms = torch.exp(diff * diff * -inv4k2[:, None]) * (weights[shifted] * weights[None, :])
        valid = pos[None, :] < (n - lag)[:, None]
        out[s : s + len(chunk)] = torch.sum(torch.where(valid, terms, 0.0), dim=1).cpu().numpy()
    return out
