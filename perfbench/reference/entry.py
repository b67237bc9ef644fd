"""The triangle analysis of one weighted chain, as the plain reference.

A frozen copy of the routes of the port's public entry,
``MCSamples.fastTriangleDensities`` (single dispatch; the two programs
with the planning readback; the corr-adaptive regrids past 256 bins; the
clamped-window rescue at a 768 frame; the mean-likelihood grids), written
over a plain chain instead of an ``MCSamples``: everything the entry reads
from its object (the weighted correlation matrix, the limits and periodic
flags of the ranges, the integer-weight test, the mean log-likelihood and
the like weights, the cumulant score) is worked out here again from the
raw samples, weights, log-likelihoods and ranges.

The entry's host rescues that need getdist's host bandwidth machinery (the
sheared f64 assist, the fragile-pair ``getAutoBandwidth2D`` and the host
1D densities of hard-limited parameters with a wide kernel) are not part
of this copy. The reference plans them as the entry does and lists the
pairs and parameters that take them in ``uncovered``; it computes nothing
for them, and their answers are left out of the comparison (every other
pair is computed on its own, so none depends on them).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .fused import _triangle_program, _tensor, all_1d_densities, all_2d_densities, pair_cumulant_score


# the regrid rescue's keys of an all_2d_densities result
_REGRID_KEYS = ("P", "contours", "rx", "ry", "corr", "neff")


@dataclass
class Chain:
    """One weighted chain as the benchmark hands it to both sides: (N, P) f64
    samples, (N,) weights, (N,) -log-likelihoods or None, parameter names
    and getdist-style ranges ({name: [lo, hi]} with None for an open end,
    [lo, hi, True] for a periodic parameter)."""

    samples: np.ndarray
    weights: np.ndarray
    loglikes: np.ndarray | None
    names: list
    ranges: dict = field(default_factory=dict)


@dataclass
class Settings:
    """The analysis settings the entry reads (getdist's analysis_defaults.ini)."""

    max_corr_2D: float = 0.99
    smooth_scale_1D: float = -1.0
    smooth_scale_2D: float = -1.0


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def correlation_matrix(chain):
    """The weighted correlation matrix in f64, as getdist computes it (means,
    the centred weighted covariance, then unit diagonal where the variance
    is not zero)."""
    w = chain.weights
    norm = w.sum()
    means = w @ chain.samples / norm
    centered = chain.samples - means
    cov = (centered * w[:, None]).T @ centered / norm
    sd = np.sqrt(cov.diagonal())
    for i in np.nonzero(sd)[0]:
        cov[i, :] /= sd[i]
        cov[:, i] /= sd[i]
    return cov


def limits(chain, idx):
    """(lo, hi, periodic) of the parameters ``idx``: (P,) f32 bounds, NaN for
    an open end, and bools."""
    lo, hi, per = [], [], []
    for j in idx:
        window = chain.ranges.get(chain.names[j], [None, None])
        lo.append(np.nan if window[0] is None or window[0] == -np.inf else float(window[0]))
        hi.append(np.nan if window[1] is None or window[1] == np.inf else float(window[1]))
        per.append(len(window) > 2 and bool(window[2]))
    return np.array(lo, np.float32), np.array(hi, np.float32), np.array(per, bool)


def bound_axes(chain, device):
    """(P,) bools: the parameters whose hard limit binds (cuts the padded
    range, as the fused 1D stage decides; a periodic one always does), and
    (P,) bools: the periodic ones."""
    lo, hi, per = limits(chain, range(len(chain.names)))
    if not (np.isfinite(lo).any() or np.isfinite(hi).any() or per.any()):
        return np.zeros(len(chain.names), bool), per
    with torch.no_grad():
        d1 = all_1d_densities(_tensor(chain.samples, device), _tensor(chain.weights, device), limits_lo=lo,
                              limits_hi=hi, periodic=per if per.any() else None)
    return _host(d1["active_lo"] | d1["active_hi"]) | per, per


def integer_weights(w):
    """Whether every weight is an integer in [0, 127] with a total below 2^31."""
    return bool(w.size and np.all(w == np.round(w)) and w.min() >= 0 and w.max() <= 127
                and w.size * float(w.max()) < 2**31)


def like_weights(chain):
    """The mean-likelihood grids' per-sample weights w exp(<-log L> - (-log L))."""
    w = chain.weights
    mean_loglike = float(w @ chain.loglikes / w.sum())
    return w * np.exp(mean_loglike - chain.loglikes)


def _regrid_entries(d2x, plist):
    keys = _REGRID_KEYS + (("likes",) if d2x.get("likes") is not None else ())
    return {key: {name: d2x[name][i] for name in keys} for i, key in enumerate(plist)}


class TriangleReference:
    """The triangle analysis of one chain on ``device``: :meth:`run` returns
    (d1, d2, pairs) as the entry does, and ``regrid_groups`` lists the reruns
    as the entry's ``fast_regrid_groups`` does; ``uncovered`` maps each pair
    (position tuple) or parameter position that takes a host rescue the
    reference does not copy to that rescue's kind."""

    def __init__(self, chain, device, settings=None):
        self.chain = chain
        self.settings = settings or Settings()
        self.device = torch.device(device)
        self.int8 = integer_weights(chain.weights)
        self.corr_full = correlation_matrix(chain)
        self._cum = None
        self._dev = None
        self.regrid_groups = []
        self.uncovered = {}

    def _device_view(self, idx):
        if self._dev is None:
            self._dev = _tensor(self.chain.samples, self.device), _tensor(self.chain.weights, self.device)
        s, w = self._dev
        if list(idx) != list(range(s.shape[1])):
            s = s[:, torch.as_tensor(list(idx), device=self.device)]
        return s, w

    def _cum_score(self):
        if self._cum is None:
            self._cum = _host(pair_cumulant_score(*self._device_view(range(len(self.chain.names)))))
        return self._cum

    def run(self, idx, contours=(0.68, 0.95), meanlikes=False):
        chain, st = self.chain, self.settings
        self.regrid_groups = []
        self.uncovered = {}
        lo, hi, per = limits(chain, idx)
        has = bool(np.isfinite(lo).any() or np.isfinite(hi).any() or per.any())
        like_w = None
        if meanlikes and chain.loglikes is not None:
            like_w = torch.from_numpy(like_weights(chain).astype(np.float32)).to(self.device)
        scale_1d = -float(st.smooth_scale_1D) if float(st.smooth_scale_1D) < 0 else 1.0
        scale_2d = -float(st.smooth_scale_2D) if float(st.smooth_scale_2D) < 0 else 1.0
        bs1 = None if scale_1d == 1.0 else scale_1d
        bs2 = None if scale_2d == 1.0 else scale_2d
        dev_s, dev_w = self._device_view(idx)
        p = len(idx)
        pairs = [(a, b) for a in range(p) for b in range(a + 1, p)]
        pairs_arr = np.array(pairs, np.int64).reshape(-1, 2)
        corr = self.corr_full[np.ix_(idx, idx)]
        sel = [k for k, (a, b) in enumerate(pairs) if abs(corr[a, b]) > 0.15]
        enable_shear = False if not sel else (True if len(sel) == len(pairs) else tuple(sel))
        contours_np = np.array(contours, np.float32)
        max_corr = float(st.max_corr_2D)
        k_pairs = len(pairs)
        lims = dict(limits_lo=lo, limits_hi=hi) if has else {}
        per_arg = per if per.any() else None

        abs_corr = np.abs(np.asarray(corr, float))
        np.fill_diagonal(abs_corr, 0.0)
        max_corr_val = float(abs_corr.max(initial=0.0))
        single = not has and like_w is None and max_corr_val < 0.866
        if single and max_corr_val >= 0.5:
            cum = self._cum_score()[np.ix_(idx, idx)]
            single = not any(abs(corr[a, b]) >= 0.5 and cum[a, b] > 0.25 for a, b in pairs)
        if single:
            d1, d2 = _triangle_program(
                dev_s, dev_w, pairs_arr[:, 0], pairs_arr[:, 1], contours_np, self.int8, max_corr=max_corr,
                enable_shear=enable_shear, bandwidth_scale_1d=bs1, bandwidth_scale_2d=bs2,
            )
            d2 = dict(d2)
            diag = _host(d2["diag"])
            frag = diag[:k_pairs] > 0.5
            regrid = {}
            if frag.any():
                plan = self._plan(idx, pairs, corr, d1, fragile=frag, fragile_only=True)
                regrid = self._exec(plan, idx, pairs, d1, contours, scale_2d)
            d2["regrid"] = regrid
            self._clamped(idx, pairs, d1, d2, contours, scale_2d, diag[k_pairs : 2 * k_pairs],
                          diag[2 * k_pairs : 3 * k_pairs])
            return d1, d2, pairs

        with torch.no_grad():
            d1 = all_1d_densities(dev_s, dev_w, periodic=per_arg, like_weights=like_w, bandwidth_scale=bs1, **lims)
        packed = _host(d1["host_pack"])
        d1h = {
            "neff": packed[:p],
            "sigma_range": packed[p : 2 * p],
            "range0": packed[2 * p : 3 * p],
            "range1": packed[3 * p : 4 * p],
            "bandwidth": packed[4 * p : 5 * p],
        }
        with torch.no_grad():
            d2 = all_2d_densities(
                dev_s, dev_w, pairs_arr[:, 0], pairs_arr[:, 1], d1["neff"], d1["range"][0], d1["range"][1],
                contours_np, active_lo=d1["active_lo"] if has else None, active_hi=d1["active_hi"] if has else None,
                periodic=per_arg, int8_weights=self.int8, bandwidth_scale=bs2, sigma_range=d1["sigma_range"],
                max_corr=max_corr, enable_shear=enable_shear, like_weights=like_w, export_hists=True,
            )
        d2 = dict(d2)
        hists = d2.pop("hists", None)
        plan = self._plan(idx, pairs, corr, d1, fragile=None, d1_host=d1h)
        if has:
            self._wide_bounded_1d(idx, lo, hi, d1h)
        regrid = self._exec(plan, idx, pairs, d1, contours, scale_2d, hists=hists, bounded=has, per=per_arg,
                            like_weights=like_w)
        diag = _host(d2["diag"])
        frag = diag[:k_pairs] > 0.5
        plan = self._plan(idx, pairs, corr, d1, fragile=frag, fragile_only=True, d1_host=d1h)
        regrid.update(self._exec(plan, idx, pairs, d1, contours, scale_2d, hists=hists, bounded=has, per=per_arg,
                                 like_weights=like_w))
        d2["regrid"] = regrid
        self._clamped(idx, pairs, d1, d2, contours, scale_2d, diag[k_pairs : 2 * k_pairs],
                      diag[2 * k_pairs : 3 * k_pairs], bounded=has, per=per_arg, like_weights=like_w)
        return d1, d2, pairs

    def _wide_bounded_1d(self, idx, lo, hi, d1_host):
        """The entry serves hard-limited parameters whose kernel spans more
        than 0.15 of their grid from the host 1D density: not copied, listed
        in ``uncovered``."""
        bw = np.asarray(d1_host["bandwidth"], float)
        span = np.maximum(np.asarray(d1_host["range1"], float) - np.asarray(d1_host["range0"], float), 1e-30)
        bounded = np.isfinite(lo) | np.isfinite(hi)
        for i in range(len(idx)):
            if bounded[i] and bw[i] / span[i] > 0.15:
                self.uncovered[i] = "host_1d"

    def _clamped(self, idx, pairs, d1, d2, contours, scale_2d, rxs, rys, bounded=False, per=None, like_weights=None):
        """Re-run pairs whose kernel width saturated the fixed window (rx/ry at
        winw/2.5 bins) with a near-half-grid window (winw 126 at 256 bins)."""
        regrid = d2.get("regrid", {})
        base_cap = 30 / 2.5

        def regrid_cap(entry):
            n_fine = int(entry["P"].shape[0])
            return max(30, int(round(n_fine / 9.0))) / 2.5

        saturated = []
        for k, key in enumerate(pairs):
            if key in self.uncovered:
                continue
            entry = regrid.get(key)
            if entry is not None:
                widest = max(float(entry["rx"]), float(entry["ry"]))
                cap = regrid_cap(entry)
            else:
                widest, cap = max(float(rxs[k]), float(rys[k])), base_cap
            if widest >= cap - 1e-3:
                saturated.append(key)
        if not saturated:
            return
        fine = 256
        dev_s, dev_w = self._device_view(idx)
        with torch.no_grad():
            d2w = all_2d_densities(
                dev_s, dev_w, np.array([a for a, _ in saturated]), np.array([b for _, b in saturated]),
                d1["neff"], d1["range"][0], d1["range"][1], np.array(contours, np.float32), fine_bins=fine,
                int8_weights=self.int8, bandwidth_scale=None if scale_2d == 1.0 else scale_2d,
                sigma_range=d1["sigma_range"], max_corr=float(self.settings.max_corr_2D), winw=fine // 2 - 2,
                active_lo=d1["active_lo"] if bounded else None, active_hi=d1["active_hi"] if bounded else None,
                periodic=per, like_weights=like_weights,
            )
        regrid.update(_regrid_entries(d2w, saturated))
        d2["regrid"] = regrid
        self.regrid_groups.append({"fine": fine, "winw": fine // 2 - 2, "pairs": saturated, "bandwidths": "clamped"})

    def _plan(self, idx, pairs, corr, d1, fragile=None, fragile_only=False, d1_host=None):
        """The pairs to re-run at the corr-adaptive fine grid (fine > 256,
        bandwidths from the in-program optimizer). The sheared assist and the
        fragile-pair host bandwidths are not copied: a pair that takes one
        goes into ``uncovered``."""
        max_corr = float(self.settings.max_corr_2D)
        lo, hi, _ = limits(self.chain, idx)

        def limited(k):
            return bool(np.isfinite(lo[k]) or np.isfinite(hi[k]))

        def cum_gate(a, b):
            return self._cum_score()[np.ix_(idx, idx)][a, b] > 0.25

        if fragile is not None and fragile.any():
            fragile = np.array([bool(f) and cum_gate(a, b) for f, (a, b) in zip(fragile, pairs)])
        if fragile_only and (fragile is None or not fragile.any()):
            return []
        groups = {}
        for k, (a, b) in enumerate(pairs):
            cc_raw = float(corr[a, b])
            cc = float(np.clip(cc_raw, -max_corr, max_corr))
            fine = 256
            if abs(cc) >= 0.1:
                angle_scale = max(0.2, np.sqrt(1 - min(max_corr, abs(cc)) ** 2))
                if int(1 / angle_scale) > 1:
                    scaled = 192 * int(3 / angle_scale) // 3
                    if scaled > 256:
                        fine = scaled
            assist = 0.5 <= abs(cc_raw) <= max_corr and not (limited(a) and limited(b)) and cum_gate(a, b)
            frag = bool(fragile is not None and fragile[k]) and not assist
            if assist or frag:
                self.uncovered[(a, b)] = "assist" if assist else "fragile"
            elif not fragile_only and fine > 256:
                groups.setdefault(fine, []).append((a, b))
        return [(fine, plist, None, "program") for fine, plist in groups.items()]

    def _exec(self, plan, idx, pairs, d1, contours, scale_2d=1.0, hists=None, bounded=False, per=None,
              like_weights=None):
        """Re-run each planned group through all_2d_densities with a window of
        max(30, fine / 9) bins."""
        regrid = {}
        if not plan:
            return regrid
        pair_pos = {key: k for k, key in enumerate(pairs)}
        dev_s, dev_w = self._device_view(idx)
        for fine, plist, override, kind in plan:
            winw = max(30, int(round(fine / 9.0)))
            hin = None
            if hists is not None and fine == 256:
                hin = hists[torch.as_tensor([pair_pos[key] for key in plist], device=hists.device)]
            with torch.no_grad():
                d2x = all_2d_densities(
                    dev_s, dev_w, np.array([a for a, _ in plist]), np.array([b for _, b in plist]),
                    d1["neff"], d1["range"][0], d1["range"][1], np.array(contours, np.float32), fine_bins=fine,
                    int8_weights=self.int8, bandwidth_scale=None if scale_2d == 1.0 else scale_2d,
                    bandwidth_override=override, sigma_range=d1["sigma_range"],
                    max_corr=float(self.settings.max_corr_2D), winw=winw, hists_in=hin,
                    active_lo=d1["active_lo"] if bounded else None, active_hi=d1["active_hi"] if bounded else None,
                    periodic=per, like_weights=like_weights,
                )
            regrid.update(_regrid_entries(d2x, plist))
            self.regrid_groups.append({"fine": fine, "winw": winw, "pairs": plist, "bandwidths": kind})
        return regrid
