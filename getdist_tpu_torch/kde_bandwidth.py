"""Kernel bandwidth selection: Botev Improved Sheather-Jones (ISJ).

The port's own copy of ``getdist_tpu/kde_bandwidth.py``, unchanged in its
arithmetic (scipy DCT and optimizers).

Implements the ISJ plug-in bandwidth of Botev, Grotowski & Kroese (2010,
Annals of Statistics 38:2916, arXiv:1011.2602) in 1D, and a 2D extension
with kernel-correlation estimation and numerical AMISE minimization
(behavioral spec: reference ``getdist/kde_bandwidth.py:102-309``; the
derivative-functional plug-in recursions there are evaluated here as
level-by-level tables instead of tree recursion — same arithmetic, each
functional computed once).

Architecture note: this module is the *parity-exact host path*. Everything
here operates on tiny O(grid) arrays (<= 2048 / 256^2), so it runs host-side
with scipy's DCT and the same scipy root-finders and tolerances as the
reference: the iterative optimizers (fsolve/brentq/TNC) amplify even 1e-16
input perturbations into ~1e-4 bandwidth differences, so bit-identical
transforms are required for 1e-6 density parity (verified empirically). The
fused all-pairs path instead uses the device DCT and batched bisection
(``getdist_tpu_torch.ops.batched``: ``_isj_bandwidth_1d`` /
``_kernel_bandwidth_2d``).
"""

import logging
import warnings

import numpy as np
import scipy.fftpack as _fftpack
from scipy.optimize import brentq, fsolve, minimize

__all__ = ["bin_samples", "gaussian_kde_bandwidth", "gaussian_kde_bandwidth_binned", "KernelOptimizer2D"]

_ROOT_PI = np.sqrt(np.pi)
_PI_SQ = np.pi**2


def _double_factorial(j):
    """(2j-1)!! for j >= 1 (== 1 for j in {0, 1})."""
    return np.prod(np.arange(1, 2 * j, 2))


# Depth of the 1D ISJ functional recursion (number of plug-in stages).
ISJ_LMAX = 7

# Stage constants xi_j = (1 + 2^{-j-1/2})/3 * (2j-1)!! / sqrt(pi/2) keyed by
# stage order j (Botev's gamma^{[l]} recursion).
_STAGE_XI = {
    j: (1 + 0.5 ** (j + 0.5)) / 3 * _double_factorial(j) / (_ROOT_PI / np.sqrt(2.0))
    for j in range(2, ISJ_LMAX)
}


def bin_samples(samples, range_min=None, range_max=None, nbins=2046, edge_fac=0.1):
    """Map samples to integer bin indices over an edge-padded range.

    Returns (indices, range_width); the default range pads the data extent
    by edge_fac on each side (role of reference ``kde_bandwidth.py:76-87``).
    """
    lo = np.min(samples)
    hi = np.max(samples)
    pad = (hi - lo) * edge_fac
    if range_min is None:
        range_min = lo - pad
    if range_max is None:
        range_max = hi + pad
    width = range_max - range_min
    dx = width / (nbins - 1)
    return ((samples - range_min) / dx).astype(int), width


def gaussian_kde_bandwidth(samples, Neff=None, range_min=None, range_max=None, nbins=2046):
    """ISJ bandwidth for raw (unbinned) samples, in sample units."""
    if Neff is None:
        Neff = np.count_nonzero(np.diff(samples)) + 1
    indices, width = bin_samples(samples, range_min, range_max, nbins)
    h = gaussian_kde_bandwidth_binned(np.bincount(indices, minlength=nbins), Neff)
    return None if h is None else h * width


def _refine_bandwidth_root(modes, neff):
    """fsolve from the 0.53 N^{-1/5} rule-of-thumb start; a suspiciously
    small root (< 0.019 N^{-1/5}) triggers a bracketed brentq recheck
    against the spurious-root regime."""
    scale = neff ** (-1.0 / 5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        start = 0.53 * scale
        root = fsolve(_isj_residual, start, (neff, modes), xtol=start / 20, factor=1)[0]
    if root < 0.019 * scale:
        try:
            root = brentq(_isj_residual, 0.019 * scale, 0.5, (neff, modes), xtol=root / 20)
        except Exception:
            # No sign change in the bracket: the small root may be real (or
            # the method failed, e.g. flat bounded distributions) — keep the
            # fsolve answer.
            pass
    return root


class _CosineModes1D:
    """DCT-space view of a binned 1D density: squared mode indices, their
    logs, and squared (halved) coefficients — everything the ISJ functional
    chain consumes."""

    __slots__ = ("i2", "log_i2", "coef2")

    def __init__(self, data, a=None):
        self.i2 = np.arange(1, np.asarray(data).size) ** 2
        self.log_i2 = np.log(self.i2)
        if a is None:
            a = _fftpack.dct(data / np.sum(data))
        self.coef2 = (a[1:] / 2) ** 2

    def functional(self, j, t):
        """||f^(j)||^2 estimate at squared smoothing scale t:
        2 pi^{2j} sum_i coef2_i i^{2j} exp(-i^2 pi^2 t)."""
        return 2 * np.pi ** (2 * j) * np.dot(self.coef2, np.exp(j * self.log_i2 - self.i2 * (_PI_SQ * t)))


def _isj_residual(h, neff, modes):
    """ISJ fixed-point residual f(h) = h - (2 N sqrt(pi) gamma(h))^{-1/5}.

    gamma chains ISJ_LMAX-1 derivative-functional estimates down from an
    initial t = h^2 smoothing; a root of f is the optimal bandwidth as a
    fraction of the binned range.
    """
    if h <= 0:
        return h - 1
    estimate = modes.functional(ISJ_LMAX, h**2)
    for j in range(ISJ_LMAX - 1, 1, -1):
        t_j = (_STAGE_XI[j] / neff / estimate) ** (2 / (3.0 + 2 * j))
        estimate = modes.functional(j, t_j)
        if not estimate:
            raise FloatingPointError("zero functional in ISJ fixed point (non-convergence)")
    return h - (2 * neff * _ROOT_PI * estimate) ** (-1.0 / 5)


def gaussian_kde_bandwidth_binned(data, Neff, a=None):
    """Optimal Gaussian kernel bandwidth for binned data, as a fraction of
    the data range, or None on failure (caller falls back to a rule of
    thumb; spec: reference ``kde_bandwidth.py:102-135``)."""
    modes = _CosineModes1D(data, a)
    try:
        return _refine_bandwidth_root(modes, Neff)
    except Exception as e:
        logging.warning("1D auto bandwidth failed. Using fallback: %s" % e)
        return None


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------

# Gaussian-kernel derivative values at zero, phi^(2j)(0) = (-1)^j (2j-1)!!/sqrt(2 pi)
_PHI_EVEN = {j: (-1) ** j * _double_factorial(j) / np.sqrt(2 * np.pi) for j in range(5)}
_PHI_EVEN[0] = 1 / np.sqrt(2 * np.pi)
# odd-order kernel constants for the psi_odd plug-in stages
_PHI_ODD = {0: 1.0, **{j: _double_factorial(j) / 2.0 ** (j + 1) / np.sqrt(np.pi) for j in range(1, 9)}}

# Derivative orders needed per plug-in level. Even table: targets (0,2),
# (2,0), (1,1) [+ (0,0)]; each level-s entry needs its two (+1)-children, so
# level s holds every order reachable from the targets; level 5 seeds the
# recursion directly from psi at t*. Odd table: targets (1,3)/(3,1) with
# (+2)-children up to level 10.
_EVEN_LEVELS = {
    5: [(i, 5 - i) for i in range(6)],
    4: [(i, 4 - i) for i in range(5)],
    3: [(i, 3 - i) for i in range(4)],
    2: [(i, 2 - i) for i in range(3)],
    1: [(0, 1), (1, 0)],
    0: [(0, 0)],
}
_ODD_LEVELS = {
    10: [(7, 3), (5, 5), (3, 7), (1, 9), (9, 1)],
    8: [(5, 3), (3, 5), (1, 7), (7, 1)],
    6: [(3, 3), (1, 5), (5, 1)],
    4: [(1, 3), (3, 1)],
}


class _CosineModes2D:
    """Squared 2D DCT spectrum of a binned density (even psi functionals)."""

    __slots__ = ("i2", "log_i2", "coef2")

    def __init__(self, normed):
        size = normed.shape[0]
        self.coef2 = _fftpack.dct(_fftpack.dct(normed, axis=0), axis=1)[1:, 1:] ** 2
        self.i2 = np.arange(1, size, dtype=np.float64) ** 2
        self.log_i2 = np.log(self.i2)

    def psi(self, sx, sy, t):
        """Even derivative functional psi_{sx,sy} at squared bandwidth t.
        sx weights the second (x) axis of the spectrum, sy the first (y)."""
        damp = -self.i2 * (_PI_SQ * t)
        wx = np.exp(damp + self.log_i2 * sx)
        wy = np.exp(damp + self.log_i2 * sy)
        return (-1) ** (sx + sy) * wy.dot(self.coef2).dot(wx.T) * np.pi ** (2 * (sx + sy)) / 4


class _FourierPower2D:
    """Full FFT power spectrum (odd functionals need signed frequencies)."""

    __slots__ = ("power", "freqs")

    def __init__(self, normed):
        spec = np.fft.fft2(normed)
        self.power = spec * np.conj(spec)
        self.freqs = np.fft.fftfreq(self.power.shape[0], d=1.0 / self.power.shape[0])

    def psi(self, sx, sy, t):
        damp = np.exp(-(self.freqs**2) * (4 * _PI_SQ * t))
        wx = damp * self.freqs**sx
        wy = damp * self.freqs**sy
        return wy.dot(self.power).real.dot(wx.T) * (2 * np.pi) ** (sx + sy)


def _even_table(modes, neff, t_star, min_level=0):
    """Plug-in estimates of the even functionals: evaluate level 5 at t*,
    then each lower level at its own stage bandwidth derived from its
    children (same arithmetic as the reference's tree recursion at
    kde_bandwidth.py:188-196, each value computed once)."""
    table = {s: modes.psi(*s, t_star) for s in _EVEN_LEVELS[5]}
    for level in range(4, min_level - 1, -1):
        for sx, sy in _EVEN_LEVELS[level]:
            children = table[(sx + 1, sy)] + table[(sx, sy + 1)]
            const = (1 + 0.5 ** (level + 1)) / 3
            t_s = (-2 * const * _PHI_EVEN[sx] * _PHI_EVEN[sy] / neff / children) ** (1.0 / (2 + level))
            table[(sx, sy)] = modes.psi(sx, sy, t_s)
    return table


def _odd_table(power, neff, p00, t_star):
    """Plug-in estimates of the odd functionals psi_13/psi_31 (spec:
    reference kde_bandwidth.py:198-213), via the same level-table scheme."""
    table = {s: power.psi(*s, t_star) for s in _ODD_LEVELS[10]}
    for level in (8, 6, 4):
        for sx, sy in _ODD_LEVELS[level]:
            children = table[(sx + 2, sy)] + table[(sx, sy + 2)]
            const = 8 * (1 - 2.0 ** (-level - 1)) / 3.0
            t_s = (const * p00 * _PHI_ODD[sx] * _PHI_ODD[sy] / neff**2 / children**2) ** (1.0 / (3 + level))
            table[(sx, sy)] = power.psi(sx, sy, t_s)
    return table


class KernelOptimizer2D:
    """2D ISJ bandwidth matrix optimizer with kernel correlation.

    Pipeline (spec: reference ``kde_bandwidth.py:146-309``): squared 2D DCT
    coefficients give even psi functionals, the full FFT power spectrum
    gives odd ones; t* solves the 2D fixed point by brentq; closed-form
    diagonal bandwidths (hx, hy) come from psi(0,2)/psi(2,0)/psi(1,1); then
    numerical AMISE minimization (TNC, bounded) admits kernel correlation c.

    Bandwidths are fractions of the binned ranges. ``correlation`` is the
    sample correlation used to seed/fix the AMISE search; ``fallback_t``
    (plug-in squared width) replaces t* when the fixed point fails or badly
    overshoots (bounded distributions).
    """

    def __init__(self, data, Neff, correlation, do_correlation=True, fallback_t=None):
        if data.shape[0] != data.shape[1]:
            raise ValueError("KernelOptimizer2D only handles square arrays currently")
        normed = data / np.sum(data)
        self._modes = _CosineModes2D(normed)
        self._power = _FourierPower2D(normed) if do_correlation else None
        self.N = Neff
        self.corr = correlation
        self.do_correlation = do_correlation
        self.t_star = self._solve_t_star(fallback_t)

    def _solve_t_star(self, fallback_t):
        try:
            # t is the squared moment-estimation bandwidth from the 2D fixed
            # point; with boundaries it can overshoot badly, in which case
            # the plug-in fallback wins.
            t_star = brentq(self._fixed_point_2d, 0, 0.1, xtol=0.001**2)
        except Exception:
            if fallback_t is None:
                raise
            logging.debug("2D kernel density optimizer using fallback plugin width %s" % np.sqrt(fallback_t))
            return fallback_t
        if fallback_t and t_star > 0.01 and t_star > 2 * fallback_t:
            logging.debug("KernelOptimizer2D using fallback (t* > 2*t_fallback)")
            return fallback_t
        return t_star

    def _fixed_point_2d(self, t):
        table = _even_table(self._modes, self.N, t, min_level=2)
        curvature = table[(0, 2)] + table[(2, 0)] + 2 * table[(1, 1)]
        implied = (2 * np.pi * self.N * curvature) ** (-1.0 / 3)
        return (t - implied) / implied

    def AMISE(self, cov, corr=None):
        """Asymptotic MISE for bandwidths (wx, wy[, rho]) using the stored
        psi-functional table; raises if the bias form is not positive."""
        wx, wy = cov[0], cov[1]
        rho = cov[2] if corr is None else corr
        table = self.p
        variance = 1.0 / (4 * np.pi * wx * wy * np.sqrt(1 - rho**2) * self.N)
        quartic = (
            wx**4 * table[4, 0]
            + wy**4 * table[0, 4]
            + 2 * wx**2 * wy**2 * table[2, 2] * (2 * rho**2 + 1)
            + 4 * rho * wx * wy * (wx**2 * table[3, 1] + wy**2 * table[1, 3])
        )
        bias = 0.25 * quartic
        if bias < 0:
            raise FloatingPointError("bias not positive definite")
        return variance + bias

    def _diag_widths(self, table):
        """Closed-form diagonal (wx, wy) from the curvature functionals."""
        pyy = table[(0, 2)]
        pxx = table[(2, 0)]
        pxy = table[(1, 1)]
        cross = pxy + np.sqrt(pxx * pyy)
        wx = (pyy ** (3.0 / 4) / (4 * np.pi * self.N * pxx ** (3.0 / 4) * cross)) ** (1.0 / 6)
        wy = (pxx ** (3.0 / 4) / (4 * np.pi * self.N * pyy ** (3.0 / 4) * cross)) ** (1.0 / 6)
        return wx, wy, pyy, pxx, pxy

    def get_h(self, do_correlation=None):
        """(hx, hy, c): closed-form diagonal widths, then AMISE-optimized
        correlated kernel when it clearly wins (spec: reference :234-306)."""
        if do_correlation is None:
            do_correlation = self.do_correlation
        table = _even_table(self._modes, self.N, self.t_star)
        wx, wy, pyy, pxx, pxy = self._diag_widths(table)
        rho = 0
        if not do_correlation:
            return wx, wy, rho

        self.p00 = table[(0, 0)]
        odd = _odd_table(self._power, self.N, self.p00, self.t_star)
        functionals = np.zeros((5, 5))
        for key, value in (
            ((0, 4), pyy),
            ((4, 0), pxx),
            ((2, 2), pxy),
            ((0, 0), self.p00),
            ((1, 3), odd[(1, 3)]),
            ((3, 1), odd[(3, 1)]),
        ):
            functionals[key] = value
        self.p = functionals

        best = self.AMISE(np.array([wx, wy, 0]))
        if self.corr:
            try:
                shrink = np.sqrt(1 - abs(self.corr))
                found = self._amise_search(np.array([wx, wy]) / shrink, fixed_corr=self.corr)
                if found.success:
                    candidate = self.AMISE(found.x, self.corr)
                    if candidate < best:
                        wx, wy = found.x
                        rho = self.corr
                        best = candidate
            except Exception:
                logging.debug("AMISE fixed correlation optimization failed")
        try:
            found = self._amise_search(np.array([wx, wy, self.corr]))
            if found.success and self.AMISE(found.x) < best * 0.9:
                wx, wy, rho = found.x
        except Exception:
            logging.debug("AMISE optimization failed")
        return wx, wy, rho

    _WIDTH_BOUND = (0.001, 0.3)

    def _amise_search(self, start, fixed_corr=None):
        """One bounded TNC minimization of the AMISE (free-correlation when
        start has 3 entries, fixed kernel correlation otherwise)."""
        box = [self._WIDTH_BOUND] * 2
        if len(start) == 3:
            box.append((-0.99, 0.99))
        return minimize(self.AMISE, start, (fixed_corr,), method="TNC", bounds=box)

    def get_hdiag(self):
        """Diagonal-only bandwidths (no kernel correlation)."""
        return self.get_h(do_correlation=False)
