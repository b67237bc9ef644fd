"""Analytic Gaussian-mixture distributions.

These serve two roles, matching the capabilities of the reference
``getdist/gaussian_mixtures.py``: (a) test oracles — mixtures with known
marginals against which KDE output is scored, and (b) Fisher-style plotting
inputs (draw confidence ellipses for a forecast covariance without samples).

Capabilities: pdf evaluation, analytic 1D/2D density grids, marginalization
and conditioning (Schur complement), rejection sampling under hard bounds,
and minting :class:`~.mcsamples.MCSamples` sets for the plotting layer.

Reproducibility contract: seeded fixtures depend on the *order* of numpy
Generator calls in :meth:`MixtureND.sim` (one multinomial per round, then one
multivariate_normal per non-empty component, a final permutation only when
more than one block was drawn) and in :class:`RandomTestMixtureND` (component
covariances before means).  Do not reorder those calls.
"""

import copy
from dataclasses import dataclass

import numpy as np

from getdist_tpu_torch.densities import Density1D, Density2D
from getdist_tpu_torch.mcsamples import MCSamples
from getdist_tpu_torch.paramnames import ParamNames

__all__ = [
    "MixtureND",
    "Mixture2D",
    "Mixture1D",
    "Gaussian1D",
    "Gaussian2D",
    "GaussianND",
    "RandomTestMixtureND",
    "randomTestMCSamples",
    "make_2D_Cov",
]

_BIG_DRAW = 100000  # minimum top-up block for rejection sampling


def make_2D_Cov(sigmax, sigmay, corr):
    off_diag = corr * sigmax * sigmay
    return np.array([[sigmax * sigmax, off_diag], [off_diag, sigmay * sigmay]])


@dataclass
class _Gauss:
    """One mixture component with cached inverse and normalization."""

    mean: np.ndarray
    cov: np.ndarray
    icov: np.ndarray
    norm: float

    @classmethod
    def build(cls, mean, cov):
        cov = np.array(cov)
        ndim = cov.shape[0]
        return cls(
            mean=np.asarray(mean, dtype=np.float64),
            cov=cov,
            icov=np.linalg.inv(cov),
            norm=float(np.sqrt(np.linalg.det(cov)) * (2 * np.pi) ** (ndim / 2.0)),
        )

    def density(self, pts):
        """Normalized Gaussian density at pts, shape (..., dim)."""
        diff = pts - self.mean
        quad = ((diff @ self.icov) * diff).sum(axis=-1)
        return np.exp(-0.5 * quad) / self.norm

    def density_axis(self, axis, x):
        """1D marginal of this component along one axis."""
        var = self.cov[axis, axis]
        z = x - self.mean[axis]
        return np.exp(-0.5 * z * z / var) / np.sqrt(2 * np.pi * var)


class MixtureND:
    """Weighted sum of multivariate Gaussians, with optional per-parameter
    hard bounds (``lims``).  With bounds set, ``pdf`` is unnormalized and
    analytic marginalization is refused for bounded directions."""

    lims = None  # hard bounds; None = fully analytic mixture

    def __init__(self, means, covs, weights=None, lims=None, names=None, label="", labels=None):
        """
        :param means: iterable of component mean vectors
        :param covs: iterable of component covariance matrices
        :param weights: relative component weights (default: equal)
        :param lims: optional [(min, max), ...] hard bounds, None entries open
        :param names: parameter names (defaults to param1, param2, ...)
        :param label: legend label for the mixture
        :param labels: latex labels for the parameters
        """
        self._components = [_Gauss.build(m, c) for m, c in zip(means, covs)]
        k = len(self._components)
        w = np.full(k, 1.0 / k) if weights is None else np.array(weights, dtype=np.float64)
        wsum = w.sum()
        if wsum <= 0:
            raise ValueError("Weight <= 0 in MixtureND")
        self.weights = w / wsum
        self.lims = lims
        self.label = label
        self.paramNames = ParamNames(names=names, default=self.dim, labels=labels)
        self.names = self.paramNames.list()
        # moments of the full mixture (law of total mean/covariance)
        mu = self.weights @ self.means
        self.total_mean = np.atleast_1d(mu)
        scatter = self.means - mu
        self.total_cov = np.einsum("k,kij->ij", self.weights, np.stack(self.covs)) + np.einsum(
            "k,ki,kj->ij", self.weights, scatter, scatter
        )

    # -- array views kept for API compatibility with the reference ---------

    @property
    def dim(self):
        return self._components[0].mean.size

    @property
    def means(self):
        return np.stack([g.mean for g in self._components])

    @property
    def covs(self):
        return [g.cov for g in self._components]

    @property
    def invcovs(self):
        return [g.icov for g in self._components]

    @property
    def norms(self):
        return np.array([g.norm for g in self._components])

    # -- evaluation ---------------------------------------------------------

    def pdf(self, x):
        """Mixture density at x (point or batch).  Points are assumed to lie
        inside any hard bounds; with bounds set the result is unnormalized."""
        x = np.asarray(x)
        out = 0.0
        for w, g in zip(self.weights, self._components):
            out = out + w * g.density(x)
        return out

    def pdf_marged(self, index, x, no_limit_marge=False):
        """Analytic marginal density along one parameter (by index or name).
        Refused when other parameters carry hard bounds."""
        axis = self._axis_of(index)
        if not no_limit_marge:
            self.checkNoLimits([axis])
        out = 0.0
        for w, g in zip(self.weights, self._components):
            out = out + w * g.density_axis(axis, x)
        return out

    def _axis_of(self, index):
        return self.names.index(index) if isinstance(index, str) else index

    def checkNoLimits(self, keep_params):
        if self.lims is None:
            return
        for i, (lo, hi) in enumerate(self.lims):
            if i not in keep_params and not (lo is None and hi is None):
                raise Exception(
                    "In general can only marginalize analytically if no hard boundary limits: " + self.label
                )

    def getLower(self, name):
        return None if self.lims is None else self.lims[self.names.index(name)][0]

    def getUpper(self, name):
        return None if self.lims is None else self.lims[self.names.index(name)][1]

    # -- plot ranges and analytic density grids ------------------------------

    def autoRanges(self, sigma_max=4, lims=None):
        """Per-parameter (min, max) plot ranges: the hard bound where one is
        set, otherwise the envelope of mean +/- sigma_max*sigma over the
        components (widened past a one-sided bound by sigma_max*sigma)."""
        bounds = lims if lims is not None else (self.lims or [(None, None)] * self.dim)
        ranges = []
        for axis, (lo_bound, hi_bound) in enumerate(bounds):
            if lo_bound is not None and hi_bound is not None:
                ranges.append((lo_bound, hi_bound))
                continue
            sig = sigma_max * np.sqrt([g.cov[axis, axis] for g in self._components])
            centers = self.means[:, axis]
            his = centers + sig
            los = centers - sig
            if lo_bound is not None:
                his = np.maximum(his, lo_bound + sig)
            if hi_bound is not None:
                los = np.minimum(los, hi_bound - sig)
            ranges.append(
                (lo_bound if lo_bound is not None else los.min(), hi_bound if hi_bound is not None else his.max())
            )
        return ranges

    def density1D(self, index=0, num_points=1024, sigma_max=4, no_limit_marge=False):
        """Analytic marginalized :class:`~.densities.Density1D` grid."""
        axis = self._axis_of(index)
        if not no_limit_marge:
            self.checkNoLimits([axis])
        lo, hi = self.autoRanges(sigma_max)[axis]
        x = np.linspace(lo, hi, num_points)
        return Density1D(x, self.pdf_marged(axis, x, no_limit_marge=True))

    def density2D(self, params=None, num_points=1024, xmin=None, xmax=None, ymin=None, ymax=None, sigma_max=5):
        """Analytic marginalized :class:`~.densities.Density2D` grid for two
        parameters (default: the first two / the only two)."""
        if isinstance(self, Mixture2D) and params is None and self.dim == 2:
            pair = self
        elif self.dim < 2:
            raise Exception("density2D requires at least two dimensions")
        else:
            pair = self.marginalizedMixture(params=params)
        box = dict(xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax)
        return pair._density2D(num_points=num_points, sigma_max=sigma_max, **box)

    # -- reduction ------------------------------------------------------------

    def _indices_for(self, params):
        indexed = []
        for p in params if params is not None else self.names:
            if isinstance(p, str):
                indexed.append(self.names.index(p))
            elif hasattr(p, "name"):
                indexed.append(self.names.index(p.name))
            else:
                indexed.append(p)
        return indexed

    def marginalizedMixture(self, params, label=None, no_limit_marge=False) -> "MixtureND":
        """The mixture projected onto a subset of parameters."""
        keep = self._indices_for(params)
        if not no_limit_marge:
            self.checkNoLimits(keep)
        keep = np.array(keep)
        cls = Mixture2D if keep.size == 2 else MixtureND
        reduced = cls(
            [g.mean[keep] for g in self._components],
            [g.cov[np.ix_(keep, keep)] for g in self._components],
            self.weights,
            lims=None if self.lims is None else [self.lims[i] for i in keep],
            names=None if self.names is None else [self.names[i] for i in keep],
            label=self.label if label is None else label,
        )
        reduced.paramNames.setLabelsAndDerivedFromParamNames(self.paramNames)
        return reduced

    def conditionalMixture(self, fixed_params, fixed_param_values, label=None):
        """The mixture conditioned on fixing some parameters to given values.

        Per component the conditional covariance is the inverse of the kept
        block of the precision matrix, the mean shifts by the cross-precision
        term, and the component weight is rescaled by the likelihood of the
        fixed values under the component's marginal (Schur complement).
        """
        fixed = self._indices_for(fixed_params)
        self.checkNoLimits(fixed)
        kept = [i for i in range(self.dim) if i not in fixed]
        if not kept:
            raise ValueError("conditionalMixture must leave at least one non-fixed parameter")
        new_means, new_covs, chisqs = [], [], []
        for g in self._components:
            shift = np.asarray(fixed_param_values) - g.mean[fixed]
            prec_kk = g.icov[np.ix_(kept, kept)]
            cov_c = np.linalg.inv(prec_kk)
            new_covs.append(cov_c)
            new_means.append(g.mean[kept] - cov_c @ (g.icov[np.ix_(kept, fixed)] @ shift))
            # -2 log of the fixed-value marginal likelihood, up to a constant
            marg_cov = g.cov[np.ix_(fixed, fixed)] - g.cov[np.ix_(fixed, kept)] @ (
                np.linalg.inv(g.cov[np.ix_(kept, kept)]) @ g.cov[np.ix_(kept, fixed)]
            )
            chisqs.append(shift @ (g.icov[np.ix_(fixed, fixed)] @ shift) + np.log(np.linalg.det(marg_cov)))
        chisqs = np.asarray(chisqs)
        out = MixtureND(
            new_means,
            new_covs,
            np.exp(-0.5 * (chisqs - chisqs.min())),
            names=None if self.names is None else [self.names[i] for i in kept],
            label=label,
        )
        out.paramNames.setLabelsAndDerivedFromParamNames(self.paramNames)
        return out

    # -- sampling ---------------------------------------------------------------

    def _within_bounds(self, pts):
        if self.lims is None:
            return pts
        for axis, (lo, hi) in enumerate(self.lims):
            if lo is not None:
                pts = pts[pts[:, axis] >= lo]
            if hi is not None:
                pts = pts[pts[:, axis] <= hi]
        return pts

    def sim(self, size, random_state=None):
        """``size`` independent draws; rejection sampling under hard bounds.

        RNG call order is a fixture-reproducibility contract (see module
        docstring); cf. reference ``gaussian_mixtures.py:53-86``.
        """
        rng = np.random.default_rng(random_state)
        blocks = []
        kept = 0
        ask = size
        retry_size_set = False
        while True:
            split = rng.multinomial(ask, self.weights)
            for n, g in zip(split, self._components):
                if n > 0:
                    batch = self._within_bounds(rng.multivariate_normal(g.mean, g.cov, size=n))
                    kept += batch.shape[0]
                    blocks.append(batch)
            if kept >= size:
                break
            if not retry_size_set:
                # one generous top-up block sized from the observed accept rate
                ask = min(max(size, _BIG_DRAW), int(1.1 * (size * (size - kept))) // max(kept, 1) + 1)
                retry_size_set = True
        draws = np.vstack(blocks)
        if len(blocks) > 1:
            draws = rng.permutation(draws)
        if kept != size:
            draws = draws[: -(kept - size), :]
        return draws

    def MCSamples(self, size, names=None, logLikes=False, random_state=None, device="cuda", **kwargs):
        """Draw ``size`` samples (numpy's generator from ``random_state``, as
        the JAX package draws them) and wrap them as
        :class:`~.mcsamples.MCSamples` on ``device``, the card unless the
        caller names the CPU (optionally with -log(pdf) values)."""
        pts = self.sim(size, random_state=random_state)
        return MCSamples(
            samples=pts,
            loglikes=-np.log(self.pdf(pts)) if logLikes else None,
            paramNamesFile=copy.deepcopy(self.paramNames),
            names=names,
            ranges=self.lims,
            device=device,
            **kwargs,
        )


class GaussianND(MixtureND):
    """A single ND Gaussian; mean/cov may be filenames of text arrays, and
    the matrix may be given as an inverse covariance."""

    def __init__(self, mean, cov, is_inv_cov=False, **kwargs):
        def load(v):
            return np.loadtxt(v) if isinstance(v, str) else v

        mean, cov = load(mean), load(cov)
        if is_inv_cov:
            cov = np.linalg.inv(cov)
        super().__init__([mean], [cov], **kwargs)


class RandomTestMixtureND(MixtureND):
    """Mixture with randomly-generated component parameters, for tests.

    RNG order (covariances first, then all means) is part of the seeded
    fixture contract.
    """

    def __init__(self, ndim=4, ncomponent=1, names=None, weights=None, seed=None, label="RandomMixture"):
        rng = np.random.default_rng(seed)
        covs = []
        for _ in range(ncomponent):
            root = rng.random((ndim, ndim))
            covs.append(root @ root.T)
        means = rng.random((ncomponent, ndim))
        spec = dict(weights=weights, lims=None, names=names, label=label)
        super().__init__(means, covs, **spec)


def _cov_from_spec(spec):
    """Accept a full 2x2 matrix or a (sigma_x, sigma_y, corr) triplet."""
    if np.ndim(spec) == 1 and len(spec) == 3:
        return make_2D_Cov(*spec)
    return spec


class Mixture2D(MixtureND):
    """Two-parameter mixture; covariances may be (sx, sy, corr) triplets and
    bounds may be passed as xmin/xmax/ymin/ymax keywords."""

    def __init__(
        self,
        means,
        covs,
        weights=None,
        lims=None,
        names=("x", "y"),
        xmin=None,
        xmax=None,
        ymin=None,
        ymax=None,
        **kwargs,
    ):
        base = lims if lims is not None else [(None, None), (None, None)]
        merged = _override_box(base, xmin, xmax, ymin, ymax)
        super().__init__(means, [_cov_from_spec(c) for c in covs], weights, merged, names=names, **kwargs)

    def _density2D(self, num_points=1024, xmin=None, xmax=None, ymin=None, ymax=None, sigma_max=5):
        box = _override_box(self.lims, xmin, xmax, ymin, ymax)
        (x0, x1), (y0, y1) = self.autoRanges(sigma_max, lims=box)
        xg = np.linspace(x0, x1, num_points)
        yg = np.linspace(y0, y1, num_points)
        mx, my = np.meshgrid(xg, yg)
        return Density2D(xg, yg, self.pdf(mx, my))

    def pdf(self, x, y=None):
        """Density at (x, y); with y omitted, the analytic x-marginal."""
        if y is None:
            return super().pdf(x)
        out = 0.0
        for w, g in zip(self.weights, self._components):
            u, v = x - g.mean[0], y - g.mean[1]
            quad = u * u * g.icov[0, 0] + 2 * u * v * g.icov[0, 1] + v * v * g.icov[1, 1]
            out = out + w * np.exp(-0.5 * quad) / g.norm
        return out


def _override_box(base, xmin, xmax, ymin, ymax):
    """2D bounds with per-edge keyword overrides applied."""
    (x0, x1), (y0, y1) = base
    return [
        (x0 if xmin is None else xmin, x1 if xmax is None else xmax),
        (y0 if ymin is None else ymin, y1 if ymax is None else ymax),
    ]


class Gaussian2D(Mixture2D):
    """A single 2D Gaussian."""

    def __init__(self, mean, cov, **kwargs):
        super().__init__([mean], [cov], **kwargs)


class Mixture1D(MixtureND):
    """One-parameter mixture specified by means and sigmas."""

    def __init__(self, means, sigmas, weights=None, lims=None, name="x", xmin=None, xmax=None, **kwargs):
        lo, hi = lims if lims is not None else (None, None)
        bound = [(lo if xmin is None else xmin, hi if xmax is None else xmax)]
        col_means = np.reshape(means, (-1, 1))
        var_mats = [np.array([[s * s]], dtype=np.float64) for s in sigmas]
        super().__init__(col_means, var_mats, weights, bound, names=[name], **kwargs)

    def pdf(self, x):
        return self.pdf_marged(0, x, no_limit_marge=True)


class Gaussian1D(Mixture1D):
    """A single 1D Gaussian."""

    def __init__(self, mean, sigma, **kwargs):
        super().__init__([mean], [sigma], **kwargs)


def randomTestMCSamples(ndim=4, ncomponent=1, nsamp=10009, nMCSamples=1, seed=10, names=None, labels=None,
                        device="cuda"):
    """One or more MCSamples sets drawn from random test mixtures, on ``device``."""
    names = names or ["x%s" % i for i in range(ndim)]
    labels = labels or ["x_{%s}" % i for i in range(ndim)]
    gen = np.random.default_rng(seed)
    made = []
    for i in range(nMCSamples):
        mixture = RandomTestMixtureND(ndim, ncomponent, names, seed=gen)
        made.append(mixture.MCSamples(nsamp, labels=labels, name_tag="Sim %s" % (i + 1), random_state=gen,
                                      device=device))
    return made if nMCSamples > 1 else made[0]
