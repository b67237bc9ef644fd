"""Probability density grids: containers, credible intervals, contour levels.

The port's own copy of ``getdist_tpu/densities.py`` (1D, 2D and N-D
grids).

Host-facing layer consuming device-computed KDE grids (the plotting API
surface; behavioral spec: reference ``getdist/densities.py:19-381``). Grids
are small (1024 / 256^2), so interpolation and limit-finding run host-side
on numpy / scipy splines; the batched device path has its own contour-level
bisection in ``getdist_tpu_torch.ops.batched``.

Semantics match the reference: water-level contour levels by sort + cumsum
with half-weighted edge bins, spline-upsampled equal-density credible
intervals, and trapezoid-ish integrators with 2^-codimension edge weights.
"""


import numpy as np
from scipy.interpolate import RectBivariateSpline, RegularGridInterpolator, splev, splrep

__all__ = ["Density1D", "Density2D", "DensityND", "GridDensity", "getContourLevels", "DensitiesError"]

defaultContours = (0.68, 0.95)


class DensitiesError(Exception):
    pass


def _halve_edges(bins):
    """Copy of a bins array with every boundary slab halved per axis."""
    out = np.array(bins)
    for axis in range(out.ndim):
        edge = [slice(None)] * out.ndim
        for end in (0, -1):
            edge[axis] = end
            out[tuple(edge)] /= 2
    return out


def getContourLevels(inbins, contours=defaultContours, missing_norm=0, half_edge=True):
    """Density levels enclosing the given probability fractions.

    Water-level method: sort the bin values, accumulate, and interpolate
    where the cumulative mass outside crosses (1 - contour) * norm. Edge
    bins count half per boundary dimension when half_edge is set.

    :param inbins: binned density (any dimension)
    :param contours: confidence fractions to solve for
    :param missing_norm: probability mass not inside inbins
    :param half_edge: half-weight edge bins in each direction
    :return: array of density levels
    """
    weighted = _halve_edges(inbins) if half_edge else np.asarray(inbins)
    targets = (1 - np.asarray(contours)) * np.sum(weighted) - missing_norm
    # rank by the RAW density values; accumulate the edge-weighted mass
    order = np.asarray(inbins).reshape(-1).argsort()
    ranked = weighted.reshape(-1)[order]
    cdf = np.cumsum(ranked)
    cuts = np.searchsorted(cdf, targets)
    if np.any(cuts == 0):
        raise DensitiesError("a contour level falls outside the plotted range")
    overshoot = (cdf[cuts] - targets) / (cdf[cuts] - cdf[cuts - 1])
    return ranked[cuts] * (1 - overshoot) + overshoot * ranked[cuts - 1]


class _LimitGrid:
    """Spline-upsampled view of a Density1D used to solve credible limits:
    fine-grid values, their sorted order, and the cumulative mass."""

    __slots__ = ("upsample", "size", "step", "values", "mass", "ranked", "cdf")

    def __init__(self, density, upsample=None):
        self.upsample = upsample if upsample is not None else max(2, 20000 // density.n)
        self.size = (density.n - 1) * self.upsample + 1
        self.step = density.spacing / self.upsample
        fine_x = density.x[0] + np.arange(self.size) * self.step
        self.values = splev(fine_x, density.spl)
        self.mass = np.sum(self.values) - 0.5 * density.P[-1] - 0.5 * density.P[0]
        self.ranked = np.sort(self.values)
        self.cdf = np.cumsum(self.ranked)

    def water_level(self, target):
        """Density value whose superlevel set holds the target mass."""
        cut = np.searchsorted(self.cdf, target)
        level = self.ranked[cut]
        if cut > 0:
            gap = self.cdf[cut] - self.cdf[cut - 1]
            frac = (self.cdf[cut] - target) / gap
            level = (1 - frac) * level + frac * self.ranked[cut + 1]
        return level


# reference-compatible alias for the limit-grid cache object
InterpGridCache = _LimitGrid


class GridDensity:
    """Base for density grids (normalized or not).

    :ivar P: array of density values
    """

    # subclasses set: view_ranges (per-axis view windows), axes (grids in
    # z, y, x order), and norm
    def setP(self, P=None):
        """Set grid values (validates shape against the axes)."""
        if P is None:
            shape = tuple(ax.size for ax in self.axes)
            self.P = np.zeros(shape)
        else:
            P = np.asarray(P)
            for ax, size in zip(self.axes, P.shape):
                if size != ax.size:
                    message = f"Array size mismatch in Density arrays: P {size}, axis {ax.size}"
                    raise DensitiesError(message)
            self.P = P
        self.spl = None

    def norm_integral(self):
        return self.integrate(self.P)

    def _spline(self):
        if self.spl is None:
            self._initSpline()
        return self.spl

    def normalize(self, by="integral", in_place=False):
        """Normalize by 'integral' (unit mass) or 'max' (peak = 1)."""
        if by == "integral":
            scale = self.norm_integral()
        elif by == "max":
            scale = np.max(self.P)
            if scale == 0:
                raise DensitiesError("empty density: no samples landed in any bin")
        else:
            raise DensitiesError(f"unknown normalization kind: {by}")
        if in_place:
            self.P /= scale
        else:
            self.setP(self.P / scale)
        self.spl = None
        return self

    def bounds(self):
        """(min, max) per axis in x, y, z order."""
        if self.view_ranges is None:
            return [(ax[0], ax[-1]) for ax in reversed(self.axes)]
        return self.view_ranges

    def getContourLevels(self, contours=defaultContours):
        """Contour levels for the given confidence fractions."""
        return getContourLevels(self.P, contours)


class Density1D(GridDensity):
    """1D marginalized density on a uniform grid; callable for interpolated
    values, with equal-density credible-interval solving."""

    ndim = 1

    def __init__(self, x, P=None, view_ranges=None):
        """
        :param x: grid of x values
        :param P: density values at x
        :param view_ranges: optional viewing range
        """
        self.x = np.asarray(x)
        self.view_ranges = view_ranges
        self.n = self.x.size
        self.spacing = self.x[1] - self.x[0]
        self.axes = [self.x]
        self.setP(P)

    def bounds(self):
        """(min, max) of the x range (or view_ranges)."""
        if self.view_ranges is None:
            return self.x[0], self.x[-1]
        return self.view_ranges

    def _initSpline(self):
        knots = splrep(self.x, self.P, s=0)
        self.spl = knots

    def integrate(self, P):
        ends = 0.5 * (P[0] + P[-1])
        return self.spacing * (ends + np.sum(P[1:-1]))

    def Prob(self, x, derivative=0):
        """Interpolated density (or derivative) at x."""
        scalar = not isinstance(x, (np.ndarray, list, tuple))
        values = splev([x] if scalar else x, self._spline(), derivative, ext=1)
        return values[0] if scalar else values

    __call__ = Prob

    def initLimitGrids(self, factor=None):
        """Build the up-sampled spline grid cache used by getLimits."""
        self._spline()
        return _LimitGrid(self, factor)

    def _interval_at(self, cache, level):
        """(min, max, hit_lower_edge, hit_upper_edge) where the fine grid
        crosses the water level, linearly interpolated between fine bins."""
        values = cache.values
        at_bottom = values[0] >= level
        if at_bottom:
            lo = self.x[0]
        else:
            i = np.argmax(values > level)
            excess = (values[i] - level) / (values[i] - values[i - 1])
            lo = self.x[0] + (i - excess) * cache.step
        at_top = values[-1] >= level
        if at_top:
            hi = self.x[-1]
        else:
            i = cache.size - np.argmax(values[::-1] > level) - 1
            excess = (values[i] - level) / (values[i] - values[i + 1])
            hi = self.x[0] + (i + excess) * cache.step
        return lo, hi, at_bottom, at_top

    def getLimits(self, p, interpGrid=None, accuracy_factor=None):
        """Equal-density credible interval(s).

        :param p: confidence fraction or list of them
        :param interpGrid: optional cache from initLimitGrids
        :param accuracy_factor: up-sampling factor override
        :return: (min, max, lim_bot, lim_top) where the booleans mark limits
            that hit the grid edge (one-tail cases); list when p is a list
        """
        cache = interpGrid or self.initLimitGrids(accuracy_factor)
        fractions = np.atleast_1d(p)
        intervals = [self._interval_at(cache, cache.water_level((1 - frac) * cache.mass)) for frac in fractions]
        return intervals[0] if fractions is not p else intervals


class Density2D(GridDensity):
    """2D marginalized density on a rectangular grid; callable like a
    RectBivariateSpline."""

    ndim = 2

    def __init__(self, x, y, P=None, view_ranges=None, mask=None):
        """
        :param x: x grid
        :param y: y grid
        :param P: (ny, nx) density values
        :param view_ranges: optional [(xmin,xmax),(ymin,ymax)]
        :param mask: optional boolean mask for non-rectangular priors
        """
        self.x, self.y = np.asarray(x), np.asarray(y)
        self.view_ranges = view_ranges
        self.mask = mask
        cell = (self.x[1] - self.x[0]) * (self.y[1] - self.y[0])
        self.spacing = cell
        self.axes = [self.y, self.x]
        self.setP(P)

    def integrate(self, P):
        # interior cells count fully, edge lines half, corners a quarter
        corner_sum = P[0, 0] + P[-1, -1] + P[-1, 0] + P[0, -1]
        sides = ((slice(1, -1), 0), (0, slice(1, -1)), (slice(1, -1), -1), (-1, slice(1, -1)))
        edge_sum = sum(np.sum(P[side]) for side in sides)
        total = np.sum(P[1:-1, 1:-1]) + 0.25 * corner_sum + 0.5 * edge_sum
        return total * self.spacing

    def _initSpline(self):
        surface = RectBivariateSpline(self.x, self.y, self.P.T, s=0)
        self.spl = surface

    def __call__(self, *args, **kwargs):
        return self._spline()(*args, **kwargs)

    def Prob(self, x, y, grid=False):
        """Interpolated density at (x, y)."""
        return self(x, y, grid=grid)


class DensityND(GridDensity):
    """N-D marginalized density with linear interpolation."""

    def __init__(self, xs, P=None, view_ranges=None):
        """
        :param xs: list of per-dimension grids
        :param P: N-D density values (the last grid's axis leading)
        :param view_ranges: optional per-dimension view ranges
        """
        self.view_ranges = view_ranges
        self.dim = len(xs)
        self.xs = xs
        for name, ax in zip(("x", "y", "z"), xs):
            setattr(self, name, ax)
        steps = [ax[1] - ax[0] for ax in xs]
        self.spacing = float(np.prod(steps))
        self.axes = list(reversed(xs))
        self.setP(P)

    def integrate(self, P):
        # a cell on c boundary hyperplanes (codimension c) carries weight 2^-c
        weights = np.ones(P.shape)
        for axis in range(P.ndim):
            shape = [1] * P.ndim
            shape[axis] = P.shape[axis]
            per_axis = np.ones(P.shape[axis])
            per_axis[0] = per_axis[-1] = 0.5
            weights = weights * per_axis.reshape(shape)
        return np.sum(P * weights)

    def _initSpline(self):
        # linear on the grid (the JAX package's LinearNDInterpolator over the
        # axis grids, not the grid points, raises: ROADMAP C16)
        self.spl = RegularGridInterpolator(self.xs, self.P.T)

    def Prob(self, xs):
        """Interpolated density at the points xs, an (m, dim) array (x
        first)."""
        return self._spline()(xs)

    __call__ = Prob
