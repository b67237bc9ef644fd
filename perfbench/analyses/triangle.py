"""The triangle analysis: ``MCSamples.fastTriangleDensities`` on one chain of
a pool, as a plotter or GUI session asks for it, and its check against
the plain reference (:mod:`perfbench.reference.entry`).

An analysis is every 1D density and every pair's 2D density with its
contour levels (and, with ``meanlikes``, the mean-likelihood curves and
grids) of all of the chain's parameters. The client moves through the
pool in turn.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.entry import Settings, TriangleReference, bound_axes

# served routes: a pair not rerun is served by the first program at 256 bins and a 30-bin window
DEFAULT_ROUTE = (256, 30, "program")


def _route_map(groups):
    """{pair: (fine, winw, kind)} of the pairs a run's rerun groups serve
    (the last rerun of a pair serves it)."""
    routes = {}
    for group in groups:
        for pair in group["pairs"]:
            routes[tuple(pair)] = (int(group["fine"]), int(group["winw"]), group["bandwidths"])
    return routes


def _enclosed(grids, levels):
    """(K, C): the share of each (K, n, n) grid's mass strictly above each of
    its levels, taken linearly between the grid's sorted cell values, so it
    moves smoothly with the level (a level that lands on a cell's value
    would otherwise count or drop that whole cell)."""
    vals = torch.sort(grids.reshape(grids.shape[0], -1).to(torch.float64), dim=1).values
    above = torch.flip(torch.cumsum(torch.flip(vals, (1,)), 1), (1,)) - vals
    lv = levels.to(torch.float64)
    i = torch.searchsorted(vals, lv, right=True).clamp(1, vals.shape[1] - 1)
    x0, x1 = vals.gather(1, i - 1), vals.gather(1, i)
    y0, y1 = above.gather(1, i - 1), above.gather(1, i)
    frac = torch.where(x1 > x0, ((lv - x0) / torch.where(x1 > x0, x1 - x0, 1.0)).clamp(0, 1), 0.0)
    return (y0 + frac * (y1 - y0)) / (above[:, :1] + vals[:, :1])


def _max_abs(a, b):
    return float(torch.max(torch.abs(a.to(torch.float64) - b.to(torch.float64))).item()) if a.numel() else 0.0


class Analysis:
    """One client's triangle analyses over ``chains`` (host
    :class:`~perfbench.reference.entry.Chain`\\ s) on ``device``."""

    def __init__(self, config, traffic, chains, device, seed):
        self.config, self.traffic, self.chains = config, traffic, chains
        self.device = torch.device(device)
        self.settings = dict(config["settings"])
        self.meanlikes = bool(traffic.get("meanlikes", False))
        self.contours = tuple(float(c) for c in traffic["contours"])
        self.mcs = []
        self._axes = {}

    def setup(self, mark=lambda stage: None):
        """Build an ``MCSamples`` per chain and warm each with one analysis
        (the first builds the kernels; each fills its object's chain caches:
        the uploaded chain and the cumulant score). ``mark(stage)`` is
        called as each stage ends."""
        from getdist_tpu_torch.mcsamples import MCSamples

        mark("program import")
        for chain in self.chains:
            self.mcs.append(MCSamples(samples=chain.samples, weights=chain.weights, loglikes=chain.loglikes,
                                      names=chain.names, ranges=chain.ranges, settings=self.settings,
                                      device=self.device))
        mark("objects")
        for i in range(len(self.chains)):
            self.run(i)
            mark(f"warm {i}")

    def release(self):
        """Free the program's state (its objects and their device caches)."""
        self.mcs = []

    def run(self, i):
        """Analysis ``i`` (not synchronized): its outputs and route record."""
        c = i % len(self.chains)
        mc = self.mcs[c]
        d1, d2, pairs = mc.fastTriangleDensities(contours=self.contours, meanlikes=self.meanlikes)
        idx = list(range(len(self.chains[c].names)))
        return {"chain": c, "idx": idx, "out": (d1, d2, pairs), "groups": list(mc.fast_regrid_groups)}

    # -- what the per-layer metrics read ---------------------------------------------------------

    def info(self, result):
        """The analysis as the work counting reads it: sample count, parameter
        flags, pairs and the grid and window that serve each pair. A
        parameter is ``limited`` where its hard limit binds, by the
        reference's rule (worked out once a chain, after the window)."""
        c = result["chain"]
        chain = self.chains[c]
        if c not in self._axes:
            self._axes[c] = bound_axes(chain, self.device)
        bound, periodic = self._axes[c]
        flags = [{"limited": bool(bound[j] and not periodic[j]), "periodic": bool(periodic[j])} for j in result["idx"]]
        routes = _route_map(result["groups"])
        pairs = result["out"][2]
        return {
            "samples": int(chain.samples.shape[0]),
            "integer_weights": bool(np.all(chain.weights == np.round(chain.weights))
                                    and chain.weights.max() <= 255 and chain.weights.min() >= 0),
            "meanlikes": self.meanlikes and chain.loglikes is not None,
            "params": flags,
            "pairs": [(a, b) + routes.get((a, b), DEFAULT_ROUTE)[:2] for a, b in pairs],
            "reruns": len(result["groups"]),
        }

    # -- the check --------------------------------------------------------------------------------

    def served(self, result):
        """The served answers on the host: the 1D densities (and likes), and
        per pair its grid, contour levels (and like grid)."""
        d1, d2, pairs = result["out"]
        regrid = d2.get("regrid", {})
        one = {"P": d1["P"].detach().cpu()}
        if self.meanlikes and d1.get("likes") is not None:
            one["likes"] = d1["likes"].detach().cpu()
        two = {}
        for k, key in enumerate(pairs):
            entry = regrid.get(key)
            src = entry if entry is not None else {name: d2[name][k] for name in ("P", "contours", "likes")
                                                   if d2.get(name) is not None}
            two[tuple(key)] = {name: src[name].detach().cpu() for name in ("P", "contours", "likes") if name in src}
        return {"chain": result["chain"], "idx": result["idx"], "groups": result["groups"], "one": one, "two": two}

    def reference(self, served):
        """The reference's analysis of the same chain and parameters, served
        the same way, and the routes it left to the host."""
        chain = self.chains[served["chain"]]
        st = Settings(max_corr_2D=float(self.settings["max_corr_2D"]),
                      smooth_scale_1D=float(self.settings["smooth_scale_1D"]),
                      smooth_scale_2D=float(self.settings["smooth_scale_2D"]))
        ref = TriangleReference(chain, self.device, st)
        d1, d2, pairs = ref.run(served["idx"], contours=self.contours, meanlikes=self.meanlikes)
        out = self.served({"chain": served["chain"], "idx": served["idx"], "out": (d1, d2, pairs), "groups": []})
        out["groups"] = ref.regrid_groups
        out["uncovered"] = dict(ref.uncovered)
        del ref, d1, d2
        return out

    def compare(self, got, want):
        """The numbers compared, each the widest gap between the program's
        served answers and the reference's, over the 1D curves and the pairs'
        grids (all peak-normalized): ``density_gap``, the densities' gap in
        units of their peak; ``contour_gap``, the gap between the shares of
        the reference grid's mass above the program's contour level and
        above its own (a level moves by a whole step between two cells'
        values where the mass it encloses hardly moves); ``like_gap``, the
        mean-likelihood gap times the reference density (the like grids are
        cut to 0 below 1e-4 of the density's peak, where a cell on either
        side of that floor would otherwise read as a whole like value). A
        pair that the program serves by another route than the reference
        (another grid, window or rescue) reads 1, the whole scale, where its
        grids differ in shape. Answers that the reference leaves to the
        host (``uncovered``) are compared by route only: the program has to
        have run that rescue on them. Returns (numbers, notes)."""
        dev = self.device
        uncovered = want["uncovered"]
        keep = torch.tensor([i not in uncovered for i in range(got["one"]["P"].shape[0])])
        ref1 = want["one"]["P"][keep].to(dev)
        density = _max_abs(got["one"]["P"][keep].to(dev), ref1)
        like = 0.0
        if self.meanlikes:
            like = _max_abs(got["one"]["likes"][keep].to(dev) * ref1, want["one"]["likes"][keep].to(dev) * ref1)
        contour = 0.0
        got_routes, want_routes = _route_map(got["groups"]), _route_map(want["groups"])
        got_kinds = {}
        for group in got["groups"]:
            for pair in group["pairs"]:
                got_kinds.setdefault(tuple(pair), set()).add(group["bandwidths"])
        mismatched, by_shape = [], {}
        for key, entry in got["two"].items():
            route = got_routes.get(key, DEFAULT_ROUTE)
            if key in uncovered:
                # the host rescue must have served the pair, whether or not
                # its kernel then saturated the window and took the clamped rescue
                if uncovered[key] not in got_kinds.get(key, ()):
                    mismatched.append(key)
                    density = 1.0
                continue
            ref = want["two"][key]
            if route != want_routes.get(key, DEFAULT_ROUTE):
                mismatched.append(key)
                if entry["P"].shape != ref["P"].shape:
                    density = contour = like = 1.0
                    continue
            by_shape.setdefault(tuple(entry["P"].shape), []).append((entry, ref))
        for pairs in by_shape.values():
            def stack(side, name):
                return torch.stack([p[side][name] for p in pairs]).to(dev)

            ref2 = stack(1, "P")
            density = max(density, _max_abs(stack(0, "P"), ref2))
            levels = torch.cat([stack(0, "contours"), stack(1, "contours")], dim=1)
            shares = _enclosed(ref2, levels)
            half = levels.shape[1] // 2
            contour = max(contour, _max_abs(shares[:, :half], shares[:, half:]))
            if self.meanlikes:
                like = max(like, _max_abs(stack(0, "likes") * ref2, stack(1, "likes") * ref2))
        nums = {"density_gap": density, "contour_gap": contour}
        if self.meanlikes:
            nums["like_gap"] = like
        notes = {"uncovered": {str(k): v for k, v in uncovered.items()},
                 "route_mismatches": [list(k) for k in mismatched]}
        return nums, notes
