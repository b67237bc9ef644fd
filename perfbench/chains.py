"""The benchmark's chains, made on the device from a seed.

One model serves every configuration (``perfbench/configs/<name>.json``,
key ``chain``): a Planck-like AR(1) walk (``x_t = rho x_{t-1} + sqrt(1 -
rho^2) L e_t``, ``x_0 = L e_0``) over a random covariance ``A A^T``, ``A =
cov_scale * G + I`` with a standard normal G, and integer weights drawn
uniformly from ``weights`` (inclusive). A configuration gives either
``params`` (that many columns named ``<prefix><i>``, the walk as it is, no
hard priors) or ``columns``: one entry for each column, ``{"name", "mean",
"sd"}`` and optionally ``"range": [lo, hi]`` (None for an open end) and
``"periodic": true``. A listed column is ``mean + sd * z`` from its
standardized walk z, folded into its range as a posterior cut by a hard
prior (reflected at each finite end; wrapped for a periodic column). With
``loglikes``, -log L = z.z / 2 over all columns.

Everything is drawn by one ``torch.Generator`` on the device, in a few
large calls; the AR(1) recursion runs as a parallel prefix scan (log2 N
passes over the chain), not a loop over samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.entry import Chain

def chain_seed(seed, i):
    """The seed of chain ``i`` of a run's pool: 63 bits of a SeedSequence of
    (seed, i), so runs with neighbouring seeds share no chain."""
    return int(np.random.SeedSequence([int(seed) % 2**64, int(i)]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _ar1_scan(b, rho):
    """x_t = rho x_{t-1} + b_t (x_0 = b_0) along dim 0, by doubling: after
    pass j each row holds the sum over its last 2^(j+1) terms."""
    x = b
    shift, factor = 1, rho
    n = b.shape[0]
    while shift < n and factor > 0.0:
        x = torch.cat([x[:shift], x[shift:] + factor * x[:-shift]])
        shift *= 2
        factor *= factor
    return x


def _fold(v, lo, hi, periodic):
    """``v`` folded into [lo, hi] (None for an open end): reflected at each
    finite end, or wrapped into [lo, hi) where ``periodic``."""
    if periodic:
        return lo + torch.remainder(v - lo, hi - lo)
    if lo is not None and hi is not None:
        span = hi - lo
        y = torch.remainder(v - lo, 2 * span)
        return lo + torch.where(y > span, 2 * span - y, y)
    if lo is not None:
        return lo + (v - lo).abs()
    if hi is not None:
        return hi - (v - hi).abs()
    return v


def make_chain(config, seed, device):
    """The configuration's chain for ``seed`` on ``device``: a
    :class:`~perfbench.reference.entry.Chain` of host arrays (the samples
    are copied back once, for ``MCSamples`` and the reference)."""
    spec = config["chain"]
    columns = spec.get("columns")
    n = int(spec["samples"])
    p = len(columns) if columns else int(spec["params"])
    rho = float(spec["rho"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    a = torch.randn((p, p), generator=gen, **f64) * float(spec["cov_scale"]) + torch.eye(p, **f64)
    root = torch.linalg.cholesky(a @ a.T)
    steps = torch.randn((n, p), generator=gen, **f64) @ root.T
    steps[1:] *= math.sqrt(1 - rho**2)
    x = _ar1_scan(steps, rho)
    del steps
    w_lo, w_hi = spec["weights"]
    weights = torch.randint(int(w_lo), int(w_hi) + 1, (n,), generator=gen, device=device).to(torch.float64)
    ranges = {}
    loglikes = None
    if columns:
        names = [c["name"] for c in columns]
    else:
        names = [f"{spec.get('prefix', 'p')}{i}" for i in range(p)]
    if columns or spec.get("loglikes"):
        z = (x - x.mean(0)) / x.std(0, correction=0)
        for j, c in enumerate(columns or []):
            lo, hi = c.get("range", [None, None])
            periodic = bool(c.get("periodic", False))
            x[:, j] = _fold(float(c["mean"]) + float(c["sd"]) * z[:, j], lo, hi, periodic)
            if lo is not None or hi is not None:
                ranges[names[j]] = [lo, hi, True] if periodic else [lo, hi]
        if spec.get("loglikes"):
            loglikes = (0.5 * torch.sum(z * z, dim=1)).cpu().numpy()
        del z
    return Chain(samples=x.cpu().numpy(), weights=weights.cpu().numpy(), loglikes=loglikes, names=names,
                 ranges=ranges)
