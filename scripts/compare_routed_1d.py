#!/usr/bin/env python
"""Routed (fused-path) 1D densities against the host path's, in the port and
in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_routed_1d.py [--rows 1000000]

Makes ``chip_smoke.bounded_chain(rows)`` from its seed and keeps six of its
columns: two lower-limited (half-normal, peaked at the limit), one
upper-limited, one two-sided, one periodic and one free, with loglikes.
For each package it prints, per parameter, the largest difference of the
peak-normalized routed density (``fastDensities``, the fused path's
conventions) from the host path's (``get1DDensityGridData`` with the route
off) on 300 points of their common range, and where it lies; then the
largest difference of the port's routed densities from the JAX package's.
The port runs with ``device="cpu"`` (the kernels' plain versions), the JAX
package with x64 off.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COLUMNS = (0, 1, 4, 6, 8, 12)


def max_diff(got, want):
    """(largest difference of the peak-normalized densities, its x)."""
    grid = np.linspace(max(got.x[0], want.x[0]), min(got.x[-1], want.x[-1]), 300)
    diff = np.abs(got.Prob(grid) / got.P.max() - want.Prob(grid) / want.P.max())
    return float(diff.max()), float(grid[diff.argmax()])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=1_000_000)
    args = parser.parse_args()
    os.environ["GETDIST_TPU_FUSED"] = "0"
    import jax

    from chip_smoke import bounded_chain
    from getdist_tpu.mcsamples import MCSamples as JaxMCSamples
    from getdist_tpu_torch.mcsamples import MCSamples

    s, w, ll, names, ranges = bounded_chain(args.rows)
    picked = [names[c] for c in COLUMNS]
    kw = dict(samples=s[:, COLUMNS].copy(), weights=w, loglikes=ll, names=picked,
              ranges={n: ranges[n] for n in picked if n in ranges})
    print(f"bounded chain {args.rows:,} rows, columns {picked}, ranges {kw['ranges']}")
    port_routed, _ = MCSamples(device="cpu", **kw).fastDensities()
    port_host = MCSamples(device="cpu", **kw)
    with jax.enable_x64(False):
        jax_routed, _ = JaxMCSamples(**kw).fastDensities()
        jax_host = JaxMCSamples(**kw)
        for name in picked:
            port = max_diff(port_routed[name], port_host.get1DDensityGridData(name))
            ref = max_diff(jax_routed[name], jax_host.get1DDensityGridData(name))
            print(f"{name} {kw['ranges'].get(name, 'free')}: routed against host, port {port[0]:.6g} at x = "
                  f"{port[1]:.6g}, JAX package {ref[0]:.6g} at x = {ref[1]:.6g}; port routed against JAX routed "
                  f"{max_diff(port_routed[name], jax_routed[name])[0]:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
