#!/usr/bin/env python
"""Routed (fused-path) 2D densities against the host path's, in the port
and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_routed_2d.py [--rows 100000] [--columns 12] [--likes]

Makes ``chip_smoke.bounded_chain(rows, p=columns)`` from its seed (four
lower-limited, two upper-limited, two two-sided and two periodic columns,
the rest free, loglikes) and, for a two-sided x two-sided, a periodic x
periodic, a lower x upper, a free x free, two two-sided x free and a
periodic x free pair (the last two-sided x free one with 15 columns or
more; at 30 columns the fused run reruns it), prints the largest difference of the peak-normalized
routed density (``get2DDensityGridData`` with the route on, served by one
fused run) from the host path's (the route off), in the port and in the
JAX package, on 80^2 points where the host density is above 0.05 of its
peak (``chip_smoke.routed_2d_diff``); then the port's routed densities
against the JAX package's, and the two host paths against each other.
With ``--likes`` the same for the mean-likelihood grids
(``meanlikes=True``) where the host density is above 0.05 of its peak.
The port runs with ``device="cpu"`` (the kernels' plain versions), the JAX
package with x64 off.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAIRS = (("b6", "b7"), ("b8", "b9"), ("b1", "b5"), ("b10", "b11"), ("b6", "b10"), ("b8", "b10"), ("b6", "b14"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=100_000)
    parser.add_argument("--columns", type=int, default=12)
    parser.add_argument("--likes", action="store_true", help="compare the mean-likelihood grids")
    args = parser.parse_args()

    import jax

    import chip_smoke as cs
    from getdist_tpu import chains as jchains
    from getdist_tpu import mcsamples as jmc
    from getdist_tpu_torch import chains as tchains
    from getdist_tpu_torch import mcsamples as tmc

    jchains.print_load_details = tchains.print_load_details = False
    samples, weights, loglikes, names, ranges = cs.bounded_chain(args.rows, p=args.columns)
    pairs = [pair for pair in PAIRS if max(int(name[1:]) for name in pair) < args.columns]
    chain = dict(samples=samples, weights=weights, loglikes=loglikes, names=names, ranges=ranges)

    def densities(route):
        os.environ["GETDIST_TPU_TORCH_FUSED"] = os.environ["GETDIST_TPU_FUSED"] = route
        t0 = time.perf_counter()
        port = tmc.MCSamples(device="cpu", **chain)
        got = {pair: port.get2DDensityGridData(*pair, num_plot_contours=2, meanlikes=args.likes) for pair in pairs}
        with jax.enable_x64(False):
            jax_mc = jmc.MCSamples(**chain)
            want = {pair: jax_mc.get2DDensityGridData(*pair, num_plot_contours=2, meanlikes=args.likes)
                    for pair in pairs}
        reran = {(names[a], names[b]) for group in port.fast_regrid_groups for a, b in group["pairs"]}
        reran = sorted(reran & set(pairs))
        print(f"route {route}: {time.perf_counter() - t0:.1f} s; pairs the port's fused run reran {reran}", flush=True)
        return got, want

    routed, jax_routed = densities("1")
    host, jax_host = densities("0")
    diff = lambda got, want: cs.routed_2d_diff(got, want, likes=args.likes)  # noqa: E731
    for pair in pairs:
        print(f"{pair}: routed against host, port {diff(routed[pair], host[pair]):.4g}, JAX package "
              f"{diff(jax_routed[pair], jax_host[pair]):.4g}; routed, port against JAX "
              f"{diff(routed[pair], jax_routed[pair]):.4g}; host, port against JAX "
              f"{diff(host[pair], jax_host[pair]):.4g}")


if __name__ == "__main__":
    main()
