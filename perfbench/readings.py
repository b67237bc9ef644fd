"""The readings that the check's limits are set from, for one cell at its own
size, on the card.

    python3 perfbench/readings.py --workload <name> --seeds 1,2,...,12 --control 3 [--out FILE]

For each seed: the cell's configuration's chain for that seed, the
program's analysis of it (after two warm-up analyses), the plain reference
and the numbers compared (the lower readings: sound runs of the program);
for the first ``--control`` seeds also the control (the reference computed
with TF32 matrix products, :mod:`perfbench.reference.control`) against the
reference (the upper readings). Each line also names the rerun groups and
the parameters whose hard limit binds. One JSON line per reading goes to
``--out`` and to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.chains import chain_seed, make_chain
    from perfbench.reference.control import TF32Matmuls
    from perfbench.reference.entry import bound_axes

    cell = harness.Cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        chain = make_chain(cell.config, chain_seed(seed, 0), device)
        analysis = cell.analysis.Analysis(cell.config, dict(cell.traffic, pool=1), [chain], device, seed)
        analysis.setup()
        result = analysis.run(0)
        got = analysis.served(result)
        groups = [(g["fine"], g["winw"], len(g["pairs"]), g["bandwidths"]) for g in result["groups"]]
        bound = [name for name, b in zip(chain.names, bound_axes(chain, device)[0]) if b]
        del result
        analysis.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        want = analysis.reference(got)
        rows = [("program", *analysis.compare(got, want))]
        if n < args.control:
            with TF32Matmuls():
                ctl = analysis.reference(got)
            rows.append(("control", *analysis.compare(ctl, want)))
        for side, nums, notes in rows:
            line = json.dumps({"workload": cell.name, "seed": seed, "side": side, "numbers": nums, "notes": notes,
                               "groups": groups, "bound": bound, "seconds": time.perf_counter() - t0,
                               "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
