"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the NVIDIA cards the cell
asks for. The last line of standard output is the result (JSON: correct,
attempted, failed, metrics, device, with tracing a breakdown, and last the
checks, each number compared beside its limit); the checks are also the
last lines of standard error. Without CUDA, or with fewer cards than the
cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_STARTED = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import harness

    cell = harness.Cell(args.workload)
    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    start = harness.process_start()
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                         t_start=min(start, _STARTED))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
