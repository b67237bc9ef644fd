"""Cells of BENCHMARK.json cut to a size a CPU test can hold."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

torch.set_num_threads(min(4, os.cpu_count() or 1))

# one column of each kind of hard prior, and one free
SMALL_COLUMNS = [
    {"name": "lower", "mean": 0.0, "sd": 1.0, "range": [0.0, None]},
    {"name": "upper", "mean": 1.0, "sd": 0.5, "range": [None, 1.0]},
    {"name": "two_sided", "mean": 0.0, "sd": 1.0, "range": [-1.0, 1.5]},
    {"name": "angle", "mean": 3.141592653589793, "sd": 1.5, "range": [0.0, 6.283185307179586], "periodic": True},
    {"name": "free", "mean": 0.0, "sd": 1.0},
]


def small_cell(name, samples=10_000, params=5, pool=2, checked=1, traced=2):
    """``name``'s cell with its chains cut to ``samples`` x ``params`` (a
    configuration with listed columns takes the first ``params`` of
    ``SMALL_COLUMNS``) and its pool to ``pool``."""
    cell = harness.Cell(name)
    cell.config = copy.deepcopy(cell.config)
    chain = cell.config["chain"]
    chain["samples"] = samples
    if chain.get("columns"):
        chain["columns"] = copy.deepcopy(SMALL_COLUMNS[:params])
    else:
        chain["params"] = params
    cell.traffic = dict(cell.traffic, pool=pool, checked=checked, traced=traced)
    return cell
