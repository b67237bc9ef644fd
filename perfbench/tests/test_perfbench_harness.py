"""The harness: cells found by name, a cell added by files and entries
alone, the result line, a run without a card, and what perfbench imports."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests.small import ROOT, small_cell

BENCH = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
HERE = Path(harness.HERE)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cells_are_found_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.config["name"] == cell.spec["config"]
    assert cell.traffic["name"] == cell.spec["traffic"]
    assert hasattr(cell.analysis, "Analysis")
    wanted = {"density_gap", "contour_gap"} | ({"like_gap"} if cell.traffic.get("meanlikes") else set())
    assert wanted <= set(cell.limits)
    for m in cell.end_to_end:
        assert callable(cell.reader("end_to_end", m["name"]))
    for m in cell.per_layer:
        assert callable(cell.reader("metrics", m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer


@pytest.fixture(scope="module")
def runs():
    cell = small_cell("bench_30x1M.triangle", samples=10_000, params=4, pool=2, checked=2, traced=2)
    return {trace: harness.run(cell, 2**31 + 5, 0.5, trace, device="cpu") for trace in (False, True)}


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(runs, trace):
    out = runs[trace]
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"reruns", "readbacks"} <= set(out["metrics"])
    else:
        assert {"triangle_ms", "triangle_p90_ms", "setup_s"} == set(out["metrics"])
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}
    assert harness.forbidden_modules() == []


def test_a_cell_added_by_files_and_entries_runs(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((HERE / "configs" / "bench_30x1M.json").read_text())
    config["name"] = "tiny_4x10k"
    config["chain"].update(samples=10_000, params=4)
    (tmp_path / "perfbench" / "configs" / "tiny_4x10k.json").write_text(json.dumps(config))
    # a mix of its own: three contour levels
    traffic = dict(json.loads((HERE / "traffic" / "triangle.json").read_text()), name="triangle3", pool=2,
                   contours=[0.68, 0.95, 0.99], checked=1)
    (tmp_path / "perfbench" / "traffic" / "triangle3.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench" / "limits" / "tiny_4x10k.triangle3.json").write_text(
        (HERE / "limits" / "bench_30x1M.triangle.json").read_text())
    bench["configs"].append({"name": "tiny_4x10k", "source": "https://example.org/tiny",
                             "file": "perfbench/configs/tiny_4x10k.json", "reduced": ["samples"], "why": "a test"})
    bench["workloads"].append({"name": "tiny_4x10k.triangle3", "config": "tiny_4x10k", "traffic": "triangle3",
                               "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; import torch; torch.set_num_threads(2); "
              "from perfbench import harness; assert harness.ROOT == __import__('pathlib').Path(sys.argv[1]); "
              "out = harness.run(harness.Cell('tiny_4x10k.triangle3'), 3, 0.2, False, device='cpu'); "
              "print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path), ROOT], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert {"triangle_ms", "setup_s"} == set(out["metrics"])


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "bench_30x1M.triangle", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_nothing_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "getdist_tpu"}, path
        if "reference" in path.relative_to(HERE).parts:
            assert "getdist_tpu_torch" not in tops, path
