"""The bandwidth optimizer's launches and idle gaps as the traced window
holds them: ``bandwidth_launches`` on synthetic windows, the breakdown's
idle gaps by the optimizer's inner spans, and a CPU trace of the program
whose window holds those spans inside ``2d:bandwidths``."""

import pytest
import torch

from perfbench import harness
from perfbench import trace as tr
from perfbench.tests.small import small_cell

read = harness.load_module(harness.HERE / "metrics" / "bandwidth_launches.py").read


def _window(device_ops, host_ranges, analyses=1):
    return tr.Window(device_ops=device_ops, host_ranges=host_ranges, start_us=0.0, end_us=1000.0,
                     analyses=[{"reruns": 0}] * analyses)


def test_an_operation_counts_where_it_starts():
    ranges = [("2d:bandwidths", 100.0, 200.0), ("2d:amise_fixed", 120.0, 150.0)]
    ops = [("k_in", 110.0, 112.0), ("k_child", 130.0, 131.0), ("k_end", 199.0, 260.0),
           ("k_before", 90.0, 105.0), ("k_after", 201.0, 202.0)]
    assert read(_window(ops, ranges)) == 3


def test_ranges_summed_per_analysis():
    # two analyses, each with program B's and the rescue's optimizer
    ranges = [("2d:bandwidths", 0.0, 10.0), ("2d:bandwidths", 20.0, 30.0),
              ("2d:bandwidths", 500.0, 510.0), ("2d:bandwidths", 520.0, 530.0), ("2d:contours", 40.0, 50.0)]
    ops = [(f"k{t}", float(t), t + 0.5) for t in (1, 2, 21, 22, 23, 45, 501, 521, 600)]
    assert read(_window(ops, ranges, analyses=2)) == 3.5


def test_nothing_to_read():
    assert read(_window([], [("2d:bandwidths", 0.0, 10.0)])) is None
    assert read(_window([("k", 1.0, 2.0)], [("2d:contours", 0.0, 10.0)])) is None
    assert read(tr.Window(device_ops=[("k", 1.0, 2.0)], host_ranges=[("2d:bandwidths", 0.0, 10.0)], start_us=0.0,
                          end_us=10.0, analyses=[])) is None


def test_idle_gaps_named_by_the_innermost_span():
    ranges = [("fast:triangle", 0.0, 1000.0), ("2d:bandwidths", 100.0, 900.0), ("2d:tstar", 100.0, 300.0),
              ("2d:amise_fixed", 400.0, 600.0), ("2d:amise_free", 600.0, 850.0)]
    ops = [("k", 0.0, 100.0), ("k", 300.0, 400.0), ("k", 850.0, 1000.0)]
    gaps = dict(_window(ops, ranges).idle_gaps())
    assert gaps == pytest.approx({"idle in 2d:tstar": 200e-6, "idle in 2d:amise_fixed": 450e-6})


def test_a_cpu_trace_holds_the_optimizer_spans():
    from torch.profiler import ProfilerActivity, profile

    from perfbench.chains import chain_seed, make_chain

    cell = small_cell("bounded_30x1M.triangle_meanlikes", samples=10_000, params=4, pool=1)
    chain = make_chain(cell.config, chain_seed(2**31 + 9, 0), torch.device("cpu"))
    analysis = cell.analysis.Analysis(cell.config, cell.traffic, [chain], "cpu", 1)
    analysis.setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.analysis_range():
            result = analysis.run(0)
    window = tr.reduce(prof, [analysis.info(result)], {})
    names = [name for name, _, _ in window.host_ranges]
    outer = [(s, e) for name, s, e in window.host_ranges if name == "2d:bandwidths"]
    assert names.count("fast:triangle") == 1 and outer
    for inner in ("2d:tstar", "2d:psi", "2d:amise_fixed", "2d:amise_free"):
        spans = [(s, e) for name, s, e in window.host_ranges if name == inner]
        assert len(spans) == len(outer), inner
        assert all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in spans), inner
    assert not any(name.startswith("mc:") for name in names)
    assert read(window) is None  # no device operation on the CPU
