"""getdist_tpu_torch.tracing: the port's spans, off, under the recorder and
under the profiler.

Off (neither a profiler nor the recorder on) a span is a shared no-op that
enters no ``record_function`` and reads no clock. Under ``recording()`` the
public fused entry yields its documented spans, each inside its parent and
one ``call`` per call, and an ``MCSamples`` build yields ``mc:init`` and its
children; the outputs are bit-identical with the recorder on and off.
Under a CPU ``torch.profiler`` each recorded span lies within 1 ms of its
kineto range: the two share a clock. The card's side of that clock (a
kernel's device interval inside its span) is in ``tests/test_torch_cuda.py``.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

from getdist_tpu_torch import tracing  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402

# the spans of a two-program call (a hard limit and loglikes), by layer
FAST = {"fast:triangle", "fast:chain_state", "fast:program_a", "fast:program_b", "fast:plan", "fast:diag"}
ONE_D = {"1d:all", "1d:neff", "1d:isj_bandwidth", "1d:isj_seeds", "1d:isj_bisect"}
TWO_D = {"2d:histograms", "2d:bandwidths", "2d:shear", "2d:tstar", "2d:psi", "2d:amise_fixed", "2d:amise_free",
         "2d:contours"}
# each span's parent, where it has one fixed parent
PARENT = {
    "1d:neff": "1d:all", "1d:isj_bandwidth": "1d:all", "1d:isj_seeds": "1d:isj_bandwidth",
    "1d:isj_bisect": "1d:isj_bandwidth", "2d:shear": "2d:bandwidths", "2d:tstar": "2d:bandwidths",
    "2d:psi": "2d:bandwidths", "2d:amise_fixed": "2d:bandwidths", "2d:amise_free": "2d:bandwidths",
    "fast:chain_state": "fast:triangle", "fast:program_a": "fast:triangle", "fast:program_b": "fast:triangle",
    "mc:chains": "mc:init", "mc:cov": "mc:init", "mc:base_stats": "mc:init", "mc:limits": "mc:init",
    "mc:like_stats": "mc:init",
}
MC = {"mc:init", "mc:chains", "mc:cov", "mc:base_stats", "mc:limits", "mc:like_stats"}


def _chain(n=20_000, p=4, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p))
    x[:, 1] += 0.6 * x[:, 0]
    x[:, 2] = np.abs(x[:, 2])
    return dict(samples=x, weights=rng.integers(1, 4, n).astype(np.float64), loglikes=0.5 * (x**2).sum(1),
                names=[f"p{i}" for i in range(p)], ranges={"p2": [0.0, None]}, device="cpu")


def _build():
    return MCSamples(**_chain())


@pytest.fixture(scope="module")
def mc():
    return _build()


def _flat(out):
    """Every tensor of a ``fastTriangleDensities`` result, in a fixed order."""
    found = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, dict):
            for key in sorted(x, key=str):
                walk(x[key])
        elif isinstance(x, (list, tuple)):
            for item in x:
                walk(item)

    walk(out)
    return found


def _check_tree(spans):
    """Each span's parent was recorded, encloses it and shares its call; a
    root is its own call."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is None:
            assert s.call == s.id
            continue
        parent = by_id[s.parent]
        assert s.call == parent.call
        assert parent.t0_ns <= s.t0_ns and s.t1_ns <= parent.t1_ns, (s.name, parent.name)
        if s.name in PARENT:
            assert parent.name == PARENT[s.name], s.name
    return by_id


def test_off_span_is_a_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span with tracing off used the profiler or the clock")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing.time, "time_ns", refuse)
    assert not torch.autograd._profiler_enabled()
    first = tracing.span("2d:probe")
    assert tracing.span("2d:probe") is first
    with first as entered:
        assert entered is None

    @tracing.span("2d:decorated")
    def twice(x):
        return 2 * x

    assert twice(3) == 6
    assert twice.__name__ == "twice"


def test_off_entry_enters_no_range(mc, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing.time, "time_ns", refuse)
    d1, d2, pairs = mc.fastTriangleDensities()
    assert len(pairs) == 6 and torch.isfinite(d2["P"]).all()


def test_entry_spans(mc):
    mc.fastTriangleDensities()  # warm
    with tracing.recording() as spans:
        mc.fastTriangleDensities()
        mc.fastTriangleDensities()
    names = {s.name for s in spans}
    assert FAST | ONE_D | TWO_D <= names
    assert not names & MC, "the constructor's spans opened inside an analysis"
    assert all(n.startswith(("fast:", "1d:", "2d:")) for n in names)
    _check_tree(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["fast:triangle", "fast:triangle"]
    assert {s.call for s in spans} == {s.id for s in roots}
    for root in roots:
        mine = [s for s in spans if s.call == root.id]
        assert {s.name for s in mine} == names
        # the optimizer's stages once per 2D program (B and the clamped rescue)
        programs = sum(s.name == "2d:bandwidths" for s in mine)
        assert programs >= 1
        for name in ("2d:tstar", "2d:psi", "2d:amise_fixed", "2d:amise_free"):
            assert sum(s.name == name for s in mine) == programs, name
    # the per-stage host seconds stay as they were
    assert {"chain_state", "program_a", "program_b"} <= set(mc.fast_profile)


def test_constructor_spans():
    with tracing.recording() as spans:
        _build()
    by_id = _check_tree(spans)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "mc:init"
    children = {s.name for s in spans if s.parent == root.id}
    assert children == MC - {"mc:init"}
    assert all(by_id[s.parent].name == "mc:init" for s in spans if s.parent is not None)


def test_outputs_bit_identical_with_recorder_on_and_off(mc):
    off = _flat(mc.fastTriangleDensities(meanlikes=True))
    with tracing.recording() as spans:
        on = _flat(mc.fastTriangleDensities(meanlikes=True))
    assert spans and len(on) == len(off) > 0
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_nested_recording_and_later_spans():
    with tracing.recording() as outer:
        with tracing.span("2d:a"):
            with tracing.recording() as inner:
                with tracing.span("2d:b"):
                    pass
            with tracing.span("2d:c"):
                pass
    assert [s.name for s in inner] == ["2d:b"]
    assert [s.name for s in outer] == ["2d:c", "2d:a"]
    a = outer[1]
    assert inner[0].parent == a.id and inner[0].call == a.id and outer[0].parent == a.id
    with tracing.span("2d:after"):
        pass
    assert len(outer) == 2


def test_spans_share_the_profiler_clock(mc):
    from torch.profiler import ProfilerActivity, profile

    mc.fastTriangleDensities()  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing.recording() as spans:
        t0 = time.time_ns()
        mc.fastTriangleDensities()
        t1 = time.time_ns()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("fast:", "1d:", "2d:")):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    recorded = {}
    for s in spans:
        recorded.setdefault(s.name, []).append((s.t0_ns, s.t1_ns))
    assert set(recorded) == set(ranges)
    ms = 1_000_000
    for name, mine in recorded.items():
        theirs = sorted(ranges[name])
        assert len(theirs) == len(mine), name
        for (s0, s1), (k0, k1) in zip(sorted(mine), theirs):
            assert abs(s0 - k0) < ms and abs(s1 - k1) < ms, (name, s0 - k0, s1 - k1)
            assert t0 <= s0 <= s1 <= t1


def test_profiler_alone_gets_the_ranges():
    from torch.profiler import ProfilerActivity, profile

    @tracing.span("2d:decorated")
    def work():
        return torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("2d:probe"):
            work()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("2d:probe") == 1 and names.count("2d:decorated") == 1
