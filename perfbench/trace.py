"""The traced window: a ``torch.profiler`` trace of a few analyses, reduced to
what the per-layer metrics and the breakdown read.

Device operations are the trace's CUDA kernels, memory copies and memsets,
without the profiler's own buffers and without the device-side spans that
the program's ``record_function`` ranges leave on the device timeline (they
would count their kernels twice). Host ranges are the program's
``fast:`` / ``1d:`` / ``2d:`` ranges and the harness's ``analysis`` range
around each analysis, whose first start and last end bound the window.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

# the program's stage ranges (``mcsamples.py`` and ``ops/batched.py``)
STAGE_PREFIXES = ("fast:", "1d:", "2d:")
ANALYSIS_RANGE = "perfbench:analysis"

# launch counters the program keeps on its kernel entries, printed beside the
# roofline metrics as a cross-check: (module, entry, attribute)
COUNTERS = (
    ("getdist_tpu_torch.ops.pair_hist", "pair_histograms", "launches"),
    ("getdist_tpu_torch.ops.pair_hist", "pair_histograms", "float_launches"),
    ("getdist_tpu_torch.ops.pair_hist", "pair_histograms", "wide_launches"),
    ("getdist_tpu_torch.ops.pair_hist", "pair_histograms", "wide_bins"),
    ("getdist_tpu_torch.ops.pair_hist", "fixed_to_f32", "launches"),
    ("getdist_tpu_torch.ops.dft_conv", "dft_conv_spectrum", "launches"),
    ("getdist_tpu_torch.ops.dft_conv", "dft_conv_spectrum", "frames"),
    ("getdist_tpu_torch.ops.dft_conv", "dft_conv2d", "launches"),
    ("getdist_tpu_torch.ops.dft_conv", "dft_conv2d", "inputs"),
)


@dataclass
class Window:
    """What one traced window holds: device operations and host ranges as
    (name, start us, end us), the window's bounds on the trace's clock, the
    analyses' descriptions (see the analysis' ``info``) and the program's
    counters over the window."""

    device_ops: list
    host_ranges: list
    start_us: float
    end_us: float
    analyses: list
    counters: dict = field(default_factory=dict)

    @property
    def seconds(self):
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self):
        """The union of the device operations' intervals inside the window,
        as sorted disjoint (start, end) in us."""
        spans = sorted((max(s, self.start_us), min(e, self.end_us)) for _, s, e in self.device_ops)
        merged = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_seconds(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_seconds(self, match):
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.device_ops if match(name)) / 1e6

    def top_device_ops(self, count=10):
        """[[name, seconds]] of the device operations that took most time, by name."""
        totals = {}
        for name, s, e in self.device_ops:
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
        return [[name[:160], sec] for name, sec in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count=10):
        """[[name, seconds]]: the device's idle time in the window, by the
        innermost stage range open on the host where each gap starts (or
        "host outside the program's stages"), largest first."""
        busy = self.busy_intervals()
        gaps, t = [], self.start_us
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end_us > t:
            gaps.append((t, self.end_us))
        stages = [(name, s, e) for name, s, e in self.host_ranges if name.startswith(STAGE_PREFIXES)]
        totals = {}
        for g0, g1 in gaps:
            open_ = [(s, name) for name, s, e in stages if s <= g0 < e]
            name = "idle in " + max(open_)[1] if open_ else "idle outside the program's stages"
            totals[name] = totals.get(name, 0.0) + (g1 - g0) / 1e6
        return [[name, sec] for name, sec in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]


def counters():
    """A snapshot of the program's launch counters (those it has)."""
    import importlib

    out = {}
    for module, entry, attr in COUNTERS:
        value = getattr(getattr(importlib.import_module(module), entry, None), attr, None)
        if value is not None:
            out[f"{entry}.{attr}"] = dict(value) if isinstance(value, dict) else value
    return out


def counter_delta(before, after):
    """``after`` - ``before``, key by key (dict counters by their keys)."""
    out = {}
    for key, value in after.items():
        old = before.get(key, {} if isinstance(value, dict) else 0)
        if isinstance(value, dict):
            diff = {str(k): v - old.get(k, 0) for k, v in value.items() if v - old.get(k, 0)}
        else:
            diff = value - old
        out[key] = diff
    return out


@contextlib.contextmanager
def analysis_range():
    """The harness's host range around one traced analysis."""
    with torch.profiler.record_function(ANALYSIS_RANGE):
        yield


def _raw_events(prof):
    """(name, on the device?, start us, end us) of every event of a finished
    profile, from the profiler's raw results (building its event tree for
    a trace of thousands of launches takes minutes)."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield e.name(), e.device_type() == cuda, e.start_ns() / 1e3, e.end_ns() / 1e3


def reduce(prof, analyses, counts):
    """The :class:`Window` of a finished profile."""
    device, host = [], []
    skip = ("Activity Buffer",) + STAGE_PREFIXES + (ANALYSIS_RANGE,)
    for name, on_device, start, end in _raw_events(prof):
        if on_device:
            if not name.startswith(skip):
                device.append((name, start, end))
        elif name.startswith(STAGE_PREFIXES + (ANALYSIS_RANGE,)):
            host.append((name, start, end))
    marks = [(s, e) for name, s, e in host if name == ANALYSIS_RANGE]
    if not marks:
        raise RuntimeError("the trace holds no analysis range")
    return Window(device_ops=device, host_ranges=host, start_us=min(s for s, _ in marks),
                  end_us=max(e for _, e in marks), analyses=analyses, counters=counts)
