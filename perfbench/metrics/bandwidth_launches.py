"""bandwidth_launches (ops/analysis), layer fused program: the device
operations (kernels, copies, memsets) that the 2D bandwidth optimizer
issues, per analysis: those that start inside a ``2d:bandwidths`` host
range (program A's or B's and the clamped rescue's), children included.

This is a proxy for the launches. The window holds each operation's device
interval, not its launch call, so an operation is placed by its device
start. That equals a join of launch calls by correlation id only while the
device keeps pace with the host, as it does under the profiler (the host
takes tens of microseconds a launch, the optimizer's operations a few).
Where the host runs ahead, operations queued inside the range start after
it, and work queued before it starts inside it, so the count can fall with
no fewer launches. A launch reduction is not to be claimed from this count
alone: check it against the join in ``scripts/time_spans_torch.py`` until
the window holds the launch calls and this reader joins them."""

from bisect import bisect_left, bisect_right

RANGE = "2d:bandwidths"


def read(window):
    if not window.analyses or not window.device_ops:
        return None
    spans = sorted((s, e) for name, s, e in window.host_ranges if name == RANGE)
    if not spans:
        return None
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = sorted(s for _, s, _ in window.device_ops)
    count = sum(bisect_right(starts, e) - bisect_left(starts, s) for s, e in merged)
    return count / len(window.analyses)
