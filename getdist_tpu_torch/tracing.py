"""Named spans over the port's stages, on the clock of a ``torch.profiler`` trace.

``span(name)`` marks a stage, as a context manager or a decorator. What it
does depends on what is on when it is entered:

* nothing: it is a shared no-op (one object per name, made once), that
  enters no profiler range, reads no clock and allocates nothing;
* a ``torch.profiler``: it enters ``torch.profiler.record_function(name)``,
  so the trace names the host's time (and the device's idle gaps) by it;
* the recorder (:func:`recording`): it appends one :class:`Span` to the
  recorder's list when it closes, stamped with ``time.time_ns()``, the
  clock ``torch.profiler`` stamps its events with.

The profiler and the recorder can be on together. A span never
synchronizes the device: its interval is the host's, and the device time it
queued comes from a trace. Spans open once per call of a stage, never once
per loop iteration. An operator's use::

    from getdist_tpu_torch import tracing

    with tracing.recording() as spans:
        mc.fastTriangleDensities()
    for s in spans:
        print(s.name, s.parent, (s.t1_ns - s.t0_ns) / 1e6, "ms")

Names start with the layer that opens them: ``fast:`` (the fused entry,
``MCSamples.fastTriangleDensities``), ``1d:`` and ``2d:`` (the fused
program, ``ops/batched.py``) and ``mc:`` (the ``MCSamples`` constructor
and its base statistics).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["Span", "span", "recording"]


class Span(NamedTuple):
    """One closed span: ``id`` and ``parent`` (the enclosing span's id, None
    at a root) number the spans of a process; ``call`` is the id of the
    outermost span it lies in, shared by every span of one call; ``t0_ns``
    and ``t1_ns`` are ``time.time_ns()`` at its start and end."""

    name: str
    id: int
    parent: int | None
    call: int
    t0_ns: int
    t1_ns: int


_records = None  # the recorder's list while it is on
_ids = itertools.count(1)
_local = threading.local()  # .open: the recorded spans open on this thread, as (id, parent, call)


class _Marker:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Idle(_Marker):
    """The span of a name while nothing is on."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Live(_Marker):
    """A span entered while the profiler or the recorder is on."""

    __slots__ = ("_range", "_into", "_frame", "_t0")

    # the recorded interval encloses the profiler's range, whose own cost
    # (a millisecond for a process's first range) is the host's time too
    def __enter__(self):
        self._range = self._into = None
        if _records is not None:
            stack = _open_stack()
            sid = next(_ids)
            # (id, parent, call): a root is its own call
            self._frame = (sid, stack[-1][0], stack[-1][2]) if stack else (sid, None, sid)
            stack.append(self._frame)
            self._into = _records
            self._t0 = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return None

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._into is not None:
            t1 = time.time_ns()
            stack = _open_stack()
            if self._frame in stack:  # the last one, unless spans closed out of order
                stack.remove(self._frame)
            sid, parent, call = self._frame
            self._into.append(Span(self.name, sid, parent, call, self._t0, t1))
        return False


_IDLE = {}


def _open_stack():
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name):
    """The span ``name``: a context manager, or a decorator of a function
    each of whose calls is one span."""
    if _records is None and not torch.autograd._profiler_enabled():
        idle = _IDLE.get(name)
        if idle is None:
            idle = _IDLE[name] = _Idle(name)
        return idle
    return _Live(name)


@contextlib.contextmanager
def recording():
    """Turn the recorder on inside; yields the list that each span closed
    inside is appended to (a :class:`Span` each, in the order they close).
    The recorder is process-wide; a nested ``recording()`` takes the spans
    until it ends, then the outer one resumes."""
    global _records
    saved, _records = _records, []
    try:
        yield _records
    finally:
        _records = saved
