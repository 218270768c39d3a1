"""Spans and counters of the port's frame codec.

``ShardedFrameCodec`` marks the phases of each call with ``span(name)``
and adds what it moves with ``count(name, n)``.  Both record only while
the recorder is on: after ``enable()`` (until ``disable()``), or while a
``torch.profiler`` profile is recording.  Otherwise ``span`` hands back
one shared object that does nothing and ``count`` returns at once, so
the codec pays a flag test and a call per phase.

A span opened while no other is open is a root: it starts a call, whose
id its spans share (``compress_frame`` and ``decompress_frame`` are the
codec's roots; a phase opened outside them is a root of its own).  A
span opened inside a root is a leaf of that call; the codec's leaves
never nest in each other, so a leaf's self time is its whole time and a
root's self time is what its leaves leave uncovered.  Times are
``time.perf_counter_ns`` on the host.  While a profiler records, each
span also opens ``torch.profiler.record_function("lz4tpu." + name)``,
so that it sits in the profiler's trace, on the trace's own clock,
inside whatever span the caller opened around the call.

Everything is kept in memory: per name the count, total seconds and
self seconds (``totals()``), the counters (``counters()``), and the
most recent ``SPAN_BUFFER`` spans themselves (``spans()``).  ``reset()``
clears all of it.

    from zig_lz4_tpu_torch import trace
    trace.enable()
    codec.compress_frame(data)
    trace.totals()["enc.stage"]["seconds"], trace.counters()["enc.blocks"]
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

__all__ = ["SPAN_BUFFER", "PREFIX", "Span", "span", "count", "enable",
           "disable", "reset", "totals", "counters", "spans"]

#: raw spans kept, the most recent
SPAN_BUFFER = 65536
#: prefix of the spans' names in a profiler's trace
PREFIX = "lz4tpu."

#: one recorded span: its name, its call's id, its parent's name (None
#: for a root), start and end (``time.perf_counter_ns``)
Span = collections.namedtuple("Span", "name call parent start_ns end_ns")

_on = False
_lock = threading.Lock()
_local = threading.local()          # .open: the spans open in this thread
_calls = itertools.count()
_totals: dict[str, list] = {}       # name -> [count, total ns, self ns]
_counters: dict[str, int] = {}
_spans: collections.deque = collections.deque(maxlen=SPAN_BUFFER)


class _Off:
    """The span handed out while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "profiled", "call", "parent", "start", "child_ns",
                 "rf")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.profiled = profiled
        self.child_ns = 0
        self.rf = None

    # The profiler's span opens first and closes last, so that the
    # bookkeeping here lies inside it on the trace's clock; the interval
    # kept in memory starts before it opens and ends before the
    # bookkeeping.
    def __enter__(self):
        self.start = time.perf_counter_ns()
        if self.profiled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        if stack:
            up = stack[-1]
            self.call, self.parent = up.call, up
        else:
            self.call, self.parent = next(_calls), None
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.open.pop()
        ns = end - self.start
        up = self.parent
        if up is not None:
            up.child_ns += ns
        with _lock:
            agg = _totals.get(self.name)
            if agg is None:
                agg = _totals[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += ns
            agg[2] += ns - self.child_ns
            _spans.append((self.name, self.call,
                           None if up is None else up.name, self.start, end))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that records the phase ``name`` while the
    recorder is on, and does nothing otherwise."""
    profiled = torch.autograd._profiler_enabled()
    if _on or profiled:
        return _Open(name, profiled)
    return _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if _on or torch.autograd._profiler_enabled():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Record from now on, with or without a profiler."""
    global _on
    _on = True


def disable() -> None:
    """Record only while a profiler records (what is kept stays)."""
    global _on
    _on = False


def reset() -> None:
    """Forget every total, counter and span, and number calls from 0."""
    global _calls
    with _lock:
        _totals.clear()
        _counters.clear()
        _spans.clear()
        _calls = itertools.count()


def totals() -> dict:
    """name -> {"count", "seconds", "self_seconds"} of every span
    recorded since the last ``reset()``."""
    with _lock:
        return {k: {"count": c, "seconds": 1e-9 * t, "self_seconds": 1e-9 * s}
                for k, (c, t, s) in _totals.items()}


def counters() -> dict:
    """name -> sum of every counter added to since the last ``reset()``."""
    with _lock:
        return dict(_counters)


def spans() -> list:
    """The most recent spans (at most ``SPAN_BUFFER``), oldest first, as
    ``Span`` tuples."""
    with _lock:
        return [Span._make(s) for s in _spans]
