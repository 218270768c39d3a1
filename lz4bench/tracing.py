"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read.

A traced run records, in one profiler window over the benchmark's
measured window: the device's kernels, copies and fills (CUPTI), the
torch CPU operators, and the benchmark's own spans (``record_function``)
named ``lz4bench.<kind>#<call>``, one around each call (kind ``enc``
for a compress, ``dec`` for a decompress), and ``lz4bench.window``
around the window.  Times are microseconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import json
import os
import re
import tempfile

__all__ = ["Span", "DeviceOp", "Trace", "read_chrome_trace", "record"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "lz4bench."
WINDOW = "lz4bench.window"
HOST = "host-python"


@dataclasses.dataclass
class Span:
    """One call as the trace saw it, with the bytes the benchmark gave
    and got: ``content`` the uncompressed bytes, ``frame`` the frame's."""
    kind: str
    call: int
    start: float
    end: float
    content: int = 0
    frame: int = 0


@dataclasses.dataclass
class DeviceOp:
    cat: str
    name: str
    start: float
    end: float
    nbytes: int = 0


def record(name: str):
    """A span of the benchmark's own around a call (a profiler
    ``record_function``)."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


def op_name(ev_name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters; a copy's or fill's as CUPTI gives it."""
    if ev_name.startswith(("Memcpy", "Memset")):
        return ev_name
    name = re.sub(r"^void\s+", "", ev_name.replace("(anonymous namespace)::",
                                                  ""))
    return name.split("(", 1)[0].split("<", 1)[0].strip() or ev_name


def read_chrome_trace(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


class Trace:
    """The spans, device operations and host operators of one traced
    window.  ``calls`` maps a call number to (content bytes, frame
    bytes); spans of calls not in it are left out."""

    def __init__(self, events: list, calls: dict):
        self.spans: list[Span] = []
        self.device: list[DeviceOp] = []
        self.window = None
        ops, main_tids = [], set()
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            t0 = float(ev["ts"])
            t1 = t0 + float(ev.get("dur", 0))
            if cat in DEVICE_CATS:
                nb = (ev.get("args") or {}).get("bytes", 0)
                self.device.append(DeviceOp(cat, name, t0, t1, int(nb or 0)))
            elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                main_tids.add(ev.get("tid"))
                if name == WINDOW:
                    self.window = (t0, t1)
                    continue
                kind, _, num = name[len(SPAN_PREFIX):].partition("#")
                if num.isdigit() and int(num) in calls:
                    c, f = calls[int(num)]
                    self.spans.append(Span(kind, int(num), t0, t1, c, f))
            elif cat == "cpu_op":
                ops.append((t0, t1, name, ev.get("tid")))
        self.device.sort(key=lambda d: d.start)
        self.spans.sort(key=lambda s: s.start)
        self._starts = [d.start for d in self.device]
        self._max_end = list(itertools.accumulate(
            (d.end for d in self.device), max))
        self._segments = _innermost(
            sorted(((a, b, n) for a, b, n, tid in ops if tid in main_tids),
                   key=lambda o: (o[0], -o[1])))
        self._seg_ends = [s[1] for s in self._segments]

    # -- selections --------------------------------------------------------

    def spans_of(self, kind: str | None) -> list[Span]:
        """Spans of ``kind``; every span for ``req`` or None."""
        if kind in (None, "req"):
            return list(self.spans)
        return [s for s in self.spans if s.kind == kind]

    def ops_in(self, span: Span, cats=DEVICE_CATS) -> list[DeviceOp]:
        """Device operations that started inside ``span``."""
        lo = bisect.bisect_left(self._starts, span.start)
        hi = bisect.bisect_right(self._starts, span.end)
        return [d for d in self.device[lo:hi] if d.cat in cats]

    # -- reductions --------------------------------------------------------

    def busy_in(self, a: float, b: float, ops=None) -> list:
        """The union of device intervals, clipped to [a, b], sorted."""
        if ops is None:
            lo = bisect.bisect_right(self._max_end, a)
            hi = bisect.bisect_left(self._starts, b)
            ops = self.device[lo:hi]
        out = []
        for d in sorted(ops, key=lambda d: d.start):
            s, e = max(d.start, a), min(d.end, b)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def idle_share(self, spans: list[Span]) -> float | None:
        """Percent of the spans' time in which the device runs nothing."""
        total = sum(s.end - s.start for s in spans)
        if total <= 0:
            return None
        busy = sum(e - s for sp in spans
                   for s, e in self.busy_in(sp.start, sp.end))
        return 100.0 * (total - busy) / total

    def kernel_seconds(self, spans: list[Span]) -> float:
        return 1e-6 * sum(d.end - d.start for sp in spans
                          for d in self.ops_in(sp, ("kernel",)))

    def window_busy(self) -> tuple[float, float]:
        """(seconds the device was busy in the window, the window's
        seconds)."""
        if self.window is None:
            a = min((s.start for s in self.spans), default=0.0)
            b = max((s.end for s in self.spans), default=0.0)
        else:
            a, b = self.window
        busy = sum(e - s for s, e in self.busy_in(a, b))
        return 1e-6 * busy, 1e-6 * (b - a)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, by
        name, and the device's idle time inside the spans by the span's
        kind and the innermost torch operator open on the host then
        (``host-python`` when none was)."""
        a, b = self.window or (float("-inf"), float("inf"))
        by_op: dict[str, float] = {}
        for d in self.device:
            if a <= d.start <= b:
                k = op_name(d.name)
                by_op[k] = by_op.get(k, 0.0) + 1e-6 * (d.end - d.start)
        gaps: dict[str, float] = {}
        for sp in self.spans:
            t = sp.start
            for s, e in self.busy_in(sp.start, sp.end) + [[sp.end, sp.end]]:
                if s > t:
                    for label, sec in self._attribute(t, s):
                        key = f"{sp.kind}:{label}"
                        gaps[key] = gaps.get(key, 0.0) + sec
                t = max(t, e)
        return {"device_ops": _top(by_op, top), "idle_gaps": _top(gaps, top)}

    def _attribute(self, a: float, b: float):
        """(label, seconds) of [a, b) by the innermost host operator."""
        i = bisect.bisect_right(self._seg_ends, a)
        t = a
        while i < len(self._segments) and self._segments[i][0] < b:
            s, e, name = self._segments[i]
            s, e = max(s, a), min(e, b)
            if s > t:
                yield HOST, 1e-6 * (s - t)
            if e > s:
                yield name, 1e-6 * (e - s)
            t = max(t, e)
            i += 1
        if b > t:
            yield HOST, 1e-6 * (b - t)


def _top(d: dict, n: int) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(ops) -> list:
    """Non-overlapping (start, end, name) segments, each labelled by the
    innermost of the nested operators ``ops`` (sorted by start, then
    longest first) open over it."""
    segs, stack = [], []
    t = float("-inf")

    def emit(s, e, name):
        if e > s:
            segs.append((s, e, name))

    for s, e, name in ops:
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            emit(t, end, nm)
            t = max(t, end)
        if stack:
            emit(t, s, stack[-1][1])
            e = min(e, stack[-1][0])
        t = max(t, s)
        stack.append((e, name))
    while stack:
        end, nm = stack.pop()
        emit(t, end, nm)
        t = max(t, end)
    return segs


def profile(fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU operators and the
    device's activity); returns (its result, the trace's events).  The
    trace goes through a file in the temporary directory, removed at
    once."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="lz4bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = read_chrome_trace(path)
    finally:
        os.remove(path)
    return result, events
