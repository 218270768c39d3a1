"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read.

A traced run records, in one profiler window over the benchmark's
measured window: the device's kernels, copies and fills (CUPTI), the
torch CPU operators, and the benchmark's own spans (``record_function``)
named ``lz4bench.<kind>#<call>``, one around each call (kind ``enc``
for a compress, ``dec`` for a decompress), and ``lz4bench.window``
around the window.  Times are microseconds on the trace's clock.

A run over a mesh of several cards traces each card's operations with
the card they ran on.  Busy and idle time are taken card by card and
averaged over the run's cards, a card with no operation idle
throughout.  ``window_busy_union`` is the time in which some card was
busy: against the cards' summed busy time it shows how far they
overlapped.  Sums of device time (``kernel_seconds``, the breakdown's
device operations) add the cards' times, card-seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import json
import os
import re
import tempfile

__all__ = ["Span", "DeviceOp", "Trace", "card_of", "read_chrome_trace",
           "record"]

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
    """A kernel, copy or fill, and the card it ran on."""
    cat: str
    name: str
    start: float
    end: float
    nbytes: int = 0
    card: int = 0


def card_of(ev: dict) -> int:
    """The card of a device event: CUPTI's ``args.device``, else its
    ``pid``."""
    args = ev.get("args") or {}
    return int(args.get("device", ev.get("pid", 0)))


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
    bytes); spans of calls not in it are left out.  ``cards`` are the
    CUDA cards the run used, over which busy and idle time are averaged
    (default: the cards the operations ran on, or one card where none
    ran)."""

    def __init__(self, events: list, calls: dict, cards=None):
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
                self.device.append(DeviceOp(cat, name, t0, t1, int(nb or 0),
                                            card_of(ev)))
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
        self.cards = sorted(set(cards) if cards is not None
                            else {d.card for d in self.device} or {0})
        self._by_card = {c: _Index([d for d in self.device if d.card == c])
                         for c in self.cards}
        self._by_card[None] = _Index(self.device)
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

    def busy_in(self, a: float, b: float, card: int | None) -> list:
        """The union of the intervals of ``card``'s operations (of every
        card's, where ``card`` is None), clipped to [a, b], sorted."""
        out = []
        for d in sorted(self._by_card[card].overlapping(a, b),
                        key=lambda d: d.start):
            s, e = max(d.start, a), min(d.end, b)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def idle_share(self, spans: list[Span]) -> float | None:
        """Percent of the spans' time in which a card runs nothing,
        averaged over the cards."""
        total = sum(s.end - s.start for s in spans)
        if total <= 0:
            return None
        busy = [sum(e - s for sp in spans
                    for s, e in self.busy_in(sp.start, sp.end, c))
                for c in self.cards]
        return sum(100.0 * (total - b) / total for b in busy) / len(busy)

    def kernel_seconds(self, spans: list[Span]) -> float:
        return 1e-6 * sum(d.end - d.start for sp in spans
                          for d in self.ops_in(sp, ("kernel",)))

    def _window_bounds(self) -> tuple[float, float]:
        if self.window is None:
            return (min((s.start for s in self.spans), default=0.0),
                    max((s.end for s in self.spans), default=0.0))
        return self.window

    def window_busy(self) -> tuple[float, float]:
        """(seconds a card was busy in the window, averaged over the
        cards; the window's seconds)."""
        a, b = self._window_bounds()
        busy = sum(sum(e - s for s, e in self.busy_in(a, b, c))
                   for c in self.cards) / len(self.cards)
        return 1e-6 * busy, 1e-6 * (b - a)

    def window_busy_union(self) -> float:
        """Seconds of the window in which some card was busy.  Against
        the cards' busy seconds summed (``window_busy()[0]`` times the
        cards) it shows how far their work overlapped: the two are equal
        where no two cards were ever busy at once, and on one card."""
        a, b = self._window_bounds()
        return 1e-6 * sum(e - s for s, e in self.busy_in(a, b, None))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, by
        name (summed over the cards), and the idle time inside the spans
        by the span's kind and the innermost torch operator open on the
        host then (``host-python`` when none was), a card's, averaged
        over the cards."""
        a, b = self.window or (float("-inf"), float("inf"))
        by_op: dict[str, float] = {}
        for d in self.device:
            if a <= d.start <= b:
                k = op_name(d.name)
                by_op[k] = by_op.get(k, 0.0) + 1e-6 * (d.end - d.start)
        gaps: dict[str, float] = {}
        for card in self.cards:
            for sp in self.spans:
                t = sp.start
                for s, e in self.busy_in(sp.start, sp.end, card) + [
                        [sp.end, sp.end]]:
                    if s > t:
                        for label, sec in self._attribute(t, s):
                            key = f"{sp.kind}:{label}"
                            gaps[key] = gaps.get(key, 0.0) + sec
                    t = max(t, e)
        gaps = {k: v / len(self.cards) for k, v in gaps.items()}
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


class _Index:
    """Device operations sorted by start, with the running maximum of
    their ends, for the operations that overlap an interval."""

    def __init__(self, ops: list):
        self.ops = ops
        self.starts = [d.start for d in ops]
        self.max_end = list(itertools.accumulate((d.end for d in ops), max))

    def overlapping(self, a: float, b: float) -> list:
        """The operations that may overlap [a, b]: from the first whose
        ends so far pass ``a`` to the last starting before ``b``."""
        lo = bisect.bisect_right(self.max_end, a)
        hi = bisect.bisect_left(self.starts, b)
        return self.ops[lo:hi]


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


def profile(fn, cards):
    """Run ``fn()`` under ``torch.profiler`` (CPU operators and the
    devices' activity) and wait for the CUDA ``cards`` before it stops;
    returns (its result, the trace's events).  The trace goes through a
    file in the temporary directory, removed at once."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            result = fn()
        for k in cards:
            torch.cuda.synchronize(k)
    fd, path = tempfile.mkstemp(prefix="lz4bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = read_chrome_trace(path)
    finally:
        os.remove(path)
    return result, events
