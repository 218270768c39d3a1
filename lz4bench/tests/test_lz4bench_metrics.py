"""The metric arithmetic: rate and ratio over the calls, idle share,
roofline and the breakdown from a synthetic profiler trace, card by card
on a mesh and, on one card, equal to the union of every operation's
interval (the oracle) on synthetic, CPU and H100 traces; and the seeded
sample of frames the reference judges."""

import gzip
import json
import math
import os

import pytest

from lz4bench import harness, tracing
from lz4bench.harness import Call, Run


def _read(name, run):
    read, kind = harness.reader(name)
    return read(run, kind)


def test_e2e_over_all_requests():
    calls = [Call("enc", 0.5, 1_000_000_000, 250_000_000, True, True),
             Call("enc", 1.5, 1_000_000_000, 250_000_000, True, True),
             Call("dec", 0.25, 500_000_000, 100_000_000, True, True),
             Call("enc", 9.0, 1_000_000_000, 1, True, False)]  # after close
    run = Run(calls, setup_s=12.5)
    assert _read("compress_gbps", run) == pytest.approx(1.0)
    assert _read("compression_ratio", run) == pytest.approx(4.0)
    assert _read("setup_s", run) == 12.5


def test_failed_requests_take_time_and_give_no_bytes():
    calls = [Call("enc", 1.0, 1_000_000_000, 1, True, True),
             Call("enc", 1.0, 1_000_000_000, 0, False, True)]
    assert _read("compress_gbps", Run(calls, 0)) == pytest.approx(0.5)
    dec = [Call("dec", 1.0, 1_000_000_000, 1, True, True)]
    assert _read("compress_gbps", Run(dec, 0)) is None


def test_decompress_rate_over_the_reads():
    calls = [Call("dec", 0.25, 500_000_000, 100_000_000, True, True),
             Call("dec", 0.75, 0, 100_000_000, False, True),   # failed
             Call("enc", 1.0, 1_000_000_000, 1, True, True),
             Call("dec", 9.0, 500_000_000, 1, True, False)]    # after close
    assert _read("decompress_gbps", Run(calls, 0)) == pytest.approx(0.5)
    enc = [Call("enc", 1.0, 1_000_000_000, 1, True, True)]
    assert _read("decompress_gbps", Run(enc, 0)) is None


def test_stored_block_pct_from_the_ports_routes():
    run = Run([], 0, routes={"stored": 96, "tmap": 672})
    assert _read("stored_block_pct", run) == pytest.approx(12.5)
    assert _read("stored_block_pct", Run([], 0, routes={"tmap": 72})) == 0.0
    assert _read("stored_block_pct", Run([], 0)) is None


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace():
    """Two calls: a compress over [100, 200) us with kernels [110, 130)
    and [120, 140) (union 30 us) and an H2D copy [150, 160) of 4000
    bytes; a decompress over [300, 400) with a kernel [350, 390)."""
    return tracing.Trace(_trace_events(), {0: (1000, 300), 1: (2000, 400)})


def _trace_events():
    return [
        _ev("user_annotation", "lz4bench.window", 50, 400),
        _ev("user_annotation", "lz4bench.enc#0", 100, 100),
        _ev("user_annotation", "lz4bench.dec#1", 300, 100),
        _ev("user_annotation", "lz4bench.enc#2", 420, 10),   # not counted
        _ev("cpu_op", "aten::to", 140, 30),
        _ev("cpu_op", "aten::copy_", 145, 20),
        _ev("cpu_op", "aten::empty", 305, 5, tid=2),          # other thread
        _ev("kernel", "void enc_match_kernel<4>(unsigned char*)", 110, 20,
            tid=7),
        _ev("kernel", "enc_parse_emit", 120, 20, tid=8),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 150, 10,
            tid=7, bytes=4000),
        _ev("kernel", "tmap_gather_kernel(int*)", 350, 40, tid=7),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 395, 5,
            tid=7, bytes=800),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 2),
    ]


def test_trace_spans_and_window():
    tr = _trace()
    assert [(s.kind, s.call) for s in tr.spans] == [("enc", 0), ("dec", 1)]
    busy, window = tr.window_busy()
    # union: [110, 140) + [150, 160) + [350, 390) + [395, 400) = 85 us
    assert busy == pytest.approx(85e-6)
    assert window == pytest.approx(400e-6)


def test_idle_share_by_kind():
    run = Run([], 0, trace=_trace(), peak_bytes_per_s=1e9)
    # enc: 100 us, busy 30 (kernels) + 10 (copy) = 40 -> 60% idle
    assert _read("device_idle_pct.enc", run) == pytest.approx(60.0)
    # dec: busy 40 + 5 -> 55% idle
    assert _read("device_idle_pct.dec", run) == pytest.approx(55.0)
    assert _read("device_idle_pct.req", run) == pytest.approx(57.5)
    assert _read("device_idle_pct.dec", Run([], 0)) is None


def test_roofline_counts_bytes_over_summed_kernel_time():
    run = Run([], 0, trace=_trace(), peak_bytes_per_s=1e9)
    # enc: 1300 bytes at 1e9 B/s = 1.3 us, over 40 us of kernels
    assert _read("enc_kernel_roofline", run) == pytest.approx(100 * 1.3 / 40)
    # no peak for the device: no reading, never 0
    assert _read("enc_kernel_roofline", Run([], 0, trace=_trace())) is None


def test_decode_roofline_counts_the_decompress_kernels_alone():
    run = Run([], 0, trace=_trace(), peak_bytes_per_s=1e9)
    # dec: 2400 bytes at 1e9 B/s = 2.4 us, over its 40 us kernel; the
    # compress span's kernels and the copy are not counted
    assert _read("dec_kernel_roofline", run) == pytest.approx(100 * 2.4 / 40)
    assert _read("dec_kernel_roofline", Run([], 0, trace=_trace())) is None
    assert _read("dec_kernel_roofline", Run([], 0)) is None
    no_dec = tracing.Trace([e for e in _trace_events()
                            if e["name"] != "lz4bench.dec#1"],
                           {0: (1000, 300), 1: (2000, 400)})
    assert _read("dec_kernel_roofline",
                 Run([], 0, trace=no_dec, peak_bytes_per_s=1e9)) is None


def test_judged_sample():
    assert harness.judged_sample([5, 7, 9], 1, budget=21) == [0, 1, 2]
    sizes = [10] * 50 + [40] + [10] * 50
    a = harness.judged_sample(sizes, 3_000_000_001, budget=200)
    assert 50 in a                                 # the largest
    assert sum(sizes[i] for i in a) == 200
    assert a == harness.judged_sample(sizes, 3_000_000_001, budget=200)
    assert a != harness.judged_sample(sizes, 3_000_000_002, budget=200)


def test_breakdown():
    bd = _trace().breakdown()
    ops = dict(bd["device_ops"])
    assert ops["tmap_gather_kernel"] == pytest.approx(40e-6)
    assert ops["enc_match_kernel"] == pytest.approx(20e-6)
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(10e-6)
    gaps = dict(bd["idle_gaps"])
    # enc idle: [100, 110) host, [140, 145) aten::to, [145, 150) and
    # [160, 165) aten::copy_, [165, 170) aten::to, [170, 200) host
    assert gaps["enc:host-python"] == pytest.approx(40e-6)
    assert gaps["enc:aten::to"] == pytest.approx(10e-6)
    assert gaps["enc:aten::copy_"] == pytest.approx(10e-6)
    # dec idle: [300, 350) and [390, 395); the op on another thread is
    # not the caller's
    assert gaps["dec:host-python"] == pytest.approx(55e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert all(isinstance(v, float) and math.isfinite(v)
               for _k, v in bd["device_ops"] + bd["idle_gaps"])


def _two_cards():
    """One compress over [100, 200) us on a mesh of two cards: card 0
    runs a kernel [110, 150), card 1 a kernel [120, 130) and a copy
    [180, 200); the window is the span."""
    ev = [
        _ev("user_annotation", "lz4bench.window", 100, 100),
        _ev("user_annotation", "lz4bench.enc#0", 100, 100),
        _ev("kernel", "enc_match_kernel", 110, 40, tid=7, device=0),
        _ev("kernel", "enc_match_kernel", 120, 10, tid=7, device=1),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 180, 20,
            tid=7, device=1, bytes=300),
    ]
    return ev, {0: (1000, 300)}


def test_idle_card_by_card_averaged():
    ev, calls = _two_cards()
    tr = tracing.Trace(ev, calls, [0, 1])
    assert tr.cards == [0, 1] == tracing.Trace(ev, calls).cards
    run = Run([], 0, trace=tr, peak_bytes_per_s=1e9)
    # card 0 idle 60 of 100 us, card 1 70: the mean, not the union's 40
    assert _read("device_idle_pct.enc", run) == pytest.approx(65.0)
    busy, window = tr.window_busy()
    assert busy == pytest.approx(35e-6) and window == pytest.approx(100e-6)
    assert 100 * (1 - busy / window) == pytest.approx(65.0)
    # some card busy over [110, 150) and [180, 200): 60 us of the 70
    # the two cards are busy in all, so they overlapped by 10
    assert tr.window_busy_union() == pytest.approx(60e-6)
    assert tr.busy_in(100, 200, None) == [[110, 150], [180, 200]]
    bd = tr.breakdown()
    assert dict(bd["idle_gaps"]) == pytest.approx({"enc:host-python": 65e-6})
    # device time adds the cards': card-seconds
    assert dict(bd["device_ops"]) == pytest.approx(
        {"enc_match_kernel": 50e-6, "Memcpy DtoH (Device -> Pageable)": 20e-6})
    assert tr.kernel_seconds(tr.spans) == pytest.approx(50e-6)
    assert _read("enc_kernel_roofline", run) == pytest.approx(100 * 1.3 / 50)


def test_a_card_with_no_operation_is_idle_throughout():
    ev, calls = _two_cards()
    tr = tracing.Trace(ev, calls, [0, 1, 2, 3])
    run = Run([], 0, trace=tr)
    assert _read("device_idle_pct.enc", run) == pytest.approx(
        (60 + 70 + 100 + 100) / 4)
    assert tr.window_busy()[0] == pytest.approx(70e-6 / 4)
    assert tr.window_busy_union() == pytest.approx(60e-6)
    card0 = [e for e in ev if e.get("args", {}).get("device") != 1]
    alone = tracing.Trace(card0, calls, [0, 1])
    assert _read("device_idle_pct.enc", Run([], 0, trace=alone)) == \
        pytest.approx((60 + 100) / 2)


def test_card_from_cupti_device_else_pid():
    assert tracing.card_of({"pid": 3, "args": {"device": 2}}) == 2
    assert tracing.card_of({"pid": 3, "args": {}}) == 3
    assert tracing.card_of({}) == 0


# -- one card: the reductions as they were before they went card by card,
#    kept as the oracle of the ones that did ----------------------------


def _union(tr, a, b):
    out = []
    for d in sorted(tr.device, key=lambda d: d.start):
        s, e = max(d.start, a), min(d.end, b)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _oracle(tr):
    """(idle share of each kind's spans, window_busy, breakdown) by the
    one-device formulas: the union of every operation's interval."""
    idle = {}
    for kind in ("enc", "dec", "req"):
        spans = tr.spans_of(kind)
        total = sum(s.end - s.start for s in spans)
        if total > 0:
            busy = sum(e - s for sp in spans
                       for s, e in _union(tr, sp.start, sp.end))
            idle[kind] = 100.0 * (total - busy) / total
    if tr.window is None:
        a = min((s.start for s in tr.spans), default=0.0)
        b = max((s.end for s in tr.spans), default=0.0)
    else:
        a, b = tr.window
    window = (1e-6 * sum(e - s for s, e in _union(tr, a, b)), 1e-6 * (b - a))
    wa, wb = tr.window or (float("-inf"), float("inf"))
    by_op, gaps = {}, {}
    for d in tr.device:
        if wa <= d.start <= wb:
            k = tracing.op_name(d.name)
            by_op[k] = by_op.get(k, 0.0) + 1e-6 * (d.end - d.start)
    for sp in tr.spans:
        t = sp.start
        for s, e in _union(tr, sp.start, sp.end) + [[sp.end, sp.end]]:
            if s > t:
                for label, sec in tr._attribute(t, s):
                    key = f"{sp.kind}:{label}"
                    gaps[key] = gaps.get(key, 0.0) + sec
            t = max(t, e)
    return idle, window, {"device_ops": tracing._top(by_op, 10),
                          "idle_gaps": tracing._top(gaps, 10)}


def _reduced(tr):
    """What ``_oracle`` gives, by the reductions; on one card the union
    over every card's operations is that card's busy time, exactly."""
    idle = {kind: tr.idle_share(tr.spans_of(kind))
            for kind in ("enc", "dec", "req")}
    busy, window = tr.window_busy()
    assert tr.window_busy_union() == busy
    return ({k: v for k, v in idle.items() if v is not None},
            (busy, window), tr.breakdown())


def test_one_card_equals_the_union_exactly():
    tr = _trace()
    assert tr.cards == [1]                      # the synthetic events' pid
    assert _reduced(tr) == _oracle(tr)          # to the last digit


def test_one_card_equals_the_union_on_a_cpu_run(monkeypatch):
    seen = []

    class Saving(tracing.Trace):
        def __init__(self, events, calls, cards=None):
            seen.append((events, calls, cards))
            super().__init__(events, calls, cards)

    monkeypatch.setattr(tracing, "Trace", Saving)
    r = harness.run_cell("hc9-64k.bulk", 20240601, 60.0, True, device="cpu",
                         mix_overrides={"corpus_bytes": 96 << 10},
                         workers=0, max_requests=4)
    assert r["correct"] and len(seen) == 1
    events, calls, cards = seen[0]
    assert cards is None and calls
    tr = tracing.Trace(events, calls, cards)
    assert tr.spans and tr.window
    assert _reduced(tr) == _oracle(tr)
    assert r["breakdown"] == _oracle(tr)[2]


def test_one_card_equals_the_union_on_an_h100_trace():
    """The first 60 calls of a traced ``hits-hc9.insert`` window on an
    H100 (``fixtures/insert_trace_h100.json.gz``: CUPTI's kernels and
    copies with their card, the torch operators, the spans)."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "insert_trace_h100.json.gz")
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    calls = {int(k): tuple(v) for k, v in data["calls"].items()}
    tr = tracing.Trace(data["events"], calls, [0])
    assert tr.cards == [0] == tracing.Trace(data["events"], calls).cards
    assert len(tr.spans) == 60 and len(tr.device) == 420
    assert _reduced(tr) == _oracle(tr)
    assert tr.kernel_seconds(tr.spans) > 0
