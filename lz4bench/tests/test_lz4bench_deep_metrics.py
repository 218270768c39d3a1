"""The reader of ``enc_deep_kernel_roofline`` on a hand-made trace and
the port's recorder counters: the deep route's bytes at the peak over
the summed time of the ``enc_deep_*`` kernels in compress spans, a
call's share of each; other kernels ignored; None without a trace, a
peak, a deep kernel or the counters, and with a port that has no
recorder.  Then the cell that reports it, ``hc12-4m.bulk``, run whole on
the port's CPU route at a small size: sound, with a frame's byte
altered, and under the control."""

import sys

import pytest

from lz4bench import control, harness, tracing
from lz4bench.harness import Run

from zig_lz4_tpu_torch import trace

NAME = "enc_deep_kernel_roofline"
WINDOW_BYTES, PAYLOAD_BYTES = 62_128_128, 14_800_000
PEAK = 3.35e12


def _read(run):
    read, kind = harness.reader(NAME)
    return read(run, kind)


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {}}


def _trace(deep=True):
    """Two compress calls of [0, 1000) and [2000, 3000) us, each with
    the three deep kernels (60 + 10 + 5 us) or a 64 KB finder in their
    place, a wide finder of 40 us and a copy; a decompress span between
    them with a kernel of that name, and one after the window's last
    counted call."""
    ev = [_ev("user_annotation", "lz4bench.window", 0, 5000)]
    for n, t in ((0, 0), (2, 2000)):
        ev.append(_ev("user_annotation", f"lz4bench.enc#{n}", t, 1000))
        if deep:
            ev += [_ev("kernel", "void enc_deep_match_wide_kernel<3>"
                                 "(unsigned char const*)", t + 100, 60, 7),
                   _ev("kernel", "enc_deep_dp_kernel(int const*)",
                       t + 200, 10, 7),
                   _ev("kernel", "enc_deep_emit_kernel", t + 300, 5, 7)]
        else:
            ev.append(_ev("kernel", "enc_match_kernel<4>", t + 100, 75, 7))
        ev += [_ev("kernel", "enc_match_wide_kernel", t + 400, 40, 7),
               _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                   t + 500, 100, 7)]
    ev += [_ev("user_annotation", "lz4bench.dec#1", 1200, 500),
           _ev("kernel", "enc_deep_emit_kernel", 1300, 50, 7),
           _ev("user_annotation", "lz4bench.enc#3", 4000, 500),
           _ev("kernel", "enc_deep_match_wide_kernel", 4100, 300, 7)]
    return tracing.Trace(ev, {0: (50 << 20, 1), 1: (50 << 20, 1),
                              2: (50 << 20, 1)})


@pytest.fixture
def counted():
    """The recorder as two deep compress calls leave it."""
    trace.reset()
    trace.enable()
    for _ in range(2):
        with trace.span("compress_frame"):
            trace.count("enc.deep_windows", 192)
            trace.count("enc.deep_window_bytes", WINDOW_BYTES)
            trace.count("enc.deep_payload_bytes", PAYLOAD_BYTES)
    trace.disable()
    yield
    trace.reset()


def test_bytes_at_the_peak_over_the_deep_kernels(counted):
    assert trace.totals()["compress_frame"]["count"] == 2
    got = _read(Run([], 0, trace=_trace(), peak_bytes_per_s=PEAK))
    least = (WINDOW_BYTES + PAYLOAD_BYTES) / PEAK       # a call's
    assert got == pytest.approx(100 * least / 75e-6, rel=1e-12)
    assert 0 < got < 100


def test_other_kernels_and_spans_ignored(counted):
    run = Run([], 0, trace=_trace(), peak_bytes_per_s=PEAK)
    # the wide finder, the copy, the decompress span's kernel and the
    # span of a call not counted add nothing: a call's 75 us
    assert _read(run) == pytest.approx(
        100 * (WINDOW_BYTES + PAYLOAD_BYTES) / PEAK / 75e-6)


def test_none_without_trace_peak_or_deep_kernel(counted):
    assert _read(Run([], 0, peak_bytes_per_s=PEAK)) is None
    assert _read(Run([], 0, trace=_trace())) is None
    assert _read(Run([], 0, trace=_trace(deep=False),
                     peak_bytes_per_s=PEAK)) is None


@pytest.mark.parametrize("missing", ["enc.deep_window_bytes",
                                     "enc.deep_payload_bytes",
                                     "compress_frame"])
def test_none_without_counters(missing):
    trace.reset()
    trace.enable()
    if missing != "compress_frame":
        with trace.span("compress_frame"):
            pass
    for name, n in (("enc.deep_window_bytes", WINDOW_BYTES),
                    ("enc.deep_payload_bytes", PAYLOAD_BYTES)):
        if name != missing:
            trace.count(name, n)
    trace.disable()
    try:
        assert _read(Run([], 0, trace=_trace(),
                         peak_bytes_per_s=PEAK)) is None
    finally:
        trace.reset()


def test_none_from_a_port_without_the_recorder(monkeypatch):
    import zig_lz4_tpu_torch
    monkeypatch.delattr(zig_lz4_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "zig_lz4_tpu_torch.trace", None)
    assert _read(Run([], 0, trace=_trace(), peak_bytes_per_s=PEAK)) is None



CELL = "hc12-4m.bulk"


class _Altered:
    """The codec with one byte in the middle of each frame flipped."""

    def __init__(self, codec):
        self.codec = codec

    def compress_frame(self, data):
        frame = bytearray(self.codec.compress_frame(data))
        frame[len(frame) // 2] ^= 0x01
        return bytes(frame)

    def decompress_frame(self, frame):
        return self.codec.decompress_frame(frame)


@pytest.mark.parametrize("how", ["sound", "altered", "control"])
def test_deep_cell_whole_on_the_cpu(how):
    cfg = harness.cell_parts(harness.load_benchmark(), CELL)[1]
    r = harness.run_cell(
        CELL, 20240601, 60.0, False, device="cpu",
        mix_overrides={"corpus_bytes": 96 << 10}, workers=0, max_requests=4,
        wrap=_Altered if how == "altered" else None,
        settings=control.control_settings(cfg) if how == "control" else None)
    assert r["correct"] == (how == "sound"), (how, r["checks"])
    assert r["attempted"] == 4
    assert (r["failed"] == 0) == (how != "altered")
