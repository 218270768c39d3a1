"""The metric arithmetic: rate and ratio over the calls, idle share,
roofline and the breakdown from a synthetic profiler trace, and the
seeded sample of frames the reference judges."""

import math

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
    ev = [
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
    calls = {0: (1000, 300), 1: (2000, 400)}
    return tracing.Trace(ev, calls)


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
