"""``zig_lz4_tpu_torch.trace``: the frame codec's spans and counters.

On the CPU, at 4 KB blocks (the codec ``tests/test_torch_batch_blocks.py``
builds, level 9), over 8 KB: a block of text and one of random bytes,
which the store-uncompressed fallback keeps.  Off, nothing is
recorded and no ``record_function`` opens; under ``enable()`` and under
a CPU profiler the same calls record one root a call and its leaf
phases, the profiler's trace holds the ``lz4tpu.`` spans inside the
caller's, and the counters equal the bytes staged and the blocks
stored.  Frames and outputs are compared byte for byte with tracing on
and off.
"""

import json

import numpy as np
import pytest
import torch

import zig_lz4_tpu_torch.parallel.sharded as sharded
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch import trace

BLOCK = 4096
ENC_LEAVES = {"enc.windows", "enc.stage", "enc.launch", "enc.collect",
              "enc.payloads", "enc.checksum", "enc.assemble"}
DEC_LEAVES = {"dec.scan", "dec.resolve", "dec.fetch", "dec.stage",
              "dec.launch", "dec.collect", "dec.join", "dec.checksum"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _codec():
    codec = sharded.ShardedFrameCodec(device="cpu", compression_level=9)
    codec.block_size = codec.window = BLOCK
    return codec


@pytest.fixture(scope="module")
def data():
    text = (b"the quick brown fox jumps over the lazy dog, "
            b"0123456789 " * 100)[:BLOCK]
    noise = np.random.default_rng(20).integers(0, 256, BLOCK, np.uint8)
    return text + noise.tobytes()


@pytest.fixture(scope="module")
def untraced(data):
    """The frame and the decoded output with nothing recording."""
    codec = _codec()
    frame = codec.compress_frame(data)
    return frame, codec.decompress_frame(frame)


def _round_trip(data):
    codec = _codec()
    frame = codec.compress_frame(data)
    return codec, frame, codec.decompress_frame(frame)


def _count_record_functions(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return calls


def test_off_records_nothing(data, untraced, monkeypatch):
    calls = _count_record_functions(monkeypatch)
    _, frame, out = _round_trip(data)
    assert (frame, out) == untraced and out == data
    assert calls == []
    assert trace.totals() == {} and trace.counters() == {}
    assert trace.spans() == []


def _check_tree(spans):
    """One root a public call, its leaves under it, no deeper level;
    each root's leaves and self time add up to its time."""
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["compress_frame", "decompress_frame"]
    assert len({r.call for r in roots}) == 2
    for root, leaves_expected in zip(roots, (ENC_LEAVES, DEC_LEAVES)):
        leaves = [s for s in spans if s.call == root.call and s.parent]
        assert {s.parent for s in leaves} == {root.name}
        assert {s.name for s in leaves} == leaves_expected
        for s in leaves:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        ordered = sorted(leaves, key=lambda s: s.start_ns)
        for a, b in zip(ordered, ordered[1:]):
            assert a.end_ns <= b.start_ns         # leaves never nest
    totals = trace.totals()
    for root in roots:
        leaves = [s for s in spans if s.call == root.call and s.parent]
        t = totals[root.name]
        assert t["count"] == 1
        assert t["seconds"] == pytest.approx(
            1e-9 * (root.end_ns - root.start_ns), abs=1e-9)
        # the leaves' totals plus the root's self time are its total
        leaf_s = sum(totals[n]["seconds"] for n in {s.name for s in leaves})
        assert leaf_s + t["self_seconds"] == pytest.approx(t["seconds"],
                                                           abs=1e-9)
        for n in {s.name for s in leaves}:
            assert totals[n]["self_seconds"] == totals[n]["seconds"]
    return roots


def test_enable_records_calls(data, untraced, monkeypatch):
    calls = _count_record_functions(monkeypatch)
    trace.enable()
    _, frame, out = _round_trip(data)
    assert (frame, out) == untraced
    _check_tree(trace.spans())
    assert calls == []                  # no profiler: no record_function


def test_profiler_records_calls_on_its_clock(data, untraced, tmp_path,
                                             monkeypatch):
    calls = _count_record_functions(monkeypatch)
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer.enc"):
            codec = _codec()
            frame = codec.compress_frame(data)
        with torch.profiler.record_function("outer.dec"):
            out = codec.decompress_frame(frame)
    assert (frame, out) == untraced
    spans = trace.spans()
    with trace.span("after"):           # the profiler has stopped
        pass
    assert trace.spans() == spans
    _check_tree(spans)
    assert sorted(c for c in calls if c.startswith(trace.PREFIX)) == \
        sorted(trace.PREFIX + s.name for s in spans)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    outer = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in marks
             if e["name"].startswith("outer.")}
    ours = [e for e in marks if e["name"].startswith(trace.PREFIX)]
    assert sorted(e["name"] for e in ours) == sorted(
        trace.PREFIX + s.name for s in spans)
    for e in ours:
        kind = "enc" if e["name"] in (
            "lz4tpu.compress_frame",
            *(trace.PREFIX + n for n in ENC_LEAVES)) else "dec"
        a, b = outer[f"outer.{kind}"]
        assert a <= e["ts"] and e["ts"] + e["dur"] <= b


def test_staged_bytes_counted(data, monkeypatch):
    staged, copied = [], []
    encode_blocks = sharded.encode_blocks

    def counted(*args, **kwargs):
        staged.append(sum(a.nbytes for a in args))
        out = encode_blocks(*args, **kwargs)
        copied.append(sum(t.nbytes for t in out))
        return out
    monkeypatch.setattr(sharded, "encode_blocks", counted)
    trace.enable()
    _codec().compress_frame(data)
    c = trace.counters()
    assert staged and c["enc.h2d_bytes"] == sum(staged)
    assert c["enc.d2h_bytes"] == sum(copied)
    # two windows of 4 KB, a length and a start each
    assert c["enc.h2d_bytes"] == 2 * (BLOCK + 8)
    assert c["enc.input_bytes"] == len(data) and c["enc.blocks"] == 2


def test_stored_blocks_are_the_decoders_stored_route(data):
    trace.enable()
    codec, _frame, _out = _round_trip(data)
    assert trace.counters()["enc.stored_blocks"] == \
        codec.routes["stored"] == 1


def test_stitch_of_sub_spans(data, monkeypatch):
    """Blocks the encoder does not take whole run as sub-spans, joined
    by ``concat_streams`` under ``enc.stitch``; 2 KB sub-spans behind 1
    KB here, so that the plain encoder stays fast."""
    monkeypatch.setattr(sharded, "device_encoder_supports", lambda w: False)
    monkeypatch.setattr(sharded, "_SUB", 2048)
    monkeypatch.setattr(sharded, "_SUBH", 1024)
    off = _codec().compress_frame(data)
    trace.enable()
    on = _codec().compress_frame(data)
    assert on == off and lz4f.decompress_frame(on) == data
    totals = trace.totals()
    assert totals["enc.stitch"]["count"] == 1
    assert totals["enc.windows"]["count"] == 2   # the split, one launch group
    c = trace.counters()
    assert c["enc.h2d_bytes"] == 4 * (3072 + 8)
    # two blocks of two sub-spans: the first's tail of each is scanned
    assert c["enc.stitch_blocks"] == 2 and c["enc.stitch_scans"] == 2


@pytest.mark.parametrize("sub,scans", [(BLOCK, 0), (BLOCK // 2, 2),
                                       (BLOCK // 4, 6), (1000, 8)])
def test_stitch_counts_blocks_and_scans(data, untraced, monkeypatch, sub,
                                        scans):
    """``enc.stitch_blocks`` counts the blocks joined and
    ``enc.stitch_scans`` the parts whose tail was scanned: none of a
    block of one sub-span, which comes back as the encoder wrote it, and
    k - 1 of a block of k."""
    monkeypatch.setattr(sharded, "device_encoder_supports", lambda w: False)
    monkeypatch.setattr(sharded, "_SUB", sub)
    monkeypatch.setattr(sharded, "_SUBH", 1024)
    off = _codec().compress_frame(data)
    trace.enable()
    on = _codec().compress_frame(data)
    assert on == off and lz4f.decompress_frame(on) == data
    if sub == BLOCK:                 # one sub-span: the whole-block frame
        assert on == untraced[0]
    c = trace.counters()
    assert c["enc.stitch_blocks"] == 2 and c["enc.stitch_scans"] == scans
    assert trace.totals()["enc.stitch"]["count"] == 1


def test_reset_clears_everything(data):
    trace.enable()
    _round_trip(data)
    assert trace.totals() and trace.counters() and trace.spans()
    trace.reset()
    assert trace.totals() == {} and trace.counters() == {}
    assert trace.spans() == []
    trace.count("x", 2)
    with trace.span("root"):
        pass
    assert trace.counters() == {"x": 2}
    assert [(s.name, s.call, s.parent) for s in trace.spans()] == [
        ("root", 0, None)]
