"""The readers of the port's own spans and counters
(``zig_lz4_tpu_torch.trace``): each against the value computed by hand
from the recorder's raw spans and the staged shapes, after a small CPU
run of the frame codec under ``trace.enable()`` (compress and decompress
for the ``enc_*`` readers, decodes of a linked frame for the ``dec_*``
ones); None without a trace, with no ``compress_frame`` or
``decompress_frame`` recorded, and with a port that has no recorder
(the parent commit's)."""

import sys

import numpy as np
import pytest
import torch

from lz4bench import harness
from lz4bench.harness import Run

import zig_lz4_tpu_torch.parallel.sharded as sharded
from zig_lz4_tpu_torch import trace

NAMES = ["enc_frame_host_us", "enc_stitch_us", "enc_stage_us",
         "enc_staged_bytes_per_byte", "enc_kernel_wait_us",
         "enc_stored_block_pct"]
BLOCK = 4096
SUB, SUBH = 2048, 1024


def _read(name, run):
    read, kind = harness.reader(name)
    return read(run, kind)


@pytest.fixture
def recorded(monkeypatch):
    """Two round trips of 8 KB (a block of text, a block of random
    bytes) through 4 KB blocks encoded as 2 KB sub-spans behind 1 KB, so
    that every compress span runs, recorded under ``enable()``; yields
    (spans, input bytes, blocks) of the run."""
    monkeypatch.setattr(sharded, "device_encoder_supports", lambda w: False)
    monkeypatch.setattr(sharded, "_SUB", SUB)
    monkeypatch.setattr(sharded, "_SUBH", SUBH)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    text = (b"the quick brown fox jumps over the lazy dog " * 100)[:BLOCK]
    noise = np.random.default_rng(7).integers(0, 256, BLOCK, np.uint8)
    data = text + noise.tobytes()
    codec = sharded.ShardedFrameCodec(device="cpu", compression_level=9)
    codec.block_size = codec.window = BLOCK
    trace.reset()
    trace.enable()
    try:
        for _ in range(2):
            assert codec.decompress_frame(codec.compress_frame(data)) == data
        yield trace.spans(), 2 * len(data), 4
    finally:
        trace.disable()
        trace.reset()
        torch.set_num_threads(n)


def _us_per_call(spans, names):
    calls = sum(s.name == "compress_frame" for s in spans)
    return 1e-3 * sum(s.end_ns - s.start_ns for s in spans
                      if s.name in names) / calls


def test_readers_against_the_recorder(recorded):
    spans, content, blocks = recorded
    run = Run([], 0.0, trace=object())
    assert sum(s.name == "compress_frame" for s in spans) == 2
    want = {
        "enc_frame_host_us": _us_per_call(spans, {
            "enc.windows", "enc.payloads", "enc.assemble", "enc.checksum"}),
        "enc_stitch_us": _us_per_call(spans, {"enc.stitch"}),
        "enc_stage_us": _us_per_call(spans, {"enc.stage"}),
        "enc_kernel_wait_us": _us_per_call(spans, {"enc.launch",
                                                   "enc.collect"}),
        # a block of each call is random and stored as it is
        "enc_stored_block_pct": 100.0 * 2 / blocks,
    }
    # a call stages 4 windows of SUBH + SUB bytes, with a length and a
    # start each, and copies back each window's output buffer and length
    width = SUBH + SUB
    out_row = width + width // 255 + 16          # compress_bound(width)
    want["enc_staged_bytes_per_byte"] = (
        2 * 4 * (width + 8) + 2 * 4 * (out_row + 4)) / content
    for name in NAMES:
        got = _read(name, run)
        assert got == pytest.approx(want[name], rel=1e-9), name
        assert got > 0, name


@pytest.mark.parametrize("name", NAMES)
def test_none_without_trace_or_compress(name, recorded):
    assert _read(name, Run([], 0.0)) is None            # untraced run
    trace.reset()
    assert _read(name, Run([], 0.0, trace=object())) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_from_a_port_without_the_recorder(name, monkeypatch):
    import zig_lz4_tpu_torch
    monkeypatch.delattr(zig_lz4_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "zig_lz4_tpu_torch.trace", None)
    assert _read(name, Run([], 0.0, trace=object())) is None


DEC_NAMES = {"dec_resolve_us": "dec.resolve", "dec_stage_us": "dec.stage"}


@pytest.fixture
def linked_reads():
    """Two decodes of a linked frame of four 64 KB blocks (the host frame
    layer's), recorded under ``enable()``; yields the spans."""
    from zig_lz4_tpu_torch import frame as lz4f
    text = (b"the quick brown fox jumps over the lazy dog " * 6000
            )[:4 << 16]
    frame = lz4f.compress_frame(text, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(block_size_id=lz4f.BlockSizeID.max64KB,
                                  block_mode=lz4f.BlockMode.linked,
                                  content_checksum=True)))
    codec = sharded.ShardedFrameCodec(device="cpu")
    trace.reset()
    trace.enable()
    try:
        for _ in range(2):
            assert codec.decompress_frame(frame) == text
            assert codec.routes == {"linked": 4}
        yield trace.spans()
    finally:
        trace.disable()
        trace.reset()


@pytest.mark.parametrize("name", sorted(DEC_NAMES))
def test_decode_readers_against_the_recorder(name, linked_reads):
    spans = linked_reads
    calls = sum(s.name == "decompress_frame" for s in spans)
    assert calls == 2
    want = 1e-3 * sum(s.end_ns - s.start_ns for s in spans
                      if s.name == DEC_NAMES[name]) / calls
    got = _read(name, Run([], 0.0, trace=object()))
    assert got == pytest.approx(want, rel=1e-9) and got > 0
    assert _read(name, Run([], 0.0)) is None            # untraced run
    trace.reset()
    assert _read(name, Run([], 0.0, trace=object())) is None


@pytest.mark.parametrize("name", sorted(DEC_NAMES))
def test_decode_reader_none_without_decompress(name):
    trace.reset()
    trace.enable()
    with trace.span("compress_frame"):
        with trace.span("dec.resolve"):
            pass
    trace.disable()
    try:
        assert _read(name, Run([], 0.0, trace=object())) is None
    finally:
        trace.reset()


@pytest.mark.parametrize("name", sorted(DEC_NAMES))
def test_decode_reader_none_from_a_port_without_the_recorder(name,
                                                             monkeypatch):
    import zig_lz4_tpu_torch
    monkeypatch.delattr(zig_lz4_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "zig_lz4_tpu_torch.trace", None)
    assert _read(name, Run([], 0.0, trace=object())) is None
