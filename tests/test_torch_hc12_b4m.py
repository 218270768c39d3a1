"""``lz4 -12`` in 4 MB independent blocks (the benchmark's ``lz4hc12-b4m``)
through the port's frame codec.

On the CPU (``device="cpu"``, the plain versions of the deep kernels)
over a seeded corpus input of 600,000 bytes: one block of three
sub-span windows, the last one short.  The frame passes the
benchmark's plain reference (``lz4bench/reference.py``); every
compressed block keeps the LZ4 block format's end-of-block rules, which
the reference does not check (the last 5 bytes are literals; the last
match starts at least 12 bytes before the block's end), by the sequence
walker below, and blocks doctored to break them fail it; level 12
compresses better than level 9; and the deep-route counters
(``enc.deep_windows``, ``enc.deep_window_bytes``,
``enc.deep_payload_bytes``) equal what the encoder was handed and
returned at level 12 and stay 0 at levels 9 and 1.

The ``cuda`` case runs on the card (``python -m pytest --noconftest -m
cuda tests/test_torch_hc12_b4m.py``): the card's frame of the corpus's
first 4,194,304 + 600,000 bytes equals the CPU route's byte for byte,
and the 48 MiB frame the benchmark's cell compresses keeps both rules in
every block and passes the reference.
"""

import json
import os

import pytest
import torch

from lz4bench import harness, judge, reference
from lz4bench.corpus import make_corpus

import zig_lz4_tpu_torch.parallel.sharded as sharded
from zig_lz4_tpu_torch import ShardedFrameCodec, kernels, trace

CONFIG = json.load(open(os.path.join(harness.HERE, "configs",
                                     "lz4hc12-b4m.json")))
SIZE = 600_000
SEED = 7
#: the LZ4 block format's end-of-block rules
LAST_LITERALS = 5
MFLIMIT = 12
COUNTERS = ("enc.deep_windows", "enc.deep_window_bytes",
            "enc.deep_payload_bytes")


# -- the walker ----------------------------------------------------------------

def _length(payload, p: int, base: int) -> tuple[int, int]:
    n = base
    if base == 15:
        while True:
            b = payload[p]
            p += 1
            n += b
            if b != 255:
                break
    return n, p


def block_sequences(payload: bytes) -> list:
    """The sequences of one LZ4 block, as (literal bytes, offset, match
    length); the last has offset and match length 0."""
    seqs, p = [], 0
    while True:
        token = payload[p]
        lit, p = _length(payload, p + 1, token >> 4)
        literals = payload[p:p + lit]
        p += lit
        if p >= len(payload):
            seqs.append((literals, 0, 0))
            return seqs
        offset = payload[p] | payload[p + 1] << 8
        ml, p = _length(payload, p + 2, token & 15)
        seqs.append((literals, offset, ml + 4))


def end_of_block_faults(payload: bytes) -> list[str]:
    """Why the block breaks the format's end-of-block rules, or []."""
    seqs = block_sequences(payload)
    size = sum(len(lit) + ml for lit, _o, ml in seqs)
    faults = []
    last = len(seqs[-1][0])
    if last < min(LAST_LITERALS, size):
        faults.append(f"last literal run {last} of a {size}-byte block")
    if len(seqs) > 1:
        start = size - last - seqs[-2][2]
        if size - start < MFLIMIT:
            faults.append(f"last match starts {size - start} bytes before "
                          f"the end")
    return faults


def encode_sequences(seqs: list) -> bytes:
    """An LZ4 block of ``seqs`` as ``block_sequences`` gives them."""
    out = bytearray()

    def ext(n):
        while n >= 255:
            out.append(255)
            n -= 255
        out.append(n)

    for literals, offset, ml in seqs:
        lit, m = len(literals), ml - 4
        out.append(min(lit, 15) << 4 | (min(m, 15) if ml else 0))
        if lit >= 15:
            ext(lit - 15)
        out += literals
        if ml:
            out += offset.to_bytes(2, "little")
            if m >= 15:
                ext(m - 15)
    return bytes(out)


def compressed_blocks(frame: bytes) -> list:
    hdr, p = reference.parse_header(frame)
    records, _ = reference.read_blocks(frame, p, hdr.block_checksum)
    return [payload for payload, stored in records if not stored]


def _decoded_size(payload: bytes) -> int:
    out = bytearray()
    reference.decode_block(payload, out, 0, CONFIG["block_size"])
    return len(out)


# -- the CPU route -------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    does them in half the CPU time, so the suite's parallel workers do
    not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codec(level: int, device: str) -> ShardedFrameCodec:
    args = harness.codec_settings(CONFIG)
    args["compression_level"] = level
    return ShardedFrameCodec(device=device, **args)


@pytest.fixture(scope="module")
def data():
    return make_corpus(1 << 20, seed=SEED)[:SIZE]


@pytest.fixture(scope="module")
def runs(data):
    """level -> (frame, counters, [(window lengths, output lengths)] of
    each encoder launch), each compress recorded under ``enable()``."""
    handed = []
    real = sharded.encode_blocks

    def spy(blocks, lens, starts, **kw):
        out, out_len = real(blocks, lens, starts, **kw)
        handed.append((lens.tolist(), out_len.tolist()))
        return out, out_len

    sharded.encode_blocks = spy
    got = {}
    try:
        for level in (12, 9, 1):
            handed.clear()
            trace.reset()
            trace.enable()
            try:
                frame = _codec(level, "cpu").compress_frame(data)
            finally:
                trace.disable()
            got[level] = frame, trace.counters(), list(handed)
    finally:
        sharded.encode_blocks = real
        trace.reset()
    return got


def test_config_gives_the_deep_route():
    codec = _codec(CONFIG["compression_level"], "cpu")
    assert (codec.level, codec.hc, codec.deep) == (12, 8, 3)
    assert codec.block_size == 4 << 20
    assert not sharded.device_encoder_supports(codec.window)


def test_frame_passes_the_reference(runs, data):
    frame = runs[12][0]
    assert reference.check_frame(frame, data, CONFIG) == ""
    assert reference.decode_frames(frame)[0] == data


@pytest.mark.parametrize("level", [12, 9, 1])
def test_every_block_keeps_the_end_of_block_rules(runs, level):
    blocks = compressed_blocks(runs[level][0])
    assert blocks
    for payload in blocks:
        assert end_of_block_faults(payload) == []
        seqs = block_sequences(payload)
        assert sum(len(lit) + ml for lit, _o, ml in seqs) == \
            _decoded_size(payload)
        assert encode_sequences(seqs) == payload


def test_doctored_last_match_into_the_last_literals_fails(runs):
    payload = compressed_blocks(runs[12][0])[0]
    seqs = block_sequences(payload)
    last, (lit, off, ml) = seqs[-1][0], seqs[-2]
    assert len(last) >= LAST_LITERALS
    # the last match takes all but 2 of the last literals
    doctored = encode_sequences(
        seqs[:-2] + [(lit, off, ml + len(last) - 2), (last[-2:], 0, 0)])
    assert _decoded_size(doctored) == _decoded_size(payload)
    faults = end_of_block_faults(doctored)
    assert len(faults) == 1 and "last literal run 2" in faults[0]


@pytest.mark.parametrize("ml, fault", [
    (7, None),                       # starts 12 bytes before the end
    (6, "last match starts 11 bytes before the end"),
    (4, "last match starts 9 bytes before the end"),
])
def test_last_match_start_rule(ml, fault):
    block = encode_sequences([(b"abcdefgh", 8, ml), (b"vwxyz", 0, 0)])
    assert _decoded_size(block) == 8 + ml + 5
    assert end_of_block_faults(block) == ([fault] if fault else [])


def test_level_12_compresses_better_than_level_9(runs):
    assert len(runs[12][0]) < len(runs[9][0]) < len(runs[1][0])


def test_deep_counters_at_level_12(runs, data):
    _frame, counters, handed = runs[12]
    lens = [n for launch, _ in handed for n in launch]
    out = [n for _, launch in handed for n in launch]
    # one launch of three windows: 262,144 bytes, then 65,536 + 262,144
    # and 65,536 + the 75,712 left
    assert len(handed) == 1
    assert lens == [262144, 327680, 65536 + SIZE - 2 * 262144]
    assert counters["enc.deep_windows"] == 3
    assert counters["enc.deep_window_bytes"] == sum(lens)
    assert counters["enc.deep_payload_bytes"] == sum(out) > 0


@pytest.mark.parametrize("level", [9, 1])
def test_deep_counters_stay_zero_off_the_deep_route(runs, level):
    _frame, counters, handed = runs[level]
    assert handed and counters["enc.blocks"] == 1
    assert all(counters.get(k, 0) == 0 for k in COUNTERS)


def test_deep_counters_record_nothing_untraced(data):
    trace.reset()
    _codec(12, "cpu").compress_frame(data[:20_000])
    assert trace.counters() == {}


# -- the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_frame_equals_cpu_route_and_keeps_the_rules():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corpus = make_corpus(48 << 20, seed=3141593217)
    head = corpus[:(4 << 20) + SIZE]
    card = _codec(12, "cuda")
    torch.set_num_threads(os.cpu_count() or 1)
    assert card.compress_frame(head) == _codec(12, "cpu").compress_frame(head)

    kernels.reset_launch_counts()
    frame = card.compress_frame(corpus)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launched == {"enc_deep_match_wide": 1, "enc_deep_dp": 1,
                        "enc_deep_emit": 1}, launched
    blocks = compressed_blocks(frame)
    assert blocks
    for payload in blocks:
        assert end_of_block_faults(payload) == []
    assert judge.check_frames([(frame, corpus)], CONFIG,
                              min(os.cpu_count() or 1, 8)) == [""]
    assert card.decompress_frame(frame) == corpus
