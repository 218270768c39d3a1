"""Sub-span windows encoded at the width their launch group needs.

``ShardedFrameCodec`` encodes the blocks of 1 MB and 4 MB frames as
sub-span windows ``[history | span]`` of up to 327,680 bytes (``_SUBH +
_SUB``); a launch group whose windows are all shorter launches at the
``_sub_width`` of its longest, at least 69,632 bytes, so that it stays
on the wide finder (the encoder's rule, ``ops/torch_block.py``).  These
tests hold that the bytes do not change with the width:
``encode_blocks`` payloads at the rule's width against those at 327,680
bytes, on the plain versions (the CPU route) and on the kernels
(``cuda``), for window lengths from one byte to a full window and for
contents whose sort keys equal or follow the key of the bytes past a
window's end (``make_torch_goldens.ff_words``);
the port's frames of short inputs against the JAX reference's
(``tests/fixtures/narrow_frames.npz``, written by ``make_torch_goldens.py
narrow``); and the counter ``enc.narrow_windows``.  The deep levels keep
327,680 bytes.  Tolerance: none; bytes are compared exactly.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch import ShardedFrameCodec, trace
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb
from zig_lz4_tpu_torch.parallel import sharded

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens as mtg  # noqa: E402  (inputs of the goldens)

FULL = sharded._SUBH + sharded._SUB
LENGTHS = (1, 4093, 48771, 65536, 98304, 262144, FULL - 7)
CONTENTS = ("random", "zero", "ff", "ff_zero_words", "ff_words")
#: the cases the plain versions run on the CPU (about 1.4 s a window at
#: 327,680 bytes at level 9); the kernels run every case
CPU_CASES = ([(1, n, c) for n in (1, 65536, 98304, FULL - 7)
              for c in CONTENTS]
             + [(9, n, c) for n in (4093, 48771, 65536) for c in CONTENTS]
             + [(9, 98304, c) for c in CONTENTS[-2:]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the plain versions' many small ops, so
    that the suite's parallel workers do not contend for the cores."""
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


@pytest.fixture(scope="module")
def corpus2():
    return make_corpus(mtg.CORPUS_MB)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _content(name: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if name == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if name == "zero":
        return np.zeros(n, np.uint8)
    if name == "ff":
        return np.full(n, 255, np.uint8)
    if name == "ff_zero_words":      # the key of the bytes past the end
        words = np.tile(np.array([0xFFFFFFFF, 0, 0, 0], "<u4"), -(-n // 16))
        return np.frombuffer(words.tobytes()[:n], np.uint8)
    return np.frombuffer(mtg.ff_words(n), np.uint8)


def _start(n: int) -> int:
    """A window longer than a sub-span holds the history before it."""
    return sharded._SUBH if n > sharded._SUB else 0


def _payloads(names, n: int, width: int, level: int, dev="cpu"):
    hc, deep = tb.level_params(level)
    w = np.zeros((len(names), width), np.uint8)
    for k, name in enumerate(names):
        w[k, :n] = _content(name, n)
    lens = torch.full((len(names),), n, dtype=torch.int32)
    starts = torch.full((len(names),), _start(n), dtype=torch.int32)
    out, out_len = tb.encode_blocks(torch.from_numpy(w).to(dev),
                                    lens.to(dev), starts.to(dev),
                                    hc=hc, deep=deep)
    out, out_len = out.cpu(), out_len.cpu()
    assert not any(out[k, int(out_len[k]):].any() for k in range(len(names)))
    return [out[k, :int(out_len[k])].numpy().tobytes()
            for k in range(len(names))]


def _check_frame(corpus2: bytes, name: str, device) -> None:
    """Hold the port's frame of ``NARROW_FRAMES`` entry ``name`` on
    ``device`` to the golden's length and SHA-256, decode it, and count
    its windows in ``enc.narrow_windows`` (two for a block of two
    sub-spans)."""
    data = mtg.narrow_input(corpus2, name)
    codec = ShardedFrameCodec(device=device, compression_level=9,
                              block_size_id=lz4f.BlockSizeID.max1MB)
    trace.enable()
    frame = codec.compress_frame(data)
    with np.load(mtg.NARROW_OUT) as z:
        assert len(frame) == int(z[f"frame_{name}_len"])
        assert hashlib.sha256(frame).hexdigest() == \
            str(z[f"frame_{name}_sha256"])
    assert lz4f.decompress_frame(frame) == data
    narrow = 2 if len(data) > sharded._SUB else 1
    assert trace.counters()["enc.narrow_windows"] == narrow


def test_the_width_rule():
    """The least multiple of 4,096 at least 16 bytes past the longest
    window, at least 69,632 (the wide finder) and at most 327,680; the
    full width at the deep levels."""
    assert tb._MAX_SHARED_BLK < tb._FIT_MIN == 69632
    for n, want in ((1, 69632), (48771, 69632), (65536, 69632),
                    (69616, 69632), (69617, 73728), (98304, 102400),
                    (262144, 266240), (65536 + 237568, 307200),
                    (FULL - 16, FULL), (FULL - 7, FULL), (FULL, FULL)):
        assert tb._sub_width(n, FULL) == want, n
        assert want >= min(n + 16, FULL) and want % 4096 == 0
        assert all(tb._sub_width(n, FULL, deep) == FULL
                   for deep in (1, 2, 3))


@pytest.mark.parametrize("level,n,content", CPU_CASES)
def test_plain_payloads_do_not_depend_on_the_width(level, n, content):
    width = tb._sub_width(n, FULL)
    if width == FULL:                # the cap: launched as it always was
        assert n + tb._FIT_PAD > FULL
        return
    assert _payloads([content], n, width, level) == \
        _payloads([content], n, FULL, level)


@pytest.mark.parametrize("name", sorted(mtg.NARROW_FRAMES))
def test_frames_equal_the_reference_frames(name, corpus2):
    """The port's level-9 frame at 1 MB blocks of an input shorter than
    a sub-span window, launched narrower than the reference's, equals
    the JAX codec's byte for byte; ``enc.narrow_windows`` counts its
    windows (two for the 499,712-byte block)."""
    _check_frame(corpus2, name, "cpu")


def test_full_windows_count_no_narrow_window():
    """4 MB in one 4 MB block: sixteen sub-span windows in one launch
    group, which holds full windows, so it launches at 327,680 bytes and
    ``enc.narrow_windows`` stays 0."""
    data = make_corpus(5)[:4 << 20]
    codec = ShardedFrameCodec(device="cpu", compression_level=1,
                              block_size_id=lz4f.BlockSizeID.max4MB)
    trace.enable()
    frame = codec.compress_frame(data)
    assert lz4f.decompress_frame(frame) == data
    c = trace.counters()
    assert c.get("enc.narrow_windows", 0) == 0
    assert c["enc.h2d_bytes"] == 16 * (FULL + 8)


def test_deep_levels_launch_the_full_width():
    """At level 12 a short input's window keeps 327,680 bytes."""
    codec = ShardedFrameCodec(device="cpu", compression_level=12,
                              block_size_id=lz4f.BlockSizeID.max1MB)
    data = _content("ff_words", 4093).tobytes()
    trace.enable()
    frame = codec.compress_frame(data)
    assert lz4f.decompress_frame(frame) == data
    c = trace.counters()
    assert c.get("enc.narrow_windows", 0) == 0
    assert c["enc.h2d_bytes"] == FULL + 8


@pytest.mark.cuda
@pytest.mark.parametrize("level,n", [(lv, n) for lv in (1, 9)
                                     for n in LENGTHS])
def test_kernel_payloads_do_not_depend_on_the_width(cuda, level, n):
    """Every content at once, at the rule's width and at 327,680 bytes,
    on ``enc_match_wide`` (at hc 0 for level 1) and ``enc_parse_emit``;
    at level 9 the first two contents against the plain route too."""
    width = tb._sub_width(n, FULL)
    got = _payloads(CONTENTS, n, width, level, cuda)
    assert got == _payloads(CONTENTS, n, FULL, level, cuda)
    if width < FULL and level == 9:  # and the plain route's bytes
        assert got[:2] == _payloads(CONTENTS[:2], n, width, level)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(mtg.NARROW_FRAMES))
def test_card_frames_equal_the_reference_frames(cuda, name, corpus2):
    _check_frame(corpus2, name, cuda)
