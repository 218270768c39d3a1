"""The plain reference: xxh32 against the published vectors, the
decoder against the golden frames, and the judgement of frames the
port writes on its CPU route."""

import importlib.util
import os
import subprocess
import sys

import pytest

from lz4bench import harness, judge, reference as R

ROOT = harness.ROOT
FIX = os.path.join(ROOT, "tests", "fixtures")
CFG64 = dict(block_size=65536, independent_blocks=True,
             content_checksum=True, block_checksum=False, content_size=True)


def _goldens():
    spec = importlib.util.spec_from_file_location(
        "make_goldens", os.path.join(FIX, "make_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLD = _goldens()


@pytest.mark.parametrize("data,seed,want", [
    (b"", 0, 0x02CC5D05), (b"", 1, 0x0B2CB792),
    (b"a", 0, 0x550D7456), (b"abc", 0, 0x32D153FF),
    (b"Nobody inspects the spammish repetition", 0, 0xE2293B2F),
])
def test_xxh32_published_vectors(data, seed, want):
    assert R.xxh32(data, seed) == want


def test_xxh32_against_the_ports_and_lanes():
    from zig_lz4_tpu_torch.utils.xxhash32 import xxh32_python
    import random
    rnd = random.Random(5)
    for n in (0, 3, 15, 16, 17, 63, 64, 65, 1000, 4099):
        b = bytes(rnd.randrange(256) for _ in range(n))
        assert R.xxh32(b) == xxh32_python(b) == GOLD.xxh32(b), n
        assert R.xxh32(b, 77) == xxh32_python(b, 77)
        lanes = [R.xxh32_lane(R.lane_words(b, k), k) for k in range(4)]
        assert R.xxh32_join(lanes, b) == R.xxh32(b)


@pytest.mark.parametrize("name", sorted(GOLD.build()))
def test_golden_frames_decode(name):
    _blob, content = GOLD.build()[name]
    dictionary = (b"0123456789abcdefghijklmnopqrstuvwxyz" * 4
                  if name == "dict_frame.lz4" else b"")
    with open(os.path.join(FIX, name), "rb") as f:
        got, _frames = R.decode_frames(f.read(), dictionary)
    assert got == content


@pytest.mark.parametrize("name", sorted(GOLD.build_negatives()))
def test_golden_negatives_rejected(name):
    with open(os.path.join(FIX, name), "rb") as f:
        with pytest.raises(R.FrameError):
            R.decode_frames(f.read())


@pytest.fixture(scope="module")
def port_frame():
    """A frame the port's CPU route writes: 200 KB of the corpus at
    level 9 in 64 KB blocks, with stored blocks among them."""
    from lz4bench.corpus import make_corpus
    from zig_lz4_tpu_torch import ShardedFrameCodec
    src = make_corpus(1 << 18, 99)[:200_000]
    codec = ShardedFrameCodec(device="cpu", compression_level=9,
                              block_size_id=4, content_checksum=True)
    return codec.compress_frame(src), src


def test_port_frame_is_judged_sound(port_frame):
    frame, src = port_frame
    assert R.check_frame(frame, src, CFG64) == ""
    assert R.decode_frames(frame)[0] == src


def _flip(frame, at):
    b = bytearray(frame)
    b[at] ^= 0x01
    return bytes(b)


def test_broken_frames_rejected(port_frame):
    frame, src = port_frame
    hdr_end = 7 + 8
    cases = {
        "payload byte": _flip(frame, hdr_end + 4 + 100),
        "content checksum": _flip(frame, len(frame) - 1),
        "header checksum": _flip(frame, hdr_end - 1),
        "truncated": frame[:-9],
        "trailing bytes": frame + b"\0",
    }
    for what, bad in cases.items():
        assert R.check_frame(bad, src, CFG64) != "", what
    # a payload that ends on a match is refused, not a crash
    out = bytearray(b"abcd")
    with pytest.raises(R.FrameError):
        R.decode_block(bytes([0x40]) + b"abcd" + b"\x04\x00", out, 0, 64)
    # another source, the same length
    other = bytes(len(src))
    assert R.check_frame(frame, other, CFG64) != ""
    # the frame is not what another configuration states
    for key, value in (("block_size", 262144), ("content_checksum", False),
                       ("independent_blocks", False)):
        assert R.check_frame(frame, src, dict(CFG64, **{key: value})) != ""


def test_blocks_not_cut_at_the_block_size():
    from zig_lz4_tpu_torch import frame as lz4f
    src = bytes(range(256)) * 600
    # one stored block of 100 KB declared as 256 KB blocks: not 64 KB
    fr = lz4f.compress_frame(src, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(block_size_id=lz4f.BlockSizeID.max256KB,
                                  content_checksum=True,
                                  content_size=len(src))))
    cfg = dict(CFG64, block_size=262144)
    assert "block" in R.check_frame(fr, src, cfg) or \
        "FLG" in R.check_frame(fr, src, cfg)


def test_judge_in_parts_equals_whole(port_frame, monkeypatch):
    frame, src = port_frame
    monkeypatch.setattr(judge, "SPLIT_BYTES", 1)
    bad = _flip(frame, 7 + 8 + 4 + 100)
    got = judge.check_frames([(frame, memoryview(src)), (bad, src),
                              (frame, src[:-1])], CFG64, workers=0)
    assert got[0] == "" and got[1] != "" and got[2] != ""


def test_linked_frame_judged_in_parts_as_whole(monkeypatch):
    """A linked frame's groups, each behind the source's 64 KB before
    it, give the verdict the whole frame decoded in order gives."""
    from lz4bench.corpus import make_corpus
    from zig_lz4_tpu_torch import frame as lz4f
    src = make_corpus(1 << 19, 17)[:400_000]
    frame = lz4f.compress_frame(src, lz4f.Preferences(frame_info=lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID.max64KB,
        block_mode=lz4f.BlockMode.linked, content_checksum=True,
        content_size=len(src))))
    cfg = dict(CFG64, independent_blocks=False)
    hdr, p = R.parse_header(frame)
    records, _end = R.read_blocks(frame, p, False)
    assert len(records) == 7
    with pytest.raises(R.FrameError):       # its blocks reach back
        R.decode_records(records, True, hdr.block_max)
    monkeypatch.setattr(judge, "SPLIT_BYTES", 1)
    # a payload byte in the fifth block, another source, the other mode
    at = p + sum(4 + len(pl) for pl, _st in records[:4]) + 4 + 200
    items = [(frame, src), (_flip(frame, at), src),
             (frame, src[:100_000] + bytes(300_000)),
             (frame, src)]
    configs = [cfg, cfg, cfg, CFG64]
    for workers in (1, 3, 8):
        got = [judge.check_frames([it], c, workers=0) if workers == 1 else
               _in_groups(it, c, workers)
               for it, c in zip(items, configs)]
        want = [R.check_frame(f, s_, c) for (f, s_), c in zip(items, configs)]
        assert [g[0] == "" for g in got] == [w == "" for w in want] == \
            [True, False, False, False], workers


def _in_groups(item, config, n):
    """``check_frames`` of ``item`` cut into ``n`` groups, in this
    process."""
    job = judge._submit(judge._Inline(), item[0], item[1], config, n)
    return [judge._collect(job, config)]


def test_judge_worker_processes(port_frame, tmp_path):
    """The judge's worker processes start, judge and end."""
    frame, src = port_frame
    (tmp_path / "f").write_bytes(frame)
    (tmp_path / "s").write_bytes(src)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from lz4bench import judge\n"
        "if __name__ == '__main__':\n"
        "    judge.SPLIT_BYTES = 1\n"
        "    f = open(%r, 'rb').read(); s = open(%r, 'rb').read()\n"
        "    bad = bytearray(f); bad[120] ^= 1\n"
        "    cfg = dict(block_size=65536, independent_blocks=True,\n"
        "               content_checksum=True, block_checksum=False,\n"
        "               content_size=True)\n"
        "    r = judge.check_frames([(f, s), (bytes(bad), s)], cfg, 2)\n"
        "    print(r[0] == '' and r[1] != '')\n"
        % (ROOT, str(tmp_path / "f"), str(tmp_path / "s")))
    script = tmp_path / "judge_pool.py"
    script.write_text(code)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "True"
