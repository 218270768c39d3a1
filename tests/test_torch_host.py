"""The port's own host layers (zig_lz4_tpu_torch: constants, errors,
xxhash32, ops/block, ops/hc, native, backend, stream, frame, models)
against the JAX package's originals they were copied from.

Tolerance: none.  Every comparison is exact equality of bytes, ints or
arrays on the same inputs, made from numpy seeds.  The port's native
runtime builds with g++ into ``zig_lz4_tpu_torch/_build/`` at first
use; the reference loads its own library.
"""

import os

import numpy as np
import pytest

import zig_lz4_tpu.frame as ref_frame
import zig_lz4_tpu_torch.frame as port_frame
from zig_lz4_tpu import backend as ref_backend
from zig_lz4_tpu import constants as ref_constants
from zig_lz4_tpu import errors as ref_errors
from zig_lz4_tpu import native as ref_native
from zig_lz4_tpu import version as ref_version
from zig_lz4_tpu.models import codec as ref_codec
from zig_lz4_tpu.ops import block as ref_block
from zig_lz4_tpu.ops import hc as ref_hc
from zig_lz4_tpu.utils import xxhash32 as ref_xxh
from zig_lz4_tpu_torch import backend as port_backend
from zig_lz4_tpu_torch import constants as port_constants
from zig_lz4_tpu_torch import errors as port_errors
from zig_lz4_tpu_torch import native as port_native
from zig_lz4_tpu_torch import version as port_version
from zig_lz4_tpu_torch.models import codec as port_codec
from zig_lz4_tpu_torch.ops import block as port_block
from zig_lz4_tpu_torch.ops import hc as port_hc
from zig_lz4_tpu_torch.utils import xxhash32 as port_xxh


def _inputs():
    """name -> bytes: text, runs, low entropy, random, tiny, empty and
    a mix, from numpy seeds."""
    rng = np.random.default_rng(1234)
    text = b"the quick brown fox jumps over the lazy dog, again and " * 300
    return {
        "text": text[:12_345],
        "rle": b"z" * 9_000,
        "period3": b"abc" * 3_000,
        "low_entropy": rng.integers(0, 4, 8_000, dtype=np.uint8).tobytes(),
        "random": rng.integers(0, 256, 5_000, dtype=np.uint8).tobytes(),
        "tiny": b"hello",
        "empty": b"",
        "mixed": (text[:700] + rng.integers(0, 256, 300, dtype=np.uint8)
                  .tobytes() + b"\x00" * 500) * 12,
    }


INPUTS = _inputs()
NAMES = sorted(INPUTS)


def _big() -> bytes:
    """~300 KB across several 64 KB blocks: repeats that reach back over
    block bounds, with incompressible stretches between them."""
    rng = np.random.default_rng(99)
    unit = b"history reaches back across the block bounds " * 300
    parts = []
    for i in range(20):
        parts.append(unit[:int(rng.integers(2_000, len(unit)))])
        if i % 6 == 0:
            parts.append(rng.integers(0, 256, 9_000, dtype=np.uint8)
                         .tobytes())
    return b"".join(parts)


def test_native_runtimes_load_from_their_own_places():
    assert ref_native.is_available() and port_native.is_available()
    build = os.path.join(os.path.dirname(port_native.__file__), os.pardir,
                         "_build")
    assert os.path.samefile(os.path.dirname(port_native._SO), build)
    assert os.path.exists(port_native._SO)
    assert not os.path.exists(os.path.join(
        os.path.dirname(port_native.__file__), "liblz4tpu_native.so"))


def test_constants_errors_version_equal():
    for name in ("MINMATCH", "MFLIMIT", "WINDOW_SIZE", "LZ4_MAX_INPUT_SIZE",
                 "LZ4_DISTANCE_MAX", "ACCELERATION_MAX"):
        assert getattr(port_constants, name) == getattr(ref_constants, name)
    for n in (0, 1, 255, 4096, 65536, 1 << 20, 4 << 20):
        assert port_constants.compress_bound(n) == \
            ref_constants.compress_bound(n)
    assert port_version.version_number() == ref_version.version_number()
    assert port_version.version_string() == ref_version.version_string()
    # the same error taxonomy, as classes of the port's own
    names = sorted(n for n in dir(ref_errors)
                   if isinstance(getattr(ref_errors, n), type)
                   and issubclass(getattr(ref_errors, n), Exception))
    assert names and "CorruptedData" in names
    for n in names:
        ref_cls, port_cls = getattr(ref_errors, n), getattr(port_errors, n)
        assert port_cls is not ref_cls
        assert [c.__name__ for c in port_cls.__mro__] == \
            [c.__name__ for c in ref_cls.__mro__]
    assert {k: v.__name__ for k, v in
            port_errors.BLOCK_ERROR_CODES.items()} == \
        {k: v.__name__ for k, v in ref_errors.BLOCK_ERROR_CODES.items()}


@pytest.mark.parametrize("name", NAMES)
def test_xxh32_equal(name):
    data = INPUTS[name]
    for seed in (0, 1, 0x9E3779B1):
        want = ref_xxh.xxh32(data, seed)
        assert port_xxh.xxh32(data, seed) == want
        assert port_xxh.xxh32_python(data, seed) == want
        assert port_native.native_xxh32(data, seed) == want


def test_xxh32_without_the_native_runtime(monkeypatch):
    """A runtime that did not load leaves ``native_xxh32`` returning
    None; the one-shot hash then runs in Python, at every length."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_tried", True)
    assert not port_native.is_available()
    for n in (0, 15, 255, 256, 257, 5000):
        data = bytes(range(256)) * 20
        assert port_xxh.xxh32(data[:n]) == port_xxh.xxh32_python(data[:n])
    assert type(port_xxh.xxh32_stream()).__name__ == "XXH32"


@pytest.mark.parametrize("name", NAMES)
def test_xxh32_stream_equal(name):
    data = INPUTS[name]
    rng = np.random.default_rng(len(data))
    cuts = sorted(int(c) for c in rng.integers(0, len(data) + 1, 5))
    a, b, c = ref_xxh.xxh32_stream(), port_xxh.xxh32_stream(), \
        port_xxh.XXH32()
    last = 0
    for cut in cuts + [len(data)]:
        for h in (a, b, c):
            h.update(data[last:cut])
        last = cut
        assert a.digest() == b.digest() == c.digest()
    assert b.digest() == ref_xxh.xxh32(data)


@pytest.mark.parametrize("accel", [1, 4, 32])
@pytest.mark.parametrize("name", NAMES)
def test_compress_fast_equal(name, accel):
    data = INPUTS[name]
    want = ref_block.compress_fast(data, accel)
    assert port_block.compress_fast(data, accel) == want
    assert port_backend.compress_fast(data, accel) == \
        ref_backend.compress_fast(data, accel) == want
    assert port_block.decompress_safe(want, len(data)) == data
    assert port_backend.decompress_safe(want, len(data)) == data


@pytest.mark.parametrize("level", [2, 9, 12])
@pytest.mark.parametrize("name", NAMES)
def test_compress_hc_equal(name, level):
    data = INPUTS[name]
    want = ref_hc.compress_hc(data, level)
    assert port_hc.compress_hc(data, level) == want
    assert port_hc.compress_hc_oracle(data[:3000], level) == \
        ref_hc.compress_hc_oracle(data[:3000], level)
    assert port_block.decompress_safe(want, len(data)) == data


def test_decompress_errors_equal_by_class_name():
    good = ref_block.compress_fast(INPUTS["text"])
    cases = [(good[:-3], len(INPUTS["text"])),          # truncated
             (good, 100),                               # output too small
             (bytes([0x10, 65, 0xFF, 0xFF, 0x00]), 64)]  # offset past start
    for comp, cap in cases:
        with pytest.raises(ref_errors.LZ4Error) as want:
            ref_block.decompress_safe(comp, cap)
        with pytest.raises(port_errors.LZ4Error) as got:
            port_block.decompress_safe(comp, cap)
        assert type(got.value).__name__ == type(want.value).__name__
        with pytest.raises(port_errors.LZ4Error) as got_n:
            port_backend.decompress_safe(comp, cap)
        assert type(got_n.value).__name__ == type(want.value).__name__


def test_dict_decode_equal():
    d = INPUTS["text"][:2000]
    data = INPUTS["text"][1000:6000]
    s_ref, s_port = ref_frame.Stream(), port_frame.Stream()
    s_ref.load_dict(d)
    s_port.load_dict(d)
    comp = s_ref.compress_fast_continue(data)
    assert s_port.compress_fast_continue(data) == comp
    assert port_block.decompress_safe_using_dict(comp, len(data), d) == data


@pytest.mark.parametrize("hist", [0, 777])
def test_native_resolve_tmap_equal(hist):
    blk = 4096
    datas = [INPUTS[n][:blk] for n in NAMES if INPUTS[n]]
    comps = [ref_hc.compress_hc(d, 9) for d in datas]
    if hist:        # matches that reach into a dictionary before the block
        d = INPUTS["text"][5000:5000 + hist]
        comps = []
        for data in datas:
            s = ref_frame.Stream()
            s.load_dict(d)
            comps.append(s.compress_fast_continue(data))
    lens = np.array([len(c) for c in comps], np.int64)
    offs = np.zeros_like(lens)
    offs[1:] = np.cumsum(lens)[:-1]
    args = (b"".join(comps), offs, lens, blk)
    T_r, ol_r = ref_native.native_resolve_tmap(
        *args, hist_len=hist, reuse_buffers=False)
    T_p, ol_p = port_native.native_resolve_tmap(
        *args, hist_len=hist, reuse_buffers=False)
    assert np.array_equal(ol_p, ol_r)
    assert [int(n) for n in ol_r] == [len(d) for d in datas]
    for k, n in enumerate(ol_r):
        assert np.array_equal(T_p[k, :n], T_r[k, :n])


@pytest.mark.parametrize("dict_len", [0, 1500])
def test_native_resolve_tmap_linked_equal(dict_len):
    bs, H = 65536, 65536
    data = _big()
    d = data[10_000:10_000 + dict_len]
    prefs = ref_frame.Preferences(frame_info=ref_frame.FrameInfo(
        block_mode=ref_frame.BlockMode.linked))
    fr = ref_frame.compress_frame(data, prefs, dictionary=d or None)
    _info, pos = ref_frame.parse_frame_header(fr)
    pays, raws = [], []
    while True:
        word = int.from_bytes(fr[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            break
        blen = word & 0x7FFFFFFF
        pays.append(fr[pos:pos + blen])
        raws.append(bool(word >> 31))
        pos += blen
    assert len(pays) >= 4
    lens = np.array([len(p) for p in pays], np.int64)
    offs = np.zeros_like(lens)
    offs[1:] = np.cumsum(lens)[:-1]
    args = (b"".join(pays), offs, lens, H + offs,
            np.array(raws, np.int8))
    kw = dict(dict_len=dict_len, total_cap=len(pays) * bs, blk_cap=bs,
              dict_base=H - dict_len)
    T_r, ol_r, total_r = ref_native.native_resolve_tmap_linked(*args, **kw)
    T_p, ol_p, total_p = port_native.native_resolve_tmap_linked(*args, **kw)
    assert total_p == total_r == len(data)
    assert np.array_equal(ol_p, ol_r)
    assert np.array_equal(T_p[:total_p], T_r[:total_r])
    # and the map is right: it rebuilds the input
    fetch = np.zeros(H + int(lens.sum()), np.uint8)
    if dict_len:
        fetch[H - dict_len:H] = np.frombuffer(d, np.uint8)
    fetch[H:] = np.frombuffer(args[0], np.uint8)
    assert fetch[T_p[:total_p]].tobytes() == data


def _prefs(mod, mode, level, block_checksum=False):
    return mod.Preferences(
        frame_info=mod.FrameInfo(
            block_size_id=mod.BlockSizeID.max64KB,
            block_mode=getattr(mod.BlockMode, mode),
            content_checksum=True, block_checksum=block_checksum),
        compression_level=level)


@pytest.mark.parametrize("with_dict", [False, True], ids=["nodict", "dict"])
@pytest.mark.parametrize("level", [0, 9])
@pytest.mark.parametrize("mode", ["linked", "independent"])
def test_host_frames_equal(mode, level, with_dict):
    data = _big()
    d = data[20_000:50_000] if with_dict else None
    want = ref_frame.compress_frame(data, _prefs(ref_frame, mode, level),
                                    dictionary=d)
    got = port_frame.compress_frame(data, _prefs(port_frame, mode, level),
                                    dictionary=d)
    assert got == want
    assert port_frame.decompress_frame(want, dictionary=d) == data
    assert ref_frame.decompress_frame(got, dictionary=d) == data
    info_p = port_frame.get_frame_info(got)
    info_r = ref_frame.get_frame_info(want)
    assert type(info_p) is not type(info_r)
    for f in ("block_size_id", "block_mode", "content_checksum",
              "frame_type", "content_size", "dict_id", "block_checksum"):
        assert int(getattr(info_p, f)) == int(getattr(info_r, f)), f


@pytest.mark.parametrize("name", NAMES)
def test_host_frames_small_inputs_equal(name):
    data = INPUTS[name]
    for mode in ("linked", "independent"):
        want = ref_frame.compress_frame(
            data, _prefs(ref_frame, mode, 3, block_checksum=True))
        assert port_frame.compress_frame(
            data, _prefs(port_frame, mode, 3, block_checksum=True)) == want
        assert port_frame.decompress_frame(want) == data


def test_frame_errors_equal_by_class_name():
    data = INPUTS["mixed"]
    fr = bytearray(ref_frame.compress_frame(
        data, _prefs(ref_frame, "independent", 0)))
    fr[len(fr) // 2] ^= 0x55
    for blob in (bytes(fr), bytes(fr[:40]), b"\x00\x01\x02\x03" * 4):
        with pytest.raises(ref_errors.LZ4Error) as want:
            ref_frame.decompress_frame(blob)
        with pytest.raises(port_errors.LZ4Error) as got:
            port_frame.decompress_frame(blob)
        assert type(got.value).__name__ == type(want.value).__name__


def test_stream_hc_and_fast_streams_equal():
    chunks = [INPUTS["text"][i:i + 3000] for i in range(0, 12_000, 3000)]
    for s_r, s_p, method in (
            (ref_frame.Stream(), port_frame.Stream(),
             "compress_fast_continue"),
            (ref_hc.StreamHC(9), port_hc.StreamHC(9), "compress_continue")):
        dec = port_frame.StreamDecode()
        for c in chunks:
            comp = getattr(s_r, method)(c)
            assert getattr(s_p, method)(c) == comp
            assert dec.decompress_continue(comp, len(c)) == c


@pytest.mark.parametrize("level", [-3, 0, 1, 2, 9, 12])
def test_get_codec_host_families_equal(level):
    data = INPUTS["mixed"]
    r, p = ref_codec.get_codec(level), port_codec.get_codec(level)
    assert type(p).__name__ == type(r).__name__
    comp = p.compress(data)
    assert comp == r.compress(data)
    assert p.decompress(comp, len(data)) == data
