"""The port's frame codec (zig_lz4_tpu_torch.ShardedFrameCodec) against
the JAX one (zig_lz4_tpu.parallel.ShardedFrameCodec), end to end.

Encode: both codecs at levels 12, 9, 5 and 0 with
``block_size``/``window`` shrunk to 4 KB (as tests/test_parallel.py:48-49
shrinks them).  The JAX codec's frames come from
``tests/fixtures/l9_frames4k.npz``, ``levels_frames4k.npz`` and
``deep_frames4k.npz``, written by
``tests/fixtures/make_torch_goldens.py``: a live JAX encode would cost
this file encoder compiles beside test_torch_encode.py's.  The JAX
codec decodes the port's frames live.  Decode: independent, linked and
dictionary frames written by the host frame layer, decoded by both
codecs; independent frames again with the native runtime taken away,
through the sequence-rebuild decoder, and single blocks through
``CUDACodec``.  The port runs on ``device="cpu"``: the plain versions of its
kernels.  The fragment-ladder engines ("win", "chase", "mixed") decode
the JAX codec's frames at levels 0 and 9, host frames of 64 KB, 256 KB
and 1 MB blocks and a dictionary frame; each block's route (tier and
engine) is held against the tier membership computed with the
reference's own resolver, predicates and tier tables, as its
single-device branch computes it.  Tolerance: none; frames and contents
are compared byte for byte, and errors by the name of the exception
class (the two packages share no class).
"""

import os
import sys

import numpy as np
import pytest
import torch

import zig_lz4_tpu.errors as ref_errors
import zig_lz4_tpu.frame as ref_frame
from zig_lz4_tpu_torch import ShardedFrameCodec, get_codec
from zig_lz4_tpu_torch import errors as E
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.models import CUDACodec
from zig_lz4_tpu_torch.ops import torch_block as tb
from zig_lz4_tpu_torch.ops.block import compress_fast, decompress_safe
from zig_lz4_tpu_torch.parallel.sharded import _scan_blocks

SMALL = 4096

_FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
sys.path.insert(0, _FIXDIR)
import make_goldens  # noqa: E402  (the independent spec oracle)
import make_torch_goldens  # noqa: E402  (the JAX codec's frames)

_GOLDENS = make_goldens.build()
_NEGATIVES = make_goldens.build_negatives()
#: golden frames that decode against a dictionary: name -> dictionary
#: (tests/fixtures/make_goldens.py:266)
_GOLDEN_DICTS = {"dict_frame.lz4": b"0123456789abcdefghijklmnopqrstuvwxyz" * 4}
CORPUS = ("hello", "repeated", "lorem", "random256", "empty", "ramp",
          "tiny", "rle", "mixed")


def _multi() -> bytes:
    """11 blocks of 4 KB across the text/XML boundary of the corpus."""
    return make_corpus(make_torch_goldens.CORPUS_MB)[make_torch_goldens.MULTI]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    does them in half the CPU time, so the suite's parallel workers do
    not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codecs():
    pytest.importorskip("jax")
    from zig_lz4_tpu.parallel import ShardedFrameCodec as JaxCodec
    ref = JaxCodec(compression_level=9)
    ref.block_size = ref.window = SMALL
    return ref, ShardedFrameCodec.from_reference(ref, device="cpu")


@pytest.fixture(scope="module")
def jax_frames():
    with np.load(make_torch_goldens.FRAMES_OUT) as z:
        return {k: z[k].tobytes() for k in z.files}


@pytest.fixture(scope="module")
def jax_level_frames():
    """``l<level>_<name>`` -> the JAX codec's frame at levels 0 and 5."""
    with np.load(make_torch_goldens.LEVEL_FRAMES_OUT) as z:
        return {k: z[k].tobytes() for k in z.files}


@pytest.fixture(scope="module")
def jax_codec():
    pytest.importorskip("jax")
    from zig_lz4_tpu.parallel import ShardedFrameCodec as JaxCodec
    return JaxCodec


@pytest.fixture(scope="module")
def port():
    return ShardedFrameCodec(compression_level=9, device="cpu")


@pytest.mark.parametrize("name", CORPUS + ("multi",))
def test_frames_identical_and_cross_decode(name, corpus, codecs,
                                           jax_frames):
    ref, port4k = codecs
    data = _multi() if name == "multi" else corpus[name]
    frame_ref = jax_frames[name]
    assert lz4f.decompress_frame(frame_ref) == data   # golden of this input
    frame = port4k.compress_frame(data)
    assert frame == frame_ref
    assert port4k.decompress_frame(frame_ref) == data
    assert ref.decompress_frame(frame) == data


@pytest.mark.parametrize("level", make_torch_goldens.FRAME_LEVELS)
@pytest.mark.parametrize("name", CORPUS + ("multi",))
def test_level_frames_identical_and_cross_decode(name, level, corpus,
                                                 codecs, jax_level_frames):
    ref, _port9 = codecs
    data = _multi() if name == "multi" else corpus[name]
    frame_ref = jax_level_frames[f"l{level}_{name}"]
    assert ref_frame.decompress_frame(frame_ref) == data
    port4k = ShardedFrameCodec(compression_level=level, device="cpu")
    port4k.block_size = port4k.window = SMALL
    frame = port4k.compress_frame(data)
    assert frame == frame_ref
    assert port4k.decompress_frame(frame_ref) == data
    assert ref.decompress_frame(frame) == data


@pytest.fixture(scope="module")
def jax_deep_frames():
    """``l12_<name>`` -> the JAX codec's frame at level 12."""
    with np.load(make_torch_goldens.DEEP_FRAMES_OUT) as z:
        return {k: z[k].tobytes() for k in z.files}


@pytest.mark.parametrize("name", CORPUS + ("multi",))
def test_deep_frames_identical_and_cross_decode(name, corpus, codecs,
                                                jax_deep_frames):
    ref, _port9 = codecs
    data = _multi() if name == "multi" else corpus[name]
    frame_ref = jax_deep_frames[f"l12_{name}"]
    assert ref_frame.decompress_frame(frame_ref) == data
    port4k = ShardedFrameCodec(compression_level=12, device="cpu")
    port4k.block_size = port4k.window = SMALL
    frame = port4k.compress_frame(data)
    assert frame == frame_ref
    assert port4k.decompress_frame(frame_ref) == data
    assert ref.decompress_frame(frame) == data


@pytest.mark.parametrize("level", [0, 1, 2, 9, 10, 11, 12, 13])
def test_from_reference_carries_level(level, jax_codec):
    """``level``, ``hc`` and ``deep`` of both codecs agree
    (tests/test_parallel.py:146-158)."""
    ref = jax_codec(compression_level=level)
    port = ShardedFrameCodec.from_reference(ref, device="cpu")
    assert (port.level, port.hc, port.deep) == (ref.level, ref.hc, ref.deep)
    assert (port.hc, port.deep) == tb.level_params(level)
    same = ShardedFrameCodec(compression_level=level, device="cpu")
    assert (same.level, same.hc, same.deep) == (port.level, port.hc,
                                                port.deep)


def test_frame_goldens_cover_every_input(jax_frames, jax_level_frames,
                                         jax_deep_frames):
    assert set(jax_deep_frames) == {f"l12_{name}"
                                    for name in CORPUS + ("multi",)}
    assert set(jax_frames) == set(CORPUS) | {"multi"}
    assert set(jax_level_frames) == {
        f"l{level}_{name}" for level in make_torch_goldens.FRAME_LEVELS
        for name in CORPUS + ("multi",)}


@pytest.mark.parametrize("name", sorted(_GOLDENS))
def test_port_decodes_golden_fixtures(name):
    blob, content = _GOLDENS[name]
    with open(os.path.join(_FIXDIR, name), "rb") as f:
        assert f.read() == blob
    port = ShardedFrameCodec(compression_level=9, device="cpu",
                             dictionary=_GOLDEN_DICTS.get(name))
    assert port.decompress_frame(blob) == content


def test_port_roundtrip_64k_blocks(port):
    data = make_corpus(2)[5 * 65536 - 30_000:5 * 65536 + 100_000]
    frame = port.compress_frame(data)
    assert lz4f.decompress_frame(frame) == data
    assert port.decompress_frame(frame) == data
    host = lz4f.compress_frame(data, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(block_mode=lz4f.BlockMode.independent,
                                  content_checksum=True)))
    assert port.decompress_frame(host) == data


def _raises_like(ref, port_codec, blob):
    """Both codecs reject ``blob`` with the error class of the same
    name, each of its own package; returns the port's exception."""
    with pytest.raises(ref_errors.LZ4Error) as want:
        ref.decompress_frame(blob)
    with pytest.raises(E.LZ4Error) as got:
        port_codec.decompress_frame(blob)
    assert type(got.value).__name__ == want.type.__name__
    assert type(got.value) is getattr(E, want.type.__name__)
    return got.value


@pytest.mark.parametrize("name", sorted(_NEGATIVES))
def test_negative_goldens_raise_reference_class(name, codecs):
    ref, port4k = codecs
    _raises_like(ref, port4k, _NEGATIVES[name][0])


def test_corrupt_block_names_frame_block(codecs):
    ref, port4k = codecs
    bad = bytes([0x10, ord("A"), 0xFF, 0xFF, 0x00])   # offset past output
    blob = make_goldens.frame([(b"stored block", True), (bad, False)])
    exc = _raises_like(ref, port4k, blob)
    assert isinstance(exc, E.CorruptedData)
    assert "frame block 1" in str(exc)


def test_block_past_frame_block_size_raises(codecs):
    ref, port4k = codecs
    blob = make_goldens.frame([(compress_fast(b"ab" * 65536), False)])
    exc = _raises_like(ref, port4k, blob)
    assert isinstance(exc, E.CorruptedData)
    assert "frame block 0" in str(exc)


def test_outside_the_slice_raises_not_implemented(port):
    """Dictionary encode and 256 KB blocks encode now, to the JAX
    codec's frames (``tests/fixtures/wide_corpus.npz``), and so do the
    deep levels at windows over 64 KB (``wide_deep_frames.npz``)."""
    with np.load(make_torch_goldens.WIDE_OUT) as z:
        want = {k: z[f"frame_{k}"].tobytes()
                for k in make_torch_goldens.WIDE_SMALL}
    with np.load(make_torch_goldens.WIDE_DEEP_FRAMES_OUT) as z:
        want.update({k: z[f"frame_{k}"].tobytes()
                     for k in ("small_dict_l10", "small_256k_l12")})
    data, _bs, level, dct = make_torch_goldens.WIDE_SMALL["small_dict"]
    frame = ShardedFrameCodec(dictionary=dct, device="cpu"
                              ).compress_frame(data)
    assert level == 0 and frame == want["small_dict"]
    assert lz4f.decompress_frame(frame, dictionary=dct) == data
    frame = ShardedFrameCodec(dictionary=dct, device="cpu",
                              compression_level=10).compress_frame(data)
    assert frame == want["small_dict_l10"]
    assert lz4f.decompress_frame(frame, dictionary=dct) == data
    # the fragment-ladder engines decode
    win = ShardedFrameCodec(decode_engine="win", device="cpu")
    blob, content = _GOLDENS["periodic_match.lz4"]
    assert win.decompress_frame(blob) == content
    assert sum(win.tier_members.values()) == 1 and "tmap" not in win.routes
    with pytest.raises(ValueError):
        ShardedFrameCodec(decode_engine="bogus", device="cpu")
    data, _bs, level, _d = make_torch_goldens.WIDE_SMALL["small_256k"]
    frame = ShardedFrameCodec(compression_level=level, device="cpu",
                              block_size_id=lz4f.BlockSizeID.max256KB
                              ).compress_frame(data)
    assert frame == want["small_256k"]
    frame = ShardedFrameCodec(compression_level=12, device="cpu",
                              block_size_id=lz4f.BlockSizeID.max256KB
                              ).compress_frame(data)
    assert frame == want["small_256k_l12"]
    assert lz4f.decompress_frame(frame) == data
    # what the slices brought in no longer raises
    assert CUDACodec(device="cpu").decompress(b"\x00", 16) == b""
    frame = ShardedFrameCodec(compression_level=12, device="cpu"
                              ).compress_frame(b"deep level " * 40)
    assert lz4f.decompress_frame(frame) == b"deep level " * 40
    assert port.decompress_frame(_GOLDENS["linked_blocks.lz4"][0]) == \
        _GOLDENS["linked_blocks.lz4"][1]
    frame = ShardedFrameCodec(device="cpu").compress_frame(b"level 0")
    assert lz4f.decompress_frame(frame) == b"level 0"


# -- linked frames and dictionaries -----------------------------------

def _linked_data(n: int, seed: int = 17) -> bytes:
    """Repeats that reach back across block bounds, with incompressible
    stretches (stored blocks) between them (tests/test_tmap.py:157)."""
    rng = np.random.default_rng(seed)
    unit = b"linked history reaches back across block bounds " * 400
    parts = []
    for i in range(n // len(unit) + 2):
        parts.append(unit)
        if i % 11 == 0:      # incompressible: store-uncompressed
            parts.append(rng.integers(0, 256, 66_000,
                                      dtype=np.uint8).tobytes())
    return b"".join(parts)[:n]


def _host_frame(mod, data, bsid, mode, dictionary=None, level=0,
                block_checksum=True):
    prefs = mod.Preferences(frame_info=mod.FrameInfo(
        block_size_id=getattr(mod.BlockSizeID, bsid),
        block_mode=getattr(mod.BlockMode, mode),
        content_checksum=True, block_checksum=block_checksum),
        compression_level=level)
    return mod.compress_frame(data, prefs, dictionary=dictionary)


@pytest.mark.parametrize("with_dict", [False, True], ids=["nodict", "dict"])
@pytest.mark.parametrize("bsid", ["max64KB", "max256KB", "max1MB"])
def test_linked_frames_decode_like_reference(bsid, with_dict, jax_codec):
    data = _linked_data(700_000 + 321)
    d = data[50_000:50_000 + 40_000] if with_dict else None
    fr = _host_frame(lz4f, data, bsid, "linked", d)
    assert fr == _host_frame(ref_frame, data, bsid, "linked", d)
    assert lz4f.parse_frame_header(fr)[0].block_mode == lz4f.BlockMode.linked
    port = ShardedFrameCodec(device="cpu", dictionary=d)
    got = port.decompress_frame(fr)
    assert got == data
    assert got == jax_codec(dictionary=d).decompress_frame(fr)


def test_linked_multi_window_with_dictionary(jax_codec):
    """Over 2 MB of output forces at least two windows through the
    history carry (``dlen`` accumulation, right-aligned history) and
    cross-window path compression (tests/test_tmap.py:157)."""
    data = _linked_data(4_500_000 + 321)
    assert len(data) > 1 << 21
    d = data[50_000:50_000 + 40_000]
    fr = _host_frame(lz4f, data, "max64KB", "linked", d)
    port = ShardedFrameCodec(device="cpu", dictionary=d)
    got = port.decompress_frame(fr)
    assert got == data
    assert got == jax_codec(dictionary=d).decompress_frame(fr)
    # without the dictionary the first match reaches before the frame
    with pytest.raises(E.LZ4Error):
        ShardedFrameCodec(device="cpu").decompress_frame(fr)


@pytest.mark.parametrize("level", [0, 9])
def test_linked_frames_small_and_concatenated(level, corpus, port):
    frames, want = [], b""
    for name in CORPUS:
        fr = _host_frame(lz4f, corpus[name], "max64KB", "linked",
                         level=level, block_checksum=False)
        assert port.decompress_frame(fr) == corpus[name]
        frames.append(fr)
        want += corpus[name]
    # concatenated frames of both kinds, as the lz4 CLI writes them
    frames.append(port.compress_frame(corpus["lorem"]))
    assert port.decompress_frame(b"".join(frames)) == want + corpus["lorem"]


def test_linked_window_budget_widens_for_long_payloads(port):
    """A stored block larger than the 1 MB payload budget of its window
    (the reference hands such a frame to the host decoder) still goes
    through the linked step."""
    rng = np.random.default_rng(4)
    big = rng.integers(0, 256, (1 << 20) + 5000, dtype=np.uint8).tobytes()
    head = b"abcdefgh" * 100
    blob = make_goldens.frame(
        [(compress_fast(head), False), (big, True)], bsize=5,
        indep=False, content=head + big)
    assert port.decompress_frame(blob) == head + big


@pytest.mark.parametrize("bsid", ["max64KB", "max256KB"])
def test_independent_dictionary_frames_decode_like_reference(bsid,
                                                             jax_codec):
    data = _linked_data(400_000, seed=5)
    d = data[30_000:30_000 + 70_000]         # longer than the window
    fr = _host_frame(lz4f, data, bsid, "independent", d, level=9)
    port = ShardedFrameCodec(device="cpu", dictionary=d, dict_id=7)
    assert port.dcap == 65536 and port.info.dict_id == 7
    got = port.decompress_frame(fr)
    assert got == data
    assert got == jax_codec(dictionary=d).decompress_frame(fr)


def test_linked_corruption_raises_reference_class(jax_codec):
    data = _linked_data(200_000)
    fr = bytearray(_host_frame(lz4f, data, "max64KB", "linked",
                               block_checksum=False))
    fr[len(fr) // 3] ^= 0xFF
    ref, port = jax_codec(), ShardedFrameCodec(device="cpu")
    _raises_like(ref, port, bytes(fr))
    # a second block whose match reaches before the frame's start
    bad = bytes([0x10, ord("A"), 0xFF, 0xFF, 0x00])
    blob = make_goldens.frame([(b"stored block", True), (bad, False)],
                              indep=False)
    exc = _raises_like(ref, port, blob)
    assert "frame block 1" in str(exc)


def _without_native(monkeypatch):
    """Take the native resolvers away, as a runtime that did not load
    leaves them, and count the sequence-rebuild calls."""
    from zig_lz4_tpu_torch.parallel import sharded
    monkeypatch.setattr(sharded, "native_resolve_tmap_linked",
                        lambda *a, **k: None)
    monkeypatch.setattr(sharded, "native_resolve_tmap",
                        lambda *a, **k: None)
    calls = []
    real = sharded.decode_blocks

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(sharded, "decode_blocks", counted)
    return calls


def test_linked_decode_needs_the_native_runtime(monkeypatch, port):
    """Without the native runtime a linked frame goes to the host frame
    layer, as the reference's decompress_frame sends it
    (tests/test_parallel.py's test_sharded_linked_frame_falls_back)."""
    calls = _without_native(monkeypatch)
    blob, content = _GOLDENS["linked_blocks.lz4"]
    assert port.decompress_frame(blob) == content
    assert not calls
    assert set(port.routes) == {"host"}
    data = make_corpus(make_torch_goldens.CORPUS_MB)[:20_000]
    prefs = lz4f.Preferences(frame_info=lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID.max64KB,
        block_mode=lz4f.BlockMode.linked))
    assert port.decompress_frame(lz4f.compress_frame(data, prefs)) == data
    assert not calls and set(port.routes) == {"host"}
    # an independent frame no longer needs it
    blob, content = _GOLDENS["periodic_match.lz4"]
    assert port.decompress_frame(blob) == content
    assert len(calls) == 1


@pytest.mark.parametrize("name", sorted(
    n for n, (blob, _c) in _GOLDENS.items()
    if n not in _GOLDEN_DICTS and n not in ("block256k.lz4", "block1m.lz4",
                                            "block4m.lz4")))
def test_golden_fixtures_decode_without_native(name, monkeypatch, port):
    """Every golden frame of blocks up to 64 KB through the
    sequence-rebuild decoder, and linked frames through the host frame
    layer."""
    blob, content = _GOLDENS[name]
    _without_native(monkeypatch)
    assert port.decompress_frame(blob) == content


def test_frames_decode_without_native(monkeypatch, corpus, jax_frames,
                                      jax_deep_frames):
    calls = _without_native(monkeypatch)
    port4k = ShardedFrameCodec(compression_level=9, device="cpu")
    port4k.block_size = port4k.window = SMALL
    for name in CORPUS + ("multi",):
        data = _multi() if name == "multi" else corpus[name]
        assert port4k.decompress_frame(jax_frames[name]) == data
        assert port4k.decompress_frame(jax_deep_frames[f"l12_{name}"]) == data
    assert len(calls) >= len(CORPUS)    # some inputs store every block
    # a dictionary is the history of every block
    data = _linked_data(150_000, seed=5)
    d = data[30_000:30_000 + 70_000]
    fr = _host_frame(lz4f, data, "max64KB", "independent", d, level=9)
    port = ShardedFrameCodec(device="cpu", dictionary=d)
    del calls[:]
    assert port.decompress_frame(fr) == data
    assert len(calls) == 1
    with pytest.raises(E.LZ4Error):
        ShardedFrameCodec(device="cpu").decompress_frame(fr)


def test_errors_without_native(monkeypatch, codecs):
    """The same error classes and block names as with the runtime."""
    ref, port4k = codecs
    _without_native(monkeypatch)
    bad = bytes([0x10, ord("A"), 0xFF, 0xFF, 0x00])   # offset past output
    blob = make_goldens.frame([(b"stored block", True), (bad, False)])
    exc = _raises_like(ref, port4k, blob)
    assert isinstance(exc, E.CorruptedData) and "frame block 1" in str(exc)
    blob = make_goldens.frame([(compress_fast(b"ab" * 65536), False)])
    exc = _raises_like(ref, port4k, blob)
    assert isinstance(exc, E.CorruptedData)
    assert "frame block 0 decodes to more than" in str(exc)
    for name in sorted(_NEGATIVES):
        _raises_like(ref, port4k, _NEGATIVES[name][0])
    # blocks over 64 KB have no sequence-rebuild route
    big = _host_frame(lz4f, _linked_data(300_000), "max256KB", "independent")
    with pytest.raises(NotImplementedError, match="T-map"):
        ShardedFrameCodec(device="cpu").decompress_frame(big)


# -- the fragment-ladder engines ---------------------------------------

ENGINES = ("win", "chase", "mixed")


def _reference_membership(frame: bytes, engine: str, dictionary=b""):
    """route -> number of blocks, as the reference's ``_decode_records``
    assigns the compressed blocks of ``frame`` to its ladder tiers on a
    one-device mesh (zig_lz4_tpu/parallel/sharded.py:676-810), computed
    with the reference's resolver, predicates and tier tables."""
    from zig_lz4_tpu.constants import compress_bound
    from zig_lz4_tpu.native import native_resolve_blocks
    from zig_lz4_tpu.ops import jax_decode as jd
    from zig_lz4_tpu.parallel import sharded as rs
    info, pos = ref_frame.parse_frame_header(frame)
    bs = info.block_size_id.to_block_size()
    pays = []
    while True:
        word = int.from_bytes(frame[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            break
        blen = word & 0x7FFFFFFF
        if not word & 0x80000000:
            pays.append(frame[pos:pos + blen])
        pos += blen + (4 if info.block_checksum else 0)
    dcap, ccap = len(dictionary), compress_bound(bs)
    chase, mixed = engine == "chase", engine == "mixed"
    use = rs._CHASE_TIERS if chase else rs._FRAG_TIERS[:-1]
    rmax_resolve = rs._CHASE_RMAX if chase else rs._FRAG_RMAX

    def supports(f_, c_, rmax):
        if chase or (mixed and rmax > 2):
            return jd.device_chase_decoder_supports(bs, f_, c_)
        return jd.device_frag_decoder_supports(bs, f_, c_)

    quanta = (bs // 4, bs // 2, ccap)

    def fit(tiers):
        out = []
        for div, rmax in tiers:
            q = next((q for q in reversed(quanta)
                      if supports(bs // div, dcap + q, rmax)), 0)
            if q:
                out.append((bs // div, rmax, q))
        return out

    tiers = fit(use)
    if not tiers and mixed:
        tiers = fit(rs._FRAG_TIERS_BIG)
    if not tiers or not pays:
        return {}
    lens = np.array([len(p) for p in pays], np.int64)
    offs = np.zeros_like(lens)
    offs[1:] = np.cumsum(lens)[:-1]
    _fd, _fl, _fs, _fp, _fh, nfrag, rounds, olens = native_resolve_blocks(
        b"".join(pays), offs, lens, max(f for f, _r, _q in tiers),
        out_cap=bs, hist_len=dcap, split_max=rs._FRAG_SPLIT_MAX,
        round_limit=rmax_resolve, reuse_buffers=False)
    members, taken = {}, np.zeros(len(pays), bool)
    for fcap, rmax, q in tiers:
        fits = (~taken & (nfrag >= 0) & (nfrag <= fcap) & (rounds <= rmax)
                & (olens <= bs) & (lens <= q))
        taken |= fits
        if not fits.any():
            continue
        fetch_t = dcap + next(x for x in quanta if x >= lens[fits].max())
        if chase or (mixed and rmax > 2):
            name = "chase"
        elif jd.device_win_decoder_supports(bs, fcap, fetch_t):
            name = f"win{16 if rmax <= 2 else 8}"
        else:
            name = "frags"
        members[f"{name} fcap={fcap} rounds={rmax}"] = int(fits.sum())
    return members


def _check_routes(codec, frame, engine, dictionary=b""):
    """The tiers were handed the blocks the reference gives them; a
    tier accepted no more than it was handed; and what no tier took or
    finished went through T-map as a counted leftover, nowhere else."""
    want = _reference_membership(frame, engine, dictionary)
    assert codec.tier_members == want
    routes = dict(codec.routes)
    stored = routes.pop("stored", 0)
    leftover = routes.pop("leftover", 0)
    assert routes.pop("tmap", 0) == leftover
    assert set(routes) <= set(want)
    assert all(routes[k] <= want[k] for k in routes)
    info, pos = lz4f.parse_frame_header(frame)
    n_blocks = len(_scan_blocks(frame, pos, info.block_checksum)[0])
    assert sum(routes.values()) + leftover + stored == n_blocks
    return sum(want.values()) - sum(routes.values())    # blocks rejected


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("level", [0, 9])
@pytest.mark.parametrize("name", CORPUS + ("multi",))
def test_ladder_engines_decode_reference_frames(name, level, engine, corpus,
                                                jax_frames,
                                                jax_level_frames):
    """The JAX codec's 4 KB-block frames through each ladder engine
    (tests/test_parallel.py:161-175)."""
    data = _multi() if name == "multi" else corpus[name]
    frame = jax_frames[name] if level == 9 else \
        jax_level_frames[f"l{level}_{name}"]
    port = ShardedFrameCodec(device="cpu", decode_engine=engine)
    assert port.decompress_frame(frame) == data
    rejected = _check_routes(port, frame, engine)
    assert sum(port.routes.values()) - port.routes.get("leftover", 0) \
        == -(-len(data) // SMALL)
    if engine == "chase":       # natural chains, depth 64: every block
        assert not rejected and "tmap" not in port.routes


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("bsid,level", [("max64KB", 0), ("max64KB", 9),
                                        ("max256KB", 9), ("max1MB", 0)])
def test_ladder_engines_decode_host_frames(bsid, level, engine):
    """Whole blocks of every size: 64 KB blocks reach the windowed and
    the chase tiers, 256 KB blocks the byte-granular decoder, and what
    no tier takes is a counted leftover."""
    data = make_corpus(2)[:1_300_000] if bsid != "max1MB" else \
        (make_corpus(2)[13 * 65536:13 * 65536 + 40_000] * 30)[:1 << 20]
    frame = _host_frame(lz4f, data, bsid, "independent", level=level)
    port = ShardedFrameCodec(device="cpu", decode_engine=engine)
    assert port.decompress_frame(frame) == data
    _check_routes(port, frame, engine)
    if bsid == "max256KB" and engine == "win":
        assert any(k.startswith("frags ") for k in port.tier_members)
    if bsid == "max64KB":
        assert any(k.startswith(("chase ",) if engine == "chase" else
                                ("win",) if engine == "win" else
                                ("win", "chase "))
                   for k in port.tier_members)
    if bsid == "max1MB" and engine != "win":
        assert any(k.startswith("chase ") for k in port.tier_members)


def test_ladder_chase_with_dictionary():
    """LIT sources arrive shifted by the dictionary's length, PER
    sources do not (tests/test_parallel.py:194-204)."""
    rng = np.random.default_rng(7)
    d = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    data = (d * 8)[:6000] + _linked_data(150_000, seed=5)
    frame = _host_frame(lz4f, data, "max64KB", "independent", d, level=9)
    port = ShardedFrameCodec(device="cpu", dictionary=d, dict_id=5,
                             decode_engine="chase")
    assert port.decompress_frame(frame) == data
    _check_routes(port, frame, "chase", d)
    assert sum(port.tier_members.values()) > 0
    with pytest.raises(E.LZ4Error):
        ShardedFrameCodec(device="cpu", decode_engine="chase"
                          ).decompress_frame(frame)


def test_ladder_rejected_blocks_go_through_tmap(monkeypatch):
    """A block whose ``ok`` comes back clear is not accepted: it is
    decoded again by T-map and counted as a leftover."""
    from zig_lz4_tpu_torch.parallel import sharded
    real = sharded.decode_blocks_frags_chase

    def first_block_fails(*a, **k):
        out, ok = real(*a, **k)
        ok[0] = 0
        out[0] = 0
        return out, ok
    monkeypatch.setattr(sharded, "decode_blocks_frags_chase",
                        first_block_fails)
    data = make_corpus(2)[:300_000]
    frame = _host_frame(lz4f, data, "max64KB", "independent", level=9)
    port = ShardedFrameCodec(device="cpu", decode_engine="chase")
    assert port.decompress_frame(frame) == data
    launches = len(port.tier_members)
    assert port.routes["leftover"] == port.routes["tmap"] == launches
    assert sum(port.tier_members.values()) == \
        sum(v for k, v in port.routes.items() if k.startswith("chase ")) \
        + launches


def test_ladder_without_native_takes_the_sequence_decoder(monkeypatch, port):
    from zig_lz4_tpu_torch.parallel import sharded
    calls = _without_native(monkeypatch)
    monkeypatch.setattr(sharded, "native_resolve_blocks",
                        lambda *a, **k: None)
    blob, content = _GOLDENS["periodic_match.lz4"]
    mixed = ShardedFrameCodec(device="cpu", decode_engine="mixed")
    assert mixed.decompress_frame(blob) == content
    assert len(calls) == 1 and mixed.routes == {"seq": 1}


def test_ladder_corrupt_block_names_frame_block():
    bad = bytes([0x10, ord("A"), 0xFF, 0xFF, 0x00])   # offset past output
    blob = make_goldens.frame([(b"stored block", True), (bad, False)])
    for engine in ENGINES:
        with pytest.raises(E.CorruptedData, match="frame block 1"):
            ShardedFrameCodec(device="cpu", decode_engine=engine
                              ).decompress_frame(blob)
    blob = make_goldens.frame([(compress_fast(b"ab" * 65536), False)])
    for engine in ENGINES:
        with pytest.raises(E.CorruptedData, match="frame block 0"):
            ShardedFrameCodec(device="cpu", decode_engine=engine
                              ).decompress_frame(blob)


@pytest.mark.parametrize("engine", ENGINES + ("tmap",))
def test_from_reference_carries_decode_engine(engine, jax_codec, jax_frames,
                                              corpus):
    ref = jax_codec(compression_level=9, decode_engine=engine)
    port = ShardedFrameCodec.from_reference(ref, device="cpu")
    assert port.decode_engine == ref.decode_engine == engine
    assert port.decompress_frame(jax_frames["lorem"]) == corpus["lorem"]
    assert bool(port.tier_members) == (engine != "tmap")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ENGINES)
def test_ladder_kernels_route_like_plain(engine):
    """On the card the three kernels take the place of the plain
    versions: the same content and the same routes, block for block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from zig_lz4_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    data = make_corpus(2)
    d = data[70_000:140_000]
    for bsid, dictionary in (("max64KB", None), ("max256KB", None),
                             ("max64KB", d)):
        frame = _host_frame(lz4f, data, bsid, "independent", dictionary,
                            level=9)
        on_cpu = ShardedFrameCodec(device="cpu", decode_engine=engine,
                                   dictionary=dictionary)
        on_card = ShardedFrameCodec(device="cuda", decode_engine=engine,
                                    dictionary=dictionary)
        reset_launch_counts()
        assert on_card.decompress_frame(frame) == data
        assert on_cpu.decompress_frame(frame) == data
        assert on_card.routes == on_cpu.routes
        assert on_card.tier_members == on_cpu.tier_members
        assert sum(LAUNCHES[k] for k in ("frag_decode", "frag_decode_win",
                                         "frag_decode_chase")) > 0


# -- the single-block codec family ------------------------------------

@pytest.mark.parametrize("level", [0, 1, 4, 9, 10, 12])
def test_cuda_codec_compresses_one_block(level):
    data = make_corpus(2)[13 * 65536:13 * 65536 + 3000]
    codec = CUDACodec(block_capacity=4096, level=level, device="cpu")
    comp = codec.compress(data)
    assert decompress_safe(comp, len(data)) == data
    hc, deep = tb.level_params(level)
    w = torch.zeros((1, 4096), dtype=torch.uint8)
    w[0, :len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out, n = tb.encode_blocks_plain(
        w, torch.tensor([len(data)], dtype=torch.int32), hc=hc, deep=deep)
    assert comp == out[0, :int(n[0])].numpy().tobytes()
    with pytest.raises(E.OutputTooSmall):
        codec.compress(data, max_output=10)
    with pytest.raises(ValueError):
        codec.compress(b"x" * 5000)


def test_get_codec_cuda_family():
    assert type(get_codec(0)).__name__ == "FastCodec"
    assert type(get_codec(5)).__name__ == "HCCodec"
    if not torch.cuda.is_available():
        # nothing picks the CPU on its own
        with pytest.raises(RuntimeError, match="CUDA"):
            get_codec("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            get_codec("cuda9")
    else:
        assert get_codec("cuda").level == 1
        assert get_codec("cuda9").level == 9
    assert decompress_safe(CUDACodec(level=12, device="cpu", block_capacity=64
                                     ).compress(b"deep level"), 10) == \
        b"deep level"


@pytest.mark.parametrize("level", [1, 9, 12])
@pytest.mark.parametrize("name", CORPUS)
def test_cuda_codec_round_trips(name, level, corpus):
    """``compress`` then ``decompress`` (the sequence-rebuild decoder),
    as ``TPUCodec`` does (tests/test_models.py); any LZ4 block decodes,
    whoever wrote it."""
    data = corpus[name][:4096]
    codec = CUDACodec(block_capacity=4096, level=level, device="cpu")
    comp = codec.compress(data)
    assert codec.decompress(comp, len(data)) == data
    assert codec.decompress(compress_fast(data), 4096) == data
    if data:
        with pytest.raises(E.OutputTooSmall):
            codec.decompress(comp, len(data) - 1)


def test_cuda_codec_decompress_rejects_bad_blocks():
    codec = CUDACodec(block_capacity=4096, level=12, device="cpu")
    with pytest.raises(E.CorruptedData):
        codec.decompress(bytes([0x10, 65, 0xFF, 0xFF, 0x00]), 4096)
    with pytest.raises(E.CorruptedData, match="capacity"):
        codec.decompress(compress_fast(b"ab" * 4096), 8192)
    with pytest.raises(E.CorruptedData, match="capacity"):
        codec.decompress(compress_fast(bytes(range(256)) * 40), 1 << 20)
