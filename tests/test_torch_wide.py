"""The port's encoder at windows over 64 KB against the JAX reference.

Dictionary frames (windows ``[dictionary | block]`` of up to 131,072
bytes), 256 KB blocks and the 327,680-byte sub-span windows of 1 MB and
4 MB blocks (``_SUB``, ``_SUBH``, ``ops/block.concat_streams``) at levels
0-9.  A live JAX encode at these widths compiles for about a minute, so
the reference's outputs come from ``tests/fixtures/wide_corpus.npz``,
written by ``tests/fixtures/make_torch_goldens.py wide``: the payloads of
``make_corpus`` windows (inputs regenerated from the stored offsets) and
the SHA-256 of the JAX codec's frames.  The port runs on
``device="cpu"``: the plain versions of its kernels.  ``cuda``-marked
tests hold ``enc_match_wide`` and ``enc_parse_emit`` against the plain
versions on the card.  Tolerance: none; payloads and frames are compared
byte for byte.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

import zig_lz4_tpu.frame as ref_frame
from zig_lz4_tpu_torch import ShardedFrameCodec
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens as mtg  # noqa: E402  (inputs of the goldens)

WINDOW_CASES = [(name, hc, k) for name, (_b, rows, _s, hcs)
                in mtg.WIDE_SETS.items() for hc in hcs
                for k in range(len(rows))]


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
def corpus2():
    return make_corpus(mtg.CORPUS_MB)


@pytest.fixture(scope="module")
def goldens():
    with np.load(mtg.WIDE_OUT) as z:
        return {k: z[k] for k in z.files}


def _golden_payload(goldens, name, hc, k) -> bytes:
    out_len = goldens[f"{name}_hc{hc}_out_len"]
    end = int(out_len[:k + 1].sum())
    return goldens[f"{name}_hc{hc}_payloads"][end - int(out_len[k]):end] \
        .tobytes()


@pytest.mark.parametrize("name,hc,k", WINDOW_CASES)
def test_plain_encode_matches_jax_wide_windows(name, hc, k, corpus2,
                                               goldens):
    windows, lens, starts = mtg.wide_windows(corpus2, name)
    assert np.array_equal(goldens[f"{name}_lens"], lens)
    w, n, s = (torch.from_numpy(a[k:k + 1]) for a in (windows, lens, starts))
    out, out_len = tb.encode_blocks(w, n, s, hc=hc)
    assert out[0, :int(out_len[0])].numpy().tobytes() == \
        _golden_payload(goldens, name, hc, k)
    assert not out[0, int(out_len[0]):].any()


def test_wide_goldens_cover_every_case(goldens):
    for name, hc, _k in WINDOW_CASES:
        assert f"{name}_hc{hc}_payloads" in goldens
    for name in list(mtg.WIDE_FRAMES) + list(mtg.WIDE_SMALL):
        assert any(key.startswith(f"frame_{name}") for key in goldens)


def _reference_codec(name):
    """The JAX codec of frame golden ``name`` (no compile: its settings
    only)."""
    pytest.importorskip("jax")
    from zig_lz4_tpu.parallel import ShardedFrameCodec as JaxCodec
    bsid, level, with_dict = mtg.WIDE_FRAMES[name]
    _data, dictionary = mtg.wide_frame_inputs(make_corpus(mtg.CORPUS_MB))
    return JaxCodec(compression_level=level,
                    block_size_id=getattr(ref_frame.BlockSizeID, bsid),
                    dictionary=dictionary if with_dict else None)


@pytest.mark.parametrize("name", sorted(mtg.WIDE_FRAMES))
def test_frames_equal_jax_frames(name, corpus2, goldens):
    """The port's frame of the 1,400,000-byte input equals the JAX
    codec's byte for byte: the sub-span split and ``concat_streams`` (1 MB
    and 4 MB blocks), the 256 KB windows, the dictionary windows and the
    framing.  The dictionary and 1 MB codecs are the reference's own,
    carried across by ``from_reference``."""
    data, dictionary = mtg.wide_frame_inputs(corpus2)
    bsid, level, with_dict = mtg.WIDE_FRAMES[name]
    if name in ("dict_l9", "max1MB_l9"):
        port = ShardedFrameCodec.from_reference(_reference_codec(name),
                                                device="cpu")
    else:
        port = ShardedFrameCodec(
            device="cpu", compression_level=level,
            block_size_id=getattr(lz4f.BlockSizeID, bsid),
            dictionary=dictionary if with_dict else None)
    frame = port.compress_frame(data)
    assert len(frame) == int(goldens[f"frame_{name}_len"])
    assert hashlib.sha256(frame).hexdigest() == \
        str(goldens[f"frame_{name}_sha256"])
    assert lz4f.decompress_frame(
        frame, dictionary=dictionary if with_dict else None) == data


def test_encoder_predicate_is_the_reference_s():
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_block import device_encoder_supports
    sizes = list(range(4096, 4 << 20, 4093)) + [
        65536, 65537, 131072, 262144, 327680, 327681, 524288, 1 << 20,
        4 << 20]
    for blk in sizes:
        assert tb.device_encoder_supports(blk) == \
            device_encoder_supports(blk), blk
    assert tb.device_encoder_supports(327680)
    assert not tb.device_encoder_supports(524288)


def test_wide_edge_windows_decode():
    """Windows over 64 KB that the goldens do not cover: all zero,
    random, n == start, n < 4, n % 4 != 0, a match exactly 65,535 bytes
    back into the history, and a history shorter than 64 KB; each
    payload decodes behind its history to the window's new bytes."""
    from zig_lz4_tpu_torch.ops.block import (decompress_safe,
                                             decompress_safe_using_dict)
    blk, rng = 131072, np.random.default_rng(11)
    rows = [(np.zeros(blk, np.uint8), blk, 65536),
            (rng.integers(0, 256, blk, dtype=np.uint8), blk, 65536),
            (rng.integers(0, 256, blk, dtype=np.uint8), 65536, 65536),
            (rng.integers(0, 256, blk, dtype=np.uint8), 65539, 65536),
            (rng.integers(0, 4, blk, dtype=np.uint8), 100_003, 0)]
    far = rng.integers(0, 256, blk, dtype=np.uint8)
    far[65536 + 1000:65536 + 1100] = far[1001:1101]     # 65,535 back
    rows.append((far, blk, 65536))
    short = rng.integers(0, 256, blk, dtype=np.uint8)
    short[20_000:20_300] = short[500:800]               # into the history
    rows.append((short, 70_000, 10_000))
    windows = np.stack([r for r, _n, _s in rows])
    lens = np.array([n for _r, n, _s in rows], np.int32)
    starts = np.array([s for _r, _n, s in rows], np.int32)
    for hc in (9, 0):
        out, out_len = tb.encode_blocks(*(torch.from_numpy(a) for a in
                                          (windows, lens, starts)), hc=hc)
        for k, (row, n, st) in enumerate(rows):
            comp = out[k, :int(out_len[k])].numpy().tobytes()
            want = row[st:n].tobytes()
            got = (decompress_safe_using_dict(comp, n - st, row[:st].tobytes())
                   if st else decompress_safe(comp, n - st)) if n > st else b""
            assert got == want, (hc, k)
        assert int(out_len[2]) == 0                     # n == start
        # the zero window is one long match; the copy at 65,535 back is
        # found, so that window beats the random one beside it
        assert int(out_len[0]) < 1000 and int(out_len[5]) < int(out_len[1])


def test_deep_levels_at_wide_windows_raise():
    """The inputs on which the deep levels at windows over 64 KB raised
    before they were ported now encode to the JAX reference's bytes
    (``wide_deep_corpus.npz``, ``wide_deep_frames.npz``; the other deep
    cases are in tests/test_torch_wide_deep.py)."""
    w = torch.zeros((1, 131072), dtype=torch.uint8)
    n = torch.full((1,), mtg.WIDE_DEEP_ZERO[10], dtype=torch.int32)
    with np.load(mtg.WIDE_DEEP_OUT) as z:
        want = z["w131k_l10_payloads"][-int(z["w131k_l10_out_len"][-1]):]
    for fn in (tb.encode_blocks, tb.encode_blocks_plain):
        out, out_len = fn(w, n, hc=8, deep=1)
        assert out[0, :int(out_len[0])].numpy().tobytes() == want.tobytes()
    with np.load(mtg.WIDE_DEEP_FRAMES_OUT) as z:
        frames = {k: z[f"frame_{k}"].tobytes()
                  for k in ("deep_wide_dict_l12", "deep_wide_4m_l12")}
    for name, want in frames.items():
        data, bsid, level, dct = mtg.WIDE_DEEP_SMALL[name]
        frame = ShardedFrameCodec(
            device="cpu", compression_level=level, dictionary=dct,
            block_size_id=getattr(lz4f.BlockSizeID, bsid)
        ).compress_frame(data)
        assert frame == want
        assert lz4f.decompress_frame(frame, dictionary=dct) == data


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(mtg.WIDE_SETS))
def test_wide_kernels_match_plain_and_goldens(cuda, name, corpus2, goldens):
    windows, lens, starts = mtg.wide_windows(corpus2, name)
    w, n, s = (torch.from_numpy(a).to(cuda) for a in (windows, lens, starts))
    for hc in mtg.WIDE_SETS[name][3]:
        pk = tb.match_candidates(w, n, hc)
        assert torch.equal(pk.cpu(), tb.match_candidates_plain(
            w.cpu(), n.cpu(), hc))
        out, out_len = tb.parse_emit(w, n, s, pk, hc)
        out_p, len_p = tb.parse_emit_plain(w.cpu(), n.cpu(), s.cpu(),
                                           pk.cpu(), hc)
        torch.cuda.synchronize()
        assert torch.equal(out_len.cpu(), len_p)
        assert torch.equal(out.cpu(), out_p)
        for k in range(len(lens)):
            assert out[k, :int(out_len[k])].cpu().numpy().tobytes() == \
                _golden_payload(goldens, name, hc, k)


@pytest.mark.cuda
@pytest.mark.parametrize("hc,accel", [(9, 1), (3, 1), (0, 1), (0, 8)])
def test_wide_kernels_odd_window_sizes(cuda, hc, accel):
    """Windows over 64 KB that are not powers of two pad the sort."""
    rng = np.random.default_rng(12)
    for blk in (65537, 100_001, 327_680):
        windows = np.zeros((2, blk), np.uint8)
        windows[0] = rng.integers(0, 3, blk, dtype=np.uint8)
        windows[1] = np.frombuffer((b"wide windows pad the sort " *
                                    (blk // 26 + 1))[:blk], np.uint8)
        lens = np.array([blk, blk - 7], np.int32)
        starts = np.array([0, blk // 3], np.int32)
        args = [torch.from_numpy(a) for a in (windows, lens, starts)]
        got = tb.encode_blocks(*(a.to(cuda) for a in args), hc=hc,
                               accel=accel)
        want = tb.encode_blocks(*args, hc=hc, accel=accel)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[0].cpu(), want[0])


def _sequences(payload: bytes) -> int:
    """Sequences of an LZ4 block payload: one token each."""
    pos, count = 0, 0
    while pos < len(payload):
        token = payload[pos]
        pos += 1
        count += 1
        lit = token >> 4
        if lit == 15:
            while payload[pos] == 255:
                lit += 255
                pos += 1
            lit += payload[pos]
            pos += 1
        pos += lit
        if pos >= len(payload):
            break
        pos += 2
        if token & 15 == 15:
            while payload[pos] == 255:
                pos += 1
            pos += 1
    return count


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [65536, 327_680])
def test_parse_emit_dense_and_single_match(cuda, blk):
    """``enc_parse_emit`` against its plain version on a window of short
    matches every few bytes (random bytes over {0, 1, 2, 3}: blk / 7 to
    blk / 5 sequences) and on one that a single match covers (all zero),
    at levels 9 and 0; both payloads decode to the window."""
    from zig_lz4_tpu_torch.ops.block import decompress_safe
    rng = np.random.default_rng(blk)
    windows = np.stack([rng.integers(0, 4, blk, dtype=np.uint8),
                        np.zeros(blk, np.uint8)])
    lens = np.full(2, blk, np.int32)
    starts = np.zeros(2, np.int32)
    w, n, s = (torch.from_numpy(a).to(cuda) for a in (windows, lens, starts))
    for hc in (9, 0):
        pk = tb.match_candidates(w, n, hc)
        out, out_len = tb.parse_emit(w, n, s, pk, hc)
        out_p, len_p = tb.parse_emit_plain(w.cpu(), n.cpu(), s.cpu(),
                                           pk.cpu(), hc)
        torch.cuda.synchronize()
        assert torch.equal(out_len.cpu(), len_p)
        assert torch.equal(out.cpu(), out_p)
        pays = [out_p[k, :int(len_p[k])].numpy().tobytes() for k in range(2)]
        assert _sequences(pays[0]) > blk // 10
        assert _sequences(pays[1]) == 2       # the match, then the tail
        for k in range(2):
            assert decompress_safe(pays[k], blk) == windows[k].tobytes()
