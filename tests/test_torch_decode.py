"""The port's block rebuilds (zig_lz4_tpu_torch.ops.torch_decode) --
T-map decode of independent blocks, the linked-frame window step, and
the rebuild from parsed sequences -- against the JAX reference
(zig_lz4_tpu.ops.jax_decode).

Tolerance: none; outputs are bytes and compared for equality.  The
block inputs are those of tests/test_tmap.py:24-36, made with numpy
seeds; the linked step runs at small H, PCQ and NOUT with seeded T.
The sequence rebuild runs live against ``decode_blocks_jax`` on those
blocks (4 KB, with and without a history, byte runs and overlapping
matches) and against ``tests/fixtures/seqdec4k.npz``, the JAX decoder's
output on the level-8 payloads of the encoder tests' static inputs.
``cuda``-marked tests hold the kernel against the plain version and
skip where there is no CUDA device.
"""

import os
import sys

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch import errors as E
from zig_lz4_tpu_torch.constants import compress_bound
from zig_lz4_tpu_torch.native import native_resolve_tmap
from zig_lz4_tpu_torch.ops import torch_decode as td
from zig_lz4_tpu_torch.ops.block import compress_fast
from zig_lz4_tpu_torch.ops.hc import compress_hc
from zig_lz4_tpu_torch.stream import Stream

BLK = 4096
_FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
SEQDEC_GOLDENS = os.path.join(_FIXDIR, "seqdec4k.npz")
LEVEL_GOLDENS_4K = os.path.join(_FIXDIR, "levels4k.npz")


def _cases():
    rng = np.random.default_rng(21)
    text = (b"the quick brown fox jumps over the lazy dog " * 200)
    return [
        text[:BLK],                                  # matchy text
        b"ab" * (BLK // 2),                          # 2-periodic RLE
        b"\x00" * BLK,                               # 1-periodic RLE
        rng.integers(0, 256, BLK, dtype=np.uint8).tobytes(),  # random
        text[:1000] + b"\x07" * 2000 +
        rng.integers(0, 256, 1096, dtype=np.uint8).tobytes(),  # mixed
        b"xyz",                                      # tiny
    ]


def _resolved(comps, garbage_seed=None):
    """(fetch uint8[B, F], T int32[B, BLK], out_len int32[B]); with a
    seed, T past out_len is overwritten with random int32 garbage, as
    the resolver may leave it."""
    lens = np.array([len(c) for c in comps], np.int64)
    offs = np.zeros_like(lens)
    offs[1:] = np.cumsum(lens)[:-1]
    T, ol = native_resolve_tmap(b"".join(comps), offs, lens, BLK,
                                reuse_buffers=False)
    fetch = np.zeros((len(comps), int(lens.max())), np.uint8)
    for i, c in enumerate(comps):
        fetch[i, :len(c)] = np.frombuffer(c, np.uint8)
    if garbage_seed is not None:
        rng = np.random.default_rng(garbage_seed)
        dead = np.arange(BLK)[None, :] >= ol[:, None]
        T[dead] = rng.integers(-2 ** 31, 2 ** 31 - 1, int(dead.sum()),
                               dtype=np.int64).astype(np.int32)
    return fetch, T, ol.astype(np.int32)


def _decode(fetch, T, ol, device="cpu"):
    return td.decode_blocks_tmap(torch.from_numpy(fetch).to(device),
                                 torch.from_numpy(T).to(device),
                                 torch.from_numpy(ol).to(device)).cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_plain_matches_jax_tmap_decoder():
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_decode import _batched_tmap_decoder
    cases = _cases()
    fetch, T, ol = _resolved([compress_hc(d, 9) for d in cases])
    want = np.asarray(_batched_tmap_decoder(BLK)(fetch, T, ol))
    got = _decode(fetch, T, ol)
    assert np.array_equal(got, want)
    for i, d in enumerate(cases):
        assert got[i, :len(d)].tobytes() == d


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_masks_t_past_out_len(seed):
    cases = _cases()
    fetch, T, ol = _resolved([compress_hc(d, 9) for d in cases], seed)
    got = _decode(fetch, T, ol)
    for i, d in enumerate(cases):
        assert got[i, :len(d)].tobytes() == d
        assert not got[i, len(d):].any()


def test_plain_clips_t_like_the_reference():
    # out[j] = fetch[clip(T[j], 0, F - 1)] for live j
    fetch = np.arange(1, 9, dtype=np.uint8)[None, :]
    T = np.array([[-5, 0, 3, 7, 8, 1 << 30, 2, 2]], np.int32)
    ol = np.array([6], np.int32)
    assert _decode(fetch, T, ol).tolist() == [[1, 1, 4, 8, 8, 8, 0, 0]]


def test_supports_every_block_size():
    for bs in (4096, 65536, 1 << 20, 4 << 20):
        assert td.device_tmap_decoder_supports(bs)
        assert td.device_tmap_decoder_supports(bs, bs + bs // 255 + 16)
    assert not td.device_tmap_decoder_supports(BLK, 2 ** 31)


def test_rejects_bad_inputs():
    fetch, T, ol = (torch.zeros((2, 4), dtype=torch.uint8),
                    torch.zeros((2, 8), dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        td.decode_blocks_tmap(fetch, T.long(), ol)
    with pytest.raises(TypeError):
        td.decode_blocks_tmap(fetch, T, ol[:1])
    with pytest.raises(ValueError):
        td.decode_blocks_tmap(fetch[:, :0], T, ol)


#: (H, PCQ, NOUT) of the linked step, small; the last is unaligned
LINKED_SHAPES = [(64, 96, 128), (256, 1000, 512), (61, 35, 131)]


def _linked_inputs(H, PCQ, NOUT, seed):
    """hist, payloads, and a T whose entries reach both, some out of
    range on either side (the step clips them)."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 256, H, dtype=np.uint8)
    pay = rng.integers(0, 256, PCQ, dtype=np.uint8)
    T = rng.integers(-5, H + PCQ + 5, NOUT, dtype=np.int64).astype(np.int32)
    return hist, pay, T


def _linked(hist, pay, T, total, device="cpu"):
    out, new_hist = td.linked_tmap_step(
        torch.from_numpy(hist).to(device), torch.from_numpy(pay).to(device),
        torch.from_numpy(T).to(device), total)
    return out.cpu().numpy(), new_hist.cpu().numpy()


def _totals(NOUT):
    """0, 1, mid, NOUT - 1, NOUT, and past NOUT (the shift clips)."""
    return [0, 1, NOUT // 2 + 1, NOUT - 1, NOUT, NOUT + 7]


@pytest.mark.parametrize("shape", LINKED_SHAPES, ids=str)
def test_linked_step_plain_matches_jax(shape):
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_decode import _linked_tmap_stepper
    H, PCQ, NOUT = shape
    step = _linked_tmap_stepper(H, PCQ, NOUT)
    hist, pay, T = _linked_inputs(H, PCQ, NOUT, seed=H + NOUT)
    for total in _totals(NOUT):
        want_out, want_hist = step(hist, pay, T, np.int32(total))
        out, new_hist = _linked(hist, pay, T, total)
        assert np.array_equal(out, np.asarray(want_out)), total
        assert np.array_equal(new_hist, np.asarray(want_hist)), total


@pytest.mark.parametrize("shape", LINKED_SHAPES, ids=str)
def test_linked_step_plain_semantics(shape):
    """out[j] = fetch[clip(T[j])] for j < total, else 0; new_hist = the
    H bytes of [hist | out] from clip(total, 0, NOUT); garbage in T at
    or past total changes nothing; hist is not written."""
    H, PCQ, NOUT = shape
    hist, pay, T = _linked_inputs(H, PCQ, NOUT, seed=3)
    fetch = np.concatenate([hist, pay])
    rng = np.random.default_rng(8)
    for total in _totals(NOUT):
        live = min(total, NOUT)
        want = np.zeros(NOUT, np.uint8)
        want[:live] = fetch[np.clip(T[:live], 0, H + PCQ - 1)]
        hist_in = hist.copy()
        out, new_hist = _linked(hist_in, pay, T, total)
        assert np.array_equal(hist_in, hist)
        assert np.array_equal(out, want)
        assert np.array_equal(new_hist,
                              np.concatenate([hist, want])[live:live + H])
        T2 = T.copy()
        T2[live:] = rng.integers(-2 ** 31, 2 ** 31 - 1, NOUT - live,
                                 dtype=np.int64).astype(np.int32)
        out2, hist2 = _linked(hist, pay, T2, total)
        assert np.array_equal(out2, out) and np.array_equal(hist2, new_hist)


def test_linked_steps_chain():
    """Two steps carry the history as the frame decoder does: the
    second window's history coordinates read the first one's tail."""
    H, NOUT = 64, 128
    rng = np.random.default_rng(12)
    hist0 = np.zeros(H, np.uint8)
    pay1 = rng.integers(0, 256, 100, dtype=np.uint8)
    T1 = (H + np.arange(NOUT) % 100).astype(np.int32)
    out1, hist1 = _linked(hist0, pay1, T1, 100)
    assert np.array_equal(hist1, pay1[100 - H:])
    # second window: 40 bytes copied from the history's tail, then 24 new
    pay2 = rng.integers(0, 256, 24, dtype=np.uint8)
    T2 = np.concatenate([H - 40 + np.arange(40), H + np.arange(24),
                         np.zeros(NOUT - 64)]).astype(np.int32)
    out2, hist2 = _linked(hist1, pay2, T2, 64)
    assert np.array_equal(out2[:40], pay1[60:])
    assert np.array_equal(out2[40:64], pay2)
    assert np.array_equal(hist2, out2[:64])


def test_linked_step_rejects_bad_inputs():
    hist, pay, T = (torch.zeros(8, dtype=torch.uint8),
                    torch.zeros(8, dtype=torch.uint8),
                    torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        td.linked_tmap_step(hist, pay, T.long(), 4)
    with pytest.raises(TypeError):
        td.linked_tmap_step(hist.int(), pay, T, 4)
    with pytest.raises(TypeError):
        td.linked_tmap_step(hist, pay, T, torch.tensor(4))
    with pytest.raises(ValueError):
        td.linked_tmap_step(hist[:0], pay, T, 4)


# -- rebuild from parsed sequences ------------------------------------

def _tables(comps, hist_lens=None, cap=None, ccap=None):
    """(comp uint8[B, ccap], lit_len, lit_src, mlen, off int32[B, cap],
    nseq int32[B]) of the payloads ``comps``, parsed by the port."""
    cap = cap or td.MAX_SEQS(BLK)
    ccap = ccap or BLK + 64
    hist_lens = hist_lens or [0] * len(comps)
    comp = np.zeros((len(comps), ccap), np.uint8)
    tabs = np.zeros((4, len(comps), cap), np.int32)
    ns = np.zeros(len(comps), np.int32)
    for j, (c, h) in enumerate(zip(comps, hist_lens)):
        comp[j, :len(c)] = np.frombuffer(c, np.uint8)
        (tabs[0, j], tabs[1, j], tabs[2, j], tabs[3, j],
         ns[j]) = td.seqs_to_arrays(td.parse_sequences(c, h), cap)
    return (comp, *tabs, ns)


def _seq_decode(arrays, blk=BLK, hists=None, device="cpu"):
    out, out_len, ok = td.decode_blocks(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in arrays), blk,
        hists=None if hists is None else torch.from_numpy(hists).to(device))
    return out.cpu().numpy(), out_len.cpu().numpy(), ok.cpu().numpy()


def _compress_with_dict(data: bytes, dictionary: bytes) -> bytes:
    """One block whose matches may reach into ``dictionary``."""
    stream = Stream()
    stream.load_dict(dictionary)
    return stream.compress_fast_continue(data)


def _history_cases():
    """(history, data) pairs whose blocks reach into the history: the
    data repeats the history's tail, then itself."""
    rng = np.random.default_rng(33)
    text = b"the quick brown fox jumps over the lazy dog " * 100
    noise = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    return [(text[:BLK], text[100:100 + BLK]),
            (noise, noise[-700:] + noise[:900] + b"z" * 300),
            (b"ab" * 600, b"ab" * 1000),
            (b"", text[:2000])]


def _hist_tables(cases):
    comps = [_compress_with_dict(d, h) if h else compress_fast(d)
             for h, d in cases]
    hists = np.zeros((len(cases), BLK), np.uint8)
    for j, (h, _d) in enumerate(cases):
        if h:
            hists[j, BLK - len(h):] = np.frombuffer(h, np.uint8)
    return _tables(comps, [len(h) for h, _d in cases]), hists


def test_seq_decode_plain_matches_jax():
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_decode import decode_blocks_jax
    cases = _cases()
    arrays = _tables([compress_hc(d, 9) for d in cases])
    want, want_len = decode_blocks_jax(*arrays, BLK)
    out, out_len, ok = _seq_decode(arrays)
    assert ok.all()
    assert np.array_equal(out_len, np.asarray(want_len))
    assert np.array_equal(out, np.asarray(want))
    for i, d in enumerate(cases):
        assert out[i, :len(d)].tobytes() == d and out_len[i] == len(d)
        assert not out[i, len(d):].any()


def test_seq_decode_plain_matches_jax_with_history():
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_decode import decode_blocks_jax
    cases = _history_cases()
    arrays, hists = _hist_tables(cases)
    # a match reaches into the history in every case that has one
    assert all((arrays[4][j] > np.cumsum(arrays[1][j] + arrays[3][j])
                - arrays[3][j]).any() for j in range(3))
    want, want_len = decode_blocks_jax(*arrays, BLK, hists=hists)
    out, out_len, ok = _seq_decode(arrays, hists=hists)
    assert ok.all()
    assert np.array_equal(out_len, np.asarray(want_len))
    assert np.array_equal(out, np.asarray(want))
    for i, (_h, d) in enumerate(cases):
        assert out[i, :out_len[i]].tobytes() == d


def _golden_seq_inputs(name):
    """The inputs tests/fixtures/make_torch_goldens.py fed the JAX
    decoder: level-8 payloads of the encoder tests' static inputs."""
    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_encode as tte
    _rows, windows, lens, starts = tte._pack(tte._static_inputs())
    with np.load(LEVEL_GOLDENS_4K) as z:
        pays = tte._payloads(z["payloads_hc8"], z["out_len_hc8"])
    with np.load(SEQDEC_GOLDENS) as z:
        sel, want, want_len = (z[f"rows_{name}"], z[f"out_{name}"],
                               z[f"out_len_{name}"])
    arrays = _tables([pays[r] for r in sel], [int(starts[r]) for r in sel])
    hists = None
    if name == "hist":
        hists = np.zeros((len(sel), BLK), np.uint8)
        for j, r in enumerate(sel):
            if starts[r]:
                hists[j, BLK - starts[r]:] = windows[r, :starts[r]]
    data = [windows[r, starts[r]:lens[r]].tobytes() for r in sel]
    return arrays, hists, want, want_len, data


@pytest.mark.parametrize("name", ["nohist", "hist"])
def test_seq_decode_plain_matches_jax_goldens(name):
    arrays, hists, want, want_len, data = _golden_seq_inputs(name)
    out, out_len, ok = _seq_decode(arrays, hists=hists)
    assert ok.all()
    assert np.array_equal(out_len, want_len)
    assert np.array_equal(out, want)
    for j, d in enumerate(data):
        assert out[j, :out_len[j]].tobytes() == d
    if name == "hist":
        assert hists.any()          # some rows do start behind a history


@pytest.mark.parametrize("k", range(6))
def test_parse_sequences_matches_reference(k):
    import zig_lz4_tpu.errors as ref_errors
    from zig_lz4_tpu.ops import jax_decode as ref
    comp = compress_hc(_cases()[k], 9)
    seqs = td.parse_sequences(comp)
    assert seqs == ref.parse_sequences(comp)
    cap = td.MAX_SEQS(BLK)
    assert cap == ref.MAX_SEQS(BLK)
    for a, b in zip(td.seqs_to_arrays(seqs, cap),
                    ref.seqs_to_arrays(seqs, cap)):
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.int32
    with pytest.raises(ValueError):
        td.seqs_to_arrays(seqs + [(0, 0, 0, 0)], len(seqs))
    # truncations and a wild offset: the same error class by name
    for bad in (comp[:len(comp) // 2], comp[:1], b"\xf0",
                bytes([0x10, 65, 0xFF, 0xFF, 0x00])):
        try:
            want = ref.parse_sequences(bad)
        except ref_errors.LZ4Error as exc:
            with pytest.raises(E.CorruptedData) as got:
                td.parse_sequences(bad)
            assert type(exc).__name__ == "CorruptedData"
            assert str(got.value) == str(exc)
        else:
            assert td.parse_sequences(bad) == want


def test_seq_decode_shared_history_and_dense_capacity():
    """A 1-D history is shared by every block; the tables may be cut to
    the sequences in use."""
    h = (b"shared dictionary bytes " * 40)[:BLK // 2]
    datas = [h[-300:] * 3, h[5:900] + b"tail", b""]
    comps = [_compress_with_dict(d, h) for d in datas]
    cap = max(len(td.parse_sequences(c, len(h))) for c in comps)
    arrays = _tables(comps, [len(h)] * 3, cap=cap, ccap=1024)
    hist = np.frombuffer(h, np.uint8).copy()
    out, out_len, ok = _seq_decode(arrays, hists=hist)
    out2, out_len2, ok2 = _seq_decode(arrays,
                                      hists=np.stack([hist] * 3))
    assert ok.all() and ok2.all()
    assert np.array_equal(out, out2) and np.array_equal(out_len, out_len2)
    for j, d in enumerate(datas):
        assert out[j, :out_len[j]].tobytes() == d


def _bad_tables():
    """Tables the host parser would not produce, one fault each; the
    last row is sound."""
    cap = 4
    comp = np.arange(64, dtype=np.uint8)[None].repeat(7, 0)
    lit = np.zeros((7, cap), np.int32)
    lsrc = np.zeros((7, cap), np.int32)
    ml = np.zeros((7, cap), np.int32)
    off = np.ones((7, cap), np.int32)
    ns = np.full(7, 2, np.int32)
    lit[:, 0], ml[:, 0], off[:, 0], lit[:, 1] = 8, 8, 4, 3
    lsrc[:, 0], lsrc[:, 1] = 1, 20
    lsrc[0, 1] = 62                 # a literal run past the payload
    off[1, 0] = 9                   # a match before the block's start
    ml[2, 0] = 200                  # more output than the block holds
    ns[3] = cap + 1                 # more sequences than the table has
    lit[4, 1] = -1                  # a negative length
    lsrc[5, 0] = -1                 # a literal run before the payload
    return comp, lit, lsrc, ml, off, ns


def test_seq_decode_flags_tables_out_of_range():
    arrays = _bad_tables()
    out, out_len, ok = _seq_decode(arrays, blk=64)
    assert ok.tolist() == [0, 0, 0, 0, 0, 0, 1]
    assert not out[:6].any()
    assert out_len[6] == 19 and out_len[2] == 65    # saturates at blk + 1
    want = list(range(1, 9)) + [5, 6, 7, 8, 5, 6, 7, 8] + [20, 21, 22]
    assert out[6, :19].tolist() == want and not out[6, 19:].any()
    # a history makes row 1 sound: its match starts one byte before
    hist = np.full(1, 77, np.uint8)
    out, out_len, ok = _seq_decode(arrays, blk=64, hists=hist)
    assert ok.tolist() == [0, 1, 0, 0, 0, 0, 1]
    assert out[1, 8:16].tolist() == [77] + list(range(1, 8))


def test_seq_decode_rejects_what_it_does_not_take():
    assert td.device_seq_decoder_supports(65536, 65536)
    assert not td.device_seq_decoder_supports(65537)
    assert not td.device_seq_decoder_supports(4096, 65537)
    arrays = [torch.from_numpy(a) for a in _bad_tables()]
    with pytest.raises(NotImplementedError, match="T-map"):
        td.decode_blocks(*arrays, 1 << 18)
    with pytest.raises(TypeError):
        td.decode_blocks(arrays[0], arrays[1].long(), *arrays[2:], 64)
    with pytest.raises(TypeError):
        td.decode_blocks(*arrays[:5], arrays[5][:2], 64)
    with pytest.raises(TypeError):
        td.decode_blocks(*arrays, 64, hists=torch.zeros((2, 8),
                                                        dtype=torch.uint8))
    assert compress_bound(BLK) <= BLK + 64


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nohist", "hist"])
def test_seq_kernel_matches_plain(cuda, name):
    arrays, hists, want, want_len, _data = _golden_seq_inputs(name)
    out, out_len, ok = _seq_decode(arrays, hists=hists, device=cuda)
    assert ok.all()
    assert np.array_equal(out, want) and np.array_equal(out_len, want_len)
    for got, plain in zip((out, out_len, ok),
                          _seq_decode(arrays, hists=hists)):
        assert np.array_equal(got, plain)


@pytest.mark.cuda
def test_seq_kernel_flags_like_plain(cuda):
    arrays = _bad_tables()
    for hists in (None, np.full(1, 77, np.uint8)):
        for got, plain in zip(_seq_decode(arrays, 64, hists, device=cuda),
                              _seq_decode(arrays, 64, hists)):
            assert np.array_equal(got, plain)


@pytest.mark.cuda
def test_seq_kernel_64k_blocks_with_history(cuda):
    """Full-size blocks behind a full-size shared history, byte runs and
    long overlapping matches included."""
    from zig_lz4_tpu_torch.corpus import make_corpus
    c = make_corpus(2)
    h = c[13 * 65536:14 * 65536]
    datas = [c[14 * 65536:15 * 65536], b"\x00" * 65536, b"abc" * 21845,
             h[1000:30000] + c[:20000], c[27 * 65536:28 * 65536]]
    comps = [_compress_with_dict(d, h) for d in datas]
    arrays = _tables(comps, [65536] * len(comps), cap=td.MAX_SEQS(65536),
                     ccap=compress_bound(65536))
    hist = np.frombuffer(h, np.uint8).copy()
    out, out_len, ok = _seq_decode(arrays, 65536, hist, device=cuda)
    assert ok.all()
    for j, d in enumerate(datas):
        assert out[j, :out_len[j]].tobytes() == d
    for got, plain in zip((out, out_len, ok),
                          _seq_decode(arrays, 65536, hist)):
        assert np.array_equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LINKED_SHAPES + [(65536, 70_001, 1 << 18),
                                                   (65536, 4096, 40_000)],
                         ids=str)
def test_linked_kernels_match_plain(cuda, shape):
    """The fused step's two outputs; besides ``_totals``, a total below
    H, whose new history starts in ``hist`` and ends in ``out``, and
    one at NOUT, whose history is out's tail."""
    H, PCQ, NOUT = shape
    hist, pay, T = _linked_inputs(H, PCQ, NOUT, seed=5)
    for total in _totals(NOUT) + [max(1, min(H, NOUT) // 3), NOUT]:
        got = _linked(hist, pay, T, total, device=cuda)
        want = _linked(hist, pay, T, total)
        assert np.array_equal(got[0], want[0]), total
        assert np.array_equal(got[1], want[1]), total


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain(cuda, seed):
    fetch, T, ol = _resolved([compress_hc(d, 9) for d in _cases()], seed)
    got = _decode(fetch, T, ol, device=cuda)
    assert np.array_equal(got, _decode(fetch, T, ol))


@pytest.mark.cuda
def test_kernel_unaligned_rows(cuda):
    """Rows whose length is not a multiple of 4, and a T whose base is
    not 16-byte aligned, take the scalar path."""
    rng = np.random.default_rng(3)
    for blk in (1, 7, 4099):
        fetch = rng.integers(0, 256, (5, 33), dtype=np.uint8)
        T = rng.integers(-40, 80, (5, blk), dtype=np.int64).astype(np.int32)
        ol = rng.integers(0, blk + 1, 5).astype(np.int32)
        assert np.array_equal(_decode(fetch, T, ol, device=cuda),
                              _decode(fetch, T, ol))
    fetch, T, ol = _resolved([compress_hc(d, 9) for d in _cases()])
    flat = torch.zeros(T.size + 1, dtype=torch.int32, device=cuda)
    T_off = flat[1:].view(T.shape)      # contiguous, base 4 bytes past 16
    T_off.copy_(torch.from_numpy(T))
    got = td.decode_blocks_tmap(torch.from_numpy(fetch).to(cuda), T_off,
                                torch.from_numpy(ol).to(cuda))
    assert np.array_equal(got.cpu().numpy(), _decode(fetch, T, ol))
