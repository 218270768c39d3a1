"""The port's T-map rebuilds (zig_lz4_tpu_torch.ops.torch_decode) --
independent blocks and the linked-frame window step -- against the JAX
reference (zig_lz4_tpu.ops.jax_decode).

Tolerance: none; outputs are bytes and compared for equality.  The
block inputs are those of tests/test_tmap.py:24-36, made with numpy
seeds; the linked step runs at small H, PCQ and NOUT with seeded T.
``cuda``-marked tests hold the kernel against the plain version and
skip where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch.native import native_resolve_tmap
from zig_lz4_tpu_torch.ops import torch_decode as td
from zig_lz4_tpu_torch.ops.hc import compress_hc

BLK = 4096


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LINKED_SHAPES + [(65536, 70_001, 1 << 18)],
                         ids=str)
def test_linked_kernels_match_plain(cuda, shape):
    H, PCQ, NOUT = shape
    hist, pay, T = _linked_inputs(H, PCQ, NOUT, seed=5)
    for total in _totals(NOUT):
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
