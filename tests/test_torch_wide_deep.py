"""The port's encoder at levels 10-12 in windows over 64 KB against the
JAX reference.

Dictionary frames (windows ``[dictionary | block]`` of up to 131,072
bytes), 256 KB blocks and the 327,680-byte sub-span windows of 1 MB and
4 MB blocks at the deep levels: exact rank tiers, the price parse, the
pooled extension (512 rows per 64 KB of window).  A live JAX encode at
these widths compiles for over a minute, so the reference's outputs come
from ``tests/fixtures/wide_deep_corpus.npz`` (payloads of the
``WIDE_SETS`` windows, regenerated from the stored corpus offsets) and
``tests/fixtures/wide_deep_frames.npz`` (the SHA-256 of the JAX codec's
frames and its short frames), written by
``tests/fixtures/make_torch_goldens.py wide_deep wide_deep_frames``.  The
port runs on ``device="cpu"``: the plain versions of its kernels.
``cuda``-marked tests hold ``enc_deep_match_wide``, ``enc_deep_dp`` and
``enc_deep_emit`` against the plain versions and the goldens on the card.
Tolerance: none; payloads and frames are compared byte for byte.
"""

import hashlib
import os
import random
import sys

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch import ShardedFrameCodec
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens as mtg  # noqa: E402  (inputs of the goldens)


def _rows(name: str, level: int) -> int:
    return len(mtg.WIDE_SETS[name][1]) + (
        name == "w131k" and level in mtg.WIDE_DEEP_ZERO)


WINDOW_CASES = [(name, level, k)
                for name, levels in mtg.WIDE_DEEP_LEVELS.items()
                for level in levels for k in range(_rows(name, level))]


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


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def goldens():
    return _load(mtg.WIDE_DEEP_OUT)


@pytest.fixture(scope="module")
def frame_goldens():
    return _load(mtg.WIDE_DEEP_FRAMES_OUT)


def golden_payload(goldens, name, level, k) -> bytes:
    out_len = goldens[f"{name}_l{level}_out_len"]
    end = int(out_len[:k + 1].sum())
    return goldens[f"{name}_l{level}_payloads"][end - int(out_len[k]):end] \
        .tobytes()


@pytest.mark.parametrize("name,level,k", WINDOW_CASES)
def test_plain_encode_matches_jax_wide_deep_windows(name, level, k, corpus2,
                                                    goldens):
    windows, lens, starts = mtg.wide_deep_windows(corpus2, name, level)
    assert np.array_equal(goldens[f"{name}_l{level}_lens"], lens)
    hc, deep = tb.level_params(level)
    w, n, s = (torch.from_numpy(a[k:k + 1]) for a in (windows, lens, starts))
    out, out_len = tb.encode_blocks(w, n, s, hc=hc, deep=deep)
    assert out[0, :int(out_len[0])].numpy().tobytes() == \
        golden_payload(goldens, name, level, k)
    assert not out[0, int(out_len[0]):].any()


def test_wide_deep_goldens_cover_every_case(goldens, frame_goldens):
    for name, level, _k in WINDOW_CASES:
        assert f"{name}_l{level}_payloads" in goldens
    for name in mtg.WIDE_DEEP_FRAMES:
        assert f"frame_{name}_sha256" in frame_goldens
    for name in mtg.WIDE_DEEP_SMALL:
        assert f"frame_{name}" in frame_goldens


@pytest.mark.parametrize("name", sorted(mtg.WIDE_DEEP_FRAMES))
def test_deep_frames_equal_jax_frames(name, corpus2, frame_goldens):
    """The port's frame of the 400,000-byte input equals the JAX codec's
    byte for byte: 1 MB blocks at level 12 (sub-span windows of 327,680
    bytes), 64 KB blocks behind a 64 KB dictionary at level 12 and
    256 KB blocks at level 10."""
    data, dictionary = corpus2[mtg.WIDE_DEEP_FRAME], corpus2[mtg.WIDE_DICT]
    bsid, level, with_dict = mtg.WIDE_DEEP_FRAMES[name]
    dct = dictionary if with_dict else None
    port = ShardedFrameCodec(device="cpu", compression_level=level,
                             block_size_id=getattr(lz4f.BlockSizeID, bsid),
                             dictionary=dct)
    frame = port.compress_frame(data)
    assert len(frame) == int(frame_goldens[f"frame_{name}_len"])
    assert hashlib.sha256(frame).hexdigest() == \
        str(frame_goldens[f"frame_{name}_sha256"])
    assert lz4f.decompress_frame(frame, dictionary=dct) == data


def test_dictionary_window_not_a_multiple_of_32(frame_goldens):
    """A 100-byte dictionary at level 12: a window of 65,636 bytes, no
    multiple of 32.  The reference's price and greedy scans take only
    multiples of 32 and raise; the port encodes it, to the reference's
    frame over the window rounded up to 32 bytes."""
    data, bsid, level, dct = mtg.WIDE_DEEP_SMALL["small_dict_l12"]
    port = ShardedFrameCodec(device="cpu", compression_level=level,
                             block_size_id=getattr(lz4f.BlockSizeID, bsid),
                             dictionary=dct)
    assert port.window % 32
    frame = port.compress_frame(data)
    assert frame == frame_goldens["frame_small_dict_l12"].tobytes()
    assert lz4f.decompress_frame(frame, dictionary=dct) == data


def test_big_window_1m_deep_encode_roundtrip():
    """tests/test_large_blocks.py's 1 MB device encode at level 12: two
    1 MB blocks, each encoded as sub-span windows behind the 64 KB
    before them and joined into one block stream."""
    rng = np.random.default_rng(7)
    text = (b"sub-span stitching over the 64KB history boundary " * 40)
    data = (text + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
            ) * 260                            # ~1.3 MB, 2 blocks
    c = ShardedFrameCodec(device="cpu", compression_level=12,
                          block_size_id=lz4f.BlockSizeID.max1MB)
    assert not tb.device_encoder_supports(c.window)
    fr = c.compress_frame(data)
    assert lz4f.decompress_frame(fr) == data
    assert c.decompress_frame(fr) == data
    assert len(fr) < len(data) // 2            # genuinely compressed


def test_deep_levels_with_dictionary():
    """tests/test_parallel.py's dictionary frame at level 11: every block
    matches into the dictionary, in a window of 1,024 + 65,536 bytes."""
    rng = random.Random(7)
    dict_ = bytes(rng.randrange(256) for _ in range(1024))
    data = (dict_ * 8)[:6000]
    c = ShardedFrameCodec(device="cpu", dictionary=dict_, dict_id=5,
                          compression_level=11)
    assert c.window > 65536
    comp = c.compress_frame(data)
    assert c.decompress_frame(comp) == data
    assert len(comp) < len(data) // 4
    assert lz4f.decompress_frame(comp, dictionary=dict_) == data


def test_cuda_codec_over_64k_at_a_deep_level(goldens):
    """``CUDACodec(level=10)`` with a 131,072-byte capacity: 1,000 zero
    bytes encode to the JAX payload of the all-zero golden window."""
    from zig_lz4_tpu_torch.models import CUDACodec
    from zig_lz4_tpu_torch.ops.block import decompress_safe
    n = mtg.WIDE_DEEP_ZERO[10]
    codec = CUDACodec(block_capacity=131072, level=10, device="cpu")
    comp = codec.compress(bytes(n))
    assert comp == golden_payload(goldens, "w131k", 10, _rows("w131k", 10) - 1)
    assert decompress_safe(comp, n) == bytes(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernels_vs_plain(w, n, s, deep):
    """Each deep kernel against its plain version on the same inputs;
    returns the kernels' (out, out_len)."""
    from zig_lz4_tpu_torch.kernels import LAUNCHES
    before = LAUNCHES["enc_deep_match_wide"]
    pk = tb.match_candidates(w, n, 8, deep=deep)
    assert LAUNCHES["enc_deep_match_wide"] == before + 1
    assert torch.equal(pk.cpu(), tb.match_candidates_plain(
        w.cpu(), n.cpu(), 8, deep=deep))
    st = tb.deep_dp(n, s, pk, deep)
    assert torch.equal(st.cpu(), tb.deep_dp_plain(n.cpu(), s.cpu(), pk.cpu(),
                                                  deep))
    out, out_len = tb.deep_emit(w, n, s, pk, st)
    out_p, len_p = tb.deep_emit_plain(w.cpu(), n.cpu(), s.cpu(), pk.cpu(),
                                      st.cpu())
    torch.cuda.synchronize()
    assert torch.equal(out_len.cpu(), len_p)
    assert torch.equal(out.cpu(), out_p)
    return out, out_len


@pytest.mark.cuda
@pytest.mark.parametrize("name,level", [(name, level) for name, levels in
                                        mtg.WIDE_DEEP_LEVELS.items()
                                        for level in levels])
def test_wide_deep_kernels_match_plain_and_goldens(cuda, name, level,
                                                   corpus2, goldens):
    windows, lens, starts = mtg.wide_deep_windows(corpus2, name, level)
    w, n, s = (torch.from_numpy(a).to(cuda) for a in (windows, lens, starts))
    out, out_len = _kernels_vs_plain(w, n, s, tb.level_params(level)[1])
    for k in range(len(lens)):
        assert out[k, :int(out_len[k])].cpu().numpy().tobytes() == \
            golden_payload(goldens, name, level, k)


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [1, 2, 3])
def test_wide_deep_kernels_odd_window_sizes(cuda, deep):
    """Windows over 64 KB that are not powers of two pad the sort."""
    rng = np.random.default_rng(13)
    for blk in (65_568, 100_032):
        windows = np.zeros((2, blk), np.uint8)
        windows[0] = rng.integers(0, 3, blk, dtype=np.uint8)
        windows[1] = np.frombuffer((b"wide deep windows pad the sort " *
                                    (blk // 31 + 1))[:blk], np.uint8)
        lens = np.array([blk, blk - 7], np.int32)
        starts = np.array([0, blk // 3], np.int32)
        _kernels_vs_plain(*(torch.from_numpy(a).to(cuda)
                            for a in (windows, lens, starts)), deep)
