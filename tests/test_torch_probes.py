"""The port's counterparts of the JAX package's two Pallas kernels.

* P1, ``zig_lz4_tpu_torch.probes.serial_decode`` against
  ``experiments/pallas_decode.py``'s ``decode_blocks_pallas``, which
  runs in Pallas interpret mode on a CPU, at 4 KB blocks: random bytes
  (one literal run over 128 bytes), a byte run (offset 1), periods
  shorter than their matches (offset < length), literal runs across
  128-byte chunk edges, corpus text and an empty block.
* P2, ``zig_lz4_tpu_torch.probes.sort_probe`` against the output of the
  probe's network (``experiments/pallas_sort_probe.py``, its ``_kernel``
  under ``pl.pallas_call(..., interpret=True)``), checked in as
  ``tests/fixtures/sort2_probe.npz`` by ``make_torch_goldens.py sort2``
  (the interpreted network takes ~10 s): keys from a range of 64, so
  that most keys tie and the payload shows the network's own tie order.

``cuda``-marked tests hold the kernels against the plain versions on the
card.  Tolerance: none; bytes, keys and payloads are compared exactly.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch.constants import compress_bound
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import hc as hc_mod
from zig_lz4_tpu_torch.ops.block import compress_fast
from zig_lz4_tpu_torch.ops.torch_decode import (MAX_SEQS, parse_sequences,
                                                seqs_to_arrays)
from zig_lz4_tpu_torch.probes import serial_decode as sd
from zig_lz4_tpu_torch.probes import sort_probe as sp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "fixtures"))
import make_torch_goldens as mtg  # noqa: E402

BLK = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so the suite's parallel workers do not
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks() -> dict:
    rng = np.random.default_rng(21)
    text = make_corpus(2)[9 * 65536:9 * 65536 + BLK]
    edges = bytearray()
    while len(edges) < BLK:         # literal runs of 100-300 bytes apart
        edges += rng.integers(0, 256, int(rng.integers(100, 300)),
                              dtype=np.uint8).tobytes()
        edges += edges[-64:] * 2
    return {"random": rng.integers(0, 256, BLK, dtype=np.uint8).tobytes(),
            "rle": b"\x61" * BLK,
            "period3": (b"xyz" * BLK)[:BLK],
            "period37": (rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
                         * (BLK // 37 + 1))[:BLK],
            "edges": bytes(edges[:BLK]),
            "text": text,
            "short": b"ab" * 40 + b"z"}


def _tables(blocks: dict):
    """(payload rows, lit, lsrc, ml, off, nseq) as numpy, the blocks in
    ``blocks`` order then an empty block."""
    pays = [compress_fast(b) if k in ("random", "edges")
            else hc_mod.compress_hc(b, 9) for k, b in blocks.items()]
    pays.append(b"\x00")                # one empty literal run
    cap, ccap = MAX_SEQS(BLK), compress_bound(BLK)
    comp = np.zeros((len(pays), ccap), np.uint8)
    tabs = [seqs_to_arrays(parse_sequences(p), cap) for p in pays]
    for j, p in enumerate(pays):
        comp[j, :len(p)] = np.frombuffer(p, np.uint8)
    lit, lsrc, ml, off = (np.stack([t[k] for t in tabs]) for k in range(4))
    return comp, lit, lsrc, ml, off, np.array([t[4] for t in tabs], np.int32)


@pytest.fixture(scope="module")
def blocks():
    return _blocks()


@pytest.fixture(scope="module")
def tables(blocks):
    return _tables(blocks)


def test_tables_cover_the_probe_s_cases(tables):
    _comp, lit, _lsrc, ml, off, nseq = tables
    live = np.arange(lit.shape[1])[None, :] < nseq[:, None]
    assert ((off == 1) & (ml > 100) & live).any()           # a byte run
    assert ((off < ml) & (off > 1) & live).any()            # overlap
    assert (lit * live > 128).any()                         # > a chunk
    assert nseq[-1] == 1 and lit[-1, 0] == 0                # empty block


def test_serial_plain_matches_pallas_decoder(blocks, tables):
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(ROOT, "experiments"))
    from pallas_decode import decode_blocks_pallas
    out, out_len = decode_blocks_pallas(*tables, BLK)
    got, got_len = sd.decode_blocks_serial(
        *(torch.from_numpy(a) for a in tables), BLK)
    assert got_len.dtype == torch.int64
    assert np.array_equal(got_len.numpy(), np.asarray(out_len))
    assert np.array_equal(got.numpy(), np.asarray(out))
    for k, b in enumerate(blocks.values()):
        assert got[k, :len(b)].numpy().tobytes() == b
    assert not got[-1].any() and int(got_len[-1]) == 0


def test_serial_plain_edge_tables():
    """Tables parse_sequences never writes: no sequence, a source past
    the payload, a match before the block, lengths past blk."""
    comp = torch.tensor([[65, 66, 67, 68]], dtype=torch.uint8)
    lit = torch.tensor([[2, 3, 0]], dtype=torch.int32)
    lsrc = torch.tensor([[0, 2, 0]], dtype=torch.int32)
    ml = torch.tensor([[5, 0, 0]], dtype=torch.int32)
    off = torch.tensor([[9, 1, 1]], dtype=torch.int32)
    for ns, want in ((0, [0] * 8), (1, [65, 66, 0, 0, 0, 0, 0, 0]),
                     (2, [65, 66, 0, 0, 0, 0, 0, 67])):
        out, n = sd.decode_blocks_serial(
            comp, lit, lsrc, ml, off, torch.tensor([ns], dtype=torch.int32),
            8)
        assert out[0].tolist() == want, ns
        assert int(n[0]) == [0, 7, 10][ns]


def test_sort2_plain_matches_probe_network():
    with np.load(mtg.SORT2_OUT) as z:
        gold = {k: z[k] for k in z.files}
    n = int(gold["n"])
    assert n == sp.N
    keys = np.random.default_rng(2).integers(
        0, int(gold["key_range"]), n).astype(np.int32)
    ko, vo = sp.bitonic_sort2(torch.from_numpy(keys)[None],
                              torch.arange(n, dtype=torch.int32)[None])
    ko, vo = ko[0].numpy(), vo[0].numpy()
    assert np.array_equal(vo[:len(gold["vals_head"])], gold["vals_head"])
    assert hashlib.sha256(ko.tobytes() + vo.tobytes()).hexdigest() == \
        str(gold["sha256"])
    # ties are common, and the network's payload order is not stable's
    assert not np.array_equal(vo, np.argsort(keys, kind="stable"))


def test_sort2_plain_batches_rows_and_keeps_pairs():
    rng = np.random.default_rng(3)
    keys = rng.integers(-5, 5, (3, 1024)).astype(np.int32)
    vals = rng.integers(0, 1 << 30, (3, 1024)).astype(np.int32)
    ko, vo = sp.bitonic_sort2(torch.from_numpy(keys), torch.from_numpy(vals))
    for b in range(3):
        one_k, one_v = sp.bitonic_sort2(torch.from_numpy(keys[b:b + 1]),
                                        torch.from_numpy(vals[b:b + 1]))
        assert torch.equal(one_k[0], ko[b]) and torch.equal(one_v[0], vo[b])
        assert np.array_equal(ko[b].numpy(), np.sort(keys[b]))
        assert sorted(zip(keys[b], vals[b])) == sorted(zip(ko[b].tolist(),
                                                           vo[b].tolist()))
    lk, _lv = sp.library_sort2(torch.from_numpy(keys), torch.from_numpy(vals))
    assert torch.equal(lk, ko)
    with pytest.raises(ValueError):
        sp.bitonic_sort2(torch.zeros((1, 6), dtype=torch.int32),
                         torch.zeros((1, 6), dtype=torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serial_kernel_matches_plain(cuda, blocks, tables):
    args = [torch.from_numpy(a) for a in tables]
    want, want_len = sd.decode_blocks_serial_plain(*args, BLK)
    got, got_len = sd.decode_blocks_serial(*(a.to(cuda) for a in args), BLK)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got_len.cpu(),
                                                        want_len)


#: rows on each side of every level of the kernel's layout: registers
#: (16 pairs a thread), warp shuffles (512 a warp), one CTA (8,192), a
#: cluster (65,536) and past it; key ranges of 3 and 64 make ties dense
SORT2_LEVELS = [(B, n, r) for n in (8, 16, 32, 512, 8192, 16384, 65536,
                                    131072)
                for B, r in ((2, 3), (1, 64))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,key_range", [(1, sp.N, 64), (5, sp.N, 1 << 30),
                                           (3, 4096, 3), (2, 2, 2)]
                         + SORT2_LEVELS)
def test_sort2_kernel_matches_plain(cuda, B, n, key_range):
    rng = np.random.default_rng(B)
    keys = torch.from_numpy(rng.integers(0, key_range, (B, n))
                            .astype(np.int32))
    vals = torch.from_numpy(rng.integers(0, 1 << 30, (B, n)).astype(np.int32))
    want = sp.bitonic_sort2_plain(keys, vals)
    got = sp.bitonic_sort2(keys.to(cuda), vals.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
