"""The sorts of the two wide finders (``enc_match_wide``,
``enc_deep_match_wide``), modelled in numpy against the plain orders and
ranks they must equal (zig_lz4_tpu_torch.ops.torch_block).

Both kernels hold a window's position order in the shared memory of one
thread-block cluster and sort it by stable byte-digit LSD radix passes
across the cluster (``kernels/csrc/radix_cluster.cuh``).  The model runs
each pass as the cluster does: the order cut into C slices of 1024 J rows
(``wide_cluster_shape``), each CTA's warps over contiguous runs of J
tiles of 32 rows, per-warp digit counts, one exclusive scan over (digit,
CTA, warp), digit-major, the scatter by rank within the warp into
whichever slice holds the destination, and a pass skipped when one digit
holds every row.  Its digits are exactly the bytes the kernels read:

* ``Less12`` and ``LessS0``: window bytes p+8..p+11, p+4..p+7, then s0's
  bytes p..p+3 (0xFF on the rows past n - 4), zero at and past n;
* ``Less32``: the eight words (s0, at(p+4), ..., at(p+28)), the last word
  first and each word from its low byte up, the override on s0's four
  bytes only;
* ``LessRanks``: three bytes of ``x[p + step k] + 1`` a key, x = -1 past
  the end, so that -1 sorts first (strides 32 and 256);
* only the rows [0, blk): the widths below are not multiples of 1024, so
  the last slice is short, and rows of equal keys span slices.

The class numbering (``ranksN``) is modelled as the cluster scan: class
boundaries counted per thread's chunk of each CTA's slice, the row before
a slice coming from the CTA before, and each CTA's count offset by those
of the CTAs before it.  Orders and ranks are held exactly (no tolerance)
against ``_stable_order`` and ``_ranks`` on windows dense in ties and on
a window of ``tests/fixtures/wide_corpus.npz``.  No JAX compile.

The spread shapes a launch of one window takes (``wide_spread_shape``:
16 CTAs of 5 rows a thread at 69,632 bytes, of 7 at 102,400, where the
last CTAs hold no row) are modelled the same way, and the rule itself is
held with the clusters the card holds at once passed in; with the
launches faked on ``meta`` tensors, so is the counter
``enc.spread_windows`` over a part of the benchmark's ``hits-hc9.insert``
cell (4,305 windows) and its bulk cells (none).

``cuda``-marked tests hold both kernels against their plain versions on
the card at 131,072 and 327,680 bytes, a window launched alone (spread)
against the same window in a launch of 64 (least shape) at 69,632 and
102,400 bytes, and the frames of ``tests/fixtures/narrow_frames.npz``.
"""

import collections
import functools
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from lz4bench import harness, traffic
from test_torch_encode import tie_dense
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch import trace
from zig_lz4_tpu_torch.constants import compress_bound
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb
from zig_lz4_tpu_torch.parallel import sharded

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens as mtg  # noqa: E402  (inputs of the goldens)

#: the benchmark's directory, for its configurations
BENCH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "lz4bench")

#: a CTA of the cluster: 1024 threads, 32 warps; 8-bit digits
THREADS, WARPS, DIGITS = 1024, 32, 256
#: (byte offset, s0 override) of each pass, least significant first
LESS12 = [(k, False) for k in (8, 9, 10, 11, 4, 5, 6, 7)] + \
    [(k, True) for k in range(4)]
LESS_S0 = [(k, True) for k in range(4)]
LESS32 = [(4 * wk + b, wk == 0) for wk in range(7, -1, -1) for b in range(4)]
#: widths in the wide range, neither a multiple of 1024 nor of 4
WIDE = 65_601
TIE_NAMES = ("zeros", "ones", "period1", "period2", "period3", "period4",
             "period7", "binary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(rows: int, C: int, J: int):
    """(CTA, warp) of each row index of the order: CTA r holds rows
    [r R, r R + R), R = 1024 J, and its warp w the rows [w 32 J,
    w 32 J + 32 J) of its slice."""
    i = np.arange(rows)
    R = THREADS * J
    assert C * R >= rows
    return i // R, (i % R) // (32 * J)


def cluster_pass(order: np.ndarray, digit: np.ndarray, C: int,
                 J: int) -> np.ndarray:
    """One stable pass of the cluster over ``order``: ``digit`` is each
    row's byte, indexed by position."""
    rows = len(order)
    cta, warp = _layout(rows, C, J)
    d = digit[order]
    counts = np.zeros((DIGITS, C, WARPS), np.int64)
    np.add.at(counts, (d, cta, warp), 1)
    if (counts.sum((1, 2)) == rows).any():     # one digit holds every row
        return order
    flat = counts.reshape(-1)                 # (digit, CTA, warp)
    base = (np.cumsum(flat) - flat).reshape(DIGITS, C, WARPS)
    key = (cta * WARPS + warp) * DIGITS + d
    srt = np.argsort(key, kind="stable")
    first = np.searchsorted(key[srt], key[srt], "left")
    rank = np.empty(rows, np.int64)
    rank[srt] = np.arange(rows) - first       # earlier rows of the warp
    dest = base[d, cta, warp] + rank
    assert np.array_equal(np.sort(dest), np.arange(rows))
    out = np.empty_like(order)
    out[dest] = order
    return out


def cluster_sort(rows: int, digits, shape=None) -> np.ndarray:
    """The identity order over ``rows`` rows through the passes of
    ``digits`` (each a digit array by position), at cluster shape
    ``shape``, by default the kernels' least for ``rows``-byte windows."""
    C, J = shape or tb.wide_cluster_shape(rows)
    order = np.arange(rows)
    for digit in digits:
        order = cluster_pass(order, digit, C, J)
    return order


def window_digits(row: np.ndarray, n: int, schedule):
    """The digit arrays of ``schedule`` = [(k, s0)] over a window."""
    blk = len(row)
    win = np.zeros(blk + 40, np.int64)
    win[:n] = row[:n]                         # zero at and past n
    p = np.arange(blk)
    for k, s0 in schedule:
        digit = win[p + k]
        yield np.where(p > n - 4, 0xFF, digit) if s0 else digit


def rank_digits(x: np.ndarray, step: int, nk: int):
    """The digit arrays of the order of the nk keys x[p + step k]: three
    bytes of x + 1 a key, the last key first, x = -1 past the end."""
    blk = len(x)
    xe = np.concatenate([x, np.full(step * nk, -1, np.int64)]) + 1
    p = np.arange(blk)
    for k in range(nk - 1, -1, -1):
        v = xe[p + step * k]
        assert v.min() >= 0 and v.max() < 1 << 24
        for b in range(3):
            yield (v >> (8 * b)) & 0xFF


def cluster_ranks(order: np.ndarray, same, shape=None) -> np.ndarray:
    """The class numbers of a sorted order as the cluster scans them at
    ``shape`` (as ``cluster_sort``): ``same(a, b)`` says whether
    positions a and b are in one class."""
    rows = len(order)
    C, J = shape or tb.wide_cluster_shape(rows)
    R = THREADS * J
    bound = np.ones(rows, bool)
    bound[1:] = ~same(order[:-1], order[1:])  # row t - 1 from any slice
    ranks = np.empty(rows, np.int64)
    cta_counts = [int(bound[r * R:(r + 1) * R].sum()) for r in range(C)]
    for r in range(C):
        lo = min(r * R, rows)
        nloc = min(R, rows - lo)
        chunk = max(-(-nloc // THREADS), 1)
        run = sum(cta_counts[:r])             # the CTAs before this one
        for t0 in range(0, nloc, chunk):      # each thread's chunk, in order
            b = bound[lo + t0:lo + min(t0 + chunk, nloc)]
            ranks[order[lo + t0:lo + t0 + len(b)]] = run + np.cumsum(b)
            run += int(b.sum())
    return ranks


def _keys(row: np.ndarray, n: int):
    s0, wins, _wb = tb._windows(torch.from_numpy(row), n)
    return s0, wins


def test_cluster_pass_is_stable_across_ctas():
    """Every CTA and warp holds rows, the digits repeat across slices, and
    the pass keeps each digit's rows in their current order."""
    rng = np.random.default_rng(3)
    rows = 70_001
    order = rng.permutation(rows)
    digit = rng.integers(0, 5, rows)
    for C, J in ((4, 18), (16, 5), (8, 9)):
        got = cluster_pass(order, digit, C, J)
        assert np.array_equal(got, order[np.argsort(digit[order],
                                                    kind="stable")])


def test_wide_cluster_shape():
    """The kernels' slices cover the window; 8 CTAs at the dictionary
    windows, 16 at 256 KB blocks and sub-span windows, and the registers'
    bounds of 20 and 32 rows a thread."""
    assert tb.wide_cluster_shape(131_072) == (8, 16)
    assert tb.wide_cluster_shape(262_144) == (16, 16)
    assert tb.wide_cluster_shape(327_680) == (16, 20)
    assert tb.wide_cluster_shape((1 << 19) - 1) == (16, 32)
    for blk in (65_537, WIDE, 100_003, 135_536, 200_000, 327_681):
        C, J = tb.wide_cluster_shape(blk)
        assert C & (C - 1) == 0 and C <= 16
        assert C * THREADS * J >= blk > C * THREADS * (J - 1)
        assert J <= (20 if blk <= 327_680 else 32)


@pytest.mark.parametrize("name", TIE_NAMES)
def test_wide_window_orders_match_plain(name):
    """Less12 and LessS0 at a width whose last slice is short, and at a
    length that leaves tail rows (s0 override) and zero bytes past n."""
    row = tie_dense(WIDE, 29)[TIE_NAMES.index(name)]
    for n in (WIDE, WIDE - 70_000 % WIDE):
        s0, wins = _keys(row, n)
        want12 = tb._stable_order((s0, wins[0], wins[1])).numpy()
        want_s0 = tb._stable_order((s0,)).numpy()
        assert np.array_equal(
            cluster_sort(WIDE, window_digits(row, n, LESS12)), want12)
        assert np.array_equal(
            cluster_sort(WIDE, window_digits(row, n, LESS_S0)), want_s0)


@pytest.mark.parametrize("name", ("zeros", "period3", "binary"))
def test_wide_32_byte_order_and_ranks_match_plain(name):
    """Less32 with s0's override on its four bytes only, and its class
    numbering across slice edges (the zeros window is one class but for
    its tail)."""
    row = tie_dense(WIDE, 31)[TIE_NAMES.index(name)]
    n = WIDE - 9
    s0, wins = _keys(row, n)
    keys = (s0,) + tuple(wins[:7])
    order = cluster_sort(WIDE, window_digits(row, n, LESS32))
    assert np.array_equal(order, tb._stable_order(keys).numpy())
    kv = np.stack([k.numpy() for k in keys])
    got = cluster_ranks(order, lambda a, b: (kv[:, a] == kv[:, b]).all(0))
    assert np.array_equal(got, tb._ranks(keys).numpy())


def _rank_orders(row: np.ndarray, n: int, shape=None):
    """The deep rank orders of a window by the model at ``shape`` (as
    ``cluster_sort``), against the plain orders: the 256-byte rank's (r,
    step 32, 8 keys), the grand orders of deep 1 and 2 (r, 4 and 8 keys)
    and of deep 3 (r2, step 256, 4 keys), and r2's class numbers across
    slice edges."""
    blk = len(row)
    s0, wins = _keys(row, n)
    r = tb._ranks((s0,) + tuple(wins[:7]))
    rn = r.numpy()
    ops = [tb._shl(r, 32 * k) for k in range(8)]
    order = cluster_sort(blk, rank_digits(rn, 32, 8), shape)
    assert np.array_equal(order, tb._stable_order(tuple(ops)).numpy())
    kv = np.stack([o.numpy() for o in ops])
    r2 = cluster_ranks(order, lambda a, b: (kv[:, a] == kv[:, b]).all(0),
                       shape)
    r2_plain = tb._ranks(tuple(ops))
    assert np.array_equal(r2, r2_plain.numpy())
    for x, step, nk in ((r, 32, 4), (r, 32, 8), (r2_plain, 256, 4)):
        want = tb._stable_order(tuple(tb._shl(x, step * k)
                                      for k in range(nk))).numpy()
        assert np.array_equal(
            cluster_sort(blk, rank_digits(x.numpy(), step, nk), shape), want)


@pytest.mark.parametrize("name", ("period7", "binary"))
def test_wide_rank_orders_match_plain(name):
    _rank_orders(tie_dense(WIDE, 37)[TIE_NAMES.index(name)], WIDE - 3)


def test_wide_corpus_window_orders_match_plain():
    """A 131,072-byte window of the wide goldens' corpus (a dictionary
    window of the 1 MB frame's bytes): every order of both finders."""
    windows, lens, _starts = mtg.wide_windows(make_corpus(mtg.CORPUS_MB),
                                              "w131k")
    row, n = windows[0], int(lens[0])
    s0, wins = _keys(row, n)
    for sched, keys in ((LESS12, (s0, wins[0], wins[1])), (LESS_S0, (s0,)),
                        (LESS32, (s0,) + tuple(wins[:7]))):
        assert np.array_equal(
            cluster_sort(len(row), window_digits(row, n, sched)),
            tb._stable_order(keys).numpy())
    _rank_orders(row, n)


#: the spread shapes of a launch of one window (``wide_spread_shape``):
#: a 64 KB insert block's width and the widest of the one-window blocks
SPREAD = {69_632: (16, 5), 102_400: (16, 7)}


def _fake_active(C: int, J: int) -> int:
    """Clusters held at once as on a card of 120 SMs free for whole
    clusters, one CTA an SM: 7 of 16 CTAs, 15 of 8, 30 of 4."""
    return 120 // C


@pytest.mark.parametrize("name", ("zeros", "period2", "period7", "binary"))
@pytest.mark.parametrize("blk", sorted(SPREAD))
def test_spread_window_orders_match_plain(blk, name):
    """Less12 and LessS0 at the spread shapes, whose last CTAs hold no
    row, at a full window, 5 bytes short (tail rows) and 48,771 valid
    bytes (a third of the rows share the tail's key, across slices)."""
    shape = SPREAD[blk]
    assert tb.wide_spread_shape(blk, 1, _fake_active) == shape
    row = tie_dense(blk, 43)[TIE_NAMES.index(name)]
    for n in (blk, blk - 5, 48_771):
        s0, wins = _keys(row, n)
        assert np.array_equal(
            cluster_sort(blk, window_digits(row, n, LESS12), shape),
            tb._stable_order((s0, wins[0], wins[1])).numpy())
        assert np.array_equal(
            cluster_sort(blk, window_digits(row, n, LESS_S0), shape),
            tb._stable_order((s0,)).numpy())


@pytest.mark.parametrize("blk", sorted(SPREAD))
def test_spread_32_byte_order_and_ranks_match_plain(blk):
    """Less32 and its class numbering at the spread shapes: the numbering
    scan passes the CTAs that hold no row."""
    shape = SPREAD[blk]
    row = tie_dense(blk, 47)[TIE_NAMES.index("period3")]
    n = blk - 9
    s0, wins = _keys(row, n)
    keys = (s0,) + tuple(wins[:7])
    order = cluster_sort(blk, window_digits(row, n, LESS32), shape)
    assert np.array_equal(order, tb._stable_order(keys).numpy())
    kv = np.stack([k.numpy() for k in keys])
    got = cluster_ranks(order, lambda a, b: (kv[:, a] == kv[:, b]).all(0),
                        shape)
    assert np.array_equal(got, tb._ranks(keys).numpy())
    _rank_orders(tie_dense(blk, 53)[TIE_NAMES.index("binary")], blk - 3,
                 shape)


@pytest.mark.parametrize("blk", sorted(SPREAD))
def test_spread_corpus_window_orders_match_plain(blk):
    """The first ``blk`` bytes of a window of the wide goldens' corpus at
    the spread shape: every order of both finders and the rank orders."""
    windows, lens, _starts = mtg.wide_windows(make_corpus(mtg.CORPUS_MB),
                                              "w131k")
    row, n = windows[0, :blk], min(int(lens[0]), blk - 5)
    shape = SPREAD[blk]
    s0, wins = _keys(row, n)
    for sched, keys in ((LESS12, (s0, wins[0], wins[1])), (LESS_S0, (s0,)),
                        (LESS32, (s0,) + tuple(wins[:7]))):
        assert np.array_equal(
            cluster_sort(blk, window_digits(row, n, sched), shape),
            tb._stable_order(keys).numpy())
    _rank_orders(row, n, shape)


def test_wide_spread_shape():
    """The launch rule with the clusters held at once passed in: C never
    below the least shape's, every shape one the kernels take, the
    widest C that holds every window, and the least shape where no wider
    C holds them all."""
    for blk in (65_537, WIDE, 69_632, 77_824, 102_400, 131_072, 200_000,
                262_144, 307_200, 327_680, (1 << 19) - 1):
        least = tb.wide_cluster_shape(blk)
        for windows in (1, 2, 7, 8, 15, 16, 30, 31, 64, 192):
            for active in (_fake_active, lambda C, J: 0, lambda C, J: 1,
                           lambda C, J: 1 << 20):
                C, J = tb.wide_spread_shape(blk, windows, active)
                assert least[0] <= C <= 16 and C & (C - 1) == 0
                assert C * THREADS * J >= blk > C * THREADS * (J - 1)
                assert J <= least[1]
                wider = [c for c in (16, 8, 4, 2) if c > least[0]
                         and active(c, -(-blk // (c * THREADS))) >= windows]
                assert C == (wider[0] if wider else least[0])
                if not wider:
                    assert (C, J) == least
    assert tb.wide_spread_shape(69_632, 1, _fake_active) == (16, 5)
    assert tb.wide_spread_shape(69_632, 8, _fake_active) == (8, 9)
    assert tb.wide_spread_shape(69_632, 64, _fake_active) == (4, 17)
    assert tb.wide_spread_shape(102_400, 1, _fake_active) == (16, 7)
    assert tb.wide_spread_shape(131_072, 9, _fake_active) == (8, 16)


class _Launches:
    """``torch_block.launch`` and the clusters held at once faked, so that
    ``match_candidates`` takes its kernel route on ``meta`` tensors: the
    launches it makes, by name and arguments."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tb, "launch",
                            lambda name, *a: self.calls.append((name, a)))
        monkeypatch.setattr(tb, "_active_clusters",
                            lambda _dev, _deep, _blk, C, J:
                            _fake_active(C, J))


@pytest.fixture
def recorder():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


@pytest.mark.parametrize("hc,deep", [(9, 0), (0, 0), (8, 3)])
def test_launch_shape_and_counter(monkeypatch, recorder, hc, deep):
    """Both wide finders launch at the rule's shape, and
    ``enc.spread_windows`` counts the windows of the launches it spreads."""
    rec = _Launches(monkeypatch)
    want = {(69_632, 1): (16, 5), (69_632, 8): (8, 9),
            (69_632, 64): (4, 17), (102_400, 2): (16, 7),
            (131_072, 9): (8, 16), (307_200, 2): (16, 19),
            (327_680, 192): (16, 20)}
    spread = 0
    for (blk, B), shape in want.items():
        w = torch.empty((B, blk), dtype=torch.uint8, device="meta")
        n = torch.empty(B, dtype=torch.int32, device="meta")
        tb.match_candidates(w, n, hc, 1, deep)
        name, args = rec.calls[-1]
        assert name == ("enc_deep_match_wide" if deep else "enc_match_wide")
        at = 8 if deep else 7
        assert args[at:at + 2] == shape
        spread += B if shape[0] > tb.wide_cluster_shape(blk)[0] else 0
        assert trace.counters().get("enc.spread_windows", 0) == spread
    assert spread == 1 + 8 + 2


def _literal_blocks(blocks, lens, starts, hc=9, deep=0, accel=1):
    """``encode_blocks`` as the frame codec calls it, with the finder's
    route taken on ``meta`` tensors (launches faked, ``_Launches``) and
    each window's payload written as one literal run from ``starts``: a
    valid LZ4 block whatever the kernels would find."""
    tb.match_candidates(blocks.to("meta"), lens.to("meta"), hc, accel, deep)
    B, blk = blocks.shape
    out = torch.zeros((B, compress_bound(blk)), dtype=torch.uint8)
    out_len = torch.zeros(B, dtype=torch.int32)
    for i in range(B):
        lit = int(lens[i]) - int(starts[i])
        run = bytearray([min(lit, 15) << 4])
        if lit >= 15:
            run += b"\xff" * ((lit - 15) // 255) + bytes([(lit - 15) % 255])
        run += blocks[i, int(starts[i]):int(lens[i])].numpy().tobytes()
        out[i, :len(run)] = torch.frombuffer(run, dtype=torch.uint8)
        out_len[i] = len(run)
    return out, out_len


def _spread_windows(monkeypatch, config: str, sizes) -> int:
    """``enc.spread_windows`` of the benchmark configuration ``config``'s
    codec compressing one input of each size in ``sizes`` (each as many
    times as it appears), on the CPU with the launches faked."""
    _Launches(monkeypatch)
    monkeypatch.setattr(sharded, "encode_blocks", _literal_blocks)
    with open(os.path.join(BENCH, "configs", config + ".json")) as f:
        settings = harness.codec_settings(json.load(f))
    codec = sharded.ShardedFrameCodec(device="cpu", **settings)
    total = 0
    for size, times in collections.Counter(sizes).items():
        trace.reset()
        data = bytes(size)
        assert lz4f.decompress_frame(codec.compress_frame(data)) == data
        total += times * trace.counters().get("enc.spread_windows", 0)
    return total


def test_insert_part_spreads_its_one_window_blocks(monkeypatch, recorder):
    """A part of ``hits-hc9.insert``: every block of one sub-span (4,305
    of 4,689, at 69,632-102,400 bytes) launches alone and spreads; the
    384 blocks of two sub-spans launch at 307,200 bytes or more, where
    the least shape is 16 CTAs already."""
    with open(os.path.join(BENCH, "configs",
                           "clickhouse-hits-lz4hc9.json")) as f:
        sizes = traffic.part_block_sizes(json.load(f)["table"])
    assert len(sizes) == 4_689
    assert sum(s <= sharded._SUB for s in sizes) == 4_305
    assert _spread_windows(monkeypatch, "clickhouse-hits-lz4hc9",
                           sizes) == 4_305


@pytest.mark.parametrize("config,size", [("lz4hc9-b64k", 4 << 20),
                                         ("lz4-l1-b4m", 8 << 20),
                                         ("lz4hc12-b4m", 8 << 20)])
def test_bulk_cells_spread_nothing(monkeypatch, recorder, config, size):
    """The bulk cells' compress: 64 KB blocks never reach the wide
    finders, and 4 MB blocks launch their 327,680-byte sub-span windows
    together, at 16 CTAs already (8 MiB here, 48 MiB in the cells)."""
    assert _spread_windows(monkeypatch, config, [size]) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_windows(blk: int) -> np.ndarray:
    """Tie-dense windows, a dense one (short matches every few bytes) and
    one that a single match covers (all zero is among the tie-dense)."""
    rng = np.random.default_rng(blk)
    return np.concatenate([tie_dense(blk, 41),
                           rng.integers(0, 4, (1, blk), dtype=np.uint8)])


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [131_072, 327_680])
@pytest.mark.parametrize("hc", [9, 3, 0])
def test_enc_match_wide_matches_plain(cuda, blk, hc):
    windows = _kernel_windows(blk)
    lens = np.full(len(windows), blk, np.int32)
    lens[1::2] -= 5                           # tail rows and zero bytes
    w, n = torch.from_numpy(windows), torch.from_numpy(lens)
    got = tb.match_candidates(w.to(cuda), n.to(cuda), hc)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tb.match_candidates_plain(w, n, hc))


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [131_072, 327_680])
@pytest.mark.parametrize("deep", [1, 2, 3])
def test_enc_deep_match_wide_matches_plain(cuda, blk, deep):
    windows = _kernel_windows(blk)[[0, 4, 6, 7, 8]]
    lens = np.full(len(windows), blk, np.int32)
    lens[1::2] -= 5
    w, n = torch.from_numpy(windows), torch.from_numpy(lens)
    got = tb.match_candidates(w.to(cuda), n.to(cuda), 8, 1, deep)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(),
                       tb.match_candidates_plain(w, n, 8, 1, deep))


@pytest.mark.cuda
@pytest.mark.parametrize("hc,deep", [(9, 0), (8, 3)])
def test_wide_finders_past_327680_bytes(cuda, hc, deep):
    """Windows past the sub-span width take 16 CTAs of up to 32 rows a
    thread (the kernels' second register bound)."""
    blk = 400_003
    assert tb.wide_cluster_shape(blk) == (16, 25)
    windows = _kernel_windows(blk)[[4, 7, 8]]
    lens = np.array([blk, blk - 5, 70_001], np.int32)
    w, n = torch.from_numpy(windows), torch.from_numpy(lens)
    got = tb.match_candidates(w.to(cuda), n.to(cuda), hc, 1, deep)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(),
                       tb.match_candidates_plain(w, n, hc, 1, deep))


@pytest.mark.cuda
@pytest.mark.parametrize("hc,deep", [(9, 0), (0, 0), (8, 3)])
@pytest.mark.parametrize("blk", sorted(SPREAD))
def test_spread_launch_matches_least_and_plain(cuda, recorder, blk, hc,
                                               deep):
    """Windows launched alone, at the spread shape, against the same
    windows inside a launch of 64, at the least shape, and against the
    plain version: valid lengths of the full width, 5 short and 48,771."""
    least = tb.wide_cluster_shape(blk)
    active = functools.partial(tb._active_clusters,
                               torch.cuda.current_device(), bool(deep), blk)
    assert tb.wide_spread_shape(blk, 1, active) == SPREAD[blk]
    assert active(*SPREAD[blk]) >= 1
    assert tb.wide_spread_shape(blk, 64, active) == least
    picks = _kernel_windows(blk)[[0, 4, 7, 8]]
    windows = np.repeat(picks, 3, axis=0)
    lens = np.tile(np.array([blk, blk - 5, 48_771], np.int32), len(picks))
    w, n = torch.from_numpy(windows), torch.from_numpy(lens)
    wc, nc = w.to(cuda), n.to(cuda)
    alone = torch.cat([tb.match_candidates(wc[i:i + 1], nc[i:i + 1], hc, 1,
                                           deep) for i in range(len(w))])
    assert trace.counters()["enc.spread_windows"] == len(w)
    rows = np.arange(64) % len(w)
    batch = tb.match_candidates(wc[rows], nc[rows], hc, 1, deep)
    torch.cuda.synchronize()
    assert trace.counters()["enc.spread_windows"] == len(w)
    assert torch.equal(batch.cpu(), alone.cpu()[rows])
    assert torch.equal(alone.cpu(),
                       tb.match_candidates_plain(w, n, hc, 1, deep))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(mtg.NARROW_FRAMES))
def test_card_spread_frames_equal_the_reference_frames(cuda, recorder, name):
    """The port's level-9 frames of ``NARROW_FRAMES`` on the card equal
    the JAX codec's byte for byte; a block of one sub-span launches its
    window alone, at the spread shape (``enc.spread_windows`` 1), the
    499,712-byte block its two windows at 307,200 bytes (0)."""
    data = mtg.narrow_input(make_corpus(mtg.CORPUS_MB), name)
    codec = sharded.ShardedFrameCodec(
        device=cuda, compression_level=9,
        block_size_id=lz4f.BlockSizeID.max1MB)
    frame = codec.compress_frame(data)
    with np.load(mtg.NARROW_OUT) as z:
        assert len(frame) == int(z[f"frame_{name}_len"])
        assert hashlib.sha256(frame).hexdigest() == \
            str(z[f"frame_{name}_sha256"])
    assert lz4f.decompress_frame(frame) == data
    one = len(data) <= sharded._SUB
    assert trace.counters().get("enc.spread_windows", 0) == int(one)
