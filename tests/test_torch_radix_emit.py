"""The arithmetic of the two encoder kernels' designs, modelled in numpy
against the plain versions they must equal (zig_lz4_tpu_torch.ops.
torch_block).

* ``enc_match`` sorts positions by stable byte passes of an LSD radix
  sort (``kernels/csrc/sort_radix.cuh``, ``encode_block.cu``).  The model
  runs each pass as the kernel does -- warps over contiguous slices of
  the order, per-warp digit counts, one exclusive scan over (digit,
  warp) digit-major, the scatter by rank within the warp, a pass skipped
  when one digit holds every row -- over exactly the bytes the kernel
  reads: window bytes p+8..p+11 and p+4..p+7, zero at and past n, then
  s0's bytes p..p+3, which are 0xFF on the rows past n - 4.  Its orders
  must equal ``_stable_order((s0, wins[0], wins[1]))`` and
  ``_stable_order((s0,))`` on windows dense in ties.
* ``enc_parse_emit`` places its sequences by block scans over the chosen
  rows: an entry merges into the one before when it starts at that
  one's end at the same offset, the last entry of each group finds its
  head by a max-scan and sizes the group's header and literal run, and
  an exclusive sum-scan of the sizes places each group.  The model does
  that with numpy scans; its payload and ``out_len`` must equal
  ``parse_emit_plain``'s at 4 KB in every configuration below level 10
  and the JAX payloads of the 64 KB goldens.

Tolerance: none; orders, payloads and lengths are compared exactly.  No
JAX compile: the reference enters through the checked-in goldens.
"""

import numpy as np
import pytest
import torch

from test_torch_encode import (GOLDEN_BLOCKS, GOLDENS, LEVEL_CONFIGS,
                               LEVEL_GOLDENS, _pack, _payloads,
                               _static_inputs, tie_dense)
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb

#: the kernel's block: 1024 threads, 32 warps, 8-bit digits
THREADS, WARPS, DIGITS = 1024, 32, 256
#: (byte offset, s0 override) of each pass, least significant first
LESS12 = [(k, False) for k in (8, 9, 10, 11, 4, 5, 6, 7)] + \
    [(k, True) for k in range(4)]
LESS_S0 = [(k, True) for k in range(4)]
#: valid lengths of the sort cases; blk is 5,000 below 64 KB, not a power
#: of two, and 65,536 for the full window
SORT_LENS = (0, 1, 3, 4, 5, 11, 12, 13, 4095, 65536)
TIE_NAMES = ("zeros", "ones", "period1", "period2", "period3", "period4",
             "period7", "binary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def radix_pass(order: np.ndarray, digit: np.ndarray) -> np.ndarray:
    """One stable pass of the kernel over ``order`` (R rows): ``digit``
    is each row's byte, indexed by row."""
    R = len(order)
    J = -(-R // THREADS)                      # tiles of 32 rows a warp
    warp = np.arange(R) // (J * 32)
    d = digit[order]
    counts = np.zeros((WARPS, DIGITS), np.int64)
    np.add.at(counts, (warp, d), 1)
    if (counts.sum(0) == R).any():            # one digit holds every row
        return order
    flat = counts.T.reshape(-1)               # (digit, warp), digit-major
    base = (np.cumsum(flat) - flat).reshape(DIGITS, WARPS)
    key = warp * DIGITS + d
    srt = np.argsort(key, kind="stable")
    first = np.searchsorted(key[srt], key[srt], "left")
    rank = np.empty(R, np.int64)
    rank[srt] = np.arange(R) - first          # earlier rows of (warp, digit)
    dest = base[d, warp] + rank
    assert np.array_equal(np.sort(dest), np.arange(R))
    out = np.empty_like(order)
    out[dest] = order
    return out


def model_order(row: np.ndarray, n: int, schedule) -> np.ndarray:
    """The kernel's sort of the positions [0, blk) of a window: the
    identity order through the passes of ``schedule``."""
    blk = len(row)
    win = np.zeros(blk + 16, np.int64)
    win[:n] = row[:n]                         # zero at and past n
    p = np.arange(blk)
    order = p.copy()
    for k, s0 in schedule:
        digit = win[p + k]
        if s0:
            digit = np.where(p > n - 4, 0xFF, digit)
        order = radix_pass(order, digit)
    return order


def test_radix_pass_is_stable_with_many_warps():
    """Every warp holds rows, the digits repeat across warps and tiles,
    and the pass keeps each digit's rows in their current order."""
    rng = np.random.default_rng(3)
    R = 50_000
    order = rng.permutation(R)
    digit = rng.integers(0, 5, R)
    got = radix_pass(order, digit)
    assert np.array_equal(got, order[np.argsort(digit[order],
                                                kind="stable")])


@pytest.mark.parametrize("name", TIE_NAMES)
@pytest.mark.parametrize("n", SORT_LENS)
def test_radix_schedule_matches_plain_orders(n, name):
    blk = 65536 if n == 65536 else 5000
    row = tie_dense(blk, 17)[TIE_NAMES.index(name)]
    s0, wins, _wb = tb._windows(torch.from_numpy(row), n)
    want12 = tb._stable_order((s0, wins[0], wins[1])).numpy()
    want_s0 = tb._stable_order((s0,)).numpy()
    assert np.array_equal(model_order(row, n, LESS12), want12)
    assert np.array_equal(model_order(row, n, LESS_S0), want_s0)


def test_radix_schedule_breaks_ties_with_a_ff_key():
    """A real s0 of four 0xFF bytes ties with the tail rows' override;
    the later keys, then the position, break the tie, and the tail rows'
    at() keys have no override."""
    blk, n = 300, 290
    row = np.zeros(blk, np.uint8)
    row[100:104] = 0xFF                       # s0(100) = 0xFFFFFFFF
    row[104:112] = 7
    row[280:290] = 0xFF
    s0, wins, _wb = tb._windows(torch.from_numpy(row), n)
    want = tb._stable_order((s0, wins[0], wins[1])).numpy()
    assert np.array_equal(model_order(row, n, LESS12), want)
    # the rows whose s0 is 0xFFFFFFFF, by their bytes (100 and 280..286)
    # or by the override (287..299), close the order together
    ff = [100] + list(range(280, 300))
    assert sorted(want[-len(ff):]) == ff


def _len_bytes(v):
    """Continuation bytes of a length field, v = length - 15."""
    return np.where(v >= 0, v // 255 + 1, 0)


def emit_model(data: bytes, n: int, start: int, chosen, ml, off,
               back) -> bytes:
    """The kernel's parallel emission of one window, with numpy scans:
    group heads, each group's header and literal run sized by its last
    entry, places by an exclusive sum-scan, then the tail run."""
    if n == start:
        return b""
    p = np.asarray(chosen, np.int64)
    ml, off, back = (np.asarray(x, np.int64) for x in (ml, off, back))
    m = len(p)
    groups = []
    total, tail = 0, start
    if m:
        e, o = p + ml[p], off[p]
        head = np.ones(m, bool)
        head[1:] = ~((e[:-1] == p[1:]) & (o[:-1] == o[1:]))
        last = np.ones(m, bool)
        last[:-1] = head[1:]
        h = np.maximum.accumulate(np.where(head, np.arange(m), -1))
        prev_e = np.concatenate([[-1], e[:-1]])
        L = np.nonzero(last)[0]
        H = h[L]
        ph = p[H]
        ls = np.maximum(prev_e[H], start)
        bq = np.maximum(np.minimum(np.minimum(back[ph], ph - ls),
                                   ph - o[L]), 0)
        ms = ph - bq
        lit, mml = ms - ls, e[L] - ms
        size = 1 + _len_bytes(lit - 15) + lit + 2 + _len_bytes(mml - 19)
        at = np.cumsum(size) - size
        groups = list(zip(at, ls, lit, mml, o[L], size))
        total, tail = int(size.sum()), max(int(e[-1]), start)
    lit_t = n - tail
    out = bytearray(total + 1 + int(_len_bytes(lit_t - 15)) + lit_t)

    def put_len(q, v):
        while v >= 255:
            out[q] = 255
            q, v = q + 1, v - 255
        out[q] = v
        return q + 1

    for at_g, ls_g, lit_g, mml_g, off_g, size_g in groups:
        q = int(at_g)
        out[q] = (min(lit_g, 15) << 4) | min(mml_g - 4, 15)
        q += 1
        if lit_g >= 15:
            q = put_len(q, int(lit_g) - 15)
        out[q:q + lit_g] = data[ls_g:ls_g + lit_g]
        q += int(lit_g)
        out[q:q + 2] = bytes((int(off_g) & 0xFF, int(off_g) >> 8))
        q += 2
        if mml_g - 4 >= 15:
            q = put_len(q, int(mml_g) - 19)
        assert q == at_g + size_g
    q = total
    out[q] = min(lit_t, 15) << 4
    q += 1
    if lit_t >= 15:
        q = put_len(q, lit_t - 15)
    out[q:q + lit_t] = data[tail:n]
    assert q + lit_t == len(out)
    return bytes(out)


def _emit_models(windows, lens, starts, hc, accel):
    """(model payloads, plain payloads) of every window at (hc, accel)."""
    w, n, s = (torch.from_numpy(a) for a in (windows, lens, starts))
    pk = tb.match_candidates_plain(w, n, hc, accel)
    out_p, len_p = tb.parse_emit_plain(w, n, s, pk, hc, accel)
    W, _probes = tb._finder(hc, 0, accel)
    got, want = [], []
    for i in range(len(lens)):
        chosen, ml, off, back = tb._parse_one(pk[i], int(lens[i]),
                                              int(starts[i]), 4 + 4 * W,
                                              hc > 0)
        got.append(emit_model(windows[i].tobytes(), int(lens[i]),
                              int(starts[i]), chosen, ml, off, back))
        want.append(out_p[i, :int(len_p[i])].numpy().tobytes())
    return got, want


@pytest.mark.parametrize("config", ["hc9"] + sorted(LEVEL_CONFIGS))
def test_emission_model_matches_plain_4k(config):
    hc, accel = {"hc9": (9, 1), **LEVEL_CONFIGS}[config]
    _rows, windows, lens, starts = _pack(_static_inputs())
    assert (starts > 0).any()
    got, want = _emit_models(windows, lens, starts, hc, accel)
    assert got == want


@pytest.fixture(scope="module")
def corpus64k():
    c = make_corpus(2)
    return np.stack([np.frombuffer(c[i * 65536:(i + 1) * 65536], np.uint8)
                     for i in GOLDEN_BLOCKS])


@pytest.mark.parametrize("level", [9, 0, 4])
def test_emission_model_matches_goldens_64k(level, corpus64k):
    hc, _deep = tb.level_params(level)
    if level == 9:
        z = np.load(GOLDENS)
        gold = _payloads(z["payloads"], z["out_len"])
    else:
        z = np.load(LEVEL_GOLDENS)
        gold = _payloads(z[f"payloads_l{level}"], z[f"out_len_l{level}"])
    k = len(GOLDEN_BLOCKS)
    got, want = _emit_models(corpus64k, np.full(k, 65536, np.int32),
                             np.zeros(k, np.int32), hc, 1)
    assert got == want == gold


@pytest.mark.parametrize("start", [1, 20_000, 65_531])
def test_emission_model_with_a_late_start_64k(start, corpus64k):
    """Emission from ``start`` on, the bytes before it history, at n <
    blk too."""
    windows = corpus64k[[1, 3]]
    lens = np.array([65536, 50_000], np.int32)
    starts = np.minimum(np.full(2, start, np.int32), lens)
    got, want = _emit_models(windows, lens, starts, 9, 1)
    assert got == want


def test_emission_model_merges_chained_selections():
    """Chosen rows that continue each other at one offset merge into
    one sequence; a change of offset starts a new one."""
    data = bytes(range(64)) * 4
    n = len(data)
    ml = np.zeros(n, np.int64)
    off = np.full(n, 1 << 20, np.int64)
    back = np.zeros(n, np.int64)
    for p, m, o in ((64, 20, 64), (84, 30, 64), (114, 10, 64),
                    (130, 40, 128), (170, 60, 64)):
        ml[p], off[p] = m, o
    chosen = [64, 84, 114, 130, 170]
    got = emit_model(data, n, 0, chosen, ml, off, back)
    # three sequences: 64..124 at offset 64, 130..170 at 128, 170..230
    assert got[0] == (15 << 4) | 15 and got[1] == 64 - 15
    assert got == tb._emit_one(data, n, 0, chosen, ml.tolist(),
                               off.tolist(), back.tolist())
