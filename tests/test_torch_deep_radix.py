"""The two deep encoder kernels' designs at windows up to 64 KB, modelled
in numpy against the plain versions they must equal
(zig_lz4_tpu_torch.ops.torch_block).

* ``enc_deep_match`` sorts a window's u16 position order in one block's
  shared memory by the stable byte passes of ``sort_radix.cuh``
  (``kernels/csrc/encode_deep.cu``): the 32-byte order
  ``(s0, at(p+4), ..., at(p+28), p)`` in 32 passes over window bytes (the
  last word first, each word from its low byte up; s0's bytes 0xFF on the
  rows past n - 4, every byte zero at and past n), then the rank orders
  ``(x[p + step k], k < nk, p)`` in TWO passes a key over the bytes of
  ``x + 1`` (x = -1 past the end), then ``(s0, p)`` in 4.  Two bytes hold
  ``x + 1`` because the rows past n - 4 share one 32-byte key, so either
  rank has at most blk - 2 <= 65,534 classes.  The classes are numbered
  by runs of up to 64 sorted rows a thread, each row compared once with
  the row before.  The pass model is ``test_torch_radix_emit``'s
  (``radix_pass``): warps over contiguous slices, per-warp counts, one
  scan over (digit, warp), the scatter by rank within the warp, a pass
  skipped when one digit holds every row.
* ``enc_deep_dp`` relaxes the price parse as the reference does
  (``jax_block.py:556-683``): one warp, 32 positions a chunk, one a lane,
  from the last chunk down (a partial first chunk where 32 does not
  divide blk); a suffix min over the lanes collapses the literal chain,
  reads beyond the chunk come from the exact costs already settled, and
  the rounds stop when no lane an edge lands on changed its estimate
  (after one round when every edge leaves the chunk).  The model must give
  ``deep_dp_plain``'s state words, and no chunk may need more than
  KD / 4 + 1 = 9 rounds (the kernel stops there).

Tolerance: none; orders, ranks and state words are compared exactly.
No JAX compile: the plain versions are held against the JAX reference by
``test_torch_encode.py`` and its goldens.  ``cuda``-marked tests hold both
kernels against their plain versions on the card.
``python tests/test_torch_deep_radix.py`` prints the model's rounds a
chunk on the corpus windows of the 64 KB deep goldens.
"""

import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script: the package from the repo
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from test_torch_encode import (CASES, DEEP_CONFIGS, DEEP_LEVELS, _pack,
                               _static_inputs, tie_dense)
from test_torch_radix_emit import radix_pass
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens as mtg  # noqa: E402  (inputs of the goldens)

THREADS = 1024
#: (byte offset, s0 override) of each pass of the 32-byte order and of the
#: order (s0, p), least significant first
LESS32 = [(4 * wk + b, wk == 0) for wk in range(7, -1, -1) for b in range(4)]
LESS_S0 = [(k, True) for k in range(4)]
#: the price parse: a literal's cost, the ring's reach, the rounds a chunk
#: at most, INF_D; the capped fine length of the deep levels (W = 8)
LITC, DP_R, ROUNDS, INF = 256, 512, 9, 1 << 28
CAPPED_ML = 4 + 4 * tb._W
STATIC_NAMES = list(_static_inputs())
TIE_NAMES = ("zeros", "ones", "period1", "period2", "period3", "period4",
             "period7", "binary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# enc_deep_match: the pass schedule and the class numbering
# ---------------------------------------------------------------------

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
    """The digit arrays of the order of the nk keys x[p + step k]: two
    bytes of x + 1 a key, the last key first, x = -1 past the end."""
    blk = len(x)
    xe = np.concatenate([x, np.full(step * nk, -1, np.int64)]) + 1
    p = np.arange(blk)
    for k in range(nk - 1, -1, -1):
        v = xe[p + step * k]
        assert v.min() >= 0 and v.max() < 1 << 16
        for b in range(2):
            yield (v >> (8 * b)) & 0xFF


def block_sort(rows: int, digits) -> np.ndarray:
    """The identity order over ``rows`` rows through the kernel's passes
    of ``digits`` (each a digit array by position)."""
    order = np.arange(rows)
    for digit in digits:
        order = radix_pass(order, digit)
    return order


def block_ranks(order: np.ndarray, kv: np.ndarray) -> np.ndarray:
    """The class numbers of a sorted order as the block numbers them:
    ``kv`` holds the eight key words by position (kv[k, p]); each
    thread's run of up to 64 rows counts the rows that differ from the
    row before, a scan adds the runs' counts."""
    rows = len(order)
    chunk = max(-(-rows // THREADS), 1)
    assert chunk <= 64                        # one u64 mask a thread
    ks = kv[:, order]
    bound = np.ones(rows, bool)
    bound[1:] = (ks[:, 1:] != ks[:, :-1]).any(0)
    counts = [int(bound[t0:t0 + chunk].sum()) for t0 in range(0, rows, chunk)]
    ranks = np.empty(rows, np.int64)
    run = 0
    for t0, c in zip(range(0, rows, chunk), counts):
        ranks[order[t0:t0 + chunk]] = run + np.cumsum(bound[t0:t0 + chunk])
        run += c
    assert rows < 3 or run <= rows - 2       # the kernel's assertion
    return ranks


def _keys(row: np.ndarray, n: int):
    s0, wins, _wb = tb._windows(torch.from_numpy(row), n)
    return s0, wins


def _shl(x: np.ndarray, k: int) -> np.ndarray:
    return tb._shl(torch.from_numpy(x), k).numpy()


def deep_orders_match_plain(row: np.ndarray, n: int) -> None:
    """Every order and rank of the deep finder at deep 1-3 by the model,
    held against the plain version's: the 32-byte order and rank r, the
    256-byte order and rank r2, the grand orders, the order (s0, p)."""
    blk = len(row)
    s0, wins = _keys(row, n)
    keys32 = (s0,) + tuple(wins[:7])
    o32 = block_sort(blk, window_digits(row, n, LESS32))
    assert np.array_equal(o32, tb._stable_order(keys32).numpy())
    r = block_ranks(o32, np.stack([k.numpy() for k in keys32]))
    assert np.array_equal(r, tb._ranks(keys32).numpy())
    ops = np.stack([_shl(r, 32 * k) for k in range(8)])
    o256 = block_sort(blk, rank_digits(r, 32, 8))
    assert np.array_equal(o256, tb._stable_order(
        tuple(torch.from_numpy(o) for o in ops)).numpy())
    r2 = block_ranks(o256, ops)
    grand = {1: (r, 32, 4), 2: (r, 32, 8), 3: (r2, 256, 4)}
    for deep, (x, step, nk) in grand.items():
        tiers, nk_plain = tb._rank_tiers(s0, wins, deep)
        assert nk_plain == nk
        want = tb._stable_order(tuple(op for _L, op in tiers[-nk:]))
        assert np.array_equal(block_sort(blk, rank_digits(x, step, nk)),
                              want.numpy()), deep
        if deep == 3:                         # the model's r2 is plain's
            assert np.array_equal(_shl(r2, 0), tiers[7][1].numpy())
    assert np.array_equal(block_sort(blk, window_digits(row, n, LESS_S0)),
                          tb._stable_order((s0,)).numpy())


def test_pass_counts():
    """32 + 4 passes over window bytes at every level, 2 a rank key:
    level 10 sorts in 44 passes, 11 in 52, 12 in 60."""
    passes = {deep: len(LESS32) + len(LESS_S0) + 2 * nk + (16 if deep == 3
                                                             else 0)
              for deep, nk in ((1, 4), (2, 8), (3, 4))}
    assert passes == {1: 44, 2: 52, 3: 60}


@pytest.fixture(scope="module")
def static_batch():
    return _pack(_static_inputs())


@pytest.mark.parametrize("name", STATIC_NAMES)
def test_radix_model_matches_plain_orders_4k(name, static_batch):
    rows, windows, lens, _starts = static_batch
    for r in rows[name]:
        deep_orders_match_plain(windows[r], int(lens[r]))


@pytest.fixture(scope="module")
def deep_rows_64k():
    return mtg.deep_rows(make_corpus(mtg.CORPUS_MB))


@pytest.mark.parametrize("k", [0, 10])
def test_radix_model_matches_plain_orders_64k(k, deep_rows_64k):
    """A corpus block and the code-like window of the 64 KB deep goldens,
    full width."""
    windows, lens, _starts = deep_rows_64k
    deep_orders_match_plain(windows[k], int(lens[k]))


@pytest.mark.parametrize("name", ("zeros", "period3", "binary"))
def test_radix_model_matches_plain_orders_tie_dense(name):
    """Windows dense in ties, n short of blk: long runs of one class and
    the override on s0's bytes only."""
    row = tie_dense(5000, 43)[TIE_NAMES.index(name)]
    deep_orders_match_plain(row, 4991)


@pytest.mark.parametrize("n", [65536, 64536])
def test_rank_bound_on_a_random_window(n):
    """A random window is the worst case: one class for each row up to
    n - 4 and one for the rows after, n - 2 in all.  The 256-byte rank
    tells the rows past n - 4 apart by how many of their keys lie before
    blk (-1 after), but the last three rows still share one class; so
    either rank has at most blk - 2 classes, x + 1 stays below 2^16 and
    two byte passes order a rank key."""
    blk = 65536
    row = np.random.default_rng(n).integers(0, 256, blk, dtype=np.uint8)
    s0, wins = _keys(row, n)
    r = tb._ranks((s0,) + tuple(wins[:7]))
    r2 = tb._ranks(tuple(tb._shl(r, 32 * k) for k in range(8)))
    assert int(r.max()) == n - 2
    assert int(r2.max()) == (n - 2 if n == blk else n - 3 + 8)
    for x in (r, r2):
        assert int(x.max()) <= blk - 2 and int(x.max()) + 1 < 1 << 16
        assert int(x.min()) == 1
        assert int(x[-1]) == int(x[-2]) == int(x[-3])


# ---------------------------------------------------------------------
# enc_deep_dp: the warp-chunk price parse
# ---------------------------------------------------------------------

def warp_dp(ml: np.ndarray, im: np.ndarray, cap_end: np.ndarray):
    """State words of the price parse as the kernel's warp computes
    them, from the chain extension's (ml, is_match, cap_end); the rounds
    each chunk took, run until no lane an edge lands on changes its
    estimate; and the counts of 18-byte cuts and of ties between the
    cut and the full match."""
    blk = len(ml)
    R = min(DP_R, blk)
    cost = np.zeros(blk + R + 64, np.int64)   # exact costs; 0 past blk
    st = np.zeros(blk, np.int64)
    lanes = np.arange(32)
    kl = lanes * LITC
    rounds, ties, cuts = [], 0, 0
    carry = 0
    for lo in range(32 * ((blk - 1) // 32), -1, -32):
        hi = min(lo + 32, blk)
        m = hi - lo
        act = lanes < m
        p = lo + lanes
        pc = np.minimum(p, blk - 1)
        mlk = np.where(act, ml[pc], 0)
        imk = act & im[pc]
        jmp = np.minimum(mlk, R)
        esc = np.where(jmp - 4 >= 15, 1 + np.maximum(jmp - 19, 0) // 255, 0)
        price = LITC * (3 + esc)
        tr = imk & (R >= 18) & (jmp > 18)
        inj, in18 = imk & (p + jmp < hi), tr & (p + 18 < hi)
        far = np.where(imk & ~inj, cost[p + jmp], 0)
        far18 = np.where(tr & ~in18, cost[p + 18], 0)
        sj, s18 = np.minimum(lanes + jmp, 31), np.minimum(lanes + 18, 31)
        T = m * LITC + carry
        # the lanes an edge lands on: only their estimates feed a round
        target = np.zeros(32, bool)
        target[sj[inj]] = True
        target[s18[in18]] = True
        est = T - kl
        r = 0
        while True:
            r += 1
            ej, e18 = est[sj], est[s18]
            a = price + np.where(inj, ej, far)
            a = np.where(tr, np.minimum(a, 3 * LITC + np.where(in18, e18,
                                                               far18)), a)
            a = np.where(imk, a + kl, INF)
            a = np.minimum.accumulate(a[::-1])[::-1]   # suffix min
            nv = np.minimum(a, T) - kl
            moved = bool(((nv != est) & target).any())
            est = nv
            if not moved:
                break
            assert r < 32
        rounds.append(r)
        # ej and e18 of the last round are exact where an edge lands in
        # the chunk; est = min(best, LITC + est[k + 1])
        a_full = price + np.where(inj, ej, far)
        a_tr = 3 * LITC + np.where(in18, e18, far18)
        cut = tr & (a_tr < a_full)                      # strictly cheaper
        best = np.where(cut, a_tr, a_full)
        take = imk & (best == est)                      # ties: the match
        e1 = np.append(est[1:], est[31])
        lit = LITC + np.where(lanes + 1 < m, e1, carry)
        assert np.array_equal(take, imk & (best <= lit))
        ties += int((tr & (a_tr == a_full)).sum())
        cuts += int(cut.sum())
        mlo = np.where(cut, np.minimum(mlk, 18), mlk)
        ce = np.where(act, cap_end[pc], False) & ~cut
        st[lo:hi] = (mlo | (take.astype(np.int64) << 30)
                     | (ce.astype(np.int64) << 29))[:m]
        cost[lo:hi] = est[:m]
        carry = int(est[0])
    return st, np.array(rounds), ties, cuts


def dp_model_matches_plain(pk: torch.Tensor, n: int, start: int,
                           deep: int):
    """The model against deep_dp_plain on one window's candidates;
    returns (rounds a chunk, 18-cut ties, cuts)."""
    ml, _off, _back, im, cap_end = tb._chain_lengths(
        pk, n, start, CAPPED_ML, tb.tier_lengths(deep))
    st, rounds, ties, cuts = warp_dp(ml.numpy(), im.numpy(),
                                     cap_end.numpy())
    want = tb.deep_dp_plain(torch.tensor([n]), torch.tensor([start]),
                            pk[None], deep)[0]
    assert np.array_equal(st, want.long().numpy())
    assert rounds.max() <= ROUNDS
    assert len(rounds) == -(-len(pk) // 32)
    return rounds, ties, cuts


@pytest.mark.parametrize("config", sorted(DEEP_CONFIGS))
def test_dp_model_matches_plain_4k(config, static_batch):
    _rows, windows, lens, starts = static_batch
    hc, deep = DEEP_CONFIGS[config]
    w, n = torch.from_numpy(windows), torch.from_numpy(lens)
    pk = tb.match_candidates_plain(w, n, hc, 1, deep)
    for i in range(len(lens)):
        dp_model_matches_plain(pk[i], int(lens[i]), int(starts[i]), deep)


@pytest.mark.parametrize("blk", [1, 13, 31, 32, 33, 300, 5000])
@pytest.mark.parametrize("deep", [1, 2, 3])
def test_dp_model_odd_window_sizes(blk, deep):
    """Partial first chunks, a window shorter than the ring's reach and
    than the 18-byte cut (blk < 18: no cut is priced)."""
    rng = np.random.default_rng(blk)
    windows = np.zeros((3, blk), np.uint8)
    windows[0] = np.frombuffer((CASES["text"] * 20)[:blk], np.uint8)
    windows[1] = rng.integers(0, 3, blk, dtype=np.uint8)
    lens = np.array([blk, blk, blk // 2], np.int32)
    starts = np.array([0, blk // 3, 0], np.int32)
    pk = tb.match_candidates_plain(torch.from_numpy(windows),
                                   torch.from_numpy(lens), 8, 1, deep)
    for i in range(3):
        dp_model_matches_plain(pk[i], int(lens[i]), int(starts[i]), deep)


def _pk(cand: np.ndarray, mlf: np.ndarray, tier=0) -> torch.Tensor:
    """Candidate packs (cand < 0: none), back = 0."""
    tier = np.broadcast_to(tier, cand.shape)
    v = np.where(cand >= 0, ((cand + 1) << 12) | (mlf << 6) | (tier << 2), 0)
    return torch.from_numpy(v.astype(np.int32))


def _stress_rows(blk: int):
    """name -> (pk, n, start, deep) built to stress the warp parse."""
    p = np.arange(blk)
    rng = np.random.default_rng(19)
    rows = {}
    # every position a 4-byte match at offset 4: the deepest in-chunk
    # chain, eight matches from lane 0 to the next chunk
    rows["all_4_byte"] = (_pk(np.where(p >= 4, p - 4, -1),
                              np.full(blk, 4)), blk, 0, 1)
    # one capped chain at offset 1 over the window: every match extends
    # to the chain's end, 512 bytes and more over most of it; at deep 3 a
    # 768-byte tier under it
    for deep, tier in ((2, 0), (3, 10)):
        rows[f"all_512_plus_d{deep}"] = (
            _pk(np.where(p >= 1, p - 1, -1), np.full(blk, 40), tier),
            blk, 0, deep)
    # 19-byte matches whose byte 18 starts no match: the 18-byte cut costs
    # exactly what the full match does, and the tie goes to the full one;
    # then 20-25-byte matches behind shorter ones, where cuts win
    tie = np.where((p % 40 == 8) & (p >= 100), p - 100, -1)
    rows["cut_ties"] = (_pk(tie, np.full(blk, 19)), blk, 0, 1)
    cand = np.where((rng.random(blk) < 0.3) & (p >= 64),
                    p - rng.integers(1, 64, blk), -1)
    rows["cut_mix"] = (_pk(cand, rng.choice([4, 5, 18, 19, 20, 22, 25],
                                            blk)), blk - 7, 9, 2)
    rows["all_literals"] = (_pk(np.full(blk, -1), np.zeros(blk, int)),
                            blk, 0, 3)
    return rows


@pytest.mark.parametrize("name", ["all_4_byte", "all_512_plus_d2",
                                  "all_512_plus_d3", "cut_ties", "cut_mix",
                                  "all_literals"])
def test_dp_model_on_stress_rows(name):
    blk = 5003
    pk, n, start, deep = _stress_rows(blk)[name]
    rounds, ties, cuts = dp_model_matches_plain(pk, n, start, deep)
    if name == "all_4_byte":
        # seven landings from lane 0: exact after round 8, and lane 4 up,
        # which hold one landing fewer, are settled by round 7
        assert rounds.max() == ROUNDS - 1
    if name == "cut_ties":
        assert ties > 100 and cuts == 0
    if name == "cut_mix":
        assert ties > 0 and cuts > 0
    if name == "all_literals":
        assert (rounds == 1).all()
    if name.startswith("all_512"):
        ml = tb._chain_lengths(pk, n, start, CAPPED_ML,
                               tb.tier_lengths(deep))[0]
        assert int((ml >= 512).sum()) > blk // 2


@pytest.mark.parametrize("level", DEEP_LEVELS)
def test_dp_model_on_a_corpus_window(level, deep_rows_64k):
    """A 64 KB corpus block of the deep goldens: 2,048 chunks."""
    windows, lens, starts = deep_rows_64k
    hc, deep = tb.level_params(level)
    pk = tb.match_candidates_plain(torch.from_numpy(windows[:1]),
                                   torch.from_numpy(lens[:1]), hc, 1, deep)
    rounds, _ties, _cuts = dp_model_matches_plain(pk[0], int(lens[0]),
                                                  int(starts[0]), deep)
    assert len(rounds) == 2048


# ---------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_windows_64k():
    """(windows, lens, starts) at 64 KB: the tie-dense windows (all zero
    among them), a random window (the most classes) and one of {0..3};
    every other one short of blk, some starting emission late."""
    blk = 65536
    rng = np.random.default_rng(64)
    windows = np.concatenate([tie_dense(blk, 47),
                              rng.integers(0, 256, (1, blk), dtype=np.uint8),
                              rng.integers(0, 4, (1, blk), dtype=np.uint8)])
    lens = np.full(len(windows), blk, np.int32)
    lens[1::2] -= 5
    starts = np.zeros(len(windows), np.int32)
    starts[2::3] = 1000
    return windows, lens, starts


def _kernels_match_plain(cuda, windows, lens, starts, deep):
    w, n, s = (torch.from_numpy(a) for a in (windows, lens, starts))
    pk = tb.match_candidates(w.to(cuda), n.to(cuda), 8, 1, deep)
    st = tb.deep_dp(n.to(cuda), s.to(cuda), pk, deep)
    torch.cuda.synchronize()
    assert torch.equal(pk.cpu(), tb.match_candidates_plain(w, n, 8, 1, deep))
    assert torch.equal(st.cpu(), tb.deep_dp_plain(n, s, pk.cpu(), deep))


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [1, 2, 3])
def test_deep_kernels_match_plain_64k(cuda, deep):
    _kernels_match_plain(cuda, *_kernel_windows_64k(), deep)


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [1, 2, 3])
def test_deep_kernels_odd_window_sizes_match_plain(cuda, deep):
    rng = np.random.default_rng(7)
    for blk in (1, 13, 31, 32, 33, 300, 1000, 5000):
        windows = np.zeros((3, blk), np.uint8)
        windows[0] = np.frombuffer((CASES["text"] * 20)[:blk], np.uint8)
        windows[1] = rng.integers(0, 3, blk, dtype=np.uint8)
        lens = np.array([blk, blk, blk // 2], np.int32)
        starts = np.array([0, blk // 3, 0], np.int32)
        _kernels_match_plain(cuda, windows, lens, starts, deep)


@pytest.mark.cuda
def test_enc_deep_dp_on_stress_rows(cuda):
    blk = 5003
    for name, (pk, n, start, deep) in _stress_rows(blk).items():
        ln, s = torch.tensor([n]), torch.tensor([start])
        st = tb.deep_dp(ln.to(cuda), s.to(cuda), pk[None].to(cuda), deep)
        torch.cuda.synchronize()
        assert torch.equal(st.cpu(), tb.deep_dp_plain(ln, s, pk[None],
                                                      deep)), name


@pytest.mark.cuda
def test_enc_deep_dp_on_a_wide_corpus_window(cuda):
    """One 327,680-byte sub-span window of the wide goldens at level 12:
    10,240 chunks, the chain's masks 80 KB of shared memory."""
    windows, lens, starts = mtg.wide_windows(make_corpus(mtg.CORPUS_MB),
                                             "w327k")
    w, n, s = (torch.from_numpy(a[:1]) for a in (windows, lens, starts))
    assert w.shape[1] == 327_680
    pk = tb.match_candidates(w.to(cuda), n.to(cuda), 8, 1, 3)
    st = tb.deep_dp(n.to(cuda), s.to(cuda), pk, 3)
    torch.cuda.synchronize()
    assert torch.equal(st.cpu(), tb.deep_dp_plain(n, s, pk.cpu(), 3))


def main():
    """Rounds a chunk of the warp parse on the corpus blocks of the 64 KB
    deep goldens, by level."""
    torch.set_num_threads(1)
    windows, lens, starts = mtg.deep_rows(make_corpus(mtg.CORPUS_MB))
    for level in DEEP_LEVELS:
        hc, deep = tb.level_params(level)
        rs = []
        for k in range(8):                    # the corpus blocks
            pk = tb.match_candidates_plain(torch.from_numpy(windows[k:k + 1]),
                                           torch.from_numpy(lens[k:k + 1]),
                                           hc, 1, deep)[0]
            rs.append(dp_model_matches_plain(pk, int(lens[k]),
                                             int(starts[k]), deep)[0])
        r = np.concatenate(rs)
        print(f"level {level}: {len(r)} chunks of 8 corpus blocks, rounds a "
              f"chunk mean {r.mean():.4f}, max {r.max()}, one round "
              f"{(r == 1).mean():.4f} of chunks")


if __name__ == "__main__":
    main()
