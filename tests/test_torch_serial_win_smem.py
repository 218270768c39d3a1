"""The designs of ``serial_decode`` and ``frag_decode_win``, modelled in
numpy against the plain versions they must equal
(zig_lz4_tpu_torch.probes.serial_decode, zig_lz4_tpu_torch.ops.torch_frags).

* ``serial_decode`` (``kernels/csrc/serial_decode.cu``) rebuilds a block
  of up to ``ROW_MAX`` bytes in one CTA's shared memory in three phases:
  the sequences' starts by an int64 scan of ``max(lit, 0) + max(ml, 0)``,
  256 sequences a chunk with a carry, and every literal byte placed at
  once, a byte finding its sequence by bisection of its chunk's literal
  prefix; then the matches walked in sequence order in rounds of
  ``min(rem, avail)`` bytes; then the row written out, zero from the end
  of the last sequence on.  The model's row starts as poison and it
  records which bytes are written: every byte below the end is written,
  and no match reads a byte before it is written -- the claims that make
  placing the literals first exact.
* ``frag_decode_win`` keeps a block's state for blocks up to 256 KB in
  the shared memory of one thread-block cluster, 32,768 positions a CTA.
  The model runs those partitions at 32,768 positions, as the kernel,
  and at 1,024, so that a 4 KB block spans four: the one-hop sources by
  the fragment scan on sorted tables (bisection otherwise), the window
  coverage of each G-byte group, the pools ranked by each partition's
  count of uncovered bytes plus the totals of the partitions before it,
  rounds in which every partition reads the known bits and values of
  the round's start, and ``ok`` over the whole block.

Both models must equal the plain versions exactly, and the window model
the JAX reference through its checked-in outputs
(``tests/fixtures/frags4k.npz``).  Tolerance: none; bytes, lengths and
``ok`` are compared exactly.  No JAX compile.  ``cuda``-marked tests hold
both kernels against their plain versions on the card: ``serial_decode``
at 64 KB and past its shared-memory limit (the warp route), and
``frag_decode_win`` with g 8 and 16 at 64 KB (a cluster of 2), 128 KB (4),
262,080 bytes (8) and past 8 x 32,768 (device scratch), and skip where
there is none: ``python -m pytest --noconftest -m cuda
tests/test_torch_serial_win_smem.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_decode_smem as tds  # noqa: E402
import test_torch_frags as ttf  # noqa: E402
import test_torch_probes as ttp  # noqa: E402
from zig_lz4_tpu_torch.ops import torch_frags as tf  # noqa: E402
from zig_lz4_tpu_torch.probes import serial_decode as sd  # noqa: E402

BLK = ttf.BLK
#: positions of a block's state a CTA holds (frag_decode.cu kClusterRows)
CLUSTER_ROWS = 1 << 15
#: sequences a chunk of serial_decode's scan (serial_decode.cu kThreads)
CHUNK = 256
POISON = 0xA5
WIN_GOLDEN = sorted(k for k, (e, _kw, _r) in ttf.GOLDEN.items()
                    if e == "win")
WIN_LIVE = sorted(k for k, (e, _kw, _r) in ttf.LIVE.items() if e == "win")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- serial_decode -----------------------------------------------------

def serial_block(comp, lit, lsrc, ml, off, nseq, blk):
    """One block by the kernel's phases: the row (bytes at or past the
    end are zero)."""
    ccap, ncap = comp.shape[0], lit.shape[0]
    ns = min(max(int(nseq), 0), ncap)
    ln = np.maximum(lit[:ns].astype(np.int64), 0)
    mn = np.maximum(ml[:ns].astype(np.int64), 0)
    on = np.maximum(off[:ns].astype(np.int64), 1)
    src = lsrc[:ns].astype(np.int64)
    row = np.full(blk, POISON, np.uint8)
    written = np.zeros(blk, bool)
    # 1. the literals, a chunk at a time: starts by the int64 scan with a
    # carry, each literal byte's sequence by bisection of the chunk's
    # literal prefix
    carry = 0
    for c0 in range(0, ns, CHUNK):
        seg = ln[c0:c0 + CHUNK] + mn[c0:c0 + CHUNK]
        op = carry + np.cumsum(seg) - seg
        lend = np.clip(np.minimum(ln[c0:c0 + CHUNK], blk - op), 0, None)
        lpre = np.cumsum(lend) - lend
        t = np.arange(int(lend.sum()))
        i = np.searchsorted(lpre, t, side="right") - 1
        k = t - lpre[i]
        s = src[c0:c0 + CHUNK][i] + k
        d = op[i] + k
        assert not written[d].any()          # the literal runs are disjoint
        row[d] = np.where((s >= 0) & (s < ccap), comp[np.clip(s, 0,
                                                              ccap - 1)], 0)
        written[d] = True
        carry += int(seg.sum())
    # 2. the matches in sequence order: each match's start from the scan,
    # its bytes inside the block copied in rounds of min(rem, avail) (a
    # match that does not overlap itself in one)
    starts = np.cumsum(ln + mn) - mn
    for q in range(ns):
        mop, avail = int(starts[q]), int(on[q])
        rem = max(min(int(mn[q]), blk - mop), 0)
        while rem > 0:
            c = min(rem, avail)
            s = np.arange(mop - avail, mop - avail + c)
            assert (s < mop).all() and written[s[s >= 0]].all()
            row[mop:mop + c] = np.where(s >= 0, row[np.clip(s, 0, None)], 0)
            written[mop:mop + c] = True
            mop, rem, avail = mop + c, rem - c, avail + c
    assert int(starts[-1] + mn[-1] if ns else 0) == carry
    # 3. the write-out
    end = min(carry, blk)
    assert written[:end].all()
    row[end:] = 0
    return row


def serial_model(comp, lit, lsrc, ml, off, nseq, blk):
    return np.stack([serial_block(comp[b], lit[b], lsrc[b], ml[b], off[b],
                                  nseq[b], blk)
                     for b in range(comp.shape[0])])


def _serial_plain(arrays, blk, device="cpu"):
    out, out_len = sd.decode_blocks_serial(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in arrays), blk)
    return out.cpu().numpy(), out_len.cpu().numpy()


def serial_adversarial(name, seed=0):
    """Tables parse_sequences never writes: (comp, lit, lsrc, ml, off,
    nseq, blk)."""
    rng = np.random.default_rng(seed)
    big = 2 ** 31 - 1
    comp = rng.integers(1, 256, (1, 40), dtype=np.uint8)
    if name == "random":
        B, ncap, blk = 12, 300, 1000
        comp = rng.integers(1, 256, (B, 200), dtype=np.uint8)
        pick = lambda lo, hi: rng.integers(lo, hi, (B, ncap))  # noqa: E731
        lit = np.where(rng.random((B, ncap)) < .2, pick(-3, 40), pick(0, 4))
        ml = np.where(rng.random((B, ncap)) < .1, pick(-5, 300), pick(0, 9))
        off = np.where(rng.random((B, ncap)) < .1, pick(-2, 2),
                       pick(1, 2000))
        lsrc = pick(-30, 230)
        nseq = rng.integers(-2, ncap + 40, B)
        nseq[:3] = (0, ncap, ncap + 1)
        return (comp, lit.astype(np.int32), lsrc.astype(np.int32),
                ml.astype(np.int32), off.astype(np.int32),
                nseq.astype(np.int32), blk)
    rows = {
        # negative and zero lengths between live ones
        "lengths": ([5, -4, 0, 3, -1], [0, 9, 9, 2, 0], [-3, 6, 0, 4, 2],
                    [1, 2, 1, 3, 5]),
        # offset 0 (counts as 1), offsets past op (sources before the
        # block read 0)
        "offsets": ([2, 1, 3, 0], [0, 3, 5, 0], [5, 4, 9, 6],
                    [0, 9, 1000, -7]),
        # literal sources before and past the payload, and across its end
        "sources": ([4, 3, 6, 2], [-2, 38, 200, -9], [2, 0, 3, 0],
                    [1, 1, 2, 1]),
        # the lengths pass blk mid-literal and mid-match
        "past_blk": ([20, 5, 9], [0, 3, 10], [70, 40, 3], [3, 7, 1]),
        # the lengths sum past 2^31: every later byte is dropped
        "past_int32": ([3, big, 4, big, big], [0, 1, 2, 3, 4],
                       [4, big, 5, big, 1], [2, 1, 3, 1, 1]),
    }
    ll, ls, mm, oo = (np.array([r], np.int32) for r in rows[name])
    ns = ll.shape[1]
    return comp, ll, ls, mm, oo, np.array([ns], np.int32), 100


SERIAL_CASES = ["lengths", "offsets", "sources", "past_blk", "past_int32",
                "random"]


@pytest.mark.parametrize("blk", [ttp.BLK, 65536])
def test_serial_model_equals_plain_on_probe_tables(blk):
    tables = ttp._tables(ttp._blocks())
    want, _n = _serial_plain(tables, blk)
    assert np.array_equal(serial_model(*tables, blk), want)


@pytest.mark.parametrize("case", SERIAL_CASES)
def test_serial_model_equals_plain_on_adversarial_tables(case):
    *arrays, blk = serial_adversarial(case)
    want, _n = _serial_plain(arrays, blk)
    assert np.array_equal(serial_model(*arrays, blk), want)


@pytest.mark.parametrize("blk", [1000, 99, 4093])
def test_serial_model_blk_not_a_multiple_of_16(blk):
    """Random tables and an empty table at a ragged ``blk``; ``nseq`` 0,
    at ``ncap`` and above it."""
    *arrays, _b = serial_adversarial("random", seed=blk)
    want, _n = _serial_plain(arrays, blk)
    assert np.array_equal(serial_model(*arrays, blk), want)
    assert not want[0].any()                 # nseq 0: a zero row


def test_serial_out_len_sums_past_int32():
    *arrays, blk = serial_adversarial("past_int32")
    out, n = _serial_plain(arrays, blk)
    total = sum(int(x) for t in (arrays[1], arrays[3]) for x in t[0])
    assert int(n[0]) == total > 2 ** 32
    assert np.array_equal(out[0, :3], arrays[0][0, :3])
    assert np.array_equal(out[0, 7:46], arrays[0][0, 1:40])
    assert not out[0, 46:].any()


class _Launches:
    """Records the launches a wrapper makes on ``meta`` tensors (which
    take the kernel route without a card): [(name, int arguments)]."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        monkeypatch.setattr(module, "launch", self.launch)

    def launch(self, name, *args):
        self.calls.append((name, [a if isinstance(a, int) else
                                  (0 if not isinstance(a, torch.Tensor)
                                   else "tensor") for a in args]))


@pytest.mark.parametrize("blk,smem", [(64, 1), (65536, 1), (sd.ROW_MAX, 1),
                                      (sd.ROW_MAX + 1, 0), (262144, 0)])
def test_serial_route_by_blk(monkeypatch, blk, smem):
    """The route is the shared-memory kernel up to ROW_MAX bytes (220
    KB; a 64 KB row leaves room for three CTAs an SM), the warp kernel
    past it; nothing else decides it."""
    rec = _Launches(monkeypatch, sd)
    meta = [torch.from_numpy(a).to("meta")
            for a in serial_adversarial("lengths")[:6]]
    out, _n = sd.decode_blocks_serial(*meta, blk)
    assert out.shape == (1, blk)
    (name, args), = rec.calls
    assert name == "serial_decode" and args[-1] == smem
    assert sd.ROW_MAX == 220 * 1024


# -- frag_decode_win ---------------------------------------------------

def group_coverage(T, unres, nwins, g):
    """The kernel's covered<G> for every byte of one block: windows of
    2g source bytes, aligned to g, per g-byte output group."""
    Tg = T.reshape(-1, g)
    ug = unres.reshape(-1, g)
    has = ug.any(1)
    cov = np.zeros_like(ug)

    def window(mask, last):
        lane = (g - 1 - np.argmax(mask[:, ::-1], 1)) if last else \
            np.argmax(mask, 1)
        t = Tg[np.arange(len(Tg)), lane]
        if last:
            t = np.maximum(t - (g - 1), 0)
        d = Tg - ((t // g) * g)[:, None]
        return mask.any(1)[:, None] & (d >= 0) & (d < 2 * g)

    cov |= window(ug, False)
    if nwins >= 2:
        cov |= window(ug, True)
    for _ in range(2, nwins):
        cov |= window(ug & ~cov, False)
    cov &= has[:, None]
    return cov.reshape(-1)


def bisection(tab, j):
    """fragment_of for every byte j: the kernel's bisection over ``tab``,
    step for step, so that it gives the kernel's answer on an unsorted
    table too (that of torch.searchsorted)."""
    lo, hi = np.zeros(len(j), np.int64), np.full(len(j), len(tab), np.int64)
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi) >> 1
        right = go & (tab[np.minimum(mid, len(tab) - 1)] <= j)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(go & ~right, mid, hi)
    return lo - 1


def one_hop(comp, fdst, fsrc, fper, fphase, nfrag, out_len, blk, rows):
    """(T, per, live) of one block: the fragment of each byte by the
    cluster kernel's scan on a sorted table, by bisection otherwise, then
    its source as source_in gives it."""
    n = min(max(int(nfrag), 0), fdst.shape[0])
    tab = fdst[:n].astype(np.int64)
    j = np.arange(blk)
    if (tab[:-1] <= tab[1:]).all():
        q = tds.fragment_scan(fdst, n, blk, rows)
    else:
        q = bisection(tab, j)
    found = q >= 0
    qc = np.clip(q, 0, None)
    rel = j - fdst[qc].astype(np.int64)
    s, p = fsrc[qc].astype(np.int64), fper[qc].astype(np.int64)
    per = found & (p > 0)
    ph = np.mod(fphase[qc].astype(np.int64) + rel, np.maximum(p, 1))
    t_per = np.clip(s + ph, 0, blk - 1)
    t_lit = np.clip(s + rel, 0, comp.shape[0] - 1)
    T = np.where(per, t_per, np.where(found, t_lit, 0))
    live = j < min(max(int(out_len), 0), blk)
    return T, per & live, live


def pool_ranks(unc, parts):
    """Each uncovered byte's rank in the block: its partition's own
    prefix count plus the totals the lower partitions publish."""
    rank = np.full(unc.shape, -1, np.int64)
    before = 0
    for p0, p1 in parts:
        rank[p0:p1] = before + np.cumsum(unc[p0:p1]) - 1
        before += int(unc[p0:p1].sum())
    return np.where(unc, rank, -1)


def partition_rounds(value, known, src, parts, rounds):
    """(value, known, rounds run) after the cluster kernels' rounds over
    one block: every partition reads the state of the round's start; a
    byte with source -1 never resolves; the rounds stop after the first
    that changes nothing."""
    r = 0
    while r < max(rounds, 0):
        new_known, new_value = known.copy(), value.copy()
        progress = False
        for p0, p1 in parts:
            s = src[p0:p1]
            got = ~known[p0:p1] & (s >= 0) & known[np.clip(s, 0, None)]
            new_value[p0:p1] = np.where(got, value[np.clip(s, 0, None)],
                                        value[p0:p1])
            new_known[p0:p1] |= got
            progress |= bool(got.any())
        known, value = new_known, new_value
        r += 1
        if not progress:
            break
    return value, known, r


def win_model(comp, fdst, fsrc, fper, fphase, nfrag, out_len, rounds, blk,
              *, fcap=None, wins=None, pool=None, lit_wins=None,
              lit_pool=None, g=8, rows=CLUSTER_ROWS):
    """(out, ok, rounds run) of every block by the cluster kernel's
    partitions of ``rows`` positions."""
    cfg = tf._win_config(blk, fcap or fdst.shape[1], rounds, wins, pool,
                         lit_wins, lit_pool, g)
    parts = [(p0, min(p0 + rows, blk)) for p0 in range(0, blk, rows)]
    B = comp.shape[0]
    out = np.zeros((B, blk), np.uint8)
    ok = np.zeros(B, np.int32)
    ran = []
    for b in range(B):
        T, per, live = one_hop(comp[b], fdst[b], fsrc[b], fper[b],
                               fphase[b], nfrag[b], out_len[b], blk, rows)
        lit = live & ~per
        # pass 1: coverage; pass 2: the pools
        if cfg["lit_wins"]:
            cov = group_coverage(T, lit, cfg["lit_wins"], g)
            rank = pool_ranks(lit & ~cov, parts)
            lit_reach = lit & (cov | ((rank >= 0) & (rank < cfg["lit_pool"])))
        else:
            lit_reach = lit
        cov = group_coverage(T, per, cfg["wins"], g)
        rank = pool_ranks(per & ~cov, parts)
        per_reach = per & (cov | ((rank >= 0) & (rank < cfg["pool"])))
        value = np.where(lit_reach, comp[b, np.where(lit_reach, T, 0)], 0)
        value, known, r = partition_rounds(value, ~live | lit_reach,
                                           np.where(per_reach, T, -1), parts,
                                           rounds)
        out[b] = np.where(known & live, value, 0)
        ok[b] = known.all()
        ran.append(r)
    return out, ok, ran


def _win_args(config):
    _engine, kw, resolve = ttf.CONFIGS[config]
    kw = dict(kw)
    return ttf.tables(*resolve)[:7], kw.pop("rounds"), kw


@pytest.mark.parametrize("rows", [CLUSTER_ROWS, 1024])
@pytest.mark.parametrize("config", WIN_GOLDEN + WIN_LIVE)
def test_win_model_equals_reference_and_plain(config, rows):
    """The six windowed configurations of frags4k.npz (the JAX outputs)
    and the three live ones against the plain version."""
    tables, rounds, kw = _win_args(config)
    out, ok, _r = win_model(*tables, rounds, BLK, rows=rows, **kw)
    want_out, want_ok = ttf._port(config)
    assert np.array_equal(out, want_out)
    assert np.array_equal(ok.astype(bool), want_ok)
    if config in ttf.GOLDEN:
        ref_out, ref_ok = ttf._reference(config)
        assert np.array_equal(out, ref_out) and np.array_equal(ok, ref_ok)


def _frag_tables(frags, blk, fetch=None, seed=0):
    """One block's table from [(dst, src, per, phase)] in increasing dst
    (LIT fragments read a fetch buffer of random letters)."""
    fetch = fetch or blk
    comp = np.random.default_rng(seed).integers(65, 91, (1, fetch), np.uint8)
    cols = np.array(frags, np.int64).T.astype(np.int32)[:, None, :]
    return [comp, *cols, np.array([len(frags)], np.int32),
            np.array([blk], np.int32)]


def pool_boundary_tables(side, blk=BLK, rows=1024):
    """A block of LIT runs whose first partition has no uncovered byte,
    whose second has two and whose third forty, so that a pool of 4 ends
    in the third.  Each odd group (bytes d - 1, d, d + 1, d % 8 == 4)
    holds one byte that its windows miss: ``side`` "per", three one-byte
    PER fragments whose first and last sources lie together and whose
    middle one lies far (two windows); "lit", two one-byte LIT fragments
    with sources far from the run and from each other (three windows)."""
    odd = [rows + 100, rows + 300] + [2 * rows + 24 * k + 4
                                      for k in range(40)]
    frags, at = [], 0
    for d in odd:
        frags.append((at, at, 0, 0))             # a LIT run up to d - 1
        if side == "per":
            a = d - 1 - rows
            frags += [(d - 1, a, 1, 0), (d, (a + 512) % rows, 1, 0),
                      (d + 1, a + 2, 1, 0)]
            at = d + 2
        else:
            frags += [(d - 1, (d + 1500) % blk, 0, 0),
                      (d, (d + 3000) % blk, 0, 0)]
            at = d + 1
    frags.append((at, at, 0, 0))
    return _frag_tables(frags, blk)


@pytest.mark.parametrize("side", ["per", "lit"])
def test_win_model_pool_boundary_in_a_later_cta(side):
    tables = pool_boundary_tables(side)
    kw = (dict(wins=2, pool=4, lit_wins=0, lit_pool=0) if side == "per"
          else dict(wins=2, pool=1024, lit_wins=3, lit_pool=4))
    T, per, live = one_hop(*(a[0] for a in tables), BLK, 1024)
    unres = per if side == "per" else live & ~per
    cov = group_coverage(T, unres, 2 if side == "per" else 3, 8)
    counts = [int((unres & ~cov)[p0:p0 + 1024].sum())
              for p0 in range(0, BLK, 1024)]
    assert counts[0] == 0 and counts[1] == 2 and counts[2] > 4
    for rows in (1024, CLUSTER_ROWS):
        out, ok, _r = win_model(*tables, 12, BLK, g=8, rows=rows, **kw)
        want = tf.decode_blocks_frags_win_plain(
            *(torch.from_numpy(a) for a in tables), 12, BLK, g=8, **kw)
        assert np.array_equal(out, want[0].numpy())
        assert np.array_equal(ok, want[1].numpy()) and not ok[0]
    big = dict(kw, **({"pool": 1024} if side == "per" else
                      {"lit_pool": 1024}))
    assert win_model(*tables, 12, BLK, g=8, rows=1024, **big)[1][0]


def alternating_chain(depth, blk=BLK, rows=1024):
    """A block of LIT runs in which ``depth`` bytes, one a group and
    alternating between the first two partitions, each copy the one
    before, from a LIT root: a chain ``depth`` hops deep whose every hop
    crosses a partition.  Returns (tables, the chain's positions)."""
    links = [(k % 2) * rows + 64 * (k + 1) for k in range(depth + 1)]
    frags, at = [], 0
    for k in sorted(range(depth + 1), key=lambda k: links[k]):
        d = links[k]
        if d > at:
            frags.append((at, at, 0, 0))
        frags.append((d, links[k - 1], 1, 0) if k else (d, d, 0, 0))
        at = d + 1
    frags.append((at, at, 0, 0))
    return _frag_tables(frags, blk), links


@pytest.mark.parametrize("depth", [1, 4, 7])
def test_win_model_chain_across_ctas(depth):
    """``ok`` is clear after ``depth - 1`` rounds and set after
    ``depth``, in the model and the plain version."""
    tables, links = alternating_chain(depth)
    assert len({d // 1024 for d in links}) == 2
    for rounds in (depth - 1, depth):
        out, ok, ran = win_model(*tables, rounds, BLK, g=8, rows=1024,
                                 wins=2, pool=512, lit_wins=0, lit_pool=0)
        want = tf.decode_blocks_frags_win_plain(
            *(torch.from_numpy(a) for a in tables), rounds, BLK, g=8, wins=2,
            pool=512, lit_wins=0, lit_pool=0)
        assert np.array_equal(out, want[0].numpy())
        assert int(ok[0]) == int(want[1][0]) == (rounds == depth)
    comp = tables[0][0]
    assert (out[0, links] == comp[links[0]]).all()


@pytest.mark.parametrize("fill", sorted(tds.FILLS))
def test_win_model_reads_nothing_past_nfrag(fill):
    tables = ttf.tables(8, 64)[:7]
    for rows in (1024, CLUSTER_ROWS):
        runs = [win_model(*tds._stale(tables, f), 8, BLK, g=8, rows=rows)
                for f in (None, fill)]
        for a, b in zip(runs[0][:2], runs[1][:2]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("blk,ctas", [(4096, 1), (65536, 2), (131072, 4),
                                      (262080, 8), (262144, 8),
                                      (262208, 0), (1 << 20, 0)])
def test_win_route_by_blk(monkeypatch, blk, ctas):
    """A cluster of ceil(blk / 32768) CTAs up to 8, with no device
    scratch; device scratch past 8 x 32,768 bytes.  The route depends on
    blk alone."""
    assert tf.win_cluster_size(blk) == ctas
    assert tf.device_win_decoder_supports(262080)
    assert not tf.device_win_decoder_supports(262144)
    rec = _Launches(monkeypatch, tf)
    meta = [torch.from_numpy(a).to("meta") for a in ttf.tables(8, 12)[:7]]
    tf.decode_blocks_frags_win(*meta, 8, blk, g=16)
    (name, args), = rec.calls
    assert name == "frag_decode_win" and args[-1] == ctas
    scratch = args[7:10]
    assert scratch == ([0, 0, 0] if ctas else ["tensor"] * 3)


# -- the kernels on the card --------------------------------------------

def _to(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [65536, 262144])
def test_serial_kernel_routes(cuda, blk):
    """The shared-memory route at 64 KB and the warp route past ROW_MAX,
    on the probe's tables and the adversarial ones (at their own blk)."""
    shape = sd.serial_launch_shape(blk)
    assert shape["shared_row"] == (blk <= sd.ROW_MAX)
    if shape["shared_row"]:
        assert shape["ctas_per_sm"] >= 3
    cases = [(ttp._tables(ttp._blocks()), blk)] + [
        (tuple(serial_adversarial(c)[:6]), serial_adversarial(c)[6])
        for c in SERIAL_CASES]
    for arrays, b in cases:
        for bb in (b, blk):
            got = _serial_plain(arrays, bb, device=cuda)
            want = _serial_plain(arrays, bb)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])


def _win_malformed(blk, order, seed=1):
    comp = ttf.tables(8, 64)[0]
    rng = np.random.default_rng(seed)
    junk = rng.integers(-blk - 4000, blk + 4000, (4, len(comp), 2048))
    junk[2] = np.where(rng.random(junk[2].shape) < .5, 0, junk[2] % 17)
    if order == "sorted":
        junk[0] = np.sort(junk[0], axis=1)
    return [comp, *junk.astype(np.int32), np.full(len(comp), 2048, np.int32),
            np.full(len(comp), blk, np.int32)]


@pytest.mark.cuda
@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("blk", [65536, 131072, 262080, 262208])
def test_win_kernel_routes(cuda, blk, g):
    """Both group widths on resolved corpus blocks, malformed sorted and
    unsorted tables, at a cluster of 2, 4 and 8 and on device scratch."""
    C = tf.win_cluster_size(blk)
    assert C == {65536: 2, 131072: 4, 262080: 8}.get(blk, 0)
    if C:
        shape = tf.win_launch_shape(blk, g)
        assert shape["ctas"] == C and shape["active_clusters"] > 0
    resolved, _blocks = tds._big_tables(blk)
    sets = [resolved] + [_win_malformed(blk, o) for o in ("sorted",
                                                          "unsorted")]
    for tables in sets:
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in tables]
        dev = _to(cuda, tables)
        for rounds, kw in ((8, {}), (2, dict(pool=4, lit_pool=4)),
                           (12, dict(lit_wins=0, lit_pool=0))):
            got = tf.decode_blocks_frags_win(*dev, rounds, blk, g=g, **kw)
            want = tf.decode_blocks_frags_win_plain(*host, rounds, blk, g=g,
                                                    **kw)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 8])
def test_win_kernel_chain_across_ctas(cuda, depth):
    """A 64 KB block whose chain alternates between the cluster's two
    CTAs: ``ok`` is clear after ``depth - 1`` rounds and set after
    ``depth``."""
    tables, links = alternating_chain(depth, 65536, CLUSTER_ROWS)
    for rounds in (depth - 1, depth):
        kw = dict(g=8, wins=2, pool=512, lit_wins=0, lit_pool=0)
        got = tf.decode_blocks_frags_win(*_to(cuda, tables), rounds, 65536,
                                         **kw)
        want = tf.decode_blocks_frags_win_plain(
            *(torch.from_numpy(a) for a in tables), rounds, 65536, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert int(got[1][0]) == (rounds == depth)


@pytest.mark.cuda
@pytest.mark.parametrize("config", WIN_GOLDEN + WIN_LIVE)
def test_win_kernel_equals_model(cuda, config):
    tables, rounds, kw = _win_args(config)
    out, ok = tf.decode_blocks_frags_win(*_to(cuda, tables), rounds, BLK,
                                         **kw)
    m_out, m_ok, _r = win_model(*tables, rounds, BLK, **kw)
    assert np.array_equal(out.cpu().numpy(), m_out)
    assert np.array_equal(ok.cpu().numpy(), m_ok)
