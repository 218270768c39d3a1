"""The designs of ``seq_decode`` and ``frag_decode_chase``, modelled in
numpy against the plain versions they must equal
(zig_lz4_tpu_torch.ops.torch_decode, zig_lz4_tpu_torch.ops.torch_frags).

* ``seq_decode`` (``kernels/csrc/seq_decode.cu``) rebuilds a block of at
  most 64 KB in shared memory: a block scan gives every sequence's
  ``seg_start``; the fill writes each literal byte, and gives each match
  byte at ``d = mstart + k`` its folded source ``s = mstart - off + k %
  off``, which reads the history when ``s < 0`` and is otherwise kept in
  ``nx`` (uint16, 0xFFFF for a byte with no pending source); then
  rounds of pointer jumping: a pending byte ``j`` whose source ``p`` was
  final at the start of the round (the ``cur`` mask) copies it, else it
  jumps in place, ``nx[j] = nx[p]``.  The model visits the pending bytes
  in a random order each round, one at a time, so that a byte may read a
  source that jumped earlier in the same round: the order must not
  matter.  A block whose chains are ``D`` hops deep takes at most
  ``ceil(log2(D + 1)) <= ceil(log2 D) + 1`` rounds.
* ``frag_decode_chase`` (``kernels/csrc/frag_decode.cu``) keeps its
  position state for blocks up to 256 KB in the shared memory of one
  thread-block cluster, 32,768 positions a CTA.  A round reads the new
  values of every partition from the state of its start (staged in
  registers), then writes them back; the frontier pool takes the first
  ``qcap`` open positions of the block in position order from each
  partition's count of open positions and the offsets of the partitions
  before it.  The model runs those partitions at 32,768 positions, as
  the kernel, and at 1,024, so that a 4 KB block spans four.

Both models must equal the plain versions exactly, and the JAX reference
through its checked-in outputs (``tests/fixtures/seqdec4k.npz``,
``tests/fixtures/frags4k.npz``).  The fragment decoders read nothing at
or past a block's ``nfrag`` column: garbage there changes no output.

Tolerance: none; bytes, lengths and ``ok`` are compared exactly.  No JAX
compile.  ``cuda``-marked tests hold both kernels against their plain
versions on the card (64 KB blocks through a cluster of 2, 256 KB
through 8, 1 MB through device scratch) and skip where there is none:
``python -m pytest --noconftest -m cuda tests/test_torch_decode_smem.py``.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_decode as ttd  # noqa: E402
import test_torch_frags as ttf  # noqa: E402
from zig_lz4_tpu_torch.ops import torch_decode as td  # noqa: E402
from zig_lz4_tpu_torch.ops import torch_frags as tf  # noqa: E402

BLK = ttd.BLK
#: positions of the chase state a CTA holds (frag_decode.cu kChaseRows)
CHASE_ROWS = 1 << 15
NO_SOURCE = 0xFFFF
CHASE = sorted(k for k, (engine, _kw, _r) in ttf.CONFIGS.items()
               if engine == "chase")


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


# -- seq_decode --------------------------------------------------------

def seq_fill(comp, lit_len, lit_src, mlen, off, nseq, blk, hist):
    """One block's scan and fill: (sout uint8[blk], nx uint16[blk],
    out_len, ok) as the kernel leaves them before its rounds."""
    ccap, cap = comp.shape[0], lit_len.shape[0]
    hcap = 0 if hist is None else hist.shape[0]
    ns = min(max(int(nseq), 0), cap)
    n_raw, m_raw = (a[:ns].astype(np.int64) for a in (lit_len, mlen))
    good = ns == int(nseq) and bool((n_raw >= 0).all() and (m_raw >= 0).all())
    n, m = np.clip(n_raw, 0, blk + 1), np.clip(m_raw, 0, blk + 1)
    o = np.maximum(off[:ns].astype(np.int64), 1)
    src = lit_src[:ns].astype(np.int64)
    seg = n + m
    st = np.minimum(np.cumsum(seg) - seg, blk + 1)     # saturating scan
    total = min(int(seg.sum()), blk + 1)
    good = good and total <= blk and not bool(
        ((n > 0) & ((src < 0) | (src > ccap - n))).any()
        or ((m > 0) & (st + n - o < -hcap)).any())
    sout = np.zeros(blk, np.uint8)
    nx = np.full(blk, NO_SOURCE, np.uint16)

    def spread(count):
        q = np.repeat(np.arange(ns), count)
        return q, np.arange(q.size) - (np.cumsum(count) - count)[q]

    # literal bytes inside the block
    q, k = spread(np.maximum(np.minimum(n, blk - st), 0))
    s = src[q] + k
    inside = (s >= 0) & (s < ccap)
    sout[st[q] + k] = np.where(inside, comp[np.clip(s, 0, ccap - 1)], 0)
    # match bytes: the folded source, or the history
    ms = np.minimum(st + n, blk)
    q, k = spread(np.maximum(np.minimum(m, blk - ms), 0))
    d, s = ms[q] + k, ms[q] - o[q] + k % o[q]
    assert (s < d).all()
    nx[d[s >= 0]] = s[s >= 0]
    h = (s < 0) & (s >= -hcap)
    if h.any():
        sout[d[h]] = hist[hcap + s[h]]
    return sout, nx, total, good


def chain_depth(nx):
    """Hops from each byte to a final one (nx[j] < j: one pass)."""
    depth = [0] * len(nx)
    for j, p in enumerate(nx.tolist()):
        if p != NO_SOURCE:
            depth[j] = depth[p] + 1
    return max(depth, default=0)


def seq_rounds(sout, nx, rng):
    """The rounds, pending bytes visited one at a time in a random order
    with in-place jumps; returns (sout, rounds)."""
    cur = (nx == NO_SOURCE).tolist()
    nx, sout = nx.tolist(), sout.tolist()
    rounds, pending = 0, not all(cur)
    while pending:
        todo = [j for j, f in enumerate(cur) if not f]
        rng.shuffle(todo)
        nxt, moved = list(cur), False
        for j in todo:
            p = nx[j]
            if cur[p]:
                sout[j] = sout[p]
                nxt[j] = True
            else:
                nx[j] = nx[p]
                moved = True
        rounds += 1
        cur, pending = nxt, moved
    return np.array(sout, np.uint8), rounds


def seq_model(comp, lit_len, lit_src, mlen, off, nseq, blk, hists=None,
              seed=0):
    """(out, out_len, ok, rounds, depth) of every block, by the kernel's
    scan, fill and rounds."""
    B = comp.shape[0]
    rng = np.random.default_rng(seed)
    out = np.zeros((B, blk), np.uint8)
    out_len, ok = np.zeros(B, np.int32), np.zeros(B, np.int32)
    rounds, depth = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for b in range(B):
        hist = None if hists is None else (
            hists if hists.ndim == 1 else hists[b])
        sout, nx, total, good = seq_fill(
            comp[b], lit_len[b], lit_src[b], mlen[b], off[b], nseq[b], blk,
            hist)
        depth[b] = chain_depth(nx)
        sout, rounds[b] = seq_rounds(sout, nx, rng)
        live = min(total, blk) if good else 0
        out[b, :live] = sout[:live]
        out_len[b], ok[b] = total, good
    return out, out_len, ok, rounds, depth


def _plain(arrays, blk=BLK, hists=None):
    return ttd._seq_decode(arrays, blk, hists)


def _assert_model_equals_plain(arrays, blk=BLK, hists=None, seed=0):
    out, out_len, ok, rounds, depth = seq_model(*arrays, blk, hists, seed)
    for got, want in zip((out, out_len, ok), _plain(arrays, blk, hists)):
        assert np.array_equal(got, want)
    assert (rounds <= np.ceil(np.log2(depth + 1))).all()
    return out, ok, rounds, depth


def chain_tables(blk, into_history=False):
    """One block in which each sequence is 1 literal plus a 4-byte match
    at offset 5, so that every match reads the one before it.  The first
    sequence's match reads 4 literals before it, or, ``into_history``,
    the last 4 bytes of the history.  Its chains run through every
    sequence: depth = nseq."""
    nseq = blk // 5 if into_history else (blk - 4) // 5
    ccap = nseq + 8
    comp = np.random.default_rng(blk).integers(
        65, 91, ccap, dtype=np.uint8)[None]
    lit = np.ones((1, nseq), np.int32)
    lsrc = (np.arange(nseq, dtype=np.int32) + 4)[None]
    if not into_history:
        lit[0, 0], lsrc[0, 0] = 5, 0
    ml = np.full((1, nseq), 4, np.int32)
    off = np.full((1, nseq), 5, np.int32)
    return comp, lit, lsrc, ml, off, np.array([nseq], np.int32)


def run_tables(blk, run):
    """One literal, then a ``run``-byte match at offset 1."""
    comp = np.array([[0x61, 0, 0, 0]], np.uint8)
    one = lambda v: np.array([[v]], np.int32)            # noqa: E731
    return (comp, one(1), one(0), one(run), one(1), np.array([1], np.int32))


@pytest.mark.parametrize("blk", [BLK, 65536])
@pytest.mark.parametrize("into_history", [False, True])
def test_seq_model_chain_through_every_sequence(blk, into_history):
    arrays = chain_tables(blk, into_history)
    hists = None
    if into_history:
        hists = np.random.default_rng(3).integers(0, 256, blk, np.uint8)
    out, ok, rounds, depth = _assert_model_equals_plain(arrays, blk, hists)
    nseq = int(arrays[5][0])
    assert ok[0] and depth[0] == nseq - into_history
    assert rounds[0] <= math.ceil(math.log2(depth[0])) + 1
    if into_history:
        assert out[0, 1:5].tolist() == hists[-4:].tolist()


@pytest.mark.parametrize("run", [BLK - 1, 7, 1])
def test_seq_model_offset_one_run(run):
    out, ok, rounds, depth = _assert_model_equals_plain(run_tables(BLK, run))
    assert ok[0] and depth[0] == 1 and rounds[0] == 1
    assert (out[0, :run + 1] == 0x61).all() and not out[0, run + 1:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seq_model_history(seed):
    arrays, hists = ttd._hist_tables(ttd._history_cases())
    out, ok, _r, _d = _assert_model_equals_plain(arrays, hists=hists,
                                                 seed=seed)
    assert ok.all()


@pytest.mark.parametrize("name", ["nohist", "hist"])
def test_seq_model_equals_jax_goldens(name):
    arrays, hists, want, want_len, data = ttd._golden_seq_inputs(name)
    out, out_len, ok, rounds, depth = seq_model(*arrays, BLK, hists)
    assert ok.all()
    assert np.array_equal(out, want) and np.array_equal(out_len, want_len)
    for got, plain in zip((out, out_len, ok), _plain(arrays, hists=hists)):
        assert np.array_equal(got, plain)
    assert (rounds <= np.ceil(np.log2(depth + 1))).all()


@pytest.mark.parametrize("hist", [None, 77])
def test_seq_model_flags_like_plain(hist):
    arrays = ttd._bad_tables()
    hists = None if hist is None else np.full(1, hist, np.uint8)
    _out, ok, _r, _d = _assert_model_equals_plain(arrays, 64, hists)
    assert ok.tolist()[-1] == 1 and not ok[:6].all()


def test_seq_model_zero_length_sequences():
    """Sequences of no bytes between live ones own no byte."""
    comp = np.arange(32, dtype=np.uint8)[None]
    lit = np.array([[3, 0, 0, 2, 0]], np.int32)
    lsrc = np.array([[0, 9, 9, 5, 9]], np.int32)
    ml = np.array([[0, 0, 4, 0, 0]], np.int32)
    off = np.array([[1, 1, 2, 1, 1]], np.int32)
    arrays = (comp, lit, lsrc, ml, off, np.array([5], np.int32))
    out, ok, _r, _d = _assert_model_equals_plain(arrays, 64)
    assert ok[0] and out[0, :9].tolist() == [0, 1, 2, 1, 2, 1, 2, 5, 6]


# -- frag_decode_chase -------------------------------------------------

def chase_model(comp, fdst, fsrc, fper, fphase, nfrag, out_len, blk,
                dense=2, doublings=4, qcap=0, rows=CHASE_ROWS):
    """(out, ok, rounds) by the cluster kernel's partitions of ``rows``
    positions: every round staged from the state of its start, the
    frontier ranked by partition counts and offsets."""
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (comp, fdst, fsrc, fper, fphase, nfrag, out_len)]
    T, per, live = (t.numpy() for t in tf._sources(*args, blk))
    nx_all = np.where(live, np.where(per, T, T + blk), blk).astype(np.int64)
    parts = [slice(c, min(c + rows, blk)) for c in range(0, blk, rows)]
    q = min(tf._chase_pool(blk, qcap), blk)
    B, fetch = comp.shape
    out = np.zeros((B, blk), np.uint8)
    ok = np.zeros(B, np.int32)
    rounds = []

    def round_(x, sel):
        staged = []
        for sl in parts:                 # every CTA reads the round start
            v = x[sl].copy()
            go = sel[sl] & (v < blk)
            v[go] = x[v[go]]
            staged.append(v)
        for sl, v in zip(parts, staged):  # then writes back
            x[sl] = v
        return bool((x[sel] < blk).any())

    for b in range(B):
        x = nx_all[b].copy()
        everywhere = np.ones(blk, bool)
        unc, nd, nf = bool((x < blk).any()), 0, 0
        while nd < dense and unc:
            unc = round_(x, everywhere)
            nd += 1
        if doublings > 0 and unc:
            open_ = x < blk
            totals = [int(open_[sl].sum()) for sl in parts]
            n = min(sum(totals), q)
            pool = np.zeros(blk, bool)
            for sl, before in zip(parts, np.cumsum([0] + totals[:-1])):
                rank = before + np.cumsum(open_[sl]) - 1
                pool[sl] = open_[sl] & (rank < n)
            while nf < doublings and unc:
                unc = round_(x, pool)
                nf += 1
        conv = x >= blk
        out[b] = np.where(live[b] & conv,
                          comp[b, np.clip(x - blk, 0, fetch - 1)], 0)
        ok[b] = conv.all()
        rounds.append((nd, nf))
    return out, ok, rounds


def fragment_scan(fdst, nfrag, blk, rows=CHASE_ROWS):
    """The cluster kernel's fragment of every byte on a table in
    increasing ``fdst``: each partition of ``rows`` positions takes the
    fragments that start in it (the larger index where two start at one
    byte), a max-scan spreads them, and the fragments before its first
    position give the carry; -1 where no fragment starts at or before."""
    live = fdst[:nfrag].astype(np.int64)
    owner = np.full(blk, -1, np.int64)
    for j0 in range(0, blk, rows):
        j1 = min(j0 + rows, blk)
        q_lo = int(np.searchsorted(live, j0 - 1, side="right"))
        q_hi = int(np.searchsorted(live, j1 - 1, side="right"))
        part = np.full(j1 - j0, -1, np.int64)
        np.maximum.at(part, live[q_lo:q_hi] - j0, np.arange(q_lo, q_hi))
        owner[j0:j1] = np.maximum(np.maximum.accumulate(part), q_lo - 1)
    return owner


@pytest.mark.parametrize("rows", [CHASE_ROWS, 1024, 100])
def test_fragment_scan_equals_bisection(rows):
    """On tables in increasing fdst -- the resolver's, and sorted garbage
    with repeats, negative starts and starts past the block -- the scan
    finds the fragment that the bisection (torch.searchsorted) finds."""
    comp, fd, _fs, _fp, _fh, nf, _ol = ttf.tables(8, 64)[:7]
    rng = np.random.default_rng(rows)
    half = rng.integers(-50, BLK + 50, (fd.shape[0], fd.shape[1] // 2 + 1))
    junk = np.sort(np.repeat(half, 2, axis=1)[:, :fd.shape[1]],
                   axis=1).astype(np.int32)
    for tab, counts in ((fd, nf), (junk, np.full(len(nf), fd.shape[1]))):
        for b in range(len(counts)):
            n = int(counts[b])
            want = np.searchsorted(tab[b, :n], np.arange(BLK),
                                   side="right") - 1
            assert np.array_equal(fragment_scan(tab[b], n, BLK, rows), want)


@pytest.mark.parametrize("blk,ctas", [(4096, 1), (32768, 1), (65536, 2),
                                      (131072, 4), (262144, 8),
                                      (262145, 0), (1 << 20, 0)])
def test_chase_cluster_size(blk, ctas):
    """A cluster of ceil(blk / 32768) CTAs, at most the portable 8; the
    1 MB path's blocks keep their state in device scratch."""
    assert tf.chase_cluster_size(blk) == ctas


def _chase_args(config):
    _engine, kw, resolve = ttf.CONFIGS[config]
    return ttf.tables(*resolve)[:7], kw


@pytest.mark.parametrize("rows", [CHASE_ROWS, 1024])
@pytest.mark.parametrize("config", CHASE)
def test_chase_model_equals_plain(config, rows):
    tables, kw = _chase_args(config)
    out, ok, _r = chase_model(*tables, BLK, rows=rows, **kw)
    want_out, want_ok = ttf._port(config)
    assert np.array_equal(out, want_out)
    assert np.array_equal(ok.astype(bool), want_ok)
    ref_out, ref_ok = ttf._reference(config) if config in ttf.GOLDEN else (
        want_out, want_ok)
    assert np.array_equal(out, ref_out) and np.array_equal(ok, ref_ok)


def test_chase_model_holds_the_round_semantics():
    """Some block converges under a larger ``dense`` and not under a
    smaller one: the rounds read the state of their start, as the
    reference's do."""
    tables, _kw = _chase_args("chase_3_0_0")
    _o2, ok2, r2 = chase_model(*tables, BLK, dense=2, doublings=0)
    _o3, ok3, r3 = chase_model(*tables, BLK, dense=3, doublings=0)
    flips = (ok2 == 0) & (ok3 == 1)
    assert flips[ttf.NAMES.index("tiny_runs")]
    assert all(r[0] == 2 for r, f in zip(r2, flips) if f)
    assert all(r[0] == 3 for r, f in zip(r3, flips) if f)
    for dense, ok in ((2, ok2), (3, ok3)):
        want = tf.decode_blocks_frags_chase_plain(
            *(torch.from_numpy(a) for a in tables), BLK, dense, 0, 0)[1]
        assert np.array_equal(ok, want.numpy())


# -- nothing at or past nfrag is read -----------------------------------

FILLS = {"large": lambda rng, s: np.full(s, 1 << 30, np.int32),
         "negative": lambda rng, s: np.full(s, -70_000, np.int32),
         "random": lambda rng, s: rng.integers(-(1 << 31), 1 << 31, s,
                                               dtype=np.int64)
         .astype(np.int32)}
ENGINES = {
    "frags": lambda a: tf.decode_blocks_frags(*a, 12, BLK),
    "win": lambda a: tf.decode_blocks_frags_win(*a, 8, BLK, g=8),
    "chase": lambda a: tf.decode_blocks_frags_chase(*a, BLK, 3, 2, 16),
}


def _stale(tables, fill, seed=0):
    """The tables with every column at or past nfrag set by ``fill``
    (None: zero)."""
    comp, fd, fs, fp, fh, nf, ol = (np.array(a) for a in tables)
    stale = np.arange(fd.shape[1])[None] >= nf[:, None]
    rng = np.random.default_rng(seed)
    for t in (fd, fs, fp, fh):
        t[stale] = 0 if fill is None else FILLS[fill](rng, int(stale.sum()))
    return comp, fd, fs, fp, fh, nf, ol


@pytest.mark.parametrize("fill", sorted(FILLS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_plain_reads_nothing_past_nfrag(engine, fill):
    tables = ttf.tables(8, 64)[:7]
    assert (np.array(tables[5]) < ttf.FCAP).all()    # stale columns exist
    runs = [ENGINES[engine]([torch.from_numpy(a) for a in _stale(tables, f)])
            for f in (None, fill)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# -- the kernels on the card --------------------------------------------

def _to(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chain", "chain_hist", "run", "run_short"])
def test_seq_kernel_worst_cases(cuda, case):
    """64 KB blocks: a chain through every sequence, with no history and
    behind a 64 KB one; a 65,535-byte offset-1 run."""
    blk = 65536
    arrays = {"chain": chain_tables,
              "chain_hist": lambda b: chain_tables(b, True),
              "run": lambda b: run_tables(b, b - 1),
              "run_short": lambda b: run_tables(b, 100)}[case](blk)
    hists = None
    if case == "chain_hist":
        hists = np.random.default_rng(3).integers(0, 256, blk, np.uint8)
    rounds = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = td.decode_blocks(*_to(cuda, arrays), blk, hists=None if hists is
                           None else torch.from_numpy(hists).to(cuda),
                           rounds=rounds)
    for g, p in zip(got, _plain(arrays, blk, hists)):
        assert np.array_equal(g.cpu().numpy(), p)
    _out, _len, ok, _r, depth = seq_model(*arrays, blk, hists)
    assert ok.all()
    assert int(rounds[0]) <= math.ceil(math.log2(depth[0] + 1))


@pytest.mark.cuda
def test_seq_kernel_flags_and_goldens(cuda):
    for name in ("nohist", "hist"):
        arrays, hists, want, want_len, _d = ttd._golden_seq_inputs(name)
        rounds = torch.zeros(len(arrays[0]), dtype=torch.int32, device=cuda)
        out, out_len, ok = td.decode_blocks(
            *_to(cuda, arrays), BLK, hists=None if hists is None else
            torch.from_numpy(hists).to(cuda), rounds=rounds)
        assert np.array_equal(out.cpu().numpy(), want)
        assert np.array_equal(out_len.cpu().numpy(), want_len)
        _o, _l, _k, _r, depth = seq_model(*arrays, BLK, hists)
        assert (rounds.cpu().numpy() <= np.ceil(np.log2(depth + 1))).all()
    for hist in (None, np.full(1, 77, np.uint8)):
        for g, p in zip(ttd._seq_decode(ttd._bad_tables(), 64, hist,
                                        device=cuda),
                        ttd._seq_decode(ttd._bad_tables(), 64, hist)):
            assert np.array_equal(g, p)


def _big_tables(bs, seed=0):
    """The port's resolver's tables of corpus blocks, chains and runs of
    ``bs`` bytes, cut to the largest fragment count."""
    from zig_lz4_tpu_torch import native
    from zig_lz4_tpu_torch.corpus import make_corpus
    from zig_lz4_tpu_torch.ops.block import compress_fast
    data = make_corpus(max(bs * 6 >> 20, 1) + 1)
    piece = np.random.default_rng(seed).integers(65, 91, 40, np.uint8)
    chain = bytearray(piece.tobytes())
    while len(chain) < bs:
        chain += chain[-37:]
    blocks = [data[k * bs:(k + 1) * bs] for k in range(4)] + [
        bytes(chain[:bs]), b"\x61" * bs, b"", b"x"]
    pays = [compress_fast(b) if b else b"\x00" for b in blocks]
    ln = np.array([len(p) for p in pays], np.int64)
    of = np.zeros_like(ln)
    of[1:] = np.cumsum(ln)[:-1]
    fd, _fl, fs, fp, fh, nf, _rd, ol = native.native_resolve_blocks(
        b"".join(pays), of, ln, bs, out_cap=bs, split_max=8, round_limit=64,
        reuse_buffers=False)
    ncol = max(int(nf.max()), 1)
    comp = np.zeros((len(pays), int(ln.max())), np.uint8)
    for k, p in enumerate(pays):
        comp[k, :len(p)] = np.frombuffer(p, np.uint8)
    return [comp, fd[:, :ncol], fs[:, :ncol], fp[:, :ncol], fh[:, :ncol],
            nf, ol.astype(np.int32)], blocks


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [65536, 262144, 1 << 20])
def test_chase_kernel_routes(cuda, bs):
    """Every chase configuration of the tests at 64 KB (a cluster of 2),
    256 KB (8) and 1 MB (device scratch)."""
    assert tf.chase_cluster_size(bs) == {65536: 2, 262144: 8}.get(bs, 0)
    tables, blocks = _big_tables(bs)
    dev = _to(cuda, tables)
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in tables]
    for config in CHASE:
        kw = dict(ttf.CONFIGS[config][1])
        out, ok = tf.decode_blocks_frags_chase(*dev, bs, **kw)
        want_out, want_ok = tf.decode_blocks_frags_chase_plain(*host, bs,
                                                               **kw)
        assert torch.equal(out.cpu(), want_out)
        assert torch.equal(ok.cpu(), want_ok)
        for k, blk_data in enumerate(blocks):
            if ok[k]:
                assert out[k, :len(blk_data)].cpu().numpy().tobytes() \
                    == blk_data
    if tf.chase_cluster_size(bs):
        shape = tf.chase_launch_shape(bs)
        assert shape["ctas"] == tf.chase_cluster_size(bs)
        assert shape["active_clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", CHASE)
def test_chase_kernel_rounds_equal_model(cuda, config):
    tables, kw = _chase_args(config)
    rounds = torch.zeros(len(tables[0]), dtype=torch.int32, device=cuda)
    out, ok = tf.decode_blocks_frags_chase(*_to(cuda, tables), BLK,
                                           rounds=rounds, **kw)
    m_out, m_ok, m_rounds = chase_model(*tables, BLK, **kw)
    assert np.array_equal(out.cpu().numpy(), m_out)
    assert np.array_equal(ok.cpu().numpy(), m_ok)
    assert rounds.cpu().tolist() == [nd | nf << 16 for nd, nf in m_rounds]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_chase_kernel_on_malformed_tables(cuda, order):
    """Garbage tables, every column live: unsorted (each byte bisects)
    and sorted (the fragment scan), at 4 KB and 64 KB."""
    for blk in (BLK, 65536):
        comp = ttf.tables(8, 64)[0]
        rng = np.random.default_rng(1)
        junk = rng.integers(-blk - 4000, blk + 4000, (4, len(comp), 2048))
        if order == "sorted":
            junk[0] = np.sort(junk[0], axis=1)
        tables = [comp, *junk.astype(np.int32),
                  np.full(len(comp), 2048, np.int32),
                  np.full(len(comp), blk, np.int32)]
        for dense, doublings, qcap in ((3, 2, 16), (5, 1, 4096)):
            got = tf.decode_blocks_frags_chase(*_to(cuda, tables), blk,
                                               dense, doublings, qcap)
            want = tf.decode_blocks_frags_chase_plain(
                *(torch.from_numpy(a) for a in tables), blk, dense,
                doublings, qcap)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", sorted(FILLS))
def test_kernels_read_nothing_past_nfrag(cuda, fill):
    tables = ttf.tables(8, 64)[:7]
    for engine, fn in ENGINES.items():
        want = fn([torch.from_numpy(a) for a in _stale(tables, None)])
        got = fn(_to(cuda, _stale(tables, fill)))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), engine
