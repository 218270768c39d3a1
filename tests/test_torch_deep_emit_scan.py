"""The designs of ``enc_deep_emit`` and ``enc_match_fast``, modelled in
numpy against the plain versions they must equal
(zig_lz4_tpu_torch.ops.torch_block).

* ``enc_deep_emit`` (``kernels/csrc/encode_deep.cu``) walks the greedy
  parse through successors staged in shared memory (the walk of
  ``enc_parse_emit``), then runs in tiles of 256 chosen rows, one a
  thread, with carries across tiles:
  - the pool: a chosen row is pooled when its cap-end bit is set and its
    exclusive rank among such rows (a sum-scan) is under P = 512 a 64 KB
    of window;
  - the extension of a pooled row, two rounds of four u32 compares at
    the match's own offset, word indices clipped to the window;
  - the running cover ``prevcov``: the exclusive max-scan of the extended
    ends ``Ev`` over EVERY chosen row, kept or dropped (the reference's
    code, ``jax_block.py:842-844``);
  - keep (``Ev - max(i, prevcov) >= 4``) and move (``prevcov > i``); a
    moved row survives while its exclusive rank among the moved rows is
    under P.  One sum-scan of ``moved | keep << 16`` gives both ranks:
    a kept row's place in the compacted list is its keep rank less the
    moved rows before it that fell past P;
  - the compaction into entries (p, e, off, back): (prevcov, Ev, off, 0)
    for a moved row, (i, Ev, off, back) otherwise;
  - the emission of ``enc_parse_emit`` over the entries: an entry merges
    into the previous kept one when it starts at that one's end at the
    same offset, the last entry of a group finds its head by a max-scan,
    its size places it by a sum-scan, then the tail literal run.
  The model runs those scans tile by tile; its payload must equal
  ``deep_emit_plain``'s and the JAX payloads of the deep goldens.  The
  moved rows cannot outnumber P: a row moves only when the extended end
  of a pooled row before it covers its start, and each pooled row's
  extension moves at most one row (a moved row that is not pooled ends
  at or before the next chosen row), so the moved rows number at most
  the pooled rows, at most P.  ``test_moved_rows_never_outnumber_the_
  pool`` checks that bound where the pool overflows.
* ``enc_match_fast`` (``kernels/csrc/encode_block.cu``) sorts positions
  by s0 in the 4 stable byte passes of ``sort_radix.cuh`` (the passes
  ``enc_match`` runs for its fallback; ``test_torch_radix_emit.
  radix_pass``), then probes +1..+probes of each sorted row, a later
  probe winning only when strictly longer, over W carried windows
  (``fast_params``).  The model must equal ``match_candidates_plain(hc=0,
  accel)`` at accelerations 1, 2, 4 and 8.

Tolerance: none; payloads, lengths and packs are compared exactly.  No
JAX compile: the reference enters through the checked-in goldens.
``cuda``-marked tests hold both kernels against their plain versions on
the card.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_encode import (DEEP_CONFIGS, DEEP_GOLDENS_4K, DEEP_LEVELS,
                               _pack, _payloads, _static_inputs, tie_dense)
from test_torch_radix_emit import LESS_S0, model_order
from zig_lz4_tpu_torch.constants import compress_bound
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens as mtg  # noqa: E402  (inputs of the goldens)

#: the kernel's block: 256 threads, one chosen row or entry a thread
TILE = 256
TAKE, CAP_END, ML_MASK = 1 << 30, 1 << 29, (1 << 20) - 1
EXT_BYTES = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# enc_deep_emit: staged walk, tiled absorb and compaction, emission
# ---------------------------------------------------------------------

def excl_sum(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x) - x


def greedy_walk(st: np.ndarray) -> np.ndarray:
    """The chosen rows: from the first take row, each next one the first
    take row at or after the chosen row's end (its successor, which the
    kernel stages span by span)."""
    blk = len(st)
    take = (st & TAKE) != 0
    ml = st & ML_MASK
    first = np.minimum.accumulate(np.where(take, np.arange(blk),
                                           blk)[::-1])[::-1]
    first = np.append(first, blk)        # first take row at or after x
    chosen, p = [], int(first[0])
    while p < blk:
        chosen.append(p)
        assert p + ml[p] < blk           # the mask is read inside the window
        p = int(first[p + ml[p]])
    return np.array(chosen, np.int64)


def extension(rowz: np.ndarray, blk: int, n: int, E: np.ndarray,
              off: np.ndarray) -> np.ndarray:
    """Exact extension of pooled ends E at offsets off: two rounds of
    four LE u32 compares; word indices clip to [0, blk - 1] and bytes
    read zero at and past n (``rowz`` is the row, zero from n on)."""
    def word(j):
        j = np.clip(j, 0, blk - 1)
        return (rowz[j] | rowz[j + 1] << 8 | rowz[j + 2] << 16
                | rowz[j + 3] << 24)

    capv = np.clip(n - 5 - E, 0, EXT_BYTES)
    e = np.zeros_like(E)
    alive = capv > 0
    for _round in range(EXT_BYTES // 16):
        base = E + e
        adv = np.zeros_like(E)
        still = np.ones(len(E), bool)
        for w in range(4):
            x = word(base + 4 * w) ^ word(base - off + 4 * w)
            low = x & -x                 # equal low bytes: ctz(x) / 8
            eqb = np.where(x == 0, 4,
                           np.log2(np.maximum(low, 1)).astype(np.int64) // 8)
            adv += np.where(still, eqb, 0)
            still &= x == 0
        adv = np.where(alive, np.minimum(adv, capv - e), 0)
        e += adv
        alive &= still & (e < capv)
    return e


def absorb_tiles(row: np.ndarray, pk: np.ndarray, st: np.ndarray, n: int,
                 chosen: np.ndarray, stats: dict):
    """Pool, extension, running cover, keep and move, and compaction, in
    tiles of TILE chosen rows with carries.  Returns the entries' (p, e,
    off, back) arrays."""
    blk = len(pk)
    P = min(512 * max(blk // 65536, 1), blk)
    rowz = np.zeros(blk + 4, np.int64)
    rowz[:n] = row[:n]
    ent = np.zeros((4, len(chosen)), np.int64)
    pool_c = cov_c = moved_c = keep_c = 0
    for t0 in range(0, len(chosen), TILE):
        i = chosen[t0:t0 + TILE]
        v = st[i]
        ml = v & ML_MASK
        ce = (v & CAP_END) != 0
        pooled = ce & (pool_c + excl_sum(ce) < P)
        off = i - ((pk[i] >> 12) - 1)
        ext = np.zeros_like(i)
        ext[pooled] = extension(rowz, blk, n, (i + ml)[pooled], off[pooled])
        Ev = i + ml + ext
        incl = np.maximum.accumulate(Ev)
        prevcov = np.maximum(cov_c, np.concatenate([[0], incl[:-1]]))
        keep = Ev - np.maximum(i, prevcov) >= 4
        moved = keep & (prevcov > i)
        packed = excl_sum(moved.astype(np.int64) | keep.astype(np.int64)
                          << 16)
        moved_before = moved_c + (packed & 0xFFFF)
        keep_before = keep_c + (packed >> 16)
        kept = keep & (~moved | (moved_before < P))
        at = keep_before - np.maximum(moved_before - P, 0)
        ent[0, at[kept]] = np.where(moved, prevcov, i)[kept]
        ent[1, at[kept]] = Ev[kept]
        ent[2, at[kept]] = off[kept]
        ent[3, at[kept]] = np.where(moved, 0, pk[i] & 3)[kept]
        stats["raised"] += int((~keep & (Ev > prevcov)).sum())
        pool_c += int(ce.sum())
        cov_c = max(cov_c, int(Ev.max()))
        moved_c += int(moved.sum())
        keep_c += int(keep.sum())
    stats.update(capped=pool_c, moved=moved_c, P=P)
    return ent[:, :keep_c - max(moved_c - P, 0)]


def _len_bytes(v):
    return np.where(v >= 0, v // 255 + 1, 0)


def emit_tiles(data: bytes, n: int, start: int, ent: np.ndarray) -> bytes:
    """The emission over the entries (p, e, off, back), in tiles of TILE
    entries: heads by a max-scan carried across tiles, the groups'
    sizes placed by a sum-scan carried across tiles, then the tail."""
    if n <= start:
        return b""
    p, e, off, back = ent
    m = len(p)
    out = bytearray(len(data) + len(data) // 255 + 16)

    def put_len(q, v):
        while v >= 255:
            out[q] = 255
            q, v = q + 1, v - 255
        out[q] = v
        return q + 1

    carry_head, carry_out = -1, 0
    for t0 in range(0, m, TILE):
        k = np.arange(t0, min(t0 + TILE, m))
        head = np.ones(len(k), bool)
        prev = k[k > 0] - 1
        head[k > 0] = ~((e[prev] == p[k[k > 0]]) & (off[prev] == off[k[k > 0]]))
        last = np.ones(len(k), bool)
        nxt = k[k + 1 < m] + 1
        last[k + 1 < m] = ~((p[nxt] == e[k[k + 1 < m]])
                            & (off[nxt] == off[k[k + 1 < m]]))
        h = np.maximum(carry_head,
                       np.maximum.accumulate(np.where(head, k, -1)))
        ph = p[h]
        prev_end = np.where(h > 0, np.maximum(e[np.maximum(h - 1, 0)], start),
                            start)
        bq = np.maximum(np.minimum(np.minimum(back[h], ph - prev_end),
                                   ph - off[k]), 0)
        lit, mml = ph - bq - prev_end, e[k] - (ph - bq)
        size = np.where(last, 1 + _len_bytes(lit - 15) + lit + 2
                        + _len_bytes(mml - 19), 0)
        at = carry_out + excl_sum(size)
        for j in np.nonzero(last)[0]:
            q, L, M = int(at[j]), int(lit[j]), int(mml[j])
            out[q] = (min(L, 15) << 4) | min(M - 4, 15)
            q += 1
            if L >= 15:
                q = put_len(q, L - 15)
            out[q:q + L] = data[prev_end[j]:prev_end[j] + L]
            q += L
            out[q:q + 2] = bytes((int(off[k[j]]) & 0xFF, int(off[k[j]]) >> 8))
            q += 2
            if M - 4 >= 15:
                q = put_len(q, M - 19)
            assert q == at[j] + size[j]
        carry_head = max(carry_head, int(np.where(head, k, -1).max()))
        carry_out += int(size.sum())
    tail = max(int(e[-1]), start) if m else start
    lit = n - tail
    q = carry_out
    out[q] = min(lit, 15) << 4
    q += 1
    if lit >= 15:
        q = put_len(q, lit - 15)
    out[q:q + lit] = data[tail:n]
    return bytes(out[:q + lit])


def deep_emit_model(row: np.ndarray, pk: np.ndarray, st: np.ndarray,
                    n: int, start: int, stats: dict | None = None) -> bytes:
    """One window through the kernel's phases: walk, tiled absorb and
    compaction, tiled emission."""
    stats = {"raised": 0} if stats is None else stats
    stats.setdefault("raised", 0)
    if n <= start:
        return b""
    chosen = greedy_walk(st)
    stats["chosen"] = len(chosen)
    ent = absorb_tiles(row, pk, st, n, chosen, stats)
    return emit_tiles(row.tobytes(), n, start, ent)


def deep_inputs(windows, lens, starts, hc, deep):
    """(pk, st) of the plain finder and price parse."""
    w, n, s = (torch.from_numpy(a) for a in (windows, lens, starts))
    pk = tb.match_candidates_plain(w, n, hc, 1, deep)
    return pk, tb.deep_dp_plain(n, s, pk, deep)


def model_matches_plain(windows, lens, starts, pk, st, stats=None):
    """The model's payloads, each checked against deep_emit_plain's."""
    w, n, s = (torch.from_numpy(a) for a in (windows, lens, starts))
    out_p, len_p = tb.deep_emit_plain(w, n, s, pk, st)
    got = []
    for k in range(len(lens)):
        st_k = {} if stats is None else stats.setdefault(k, {})
        pay = deep_emit_model(windows[k], pk[k].long().numpy(),
                              st[k].long().numpy(), int(lens[k]),
                              int(starts[k]), st_k)
        assert pay == out_p[k, :int(len_p[k])].numpy().tobytes(), k
        got.append(pay)
    return got


@pytest.fixture(scope="module")
def static_batch():
    return _pack(_static_inputs())


@pytest.mark.parametrize("config", sorted(DEEP_CONFIGS))
def test_scan_model_matches_plain_and_goldens_4k(config, static_batch):
    """Every deep configuration on the static 4 KB inputs (empty, short,
    history rows with start > 0, fuzz rows), against the plain version
    and the JAX payloads of ``deep4k.npz``."""
    _rows, windows, lens, starts = static_batch
    assert (starts > 0).any()
    hc, deep = DEEP_CONFIGS[config]
    pk, st = deep_inputs(windows, lens, starts, hc, deep)
    got = model_matches_plain(windows, lens, starts, pk, st)
    z = np.load(DEEP_GOLDENS_4K)
    assert got == _payloads(z[f"payloads_{config}"], z[f"out_len_{config}"])


def test_scan_model_makes_the_deep_frames_4k(monkeypatch, corpus):
    """The JAX codec's level-12 frames of ``deep_frames4k.npz``, written
    by the port's frame layer with the model in place of the emission."""
    from zig_lz4_tpu_torch import ShardedFrameCodec

    def model_emit(blocks, lens, starts, pk, st):
        B, blk = blocks.shape
        out = torch.zeros((B, compress_bound(blk)), dtype=torch.uint8)
        out_len = torch.zeros(B, dtype=torch.int32)
        for k in range(B):
            pay = deep_emit_model(blocks[k].numpy(), pk[k].long().numpy(),
                                  st[k].long().numpy(), int(lens[k]),
                                  int(starts[k]))
            if pay:
                out[k, :len(pay)] = torch.frombuffer(bytearray(pay),
                                                     dtype=torch.uint8)
            out_len[k] = len(pay)
        return out, out_len

    monkeypatch.setattr(tb, "deep_emit_plain", model_emit)
    inputs = dict(corpus, multi=make_corpus(mtg.CORPUS_MB)[mtg.MULTI])
    codec = ShardedFrameCodec(compression_level=12, device="cpu")
    codec.block_size = codec.window = mtg.SMALL
    with np.load(mtg.DEEP_FRAMES_OUT) as z:
        assert set(z.files) == {f"l12_{k}" for k in inputs}
        for name, data in inputs.items():
            assert codec.compress_frame(data) == z[f"l12_{name}"].tobytes(), \
                name


@pytest.fixture(scope="module")
def deep_rows_64k():
    return mtg.deep_rows(make_corpus(mtg.CORPUS_MB))


@pytest.mark.parametrize("level", DEEP_LEVELS)
def test_scan_model_matches_goldens_64k(level, deep_rows_64k):
    """The 64 KB deep goldens (corpus blocks, a byte run, a period-300
    block, a code-like block, a window with start = 20,000)."""
    windows, lens, starts = deep_rows_64k
    assert starts[-1] == 20_000
    hc, deep = tb.level_params(level)
    pk, st = deep_inputs(windows, lens, starts, hc, deep)
    z = np.load(mtg.DEEP64K_OUT.format(level))
    assert model_matches_plain(windows, lens, starts, pk, st) == \
        _payloads(z["payloads"], z["out_len"])


def test_scan_model_matches_a_wide_deep_golden():
    """One 131,072-byte window of ``wide_deep_corpus.npz`` at level 10:
    P = 1,024 there, and the walk crosses 64 staged spans."""
    windows, lens, starts = mtg.wide_deep_windows(
        make_corpus(mtg.CORPUS_MB), "w131k", 10)
    windows, lens, starts = windows[:1], lens[:1], starts[:1]
    assert windows.shape[1] == 131_072 and starts[0] > 0
    pk, st = deep_inputs(windows, lens, starts, 8, 1)
    with np.load(mtg.WIDE_DEEP_OUT) as z:
        want = _payloads(z["w131k_l10_payloads"], z["w131k_l10_out_len"])[0]
    assert model_matches_plain(windows, lens, starts, pk, st) == [want]


def test_scan_model_with_no_emission():
    """n == start: no payload (out_len 0); the walk does not run."""
    windows = tie_dense(4096, 5)[[2, 7]]
    lens = np.array([4096, 100], np.int32)
    starts = np.array([4096, 100], np.int32)
    pk, st = deep_inputs(windows, lens, starts, 8, 3)
    assert model_matches_plain(windows, lens, starts, pk, st) == [b"", b""]


def overflow_window(seed: int = 11, blk: int = 65536) -> np.ndarray:
    """A window whose capped chosen rows outnumber the pool: lines of 36
    to 45 bytes drawn from 400 random ones, each within two lines of the
    one before, so most matches run past the carried windows and their
    chains end where the next line is drawn elsewhere."""
    rng = np.random.default_rng(seed)
    lines = [rng.integers(0, 256, int(rng.integers(36, 46)), dtype=np.uint8)
             for _ in range(400)]
    out, k = [], 0
    while sum(map(len, out)) < blk:
        k = (k + int(rng.integers(-2, 3))) % len(lines)
        out.append(lines[k])
    return np.concatenate(out)[:blk]


@pytest.fixture(scope="module")
def overflow_batch():
    """The overflow window at level 12, full and with n < blk, start >
    0; and its stats."""
    row = overflow_window()
    windows = np.stack([row, row])
    lens = np.array([65536, 60_001], np.int32)
    starts = np.array([0, 777], np.int32)
    pk, st = deep_inputs(windows, lens, starts, 8, 3)
    stats = {}
    got = model_matches_plain(windows, lens, starts, pk, st, stats)
    return windows, lens, starts, pk, st, stats, got


def test_scan_model_on_a_pool_overflow(overflow_batch):
    """The capped chosen rows exceed P = 512, so the pool is cut to the
    first P by position, and some dropped row raises the running max
    (the cover is a max over every chosen row, kept or dropped)."""
    stats = overflow_batch[5]
    for k in (0, 1):
        assert stats[k]["capped"] > stats[k]["P"] == 512, stats[k]
        assert stats[k]["chosen"] > 2 * TILE
    assert any(s["raised"] for s in stats.values()), stats


def test_moved_rows_never_outnumber_the_pool(overflow_batch):
    stats = overflow_batch[5]
    for s in stats.values():
        assert 0 < s["moved"] <= s["P"], s


def test_tiled_emission_equals_the_parse_emission():
    """The factored emission serves ``enc_parse_emit`` too: over the
    chosen rows of ``_parse_one`` as entries (p, p + ml, off, back), it
    gives ``parse_emit_plain``'s bytes."""
    _rows, windows, lens, starts = _pack(_static_inputs())
    w, n, s = (torch.from_numpy(a) for a in (windows, lens, starts))
    pk = tb.match_candidates_plain(w, n, 9)
    out_p, len_p = tb.parse_emit_plain(w, n, s, pk, 9)
    for k in range(len(lens)):
        chosen, ml, off, back = tb._parse_one(pk[k], int(lens[k]),
                                              int(starts[k]), 36, True)
        c = np.array(chosen, np.int64)
        ent = np.stack([c, c + np.array(ml)[c], np.array(off)[c],
                        np.array(back)[c]]) if len(c) else \
            np.zeros((4, 0), np.int64)
        assert emit_tiles(windows[k].tobytes(), int(lens[k]), int(starts[k]),
                          ent) == out_p[k, :int(len_p[k])].numpy().tobytes()


# ---------------------------------------------------------------------
# enc_match_fast: 4 s0 passes, probes +1..+probes
# ---------------------------------------------------------------------

def fast_model(row: np.ndarray, n: int, accel: int) -> np.ndarray:
    """The kernel's candidate pack of every position at hc = 0."""
    W, probes = tb.fast_params(accel)
    blk = len(row)
    s = model_order(row, n, LESS_S0)
    b = np.zeros(blk + 4 * W + 8, np.int64)
    b[:n] = row[:n]

    def at(p):
        return b[p] | b[p + 1] << 8 | b[p + 2] << 16 | b[p + 3] << 24

    def byte(p):
        return np.where(p < 0, 0, b[np.maximum(p, 0)])

    best_ml = np.zeros(blk, np.int64)
    best = np.zeros(blk, np.int64)
    for k in range(1, probes + 1):
        t = np.arange(k, blk)
        p, q = s[t], s[t - k]
        ok = (p <= n - 4) & (q <= n - 4) & (q < p) & (p - q <= 65535)
        ok &= at(p) == at(q)
        ml = np.full(len(t), 4, np.int64)
        going = np.ones(len(t), bool)
        for j in range(1, W + 1):
            x = at(p + 4 * j) ^ at(q + 4 * j)
            low = x & -x
            eqb = np.where(x == 0, 4,
                           np.log2(np.maximum(low, 1)).astype(np.int64) // 8)
            ml += np.where(going, eqb, 0)
            going &= x == 0
        back = np.where(byte(p - 1) != byte(q - 1), 0,
                        np.where(byte(p - 2) != byte(q - 2), 1, 2))
        ml = np.where(ok, ml, 0)
        win = ok & (ml > best_ml[p])     # a later probe: strictly longer
        best_ml[p[win]] = ml[win]
        best[p[win]] = ((q + 1) << 12 | ml << 6 | back)[win]
    return best


def fast_model_matches_plain(windows, lens, accel):
    w, n = torch.from_numpy(windows), torch.from_numpy(lens)
    want = tb.match_candidates_plain(w, n, 0, accel).numpy()
    for k in range(len(lens)):
        assert np.array_equal(fast_model(windows[k], int(lens[k]), accel),
                              want[k]), (k, accel)


ACCELS = (1, 2, 4, 8)


@pytest.mark.parametrize("accel", ACCELS)
def test_fast_model_matches_plain_4k(accel, static_batch):
    _rows, windows, lens, _starts = static_batch
    fast_model_matches_plain(windows, lens, accel)


@pytest.mark.parametrize("accel", ACCELS)
def test_fast_model_on_tie_dense_windows(accel):
    windows = tie_dense(5000, 23)
    lens = np.array([5000, 4999, 4996, 4097, 5000, 1, 3, 4], np.int32)
    fast_model_matches_plain(windows, lens, accel)


@pytest.mark.parametrize("blk", [1, 5, 13, 300, 1001])
def test_fast_model_odd_window_sizes(blk):
    rng = np.random.default_rng(blk)
    windows = np.stack([rng.integers(0, 3, blk, dtype=np.uint8),
                        np.resize(np.frombuffer(b"abcabcabd", np.uint8),
                                  blk)])
    lens = np.array([blk, max(blk - 2, 0)], np.int32)
    for accel in ACCELS:
        fast_model_matches_plain(windows, lens, accel)


# ---------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _deep_emit_matches_plain(cuda, windows, lens, starts, pk, st):
    w, n, s = (torch.from_numpy(a) for a in (windows, lens, starts))
    out, out_len = tb.deep_emit(w.to(cuda), n.to(cuda), s.to(cuda),
                                pk.to(cuda), st.to(cuda))
    torch.cuda.synchronize()
    out_p, len_p = tb.deep_emit_plain(w, n, s, pk, st)
    assert torch.equal(out_len.cpu(), len_p)
    assert torch.equal(out.cpu(), out_p)


@pytest.mark.cuda
def test_enc_deep_emit_on_a_pool_overflow(cuda, overflow_batch):
    windows, lens, starts, pk, st = overflow_batch[:5]
    _deep_emit_matches_plain(cuda, windows, lens, starts, pk, st)


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [1, 3])
def test_enc_deep_emit_odd_window_sizes(cuda, deep):
    rng = np.random.default_rng(deep)
    for blk in (1, 13, 31, 33, 300, 2049, 5000):
        windows = np.zeros((3, blk), np.uint8)
        windows[0] = np.resize(np.frombuffer(b"the quick brown fox ",
                                             np.uint8), blk)
        windows[1] = rng.integers(0, 3, blk, dtype=np.uint8)
        windows[2] = overflow_window(deep, blk)
        lens = np.array([blk, blk, blk // 2], np.int32)
        starts = np.array([0, blk // 3, blk // 2], np.int32)
        pk, st = deep_inputs(windows, lens, starts, 8, deep)
        _deep_emit_matches_plain(cuda, windows, lens, starts, pk, st)


@pytest.mark.cuda
@pytest.mark.parametrize("accel", ACCELS)
def test_enc_match_fast_matches_plain(cuda, accel):
    blk = 65536
    rng = np.random.default_rng(accel)
    windows = np.concatenate([tie_dense(blk, 29), overflow_window(accel)[None],
                              rng.integers(0, 256, (1, blk), dtype=np.uint8)])
    lens = np.full(len(windows), blk, np.int32)
    lens[1::2] -= 3
    w, n = torch.from_numpy(windows), torch.from_numpy(lens)
    pk = tb.match_candidates(w.to(cuda), n.to(cuda), 0, accel)
    torch.cuda.synchronize()
    assert torch.equal(pk.cpu(), tb.match_candidates_plain(w, n, 0, accel))
    for odd in (1, 5, 13, 1001, 4097):
        pk = tb.match_candidates(w[:3, :odd].contiguous().to(cuda),
                                 n[:3].clamp(max=odd).to(cuda), 0, accel)
        torch.cuda.synchronize()
        assert torch.equal(pk.cpu(), tb.match_candidates_plain(
            w[:3, :odd].contiguous(), n[:3].clamp(max=odd), 0, accel))
