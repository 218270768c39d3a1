"""``enc_parse_emit``'s spread route: one window's parse over a
thread-block cluster of C CTAs (``kernels/csrc/parse_cluster.cuh``) for
a launch of few windows (zig_lz4_tpu_torch.ops.torch_block).

The route splits the window's rows into C slices of whole 32-row words
(``32 * ceil(ceil(blk / 32) / C)`` rows each) and walks the greedy
parse as one speculative path a slice, from the slice's first match row,
then follows the true entry into each slice in order until it meets that
slice's path or leaves the slice.  The numpy model here is that walk and
fix-up, held against the serial walk (``greedy_walk``'s chain) on random
successor arrays, on adversarial ones (paths that never meet, chosen rows
at the slices' first and last rows, matches over whole slices, empty
slices) and on the plain parse's own successors of real windows.

On the CPU: the launch rule (``parse_spread_shape``) with the clusters
the card holds at once passed in, and the counter ``enc.spread_parses``
over a part of the benchmark's ``hits-hc9.insert`` cell (5,073 windows:
4,305 one-window launches and 384 two-window ones) and its bulk cells
(none), with the launches faked on ``meta`` tensors; and that the window
the ``cuda`` cases use to cross a CTA edge with a merged group does so.

``cuda``-marked tests hold every spread shape against the one-CTA launch
and ``parse_emit_plain`` on the card at 69,632, 102,400 and 307,200 bytes
(hc 9 and hc 0), the rule with the card's own cluster counts, and the
frames of ``tests/fixtures/narrow_frames.npz`` at the spread shape.
Tolerance: none; bytes are compared exactly.
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
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch import kernels, trace
from zig_lz4_tpu_torch.constants import compress_bound
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb
from zig_lz4_tpu_torch.parallel import sharded

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens as mtg  # noqa: E402  (inputs of the goldens)

BENCH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "lz4bench")
#: the widths of an insert call's launches: a 64 KB and a 98,304-byte
#: block's lone window, and a two-sub-span block's two windows
WIDTHS = (69_632, 102_400, 307_200)
CONTENTS = ("random", "zero", "ff", "ff_zero_words", "ff_words", "merged")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorder():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


# ---------------------------------------------------------------------
# the walk: speculative paths a slice and the fix-up
# ---------------------------------------------------------------------

def slices(blk: int, C: int):
    """[(lo, hi)] of the C slices of a ``blk``-row window."""
    S = 32 * -(-(-(-blk // 32)) // C)
    return [(min(c * S, blk), min(c * S + S, blk)) for c in range(C)]


def first_at_or_after(match: np.ndarray, x: int) -> int:
    rows = np.flatnonzero(match[x:])
    return x + int(rows[0]) if len(rows) else len(match)


def serial_walk(match: np.ndarray, succ: np.ndarray) -> list:
    """``greedy_walk``: the first match row, then each chosen row's
    successor, until past the window."""
    p, out = first_at_or_after(match, 0), []
    while p < len(match):
        out.append(p)
        p = int(succ[p])
    return out


def slice_walk(match: np.ndarray, succ: np.ndarray, C: int):
    """The spread route's walk (``walk_cluster``): each slice's path from
    its first match row (the first at or after the slice's first row,
    which may lie past it) until it leaves the slice, then the true
    entry into each slice in order, listed until it meets the slice's
    path or leaves the slice.  Returns (the rows, the rows the fix-up
    listed in each slice)."""
    blk = len(match)
    paths, exits = [], []
    for lo, hi in slices(blk, C):
        p, path = first_at_or_after(match, lo) if lo < blk else blk, []
        while p < hi:
            path.append(p)
            p = int(succ[p])
        paths.append(path)
        exits.append(p)
    x, out, fixed = first_at_or_after(match, 0), [], []
    for (lo, hi), path, exit_ in zip(slices(blk, C), paths, exits):
        on = {p: k for k, p in enumerate(path)}
        nfix, keep = 0, len(path)
        if x < hi:
            assert x >= lo
            while x not in on:
                out.append(x)
                nfix += 1
                x = int(succ[x])
                if x >= hi:
                    break
            if x < hi:
                keep, x = on[x], exit_
        out.extend(path[keep:])
        fixed.append(nfix)
    return out, fixed


def successors(match: np.ndarray, reach: np.ndarray) -> np.ndarray:
    """succ[p] = the first match row at or after ``reach[p]`` (the
    window's length where there is none), as the kernels stage it."""
    blk = len(match)
    nxt = np.full(blk + 1, blk, np.int64)
    for p in range(blk - 1, -1, -1):
        nxt[p] = p if match[p] else nxt[p + 1]
    return nxt[np.minimum(reach, blk)]


def random_case(blk: int, density: float, seed: int):
    rng = np.random.default_rng(seed)
    match = rng.random(blk) < density
    reach = np.arange(blk) + rng.integers(4, 4 + 2 * int(4 / density) + 64,
                                          blk)
    return match, successors(match, reach)


@pytest.mark.parametrize("C", [2, 4, 8, 16])
@pytest.mark.parametrize("density", [0.02, 0.3, 0.9])
def test_slice_walk_matches_serial_on_random_successors(C, density):
    for seed in range(4):
        match, succ = random_case(4_000 + 37 * seed, density, seed)
        assert slice_walk(match, succ, C)[0] == serial_walk(match, succ)


@pytest.mark.parametrize("C", [4, 16])
def test_slice_walk_when_paths_never_meet(C):
    """Every row from 1 on a match row of length 4: the true path runs
    on the rows 1 mod 4, each slice's path on the rows 0 mod 4 from its
    first row, so the two never meet and the fix-up lists every true row
    of every slice after the first."""
    blk = 69_632
    match = np.ones(blk, bool)
    match[0] = False
    succ = successors(match, np.arange(blk) + 4)
    rows, fixed = slice_walk(match, succ, C)
    assert rows == serial_walk(match, succ) == list(range(1, blk, 4))
    assert fixed[0] == 0
    assert fixed[1:] == [(hi - lo) // 4 for lo, hi in slices(blk, C)[1:]]


@pytest.mark.parametrize("C", [2, 8, 16])
def test_slice_walk_with_chosen_rows_at_slice_edges(C):
    """Successors that steer the true path onto the slices' edges: out of
    every second slice it leaves from the slice's last row into the next
    slice's fourth (past that slice's own path's start, its first row),
    and it enters every other slice at its first row."""
    blk = 69_632 + 7
    rng = np.random.default_rng(C)
    cuts = slices(blk, C)
    match = rng.random(blk) < 0.05
    for lo, hi in cuts:
        match[[lo, lo + 3, hi - 1]] = True
    succ = successors(match, np.arange(blk) + rng.integers(4, 150, blk))
    want = []
    for c, (lo, hi) in enumerate(cuts[:-1]):
        near = np.flatnonzero(match[hi - 400:hi - 5]) + hi - 400
        if c % 2 == 0:
            succ[near] = hi - 1
            succ[hi - 1] = hi + 3
            want += [hi - 1, hi + 3]
        else:
            succ[near] = hi
            want.append(hi)
    rows = serial_walk(match, succ)
    assert set(want) <= set(rows)
    rows_c, fixed = slice_walk(match, succ, C)
    assert rows_c == rows
    assert all(fixed[c] > 0 for c in range(1, C, 2))


@pytest.mark.parametrize("C", [4, 16])
def test_slice_walk_over_whole_slices_and_empty_ones(C):
    """Long matches that skip whole slices, slices with no match row,
    and windows shorter than the cluster's slices (trailing slices
    empty)."""
    blk = 69_632
    match = np.zeros(blk, bool)
    match[[5, 9, 40_000, 40_004, 69_000]] = True
    reach = np.arange(blk) + 4
    reach[9] = 39_000                    # over the slices in between
    succ = successors(match, reach)
    assert slice_walk(match, succ, C)[0] == serial_walk(match, succ) == [
        5, 9, 40_000, 40_004, 69_000]
    for blk_s in (1, 31, 100, 1_000):
        match, succ = random_case(blk_s, 0.5, blk_s)
        assert slice_walk(match, succ, C)[0] == serial_walk(match, succ)
    assert slice_walk(np.zeros(blk, bool), np.zeros(blk, np.int64),
                      C)[0] == []


def merged_groups(n: int, seed: int = 7) -> np.ndarray:
    """``n`` bytes of units [source | filler | copy of the source], 3,000
    bytes each.  The filler holds a nearer copy of the 50 bytes at each
    of five places of the source, so the copy's same-offset chain breaks
    there; each break ends a capped match whose next chosen row starts at
    its end at the same offset, and the copy parses as six entries that
    merge into one group."""
    rng = np.random.default_rng(seed)
    units = []
    for _ in range(-(-n // 3_000)):
        src = rng.integers(0, 256, 1_200, dtype=np.uint8)
        fill = rng.integers(0, 256, 600, dtype=np.uint8)
        for j, k in enumerate((100, 300, 500, 700, 900)):
            q = 40 + 110 * j
            fill[q:q + 50] = src[k:k + 50]
            fill[q - 1] = src[k - 1] ^ 0xFF
        units += [src, fill, src]
    return np.concatenate(units)[:n]


def content(name: str, n: int) -> np.ndarray:
    """The five contents of ``test_torch_sub_width.py`` and
    ``merged_groups``."""
    if name == "merged":
        return merged_groups(n)
    rng = np.random.default_rng(n)
    if name == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if name == "zero":
        return np.zeros(n, np.uint8)
    if name == "ff":
        return np.full(n, 255, np.uint8)
    if name == "ff_zero_words":
        words = np.tile(np.array([0xFFFFFFFF, 0, 0, 0], "<u4"), -(-n // 16))
        return np.frombuffer(words.tobytes()[:n], np.uint8)
    return np.frombuffer(mtg.ff_words(n), np.uint8)


def _plain_parse(row: np.ndarray, n: int, hc: int):
    """(match rows after the lazy deferral, successors, chosen rows,
    entries (p, e, off)) of the plain parse of one window."""
    w = torch.from_numpy(row[None])
    pk = tb.match_candidates_plain(w, torch.tensor([n], dtype=torch.int32),
                                   hc)[0]
    capped = 4 + 4 * tb._finder(hc, 0, 1)[0]
    ml, off, _back, is_match, _ce = tb._chain_lengths(pk, n, 0, capped)
    if hc:
        is_match = is_match & ~tb._lazy_defer(ml, is_match)
    match, ml = is_match.numpy(), ml.numpy()
    chosen = tb._greedy(is_match, ml.tolist())
    succ = successors(match, np.arange(len(row)) + ml)
    ents = [(p, p + int(ml[p]), int(off[p])) for p in chosen]
    return match, succ, chosen, ents


@pytest.mark.parametrize("hc", [9, 0])
def test_slice_walk_on_the_plain_parse_of_real_windows(hc):
    """The plain parse's successors of corpus windows and of the merged
    window at 69,632 bytes: every C gives its chosen rows."""
    blk = WIDTHS[0]
    corpus = make_corpus(mtg.CORPUS_MB)
    for k, src in enumerate((corpus[27 * 65_536:28 * 65_536],
                             corpus[13 * 65_536:14 * 65_536],
                             merged_groups(65_536).tobytes())):
        row = np.zeros(blk, np.uint8)
        row[:65_536] = np.frombuffer(src, np.uint8)
        match, succ, chosen, _ents = _plain_parse(row, 65_536 - 7 * k, hc)
        assert serial_walk(match, succ) == chosen
        for C in (4, 8, 16):
            assert slice_walk(match, succ, C)[0] == chosen


@pytest.mark.parametrize("hc", [9, 0])
def test_merged_window_crosses_a_cta_edge(hc):
    """The merged window the ``cuda`` cases run: at 69,632 bytes, full,
    its list of entries holds merged groups (an entry starting at the one
    before's end at the same offset) that straddle the edges of the
    emission's 16 chunks of ceil(cnt / 16) entries."""
    blk = WIDTHS[0]
    row = content("merged", blk)
    _match, _succ, chosen, ents = _plain_parse(row, blk, hc)
    chunk = -(-len(chosen) // 16)
    merges = [i for i in range(1, len(ents))
              if ents[i - 1][1] == ents[i][0]
              and ents[i - 1][2] == ents[i][2]]
    assert len(merges) > len(ents) // 3
    assert sum(i % chunk == 0 for i in merges) >= 4


# ---------------------------------------------------------------------
# the launch rule and the counter
# ---------------------------------------------------------------------

def _fake_active(C: int) -> int:
    """Clusters held at once as on a card of 120 SMs free for whole
    clusters, one CTA of 1024 threads an SM: 7 of 16 CTAs, 15 of 8."""
    return 120 // C


@pytest.mark.parametrize("blk,windows,want", [
    (69_632, 1, 16), (102_400, 1, 16), (307_200, 2, 16),
    (69_632, 7, 16), (69_632, 8, 8), (69_632, 30, 4), (69_632, 31, 1),
    (102_400, 15, 8), (102_400, 16, 1),
    (65_536, 768, 1), (65_536, 256, 1), (65_536, 64, 1),
    (327_680, 192, 1), (327_680, 32, 1),
    (393_216, 1, 16), (400_003, 1, 1), (524_287, 1, 1), (1, 1, 16)])
def test_parse_spread_shape(blk, windows, want):
    """The widest C from 16 down whose slices fit and whose clusters the
    card holds for every window of the launch; one CTA otherwise."""
    assert tb.parse_spread_shape(blk, windows, _fake_active) == want


def test_parse_spread_shape_rule():
    """Never below one CTA, never a C whose slices overflow or whose
    clusters the card cannot hold at once, and no wider C that would."""
    rng = np.random.default_rng(3)
    for _ in range(300):
        blk = int(rng.integers(1, 1 << 19))
        windows = int(rng.integers(1, 80))
        held = {C: int(rng.integers(0, 40)) for C in (2, 4, 8, 16)}
        C = tb.parse_spread_shape(blk, windows, held.__getitem__)
        ok = [c for c in (2, 4, 8, 16)
              if tb._spread_fits(blk, c) and held[c] >= windows]
        assert C == max(ok, default=1)
    assert tb.parse_spread_shape(69_632, 1, lambda C: 0) == 1


class _Launches:
    """``launch`` and the card's cluster counts faked: the launches are
    recorded, nothing runs."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tb, "launch",
                            lambda name, *a: self.calls.append((name, a)))
        monkeypatch.setattr(tb, "_active_clusters",
                            lambda _dev, _deep, _blk, C, J: 120 // C)
        monkeypatch.setattr(tb, "_parse_active",
                            lambda _dev, _blk, C: _fake_active(C))


def test_launch_shape_and_counter(monkeypatch, recorder):
    """``parse_emit`` launches at the rule's C (its last argument), and
    ``enc.spread_parses`` counts the windows of the launches it
    spreads."""
    rec = _Launches(monkeypatch)
    spread = 0
    for (blk, B), C in {(69_632, 1): 16, (69_632, 8): 8, (102_400, 2): 16,
                        (307_200, 2): 16, (65_536, 768): 1,
                        (327_680, 192): 1}.items():
        w = torch.empty((B, blk), dtype=torch.uint8, device="meta")
        n = torch.empty(B, dtype=torch.int32, device="meta")
        pk = torch.empty((B, blk), dtype=torch.int32, device="meta")
        tb.parse_emit(w, n, n, pk)
        name, args = rec.calls[-1]
        assert name == "enc_parse_emit" and args[-1] == C
        assert args[-2] == 1 and args[-3] == 36   # lazy, capped_ml at hc 9
        spread += B if C > 1 else 0
        assert trace.counters().get("enc.spread_parses", 0) == spread
    assert spread == 1 + 8 + 2 + 2


def _meta_encode(blocks, lens, starts, hc=9, deep=0, accel=1):
    """``encode_blocks`` as the frame codec calls it, with the kernels'
    routes taken on ``meta`` tensors (launches faked, ``_Launches``) and
    each window's payload written as one literal run from ``starts``: a
    valid LZ4 block whatever the kernels would find."""
    m = [t.to("meta") for t in (blocks, lens, starts)]
    pk = tb.match_candidates(m[0], m[1], hc, accel, deep)
    if not deep:
        tb.parse_emit(m[0], m[1], m[2], pk, hc, accel)
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


def _spread_parses(monkeypatch, config: str, sizes) -> int:
    """``enc.spread_parses`` of the benchmark configuration ``config``'s
    codec compressing one input of each size in ``sizes`` (each as many
    times as it appears), on the CPU with the launches faked."""
    _Launches(monkeypatch)
    monkeypatch.setattr(sharded, "encode_blocks", _meta_encode)
    with open(os.path.join(BENCH, "configs", config + ".json")) as f:
        settings = harness.codec_settings(json.load(f))
    codec = sharded.ShardedFrameCodec(device="cpu", **settings)
    total = 0
    for size, times in collections.Counter(sizes).items():
        trace.reset()
        data = bytes(size)
        assert lz4f.decompress_frame(codec.compress_frame(data)) == data
        total += times * trace.counters().get("enc.spread_parses", 0)
    return total


def test_insert_part_spreads_every_parse(monkeypatch, recorder):
    """A part of ``hits-hc9.insert``: each of the 4,305 blocks of one
    sub-span launches its window alone, and each of the 384 blocks of two
    launches its two windows together at 307,200 bytes; all spread."""
    with open(os.path.join(BENCH, "configs",
                           "clickhouse-hits-lz4hc9.json")) as f:
        sizes = traffic.part_block_sizes(json.load(f)["table"])
    assert len(sizes) == 4_689
    one = sum(s <= sharded._SUB for s in sizes)
    assert (one, len(sizes) - one) == (4_305, 384)
    assert _spread_parses(monkeypatch, "clickhouse-hits-lz4hc9",
                          sizes) == 4_305 + 2 * 384 == 5_073


@pytest.mark.parametrize("config,size", [("lz4hc9-b64k", 4 << 20),
                                         ("lz4hc9-b64k-4gpu", 4 << 20),
                                         ("lz4-l1-b4m", 8 << 20),
                                         ("lz4hc12-b4m", 8 << 20)])
def test_bulk_cells_spread_no_parse(monkeypatch, recorder, config, size):
    """The bulk cells' compress: 64 KB blocks launch together (768 a
    launch in the cells, 256 a card on the mesh, 64 here), 4 MB blocks
    their 327,680-byte sub-span windows together, and level 12 runs no
    ``enc_parse_emit``."""
    assert _spread_parses(monkeypatch, config, [size]) == 0


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _parse_at(w, n, st, pk, hc: int, C: int):
    """(out, out_len) of ``enc_parse_emit`` launched directly at C CTAs a
    window (1: one CTA of 256 threads)."""
    B, blk = w.shape
    cap = compress_bound(blk)
    out = torch.empty((B, cap), dtype=torch.uint8, device=w.device)
    out_len = torch.empty(B, dtype=torch.int32, device=w.device)
    mlw = torch.empty_like(pk)
    runs = torch.empty((B, (blk // 4 + 1) + 3 * (blk // 4 + 2)),
                       dtype=torch.int32, device=w.device)
    kernels.launch("enc_parse_emit", w, n, st, pk, mlw, runs, out, out_len,
                   B, blk, cap, runs.shape[1],
                   4 + 4 * tb._finder(hc, 0, 1)[0], int(hc > 0), C)
    return out, out_len


def _windows(blk: int):
    """Every content at the full width, 5 short and 48,771 bytes; every
    second window of 65,537 bytes or more after a 64 KB history."""
    rows, lens = [], []
    for name in CONTENTS:
        for n in (blk, blk - 5, 48_771):
            row = np.zeros(blk, np.uint8)
            row[:n] = content(name, n)
            rows.append(row)
            lens.append(n)
    lens = np.array(lens, np.int32)
    starts = np.where((np.arange(len(lens)) % 2 == 1) & (lens > 65_536),
                      65_536, 0).astype(np.int32)
    return np.stack(rows), lens, starts


@pytest.mark.cuda
@pytest.mark.parametrize("hc", [9, 0])
@pytest.mark.parametrize("blk", WIDTHS)
def test_spread_shapes_match_one_cta_and_plain(cuda, recorder, blk, hc):
    """Every C whose slices fit, on every window at once, against one
    CTA a window and against the plain version; each window launched
    alone by ``parse_emit`` takes the spread route and the same bytes."""
    windows, lens, starts = _windows(blk)
    w, n, s = (torch.from_numpy(a) for a in (windows, lens, starts))
    wc, nc, sc = w.to(cuda), n.to(cuda), s.to(cuda)
    pk = tb.match_candidates(wc, nc, hc)
    one = _parse_at(wc, nc, sc, pk, hc, 1)
    plain = tb.parse_emit_plain(w, n, s, pk.cpu(), hc)
    assert torch.equal(one[1].cpu(), plain[1])
    assert torch.equal(one[0].cpu(), plain[0])
    fits = [C for C in (2, 4, 8, 16) if tb._spread_fits(blk, C)]
    assert 16 in fits
    for C in fits:
        got = _parse_at(wc, nc, sc, pk, hc, C)
        assert torch.equal(got[1], one[1]), C
        assert torch.equal(got[0], one[0]), C
    trace.reset()
    alone = [tb.parse_emit(wc[i:i + 1], nc[i:i + 1], sc[i:i + 1],
                           pk[i:i + 1], hc) for i in range(len(lens))]
    assert trace.counters()["enc.spread_parses"] == len(lens)
    assert torch.equal(torch.cat([a[1] for a in alone]), one[1])
    assert torch.equal(torch.cat([a[0] for a in alone]), one[0])


@pytest.mark.cuda
def test_rule_on_the_card(cuda):
    """With the card's own cluster counts: an insert call's launches
    spread at 16 CTAs, the bulk cells' launches keep one CTA."""
    dev = torch.cuda.current_device()
    for blk, windows, want in ((69_632, 1, 16), (102_400, 1, 16),
                               (307_200, 2, 16), (65_536, 768, 1),
                               (65_536, 256, 1), (327_680, 192, 1)):
        active = functools.partial(tb._parse_active, dev, blk)
        assert tb.parse_spread_shape(blk, windows, active) == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(mtg.NARROW_FRAMES))
def test_card_spread_frames_equal_the_reference_frames(cuda, recorder, name):
    """The port's level-9 frames of ``NARROW_FRAMES`` on the card equal
    the JAX codec's byte for byte; a block of one sub-span parses its
    window at the spread route (``enc.spread_parses`` 1), the
    499,712-byte block its two windows (2)."""
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
    want = 1 if len(data) <= sharded._SUB else 2
    assert trace.counters().get("enc.spread_parses", 0) == want
