"""The port's block encoder, levels 0-12
(zig_lz4_tpu_torch.ops.torch_block) against the JAX reference
(zig_lz4_tpu.ops.jax_block).

Tolerance: none.  The outputs are bytes and lengths, so every
comparison is exact equality.

* 4 KB windows, live: the plain encoder against
  ``encode_blocks_jax(..., blk=4096)`` at ``hc=9`` and at ``hc=0``
  on the same inputs (one JAX compile each for the whole batch; this is
  the one test file that compiles the JAX encoder).
* 4 KB windows, checked in: every other configuration (``hc=0`` at
  ``accel`` 1, 2, 4, 8 and ``hc`` 2..8) against the JAX payloads of
  ``tests/fixtures/levels4k.npz``.
* 64 KB windows: the plain encoder at levels 0, 4 and 9 against the JAX
  payloads checked in by ``tests/fixtures/make_torch_goldens.py``
  (compiling JAX at 64 KB takes minutes on a CPU).
* The deep levels: ``(hc, deep)`` = (8, 1), (8, 2), (8, 3) and (4, 1)
  at 4 KB against ``tests/fixtures/deep4k.npz``, and levels 10, 11, 12
  at 64 KB against ``deep_corpus64k_l<level>.npz`` (the corpus blocks,
  a byte run, a period-300 block, a code-like block whose matches run
  far over 1024 bytes, and a window with ``start > 0`` and ``n < blk``).
* ``cuda``-marked tests hold the CUDA kernels against the plain
  versions; they skip where there is no CUDA device.  On the card:
  ``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import os
import random

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch.constants import compress_bound
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb
from zig_lz4_tpu_torch.ops.block import (decompress_safe,
                                         decompress_safe_using_dict)

BLK = 4096
_FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDENS = os.path.join(_FIXDIR, "l9_corpus64k.npz")
#: JAX payloads of the same 64 KB blocks at levels 0 and 4, and of the
#: static 4 KB inputs at every configuration below level 9
LEVEL_GOLDENS = os.path.join(_FIXDIR, "levels_corpus64k.npz")
GOLDENS_4K = os.path.join(_FIXDIR, "levels4k.npz")
#: name -> (hc, accel), as tests/fixtures/make_torch_goldens.py writes
LEVEL_CONFIGS = {**{f"hc0_a{a}": (0, a) for a in (1, 2, 4, 8)},
                 **{f"hc{h}": (h, 1) for h in range(2, 9)}}
#: make_corpus(2) 64 KB blocks of the goldens file, one per content type
GOLDEN_BLOCKS = (0, 5, 7, 9, 13, 18, 27, 29)
#: the deep configurations: name -> (hc, deep), as make_torch_goldens.py
#: writes them: levels 10, 11, 12 and the reference's fuzz configuration
DEEP_CONFIGS = {"hc8_d1": (8, 1), "hc8_d2": (8, 2), "hc8_d3": (8, 3),
                "hc4_d1": (4, 1)}
DEEP_GOLDENS_4K = os.path.join(_FIXDIR, "deep4k.npz")
DEEP_GOLDENS_64K = os.path.join(_FIXDIR, "deep_corpus64k_l{}.npz")
DEEP_LEVELS = (10, 11, 12)
#: windows of the 64 KB deep goldens: the corpus blocks and four more
DEEP_ROWS_64K = len(GOLDEN_BLOCKS) + 4

#: tests/test_jax_codec.py:50-62
CASES = {
    "text": (b"the quick brown fox jumps over the lazy dog " * 80)[:3500],
    "rle": b"a" * 3000,
    "rle2": b"ab" * 1500,
    "random": bytes(random.Random(1).randrange(256) for _ in range(3000)),
    "low_entropy": bytes(random.Random(2).randrange(4) for _ in range(4000)),
    "ramp": bytes(i & 0xFF for i in range(4096)),
    "tiny": b"hello",
    "twelve": b"0123456789ab",
    "thirteen": b"0123456789abc",
    "empty": b"",
    "mixed": (b"abcabcabc" + bytes(random.Random(3).randrange(256)
                                   for _ in range(200))) * 10,
}
#: keys of the conftest ``corpus`` fixture
CORPUS = ("hello", "repeated", "lorem", "random256", "empty", "ramp",
          "tiny", "rle", "mixed")
#: windows per corpus entry (entries longer than BLK are cut into
#: consecutive BLK windows)
MAX_WINDOWS = 4


def _fuzz(seed: int):
    """A window of copies from earlier in it (short and long offsets,
    overlapping), low-entropy runs and random bytes; odd seeds fill the
    window, even ones stop short, every third starts emission late."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < BLK:
        r = rng.random()
        if r < 0.45 and len(out) > 8:
            off = int(rng.integers(1, min(len(out), 6000) + 1))
            for _ in range(int(rng.integers(3, 120))):
                out.append(out[-off])
        elif r < 0.75:
            out += rng.integers(0, 4, int(rng.integers(1, 24)),
                                dtype=np.uint8).tobytes()
        else:
            out += rng.integers(0, 256, int(rng.integers(1, 12)),
                                dtype=np.uint8).tobytes()
    n = BLK if seed % 2 else int(rng.integers(1, BLK))
    start = int(rng.integers(0, n)) if seed % 3 == 0 else 0
    return bytes(out[:n]), start


def _static_inputs():
    """name -> [(data, start)]: CASES, make_corpus slices (full
    windows and n < blk), two windows with a history prefix and seeded
    fuzz windows."""
    c = make_corpus(2)
    inputs = {f"case_{k}": [(v, 0)] for k, v in CASES.items()}
    for blk_i in GOLDEN_BLOCKS:
        base = blk_i * 65536 + 1000
        inputs[f"corpus2_{blk_i}"] = [(c[base:base + BLK], 0),
                                      (c[base + BLK:base + BLK + 1500], 0)]
    text = CASES["text"]
    inputs["history"] = [(text[:3000], 1024), (text[:2000], 2000)]
    inputs["fuzz"] = [_fuzz(seed) for seed in range(12)]
    return inputs


def tie_dense(blk: int, seed: int = 0) -> np.ndarray:
    """Windows dense in ties for the finders' sorts, as rows of blk
    bytes: all 0x00, all 0xFF, periods 1, 2, 3, 4 and 7, and random bytes
    over {0, 1}."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(blk, np.uint8), np.full(blk, 0xFF, np.uint8)]
    for per in (1, 2, 3, 4, 7):
        rows.append(np.resize(rng.integers(0, 256, per, dtype=np.uint8),
                              blk))
    rows.append(rng.integers(0, 2, blk, dtype=np.uint8))
    return np.stack(rows)


def _with_corpus(corpus):
    inputs = _static_inputs()
    for k in CORPUS:
        v = corpus[k]
        inputs[f"corpus_{k}"] = [(v[i:i + BLK], 0) for i in
                                 range(0, max(len(v), 1), BLK)][:MAX_WINDOWS]
    return inputs


def _pack(inputs):
    """Batch arrays of every window, and name -> row indices."""
    rows, flat = {}, []
    for name, wins in inputs.items():
        rows[name] = list(range(len(flat), len(flat) + len(wins)))
        flat += wins
    windows = np.zeros((len(flat), BLK), np.uint8)
    lens = np.zeros(len(flat), np.int32)
    starts = np.zeros(len(flat), np.int32)
    for k, (d, s) in enumerate(flat):
        windows[k, :len(d)] = np.frombuffer(d, np.uint8)
        lens[k], starts[k] = len(d), s
    return rows, windows, lens, starts


def _encode(windows, lens, starts, device="cpu", hc=9, accel=1, deep=0):
    out, out_len = tb.encode_blocks(torch.from_numpy(windows).to(device),
                                    torch.from_numpy(lens).to(device),
                                    torch.from_numpy(starts).to(device),
                                    hc=hc, deep=deep, accel=accel)
    return out.cpu().numpy(), out_len.cpu().numpy()


def _payloads(dense, out_len):
    """The payloads packed back to back in ``dense``, as a list."""
    ends = np.cumsum(out_len)
    return [dense[e - n:e].tobytes() for e, n in zip(ends, out_len)]


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
def batch(corpus):
    return _pack(_with_corpus(corpus))


@pytest.fixture(scope="module")
def jax_out(batch):
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax
    _rows, windows, lens, starts = batch
    out, out_len = encode_blocks_jax(windows, lens, blk=BLK, starts=starts,
                                     hc=9)
    return np.asarray(out), np.asarray(out_len)


@pytest.fixture(scope="module")
def port_out(batch):
    _rows, windows, lens, starts = batch
    return _encode(windows, lens, starts)


@pytest.fixture(scope="module")
def jax_out_fast(batch):
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax
    _rows, windows, lens, starts = batch
    out, out_len = encode_blocks_jax(windows, lens, blk=BLK, starts=starts,
                                     hc=0, accel=1)
    return np.asarray(out), np.asarray(out_len)


@pytest.fixture(scope="module")
def port_out_fast(batch):
    _rows, windows, lens, starts = batch
    return _encode(windows, lens, starts, hc=0)


@pytest.fixture(scope="module")
def static_batch():
    return _pack(_static_inputs())


@pytest.fixture(scope="module")
def goldens():
    z = np.load(GOLDENS)
    assert tuple(z["blocks"]) == GOLDEN_BLOCKS
    c = make_corpus(2)
    rows = np.stack([np.frombuffer(c[i * 65536:(i + 1) * 65536], np.uint8)
                     for i in GOLDEN_BLOCKS])
    zl = np.load(LEVEL_GOLDENS)
    assert tuple(zl["blocks"]) == GOLDEN_BLOCKS
    payloads = {9: _payloads(z["payloads"], z["out_len"])}
    for level in (0, 4):
        payloads[level] = _payloads(zl[f"payloads_l{level}"],
                                    zl[f"out_len_l{level}"])
    return rows, payloads


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


NAMES = list(_static_inputs()) + [f"corpus_{k}" for k in CORPUS]


@pytest.mark.parametrize("name", NAMES)
def test_plain_encode_matches_jax_4k(name, batch, jax_out, port_out):
    rows, _w, lens, starts = batch
    for r in rows[name]:
        assert port_out[1][r] == jax_out[1][r]
        assert np.array_equal(port_out[0][r], jax_out[0][r])


@pytest.mark.parametrize("name", NAMES)
def test_plain_fast_encode_matches_jax_4k(name, batch, jax_out_fast,
                                          port_out_fast):
    rows, _w, lens, starts = batch
    for r in rows[name]:
        assert port_out_fast[1][r] == jax_out_fast[1][r]
        assert np.array_equal(port_out_fast[0][r], jax_out_fast[0][r])


def _decodes(windows, lens, starts, out, rows):
    for r in rows:
        n, s = int(lens[r]), int(starts[r])
        comp = out[0][r, :out[1][r]].tobytes()
        assert not out[0][r, out[1][r]:].any()
        if n == s:
            assert comp == b""
            continue
        want = windows[r, s:n].tobytes()
        if s == 0:
            assert decompress_safe(comp, n) == want
        else:
            assert decompress_safe_using_dict(
                comp, n - s, windows[r, :s].tobytes()) == want


@pytest.mark.parametrize("name", NAMES)
def test_plain_encode_decodes_with_oracle(name, batch, port_out):
    rows, windows, lens, starts = batch
    _decodes(windows, lens, starts, port_out, rows[name])


@pytest.mark.parametrize("config", sorted(LEVEL_CONFIGS))
def test_plain_encode_matches_jax_goldens_4k(config, static_batch):
    """Every configuration below level 9 on the static inputs (cases,
    corpus slices, history and fuzz rows), against the JAX payloads
    checked in; each output also decodes to its input."""
    hc, accel = LEVEL_CONFIGS[config]
    rows, windows, lens, starts = static_batch
    z = np.load(GOLDENS_4K)
    out = _encode(windows, lens, starts, hc=hc, accel=accel)
    assert np.array_equal(out[1], z[f"out_len_{config}"])
    want = _payloads(z[f"payloads_{config}"], z[f"out_len_{config}"])
    for r, p in enumerate(want):
        assert out[0][r, :out[1][r]].tobytes() == p, (config, r)
    _decodes(windows, lens, starts, out, range(len(lens)))


def test_goldens_4k_cover_every_configuration():
    with np.load(GOLDENS_4K) as z:
        assert set(z.files) == {f"{kind}_{c}" for c in LEVEL_CONFIGS
                                for kind in ("out_len", "payloads")}
        # the acceleration knob and the level change the bytes
        sizes = {c: int(z[f"out_len_{c}"].sum()) for c in LEVEL_CONFIGS}
    assert sizes["hc0_a1"] < sizes["hc0_a2"] < sizes["hc0_a4"] \
        < sizes["hc0_a8"]
    assert sizes["hc8"] < sizes["hc2"] < sizes["hc0_a1"]


def _matches_golden_64k(k, level, goldens):
    rows, payloads = goldens
    hc, _deep = tb.level_params(level)
    out, out_len = _encode(rows[k:k + 1], np.full(1, 65536, np.int32),
                           np.zeros(1, np.int32), hc=hc)
    assert out.shape == (1, compress_bound(65536))
    assert out[0, :out_len[0]].tobytes() == payloads[level][k]


@pytest.mark.parametrize("k", range(len(GOLDEN_BLOCKS)))
def test_plain_encode_matches_jax_goldens_64k(k, goldens):
    _matches_golden_64k(k, 9, goldens)


@pytest.mark.parametrize("level", [0, 4])
@pytest.mark.parametrize("k", range(len(GOLDEN_BLOCKS)))
def test_plain_encode_matches_jax_level_goldens_64k(k, level, goldens):
    _matches_golden_64k(k, level, goldens)


def test_level_params_match_reference():
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_block import fast_params, level_params
    for level in range(-1, 14):
        assert tb.level_params(level) == level_params(level)
    for accel in range(-1, 12):
        assert tb.fast_params(accel) == fast_params(accel)


def test_deep_levels_raise_not_implemented():
    """The deep levels encode now; what still raises is a ``deep``
    outside 1..3, ``deep`` over the fast finder, and a negative
    ``hc``."""
    data = (b"deep levels encode " * 4)[:64]
    w = torch.frombuffer(bytearray(data), dtype=torch.uint8)[None]
    n = torch.full((1,), 64, dtype=torch.int32)
    for deep in (1, 2, 3):
        for fn in (tb.encode_blocks, tb.encode_blocks_plain):
            out, out_len = fn(w, n, hc=8, deep=deep)
            assert decompress_safe(out[0, :int(out_len[0])].numpy()
                                   .tobytes(), 64) == data
    for hc, deep in ((8, 4), (8, -1), (0, 1)):
        with pytest.raises(ValueError):
            tb.encode_blocks(w, n, hc=hc, deep=deep)
    with pytest.raises(ValueError):
        tb.encode_blocks(w, n, hc=-1)
    with pytest.raises(ValueError):
        tb.deep_dp(n, n, torch.zeros((1, 64), dtype=torch.int32), 0)


@pytest.fixture(scope="module")
def deep_out_4k(static_batch):
    """config -> the plain encoder's (out, out_len) of the static
    inputs, encoded once per configuration."""
    _rows, windows, lens, starts = static_batch
    done = {}

    def get(config):
        if config not in done:
            hc, deep = DEEP_CONFIGS[config]
            done[config] = _encode(windows, lens, starts, hc=hc, deep=deep)
        return done[config]
    return get


STATIC_NAMES = list(_static_inputs())


@pytest.mark.parametrize("config", sorted(DEEP_CONFIGS))
@pytest.mark.parametrize("name", STATIC_NAMES)
def test_plain_deep_encode_matches_jax_goldens_4k(name, config, static_batch,
                                                  deep_out_4k):
    """Rank tiers, price parse, extension and absorb on the static
    inputs (empty, 12- and 13-byte, byte-run and incompressible
    windows, corpus slices with ``n < blk``, history rows with
    ``start > 0``, fuzz rows), against the JAX payloads checked in;
    each output also decodes to its input."""
    rows, windows, lens, starts = static_batch
    z = np.load(DEEP_GOLDENS_4K)
    want = _payloads(z[f"payloads_{config}"], z[f"out_len_{config}"])
    out = deep_out_4k(config)
    for r in rows[name]:
        assert out[1][r] == z[f"out_len_{config}"][r]
        assert out[0][r, :out[1][r]].tobytes() == want[r], (config, r)
    _decodes(windows, lens, starts, out, rows[name])


def test_deep_goldens_4k_cover_every_configuration(static_batch):
    with np.load(DEEP_GOLDENS_4K) as z:
        assert set(z.files) == {f"{kind}_{c}" for c in DEEP_CONFIGS
                                for kind in ("out_len", "payloads")}
        sizes = {c: int(z[f"out_len_{c}"].sum()) for c in DEEP_CONFIGS}
        assert all(len(z[f"out_len_{c}"]) == len(static_batch[2])
                   for c in DEEP_CONFIGS)
    with np.load(GOLDENS_4K) as z:
        hc8 = int(z["out_len_hc8"].sum())
    # the price parse pays: every deep configuration beats level 8
    assert max(sizes.values()) < hc8


@pytest.fixture(scope="module")
def deep_rows_64k():
    """(windows, lens, starts) of the 64 KB deep goldens."""
    import sys
    sys.path.insert(0, _FIXDIR)
    import make_torch_goldens
    rows = make_torch_goldens.deep_rows(make_corpus(
        make_torch_goldens.CORPUS_MB))
    assert len(rows[1]) == DEEP_ROWS_64K
    return rows


def _deep_golden_64k(level):
    z = np.load(DEEP_GOLDENS_64K.format(level))
    assert tuple(z["blocks"]) == GOLDEN_BLOCKS
    assert len(z["out_len"]) == DEEP_ROWS_64K
    return _payloads(z["payloads"], z["out_len"])


@pytest.mark.parametrize("level", DEEP_LEVELS)
@pytest.mark.parametrize("k", range(DEEP_ROWS_64K))
def test_plain_deep_encode_matches_jax_goldens_64k(k, level, deep_rows_64k):
    windows, lens, starts = deep_rows_64k
    hc, deep = tb.level_params(level)
    out = _encode(windows[k:k + 1], lens[k:k + 1], starts[k:k + 1], hc=hc,
                  deep=deep)
    assert out[0][0, :out[1][0]].tobytes() == _deep_golden_64k(level)[k]
    _decodes(windows[k:k + 1], lens[k:k + 1], starts[k:k + 1], out, [0])


def test_deep_goldens_64k_hold_long_matches(deep_rows_64k):
    """The goldens reach what only 64 KB windows can: matches over 512
    bytes (the cost ring prices them at 512) and over 1024 bytes (the
    deepest 256-byte tier)."""
    from zig_lz4_tpu_torch.ops.torch_decode import parse_sequences
    longest = max(ml for p in _deep_golden_64k(12)
                  for _l, _s, ml, _o in parse_sequences(p, 65536))
    assert longest > 1024
    mls = [ml for _l, _s, ml, _o in parse_sequences(_deep_golden_64k(12)[3])]
    assert max(mls) > 18 and min(m for m in mls if m) >= 4


def test_plain_deep_encode_matches_jax_live_4k(static_batch, deep_out_4k):
    """One live JAX compile of a deep configuration: level 12 on the
    static inputs, against the plain encoder and the checked-in
    goldens, so a stale fixture cannot hide a difference."""
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax
    _rows, windows, lens, starts = static_batch
    out, out_len = encode_blocks_jax(windows, lens, blk=BLK, starts=starts,
                                     hc=8, deep=3)
    out, out_len = np.asarray(out), np.asarray(out_len)
    got = deep_out_4k("hc8_d3")
    assert np.array_equal(got[1], out_len)
    assert np.array_equal(got[0], out)
    with np.load(DEEP_GOLDENS_4K) as z:
        assert np.array_equal(z["out_len_hc8_d3"], out_len)


def test_tier_lengths_and_stages_compose(static_batch):
    """The stage functions compose to ``encode_blocks_plain``, and the
    tier table is the reference's (jax_block.py:307-321)."""
    assert tb.tier_lengths(0) == []
    assert tb.tier_lengths(1) == [32, 64, 96, 128]
    assert tb.tier_lengths(2) == [32 * k for k in range(1, 9)]
    assert tb.tier_lengths(3) == [32 * k for k in range(1, 8)] + [
        256, 512, 768, 1024]
    rows, windows, lens, starts = static_batch
    sel = rows["case_text"] + rows["fuzz"][:3] + rows["history"]
    w, n, s = (torch.from_numpy(a[sel]) for a in (windows, lens, starts))
    pk = tb.match_candidates(w, n, 8, 1, 3)
    assert int(((pk >> 2) & 15).max()) > 0      # a rank tier was used
    st = tb.deep_dp(n, s, pk, 3)
    out, out_len = tb.deep_emit(w, n, s, pk, st)
    want, want_len = tb.encode_blocks_plain(w, n, s, hc=8, deep=3)
    assert torch.equal(out_len, want_len) and torch.equal(out, want)


def test_encoder_rejects_what_it_does_not_take():
    """Windows over 64 KB encode at every level up to the reference's
    predicate (tests/test_torch_wide.py, tests/test_torch_wide_deep.py);
    wider ones raise.  An empty 131,072-byte window at level 12 encodes
    to the JAX reference's payload (``wide_deep_corpus.npz``)."""
    assert tb.device_encoder_supports(65536)
    assert tb.device_encoder_supports(65537)
    assert tb.device_encoder_supports(327680)
    assert not tb.device_encoder_supports(524288)
    w = torch.zeros((1, 524288), dtype=torch.uint8)
    n = torch.zeros(1, dtype=torch.int32)
    for hc, deep in ((9, 0), (8, 1), (8, 3)):
        with pytest.raises(NotImplementedError,
                           match="device_encoder_supports"):
            tb.encode_blocks(w, n, hc=hc, deep=deep)
    with np.load(os.path.join(_FIXDIR, "wide_deep_corpus.npz")) as z:
        want = int(z["w131k_l12_out_len"][-1])      # the empty window
    out, out_len = tb.encode_blocks(w[:, :2 * 65536], n, hc=8, deep=3)
    assert int(out_len[0]) == want and not out.any()
    with pytest.raises(TypeError):
        tb.encode_blocks(torch.zeros((1, 16), dtype=torch.int32), n)
    with pytest.raises(TypeError):
        tb.encode_blocks(torch.zeros((1, 16), dtype=torch.uint8),
                         n.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["hc9"] + sorted(LEVEL_CONFIGS))
def test_kernels_match_plain_4k(cuda, config):
    hc, accel = {"hc9": (9, 1), **LEVEL_CONFIGS}[config]
    inputs = _static_inputs()
    dense = tie_dense(BLK)
    # the tie-dense windows whole, and cut to n = 0, 1, 3, 4, 5, 11, 12,
    # 13 and 4,095 bytes
    inputs["tie_dense"] = [(r.tobytes(), 0) for r in dense]
    inputs["tie_dense_short"] = [
        (dense[k % len(dense), :m].tobytes(), 0)
        for k, m in enumerate((0, 1, 3, 4, 5, 11, 12, 13, 4095))]
    _rows, windows, lens, starts = _pack(inputs)
    w, n, s = (torch.from_numpy(a).to(cuda) for a in (windows, lens, starts))
    pk = tb.match_candidates(w, n, hc, accel)
    assert torch.equal(pk.cpu(), tb.match_candidates_plain(w.cpu(), n.cpu(),
                                                           hc, accel))
    out, out_len = tb.parse_emit(w, n, s, pk, hc, accel)
    out_p, len_p = tb.parse_emit_plain(w.cpu(), n.cpu(), s.cpu(), pk.cpu(),
                                       hc, accel)
    torch.cuda.synchronize()
    assert torch.equal(out_len.cpu(), len_p)
    assert torch.equal(out.cpu(), out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 4, 9])
def test_kernels_match_goldens_64k(cuda, goldens, level):
    rows, payloads = goldens
    hc, _deep = tb.level_params(level)
    out, out_len = _encode(rows, np.full(len(rows), 65536, np.int32),
                           np.zeros(len(rows), np.int32), device=cuda, hc=hc)
    for k, p in enumerate(payloads[level]):
        assert out[k, :out_len[k]].tobytes() == p


@pytest.mark.cuda
@pytest.mark.parametrize("hc,accel", [(9, 1), (3, 1), (0, 1), (0, 8)])
def test_kernels_odd_window_sizes(cuda, hc, accel):
    """Windows that are not powers of two: the sorts take blk rows (the
    bitonic network pads them to a power of two); each width also runs
    the tie-dense windows, whole and cut short."""
    rng = np.random.default_rng(5)
    text = CASES["text"]
    for blk in (1, 13, 1000, 5000):
        dense = tie_dense(blk, blk)
        windows = np.zeros((3 + 2 * len(dense), blk), np.uint8)
        windows[0] = np.frombuffer((text * 20)[:blk], np.uint8)
        windows[1] = rng.integers(0, 3, blk, dtype=np.uint8)
        windows[3:] = np.concatenate([dense, dense])
        lens = np.array([blk, blk, blk // 2] + [blk] * len(dense)
                        + [max(blk - 12, 0)] * len(dense), np.int32)
        starts = np.zeros(len(windows), np.int32)
        got = _encode(windows, lens, starts, device=cuda, hc=hc,
                      accel=accel)
        want = _encode(windows, lens, starts, hc=hc, accel=accel)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])


def _deep_stages_match_plain(w, n, s, hc, deep):
    """Each deep kernel against its plain version on the kernel's own
    inputs, then the whole against the plain encoder."""
    cw, cn, cs = w.cpu(), n.cpu(), s.cpu()
    pk = tb.match_candidates(w, n, hc, 1, deep)
    assert torch.equal(pk.cpu(), tb.match_candidates_plain(cw, cn, hc, 1,
                                                           deep))
    st = tb.deep_dp(n, s, pk, deep)
    assert torch.equal(st.cpu(), tb.deep_dp_plain(cn, cs, pk.cpu(), deep))
    out, out_len = tb.deep_emit(w, n, s, pk, st)
    out_p, len_p = tb.deep_emit_plain(cw, cn, cs, pk.cpu(), st.cpu())
    torch.cuda.synchronize()
    assert torch.equal(out_len.cpu(), len_p)
    assert torch.equal(out.cpu(), out_p)


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(DEEP_CONFIGS))
def test_deep_kernels_match_plain_4k(cuda, config):
    hc, deep = DEEP_CONFIGS[config]
    _rows, windows, lens, starts = _pack(_static_inputs())
    w, n, s = (torch.from_numpy(a).to(cuda) for a in (windows, lens, starts))
    _deep_stages_match_plain(w, n, s, hc, deep)


@pytest.mark.cuda
@pytest.mark.parametrize("level", DEEP_LEVELS)
def test_deep_kernels_match_goldens_64k(cuda, deep_rows_64k, level):
    windows, lens, starts = deep_rows_64k
    hc, deep = tb.level_params(level)
    out, out_len = _encode(windows, lens, starts, device=cuda, hc=hc,
                           deep=deep)
    for k, p in enumerate(_deep_golden_64k(level)):
        assert out[k, :out_len[k]].tobytes() == p, k
    w, n, s = (torch.from_numpy(a).to(cuda) for a in (windows, lens, starts))
    _deep_stages_match_plain(w, n, s, hc, deep)


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [1, 2, 3])
def test_deep_kernels_odd_window_sizes(cuda, deep):
    rng = np.random.default_rng(6)
    text = CASES["text"]
    for blk in (1, 13, 300, 1000, 5000):
        windows = np.zeros((3, blk), np.uint8)
        windows[0] = np.frombuffer((text * 20)[:blk], np.uint8)
        windows[1] = rng.integers(0, 3, blk, dtype=np.uint8)
        lens = np.array([blk, blk, blk // 2], np.int32)
        starts = np.array([0, blk // 3, 0], np.int32)
        got = _encode(windows, lens, starts, device=cuda, hc=8, deep=deep)
        want = _encode(windows, lens, starts, hc=8, deep=deep)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])
