"""The port's fragment-ladder decoders (zig_lz4_tpu_torch.ops.torch_frags)
against the JAX reference (zig_lz4_tpu.ops.jax_decode): the byte
granular, the windowed and the chase (pointer doubling) engine, the
geometry predicates, the tier configurations and the Python mirror of
the host resolver.

Tolerance: none; ``out`` is compared byte for byte and ``ok`` for
equality, also where the reference clears ``ok`` (a straggler pool of 4,
too few doubling rounds, a frontier pool of 8).  The inputs mirror
tests/test_win_decoder.py, tests/test_chase_decoder.py and
tests/test_resolver.py:131-165 at ``BLK = 4096``: every block goes
through ``resolve_fragments_py`` into a fragment table whose stale rows
(at or past ``nfrag``) are filled with seeded garbage, and the same
numpy arrays go through the jitted, vmapped JAX function and through the
port's plain PyTorch version (``device="cpu"``).  Six static
configurations run live; the others are read from
``tests/fixtures/frags4k.npz``, the JAX functions' outputs written by
``tests/fixtures/make_torch_goldens.py frags4k``.  ``cuda``-marked tests
hold the three kernels against the plain versions and skip where there
is no CUDA device.
"""

import functools
import os

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch.constants import compress_bound
from zig_lz4_tpu_torch.ops import torch_decode as td
from zig_lz4_tpu_torch.ops import torch_frags as tf
from zig_lz4_tpu_torch.ops.block import compress_fast
from zig_lz4_tpu_torch.ops.hc import compress_hc
from zig_lz4_tpu_torch.parallel import sharded as port_sharded

BLK = 4096
FCAP = BLK
CCAP = compress_bound(BLK)
FRAG_GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures",
                            "frags4k.npz")

#: name -> (engine, keyword arguments of the JAX function, resolver's
#: (split_max, round_limit)); run against the live JAX function
LIVE = {
    "win_g8_pool1024": ("win", dict(rounds=12, pool=1024, g=8), (8, 12)),
    "win_g8_pool4": ("win", dict(rounds=12, pool=4, g=8), (8, 12)),
    "win_g16_tier2": ("win", dict(rounds=2, wins=2, pool=256, lit_wins=3,
                                  lit_pool=1024, g=16), (8, 12)),
    "chase_2_4_512": ("chase", dict(dense=2, doublings=4, qcap=512),
                      (8, 64)),
    "chase_0_1_512": ("chase", dict(dense=0, doublings=1, qcap=512),
                      (8, 64)),
    "frags_r10": ("frags", dict(rounds=10), (2, 10)),
}
#: the same, held against the checked-in outputs of the JAX functions
GOLDEN = {
    "win_g8_tier8": ("win", dict(rounds=8, wins=2, pool=512, lit_wins=4,
                                 lit_pool=2048, g=8), (8, 12)),
    "win_g8_bytelit": ("win", dict(rounds=8, wins=2, pool=512, lit_wins=0,
                                   lit_pool=0, g=8), (8, 12)),
    "win_g16_pool4": ("win", dict(rounds=12, pool=4, g=16), (8, 12)),
    "win_g16_tier8": ("win", dict(rounds=8, wins=2, pool=512, lit_wins=4,
                                  lit_pool=2048, g=16), (8, 12)),
    "win_g8_litpool4": ("win", dict(rounds=12, pool=1024, lit_wins=3,
                                    lit_pool=4, g=8), (8, 12)),
    "win_g8_onewin": ("win", dict(rounds=12, wins=1, pool=64, lit_wins=1,
                                  lit_pool=64, g=8), (8, 12)),
    "chase_0_2_8": ("chase", dict(dense=0, doublings=2, qcap=8), (8, 64)),
    "chase_3_0_0": ("chase", dict(dense=3, doublings=0, qcap=0), (8, 64)),
    "chase_4_0_0": ("chase", dict(dense=4, doublings=0, qcap=0), (8, 64)),
    "chase_5_1_4096": ("chase", dict(dense=5, doublings=1, qcap=4096),
                       (8, 64)),
    "chase_2_2_16": ("chase", dict(dense=2, doublings=2, qcap=16), (8, 64)),
    "frags_r0": ("frags", dict(rounds=0), (8, 12)),
    "frags_r2": ("frags", dict(rounds=2), (8, 12)),
    "frags_r12": ("frags", dict(rounds=12), (8, 12)),
}
CONFIGS = {**LIVE, **GOLDEN}


def _chain(piece: bytes, back: int) -> bytes:
    """Each copy references the last one: the chain depth grows."""
    data = bytearray(piece)
    while len(data) < BLK:
        data += data[-back:]
    return bytes(data[:BLK])


@functools.lru_cache(maxsize=None)
def inputs() -> dict:
    """name -> (data, compressed block)."""
    rng = np.random.default_rng(3)
    text = b"the quick brown fox jumps over the lazy dog -- " * 40
    mixed = (text + rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
             + b"\x00" * 500 + text)[:BLK]
    rows = {f"period{p}": (bytes(range(65, 65 + p)) * (BLK // p + 1))[:BLK]
            for p in (1, 2, 3, 4, 5, 7, 8, 9, 13)}
    rows.update(
        mixed=mixed, empty=b"", one=b"x",
        short=b"hello world, hello world, hello!",
        chain37=_chain(np.random.default_rng(7).integers(
            65, 91, 40, dtype=np.uint8).tobytes(), 37),
        chain37_text=_chain(b"0123456789abcdefghijklmnopqrstuvwxyz!@#$", 37),
        chain47=_chain(np.random.default_rng(11).integers(
            65, 91, 50, dtype=np.uint8).tobytes(), 47),
        random=np.random.default_rng(5).integers(
            0, 256, BLK, dtype=np.uint8).tobytes())
    rng = np.random.default_rng(11)
    rows["tiny_runs"] = b"".join(
        bytes([rng.integers(65, 70)]) * int(rng.integers(1, 6))
        for _ in range(1500))[:BLK]
    rng = np.random.default_rng(7)
    rows["match_dense"] = ((text[:997] + rng.integers(
        0, 256, 131, dtype=np.uint8).tobytes()) * 4)[:BLK]
    out = {k: (d, compress_fast(d) if d else b"") for k, d in rows.items()}
    out["mixed_hc"] = (mixed, compress_hc(mixed, 9))
    return out


NAMES = tuple(inputs())


@functools.lru_cache(maxsize=None)
def tables(split_max: int, round_limit: int):
    """(comp uint8[B, CCAP], fdst, fsrc, fper, fphase int32[B, FCAP],
    nfrag, out_len int32[B], rounds of each block) of every input."""
    rows = list(inputs().values())
    B = len(rows)
    rng = np.random.default_rng(99)
    comp = np.zeros((B, CCAP), np.uint8)
    # rows at or past nfrag are stale: the decoders must not read them
    tabs = rng.integers(-5, 70_000, (4, B, FCAP)).astype(np.int32)
    nfrag, out_len = np.zeros(B, np.int32), np.zeros(B, np.int32)
    depth = []
    for i, (data, c) in enumerate(rows):
        frags, max_round, ol = tf.resolve_fragments_py(
            c, FCAP, BLK, 0, split_max, round_limit)
        assert ol == len(data)
        comp[i, :len(c)] = np.frombuffer(c, np.uint8)
        for q, (d, _n, s, p, h, _r) in enumerate(frags):
            tabs[:, i, q] = (d, s, p, h)
        nfrag[i], out_len[i] = len(frags), ol
        depth.append(max_round)
    return (comp, tabs[0], tabs[1], tabs[2], tabs[3], nfrag, out_len,
            tuple(depth))


def jax_outputs(name: str):
    """(out uint8[B, BLK], ok bool[B] or None) of the JAX function of
    configuration ``name``, jitted and vmapped over every input."""
    import jax

    from zig_lz4_tpu.ops import jax_decode as jd
    engine, kw, resolve = CONFIGS[name]
    fn = {"win": jd._decode_block_frags_win,
          "chase": jd._decode_block_frags_chase,
          "frags": jd._decode_block_frags}[engine]
    dec = jax.jit(jax.vmap(functools.partial(fn, blk=BLK, fcap=FCAP, **kw)))
    r = dec(*tables(*resolve)[:7])
    if engine == "frags":
        return np.asarray(r), None
    return np.asarray(r[0]), np.asarray(r[1]).astype(bool)


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    if name in LIVE:
        pytest.importorskip("jax")
        return jax_outputs(name)
    with np.load(FRAG_GOLDENS) as z:
        ok = z[f"ok_{name}"] if f"ok_{name}" in z.files else None
        return z[f"out_{name}"], ok


def port_outputs(name: str, device="cpu"):
    engine, kw, resolve = CONFIGS[name]
    args = [torch.from_numpy(a).to(device) for a in tables(*resolve)[:7]]
    kw = dict(kw)
    if engine == "win":
        out, ok = tf.decode_blocks_frags_win(*args, kw.pop("rounds"), BLK,
                                             **kw)
    elif engine == "chase":
        out, ok = tf.decode_blocks_frags_chase(*args, BLK, **kw)
    else:
        out, ok = tf.decode_blocks_frags(*args, kw["rounds"], BLK)
    return out.cpu().numpy(), ok.cpu().numpy().astype(bool)


_port = functools.lru_cache(maxsize=None)(port_outputs)


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


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plain_equals_reference(config, name):
    i = NAMES.index(name)
    want_out, want_ok = _reference(config)
    out, ok = _port(config)
    assert out[i].tobytes() == want_out[i].tobytes()
    data = inputs()[name][0]
    if want_ok is not None:
        assert ok[i] == want_ok[i]
    elif ok[i]:
        # the reference's byte decoder returns no flag: the port's is
        # set exactly when the block came out whole
        assert out[i, :len(data)].tobytes() == data
    if ok[i]:
        assert out[i, :len(data)].tobytes() == data
        assert not out[i, len(data):].any()


def test_reference_clears_ok_where_the_tests_say():
    """The cases that tell a round that reads the state of its start
    from one that updates in place (tests/test_win_decoder.py:74-85,
    tests/test_chase_decoder.py:80-111)."""
    at = NAMES.index
    assert _port("win_g8_pool1024")[1].all()
    assert not _port("win_g8_pool4")[1][at("tiny_runs")]
    assert not _port("win_g16_pool4")[1][at("tiny_runs")]
    assert not _port("win_g8_litpool4")[1][at("tiny_runs")]
    assert _port("chase_2_4_512")[1].all()
    assert not _port("chase_0_1_512")[1][at("chain37_text")]
    assert not _port("chase_0_2_8")[1][at("chain47")]
    assert _port("chase_5_1_4096")[1].all()
    assert _port("frags_r12")[1].all() and not _port("frags_r0")[1].all()
    # a block of literals alone needs no round
    assert _port("frags_r0")[1][at("random")]


def test_frag_ok_is_whole_block():
    """``decode_blocks_frags`` sets ``ok`` exactly where ``rounds``
    covers the block's depth (the reference returns no flag)."""
    depth = np.array(tables(8, 12)[7])
    for rounds, config in ((0, "frags_r0"), (2, "frags_r2"),
                           (12, "frags_r12")):
        assert (_port(config)[1] == (depth <= rounds)).all()


def test_tables_narrower_than_fcap():
    """Columns at or past the largest ``nfrag`` need not be staged."""
    comp, fd, fs, fp, fh, nf, ol, _d = tables(8, 12)
    ncol = int(nf.max())
    wide = [torch.from_numpy(a) for a in (comp, fd, fs, fp, fh, nf, ol)]
    cut = [torch.from_numpy(np.ascontiguousarray(a[:, :ncol]))
           if a.ndim == 2 and a.dtype == np.int32 else torch.from_numpy(a)
           for a in (comp, fd, fs, fp, fh, nf, ol)]
    for a, b in zip(tf.decode_blocks_frags_win(*wide, 8, BLK, g=16),
                    tf.decode_blocks_frags_win(*cut, 8, BLK, fcap=FCAP,
                                               g=16)):
        assert torch.equal(a, b)
    for a, b in zip(tf.decode_blocks_frags_chase(*wide, BLK, 3, 0, 0),
                    tf.decode_blocks_frags_chase(*cut, BLK, 3, 0, 0)):
        assert torch.equal(a, b)


def test_malformed_tables_stay_in_bounds():
    """Garbage tables (every row live) may give anything, and index
    nothing out of bounds."""
    comp, fd, fs, fp, fh, nf, ol, _d = tables(8, 12)
    rng = np.random.default_rng(1)
    junk = [torch.from_numpy(rng.integers(-70_000, 70_000, fd.shape)
                             .astype(np.int32)) for _ in range(4)]
    args = [torch.from_numpy(comp), *junk,
            torch.full((len(nf),), FCAP, dtype=torch.int32),
            torch.full((len(nf),), BLK, dtype=torch.int32)]
    for out, ok in (tf.decode_blocks_frags(*args, 3, BLK),
                    tf.decode_blocks_frags_win(*args, 3, BLK),
                    tf.decode_blocks_frags_chase(*args, BLK)):
        assert out.shape == (len(nf), BLK) and ok.shape == (len(nf),)


def test_wrappers_reject_bad_arguments():
    args = [torch.from_numpy(a) for a in tables(8, 12)[:7]]
    with pytest.raises(TypeError):
        tf.decode_blocks_frags(args[0].int(), *args[1:], 2, BLK)
    with pytest.raises(TypeError):
        tf.decode_blocks_frags_chase(*args[:5], args[5].long(), args[6], BLK)
    with pytest.raises(ValueError, match="g 8 or 16"):
        tf.decode_blocks_frags_win(*args, 2, BLK, g=4)
    with pytest.raises(ValueError, match="64"):
        tf.decode_blocks_frags_win(*args, 2, 4000)


def test_names_are_where_the_reference_has_them():
    for name in tf.__all__:
        assert getattr(td, name) is getattr(tf, name)


# -- the host side: resolver mirror, predicates, configurations --------

@pytest.mark.parametrize("split_max,round_limit",
                         [(8, 4), (4, 8), (2, 10), (1 << 20, 2), (8, 64)])
@pytest.mark.parametrize("name", NAMES)
def test_resolver_mirror_equals_reference(name, split_max, round_limit):
    from zig_lz4_tpu.ops.jax_decode import resolve_fragments_py
    comp = inputs()[name][1]
    for fcap in (1 << 15, 96):
        assert (tf.resolve_fragments_py(comp, fcap, BLK, 0, split_max,
                                        round_limit)
                == resolve_fragments_py(comp, fcap, BLK, 0, split_max,
                                        round_limit))
    assert (tf.resolve_fragments_py(comp, 1 << 15, 100, 0, split_max,
                                    round_limit)
            == resolve_fragments_py(comp, 1 << 15, 100, 0, split_max,
                                    round_limit))


def test_resolver_mirror_with_history():
    from zig_lz4_tpu.ops.jax_decode import resolve_fragments_py
    from zig_lz4_tpu_torch.stream import Stream
    hist = b"0123456789abcdefghijklmnopqrstuvwxyz" * 3
    st = Stream()
    st.load_dict(hist)
    comp = st.compress_fast_continue(b"abcdefghijklmnop" * 8 + b"NEW!")
    got = tf.resolve_fragments_py(comp, 1 << 20, 1 << 20, len(hist), 8, 6)
    assert got == resolve_fragments_py(comp, 1 << 20, 1 << 20, len(hist),
                                       8, 6)
    assert any(s < len(hist) for _d, _n, s, p, _h, _r in got[0] if p == 0)


@pytest.mark.parametrize("blk", [4096, 65536, 262144, 1 << 20, 4 << 20])
def test_predicates_equal_reference(blk):
    from zig_lz4_tpu.ops import jax_decode as jd
    for div in (1, 2, 4, 8, 32, 64, 256):
        for fetch in (None, blk // 4, blk // 2, compress_bound(blk),
                      65536 + blk // 4, 65536 + compress_bound(blk)):
            fcap = blk // div
            assert tf._frag_geometry(blk, fcap, fetch or compress_bound(
                blk)) == jd._frag_geometry(blk, fcap, fetch
                                           or compress_bound(blk))
            for name in ("device_frag_decoder_supports",
                         "device_win_decoder_supports",
                         "device_chase_decoder_supports"):
                assert getattr(tf, name)(blk, fcap, fetch) == \
                    getattr(jd, name)(blk, fcap, fetch), (name, div, fetch)
    for name in ("device_frag_decoder_supports",
                 "device_win_decoder_supports",
                 "device_chase_decoder_supports"):
        assert getattr(tf, name)(blk) == getattr(jd, name)(blk)


def test_predicates_by_value():
    """tests/test_win_decoder.py:88, tests/test_chase_decoder.py:128."""
    assert tf.device_win_decoder_supports(65536)
    assert not tf.device_win_decoder_supports(262144)
    assert tf.device_chase_decoder_supports(65536)
    assert tf.device_chase_decoder_supports(262144, fcap=32768)
    assert not tf.device_chase_decoder_supports(262144)
    assert tf.device_chase_decoder_supports(1 << 20, (1 << 20) // 32)


def test_tier_configurations_by_value():
    from zig_lz4_tpu.ops.jax_decode import win_tier_config
    from zig_lz4_tpu.parallel import sharded as ref_sharded
    assert tf.win_tier_config(65536, 8192, 2) == dict(
        wins=2, pool=256, lit_wins=3, lit_pool=1024)
    assert tf.win_tier_config(65536, 16384, 8) == dict(
        wins=2, pool=512, lit_wins=4, lit_pool=2048)
    assert tf.win_tier_config(65536, 65536, 12) == dict(
        wins=2, pool=512, lit_wins=0, lit_pool=0)
    for blk, fcap, rounds in ((65536, 8192, 2), (65536, 16384, 8),
                              (65536, 65536, 12), (4096, 512, 1),
                              (4096, 4096, 3)):
        assert tf.win_tier_config(blk, fcap, rounds) == \
            win_tier_config(blk, fcap, rounds)
    assert port_sharded._chase_config(8) == (3, 0, 0)
    assert port_sharded._chase_config(16) == (4, 0, 0)
    assert port_sharded._chase_config(64) == (5, 1, 4096)
    for depth in (1, 2, 3, 8, 12, 16, 17, 32, 33, 64, 200):
        assert port_sharded._chase_config(depth) == \
            ref_sharded._chase_config(depth)
    for name in ("_FRAG_TIERS", "_FRAG_TIERS_BIG", "_FRAG_SPLIT_MAX",
                 "_FRAG_RMAX", "_CHASE_TIERS", "_CHASE_RMAX"):
        assert getattr(port_sharded, name) == getattr(ref_sharded, name)


def test_goldens_cover_every_configuration():
    with np.load(FRAG_GOLDENS) as z:
        for name, (engine, _kw, _res) in GOLDEN.items():
            assert z[f"out_{name}"].shape == (len(NAMES), BLK)
            assert (f"ok_{name}" in z.files) == (engine != "frags")
        assert z["names"].tolist() == list(NAMES)
    assert len(LIVE) <= 6


# -- the kernels against their plain versions, on the card -------------

@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_kernel_matches_plain(cuda, config):
    out, ok = port_outputs(config, device=cuda)
    want_out, want_ok = _port(config)
    assert np.array_equal(out, want_out) and np.array_equal(ok, want_ok)


@pytest.mark.cuda
def test_kernels_on_malformed_tables(cuda):
    comp, fd, _fs, _fp, _fh, nf, _ol, _d = tables(8, 12)
    rng = np.random.default_rng(1)
    junk = [torch.from_numpy(rng.integers(-70_000, 70_000, fd.shape)
                             .astype(np.int32)).to(cuda) for _ in range(4)]
    args = [torch.from_numpy(comp).to(cuda), *junk,
            torch.full((len(nf),), FCAP, dtype=torch.int32, device=cuda),
            torch.full((len(nf),), BLK, dtype=torch.int32, device=cuda)]
    for out, ok in (tf.decode_blocks_frags(*args, 3, BLK),
                    tf.decode_blocks_frags_win(*args, 3, BLK),
                    tf.decode_blocks_frags_chase(*args, BLK)):
        torch.cuda.synchronize()
        assert out.shape == (len(nf), BLK) and ok.shape == (len(nf),)
