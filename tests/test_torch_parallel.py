"""The port's ``('blocks',)`` mesh (zig_lz4_tpu_torch.parallel:
``blocks_mesh``, ``local_device_count`` and ``ShardedFrameCodec(mesh=)``)
against the JAX codec on its 8-device CPU mesh, mirroring
tests/test_parallel.py.

The port's meshes here are ``blocks_mesh(devices=["cpu"] * n)``: every
shard runs the plain versions of the kernels, each staged and gathered
as on n cards.  Frames at n = 1, 2 and 8 equal each other and the JAX
codec's frames of ``tests/fixtures/l9_frames4k.npz``,
``levels_frames4k.npz`` (4 KB blocks) and ``surface_mesh.json`` (2 KB
blocks; a live JAX encode would cost this file encoder compiles).  With
more than one device the fragment ladder opens its deep tier (``fcap`` = the block
size, 12 rounds), as the reference's does (zig_lz4_tpu/parallel/
sharded.py:700,703); the blocks each tier is handed are held against the
reference's own resolver, predicates and tier tables.  Tolerance: none.
"""

import hashlib
import os
import random
import sys

import numpy as np
import pytest
import torch

import zig_lz4_tpu.frame as ref_frame
from zig_lz4_tpu_torch import ShardedFrameCodec
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.parallel import blocks_mesh, local_device_count
from zig_lz4_tpu_torch.parallel.mesh import BlocksMesh

_FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
sys.path.insert(0, _FIXDIR)
import make_surface_goldens as msg  # noqa: E402
import make_torch_goldens as mtg  # noqa: E402

SMALL = 4096
MESH_SIZES = (1, 2, 8)
CORPUS = ("hello", "repeated", "lorem", "random256", "empty", "ramp",
          "tiny", "rle", "mixed")
DEEP_TIER = "rounds=12"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return blocks_mesh(devices=["cpu"] * n)


def _codec(n, block=SMALL, **kw):
    c = ShardedFrameCodec(mesh=_mesh(n), **kw)
    c.block_size = block
    c.window = c.dcap + block
    return c


def _corpus(n):
    """tests/test_parallel.py:12-25."""
    rng = random.Random(123)
    words = (b"sharded frame pipeline over a blocks mesh with ordered "
             b"gather and dictionary broadcast ").split()
    out = bytearray()
    while len(out) < n:
        r = rng.random()
        if r < 0.6:
            out += rng.choice(words) + b" "
        elif r < 0.8:
            out += bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
        else:
            out += bytes([rng.randrange(256)]) * rng.randrange(60)
    return bytes(out[:n])


@pytest.fixture(scope="module")
def jax_frames():
    frames = {}
    for level, path in ((9, mtg.FRAMES_OUT), (0, mtg.LEVEL_FRAMES_OUT)):
        with np.load(path) as z:
            for k in z.files:
                if level == 9:
                    frames[(9, k)] = z[k].tobytes()
                elif k.startswith("l0_"):
                    frames[(0, k[3:])] = z[k].tobytes()
    return frames


def _inputs(corpus, name):
    if name == "multi":
        return make_corpus(mtg.CORPUS_MB)[mtg.MULTI]
    return corpus[name]


def test_mesh_devices():
    m = _mesh(8)
    assert m.size == 8 and m.devices == (torch.device("cpu"),) * 8
    assert blocks_mesh(3, devices=["cpu"] * 8).size == 3
    assert isinstance(m, BlocksMesh)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        blocks_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        blocks_mesh(devices=["meta"])
    if not torch.cuda.is_available():
        assert local_device_count() == 0
        # nothing drops to the CPU on its own
        with pytest.raises(RuntimeError, match="CUDA"):
            blocks_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            blocks_mesh(devices=["cuda:0", "cuda:0"])
    else:
        assert blocks_mesh().size == local_device_count()


@pytest.mark.parametrize("rows", range(10))
@pytest.mark.parametrize("n", range(1, 5))
def test_mesh_split(n, rows):
    """The split every batch route stages by: ``ceil(rows / n)`` rows a
    device, contiguous and in the mesh's order, the pad rows of the
    reference's layout not staged (no empty shard); a batch is a
    multiple of the mesh's size with at least one row a device."""
    devs = tuple(torch.device("cuda", k) for k in range(n))
    mesh = BlocksMesh(devs)
    shards = mesh.shards(rows)
    per = -(-rows // n)
    staged = [i for _d, lo, hi in shards for i in range(lo, hi)]
    assert staged == list(range(rows))      # contiguous, in order, once
    assert [d for d, _lo, _hi in shards] == list(devs[:len(shards)])
    assert all(hi - lo == per for _d, lo, hi in shards[:-1])
    assert all(0 < hi - lo <= per for _d, lo, hi in shards)
    assert mesh.batch(rows) % n == 0 and mesh.batch(rows) >= n
    assert mesh.batch(rows) == (rows - rows % n if rows >= n else n)


def test_one_device_codec_is_a_mesh_of_one():
    c = ShardedFrameCodec(device="cpu")
    assert c.n_devices == 1 and c.mesh.devices == (torch.device("cpu"),)
    m = _codec(8)
    assert m.n_devices == 8 and m.device == torch.device("cpu")


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("level", [9, 0])
@pytest.mark.parametrize("name", CORPUS + ("multi",))
def test_mesh_frames_equal_the_jax_codec(name, level, n, corpus,
                                         jax_frames):
    """tests/test_parallel.py:52-55: the mesh's frame is the JAX codec's
    frame on its 8-device mesh, at every mesh size, and decodes back."""
    data = _inputs(corpus, name)
    c = _codec(n, compression_level=level)
    frame = c.compress_frame(data)
    assert frame == jax_frames[(level, name)]
    assert c.decompress_frame(frame) == data


@pytest.mark.parametrize("level", msg.MESH_LEVELS)
def test_deep_chain_frames_equal_the_jax_codec(level):
    want = msg.load("mesh")[f"level {level}"]
    frames = {n: _codec(n, msg.DEEP_BLK, compression_level=level)
              .compress_frame(msg.deep_chain()) for n in MESH_SIZES}
    assert len(set(frames.values())) == 1
    assert hashlib.sha256(frames[1]).hexdigest() == want["sha256"]


def _reference_membership(frame: bytes, engine: str, n_devices: int):
    """route -> blocks, as the reference's ``_decode_records`` assigns
    the compressed blocks of ``frame`` to its ladder tiers on a mesh of
    ``n_devices`` (zig_lz4_tpu/parallel/sharded.py:676-810), with the
    reference's resolver, predicates and tier tables."""
    from zig_lz4_tpu.constants import compress_bound
    from zig_lz4_tpu.native import native_resolve_blocks
    from zig_lz4_tpu.ops import jax_decode as jd
    from zig_lz4_tpu.parallel import sharded as rs
    info, pos = ref_frame.parse_frame_header(frame)
    bs = info.block_size_id.to_block_size()
    pays = []
    while True:
        word = int.from_bytes(frame[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            break
        blen = word & 0x7FFFFFFF
        if not word & 0x80000000:
            pays.append(frame[pos:pos + blen])
        pos += blen + (4 if info.block_checksum else 0)
    chase, mixed = engine == "chase", engine == "mixed"
    if chase:
        use = rs._CHASE_TIERS
    else:
        use = rs._FRAG_TIERS if n_devices > 1 else rs._FRAG_TIERS[:-1]
    quanta = (bs // 4, bs // 2, compress_bound(bs))

    def supports(f_, c_, rmax):
        if chase or (mixed and rmax > 2):
            return jd.device_chase_decoder_supports(bs, f_, c_)
        return jd.device_frag_decoder_supports(bs, f_, c_)

    tiers = []
    for div, rmax in use:
        q = next((q for q in reversed(quanta)
                  if supports(bs // div, q, rmax)), 0)
        if q:
            tiers.append((bs // div, rmax, q))
    lens = np.array([len(p) for p in pays], np.int64)
    offs = np.zeros_like(lens)
    offs[1:] = np.cumsum(lens)[:-1]
    _fd, _fl, _fs, _fp, _fh, nfrag, rounds, olens = native_resolve_blocks(
        b"".join(pays), offs, lens, max(f for f, _r, _q in tiers),
        out_cap=bs, split_max=rs._FRAG_SPLIT_MAX,
        round_limit=rs._CHASE_RMAX if chase else rs._FRAG_RMAX,
        reuse_buffers=False)
    members, taken = {}, np.zeros(len(pays), bool)
    for fcap, rmax, q in tiers:
        fits = (~taken & (nfrag >= 0) & (nfrag <= fcap) & (rounds <= rmax)
                & (olens <= bs) & (lens <= q))
        taken |= fits
        if not fits.any():
            continue
        fetch_t = next(x for x in quanta if x >= lens[fits].max())
        if chase or (mixed and rmax > 2):
            name = "chase"
        elif jd.device_win_decoder_supports(bs, fcap, fetch_t):
            name = f"win{16 if rmax <= 2 else 8}"
        else:
            name = "frags"
        members[f"{name} fcap={fcap} rounds={rmax}"] = int(fits.sum())
    return members


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("engine", ["win", "mixed"])
def test_deep_tier_opens_on_a_mesh(engine, n):
    """Blocks whose chains run past 8 rounds go to the deep tier (12
    rounds) on a mesh of more than one device, and to T-map on a mesh of
    one, as the reference's single-device branch leaves that tier out."""
    data = msg.deep_chain()
    c = _codec(n, msg.DEEP_BLK, compression_level=9, decode_engine=engine)
    frame = c.compress_frame(data)
    assert c.decompress_frame(frame) == data
    assert c.tier_members == _reference_membership(frame, engine, n)
    deep = {k: v for k, v in c.routes.items() if DEEP_TIER in k}
    if n == 1:
        assert not deep and c.routes.get("tmap", 0) > 0
    else:
        assert sum(deep.values()) > 0
        assert next(iter(deep)).startswith(
            "chase fcap=65536" if engine == "mixed" else "win8 fcap=65536")
    routes = dict(c.routes)
    assert routes.pop("tmap", 0) == routes.pop("leftover", 0)
    assert sum(routes.values()) + c.routes.get("leftover", 0) == \
        -(-len(data) // msg.DEEP_BLK)


def test_mesh_decodes_host_frames_and_the_host_decodes_its_frames():
    """tests/test_parallel.py:58-77, both ways, and an incompressible
    input through the stored-block fallback (:80-85)."""
    c = _codec(8, compression_level=9)
    data = _corpus(30_000)
    assert lz4f.decompress_frame(c.compress_frame(data)) == data
    prefs = lz4f.Preferences(frame_info=lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID.max64KB,
        block_mode=lz4f.BlockMode.independent, content_checksum=True))
    assert c.decompress_frame(lz4f.compress_frame(data, prefs)) == data
    rng = random.Random(99)
    noise = bytes(rng.randrange(256) for _ in range(20_000))
    comp = c.compress_frame(noise)
    assert c.decompress_frame(comp) == noise
    assert len(comp) < len(noise) + 600


@pytest.mark.parametrize("engine", ["tmap", "chase"])
def test_mesh_with_dictionary(engine):
    """tests/test_parallel.py:88-102 and :194-204."""
    rng = random.Random(7)
    dict_ = bytes(rng.randrange(256) for _ in range(1024))
    data = (dict_ * 8)[:6000]
    c = ShardedFrameCodec(mesh=_mesh(8), dictionary=dict_, dict_id=5,
                          decode_engine=engine)
    c.block_size = 1024
    c.window = c.dcap + 1024
    comp = c.compress_frame(data)
    assert c.decompress_frame(comp) == data
    assert len(comp) < len(data) // 4
    assert lz4f.decompress_frame(comp, dictionary=dict_) == data


def test_mesh_linked_and_empty_frames():
    """tests/test_parallel.py:105-116: a linked frame decodes on the
    mesh's first device; an empty input round-trips."""
    c = _codec(8)
    data = _corpus(20_000)
    prefs = lz4f.Preferences(frame_info=lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID.max64KB,
        block_mode=lz4f.BlockMode.linked))
    assert c.decompress_frame(lz4f.compress_frame(data, prefs)) == data
    assert c.routes == {"linked": 1}
    assert c.decompress_frame(c.compress_frame(b"")) == b""


def test_mesh_without_the_native_runtime(monkeypatch):
    """The sequence-rebuild decoder, sharded the same way."""
    from zig_lz4_tpu_torch.parallel import sharded as sh
    monkeypatch.setattr(sh, "native_resolve_tmap", lambda *a, **k: None)
    c = _codec(8, compression_level=9)
    data = _corpus(30_000)
    assert c.decompress_frame(c.compress_frame(data)) == data
    assert c.routes == {"seq": -(-len(data) // SMALL)}


def test_from_reference_takes_a_mesh():
    from zig_lz4_tpu.parallel import ShardedFrameCodec as JaxCodec
    ref = JaxCodec(compression_level=9, decode_engine="win")
    port = ShardedFrameCodec.from_reference(ref, mesh=_mesh(8))
    assert port.n_devices == 8 == ref.n_devices
    assert port.decode_engine == "win" and port.level == 9


def test_unknown_decode_engine_rejected():
    with pytest.raises(ValueError):
        ShardedFrameCodec(mesh=_mesh(2), decode_engine="warp")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the mesh's kernels run only on the card")
@pytest.mark.parametrize("engine", ["win", "mixed"])
def test_cuda_mesh_deep_tier_equals_one_device(engine):
    """Two shards on one card: the frame is the one-device frame, and
    the deep tier's blocks decode on the card as on the CPU."""
    data = msg.deep_chain(1 << 17)
    mesh = blocks_mesh(devices=["cuda:0", "cuda:0"])
    c = ShardedFrameCodec(mesh=mesh, compression_level=9,
                          decode_engine=engine)
    one = ShardedFrameCodec(device="cuda", compression_level=9)
    cpu = _codec(2, msg.DEEP_BLK, compression_level=9, decode_engine=engine)
    for codec in (c, one):
        codec.block_size = codec.window = msg.DEEP_BLK
    frame = c.compress_frame(data)
    assert frame == one.compress_frame(data) == cpu.compress_frame(data)
    assert c.decompress_frame(frame) == data
    assert any(DEEP_TIER in k for k in c.routes)
    assert cpu.decompress_frame(frame) == data
    assert cpu.routes == c.routes and cpu.tier_members == c.tier_members


#: (input bytes, ``batch_blocks``, shards launched by compress and by
#: decompress, round trips of more than one shard in each) over the
#: four-card cell's mesh: 4 blocks, a shard a device; 5 blocks in one
#: group of 3 shards (2, 2, 1; the fourth device gets none); 7 blocks in
#: groups of 4 and 3, the last smaller than the mesh, and decoded as 4
#: shards (2, 2, 2, 1); one block, one shard, nothing to join
MESH4_CASES = {"four_blocks": (4 * 65536, None, 4, 1, 4, 1),
               "five_blocks": (5 * 65536 - 3000, None, 3, 1, 3, 1),
               "last_group_short": (7 * 65536 - 5000, 4, 7, 2, 4, 1),
               "one_block": (40_000, None, 1, 0, 1, 0)}


def _traced_round_trip(codec, data, batch_blocks):
    """(frame, decoded, span counts, counters) of one compress and one
    decompress of ``data`` under the recorder."""
    from zig_lz4_tpu_torch import trace
    trace.reset()
    trace.enable()
    try:
        frame = codec.compress_frame(data, batch_blocks=batch_blocks)
        out = codec.decompress_frame(frame)
        spans = {k: v["count"] for k, v in trace.totals().items()}
        return frame, out, spans, trace.counters()
    finally:
        trace.disable()
        trace.reset()


@pytest.mark.parametrize("case", sorted(MESH4_CASES))
def test_four_card_cell_on_a_cpu_mesh(case):
    """``hc9-64k.mesh4``'s configuration (``lz4hc9-b64k-4gpu``) built as
    the benchmark builds it, over its four chips as ``cpu`` four times:
    the frame is the one-device frame byte for byte, the benchmark's
    reference passes it under the configuration, the mesh decodes it
    back; every round trip of more than one shard joins their rows once
    under ``.gather``, and ``.shards`` counts the shards launched; one
    device joins nothing."""
    from lz4bench import harness, reference
    size, batch_blocks, enc_n, enc_g, dec_n, dec_g = MESH4_CASES[case]
    cell, config, _mix = harness.cell_parts(harness.load_benchmark(),
                                            "hc9-64k.mesh4")
    assert cell["chips"] == 4
    args = harness.codec_settings(config)
    data = _corpus(size)
    mesh = ShardedFrameCodec(mesh=_mesh(cell["chips"]), **args)
    one = ShardedFrameCodec(mesh=_mesh(1), **args)
    frame, out, spans, counts = _traced_round_trip(mesh, data, batch_blocks)
    one_frame, one_out, one_spans, one_counts = _traced_round_trip(
        one, data, batch_blocks)
    assert frame == one_frame
    assert out == one_out == data
    assert reference.check_frame(frame, data, config) == ""
    for kind, shards, gathers in (("enc", enc_n, enc_g),
                                  ("dec", dec_n, dec_g)):
        assert counts.get(f"{kind}.shards", 0) == shards
        assert spans.get(f"{kind}.gather", 0) == gathers
        assert spans.get(f"{kind}.stage", 0) == shards
        assert f"{kind}.gather" not in one_spans
        assert one_counts.get(f"{kind}.shards", 0) == \
            one_spans.get(f"{kind}.collect", 0)
