"""The design of ``frag_decode``'s cluster route, modelled in numpy against
the plain version it must equal (zig_lz4_tpu_torch.ops.torch_frags).

``frag_decode`` (``kernels/csrc/frag_decode.cu``) keeps a block's state,
for blocks up to 8 x 32,768 bytes whose size is a multiple of 64, in the
shared memory of one thread-block cluster, 32,768 positions a CTA: it is
the windowed decoder's cluster kernel with every byte covered and no
pools.  The model runs those partitions at 32,768 positions, as the
kernel, and at 1,024, so that a 4 KB block spans four: the one-hop
sources by the fragment scan on sorted tables (bisection otherwise), a
literal byte copied at once and a PER byte keeping its source, rounds in
which every partition reads the known bits and values of the round's
start, and ``ok`` over the whole block.  Other blocks keep their state in
device scratch; the route depends on ``blk`` alone.

The model must equal the plain version exactly, and the JAX reference
through its checked-in outputs (``tests/fixtures/frags4k.npz``).
Tolerance: none; bytes and ``ok`` are compared exactly.  No JAX compile.
``cuda``-marked tests hold the kernel against its plain version on the
card at 64 KB (a cluster of 2), 128 KB (4), 256 KB (8), past 8 x 32,768
bytes and at a size that is not a multiple of 64 (device scratch), and
skip where there is none: ``python -m pytest --noconftest -m cuda
tests/test_torch_frags_smem.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_decode_smem as tds  # noqa: E402
import test_torch_frags as ttf  # noqa: E402
import test_torch_serial_win_smem as tsw  # noqa: E402
from zig_lz4_tpu_torch.ops import torch_frags as tf  # noqa: E402

BLK = ttf.BLK
CLUSTER_ROWS = tsw.CLUSTER_ROWS
FRAGS_GOLDEN = sorted(k for k, (e, _kw, _r) in ttf.GOLDEN.items()
                      if e == "frags")
FRAGS_LIVE = sorted(k for k, (e, _kw, _r) in ttf.LIVE.items()
                    if e == "frags")
#: shared-memory bytes of a CTA of 32,768 positions: the source words,
#: out, and the masks cur and nxt
CTA_SMEM = 5 * CLUSTER_ROWS + 8 * CLUSTER_ROWS // 32


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


def frags_model(comp, fdst, fsrc, fper, fphase, nfrag, out_len, rounds,
                blk, rows=CLUSTER_ROWS):
    """(out, ok, rounds run) of every block by the cluster kernel's
    partitions of ``rows`` positions."""
    parts = [(p0, min(p0 + rows, blk)) for p0 in range(0, blk, rows)]
    B = comp.shape[0]
    out = np.zeros((B, blk), np.uint8)
    ok = np.zeros(B, np.int32)
    ran = []
    for b in range(B):
        T, per, live = tsw.one_hop(comp[b], fdst[b], fsrc[b], fper[b],
                                   fphase[b], nfrag[b], out_len[b], blk,
                                   rows)
        # one pass: literals copied, PER bytes keep their source, dead
        # bytes known
        lit = live & ~per
        value = np.where(lit, comp[b, np.where(lit, T, 0)], 0)
        value, known, r = tsw.partition_rounds(
            value, ~live | lit, np.where(per, T, -1), parts, rounds)
        out[b] = np.where(known & live, value, 0)
        ok[b] = known.all()
        ran.append(r)
    return out, ok, ran


def _plain(tables, rounds, blk=BLK):
    out, ok = tf.decode_blocks_frags_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in tables),
        rounds, blk)
    return out.numpy(), ok.numpy()


def _args(config):
    _engine, kw, resolve = ttf.CONFIGS[config]
    return ttf.tables(*resolve)[:7], kw["rounds"]


@pytest.mark.parametrize("rows", [CLUSTER_ROWS, 1024])
@pytest.mark.parametrize("config", FRAGS_GOLDEN + FRAGS_LIVE)
def test_frags_model_equals_reference_and_plain(config, rows):
    """The three byte-granular configurations of frags4k.npz (the JAX
    outputs; ``ok`` set exactly where ``rounds`` covers the resolver's
    depth of the block) and the live one against the plain version."""
    tables, rounds = _args(config)
    out, ok, ran = frags_model(*tables, rounds, BLK, rows=rows)
    want_out, want_ok = ttf._port(config)
    assert np.array_equal(out, want_out)
    assert np.array_equal(ok.astype(bool), want_ok)
    assert max(ran) <= rounds
    if config in ttf.GOLDEN:
        ref_out, _ref_ok = ttf._reference(config)   # the reference: no ok
        assert np.array_equal(out, ref_out)
        depth = np.array(ttf.tables(*ttf.CONFIGS[config][2])[7])
        assert np.array_equal(ok.astype(bool), depth <= rounds)


@pytest.mark.parametrize("depth", [1, 4, 7])
def test_frags_model_chain_across_partitions(depth):
    """A chain ``depth`` hops deep whose every hop crosses a partition:
    ``ok`` clear below ``depth`` rounds, set at and above it, in the model
    and the plain version; the rounds stop early once nothing changes."""
    tables, links = tsw.alternating_chain(depth)
    assert len({d // 1024 for d in links}) == 2
    for rounds in (depth - 1, depth, depth + 3):
        want = _plain(tables, rounds)
        for rows in (1024, CLUSTER_ROWS):
            out, ok, ran = frags_model(*tables, rounds, BLK, rows=rows)
            assert np.array_equal(out, want[0])
            assert np.array_equal(ok, want[1])
            assert int(ok[0]) == (rounds >= depth)
            assert ran[0] == min(rounds, depth + 1)
    comp = tables[0][0]
    assert (out[0, links] == comp[links[0]]).all()


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_frags_model_on_malformed_tables(order):
    """Garbage tables with every column live: sources before and past
    the block and the fetch buffer, negative periods and phases; sorted
    (the fragment scan) and unsorted (bisection)."""
    tables = tsw._win_malformed(BLK, order)
    for rounds in (0, 3, 12):
        want = _plain(tables, rounds)
        for rows in (1024, CLUSTER_ROWS):
            out, ok, _r = frags_model(*tables, rounds, BLK, rows=rows)
            assert np.array_equal(out, want[0])
            assert np.array_equal(ok, want[1])


@pytest.mark.parametrize("fill", sorted(tds.FILLS))
def test_frags_model_reads_nothing_past_nfrag(fill):
    tables = ttf.tables(8, 64)[:7]
    for rows in (1024, CLUSTER_ROWS):
        runs = [frags_model(*tds._stale(tables, f), 12, BLK, rows=rows)
                for f in (None, fill)]
        for a, b in zip(runs[0][:2], runs[1][:2]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("blk,ctas", [(4096, 1), (65536, 2), (131072, 4),
                                      (262144, 8), (262208, 0), (65500, 0),
                                      (4000, 0), (1 << 20, 0)])
def test_frags_route_by_blk(monkeypatch, blk, ctas):
    """A cluster of ceil(blk / 32768) CTAs up to 8, with no device
    scratch, when blk % 64 == 0; device scratch past 8 x 32,768 bytes and
    for any other size.  The route depends on blk alone."""
    assert tf.frag_cluster_size(blk) == ctas
    rec = tsw._Launches(monkeypatch, tf)
    meta = [torch.from_numpy(a).to("meta") for a in ttf.tables(8, 12)[:7]]
    out, ok = tf.decode_blocks_frags(*meta, 8, blk)
    assert out.shape == (len(ok), blk)
    (name, args), = rec.calls
    assert name == "frag_decode" and args[-1] == ctas
    assert args[7:9] == ([0, 0] if ctas else ["tensor"] * 2)


# -- the kernel on the card ---------------------------------------------

def _to(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [65536, 131072, 262144, 262208, 65500])
def test_frags_kernel_routes(cuda, blk):
    """Resolved corpus blocks, malformed sorted and unsorted tables, at a
    cluster of 2, 4 and 8 and on device scratch, at rounds 0 (every block
    with a PER byte cleared), 2, 8 and 12."""
    C = tf.frag_cluster_size(blk)
    assert C == {65536: 2, 131072: 4, 262144: 8}.get(blk, 0)
    shape = tf.frag_launch_shape(blk)
    assert shape["ctas"] == C
    if C:
        assert shape["smem_bytes"] == CTA_SMEM
        assert shape["active_clusters"] > 0
    resolved, blocks = tds._big_tables(blk)
    sets = [resolved] + [tsw._win_malformed(blk, o) for o in ("sorted",
                                                              "unsorted")]
    for k, tables in enumerate(sets):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in tables]
        dev = _to(cuda, tables)
        for rounds in (0, 2, 8, 12):
            got = tf.decode_blocks_frags(*dev, rounds, blk)
            want = tf.decode_blocks_frags_plain(*host, rounds, blk)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
            if k == 0 and rounds == 12:
                for i, data in enumerate(blocks):
                    if got[1][i]:
                        assert got[0][i, :len(data)].cpu().numpy() \
                            .tobytes() == data
            if k == 0 and rounds == 0:
                assert not bool(got[1].all())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 8])
def test_frags_kernel_chain_across_ctas(cuda, depth):
    """A 64 KB block whose chain alternates between the cluster's two
    CTAs: ``ok`` is clear after ``depth - 1`` rounds and set after
    ``depth``."""
    tables, _links = tsw.alternating_chain(depth, 65536, CLUSTER_ROWS)
    for rounds in (depth - 1, depth):
        got = tf.decode_blocks_frags(*_to(cuda, tables), rounds, 65536)
        want = tf.decode_blocks_frags_plain(
            *(torch.from_numpy(a) for a in tables), rounds, 65536)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert int(got[1][0]) == (rounds == depth)


@pytest.mark.cuda
@pytest.mark.parametrize("config", FRAGS_GOLDEN + FRAGS_LIVE)
def test_frags_kernel_equals_model(cuda, config):
    tables, rounds = _args(config)
    out, ok = tf.decode_blocks_frags(*_to(cuda, tables), rounds, BLK)
    m_out, m_ok, _r = frags_model(*tables, rounds, BLK)
    assert np.array_equal(out.cpu().numpy(), m_out)
    assert np.array_equal(ok.cpu().numpy(), m_ok)
