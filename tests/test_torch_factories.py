"""The single-block factories of the port (``ops.torch_block``:
``hc_probes``, ``make_block_encoder``; ``ops.torch_decode``:
``make_block_decoder``) against the JAX package's
(``jax_block.py:1125-1151``, ``jax_decode.py:1366-1386``).

The encoder's payloads at 1 KB windows, levels 0, 9 and 12, are held
against the JAX factory's in ``tests/fixtures/surface_factories.json``
(``tests/fixtures/make_surface_goldens.py``: a live JAX encoder costs
about a minute of compile a level); the decoder runs live on both sides
(a compile of a second).  The port runs on ``device="cpu"``: the plain
versions of its kernels.  Tolerance: none.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch import errors as E
from zig_lz4_tpu_torch.models import CUDACodec
from zig_lz4_tpu_torch.ops import torch_block as tb
from zig_lz4_tpu_torch.ops import torch_decode as td

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "fixtures"))
import make_surface_goldens as msg  # noqa: E402

BLK = msg.FACTORY_BLK
GOLDEN = msg.load("factories")
WINDOWS = msg.factory_windows()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payloads(level, device="cpu"):
    enc = tb.make_block_encoder(BLK, *tb.level_params(level), device=device)
    return [enc(w, n, start) for w, n, start in WINDOWS]


def test_hc_probes_equal_the_reference():
    from zig_lz4_tpu.ops.jax_block import hc_probes
    for level in range(-3, 16):
        assert tb.hc_probes(level) == hc_probes(level)


@pytest.mark.parametrize("level", msg.FACTORY_LEVELS)
def test_block_encoder_equals_the_jax_factory(level):
    got = _payloads(level)
    want = GOLDEN[f"level {level}"]
    assert len(got) == len(want)
    for (out, n), row in zip(got, want):
        assert out.shape == (row["width"],) and out.dtype == torch.uint8
        assert int(n) == row["len"]
        assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == \
            row["out_sha256"]


def test_block_encoder_takes_arrays_and_tensors_and_is_cached():
    enc = tb.make_block_encoder(BLK, 9, device="cpu")
    assert enc is tb.make_block_encoder(BLK, 9, device="cpu")
    w, n, _s = WINDOWS[0]
    a = enc(w, np.int32(n))
    b = enc(torch.from_numpy(w), torch.tensor(n))
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    with pytest.raises(TypeError, match=f"uint8\\[{BLK}\\]"):
        enc(w[:-1], n)
    with pytest.raises(ValueError):
        tb.make_block_encoder(BLK, 0, deep=1, device="cpu")


@pytest.fixture(scope="module")
def jax_decoder():
    pytest.importorskip("jax")
    from zig_lz4_tpu.ops.jax_decode import make_block_decoder
    return make_block_decoder


@pytest.mark.parametrize("level", msg.FACTORY_LEVELS)
def test_block_decoder_equals_the_jax_factory(level, jax_decoder):
    """Every payload of the encoder, decoded by both factories: blocks
    that emit from 0 with the default history, the last one behind its
    first 300 bytes as history."""
    dec = td.make_block_decoder(BLK, device="cpu")
    dec_h = td.make_block_decoder(BLK, hcap=300, device="cpu")
    ref, ref_h = jax_decoder(BLK), jax_decoder(BLK, hcap=300)
    ccap = td.compress_bound(BLK)
    for (w, n, start), (out, m) in zip(WINDOWS, _payloads(level)):
        comp = out[:int(m)].numpy().tobytes()
        hist = w[:start] if start else None
        seqs = td.parse_sequences(comp, start)
        tabs = td.seqs_to_arrays(seqs, td.MAX_SEQS(BLK))
        buf = np.zeros(ccap, np.uint8)
        buf[:len(comp)] = np.frombuffer(comp, np.uint8)
        got, got_n = (dec_h if start else dec)(comp, *tabs, hist=hist)
        want, want_n = (ref_h if start else ref)(buf, *tabs, hist=hist)
        assert int(got_n) == int(want_n) == n - start
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert got.numpy()[:n - start].tobytes() == w[start:n].tobytes()


def test_block_decoder_rejects_bad_tables():
    dec = td.make_block_decoder(BLK, device="cpu")
    assert dec is td.make_block_decoder(BLK, device="cpu")
    # two literals then a match of 2,000 bytes: past the block
    lit, lsrc, ml, off, ns = td.seqs_to_arrays([(2, 1, 2000, 1)],
                                               td.MAX_SEQS(BLK))
    with pytest.raises(E.CorruptedData, match="capacity"):
        dec(b"\x2f" + b"ab", lit, lsrc, ml, off, ns)
    with pytest.raises(TypeError, match="columns"):
        dec(b"", lit[:-1], lsrc, ml, off, 0)
    with pytest.raises(TypeError, match="hist"):
        dec(b"", lit, lsrc, ml, off, 0, hist=np.zeros(2, np.uint8))


def test_factories_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.make_block_encoder(BLK)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.make_block_decoder(BLK)


@pytest.mark.parametrize("level", [1, 9, 12])
def test_cuda_codec_goes_through_the_factories(level, monkeypatch):
    """``CUDACodec`` calls the factories, as ``TPUCodec`` does
    (zig_lz4_tpu/models/codec.py:75-113)."""
    calls = []
    real_enc, real_dec = tb.make_block_encoder, td.make_block_decoder
    monkeypatch.setattr(tb, "make_block_encoder",
                        lambda *a, **k: calls.append("enc") or
                        real_enc(*a, **k))
    monkeypatch.setattr(td, "make_block_decoder",
                        lambda *a, **k: calls.append("dec") or
                        real_dec(*a, **k))
    w, n, _s = WINDOWS[3]
    codec = CUDACodec(block_capacity=BLK, level=level, device="cpu")
    comp = codec.compress(w[:n].tobytes())
    assert codec.decompress(comp, n) == w[:n].tobytes()
    assert calls == ["enc", "dec"]


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA "
                    "device: the factories launch the kernels only there")
@pytest.mark.parametrize("level", [0, 9, 12])
def test_cuda_factories_equal_the_cpu(level):
    """At 64 KB windows on the card (``enc_match_fast`` /
    ``enc_match`` / ``enc_deep_*``, then ``seq_decode``): the plain
    versions' bytes."""
    rng = np.random.default_rng(level)
    words = np.frombuffer(b"factory kernels on the card ", np.uint8)
    w = rng.choice(words, 65536).astype(np.uint8)
    w[30000:40000] = rng.integers(0, 256, 10000, dtype=np.uint8)
    hc, deep = tb.level_params(level)
    enc = tb.make_block_encoder(65536, hc, deep, device="cuda")
    out, n = enc(w, 65000)
    pout, pn = tb.make_block_encoder(65536, hc, deep, device="cpu")(w, 65000)
    assert int(n) == int(pn) and torch.equal(out.cpu(), pout)
    comp = out[:int(n)].cpu().numpy().tobytes()
    tabs = td.seqs_to_arrays(td.parse_sequences(comp), td.MAX_SEQS(65536))
    got, m = td.make_block_decoder(65536, device="cuda")(comp, *tabs)
    assert int(m) == 65000 and got[:65000].cpu().numpy().tobytes() == \
        w[:65000].tobytes()
