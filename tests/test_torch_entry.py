"""The port's entry points (zig_lz4_tpu_torch.entry) against the
repository's ``__graft_entry__.py``: ``entry()``'s step equals the JAX
step's (``tests/fixtures/surface_entry.json``, from
``tests/fixtures/make_surface_goldens.py``: one JAX compile at 64 KB),
and ``dryrun_multichip`` passes over meshes of CPU devices, where its
shards run the plain versions of the kernels.  Tolerance: none.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from zig_lz4_tpu_torch import entry as pe
from zig_lz4_tpu_torch.ops.torch_block import encode_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "fixtures"))
import make_surface_goldens as msg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_equals_the_jax_entry():
    want = msg.load("entry")
    fn, args = pe.entry(device="cpu")
    assert [a.device.type for a in args] == ["cpu"] * 3
    out, olen = fn(*args)
    assert list(out.shape) == want["shape"]
    assert olen.tolist() == want["out_len"]
    assert [hashlib.sha256(r.numpy().tobytes()).hexdigest()
            for r in out] == want["out_sha256"]


@pytest.mark.parametrize("n_blocks,blk,dict_len", [(4, 65536, 0),
                                                   (4, 1280, 256)])
def test_example_batch_is_the_reference_s(n_blocks, blk, dict_len):
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g     # its batch maker imports no JAX
    for a, b in zip(pe._example_batch(n_blocks, blk, dict_len),
                    g._example_batch(n_blocks, blk, dict_len)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pe.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        pe.dryrun_multichip(2)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip(n):
    pe.dryrun_multichip(n, devices=["cpu"] * 8)


def test_dryrun_asks_for_the_devices_it_has():
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        pe.dryrun_multichip(3, devices=["cpu"] * 2)


def test_dryrun_detects_a_wrong_decode(monkeypatch):
    """The dryrun's decode check is live: a decoder that drops a byte
    fails it."""
    real = pe.decode_blocks_frags

    def broken(*a):
        out, ok = real(*a)
        out = out.clone()
        out[:, 7] ^= 1
        return out, ok
    monkeypatch.setattr(pe, "decode_blocks_frags", broken)
    with pytest.raises(AssertionError, match="sharded decode mismatch"):
        pe.dryrun_multichip(2, devices=["cpu"] * 2)


def test_entry_step_decodes():
    from zig_lz4_tpu_torch.ops.block import decompress_safe
    fn, (w, ln, st) = pe.entry(device="cpu")
    out, olen = encode_blocks(w, ln, st, hc=0)
    for k in range(w.shape[0]):
        raw = w[k, :int(ln[k])].numpy().tobytes()
        comp = out[k, :int(olen[k])].numpy().tobytes()
        assert decompress_safe(comp, len(raw)) == raw
