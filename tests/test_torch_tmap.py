"""The port's ``resolve_tmap_py`` (ops/torch_decode.py) against the
reference's (``zig_lz4_tpu/ops/jax_decode.py:968``) and the port's native
T-map resolver, on the cases of tests/test_tmap.py: equal T and out_len,
the dictionary history, corruption raising, and None where a block
decodes past ``out_cap``.  Tolerance: none; T-maps are compared entry for
entry, errors by the name of the exception class (the two packages share
no class).
"""

import numpy as np
import pytest

from zig_lz4_tpu.ops.jax_decode import resolve_tmap_py as ref_resolve
from zig_lz4_tpu_torch import errors as E
from zig_lz4_tpu_torch.native import native_resolve_tmap
from zig_lz4_tpu_torch.ops.block import compress_fast
from zig_lz4_tpu_torch.ops.hc import StreamHC, compress_hc
from zig_lz4_tpu_torch.ops.torch_decode import resolve_tmap_py

BLK = 4096


def _cases():
    rng = np.random.default_rng(21)
    text = (b"the quick brown fox jumps over the lazy dog " * 200)
    return [
        text[:BLK],                                  # matchy text
        b"ab" * (BLK // 2),                          # 2-periodic run
        b"\x00" * BLK,                               # 1-periodic run
        rng.integers(0, 256, BLK, dtype=np.uint8).tobytes(),  # random
        text[:1000] + b"\x07" * 2000 +
        rng.integers(0, 256, 1096, dtype=np.uint8).tobytes(),  # mixed
        b"xyz",                                      # tiny
    ]


def _native(comp, out_cap, hist_len=0):
    T, ol = native_resolve_tmap(comp, np.zeros(1, np.int64),
                                np.array([len(comp)], np.int64), out_cap,
                                hist_len=hist_len, reuse_buffers=False)
    return T[0], int(ol[0])


@pytest.mark.parametrize("level", [0, 9])
def test_tmap_py_equals_reference_and_native(level):
    for data in _cases():
        comp = compress_hc(data, 9) if level else compress_fast(data)
        T, ol = resolve_tmap_py(comp, BLK)
        Tr, olr = ref_resolve(comp, BLK)
        Tn, oln = _native(comp, BLK)
        assert ol == olr == oln == len(data)
        assert np.array_equal(T, Tr)
        assert np.array_equal(T[:ol], Tn[:ol])
        fetch = np.frombuffer(comp, np.uint8)
        assert fetch[T[:ol]].tobytes() == data


def test_tmap_py_dictionary_history():
    data = _cases()[0]
    dict_ = data[:1024]
    s = StreamHC(9)
    s.load_dict(dict_)
    tail = data[1500:3500]
    comp = s.compress_continue(tail)
    T, ol = resolve_tmap_py(comp, BLK, hist_len=len(dict_))
    Tr, olr = ref_resolve(comp, BLK, hist_len=len(dict_))
    Tn, oln = _native(comp, BLK, hist_len=len(dict_))
    assert ol == olr == oln == len(tail)
    assert np.array_equal(T, Tr) and np.array_equal(T[:ol], Tn[:ol])
    fetch = np.frombuffer(dict_ + comp, np.uint8)
    assert fetch[T[:ol]].tobytes() == tail


@pytest.mark.parametrize("comp", [
    bytes([0x10, ord("A"), 0xFF, 0xFF, 0x00]),     # offset past the output
    bytes([0xF0, 0xFF]),                           # literal escape runs out
    bytes([0x20, ord("A")]),                       # literal overrun
    bytes([0x10, ord("A"), 0x01]),                 # truncated offset
    bytes([0x1F, ord("A"), 0x01, 0x00, 0xFF]),     # match escape runs out
], ids=["bad_offset", "literal_escape", "literal_overrun", "offset",
        "match_escape"])
def test_tmap_py_corruption_raises(comp):
    from zig_lz4_tpu import errors as ref_errors
    with pytest.raises(E.CorruptedData):
        resolve_tmap_py(comp, BLK)
    with pytest.raises(ref_errors.CorruptedData):
        ref_resolve(comp, BLK)
    with pytest.raises(E.CorruptedData):
        _native(comp, BLK)


def test_tmap_py_overrun_is_none():
    comp = compress_fast(b"ab" * BLK)              # decodes to 2 * BLK
    assert resolve_tmap_py(comp, BLK) is None
    assert ref_resolve(comp, BLK) is None
    assert _native(comp, BLK)[1] == -1             # marked, not an error
    lit = bytes([0x50]) + b"hello"                # literals past the cap
    assert resolve_tmap_py(lit, 4) is None
    assert ref_resolve(lit, 4) is None
