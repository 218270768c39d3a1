"""The port's join of sub-span streams (``ops/block.concat_streams``)
against the reference's walk of every sequence
(``zig_lz4_tpu/ops/block.concat_streams``), byte for byte.

The port passes one part through, never scans the last part's tail, and
finds the other tails natively (``lz4tpu_scan_tail``) where the runtime
loaded, else by ``_scan_tail``.  Each case runs on both routes: as the
process has it (native) and with the runtime taken away, as
``ZIG_LZ4_TPU_NO_NATIVE=1`` leaves it.  The parts come from the native
HC-9 and fast encoders over corpus slices and random bytes, each sub-span
behind the bytes before it as the frame codec cuts them, and from
sequences written by hand: all-literal parts, literal runs of 14, 15,
270 and 525 bytes, parts that end on a match, ``b"\\x00"`` and empty
parts.  A part cut inside a sequence raises on both routes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from zig_lz4_tpu.ops import block as ref_block
from zig_lz4_tpu_torch import native
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.errors import CorruptedData
from zig_lz4_tpu_torch.ops import block as port_block

_CORPUS = make_corpus(1)
_HIST = 1024                     # history behind each sub-span


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.is_available()


def _sub_spans(data: bytes, k: int, hc: bool) -> list[bytes]:
    """``data`` cut into ``k`` sub-spans, each encoded behind the
    ``_HIST`` bytes before it."""
    cuts = np.linspace(0, len(data), k + 1).astype(int)
    parts = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        window = data[max(lo - _HIST, 0):hi]
        start = lo - max(lo - _HIST, 0)
        if hc:
            parts.append(native.native_compress_hc_window(window, start, 9))
        else:
            parts.append(native.native_compress_fast(window[start:]))
    return parts


def _seq(lit: bytes, offset: int | None = None, ml: int = 4) -> bytes:
    """One sequence written by hand; ``offset`` None writes the
    literals-only form."""
    nib = 0 if offset is None else min(ml - 4, 15)
    out = port_block._emit_run_header(len(lit), nib) + lit
    if offset is None:
        return out
    out += offset.to_bytes(2, "little")
    if nib == 15:
        rem = ml - 4 - 15
        out += b"\xff" * (rem // 255) + bytes((rem % 255,))
    return out


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                np.uint8).tobytes()


def _part(head: int, tail: int | None, seed: int, ml: int = 20) -> bytes:
    """A literal run of ``head`` bytes and a match, then a literals-only
    tail of ``tail`` bytes (none: the part ends on the match)."""
    out = _seq(_rand(head, seed), offset=max(head, 1), ml=ml)
    return out if tail is None else out + _seq(_rand(tail, seed + 1))


def _lits(n: int, seed: int) -> bytes:
    """An all-literal part."""
    return _seq(_rand(n, seed))


def _data(source: str, k: int) -> bytes:
    return (_CORPUS[200_000:200_000 + 3000 * k] if source == "corpus"
            else _rand(1500 * k, k))


def _encoded(source: str, k: int, hc: bool) -> list[bytes]:
    return _sub_spans(_data(source, k), k, hc)


CASES = {}
for _src in ("corpus", "random"):
    for _enc, _hc in (("hc9", True), ("fast", False)):
        for _k in (1, 2, 3, 5, 16):
            CASES[f"{_src}-{_enc}-{_k}"] = (
                lambda s=_src, k=_k, hc=_hc: _encoded(s, k, hc))
CASES.update({
    "all-literal-first": lambda: [_lits(300, 1), _part(20, 9, 2),
                                  _part(40, 6, 3)],
    "all-literal-middle": lambda: [_part(20, 9, 4), _lits(20, 5),
                                   _part(3, 6, 6)],
    "all-literal-last": lambda: [_part(20, 9, 7), _part(0, 30, 8),
                                 _lits(7, 9)],
    "all-literal-cascade": lambda: [_lits(10, 10), _lits(5, 11),
                                    _lits(270, 12), _part(1, 5, 13),
                                    _lits(9, 14)],
    "all-literal-every": lambda: [_lits(14, 15), _lits(1, 16),
                                  _lits(525, 17)],
    "all-literal-alone": lambda: [_lits(525, 18)],
    "ends-on-match-first": lambda: [_part(30, None, 19), _part(14, 5, 20)],
    "ends-on-match-middle": lambda: [_part(3, 15, 21), _part(30, None, 22,
                                                             ml=600),
                                     _part(15, 7, 23)],
    "ends-on-match-last": lambda: [_part(3, 15, 24), _part(270, None, 25)],
    "ends-on-match-alone": lambda: [_part(525, None, 26, ml=19)],
    "one-empty-sequence-alone": lambda: [b"\x00"],
    "one-empty-sequence-first": lambda: [b"\x00", _part(5, 5, 27)],
    "one-empty-sequence-middle": lambda: [_part(5, 14, 28), b"\x00",
                                          _part(1, 5, 29)],
    "one-empty-sequence-last": lambda: [_part(5, 14, 30), b"\x00"],
    "one-empty-sequence-after-match": lambda: [_part(5, None, 31),
                                               b"\x00"],
    "empty-parts": lambda: [b"", _part(9, 5, 32), b"", b"",
                            _part(2, 14, 33), b""],
    "empty-parts-around-one": lambda: [b"", _part(9, 5, 34), b""],
    "empty-parts-only": lambda: [b"", b""],
    "no-parts": lambda: [],
})
for _n in (14, 15, 270, 525):                # 0, 0, 1 and 2 255-bytes
    CASES[f"runs-{_n}"] = (lambda n=_n: [_part(n, n, 40), _part(n, n, 42),
                                         _part(n, n, 44), _lits(n, 46)])
    CASES[f"runs-{_n}-pending-over"] = (
        lambda n=_n: [_part(1, n, 50), _part(255 - n % 255, 3, 52),
                      _part(n, 1, 54)])


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_join_equals_the_walk(case, route, monkeypatch):
    parts = CASES[case]()
    want = ref_block.concat_streams(parts)
    if route == "native":
        assert native.is_available()
        for p in parts:                      # the tails, part by part
            if p:
                tok, start, lit = native.native_scan_tail(p)
                body, tail = port_block._scan_tail(p)
                assert (p[:tok], p[start:start + lit]) == (body, tail)
                assert start + lit == len(p)
    else:
        _no_native(monkeypatch)
    got, scans = port_block._concat(parts)
    assert got == want and port_block.concat_streams(parts) == want
    moving = [p for p in parts if p and p != b"\x00"]
    assert scans == max(len(moving) - 1, 0)
    if len(moving) == 1:                     # passed through, not copied
        assert got is moving[0]
    if case.startswith(("corpus", "random")):     # one block again
        source, _enc, k = case.split("-")
        data = _data(source, int(k))
        assert port_block.decompress_safe(got, len(data)) == data


def _cuts(part: bytes) -> list[int]:
    """Lengths that cut ``part`` inside a sequence that is not its
    tail: in a literal-length extension, in the literals, in the
    offset and in a match-length extension."""
    ip, cuts = 0, []
    while True:
        token = part[ip]
        lit, p = token >> 4, ip + 1
        if lit == 15:
            if part[p] == 255:                   # inside the extension
                cuts.append(p + 1)
            while part[p] == 255:
                p += 1
            lit += 255 * (p - ip - 1) + part[p]
            p += 1
        if p + lit >= len(part):
            return cuts
        if lit > 1:
            cuts.append(p + lit // 2)
        p += lit
        cuts.append(p + 1)                       # one byte of the offset
        p += 2
        if token & 15 == 15:
            if part[p] == 255:
                cuts.append(p + 1)
            while part[p] == 255:
                p += 1
            p += 1
        ip = p


@pytest.mark.parametrize("route", ["native", "python"])
def test_a_cut_part_raises(route, monkeypatch):
    whole = (_part(270, None, 60, ml=600) + _part(20, None, 61)
             + _part(3, 30, 62))
    cuts = _cuts(whole)
    assert len(cuts) >= 6
    if route == "python":
        _no_native(monkeypatch)
    for n in cuts:
        with pytest.raises(CorruptedData):
            port_block.concat_streams([whole[:n], _part(4, 5, 63)])
    if route == "native":
        with pytest.raises(CorruptedData):
            native.native_scan_tail(whole[:cuts[0]])


def test_join_without_the_native_runtime_in_a_process():
    """The route ``ZIG_LZ4_TPU_NO_NATIVE=1`` sets for a whole process."""
    parts = CASES["runs-270"]() + CASES["corpus-hc9-3"]()
    want = ref_block.concat_streams(parts)
    code = ("import sys\n"
            "from zig_lz4_tpu_torch import native\n"
            "from zig_lz4_tpu_torch.ops.block import concat_streams\n"
            "parts = eval(sys.stdin.read())\n"
            "assert not native.is_available()\n"
            "sys.stdout.write(concat_streams(parts).hex())\n")
    env = dict(os.environ, ZIG_LZ4_TPU_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], input=repr(parts),
                       capture_output=True, text=True, env=env,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))), timeout=120)
    assert r.returncode == 0, r.stderr
    assert bytes.fromhex(r.stdout) == want
