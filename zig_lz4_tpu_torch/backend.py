"""Backend dispatch: pure-Python oracle vs C++ native host runtime.

The oracle (ops/block.py) defines behavior; the native runtime is
bit-identical (tests/test_native.py enforces it) and is used
automatically for the host-side hot paths.  Set ZIG_LZ4_TPU_NO_NATIVE=1
to force pure Python.
"""

from __future__ import annotations

from . import errors as E
from .ops import block as _blk
from . import native as _native

__all__ = ["compress_fast", "compress_default", "decompress_generic",
           "decompress_safe", "using_native"]


def using_native() -> bool:
    return _native.is_available()


def compress_fast(src, acceleration: int = 1,
                  max_output: int | None = None) -> bytes:
    src = bytes(src)
    if len(src) > _blk.LZ4_MAX_INPUT_SIZE:   # dynamic read: test hook
        raise E.InputTooLarge(f"input {len(src)} > {_blk.LZ4_MAX_INPUT_SIZE}")
    if _native.is_available():
        out = _native.native_compress_fast(src, acceleration, max_output)
        if out is not None:
            return out
    return _blk.compress_fast(src, acceleration, max_output)


def compress_default(src, max_output: int | None = None) -> bytes:
    return compress_fast(src, 1, max_output)


def decompress_generic(src, out_capacity: int, target: int | None = None,
                       prefix: bytes = b"", ext_dict: bytes = b"") -> bytes:
    if _native.is_available():
        out = _native.native_decompress(src, out_capacity, target,
                                        prefix, ext_dict)
        if out is not None:
            return out
    return _blk._decompress_generic(src, out_capacity, target,
                                    prefix, ext_dict)


def decompress_safe(src, max_output_size: int) -> bytes:
    return decompress_generic(src, max_output_size)


def compress_window(window: bytes, table, base: int, start: int,
                    acceleration: int, max_output: int | None = None,
                    window_floor: int = 0):
    """Streaming window compress; returns (out, updated_table).

    ``table`` is the 4096-entry hash table of global (pos + 1) values:
    either a Python list (oracle) or a ``NativeStreamTable`` that the
    native call updates IN PLACE -- holding the native table across
    calls skips 2x4096 ctypes element conversions per block (the
    dominant cost of the round-2 marshalling design at 4KB blocks).
    """
    if isinstance(table, _native.NativeStreamTable):
        out = _native.native_compress_window(window, start, acceleration,
                                             table, base, window_floor,
                                             max_output)
        if out is not None:
            return out, table
        table = list(table.arr)       # native vanished mid-stream
    elif _native.is_available():
        nt = _native.NativeStreamTable()
        nt.arr[:] = table
        out = _native.native_compress_window(window, start, acceleration,
                                             nt, base, window_floor,
                                             max_output)
        if out is not None:
            return out, list(nt.arr)
    out = bytearray()
    _blk._compress_sequences(window, table, base, start, acceleration,
                             out, max_output, window_floor)
    return bytes(out), table
