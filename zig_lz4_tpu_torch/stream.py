"""Streaming block compression/decompression with a 64KB sliding window.

Reference analogs:
  * ``Stream``        -- reference: src/lz4.zig:751-865 (fast stream)
  * ``StreamDecode``  -- reference: src/lz4.zig:870-957
  * ``StreamHC``      -- reference: src/lz4hc.zig:1557-1735 (in ops/hc.py,
    re-exported here)

Important divergence (improvement): the reference's fast streaming path
never actually emits cross-block matches -- its hash-table positions are
misinterpreted as current-block indices, so matches are revalidated
against the wrong bytes and the "dictionary" is never referenced
(SURVEY.md section 2.1).  This implementation threads a true global
coordinate space through the hash table, so compressed streams contain
real back-references into the previous 64KB of history / the loaded
dictionary, like upstream C LZ4.  Output remains wire-valid in both
designs; ours compresses strictly better.

State is a (history bytes <= 64KB, global offset, hash table) triple --
trivially checkpointable (SURVEY.md section 5 "checkpoint/resume").
"""

from __future__ import annotations

from .constants import (
    HASH_SIZE_U32,
    HASHLOG,
    LZ4_MAX_INPUT_SIZE,
    MFLIMIT,
    WINDOW_SIZE,
    decoder_ring_buffer_size,
)
from .errors import InputTooLarge
from .ops.block import (
    _compress_sequences,
    _decompress_generic,
    _emit_literals_only,
)

__all__ = ["Stream", "StreamDecode", "StreamHC", "decoder_ring_buffer_size"]


class Stream:
    """Stateful fast compressor with a true 64KB sliding window.

    reference: src/lz4.zig:751-865 (createStream/loadDict/
    compressFastContinue/saveDict).
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        """reference: src/lz4.zig initStream semantics."""
        # hold the hash table in native form when the C++ runtime is
        # up: the round-2 design marshalled 2x4096 entries through
        # ctypes per block, which dominated 4KB-block streaming
        from . import native as _native
        if _native.is_available():
            self.table = _native.NativeStreamTable()
        else:
            self.table = [0] * HASH_SIZE_U32
        self.history = b""         # last <= 64KB of the stream
        self.global_offset = 0     # stream position of end of history

    def _table_list(self) -> list:
        from . import native as _native
        if isinstance(self.table, _native.NativeStreamTable):
            return list(self.table.arr)
        return list(self.table)

    def _table_store(self, vals) -> None:
        from . import native as _native
        if isinstance(self.table, _native.NativeStreamTable):
            self.table.arr[:] = vals
        else:
            self.table = list(vals)

    # -- dictionary management -------------------------------------------

    def load_dict(self, dictionary) -> int:
        """Prime the stream with an external dictionary.

        Keeps the last 64KB and pre-hashes every position so the first
        compressed block can reference it (reference: src/lz4.zig:798-819
        keeps last 64KB and pre-hashes).  Returns loaded byte count.
        """
        d = bytes(dictionary)[-WINDOW_SIZE:]
        self.reset()
        self.history = d
        self.global_offset = len(d)
        if len(d) >= 4:
            # vectorized prehash; last occurrence wins == max of the
            # ascending (i + 1) values per hash bucket
            import numpy as np
            b = np.frombuffer(d, np.uint8).astype(np.uint32)
            u32 = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16)
                   | (b[3:] << 24))
            h = ((u32 * np.uint32(2654435761)) >> np.uint32(32 - HASHLOG)) \
                .astype(np.int64)
            vals = np.zeros(HASH_SIZE_U32, np.int64)
            np.maximum.at(vals, h, np.arange(1, len(h) + 1,
                                             dtype=np.int64))
            filled = self._table_list()
            nz = vals != 0
            arr = np.array(filled, np.int64)
            arr[nz] = vals[nz]
            self._table_store(arr.tolist())
        return len(d)

    def save_dict(self, max_size: int = WINDOW_SIZE) -> bytes:
        """Snapshot the last <= 64KB of history for checkpoint/resume.

        reference: src/lz4.zig:839-854.  The returned bytes can be fed
        to ``load_dict`` on a fresh stream to resume compression with
        identical window contents.
        """
        return self.history[-min(max_size, WINDOW_SIZE):]

    # -- compression ------------------------------------------------------

    def compress_fast_continue(self, src, acceleration: int = 1,
                               max_output: int | None = None) -> bytes:
        """Compress the next block, matching against the prior 64KB.

        reference: src/lz4.zig:822-836 -- but with real cross-block
        matching (see module docstring).
        """
        src = bytes(src)
        n = len(src)
        if n > LZ4_MAX_INPUT_SIZE:
            raise InputTooLarge(f"input {n} > {LZ4_MAX_INPUT_SIZE}")
        out = bytearray()
        if n == 0:
            return b""

        history = self.history
        window = history + src
        start = len(history)
        base = self.global_offset - start   # global pos of window[0]

        if n < MFLIMIT + 1:
            _emit_literals_only(src, out, 0, n)
        else:
            from .backend import compress_window
            res, self.table = compress_window(window, self.table, base,
                                              start, acceleration,
                                              max_output)
            out += res

        # slide the window
        self.history = window[-WINDOW_SIZE:]
        self.global_offset += n
        return bytes(out)

    # checkpoint/resume as plain data (SURVEY.md section 5)
    def state_dict(self) -> dict:
        return {
            "table": self._table_list(),
            "history": self.history,
            "global_offset": self.global_offset,
        }

    def load_state_dict(self, state: dict) -> None:
        self._table_store(state["table"])
        self.history = bytes(state["history"])
        self.global_offset = int(state["global_offset"])


class StreamDecode:
    """Stateful streaming decoder tracking 64KB of decoded history.

    reference: src/lz4.zig:870-957.  Divergence (improvement): the
    reference clears the external dictionary after the first block
    (src/lz4.zig:936-937); we retain it, matching upstream C semantics,
    so later blocks may still reference dictionary content that remains
    within the 64KB offset reach.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.prefix = b""       # last <= 64KB of decoded output
        self.ext_dict = b""

    def set_dict(self, dictionary) -> None:
        """reference: src/lz4.zig setStreamDecode-with-dict flow."""
        self.ext_dict = bytes(dictionary)[-WINDOW_SIZE:]

    def decompress_continue(self, src, max_output_size: int) -> bytes:
        """Decode the next block against accumulated history."""
        from .backend import decompress_generic
        out = decompress_generic(bytes(src), max_output_size, None,
                                 self.prefix, self.ext_dict)
        self.prefix = (self.prefix + out)[-WINDOW_SIZE:]
        return out

    def decompress_continue_partial(self, src, target: int,
                                    max_output_size: int) -> bytes:
        from .backend import decompress_generic
        out = decompress_generic(bytes(src), max_output_size, target,
                                 self.prefix, self.ext_dict)
        self.prefix = (self.prefix + out)[-WINDOW_SIZE:]
        return out


def __getattr__(name):
    if name == "StreamHC":
        from .ops.hc import StreamHC
        return StreamHC
    raise AttributeError(name)
