"""xxHash32 -- from-scratch implementation.

The reference gets xxHash32 from Zig's standard library
(``std.hash.XxHash32``, used at reference: src/lz4f.zig:139,375,424,560
for the frame header checksum, block checksums and content checksum).
We implement the algorithm from its public specification here, with:

  * a one-shot function ``xxh32``             (hot path may use C++ native)
  * a streaming class ``XXH32``               (update / digest / reset)

The streaming class is required because the frame content checksum is
accumulated block-by-block (reference: src/lz4f.zig:384-386).

The C++ native backend (``native``) provides a fast one-shot
implementation; this module transparently uses it for bulk data when
available and falls back to pure Python otherwise.  Both are validated
against each other and against published xxh32 test vectors in
tests/test_xxhash.py.
"""

from __future__ import annotations

import struct

PRIME1 = 2654435761
PRIME2 = 2246822519
PRIME3 = 3266489917
PRIME4 = 668265263
PRIME5 = 374761393

_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * PRIME2) & _M32
    return (_rotl(acc, 13) * PRIME1) & _M32


def _avalanche(h: int) -> int:
    h ^= h >> 15
    h = (h * PRIME2) & _M32
    h ^= h >> 13
    h = (h * PRIME3) & _M32
    h ^= h >> 16
    return h


def _finalize(h: int, tail: bytes) -> int:
    i = 0
    n = len(tail)
    while i + 4 <= n:
        (w,) = struct.unpack_from("<I", tail, i)
        h = (h + w * PRIME3) & _M32
        h = (_rotl(h, 17) * PRIME4) & _M32
        i += 4
    while i < n:
        h = (h + tail[i] * PRIME5) & _M32
        h = (_rotl(h, 11) * PRIME1) & _M32
        i += 1
    return _avalanche(h)


def xxh32_python(data: bytes, seed: int = 0) -> int:
    """Pure-Python one-shot xxHash32 (bit-exact, any input size)."""
    n = len(data)
    if n >= 16:
        a1 = (seed + PRIME1 + PRIME2) & _M32
        a2 = (seed + PRIME2) & _M32
        a3 = seed & _M32
        a4 = (seed - PRIME1) & _M32
        nstripes = n // 16
        lanes = struct.unpack_from("<%dI" % (nstripes * 4), data)
        rotl, m = _rotl, _M32
        for s in range(0, nstripes * 4, 4):
            a1 = (rotl((a1 + lanes[s] * PRIME2) & m, 13) * PRIME1) & m
            a2 = (rotl((a2 + lanes[s + 1] * PRIME2) & m, 13) * PRIME1) & m
            a3 = (rotl((a3 + lanes[s + 2] * PRIME2) & m, 13) * PRIME1) & m
            a4 = (rotl((a4 + lanes[s + 3] * PRIME2) & m, 13) * PRIME1) & m
        h = (_rotl(a1, 1) + _rotl(a2, 7) + _rotl(a3, 12) + _rotl(a4, 18)) & m
        tail = data[nstripes * 16:]
    else:
        h = (seed + PRIME5) & _M32
        tail = data
    h = (h + n) & _M32
    return _finalize(h, tail)


def xxh32(data, seed: int = 0) -> int:
    """One-shot xxHash32.  Uses the C++ native backend for bulk data."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        data = bytes(data)
    data = bytes(data)
    if len(data) >= 256:
        from ..native import native_xxh32
        h = native_xxh32(data, seed)
        if h is not None:       # None: the runtime did not load
            return h
    return xxh32_python(data, seed)


class XXH32:
    """Streaming xxHash32 (update / digest), bit-exact vs one-shot.

    Used by the frame layer to accumulate the content checksum across
    blocks (reference: src/lz4f.zig:384-386) and by the streaming frame
    compression API.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed & _M32
        self.reset()

    def reset(self) -> None:
        s = self.seed
        self._a1 = (s + PRIME1 + PRIME2) & _M32
        self._a2 = (s + PRIME2) & _M32
        self._a3 = s
        self._a4 = (s - PRIME1) & _M32
        self._buf = b""
        self._total = 0

    def update(self, data) -> "XXH32":
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
        data = bytes(data)
        self._total += len(data)
        buf = self._buf + data
        nstripes = len(buf) // 16
        if nstripes:
            lanes = struct.unpack_from("<%dI" % (nstripes * 4), buf)
            a1, a2, a3, a4 = self._a1, self._a2, self._a3, self._a4
            rotl, m = _rotl, _M32
            for s in range(0, nstripes * 4, 4):
                a1 = (rotl((a1 + lanes[s] * PRIME2) & m, 13) * PRIME1) & m
                a2 = (rotl((a2 + lanes[s + 1] * PRIME2) & m, 13) * PRIME1) & m
                a3 = (rotl((a3 + lanes[s + 2] * PRIME2) & m, 13) * PRIME1) & m
                a4 = (rotl((a4 + lanes[s + 3] * PRIME2) & m, 13) * PRIME1) & m
            self._a1, self._a2, self._a3, self._a4 = a1, a2, a3, a4
        self._buf = buf[nstripes * 16:]
        return self

    def digest(self) -> int:
        if self._total >= 16:
            h = (_rotl(self._a1, 1) + _rotl(self._a2, 7)
                 + _rotl(self._a3, 12) + _rotl(self._a4, 18)) & _M32
        else:
            h = (self.seed + PRIME5) & _M32
        h = (h + self._total) & _M32
        return _finalize(h, self._buf)


def xxh32_stream(seed: int = 0):
    """Streaming xxh32 factory: native-backed when available."""
    try:
        from ..native import NativeXXH32, is_available
        if is_available():
            return NativeXXH32(seed)
    except (ImportError, RuntimeError):
        pass
    return XXH32(seed)
