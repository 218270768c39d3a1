"""The plain reference the benchmark judges the port's frames by.

An LZ4 frame and block decoder and an xxHash32, written from the public
LZ4 Frame Format and Block Format specifications and the xxHash
specification, in plain Python.  It imports nothing but the standard
library: not the port, not the JAX package.  Every check is of bytes:
LZ4 is lossless.

Frame:  magic 0x184D2204 (LE) | FLG | BD | [content size u64]
        | [dict id u32] | HC | blocks | end mark 0 | [content xxh32]
  FLG   bits 7-6 version 01, 5 block independence, 4 block checksum,
        3 content size, 2 content checksum, 1 reserved, 0 dict id
  BD    bits 6-4 block max size (4: 64 KB, 5: 256 KB, 6: 1 MB, 7: 4 MB)
  HC    (xxh32(FLG .. dict id) >> 8) & 0xFF
Block:  u32 LE size word (high bit: stored uncompressed) | payload
        | [block xxh32]
Payload: sequences of token (literals << 4 | match length - 4),
        literal length continuation (255* rest), literals, offset u16
        LE, match length continuation; the last sequence is literals
        alone.
xxh32:  four lanes, each a recurrence over every fourth 32-bit word of
        the whole 16-byte stripes, joined with the length and the tail.
"""

from __future__ import annotations

import dataclasses
import sys

__all__ = ["FrameError", "Header", "xxh32", "xxh32_lane", "xxh32_join",
           "lane_words", "parse_header", "read_blocks", "decode_block",
           "decode_records", "decode_frames", "check_frame", "judge"]

MAGIC = 0x184D2204
SKIPPABLE_MASK = 0xFFFFFFF0
SKIPPABLE_START = 0x184D2A50
BLOCK_SIZES = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
STORED = 0x80000000

P1, P2, P3, P4, P5 = (2654435761, 2246822519, 3266489917, 668265263,
                      374761393)
M32 = 0xFFFFFFFF


class FrameError(ValueError):
    """A frame or block that breaks the format."""


# -- xxHash32 ---------------------------------------------------------------

def lane_words(data, lane: int) -> bytes:
    """The little-endian 32-bit words of ``data``'s lane ``lane`` (0-3):
    word ``lane`` of every whole 16-byte stripe."""
    mv = memoryview(data).cast("B")
    n = len(mv) // 16 * 16
    words = mv[:n].cast("I")[lane::4].tobytes()
    if sys.byteorder == "big":
        words = b"".join(words[i:i + 4][::-1]
                         for i in range(0, len(words), 4))
    return words


def xxh32_lane(words: bytes, lane: int, seed: int = 0) -> int:
    """The accumulator of lane ``lane`` after ``words`` (``lane_words``)."""
    acc = ((seed + P1 + P2, seed + P2, seed, seed - P1)[lane]) & M32
    mv = memoryview(words).cast("B").cast("I") if sys.byteorder == \
        "little" else [int.from_bytes(words[i:i + 4], "little")
                       for i in range(0, len(words), 4)]
    for w in mv:
        acc = (acc + w * P2) & M32
        acc = (acc << 13 | acc >> 19) * P1 & M32
    return acc


def xxh32_join(lanes, data, seed: int = 0) -> int:
    """xxh32 of ``data`` from its four lane accumulators (ignored below
    16 bytes): the length, then the tail past the last whole stripe."""
    data = memoryview(data).cast("B")
    n = len(data)
    if n >= 16:
        a1, a2, a3, a4 = lanes
        h = ((a1 << 1 | a1 >> 31) + (a2 << 7 | a2 >> 25)
             + (a3 << 12 | a3 >> 20) + (a4 << 18 | a4 >> 14)) & M32
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    i = n // 16 * 16
    while i + 4 <= n:
        w = int.from_bytes(data[i:i + 4], "little")
        h = (h + w * P3) & M32
        h = (h << 17 | h >> 15) * P4 & M32
        i += 4
    while i < n:
        h = (h + data[i] * P5) & M32
        h = (h << 11 | h >> 21) * P1 & M32
        i += 1
    h ^= h >> 15
    h = (h * P2) & M32
    h ^= h >> 13
    h = (h * P3) & M32
    return h ^ (h >> 16)


def xxh32(data, seed: int = 0) -> int:
    """xxHash32 of ``data`` (bytes-like) with ``seed``."""
    lanes = [xxh32_lane(lane_words(data, k), k, seed) for k in range(4)]
    return xxh32_join(lanes, data, seed)


# -- blocks -----------------------------------------------------------------

def decode_block(src, out: bytearray, floor: int, cap: int) -> None:
    """Append the decoded bytes of one block payload ``src`` to ``out``.
    A match may reach back to ``out[floor]`` (the block's own start for
    an independent block, the history's start otherwise); the block may
    decode to at most ``cap`` bytes."""
    src = bytes(src)
    n = len(src)
    start = len(out)
    i = 0
    if n == 0:
        raise FrameError("empty block payload")
    while True:
        tok = src[i]
        i += 1
        lit = tok >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise FrameError("literal length runs off the block")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise FrameError("literals run off the block")
        out += src[i:i + lit]
        i += lit
        if i == n:
            break
        if i + 2 > n:
            raise FrameError("offset runs off the block")
        off = src[i] | src[i + 1] << 8
        i += 2
        ml = tok & 15
        if ml == 15:
            while True:
                if i >= n:
                    raise FrameError("match length runs off the block")
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        pos = len(out)
        s = pos - off
        if off == 0 or s < floor:
            raise FrameError(f"match offset {off} reaches before the window")
        if off >= ml:
            out += out[s:s + ml]
        else:                        # overlapping: the pattern repeats
            out += (out[s:pos] * (ml // off + 1))[:ml]
        if pos + ml - start > cap:
            raise FrameError("block decodes past its maximum size")
        if i == n:
            raise FrameError("block ends on a match: its last sequence "
                             "holds literals only")


def decode_records(records, independent: bool, cap: int,
                   history: bytes = b"") -> tuple[bytearray, list]:
    """(content, size of each block) of block ``records`` [(payload,
    stored)] decoded behind ``history`` (a dictionary, at most 64 KB).
    A linked block's matches reach into earlier blocks and the history,
    an independent block's into its own bytes and the history alone."""
    hist = bytes(history[-65536:])
    work = bytearray(hist)
    sizes = []
    for payload, stored in records:
        b0 = len(work)
        if stored:
            if len(payload) > cap:
                raise FrameError("stored block over the maximum size")
            work += payload
        elif not independent:
            decode_block(payload, work, 0, cap)
        elif hist:
            tmp = bytearray(hist)
            decode_block(payload, tmp, 0, cap)
            work += memoryview(tmp)[len(hist):]
        else:
            decode_block(payload, work, b0, cap)
        sizes.append(len(work) - b0)
    del work[:len(hist)]
    return work, sizes


# -- frames -----------------------------------------------------------------

@dataclasses.dataclass
class Header:
    """What a frame's header declares."""
    flg: int
    bd: int
    independent: bool
    block_checksum: bool
    content_size: int | None        # None when not declared
    content_checksum: bool
    dict_id: int | None             # None when not declared
    block_max: int


def parse_header(buf: bytes, pos: int = 0) -> tuple[Header, int]:
    """The header of the LZ4 frame at ``pos`` and the position past it;
    the header checksum is verified."""
    if pos + 7 > len(buf):
        raise FrameError("truncated frame header")
    if int.from_bytes(buf[pos:pos + 4], "little") != MAGIC:
        raise FrameError("not an LZ4 frame")
    flg, bd = buf[pos + 4], buf[pos + 5]
    if flg >> 6 != 1:
        raise FrameError("FLG version is not 01")
    if flg & 0x02 or bd & 0x8F:
        raise FrameError("reserved header bit set")
    code = (bd >> 4) & 7
    if code not in BLOCK_SIZES:
        raise FrameError(f"block max size code {code}")
    p = pos + 6
    csize = did = None
    if flg & 0x08:
        csize = int.from_bytes(buf[p:p + 8], "little")
        p += 8
    if flg & 0x01:
        did = int.from_bytes(buf[p:p + 4], "little")
        p += 4
    if p >= len(buf):
        raise FrameError("truncated frame header")
    if buf[p] != (xxh32(buf[pos + 4:p]) >> 8) & 0xFF:
        raise FrameError("header checksum mismatch")
    return Header(flg, bd, bool(flg & 0x20), bool(flg & 0x10), csize,
                  bool(flg & 0x04), did, BLOCK_SIZES[code]), p + 1


def read_blocks(buf: bytes, p: int, block_checksum: bool):
    """([(payload, stored)] of the blocks from ``p`` to the end mark, the
    position past the end mark); block checksums are verified."""
    records = []
    while True:
        if p + 4 > len(buf):
            raise FrameError("truncated block header")
        word = int.from_bytes(buf[p:p + 4], "little")
        p += 4
        if word == 0:
            return records, p
        blen = word & ~STORED
        if p + blen > len(buf):
            raise FrameError("truncated block payload")
        payload = buf[p:p + blen]
        p += blen
        if block_checksum:
            if p + 4 > len(buf):
                raise FrameError("truncated block checksum")
            if int.from_bytes(buf[p:p + 4], "little") != xxh32(payload):
                raise FrameError("block checksum mismatch")
            p += 4
        records.append((payload, bool(word & STORED)))


def read_checksum(buf: bytes, p: int, hdr: Header):
    """(stored content checksum or None, position past it)."""
    if not hdr.content_checksum:
        return None, p
    if p + 4 > len(buf):
        raise FrameError("missing content checksum")
    return int.from_bytes(buf[p:p + 4], "little"), p + 4


def decode_frames(buf, dictionary: bytes = b"") -> tuple[bytes, list]:
    """(content, [(header, block sizes)] of each LZ4 frame) of ``buf``:
    one or more frames back to back, skippable frames skipped; each
    frame's content checksum and content size are verified."""
    buf = bytes(buf)
    out = bytearray()
    frames = []
    pos = 0
    while pos < len(buf):
        if pos + 8 > len(buf):
            raise FrameError("truncated frame")
        magic = int.from_bytes(buf[pos:pos + 4], "little")
        if magic & SKIPPABLE_MASK == SKIPPABLE_START:
            pos += 8 + int.from_bytes(buf[pos + 4:pos + 8], "little")
            if pos > len(buf):
                raise FrameError("truncated skippable frame")
            continue
        hdr, p = parse_header(buf, pos)
        records, p = read_blocks(buf, p, hdr.block_checksum)
        content, sizes = decode_records(records, hdr.independent,
                                        hdr.block_max, dictionary)
        stored, pos = read_checksum(buf, p, hdr)
        if stored is not None and stored != xxh32(content):
            raise FrameError("content checksum mismatch")
        if hdr.content_size is not None and hdr.content_size != len(content):
            raise FrameError(f"content size {hdr.content_size} declared, "
                             f"{len(content)} decoded")
        out += content
        frames.append((hdr, sizes))
    if not frames:
        raise FrameError("no LZ4 frame")
    return bytes(out), frames


# -- the judgement ------------------------------------------------------------

def expected_flags(config: dict) -> tuple[int, int]:
    """(FLG, BD) that a frame written as ``config`` states carries."""
    code = {v: k for k, v in BLOCK_SIZES.items()}[config["block_size"]]
    flg = (0x40 | 0x20 * bool(config["independent_blocks"])
           | 0x10 * bool(config["block_checksum"])
           | 0x08 * bool(config["content_size"])
           | 0x04 * bool(config["content_checksum"]))
    return flg, code << 4


def judge(hdr: Header, sizes, content, checksum, end: int, frame_len: int,
          source, source_xxh32: int, config: dict) -> str:
    """Why a decoded frame is not ``source`` written as ``config``
    states, or "".  ``checksum`` is the content checksum the frame
    stored (None when it stored none), ``source_xxh32`` the reference's
    own xxh32 of ``source``."""
    flg, bd = expected_flags(config)
    if (hdr.flg, hdr.bd) != (flg, bd):
        return (f"FLG/BD {hdr.flg:#04x}/{hdr.bd:#04x}, the configuration "
                f"states {flg:#04x}/{bd:#04x}")
    if end != frame_len:
        return f"{frame_len - end} bytes after the frame"
    if content != source:
        return "content differs from the source"
    if checksum is not None and checksum != source_xxh32:
        return "content checksum is not the xxh32 of the source"
    if hdr.content_size is not None and hdr.content_size != len(source):
        return "content size is not the source's"
    bs = config["block_size"]
    if any(s != bs for s in sizes[:-1]) or (sizes and not 0 < sizes[-1]) \
            or (len(source) and not sizes):
        return "blocks are not the source cut at the block size"
    return ""


def check_frame(frame, source, config: dict,
                source_xxh32: int | None = None) -> str:
    """Why ``frame`` is not one LZ4 frame of ``source`` written as
    ``config`` states (``block_size`` in bytes, ``independent_blocks``,
    ``content_checksum``, ``block_checksum``, ``content_size``), or ""
    when it is."""
    buf = bytes(frame)
    if source_xxh32 is None:
        source_xxh32 = xxh32(source)
    try:
        hdr, p = parse_header(buf)
        records, p = read_blocks(buf, p, hdr.block_checksum)
        content, sizes = decode_records(records, hdr.independent,
                                        hdr.block_max)
        checksum, end = read_checksum(buf, p, hdr)
    except FrameError as exc:
        return str(exc)
    return judge(hdr, sizes, memoryview(content), checksum, end, len(buf),
                 memoryview(source).cast("B"), source_xxh32, config)
