"""LZ4 Frame format (lz4f) -- container layer.

Implements the LZ4 frame specification: magic + FLG/BD descriptor with
xxHash32 header checksum, block framing with optional block checksums,
optional content size and content checksum, endmark, skippable frames.

Reference analogs (and fixed gaps):
  * one-shot ``compress_frame`` / ``decompress_frame``
      reference: src/lz4f.zig:354-446, 541-638
  * ``compress_frame_bound``      reference: src/lz4f.zig:274-301
  * header codec (FLG/BD/HC)      reference: src/lz4f.zig:136-249,304-351
  * ``header_size`` peek          reference: src/lz4f.zig:451-480

Gaps in the reference that are implemented for real here
(SURVEY.md section 2.3):
  1. A streaming frame API (``FrameCompressor`` / ``FrameDecompressor``)
     -- the reference README advertises compressBegin/Update/End but the
     code only has one-shot paths.
  2. True linked-block mode: in linked mode each block is compressed
     against the previous 64KB of history (reference compresses every
     block independently even when FLG says linked) and the decoder
     carries history across blocks, so genuine linked frames produced
     by the upstream ``lz4`` CLI decode correctly.
  3. Skippable frames are skipped on decode (reference rejects them)
     and can be written via ``write_skippable_frame``.
  4. ``content_size`` is verified against the actual decoded size.
  5. Frame-level dictionaries (dictID) are honored on both sides.
"""

from __future__ import annotations

import dataclasses
import enum

from .constants import WINDOW_SIZE, compress_bound
from . import errors as E
from . import backend
from .ops import block as blk
from .stream import Stream, StreamDecode
from .utils.xxhash32 import XXH32, xxh32, xxh32_stream

__all__ = [
    "MAGIC", "MAGIC_SKIPPABLE_START", "MAGIC_SKIPPABLE_MASK",
    "BlockSizeID", "BlockMode", "FrameInfo", "Preferences",
    "CompressOptions", "DecompressOptions",
    "compress_frame", "decompress_frame", "compress_frame_bound",
    "get_frame_info", "header_size", "write_skippable_frame",
    "FrameCompressor", "FrameDecompressor",
]

# --- constants (reference: src/lz4f.zig:11-27) ---

MAGIC = 0x184D2204
MAGIC_SKIPPABLE_START = 0x184D2A50
MAGIC_SKIPPABLE_MASK = 0xFFFFFFF0

HEADER_SIZE_MIN = 7
HEADER_SIZE_MAX = 19
MIN_SIZE_TO_KNOW_HEADER_LENGTH = 5

BLOCK_HEADER_SIZE = 4
BLOCK_CHECKSUM_SIZE = 4
CONTENT_CHECKSUM_SIZE = 4
ENDMARK_SIZE = 4

_UNCOMPRESSED_BIT = 0x80000000


class BlockSizeID(enum.IntEnum):
    """reference: src/lz4f.zig:64-78."""
    default = 0
    max64KB = 4
    max256KB = 5
    max1MB = 6
    max4MB = 7

    def to_block_size(self) -> int:
        return {
            BlockSizeID.default: 64 * 1024,
            BlockSizeID.max64KB: 64 * 1024,
            BlockSizeID.max256KB: 256 * 1024,
            BlockSizeID.max1MB: 1024 * 1024,
            BlockSizeID.max4MB: 4 * 1024 * 1024,
        }[self]


class BlockMode(enum.IntEnum):
    """reference: src/lz4f.zig:81-84."""
    linked = 0
    independent = 1


class FrameType(enum.IntEnum):
    frame = 0
    skippable_frame = 1


@dataclasses.dataclass(frozen=True)
class FrameInfo:
    """reference: src/lz4f.zig:106-114."""
    block_size_id: BlockSizeID = BlockSizeID.default
    block_mode: BlockMode = BlockMode.linked
    content_checksum: bool = False
    frame_type: FrameType = FrameType.frame
    content_size: int = 0      # 0 = unknown
    dict_id: int = 0           # 0 = none
    block_checksum: bool = False


@dataclasses.dataclass(frozen=True)
class Preferences:
    """reference: src/lz4f.zig:117-122.

    ``compression_level``: <=0 selects the fast codec with acceleration
    ``1 - level``; >=1 selects the HC codec clamped to levels 2..12
    (the reference routes any level > 0 to HC, src/lz4f.zig:393-404).

    ``auto_flush``: honored by the streaming FrameCompressor -- every
    update() emits its data immediately instead of buffering to full
    blocks (the reference declares but ignores it, lz4f.zig:119).

    ``favor_dec_speed``: accepted for API parity and ignored, exactly
    like the reference (declared lz4f.zig:120, stored lz4hc.zig:402,
    never read); the upstream C behavior it selects (avoiding offsets
    < 8 in the HC optimal parser) is a micro-optimization for one
    decoder implementation, not a wire-format feature.
    """
    frame_info: FrameInfo = dataclasses.field(default_factory=FrameInfo)
    compression_level: int = 0
    auto_flush: bool = False
    favor_dec_speed: bool = False


@dataclasses.dataclass(frozen=True)
class CompressOptions:
    stable_src: bool = False


@dataclasses.dataclass(frozen=True)
class DecompressOptions:
    stable_dst: bool = False
    skip_checksums: bool = False


# --- header codec (reference: src/lz4f.zig:136-249) ---

def _header_checksum_byte(descriptor: bytes) -> int:
    """Second byte of xxh32 of the descriptor (reference: lz4f.zig:138-141)."""
    return (xxh32(descriptor) >> 8) & 0xFF


def _encode_flg(info: FrameInfo) -> int:
    flg = 0x40  # version 01 in bits 7-6
    if info.block_mode == BlockMode.independent:
        flg |= 0x20
    if info.block_checksum:
        flg |= 0x10
    if info.content_size != 0:
        flg |= 0x08
    if info.content_checksum:
        flg |= 0x04
    if info.dict_id != 0:
        flg |= 0x01
    return flg


def _decode_flg(flg: int) -> tuple:
    """Returns (block_mode, block_checksum, has_content_size,
    content_checksum, has_dict_id)."""
    if (flg >> 6) & 0x3 != 1:
        raise E.HeaderVersionWrong(f"FLG version bits {(flg >> 6) & 3}")
    if flg & 0x02:
        raise E.ReservedFlagSet("FLG reserved bit 1 set")
    return (
        BlockMode.independent if flg & 0x20 else BlockMode.linked,
        bool(flg & 0x10),
        bool(flg & 0x08),
        bool(flg & 0x04),
        bool(flg & 0x01),
    )


def _encode_bd(bsid: BlockSizeID) -> int:
    value = 4 if bsid in (BlockSizeID.default, BlockSizeID.max64KB) else int(bsid)
    return value << 4


def _decode_bd(bd: int) -> BlockSizeID:
    if bd & 0x8F:
        raise E.ReservedFlagSet(f"BD reserved bits set: {bd:#x}")
    v = (bd >> 4) & 0x7
    if v in (0, 4):
        return BlockSizeID.max64KB
    if v == 5:
        return BlockSizeID.max256KB
    if v == 6:
        return BlockSizeID.max1MB
    if v == 7:
        return BlockSizeID.max4MB
    raise E.MaxBlockSizeInvalid(f"block size id {v}")


def write_frame_header(info: FrameInfo) -> bytes:
    """Serialize magic + descriptor + header checksum.

    reference: src/lz4f.zig:304-351.
    """
    desc = bytearray()
    desc.append(_encode_flg(info))
    desc.append(_encode_bd(info.block_size_id))
    if info.content_size != 0:
        desc += int(info.content_size).to_bytes(8, "little")
    if info.dict_id != 0:
        desc += int(info.dict_id).to_bytes(4, "little")
    out = MAGIC.to_bytes(4, "little") + bytes(desc)
    return out + bytes([_header_checksum_byte(bytes(desc))])


def header_size(buf) -> int:
    """Peek the total header length from the first >= 5 bytes.

    reference: src/lz4f.zig:451-480 (returns 8 for skippable frames).
    """
    buf = bytes(buf)
    if len(buf) < MIN_SIZE_TO_KNOW_HEADER_LENGTH:
        raise E.FrameHeaderIncomplete(f"need 5 bytes, have {len(buf)}")
    magic = int.from_bytes(buf[:4], "little")
    if magic & MAGIC_SKIPPABLE_MASK == MAGIC_SKIPPABLE_START:
        return 8
    if magic != MAGIC:
        raise E.FrameTypeUnknown(f"magic {magic:#x}")
    flg = buf[4]
    size = HEADER_SIZE_MIN
    if flg & 0x08:
        size += 8
    if flg & 0x01:
        size += 4
    return size


def parse_frame_header(buf) -> tuple[FrameInfo, int]:
    """Parse and validate a frame header; returns (FrameInfo, length).

    reference: src/lz4f.zig:483-538 (validates the header checksum).
    """
    buf = bytes(buf)
    total = header_size(buf)
    if len(buf) < total:
        raise E.FrameHeaderIncomplete(f"need {total} bytes, have {len(buf)}")
    magic = int.from_bytes(buf[:4], "little")
    if magic & MAGIC_SKIPPABLE_MASK == MAGIC_SKIPPABLE_START:
        size = int.from_bytes(buf[4:8], "little")
        return (FrameInfo(frame_type=FrameType.skippable_frame,
                          content_size=size), 8)
    flg = buf[4]
    bd = buf[5]
    block_mode, block_cs, has_csize, content_cs, has_dict = _decode_flg(flg)
    bsid = _decode_bd(bd)
    pos = 6
    content_size = 0
    if has_csize:
        content_size = int.from_bytes(buf[pos:pos + 8], "little")
        pos += 8
    dict_id = 0
    if has_dict:
        dict_id = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
    hc = buf[pos]
    expect = _header_checksum_byte(buf[4:pos])
    if hc != expect:
        raise E.HeaderChecksumInvalid(f"HC {hc:#x} != {expect:#x}")
    pos += 1
    info = FrameInfo(block_size_id=bsid, block_mode=block_mode,
                     content_checksum=content_cs, content_size=content_size,
                     dict_id=dict_id, block_checksum=block_cs)
    return info, pos


def get_frame_info(buf) -> FrameInfo:
    return parse_frame_header(buf)[0]


# --- bounds (reference: src/lz4f.zig:274-301) ---

def compress_frame_bound(src_size: int, prefs: Preferences | None = None) -> int:
    prefs = prefs or Preferences()
    info = prefs.frame_info
    block_size = info.block_size_id.to_block_size()
    n_blocks = max((src_size + block_size - 1) // block_size, 1)
    per_block = BLOCK_HEADER_SIZE + compress_bound(min(block_size, src_size))
    if info.block_checksum:
        per_block += BLOCK_CHECKSUM_SIZE
    total = HEADER_SIZE_MAX + n_blocks * per_block + ENDMARK_SIZE
    if info.content_checksum:
        total += CONTENT_CHECKSUM_SIZE
    return total


# --- block compressor dispatch ---

def _block_compressor(level: int):
    """Pick the per-block compressor for a compression level via the
    codec model registry (models/codec.py).  Level > 0 routes to HC
    (reference: lz4f.zig:393-404)."""
    from .models.codec import get_codec
    codec = get_codec(level)
    def comp(data, max_output=None):
        return codec.compress(data, max_output=max_output)
    return comp


# --- streaming frame compressor (README-promised API, built for real) ---

class FrameCompressor:
    """Incremental frame compression: begin() / update() / flush() / end().

    The reference README documents this API (reference: README.md:96-123)
    but the implementation only ships one-shot compressFrame; here it is
    implemented for real, including linked-block history via the
    streaming block layer and dictionary support.
    """

    def __init__(self, prefs: Preferences | None = None,
                 dictionary: bytes | None = None, dict_id: int = 0):
        self.prefs = prefs or Preferences()
        info = self.prefs.frame_info
        if dict_id and not info.dict_id:
            info = dataclasses.replace(info, dict_id=dict_id)
        self.info = info
        self.block_size = info.block_size_id.to_block_size()
        self.level = self.prefs.compression_level
        self._dict = bytes(dictionary)[-WINDOW_SIZE:] if dictionary else b""
        self._pending = bytearray()
        self._content_hash = (xxh32_stream()
                              if info.content_checksum else None)
        self._content_len = 0
        self._started = False
        self._finished = False
        self._stream = None     # linked-mode compression state

    # -- internals --------------------------------------------------------

    def _new_stream(self):
        if self.level > 0:
            from .ops.hc import StreamHC
            s = StreamHC(self.level)
        else:
            s = Stream()
        if self._dict:
            s.load_dict(self._dict)
        return s

    def _compress_block(self, data: bytes) -> bytes:
        """Compress one block body; returns the framed block bytes
        (size word + payload + optional checksum).  Applies the
        store-uncompressed fallback (reference: src/lz4f.zig:407-418)."""
        linked = self.info.block_mode == BlockMode.linked
        try:
            if linked:
                if self._stream is None:
                    self._stream = self._new_stream()
                if self.level > 0:
                    comp = self._stream.compress_continue(
                        data, max_output=len(data) - 1)
                else:
                    comp = self._stream.compress_fast_continue(
                        data, 1 - min(self.level, 0),
                        max_output=len(data) - 1)
            elif self._dict:
                # independent blocks each use the dictionary
                s = self._new_stream()
                if self.level > 0:
                    comp = s.compress_continue(data, max_output=len(data) - 1)
                else:
                    comp = s.compress_fast_continue(
                        data, 1 - min(self.level, 0),
                        max_output=len(data) - 1)
            else:
                comp = _block_compressor(self.level)(
                    data, max_output=len(data) - 1)
            stored, size_word = comp, len(comp)
        except E.OutputTooSmall:
            # incompressible: store raw with the high bit set
            stored, size_word = data, len(data) | _UNCOMPRESSED_BIT
            if linked and self._stream is not None:
                # keep history consistent with what the decoder sees
                self._feed_history_raw(data)

        out = bytearray(size_word.to_bytes(4, "little"))
        out += stored
        if self.info.block_checksum:
            out += xxh32(stored).to_bytes(4, "little")
        return bytes(out)

    def _feed_history_raw(self, data: bytes) -> None:
        """After a store-uncompressed block in linked mode, the decoder's
        history window still contains these bytes; resync by re-priming
        the stream dictionary with the last 64KB."""
        tail = (self._stream.save_dict() + data)[-WINDOW_SIZE:]
        self._stream = self._new_stream_from_tail(tail)

    def _new_stream_from_tail(self, tail: bytes):
        if self.level > 0:
            from .ops.hc import StreamHC
            s = StreamHC(self.level)
        else:
            s = Stream()
        s.load_dict(tail)
        return s

    # -- public API ---------------------------------------------------

    def begin(self) -> bytes:
        """Write the frame header.  reference README: compressBegin."""
        if self._started:
            raise E.FrameDecodingAlreadyStarted("begin() called twice")
        self._started = True
        return write_frame_header(self.info)

    def update(self, data) -> bytes:
        """Add content; returns any completed compressed blocks.

        Buffers partials to full blocks unless ``auto_flush`` is set
        in preferences (then compresses everything immediately).
        reference README: compressUpdate.
        """
        if not self._started:
            raise E.CompressionStateUninitialized("call begin() first")
        if self._finished:
            raise E.FrameDecodingAlreadyStarted("frame already ended")
        data = bytes(data)
        if self._content_hash is not None:
            self._content_hash.update(data)
        self._content_len += len(data)
        self._pending += data
        out = bytearray()
        while len(self._pending) >= self.block_size:
            chunk = bytes(self._pending[:self.block_size])
            del self._pending[:self.block_size]
            out += self._compress_block(chunk)
        if self.prefs.auto_flush and self._pending:
            out += self.flush()
        return bytes(out)

    def flush(self) -> bytes:
        """Force-compress buffered input as a (short) block."""
        if not self._pending:
            return b""
        chunk = bytes(self._pending)
        self._pending.clear()
        return self._compress_block(chunk)

    def end(self) -> bytes:
        """Flush, then emit endmark + optional content checksum.

        reference README: compressEnd; one-shot analog
        src/lz4f.zig:433-441."""
        out = bytearray(self.flush())
        out += (0).to_bytes(4, "little")
        if self._content_hash is not None:
            out += self._content_hash.digest().to_bytes(4, "little")
        self._finished = True
        if (self.info.content_size and
                self._content_len != self.info.content_size):
            raise E.FrameSizeWrong(
                f"declared content_size {self.info.content_size}, "
                f"wrote {self._content_len}")
        return bytes(out)


# --- streaming frame decompressor ---

class FrameDecompressor:
    """Incremental frame decoder: feed compressed bytes, get content.

    State machine over header -> blocks -> endmark -> content checksum,
    with skippable-frame skipping, linked-block history, block/content
    checksum verification and content-size verification.  This is the
    robust-decoding counterpart the reference lacks (its one-shot
    decoder cannot decode genuine linked frames or skippable frames,
    SURVEY.md section 2.3).
    """

    def __init__(self, dictionary: bytes | None = None,
                 options: DecompressOptions | None = None):
        self._dict = bytes(dictionary) if dictionary else b""
        self.options = options or DecompressOptions()
        self.reset()

    def reset(self) -> None:
        self._buf = bytearray()
        self._state = "MAGIC"
        self._skip_remaining = 0
        self.frame_info: FrameInfo | None = None
        self._block_size = 0
        self._content_hash: XXH32 | None = None
        self._content_len = 0
        self._decode_stream: StreamDecode | None = None
        self.finished = False

    # amount of further input wanted (0 when a frame has fully ended
    # and no more bytes are buffered)
    def feed(self, data) -> bytes:
        """Consume compressed bytes, return decoded content bytes."""
        self._buf += bytes(data)
        out = bytearray()
        progress = True
        while progress:
            progress = self._step(out)
        return bytes(out)

    def _need(self, n: int) -> bool:
        return len(self._buf) >= n

    def _take(self, n: int) -> bytes:
        b = bytes(self._buf[:n])
        del self._buf[:n]
        return b

    def _step(self, out: bytearray) -> bool:
        st = self._state
        if st == "MAGIC":
            if not self._need(MIN_SIZE_TO_KNOW_HEADER_LENGTH):
                return False
            magic = int.from_bytes(bytes(self._buf[:4]), "little")
            if magic & MAGIC_SKIPPABLE_MASK == MAGIC_SKIPPABLE_START:
                if not self._need(8):
                    return False
                self._take(4)
                self._skip_remaining = int.from_bytes(self._take(4), "little")
                self._state = "SKIP"
                return True
            hdr_len = header_size(bytes(self._buf))  # validates magic
            if not self._need(hdr_len):
                return False
            info, consumed = parse_frame_header(bytes(self._buf[:hdr_len]))
            self._take(consumed)
            self.frame_info = info
            self._block_size = info.block_size_id.to_block_size()
            self._content_hash = (xxh32_stream()
                              if info.content_checksum else None)
            self._content_len = 0
            self._decode_stream = StreamDecode()
            if self._dict:
                self._decode_stream.set_dict(self._dict)
            self._state = "BLOCK_HEADER"
            self.finished = False
            return True

        if st == "SKIP":
            take = min(self._skip_remaining, len(self._buf))
            self._take(take)
            self._skip_remaining -= take
            if self._skip_remaining == 0:
                self._state = "MAGIC"
                self.finished = True
                return True
            return False

        if st == "BLOCK_HEADER":
            if not self._need(4):
                return False
            word = int.from_bytes(self._take(4), "little")
            if word == 0:
                self._state = ("CONTENT_CHECKSUM"
                               if self.frame_info.content_checksum else "MAGIC")
                if self._state == "MAGIC":
                    self._end_frame()
                return True
            self._block_uncompressed = bool(word & _UNCOMPRESSED_BIT)
            self._block_len = word & ~_UNCOMPRESSED_BIT
            if self._block_len > compress_bound(self._block_size):
                raise E.MaxBlockSizeInvalid(
                    f"block length {self._block_len} exceeds bound for "
                    f"{self._block_size}-byte blocks")
            self._state = "BLOCK_DATA"
            return True

        if st == "BLOCK_DATA":
            need = self._block_len
            if self.frame_info.block_checksum:
                need += BLOCK_CHECKSUM_SIZE
            if not self._need(need):
                return False
            payload = self._take(self._block_len)
            if self.frame_info.block_checksum:
                expect = int.from_bytes(self._take(4), "little")
                if (not self.options.skip_checksums
                        and xxh32(payload) != expect):
                    raise E.BlockChecksumInvalid(
                        f"block checksum mismatch")
            if self._block_uncompressed:
                decoded = payload
                # decoder history must still advance in linked mode
                ds = self._decode_stream
                ds.prefix = (ds.prefix + decoded)[-WINDOW_SIZE:]
            else:
                if self.frame_info.block_mode == BlockMode.linked:
                    decoded = self._decode_stream.decompress_continue(
                        payload, self._block_size)
                else:
                    ds = StreamDecode()
                    if self._dict:
                        ds.set_dict(self._dict)
                    decoded = ds.decompress_continue(payload, self._block_size)
            out += decoded
            if self._content_hash is not None:
                self._content_hash.update(decoded)
            self._content_len += len(decoded)
            self._state = "BLOCK_HEADER"
            return True

        if st == "CONTENT_CHECKSUM":
            if not self._need(4):
                return False
            expect = int.from_bytes(self._take(4), "little")
            if (not self.options.skip_checksums
                    and self._content_hash.digest() != expect):
                raise E.ContentChecksumInvalid(
                    f"content checksum {self._content_hash.digest():#x} "
                    f"!= {expect:#x}")
            self._state = "MAGIC"
            self._end_frame()
            return True

        return False

    def _end_frame(self) -> None:
        info = self.frame_info
        if info and info.content_size and self._content_len != info.content_size:
            raise E.FrameSizeWrong(
                f"declared content size {info.content_size}, "
                f"decoded {self._content_len}")
        self.finished = True

    @property
    def unconsumed(self) -> int:
        return len(self._buf)


# --- one-shot entry points ---

def compress_frame(src, prefs: Preferences | None = None,
                   dictionary: bytes | None = None) -> bytes:
    """One-shot frame compression (reference: src/lz4f.zig:354-446)."""
    prefs = prefs or Preferences()
    fc = FrameCompressor(prefs, dictionary=dictionary)
    out = bytearray(fc.begin())
    out += fc.update(bytes(src))
    out += fc.end()
    return bytes(out)


def decompress_frame(src, max_output: int | None = None,
                     dictionary: bytes | None = None,
                     options: DecompressOptions | None = None) -> bytes:
    """One-shot frame decompression (reference: src/lz4f.zig:541-638).

    Decodes every frame in ``src`` (concatenated frames, as the lz4 CLI
    does), skipping skippable frames.  ``max_output`` bounds the total
    decoded size.
    """
    fd = FrameDecompressor(dictionary=dictionary, options=options)
    out = fd.feed(bytes(src))
    if fd.unconsumed or not fd.finished:
        raise E.FrameSizeWrong(
            f"truncated or trailing data: {fd.unconsumed} bytes unconsumed, "
            f"finished={fd.finished}")
    if max_output is not None and len(out) > max_output:
        raise E.DstMaxSizeTooSmall(f"decoded {len(out)} > {max_output}")
    return out


def write_skippable_frame(payload, magic_variant: int = 0) -> bytes:
    """Build a skippable frame (magic 0x184D2A5x) around arbitrary bytes."""
    if not 0 <= magic_variant <= 15:
        raise E.ParameterInvalid("magic_variant must be 0..15")
    payload = bytes(payload)
    return ((MAGIC_SKIPPABLE_START + magic_variant).to_bytes(4, "little")
            + len(payload).to_bytes(4, "little") + payload)
