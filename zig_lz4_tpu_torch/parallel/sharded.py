"""LZ4 frame codec on CUDA devices: levels 0-12 encode; T-map,
fragment-ladder and sequence-rebuild decode.

Counterpart of ``ShardedFrameCodec`` of the JAX reference
(``parallel/sharded.py``): on the encode side every block size, with or
without a dictionary, at levels 0-12; on the decode side independent and
linked frames of any block size, with or without a dictionary.  The
block work runs on one device, or over a ``('blocks',)`` mesh
(``parallel/mesh.py``): every batch of blocks is cut into one contiguous
shard a device of the mesh, each shard is staged to its device and
encoded or decoded there, and the results are gathered in order.  The
bytes do not depend on the mesh.

  compress:   frame data -> [B, window] matrix of windows
              ``[dictionary | block]`` on the device (blocks over 256 KB
              as 256 KB sub-spans behind the 64 KB before each, each
              launch group as wide as its longest window needs) ->
              encoder kernels (ops/torch_block) -> host gather of
              (payload, length), sub-span streams joined -> frame
              assembly on the host, with the store-uncompressed fallback
              and xxh32 checksums.

  decompress: host scan of the frame into block records, then
              * independent blocks: one native ``native_resolve_tmap``
                over all compressed payloads -> fetch buffers
                ``[dictionary | payload]`` and T-maps staged to the
                device -> the gather kernel (ops/torch_decode) ->
                ordered gather.  Stored blocks are copied as they are.
                Under ``decode_engine`` "win", "chase" or "mixed" the
                fragment ladder goes first: one native
                ``native_resolve_blocks`` per group of blocks -> each
                block to the first tier (fragment budget, round depth,
                payload quantum) that fits it -> fetch buffers and the
                tier's fragment tables, a few thousand entries a block,
                staged to the device -> the tier's engine
                (ops/torch_frags) -> the blocks whose ``ok`` is set;
                what no tier took or finished goes through the T-map
                path.  Without the native runtime the payloads are
                parsed into sequence tables in Python and rebuilt by
                the sequence-rebuild kernel (blocks up to 64 KB).
              * linked blocks: windows of blocks, one native
                ``native_resolve_tmap_linked`` per window -> payloads
                and the window's T-map staged to the device -> the
                linked step kernels, which carry the 64 KB history on
                the device from window to window -> one copy back at
                the end.  Without the native runtime the frame goes to
                the host frame layer, as the reference's does.
              Checksums are verified on the host.

Without the native runtime, independent blocks over 64 KB raise
``NotImplementedError``: the sequence-rebuild decoder does not take them.
"""

from __future__ import annotations

import dataclasses
import itertools
import re

import numpy as np
import torch

from .. import errors as E
from .. import frame as lz4f
from .. import trace
from ..constants import WINDOW_SIZE, compress_bound
from ..native import (native_resolve_blocks, native_resolve_tmap,
                      native_resolve_tmap_linked)
from ..ops.block import _concat
from ..ops.torch_block import (_sub_width, device_encoder_supports,
                               encode_blocks, level_params)
from ..ops.torch_decode import (MAX_SEQS, decode_blocks,
                                decode_blocks_tmap,
                                device_seq_decoder_supports,
                                linked_tmap_step, parse_sequences,
                                seqs_to_arrays)
from ..ops.torch_frags import (decode_blocks_frags,
                               decode_blocks_frags_chase,
                               decode_blocks_frags_win,
                               device_chase_decoder_supports,
                               device_frag_decoder_supports,
                               device_win_decoder_supports)
from ..utils.xxhash32 import xxh32, xxh32_stream
from .device import resolve_device
from .mesh import BlocksMesh, blocks_mesh  # noqa: F401  (reference's path)

__all__ = ["ShardedFrameCodec"]

_UNCOMPRESSED_BIT = 0x80000000
#: window bytes per encoder launch: 1024 windows of 64 KB.  Device
#: scratch per window byte: 4 bytes of candidate words, 4 of parse state,
#: 3 of literal runs and 1 of output (~0.8 GB at levels 0-9); the deep
#: levels add 4 bytes of 32-byte ranks, 4 more of 256-byte ranks at
#: level 12, and 1 of chosen rows (~1.4 GB at level 12); windows over
#: 64 KB add ~7 bytes of sort order and window words (~1.3 GB)
_ENC_BYTES = 1024 * 65536
#: blocks over _SUB bytes encode as _SUB-byte sub-spans, each behind the
#: _SUBH bytes before it in one window, so that matches reach across the
#: sub-span bounds (reference: sharded.py:79-89, with the same values:
#: the bytes depend on them)
_SUB = 262144
_SUBH = 65536
#: output bytes per decode launch; T is staged at 4 bytes per output
#: byte, so 64 MB of output stages 256 MB of T
_DEC_BYTES = 64 << 20
#: linked-frame windows: output bytes per window (at least one block)
#: and the payload budget of a window of blocks under 1 MB, as in the
#: reference (sharded.py:474-476)
_LINK_NOUT = 1 << 21
_LINK_PCQ = 1 << 20
#: fragment-ladder tiers: (fcap divisor of the block size, most rounds).
#: Most blocks fit the cheap tier; match-dense blocks go to the wider
#: and deeper ones (reference: sharded.py:48-65).  A mesh of one device
#: leaves the last, deep tier out, as the reference's does
#: (sharded.py:700,703).
_FRAG_TIERS = ((8, 2), (4, 8), (1, 12))
#: narrow ladder for 1 MB and 4 MB blocks, taken when no tier above
#: fits: at a payload of at most half the block the chase engine covers
#: budgets of bs/64 and bs/256 fragments
_FRAG_TIERS_BIG = ((64, 12), (256, 12))
_FRAG_SPLIT_MAX = 8
_FRAG_RMAX = _FRAG_TIERS[-1][1]
#: chase tiers: (fcap divisor, deepest chain).  Pointer doubling reaches
#: depth 2^(dense + doublings), so the resolver keeps natural chains
#: (round_limit 64) instead of splitting matches to bound the rounds
#: (reference: sharded.py:66-78)
_CHASE_TIERS = ((4, 16), (2, 64), (1, 64), (32, 64))
_CHASE_RMAX = 64
#: host bytes of fragment tables per resolve (five int32 arrays of
#: fcap columns a block); a frame with more resolves in groups of blocks
_FRAG_TABLE_BYTES = 256 << 20


def _chase_config(depth: int) -> tuple[int, int, int]:
    """(dense, doublings, qcap) with 2^(dense + doublings) >= ``depth``:
    depths up to 32 run dense rounds alone, deeper ones add rounds over
    a pool of 4096 (reference: sharded.py:92-109)."""
    e = max((depth - 1).bit_length(), 1)    # 2^e >= depth
    dense = min(e, 5)
    dbl = e - dense
    return dense, dbl, 4096 if dbl else 0


def _rows(parts, width: int, prefix: bytes = b"") -> np.ndarray:
    """Zero-padded ``uint8[len(parts), width]``: each row ``prefix``,
    then its part, or its (history, span) pair back to back."""
    rows = np.zeros((len(parts), width), np.uint8)
    if prefix:
        rows[:, :len(prefix)] = np.frombuffer(prefix, np.uint8)
    for k, part in enumerate(parts):
        at = len(prefix)
        for piece in part if isinstance(part, tuple) else (part,):
            rows[k, at:at + len(piece)] = np.frombuffer(piece, np.uint8)
            at += len(piece)
    return rows


def _row_bytes(out: np.ndarray, lens) -> list[bytes]:
    """Row ``k`` of ``out`` up to ``lens[k]`` bytes, for every row."""
    return [out[k, :n].tobytes()
            for k, n in enumerate(np.asarray(lens).tolist())]


def _pack(payloads: list) -> tuple[bytes, np.ndarray, np.ndarray]:
    """(concat, offs, lens) of ``payloads`` for the native resolvers:
    the payloads back to back, with their int64 offsets and lengths."""
    lens = np.array([len(p) for p in payloads], np.int64)
    offs = np.zeros_like(lens)
    offs[1:] = np.cumsum(lens)[:-1]
    return b"".join(payloads), offs, lens


def _scan_blocks(comp: bytes, pos: int, block_checksum: bool):
    """The (payload, uncompressed) block records of a frame from
    ``pos`` (just past its header) to its end mark, and the position
    after the end mark."""
    records = []
    while True:
        if pos + 4 > len(comp):
            raise E.FrameSizeWrong("truncated block header")
        word = int.from_bytes(comp[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            return records, pos
        uncompressed = bool(word & _UNCOMPRESSED_BIT)
        blen = word & ~_UNCOMPRESSED_BIT
        if pos + blen > len(comp):
            raise E.FrameSizeWrong("truncated block payload")
        payload = comp[pos:pos + blen]
        pos += blen
        if block_checksum:
            expect = int.from_bytes(comp[pos:pos + 4], "little")
            pos += 4
            if xxh32(payload) != expect:
                raise E.BlockChecksumInvalid("block checksum mismatch")
        records.append((payload, uncompressed))


def _frame_block_error(exc: E.CorruptedData, what: str,
                       frame_index) -> E.CorruptedData:
    """``exc`` of a native resolver, which numbers the blocks of its
    own call, renamed to the frame's block index."""
    m = re.search(r"block (\d+)", str(exc))
    where = (f"frame block {frame_index(int(m.group(1)))}" if m
             else "a frame block")
    return E.CorruptedData(f"{what}: {where} is corrupt ({exc})")


class ShardedFrameCodec:
    """LZ4 frame codec whose block work runs on CUDA devices.

    Keeps the reference's constructor (``sharded.py:156-163``), with
    ``device`` first: the codec runs on that one device, or, when
    ``mesh`` is given (``blocks_mesh``), over the mesh's devices, and
    its ``device`` is then the mesh's first.  ``device="cpu"`` (or a mesh
    of CPU devices) runs the plain PyTorch versions of the kernels, for
    tests; nothing picks the CPU on its own.
    """

    def __init__(self, device: str | torch.device = "cuda",
                 block_size_id: lz4f.BlockSizeID = lz4f.BlockSizeID.max64KB,
                 content_checksum: bool = True,
                 block_checksum: bool = False,
                 dictionary: bytes | None = None,
                 dict_id: int = 0,
                 compression_level: int = 0,
                 decode_engine: str = "tmap",
                 mesh: BlocksMesh | None = None):
        if decode_engine not in ("tmap", "win", "chase", "mixed"):
            raise ValueError(f"unknown decode_engine {decode_engine!r}")
        self.level = int(compression_level)
        # device-encoder quality knobs derived from the level
        # (reference: sharded.py:173-176)
        self.hc, self.deep = level_params(self.level)
        #: "tmap": per-byte source maps and one gather a block, every
        #: block.  "mixed": the fragment ladder, windowed on the
        #: 2-round tier and chase deeper; "win" and "chase" force one
        #: ladder engine everywhere ("chase" also resolves with natural
        #: chains).  What the ladder leaves goes through T-map.
        self.decode_engine = decode_engine
        #: blocks of the last ``decompress_frame`` by the route that
        #: decoded them, and blocks each ladder tier was handed
        self.routes: dict[str, int] = {}
        self.tier_members: dict[str, int] = {}
        self.mesh = mesh or BlocksMesh((resolve_device(device),))
        self.n_devices = self.mesh.size
        #: the mesh's first device: linked frames decode there
        self.device = self.mesh.devices[0]
        self.block_size = lz4f.BlockSizeID(block_size_id).to_block_size()
        self.dict = bytes(dictionary)[-WINDOW_SIZE:] if dictionary else b""
        self.dcap = len(self.dict)
        self.window = self.dcap + self.block_size
        self.info = lz4f.FrameInfo(
            block_size_id=lz4f.BlockSizeID(block_size_id),
            block_mode=lz4f.BlockMode.independent,
            content_checksum=content_checksum,
            block_checksum=block_checksum,
            dict_id=dict_id if dictionary else 0)

    @classmethod
    def from_reference(cls, ref, device: str | torch.device = "cuda",
                       mesh: BlocksMesh | None = None):
        """The port's codec with the settings of a JAX
        ``ShardedFrameCodec`` ``ref``, read from its plain attributes
        (level, block size, window, frame flags, dictionary, decode
        engine) and converted by value: the two packages share no
        class, and ``ref``'s package is never imported.  The codec runs
        on ``device``, or over ``mesh``."""
        info = ref.info
        codec = cls(device=device, mesh=mesh,
                    block_size_id=int(info.block_size_id),
                    content_checksum=bool(info.content_checksum),
                    block_checksum=bool(info.block_checksum),
                    dictionary=bytes(ref.dict) or None,
                    dict_id=int(info.dict_id),
                    compression_level=int(ref.level),
                    decode_engine=str(ref.decode_engine))
        codec.block_size = int(ref.block_size)
        codec.window = int(ref.window)
        return codec

    def _round_trip(self, prefix: str, arrays, launch) -> list:
        """The host ``arrays`` through the mesh and back: the rows of
        each shard (``BlocksMesh.shards``) staged to its device under
        ``<prefix>.stage`` and handed to ``launch(device, *tensors)``
        under ``<prefix>.launch``, every shard before the first is
        gathered; then the output tensors ``launch`` returned, copied
        back in mesh order under ``<prefix>.collect``, as host arrays
        with the shards' rows joined under ``<prefix>.gather`` (one
        shard's as copied back, with no join).  ``<prefix>.shards``
        counts the shards launched."""
        shards = self.mesh.shards(len(arrays[0]))
        trace.count(prefix + ".shards", len(shards))
        launched = []
        for d, lo, hi in shards:
            with trace.span(prefix + ".stage"):
                args = [torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
                        .to(d) for a in arrays]
            with trace.span(prefix + ".launch"):
                launched.append(launch(d, *args))
        with trace.span(prefix + ".collect"):
            copied = [[t.cpu().numpy() for t in out] for out in launched]
        if len(copied) == 1:
            return copied[0]
        with trace.span(prefix + ".gather"):
            return [np.concatenate(col) for col in zip(*copied)]

    # -- compression ----------------------------------------------------

    def _encode_windows(self, entries: list, width,
                        batch_blocks: int | None = None) -> list[bytes]:
        """Payloads of ``entries`` = [(history, span)]: windows
        ``[history | span]`` that emit from the history's end, each
        launch group at ``width(longest)`` bytes, ``longest`` its longest
        window.  A group holds ``_ENC_BYTES`` of windows at the widest,
        ``width(self.window)`` (no window is longer than the codec's), or
        ``batch_blocks`` windows rounded by ``BlocksMesh.batch`` where
        that is fewer; it is one encoder launch a shard, and counted in
        ``enc.narrow_windows`` where it launches below the widest.  The
        payloads depend neither on the batching nor on the width."""
        widest = width(self.window)
        batch = self.mesh.batch(max(_ENC_BYTES // widest, 1))
        if batch_blocks:
            batch = min(self.mesh.batch(batch_blocks), batch)
        payloads = []
        for c0 in range(0, len(entries), batch):
            group = entries[c0:c0 + batch]
            with trace.span("enc.windows"):
                ends = [len(h) + len(s) for h, s in group]
                w = width(max(ends))
                if w < widest:
                    trace.count("enc.narrow_windows", len(group))
                lens = np.array(ends, np.int32)
                starts = np.array([len(h) for h, _s in group], np.int32)
                host = (_rows(group, w), lens, starts)
            if self.deep:       # from the host arrays: no synchronisation
                trace.count("enc.deep_windows", len(group))
                trace.count("enc.deep_window_bytes", int(lens.sum()))
            # levels <= 1 run the fast finder at acceleration 1, as the
            # reference's frame codec does (sharded.py:112-121)
            out, out_len = self._round_trip(
                "enc", host,
                lambda _d, *a: encode_blocks(*a, hc=self.hc, deep=self.deep))
            trace.count("enc.h2d_bytes", sum(a.nbytes for a in host))
            trace.count("enc.d2h_bytes", out.nbytes + out_len.nbytes)
            if self.deep:
                trace.count("enc.deep_payload_bytes", int(out_len.sum()))
            with trace.span("enc.payloads"):
                payloads += _row_bytes(out, out_len)
        return payloads

    def _encode_span(self, span: bytes, batch_blocks: int | None = None
                     ) -> list[tuple[bytes, bytes]]:
        """Device encode of a contiguous byte span into per-block (raw,
        compressed) pairs (reference: sharded.py:257-292).  A block's
        window is ``[dictionary | block]``, emitting from the
        dictionary's end.  Blocks whose windows the encoder does not take
        (``device_encoder_supports``: those over 256 KB) encode as
        ``_SUB``-byte sub-spans, each behind the 64 KB before it (the
        dictionary for the first), each launch group at the width the
        encoder gives its longest window (``torch_block._sub_width``),
        and the sub-span streams join into one block stream
        (``_encode_raws_big``, sharded.py:209-255).
        ``batch_blocks`` groups whole-block windows only: the sub-span
        windows keep the default grouping, as the reference's big-block
        paths ignore it (sharded.py:304-309)."""
        bs = self.block_size
        whole = device_encoder_supports(self.window)
        with trace.span("enc.windows"):         # the blocks and sub-spans
            raws = [span[k:k + bs] for k in range(0, len(span), bs)]
            entries, owner = [], []
            for bi, raw in enumerate(raws):
                if whole:
                    entries.append((self.dict, raw))
                    continue
                for s0 in range(0, max(len(raw), 1), _SUB):
                    hist = (self.dict if s0 == 0
                            else raw[max(s0 - _SUBH, 0):s0])
                    entries.append((hist, raw[s0:s0 + _SUB]))
                    owner.append(bi)
        if whole:
            return list(zip(raws, self._encode_windows(
                entries, lambda _n: self.window, batch_blocks)))
        per_block: list[list[bytes]] = [[] for _ in raws]
        for bi, p in zip(owner, self._encode_windows(
                entries, lambda n: _sub_width(n, _SUBH + _SUB, self.deep))):
            per_block[bi].append(p)
        with trace.span("enc.stitch"):
            pairs, scans = [], 0
            for raw, ps in zip(raws, per_block):
                block, n = _concat(ps)
                pairs.append((raw, block))
                scans += n
            trace.count("enc.stitch_blocks", len(pairs))
            trace.count("enc.stitch_scans", scans)
            return pairs

    def compress_frame(self, data: bytes,
                       batch_blocks: int | None = None) -> bytes:
        """Compress ``data`` into one LZ4 frame of independent blocks.

        ``batch_blocks`` is the reference's (sharded.py:294-320): blocks
        a batch, rounded down to a multiple of the mesh's size and at
        least one a device; 0 or None keep the default.  Here it groups
        the blocks of each encoder launch, capped at ``_ENC_BYTES`` of
        windows, and only where the window is one whole block.  The
        frame does not depend on it."""
        with trace.span("compress_frame"):
            data = bytes(data)
            pairs = self._encode_span(data, batch_blocks)
            chash = None
            if self.info.content_checksum:
                with trace.span("enc.checksum"):
                    chash = xxh32_stream()
                    if data:
                        chash.update(data)
            with trace.span("enc.assemble"):
                # declare the (known) content size so decoders can verify
                # the round trip (reference FLG bit 3, lz4f.zig:106-122)
                info = dataclasses.replace(self.info, content_size=len(data))
                out = bytearray(lz4f.write_frame_header(info))
                n_stored = 0
                for raw, comp in pairs:
                    if len(comp) < len(raw):
                        stored, word = comp, len(comp)
                    else:   # store-uncompressed fallback (lz4f.zig:407-418)
                        stored, word = raw, len(raw) | _UNCOMPRESSED_BIT
                        n_stored += 1
                    out += word.to_bytes(4, "little")
                    out += stored
                    if self.info.block_checksum:
                        out += xxh32(stored).to_bytes(4, "little")

                out += (0).to_bytes(4, "little")
                if chash is not None:
                    out += chash.digest().to_bytes(4, "little")
                trace.count("enc.input_bytes", len(data))
                trace.count("enc.blocks", len(pairs))
                trace.count("enc.stored_blocks", n_stored)
                return bytes(out)

    # -- decompression ----------------------------------------------------

    def decompress_frame(self, comp: bytes) -> bytes:
        """Decode a frame on the device: independent or linked blocks of
        any declared block size, against the codec's dictionary if it
        has one.  Skippable frames go to the host frame layer.
        ``routes`` then says how many blocks went which way."""
        with trace.span("decompress_frame"):
            comp = bytes(comp)
            self.routes, self.tier_members = {}, {}
            parts = []
            while True:                  # concatenated frames (lz4 CLI)
                content, pos = self._decompress_one(comp)
                parts.append(content)
                if pos >= len(comp):
                    return b"".join(parts) if len(parts) > 1 else content
                comp = comp[pos:]

    def _count(self, route: str, n: int) -> None:
        if n:
            self.routes[route] = self.routes.get(route, 0) + n

    def _decompress_one(self, comp: bytes) -> tuple[bytes, int]:
        """(content of the frame at the start of ``comp``, its end)."""
        with trace.span("dec.scan"):
            info, pos = lz4f.parse_frame_header(comp)
            if info.frame_type == lz4f.FrameType.skippable_frame:
                return (lz4f.decompress_frame(comp,
                                              dictionary=self.dict or None),
                        len(comp))
            bs = info.block_size_id.to_block_size()
            records, pos = _scan_blocks(comp, pos, info.block_checksum)
        if info.block_mode == lz4f.BlockMode.linked:
            content = self._decode_linked(records, bs)
            if content is None:
                # no native runtime: the host frame layer decodes the
                # frame, as the reference's decompress_frame does
                # (sharded.py:395-399); it verifies the checksum
                end = pos + 4 * bool(info.content_checksum)
                self._count("host", len(records))
                return (lz4f.decompress_frame(comp[:end],
                                              dictionary=self.dict or None),
                        end)
            self._count("linked", len(records))
        else:
            blocks = self._decode_records(records, bs)
            with trace.span("dec.join"):
                content = b"".join(blocks)

        if info.content_checksum:
            if pos + 4 > len(comp):
                raise E.FrameSizeWrong("missing content checksum")
            expect = int.from_bytes(comp[pos:pos + 4], "little")
            pos += 4
            with trace.span("dec.checksum"):
                if xxh32(content) != expect:
                    raise E.ContentChecksumInvalid(
                        "content checksum mismatch")
        if info.content_size and len(content) != info.content_size:
            raise E.FrameSizeWrong(
                f"content size {info.content_size} != {len(content)}")
        return content, pos

    def _resolve_linked_windows(self, records: list, bs: int):
        """Cut the records of a linked frame into windows and resolve
        each on the host: yields (payloads, T, total) per window, the
        window's block payloads back to back, its global T-map over
        ``[64 KB entry history | payloads]`` and its output length
        (reference: sharded.py:469-555).  Resolution is structural --
        the native linked resolver path-compresses every
        history-reaching match through earlier entries without decoded
        bytes -- so it runs ahead of the device.  Yields None alone when
        the native runtime did not load."""
        H = WINDOW_SIZE
        nout = max(bs, _LINK_NOUT)
        pcq = compress_bound(bs) if bs >= (1 << 20) else _LINK_PCQ
        longest = max((len(p) for p, _u in records), default=0)
        if longest > pcq:
            # the reference hands such frames to the host decoder: its
            # merge packs fetch coordinates into 22 bits.  A gather has
            # no such limit, so the window budget grows instead.
            pcq = max(compress_bound(bs), longest)
        dlen = min(self.dcap, H)
        b0 = 0
        while b0 < len(records):
            # window assembly: greedy under the payload and output
            # budgets
            b1, psum = b0, 0
            while (b1 < len(records)
                   and psum + len(records[b1][0]) <= pcq
                   and (b1 - b0 + 1) * bs <= nout):
                psum += len(records[b1][0])
                b1 += 1
            recs = records[b0:b1]
            pay, offs, lens = _pack([p for p, _u in recs])
            is_raw = np.array([u for _p, u in recs], np.int8)
            try:
                with trace.span("dec.resolve"):
                    r = native_resolve_tmap_linked(
                        pay, offs, lens, H + offs, is_raw, dict_len=dlen,
                        total_cap=nout, blk_cap=bs, dict_base=H - dlen)
            except E.CorruptedData as exc:
                raise _frame_block_error(exc, "linked T-map resolve",
                                         lambda k: b0 + k) from exc
            if r is None:           # the runtime loads before the first
                yield None          # window or never
                return
            T, _olens, total = r
            yield pay, T, total
            dlen = min(H, dlen + total)     # the history stays
            b0 = b1                         # right-aligned

    def _linked_history(self) -> np.ndarray:
        """The history a linked frame starts from: the dictionary,
        right-aligned in 64 KB (``dict_base = H - dict_len``)."""
        hist = np.zeros(WINDOW_SIZE, np.uint8)
        if self.dcap:
            hist[-self.dcap:] = np.frombuffer(self.dict, np.uint8)
        return hist

    def _decode_linked(self, records: list, bs: int) -> bytes | None:
        """Content of a linked-mode frame via windowed T-maps
        (reference: ``_decompress_linked_device``, sharded.py:445-576).
        Linked blocks form a 64 KB dependency chain; only each
        window's fetch data ``[entry history | payloads]`` needs bytes,
        and the entry history is the previous window's output tail, so
        the steps chain on the device and the host copies the output
        back once.  None, with nothing staged, when the native runtime
        did not load."""
        windows = self._resolve_linked_windows(records, bs)
        first = next(windows, ())   # resolved before anything is staged
        if first is None:
            return None
        dev = self.device
        hist = torch.from_numpy(self._linked_history()).to(dev)
        outs = []
        for pay, T, total in itertools.chain([first] if first else [],
                                             windows):
            if not total:
                continue
            # T rows at or past ``total`` are uninitialized: only the
            # live rows are staged
            with trace.span("dec.stage"):
                args = (torch.from_numpy(np.frombuffer(pay, np.uint8).copy()
                                         ).to(dev),
                        torch.from_numpy(T[:total]).to(dev))
            with trace.span("dec.launch"):
                out, hist = linked_tmap_step(hist, *args, total)
            outs.append(out)
        if not outs:
            return b""
        with trace.span("dec.collect"):
            out = torch.cat(outs).cpu().numpy()          # the one sync
        with trace.span("dec.join"):
            return out.tobytes()

    def _decode_records(self, payloads: list, bs: int) -> list:
        """Raw blocks of the (payload, uncompressed) records of an
        independent-mode frame: stored blocks as they are; compressed
        blocks through the fragment ladder when the codec's engine asks
        for it, then -- every block, or what the ladder left -- through
        the T-map decoder; through the sequence-rebuild decoder when
        the native runtime did not load."""
        results: list[bytes | None] = [None] * len(payloads)
        comp_idx = [k for k, (_, u) in enumerate(payloads) if not u]
        for k, (p, u) in enumerate(payloads):
            if u:
                results[k] = p
        self._count("stored", len(payloads) - len(comp_idx))
        rest = comp_idx
        if rest and self.decode_engine != "tmap":
            rest = self._decode_ladder(payloads, bs, comp_idx, results)
            if rest is not None:
                self._count("leftover", len(rest))
            else:                           # no runtime, no ladder
                rest = comp_idx
        if rest:
            if self._decode_tmap(payloads, bs, rest, results):
                self._count("tmap", len(rest))
            else:
                self._decode_seqs(payloads, bs, rest, results)
                self._count("seq", len(rest))
        return results

    def _ladder_tiers(self, bs: int) -> tuple[list, int]:
        """The tiers of this codec's engine that fit ``bs``-byte blocks,
        as (fcap, rounds, largest payload), and the resolver's round
        limit (reference: sharded.py:676-734).  A tier whose geometry
        fits only a small fetch quantum restricts itself to payloads
        that small, which is what gives 1 MB and 4 MB blocks a route.
        The deep tier opens on a mesh of more than one device."""
        eng = self.decode_engine
        mixed = eng == "mixed"
        if eng == "chase":
            use, rmax_resolve = _CHASE_TIERS, _CHASE_RMAX
        else:
            use = _FRAG_TIERS if self.n_devices > 1 else _FRAG_TIERS[:-1]
            rmax_resolve = _FRAG_RMAX

        def supports(fcap, fetch_cap, rmax):
            if eng == "chase" or (mixed and rmax > 2):
                return device_chase_decoder_supports(bs, fcap, fetch_cap)
            return device_frag_decoder_supports(bs, fcap, fetch_cap)

        quanta = (bs // 4, bs // 2, compress_bound(bs))

        def fit(tiers):
            out = []
            for div, rmax in tiers:
                q = next((q for q in reversed(quanta)
                          if supports(bs // div, self.dcap + q, rmax)), 0)
                if q:
                    out.append((bs // div, rmax, q))
            return out

        tiers = fit(use)
        if not tiers and mixed:
            tiers = fit(_FRAG_TIERS_BIG)
        return tiers, rmax_resolve

    def _decode_ladder(self, payloads: list, bs: int, comp_idx: list,
                       results: list) -> list | None:
        """Fragment-ladder decode of the compressed records ``comp_idx``
        (reference: sharded.py:707-835): the host resolves each block
        into a fragment table at the widest fitting budget; a block
        goes to the first tier whose budget, depth and payload quantum
        it meets, and is accepted when the tier's engine sets its
        ``ok``.  Fills ``results`` in place and returns the records
        that are still open; None, with nothing done, when the native
        runtime did not load."""
        tiers, rmax_resolve = self._ladder_tiers(bs)
        if not tiers or not any(payloads[k][0] for k in comp_idx):
            return list(comp_idx)
        fcap_hi = max(f for f, _r, _q in tiers)
        group = max(_FRAG_TABLE_BYTES // (20 * fcap_hi), 1)
        for g0 in range(0, len(comp_idx), group):
            grp = comp_idx[g0:g0 + group]
            try:
                with trace.span("dec.resolve"):
                    concat, offs64, lens64 = _pack([payloads[k][0]
                                                    for k in grp])
                    # the tables are views of a buffer that the next
                    # resolve overwrites: each group is staged before the
                    # next one
                    r = native_resolve_blocks(
                        concat, offs64, lens64, fcap_hi, out_cap=bs,
                        hist_len=self.dcap, split_max=_FRAG_SPLIT_MAX,
                        round_limit=rmax_resolve)
            except E.CorruptedData as exc:
                raise _frame_block_error(exc, "fragment resolve",
                                         lambda k: grp[k]) from exc
            if r is None:
                return None
            fdst, _flen, fsrc, fper, fph, nfrag, rounds, olens = r
            taken = np.zeros(len(grp), bool)
            for fcap, rmax, q in tiers:
                fits = (~taken & (nfrag >= 0) & (nfrag <= fcap)
                        & (rounds <= rmax) & (olens <= bs) & (lens64 <= q))
                taken |= fits
                self._run_tier(payloads, bs, grp, np.flatnonzero(fits),
                               (fdst, fsrc, fper, fph, nfrag, olens),
                               fcap, rmax, results)
        return [k for k in comp_idx if results[k] is None]

    def _run_tier(self, payloads: list, bs: int, grp: list, rows, tables,
                  fcap: int, rmax: int, results: list) -> None:
        """Decode the blocks ``grp[rows]`` with the engine of the tier
        (``fcap``, ``rmax``), ``_DEC_BYTES`` of output a batch, one launch
        a shard, each batch at the smallest fetch quantum that holds its
        largest payload, with the tables cut to its largest fragment
        count."""
        fdst, fsrc, fper, fph, nfrag, olens = tables
        dcap, eng = self.dcap, self.decode_engine
        quanta = (bs // 4, bs // 2, compress_bound(bs))
        batch = self.mesh.batch(max(_DEC_BYTES // bs, 1))
        for c0 in range(0, len(rows), batch):
            sel = rows[c0:c0 + batch]
            need = max(len(payloads[grp[j]][0]) for j in sel)
            fetch_t = dcap + next(q for q in quanta if q >= need)
            with trace.span("dec.fetch"):
                bufs = _rows([payloads[grp[j]][0] for j in sel], fetch_t,
                             self.dict)
                ncol = max(int(nfrag[sel].max()), 1)
                host = (bufs, fdst[sel, :ncol], fsrc[sel, :ncol],
                        fper[sel, :ncol], fph[sel, :ncol], nfrag[sel],
                        olens[sel].astype(np.int32))
            g = 16 if rmax <= 2 else 8          # wide groups when shallow
            if eng == "chase" or (eng == "mixed" and rmax > 2):
                name = "chase"
            elif device_win_decoder_supports(bs, fcap, fetch_t):
                name = f"win{g}"
            else:
                name = "frags"

            def launch(_d, *args):
                if name == "chase":
                    return decode_blocks_frags_chase(*args, bs,
                                                     *_chase_config(rmax))
                if name == "frags":
                    return decode_blocks_frags(*args, rmax, bs)
                return decode_blocks_frags_win(*args, rmax, bs, fcap=fcap,
                                               g=g)
            out, ok = self._round_trip("dec", host, launch)
            route = f"{name} fcap={fcap} rounds={rmax}"
            self.tier_members[route] = (self.tier_members.get(route, 0)
                                        + len(sel))
            self._count(route, int((ok != 0).sum()))
            with trace.span("dec.join"):
                for jj, j in enumerate(sel):
                    if ok[jj]:
                        results[grp[j]] = out[jj, :int(olens[j])].tobytes()

    def _decode_seqs(self, payloads: list, bs: int, comp_idx: list,
                     results: list) -> None:
        """Sequence-rebuild decode of the compressed records
        ``comp_idx`` (reference: sharded.py:868-906): each payload is
        parsed on the host into its sequence table, and the device
        rebuilds the block from the payload, the table and the
        dictionary as history.  Fills ``results`` in place."""
        if not device_seq_decoder_supports(bs, self.dcap):
            raise NotImplementedError(
                f"{bs}-byte blocks without the native host runtime: the "
                "sequence-rebuild decoder takes blocks up to 64 KB, and "
                "larger ones decode through the T-map path, which needs "
                "the runtime (zig_lz4_tpu_torch.native)")
        ccap, nseq_cap = compress_bound(bs), MAX_SEQS(bs)
        hist = (torch.from_numpy(np.frombuffer(self.dict, np.uint8).copy())
                if self.dcap else None)
        batch = self.mesh.batch(max(_DEC_BYTES // bs, 1))
        for c0 in range(0, len(comp_idx), batch):
            grp = comp_idx[c0:c0 + batch]
            with trace.span("dec.resolve"):     # the parse, in Python
                tabs = np.zeros((4, len(grp), nseq_cap), np.int32)
                nss = np.zeros(len(grp), np.int32)
                for j, k in enumerate(grp):
                    p = payloads[k][0]
                    if len(p) > ccap:
                        raise E.CorruptedData(
                            f"frame block {k}: {len(p)} payload bytes "
                            f"exceed the bound {ccap} of a {bs}-byte block")
                    try:
                        seqs = parse_sequences(p, self.dcap)
                    except E.CorruptedData as exc:
                        raise E.CorruptedData(
                            f"frame block {k} is corrupt ({exc})") from exc
                    if (len(seqs) > nseq_cap
                            or sum(a + c for a, _b, c, _d in seqs) > bs):
                        raise E.CorruptedData(
                            f"frame block {k} decodes to more than the "
                            f"frame block size {bs}")
                    (tabs[0, j], tabs[1, j], tabs[2, j], tabs[3, j],
                     nss[j]) = seqs_to_arrays(seqs, nseq_cap)
                bufs = _rows([payloads[k][0] for k in grp], ccap)
            out, olens, ok = self._round_trip(
                "dec", (bufs, *tabs, nss),
                lambda d, *a: decode_blocks(
                    *a, bs, hists=None if hist is None else hist.to(d)))
            if not ok.all():
                raise E.CorruptedData(
                    f"frame block {grp[int(np.flatnonzero(ok == 0)[0])]}: "
                    "the sequence-rebuild decoder rejected its table")
            with trace.span("dec.join"):
                for k, b in zip(grp, _row_bytes(out, olens)):
                    results[k] = b

    def _decode_tmap(self, payloads: list, bs: int, comp_idx: list,
                     results: list) -> bool:
        """T-map decode of the compressed records ``comp_idx``: one
        native resolve of every payload on the host, then the gather
        kernel over batches of blocks, each from its fetch buffer
        ``[dictionary | payload]``.  Fills ``results`` in place and
        returns True; False, with nothing done, when the native runtime
        did not load."""
        try:
            with trace.span("dec.resolve"):
                concat, offs64, lens64 = _pack([payloads[k][0]
                                                for k in comp_idx])
                # owned T: the staging copy below must not race a later
                # resolve that reuses the shared buffer
                r = native_resolve_tmap(concat, offs64, lens64, bs,
                                        hist_len=self.dcap,
                                        reuse_buffers=False)
        except E.CorruptedData as exc:
            raise _frame_block_error(exc, "T-map resolve",
                                     lambda k: comp_idx[k]) from exc
        if r is None:
            return False
        T, olens = r
        over = np.flatnonzero(olens < 0)
        if over.size:
            raise E.CorruptedData(
                f"frame block {comp_idx[int(over[0])]} decodes to more "
                f"than the frame block size {bs}")

        batch = self.mesh.batch(max(_DEC_BYTES // bs, 1))
        for c0 in range(0, len(comp_idx), batch):
            grp = comp_idx[c0:c0 + batch]
            with trace.span("dec.fetch"):
                fetch = _rows([payloads[k][0] for k in grp],
                              self.dcap + int(lens64[c0:c0 + batch].max()),
                              self.dict)
                glen = olens[c0:c0 + batch]
                host = (fetch, T[c0:c0 + batch], glen.astype(np.int32))
            out, = self._round_trip(
                "dec", host, lambda _d, *a: (decode_blocks_tmap(*a),))
            with trace.span("dec.join"):
                for k, b in zip(grp, _row_bytes(out, glen)):
                    results[k] = b
        return True
