"""Multi-host frame compression (counterpart of the reference's
``parallel/multihost.py``).

The corpus is cut across processes in whole frame blocks: every process
compresses its contiguous span of blocks on its local devices through
:class:`ShardedFrameCodec`'s encoder (blocks over the local mesh), then
the variable-length block records are all-gathered across processes in
frame order, and every process serializes the same spec-conformant
frame.  A shared dictionary, when given, is the same on every process.

Checksums: per-block xxHash32 checksums are computed where the blocks
are; the whole-content checksum is one sequential xxh32 stream, so it
is computed only when ``content_hash`` is asked for (a pass over the
raw corpus) -- both layouts are spec-conformant.

The collectives run over ``torch.distributed`` with the gloo backend on
host tensors: the payloads begin and end as host bytes, and NCCL cannot
put two ranks on one GPU.  One process needs no set-up (a world of 1);
for more, every process calls :func:`initialize` first: with no
arguments under ``torchrun``, or with the coordinator, world size and
rank.
"""

from __future__ import annotations

import atexit
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import frame as lz4f
from ..constants import WINDOW_SIZE
from ..utils.xxhash32 import xxh32
from .mesh import blocks_mesh
from .sharded import _UNCOMPRESSED_BIT, ShardedFrameCodec, _scan_blocks

__all__ = ["initialize", "MultiHostFrameCodec"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout: int = 300) -> None:
    """Join the process group over gloo as rank ``process_id`` of
    ``num_processes``.  Idempotent: a process already in a group keeps
    it.

    What the caller leaves out comes from the launcher's environment, as
    ``jax.distributed.initialize`` takes it from the cluster's (the
    reference, ``multihost.py:53-55``): ``torchrun`` sets
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``.  With
    a ``coordinator_address`` (a ``host:port``) the group meets at
    ``tcp://{coordinator_address}``, else at ``env://``
    (``MASTER_ADDR:MASTER_PORT``); a rank or world size not given is
    read from ``RANK`` or ``WORLD_SIZE``.  What is given wins.  With
    neither, this raises: a process alone needs no :func:`initialize`
    (``_process_info()`` is ``(0, 1)`` without a group).

    One tiny all-gather runs at once, while the processes are still in
    step: the first collective is the backends' rendezvous, and a
    process that reached it only after a long skew (a build, a first
    compile) would leave the early one waiting out its timeout, as the
    reference's comment on its own warm-up says (``multihost.py:48-55``).
    """
    if dist.is_initialized():
        return
    init_method = f"tcp://{coordinator_address}" \
        if coordinator_address is not None else "env://"
    dist.init_process_group(
        "gloo", init_method=init_method,
        world_size=_given_or_env(num_processes, "WORLD_SIZE",
                                 "num_processes"),
        rank=_given_or_env(process_id, "RANK", "process_id"),
        timeout=datetime.timedelta(seconds=initialization_timeout))
    # the group's threads are joined before the interpreter ends, as the
    # reference's collectives are finalized at exit; a rank that ends
    # with the group still up may abort (SIGABRT) after its last line
    atexit.register(_shutdown)
    if dist.get_world_size() > 1:
        dist.all_gather([torch.zeros(1, dtype=torch.int32)
                         for _ in range(dist.get_world_size())],
                        torch.zeros(1, dtype=torch.int32))


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _given_or_env(value: int | None, var: str, name: str) -> int:
    """``value`` when given, else the launcher's ``var``; raises when
    neither is there (no quiet world of 1)."""
    if value is not None:
        return int(value)
    if not os.environ.get(var):
        raise ValueError(f"initialize: {name} not given and {var} not "
                         "set; start the process with torchrun or pass it")
    return int(os.environ[var])


def _process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_bytes(payload: bytes) -> list[bytes]:
    """All-gather one bytes blob a process; returns them in rank order.
    The lengths go first, then the blobs padded to the longest, rounded
    up to 64 KB as the reference rounds them (``multihost.py:80-82``)."""
    _pid, pcount = _process_info()
    if pcount == 1:
        return [payload]
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(pcount)]
    dist.all_gather(lens, torch.tensor([len(payload)], dtype=torch.int64))
    lens = [int(t) for t in lens]
    cap = max(-(-max(lens) // 65536) * 65536, 65536)
    buf = torch.zeros(cap, dtype=torch.uint8)
    buf.numpy()[:len(payload)] = np.frombuffer(payload, np.uint8)
    bufs = [torch.empty(cap, dtype=torch.uint8) for _ in range(pcount)]
    dist.all_gather(bufs, buf)
    return [b[:n].numpy().tobytes() for b, n in zip(bufs, lens)]


class MultiHostFrameCodec:
    """Corpus -> one LZ4 frame, blocks cut across processes, then over
    each process's local devices; block records all-gathered in frame
    order.  Keeps the reference's arguments and defaults
    (``multihost.py:96-117``); ``local_mesh`` defaults to every local
    CUDA device."""

    def __init__(self, block_size_id=lz4f.BlockSizeID.max64KB,
                 block_checksum: bool = True,
                 dictionary: bytes | None = None,
                 local_mesh=None, compression_level: int = 0,
                 decode_engine: str = "win"):
        self.bsid = lz4f.BlockSizeID(block_size_id)
        self.block_size = self.bsid.to_block_size()
        self.block_checksum = block_checksum
        self.dict = bytes(dictionary)[-WINDOW_SIZE:] if dictionary \
            else None
        # each process drives its local devices only: the span split is
        # the parallelism across processes, the mesh the one within
        self.local = ShardedFrameCodec(
            mesh=local_mesh or blocks_mesh(), block_size_id=self.bsid,
            content_checksum=False, block_checksum=False,
            dictionary=self.dict, compression_level=compression_level,
            decode_engine=decode_engine)

    def _local_span(self, n_blocks: int) -> tuple[int, int]:
        pid, pcount = _process_info()
        per = -(-n_blocks // pcount)
        lo = min(pid * per, n_blocks)
        hi = min(lo + per, n_blocks)
        return lo, hi

    def compress_corpus(self, data: bytes,
                        content_hash: bool = False) -> bytes:
        """Compress ``data`` (the whole corpus, visible to every process
        -- or at least its span; only ``[lo*bs, hi*bs)`` is read) into
        one LZ4 frame.  Every process returns the same frame."""
        data = bytes(data)
        bs = self.block_size
        n_blocks = max((len(data) + bs - 1) // bs, 0)
        lo, hi = self._local_span(n_blocks)

        # the encode of this process's span over its local devices
        records = bytearray()
        for b0 in range(lo, hi, 256):
            b1 = min(b0 + 256, hi)
            for raw, comp in self.local._encode_span(data[b0 * bs:b1 * bs]):
                if len(comp) < len(raw):
                    stored, word = comp, len(comp)
                else:
                    stored, word = raw, len(raw) | _UNCOMPRESSED_BIT
                records += word.to_bytes(4, "little")
                records += stored
                if self.block_checksum:
                    records += xxh32(stored).to_bytes(4, "little")

        parts = _allgather_bytes(bytes(records))    # in frame order

        info = lz4f.FrameInfo(
            block_size_id=self.bsid,
            block_mode=lz4f.BlockMode.independent,
            content_checksum=content_hash,
            block_checksum=self.block_checksum,
            content_size=len(data))
        out = bytearray(lz4f.write_frame_header(info))
        for p in parts:
            out += p
        out += (0).to_bytes(4, "little")
        if content_hash:
            out += xxh32(data).to_bytes(4, "little")
        return bytes(out)

    def decompress_corpus(self, frame: bytes) -> bytes:
        """Decode an independent-mode frame across processes: every
        process scans the block records, decodes its span of blocks on
        its local devices, and the decoded spans are all-gathered in
        rank order; every process returns the same corpus.  The content
        checksum and size are verified on the whole.  Linked and
        skippable frames go to the host frame layer."""
        frame = bytes(frame)
        info, pos = lz4f.parse_frame_header(frame)
        if info.block_mode == lz4f.BlockMode.linked or \
                info.frame_type == lz4f.FrameType.skippable_frame:
            return lz4f.decompress_frame(frame,
                                         dictionary=self.dict or None)
        bs = info.block_size_id.to_block_size()
        records, pos = _scan_blocks(frame, pos, info.block_checksum)

        lo, hi = self._local_span(len(records))
        span = self.local._decode_records(records[lo:hi], bs)
        content = b"".join(_allgather_bytes(b"".join(span)))

        if info.content_checksum:
            if pos + 4 > len(frame):
                raise lz4f.E.FrameSizeWrong("missing content checksum")
            expect = int.from_bytes(frame[pos:pos + 4], "little")
            if xxh32(content) != expect:
                raise lz4f.E.ContentChecksumInvalid(
                    "content checksum mismatch")
        if info.content_size and len(content) != info.content_size:
            raise lz4f.E.FrameSizeWrong(
                f"content size {info.content_size} != {len(content)}")
        return content
