"""Codec model families -- the user-facing "models" of this framework.

The reference exposes three encoder families behind one compressHC
entry point plus the fast path (reference: src/lz4hc.zig:59-97 level
table; src/lz4.zig:292 fast).  Here each family is a small model class
with a uniform interface so pipelines (frame layer, sharded codec,
benchmarks) can treat them interchangeably:

  * FastCodec  -- greedy hash-table matcher (levels <= 0;
                  acceleration = 1 - level).  Host: C++ native/oracle.
  * HCCodec    -- MID / hash-chain / optimal strategies (levels 2-12).
  * CUDACodec  -- the device codec (ops/torch_block on hand-written
                  CUDA kernels): the flagship family, one block per
                  thread block.

All families emit interchangeable LZ4 block bytes; any decoder decodes
any family's output.
"""

from __future__ import annotations

from .. import backend
from ..constants import compress_bound  # noqa: F401  (reference's path)
from ..ops import hc as _hc

__all__ = ["BlockCodec", "FastCodec", "HCCodec", "CUDACodec", "get_codec"]


class BlockCodec:
    """Uniform block-codec interface."""

    level: int = 0

    def compress(self, data: bytes, max_output: int | None = None) -> bytes:
        raise NotImplementedError

    def decompress(self, comp: bytes, max_output_size: int) -> bytes:
        return backend.decompress_safe(comp, max_output_size)


class FastCodec(BlockCodec):
    """reference: src/lz4.zig:283-447."""

    def __init__(self, acceleration: int = 1):
        self.acceleration = acceleration
        self.level = 1 - acceleration

    def compress(self, data, max_output=None):
        return backend.compress_fast(data, self.acceleration, max_output)


class HCCodec(BlockCodec):
    """reference: src/lz4hc.zig:1440-1494."""

    def __init__(self, level: int = _hc.LZ4HC_CLEVEL_DEFAULT):
        self.level = level

    def compress(self, data, max_output=None):
        return _hc.compress_hc(data, self.level, max_output=max_output)


class CUDACodec(BlockCodec):
    """Block codec on the hand-written CUDA kernels; one encoder call
    per compress.

    ``level`` <= 1 selects the fast finder; 2..12 the HC-class
    suffix-order finder (deeper candidate probes + lazy deferral; from
    10 on exact rank tiers and a price-aware parse; same wire format).
    ``decompress`` parses the block on the host and rebuilds it with
    the sequence-rebuild kernel.  For bulk work use the batched entry
    points ``ops.torch_block.encode_blocks`` and
    ``ops.torch_decode.decode_blocks`` or the ShardedFrameCodec
    pipeline -- this class is the single-block convenience wrapper.
    ``device="cpu"`` must be asked for and runs the kernels' plain
    PyTorch versions.
    """

    def __init__(self, block_capacity: int = 65536, level: int = 1,
                 device="cuda"):
        from ..parallel.device import resolve_device
        self.block_capacity = block_capacity
        self.level = level
        self.device = resolve_device(device)

    def compress(self, data, max_output=None):
        import numpy as np
        from ..errors import OutputTooSmall
        from ..ops.torch_block import level_params, make_block_encoder
        data = bytes(data)
        if len(data) > self.block_capacity:
            raise ValueError(
                f"block {len(data)} exceeds capacity {self.block_capacity}")
        buf = np.zeros(self.block_capacity, np.uint8)
        buf[:len(data)] = np.frombuffer(data, np.uint8)
        out, n = make_block_encoder(self.block_capacity,
                                    *level_params(self.level),
                                    device=self.device)(buf, len(data))
        comp = out[:int(n)].cpu().numpy().tobytes()
        if max_output is not None and len(comp) > max_output:
            raise OutputTooSmall(f"{len(comp)} > {max_output}")
        return comp

    def decompress(self, comp, max_output_size):
        from ..errors import CorruptedData, OutputTooSmall
        from ..ops.torch_decode import (MAX_SEQS, make_block_decoder,
                                        parse_sequences, seqs_to_arrays)
        comp = bytes(comp)
        cap = self.block_capacity
        seqs = parse_sequences(comp)
        if len(seqs) > MAX_SEQS(cap):
            raise CorruptedData(
                f"block decodes to more than the capacity {cap}")
        out, n = make_block_decoder(cap, device=self.device)(
            comp, *seqs_to_arrays(seqs, MAX_SEQS(cap)))
        res = out[:int(n)].cpu().numpy().tobytes()
        if len(res) > max_output_size:
            raise OutputTooSmall(f"{len(res)} > {max_output_size}")
        return res


def get_codec(level: int | str = 0) -> BlockCodec:
    """Level dispatch mirroring the frame layer's rules
    (reference: src/lz4f.zig:393-404): <= 0 fast, >= 1 HC; "cuda" or
    "cuda<level>" for the device family."""
    if level == "cuda":
        return CUDACodec()
    if isinstance(level, str) and level.startswith("cuda"):
        return CUDACodec(level=int(level[4:] or 1))
    level = int(level)
    if level <= 0:
        return FastCodec(1 - level)
    return HCCodec(level)
