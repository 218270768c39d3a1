#!/usr/bin/env python3
"""Time the port's main path at one level and block size, for comparing
two checkouts.

Host-bound times move between machines and between processes, so two
versions of the port are compared only inside one call on one card, in
turns.  Unpack the other commit into a directory (``git archive``) and
run this file from each checkout's root, which is put first on the
module path:

    cd other_checkout && python3 /path/to/time_main_path.py [level] [block]
    cd this_checkout && python3 time_main_path.py [level] [block]

It compresses and decompresses the bench's 48 MB corpus in independent
blocks of ``block`` bytes (``64KB``, the default, ``256KB``, ``1MB`` or
``4MB``) at ``level`` (default 9; 0-12) on one CUDA device and prints,
for two rounds, the median and range of 5 runs of each call in
milliseconds between CUDA events.  It uses only what every version of
the port has: ``ShardedFrameCodec`` (with ``block_size_id``),
``frame.BlockSizeID`` and ``corpus.make_corpus``.
"""

import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from zig_lz4_tpu_torch import ShardedFrameCodec  # noqa: E402
from zig_lz4_tpu_torch import frame as lz4f  # noqa: E402
from zig_lz4_tpu_torch.corpus import make_corpus  # noqa: E402

BLK = 65536
REPS = 5


def cuda_ms(fn):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    level = int(sys.argv[1]) if len(sys.argv) > 1 else 9
    block = sys.argv[2] if len(sys.argv) > 2 else "64KB"
    data = make_corpus(48)
    data = data[:len(data) - len(data) % (BLK * 64)]
    codec = ShardedFrameCodec(compression_level=level, device="cuda",
                              block_size_id=lz4f.BlockSizeID[f"max{block}"])
    frame = codec.compress_frame(data)
    if codec.decompress_frame(frame) != data:
        print("round trip differs", file=sys.stderr)
        return 1
    for rnd in range(2):
        enc = [cuda_ms(lambda: codec.compress_frame(data))
               for _ in range(REPS)]
        dec = [cuda_ms(lambda: codec.decompress_frame(frame))
               for _ in range(REPS)]
        print(f"{os.getcwd()} level {level}, {block} blocks, round {rnd}: "
              f"compress_frame "
              f"{statistics.median(enc):.2f} ms ({min(enc):.2f}-"
              f"{max(enc):.2f}), decompress_frame "
              f"{statistics.median(dec):.2f} ms ({min(dec):.2f}-"
              f"{max(dec):.2f}) on {torch.cuda.get_device_name(0)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
