"""zig_lz4_tpu_torch -- the LZ4 framework on PyTorch and an NVIDIA H100.

A port of the JAX package beside it, which stays as the reference.
This package is whole on its own: it carries its own host layers --
constants, errors, the frame format, streaming, the block codec oracle,
HC, xxHash32 and the C++ native runtime (whose T-map resolvers the
decoder uses) -- and imports nothing of the reference.  The device work
is done by hand-written CUDA kernels (``kernels/csrc``) behind
``ShardedFrameCodec`` and ``models.CUDACodec``.

This package imports ``torch`` and never ``jax``.
"""

from . import backend, constants, errors, frame, native, stream, version
from .constants import compress_bound
from .models import get_codec
from .ops import block, hc
from .parallel.sharded import ShardedFrameCodec
from .utils import xxhash32

__all__ = ["ShardedFrameCodec", "backend", "block", "compress_bound",
           "constants", "errors", "frame", "get_codec", "hc", "native",
           "stream", "version", "xxhash32"]
