"""zig_lz4_tpu_torch -- the LZ4 framework on PyTorch and an NVIDIA H100.

A port of the JAX package beside it, which stays as the reference.
This package is whole on its own: it carries its own host layers --
constants, errors, the frame format, streaming, the block codec oracle,
HC, xxHash32 and the C++ native runtime (whose T-map resolvers the
decoder uses) -- and imports nothing of the reference.  The device work
is done by hand-written CUDA kernels (``kernels/csrc``) behind
``ShardedFrameCodec`` and ``models.CUDACodec``.

The flat facade holds every name of the reference package's own (its
``__init__.py``, after the reference library's ``root.zig:1-57``):
constants, errors, the block functions and the version, with
``lz4f``/``frame``, ``lz4hc``, the ``Stream*`` classes and
``compress_hc`` resolved at first use.

This package imports ``torch`` and never ``jax``.
"""

from . import backend, constants, errors, frame, native, stream, version
from .constants import (
    ACCELERATION_DEFAULT,
    ACCELERATION_MAX,
    LZ4_DISTANCE_MAX,
    LZ4_MAX_INPUT_SIZE,
    LZ4_MEMORY_USAGE,
    MFLIMIT,
    MINMATCH,
    compress_bound,
    decoder_ring_buffer_size,
)
from .errors import (
    BlockError,
    CorruptedData,
    DecompressionFailed,
    FrameError,
    InputTooLarge,
    InvalidState,
    LZ4Error,
    OutputTooSmall,
)
from .models import get_codec
from .ops import block, hc
from .ops.block import (
    HashTable,
    compress_default,
    compress_dest_size,
    compress_fast,
    compress_fast_ext_state,
    decompress_safe,
    decompress_safe_partial,
    decompress_safe_partial_using_dict,
    decompress_safe_using_dict,
    sizeof_state,
)
from .parallel.sharded import ShardedFrameCodec
from .utils import xxhash32
from .version import (
    FRAMEWORK_VERSION,
    VERSION_MAJOR,
    VERSION_MINOR,
    VERSION_RELEASE,
    version_number,
    version_string,
)

__version__ = FRAMEWORK_VERSION

__all__ = ["ShardedFrameCodec", "backend", "block", "compress_bound",
           "constants", "errors", "frame", "get_codec", "hc", "native",
           "stream", "version", "xxhash32"]


def __getattr__(name):
    # importlib.import_module, not ``from . import x``: the latter falls
    # back to getattr on the package and recurses
    import importlib
    if name in ("lz4f", "frame"):
        return importlib.import_module(".frame", __name__)
    if name == "lz4hc":
        return importlib.import_module(".ops.hc", __name__)
    if name in ("Stream", "StreamDecode", "StreamHC"):
        return getattr(importlib.import_module(".stream", __name__), name)
    if name == "compress_hc":
        return importlib.import_module(".ops.hc", __name__).compress_hc
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
