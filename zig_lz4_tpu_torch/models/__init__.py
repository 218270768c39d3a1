from .codec import (
    BlockCodec,
    FastCodec,
    HCCodec,
    CUDACodec,
    get_codec,
)

__all__ = ["BlockCodec", "FastCodec", "HCCodec", "CUDACodec", "get_codec"]
