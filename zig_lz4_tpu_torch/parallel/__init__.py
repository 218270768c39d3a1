from .device import resolve_device
from .mesh import blocks_mesh, local_device_count
from .sharded import ShardedFrameCodec

__all__ = ["blocks_mesh", "local_device_count", "resolve_device",
           "ShardedFrameCodec"]


def __getattr__(name):
    if name == "MultiHostFrameCodec":
        from .multihost import MultiHostFrameCodec
        return MultiHostFrameCodec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
