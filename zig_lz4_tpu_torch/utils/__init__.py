from .xxhash32 import XXH32, xxh32, xxh32_python

__all__ = ["XXH32", "xxh32", "xxh32_python"]
