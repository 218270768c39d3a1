"""Version API.

The reference re-exports a version API that is never actually defined
(reference: src/root.zig:38-44 re-exports ``lz4.versionNumber`` etc.,
but src/lz4.zig never defines them -- a latent compile error behind
Zig's lazy analysis; src/test_streaming.zig:146-152 expects 1.10.0 /
11000).  This module defines it for real, matching the values the
reference's orphaned test expects, plus this framework's own version.
"""

# Wire/algorithm compatibility version (upstream LZ4 versioning scheme).
VERSION_MAJOR = 1
VERSION_MINOR = 10
VERSION_RELEASE = 0

#: Framework's own release version.
FRAMEWORK_VERSION = "0.1.0"


def version_number() -> int:
    """LZ4-style version number: major*10000 + minor*100 + release."""
    return VERSION_MAJOR * 100 * 100 + VERSION_MINOR * 100 + VERSION_RELEASE


def version_string() -> str:
    return f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_RELEASE}"
