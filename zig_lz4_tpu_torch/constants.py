"""LZ4 format constants.

Mirrors the constant set of the reference implementation
(reference: src/lz4.zig:12-44) which itself follows Yann Collet's LZ4
block format specification. These values are fixed by the wire format
and shared by every backend (NumPy oracle, C++ native, JAX/Pallas).
"""

# --- Block format constants (reference: src/lz4.zig:12-44) ---

#: Minimum match length the format can encode.
MINMATCH = 4

#: The last match must start at least this many bytes before block end.
MFLIMIT = 12

#: The last 5 bytes of a block are always literals.
LASTLITERALS = 5

#: Number of bits in the token used for the match length nibble.
ML_BITS = 4

#: Mask for the match-length nibble (15 == extended length follows).
ML_MASK = (1 << ML_BITS) - 1

#: Mask for the literal-run nibble (15 == extended length follows).
RUN_MASK = 15

#: Maximum supported input size for a single block (0x7E000000).
LZ4_MAX_INPUT_SIZE = 0x7E000000

#: Maximum match offset (16-bit offset field).
LZ4_DISTANCE_MAX = 65535

#: Hash table sizing: table bytes = 1 << MEMORY_USAGE.
LZ4_MEMORY_USAGE = 14

#: log2 of the number of hash table entries (u32 entries).
HASHLOG = LZ4_MEMORY_USAGE - 2  # 12 -> 4096 entries

#: Number of entries in the fast-path hash table.
HASH_SIZE_U32 = 1 << HASHLOG

#: Fibonacci hashing multiplier (golden-ratio derived).
HASH_PRIME = 2654435761

#: Default / max acceleration factor for the fast compressor.
ACCELERATION_DEFAULT = 1
ACCELERATION_MAX = 65537

#: Acceleration skip trigger: every (1 << SKIP_TRIGGER) misses, the
#: search step grows by one.  (C reference semantics; the Zig port's
#: step logic stalls ~64 probes at each search start -- an intentional
#: divergence, see docs/DESIGN.md "Divergences".)
SKIP_TRIGGER = 6

# --- Streaming constants ---

#: 64KB sliding window.
WINDOW_SIZE = 65536


def compress_bound(input_size: int) -> int:
    """Worst-case compressed size for a block of ``input_size`` bytes.

    reference: src/lz4.zig:80-83 (``n + n/255 + 16``; 0 if over max).
    """
    if input_size > LZ4_MAX_INPUT_SIZE:
        return 0
    return input_size + input_size // 255 + 16


def decoder_ring_buffer_size(max_block_size: int) -> int:
    """Minimum ring buffer size for streaming decode.

    reference: src/lz4.zig:954-957 (65536 + 14 + maxBlockSize).
    """
    return 65536 + 14 + max_block_size
