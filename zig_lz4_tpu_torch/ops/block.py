"""LZ4 block codec -- canonical (oracle) implementation.

This is the framework's *specification by construction*: a bit-exact,
pure-Python/bytes implementation of the LZ4 block wire format.  Every
accelerated backend (C++ native, JAX/XLA vectorized, Pallas kernels)
must produce byte-identical output to this module for compression and
byte-identical round-trips for decompression; tests enforce that.

Capability parity with the reference:
  * ``compress_fast`` / ``compress_default``   (reference: src/lz4.zig:283-447)
  * ``compress_bound``                          (reference: src/lz4.zig:80-83)
  * ``compress_dest_size``                      (reference: src/lz4.zig:551-616)
  * ext-state variants (caller-owned hash table)(reference: src/lz4.zig:524-546)
  * ``decompress_safe`` + partial + dict variants, all built on one
    generic decode engine                        (reference: src/lz4.zig:89-259)

Documented divergences from the reference (all wire-valid, ratio >=):
  1. Acceleration skip uses the C-reference semantics
     (``step = searchMatchNb++ >> SKIP_TRIGGER`` with
     ``searchMatchNb = accel << SKIP_TRIGGER``).  The Zig port's loop
     (src/lz4.zig:318-334) stalls ~64 probes at each search start
     because ``step`` starts at ``searchMatchNb >> 6 == 0``.
  2. The hash table stores ``position + 1`` (0 = empty) so position 0
     participates in matching; the reference loses position 0
     (src/lz4.zig:263-277 sentinel comment).
  3. Matches are extended *backward* into the pending literal run
     (the C reference's "catch-up"); the Zig port does not.  Strictly
     improves ratio.
  4. After emitting a match we insert the hash of ``ip - 2`` and then
     re-probe at ``ip`` immediately (C-reference behavior); the Zig
     port inserts at ``ip`` and skips one byte (src/lz4.zig:437-442).
  5. Partial decompression clamps copies at the target and returns
     exactly ``min(target, full_size)`` bytes (C semantics).  The
     reference errors mid-sequence instead (src/lz4.zig:89-251 bounds
     checks) -- its partial-decode test never runs (orphaned suite).
``compress_dest_size`` keeps the reference's observable behavior (the
largest source prefix whose compressed form fits, found by binary
search over prefix recompressions, reference: src/lz4.zig:551-616).

True 64KB-window streaming (unlike the reference fast stream, which is
effectively block-independent -- see SURVEY.md section 2.1) is built on
top of ``_compress_sequences`` in ``stream.py``.
"""

from __future__ import annotations

import re

from ..constants import (
    ACCELERATION_MAX,
    HASH_PRIME,
    HASH_SIZE_U32,
    HASHLOG,
    LASTLITERALS,
    LZ4_DISTANCE_MAX,
    LZ4_MAX_INPUT_SIZE,
    MFLIMIT,
    MINMATCH,
    ML_MASK,
    RUN_MASK,
    SKIP_TRIGGER,
    compress_bound,
)
from ..errors import CorruptedData, InputTooLarge, OutputTooSmall
from ..native import native_scan_tail

__all__ = [
    "compress_bound",
    "compress_default",
    "compress_fast",
    "compress_fast_ext_state",
    "compress_dest_size",
    "decompress_safe",
    "decompress_safe_partial",
    "decompress_safe_using_dict",
    "decompress_safe_partial_using_dict",
    "HashTable",
    "sizeof_state",
    "concat_streams",
]

_M32 = 0xFFFFFFFF


def _hash4(seq32: int) -> int:
    """Fibonacci hash of a 4-byte little-endian sequence.

    reference: src/lz4.zig:73-77 (``(seq * 2654435761) >> (32 - HASHLOG)``).
    """
    return ((seq32 * HASH_PRIME) & _M32) >> (32 - HASHLOG)


class HashTable:
    """Caller-owned compressor state (ext-state API).

    reference: src/lz4.zig:263-277 and the ext-state entry points at
    src/lz4.zig:524-546.  Entries store ``position + 1``; 0 is empty.
    """

    __slots__ = ("table",)

    def __init__(self):
        self.table = [0] * HASH_SIZE_U32

    def reset(self) -> None:
        t = self.table
        for i in range(HASH_SIZE_U32):
            t[i] = 0


def sizeof_state() -> int:
    """Size in bytes of the ext-state buffer (reference: src/lz4.zig:524)."""
    return HASH_SIZE_U32 * 4


def _count_match(src, ip: int, ref: int, limit: int) -> int:
    """Length of the common run src[ip..] == src[ref..], capped at limit.

    Chunked slice comparison (bytes compare at C speed), then a binary
    narrow on the first differing chunk -- the vector analog of the
    C reference's 8-byte XOR + ctz loop.
    """
    n = 0
    # wide chunks
    chunk = 512
    while chunk >= 4:
        while ip + n + chunk <= limit and \
                src[ip + n:ip + n + chunk] == src[ref + n:ref + n + chunk]:
            n += chunk
        chunk >>= 3
    while ip + n < limit and src[ip + n] == src[ref + n]:
        n += 1
    return n


def _emit_length(out: bytearray, length: int) -> None:
    """Emit the 255-continuation extension bytes for a length >= 15."""
    length -= RUN_MASK
    while length >= 255:
        out.append(255)
        length -= 255
    out.append(length)


def _emit_literals_only(src, out: bytearray, start: int, end: int) -> None:
    """Emit a final literal-only run (token + length + bytes).

    reference: src/lz4.zig:449-519 (compressAsLiterals / finishCompression).
    """
    lit_len = end - start
    if lit_len >= RUN_MASK:
        out.append(RUN_MASK << 4)
        _emit_length(out, lit_len)
    else:
        out.append(lit_len << 4)
    out += src[start:end]


def _compress_sequences(src, table, base: int, start: int,
                        acceleration: int, out: bytearray,
                        max_output: int | None = None,
                        window_floor: int = 0) -> None:
    """Core greedy match-find + sequence-emit loop over ``src[start:]``.

    ``src``   -- the full match window (possibly history + new data).
    ``table`` -- hash table list storing (base + position + 1).
    ``base``  -- global offset of src[0] (for streaming; 0 one-shot).
    ``start`` -- index in src where emission begins (history boundary).
    ``window_floor`` -- smallest src index matches may reference.

    Positions below ``start`` act as dictionary/history: matched but
    never emitted as literals.  This implements *true* sliding-window
    streaming, unlike the reference fast stream (SURVEY.md 2.1).
    """
    n = len(src)
    accel = min(max(acceleration, 1), ACCELERATION_MAX)
    anchor = start
    ip = start + 1 if start == 0 else start
    mflimit = n - MFLIMIT          # positions < mflimit may start a search
    match_limit = n - LASTLITERALS

    if n - start == 0:
        return
    if n - start < MFLIMIT + 1 or mflimit <= ip:
        _emit_literals_only(src, out, anchor, n)
        _check_budget(out, max_output)
        return

    from_bytes = int.from_bytes

    while True:
        # --- search for a match ---
        step = 1
        search_match_nb = accel << SKIP_TRIGGER
        cand = -1
        while True:
            if ip >= mflimit:
                _emit_literals_only(src, out, anchor, n)
                _check_budget(out, max_output)
                return
            seq = from_bytes(src[ip:ip + 4], "little")
            h = _hash4(seq)
            entry = table[h]
            table[h] = base + ip + 1
            if entry:
                cand = entry - 1 - base   # src-local candidate index
                if (cand >= window_floor and
                        cand + LZ4_DISTANCE_MAX >= ip and
                        cand < ip and
                        from_bytes(src[cand:cand + 4], "little") == seq):
                    break
            ip += step
            step = search_match_nb >> SKIP_TRIGGER
            search_match_nb += 1

        # --- backward extension (catch-up) ---
        while ip > anchor and cand > window_floor and src[ip - 1] == src[cand - 1]:
            ip -= 1
            cand -= 1

        # --- match length ---
        mlen = MINMATCH + _count_match(src, ip + MINMATCH, cand + MINMATCH,
                                       match_limit)

        # --- emit sequence ---
        lit_len = ip - anchor
        token_pos = len(out)
        out.append(0)
        if lit_len >= RUN_MASK:
            out[token_pos] = RUN_MASK << 4
            _emit_length(out, lit_len)
        else:
            out[token_pos] = lit_len << 4
        out += src[anchor:ip]
        offset = ip - cand
        out.append(offset & 0xFF)
        out.append(offset >> 8)
        ml_token = mlen - MINMATCH
        if ml_token >= ML_MASK:
            out[token_pos] |= ML_MASK
            _emit_length(out, ml_token)
        else:
            out[token_pos] |= ml_token
        _check_budget(out, max_output)

        ip += mlen
        anchor = ip
        if ip >= mflimit:
            _emit_literals_only(src, out, anchor, n)
            _check_budget(out, max_output)
            return

        # --- re-seed table at ip-2 and fall through to re-probe at ip ---
        seq2 = from_bytes(src[ip - 2:ip + 2], "little")
        table[_hash4(seq2)] = base + ip - 1


def _check_budget(out: bytearray, max_output: int | None) -> None:
    if max_output is not None and len(out) > max_output:
        raise OutputTooSmall(
            f"compressed output {len(out)} exceeds budget {max_output}")


def compress_fast(src, acceleration: int = 1,
                  max_output: int | None = None) -> bytes:
    """Compress one LZ4 block (fast mode).

    reference: src/lz4.zig:292-447.  Raises ``InputTooLarge`` over
    LZ4_MAX_INPUT_SIZE and ``OutputTooSmall`` if ``max_output`` is
    given and exceeded.  Empty input compresses to 0 bytes
    (reference: src/lz4.zig:299-300).
    """
    src = bytes(src)
    n = len(src)
    if n > LZ4_MAX_INPUT_SIZE:
        raise InputTooLarge(f"input {n} > {LZ4_MAX_INPUT_SIZE}")
    if n == 0:
        return b""
    out = bytearray()
    if n < MFLIMIT + 1:
        _emit_literals_only(src, out, 0, n)
        _check_budget(out, max_output)
        return bytes(out)
    table = [0] * HASH_SIZE_U32
    _compress_sequences(src, table, 0, 0, acceleration, out, max_output)
    return bytes(out)


def compress_default(src, max_output: int | None = None) -> bytes:
    """reference: src/lz4.zig:283-286 (acceleration = 1)."""
    return compress_fast(src, 1, max_output)


def compress_fast_ext_state(state: HashTable, src, acceleration: int = 1,
                            max_output: int | None = None) -> bytes:
    """Compress using a caller-owned state (reference: src/lz4.zig:524-546).

    The state is reset before use, matching the reference ext-state
    entry point.
    """
    state.reset()
    src = bytes(src)
    n = len(src)
    if n > LZ4_MAX_INPUT_SIZE:
        raise InputTooLarge(f"input {n} > {LZ4_MAX_INPUT_SIZE}")
    if n == 0:
        return b""
    out = bytearray()
    if n < MFLIMIT + 1:
        _emit_literals_only(src, out, 0, n)
        _check_budget(out, max_output)
        return bytes(out)
    _compress_sequences(src, state.table, 0, 0, acceleration, out, max_output)
    return bytes(out)


def compress_dest_size(src, target_dst_size: int) -> tuple[bytes, int]:
    """Compress as much of ``src`` as fits in ``target_dst_size`` bytes.

    Returns ``(compressed, src_bytes_consumed)``.
    reference: src/lz4.zig:551-616 (which binary-searches prefix
    recompressions; we keep that observable behavior -- the largest
    prefix whose compressed form fits -- via the same search, since it
    is the simplest implementation whose result is reproducible).
    """
    src = bytes(src)
    if target_dst_size <= 0:
        return b"", 0
    # Fast path: everything fits.
    try:
        full = compress_default(src, max_output=target_dst_size)
        return full, len(src)
    except OutputTooSmall:
        pass
    lo, hi = 0, len(src)          # lo = known-fitting prefix length
    best = b""
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            c = compress_default(src[:mid], max_output=target_dst_size)
            best, lo = c, mid
        except OutputTooSmall:
            hi = mid - 1
    return best, lo


def _decompress_generic(src, out_capacity: int, target: int | None,
                        prefix: bytes, ext_dict: bytes) -> bytes:
    """Single decode engine for every public decompress variant.

    reference: src/lz4.zig:89-251 (decompressGeneric).  ``prefix`` is
    the already-decoded streaming history immediately preceding the
    output; ``ext_dict`` is a non-contiguous external dictionary that
    logically precedes the prefix.  Partial decode (``target`` not
    None) clamps at the target (divergence 5 in the module docstring).
    """
    src = bytes(src)
    if len(src) == 0:
        return b""
    if out_capacity == 0:
        return b""
    full_target = out_capacity if target is None else min(target, out_capacity)

    out = bytearray()
    ip = 0
    iend = len(src)
    plen = len(prefix)
    dlen = len(ext_dict)

    while True:
        if ip >= iend:
            break
        token = src[ip]
        ip += 1

        # --- literal run ---
        lit_len = token >> 4
        if lit_len == RUN_MASK:
            while True:
                if ip >= iend:
                    raise CorruptedData("truncated literal length")
                s = src[ip]
                ip += 1
                lit_len += s
                if s != 255:
                    break
        if lit_len:
            if ip + lit_len > iend:
                raise CorruptedData("literal run overruns input")
            room = full_target - len(out)
            if lit_len > room:
                if target is None:
                    raise OutputTooSmall("literals overflow output")
                out += src[ip:ip + room]
                return bytes(out)
            out += src[ip:ip + lit_len]
            ip += lit_len

        if ip >= iend:
            break       # last sequence carries no match

        # --- offset ---
        if ip + 2 > iend:
            raise CorruptedData("truncated offset")
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0:
            raise CorruptedData("zero offset")

        # --- match length ---
        mlen = token & ML_MASK
        if mlen == ML_MASK:
            while True:
                if ip >= iend:
                    raise CorruptedData("truncated match length")
                s = src[ip]
                ip += 1
                mlen += s
                if s != 255:
                    break
        mlen += MINMATCH

        op = len(out)
        room = full_target - op
        clamped = False
        if mlen > room:
            if target is None:
                raise OutputTooSmall("match overflows output")
            clamped = True

        if offset <= op:
            # Match entirely within current output.
            mpos = op - offset
            take = min(mlen, room)
            if offset >= take:
                out += out[mpos:mpos + take]
            else:
                pat = bytes(out[mpos:op])
                reps = take // offset + 1
                out += (pat * reps)[:take]
        elif offset <= op + plen:
            # Match starts in the streaming prefix.
            back = offset - op           # bytes into prefix
            take = min(mlen, room)
            from_prefix = min(back, take)
            out += prefix[plen - back:plen - back + from_prefix]
            rest = take - from_prefix
            if rest:
                # continues into current output from position 0
                _overlap_extend(out, op + from_prefix, rest, offset)
        elif offset <= op + plen + dlen:
            # Match starts in the external dictionary.
            back = offset - op - plen    # bytes into ext dict
            take = min(mlen, room)
            from_dict = min(back, take)
            out += ext_dict[dlen - back:dlen - back + from_dict]
            rest = take - from_dict
            if rest:
                # continues into prefix then current output
                cur = len(out)
                remaining_prefix = prefix
                from_prefix = min(len(remaining_prefix), rest)
                out += remaining_prefix[:from_prefix]
                rest -= from_prefix
                if rest:
                    _overlap_extend(out, cur + from_prefix, rest, offset)
        else:
            raise CorruptedData(
                f"offset {offset} beyond decoded data ({op}+{plen}+{dlen})")

        if clamped:
            return bytes(out)

    return bytes(out)


def _overlap_extend(out: bytearray, op: int, count: int, offset: int) -> None:
    """Continue a match copy that wrapped from history into ``out``.

    Copies ``count`` bytes to the end of ``out`` reading from
    ``out[pos - offset]`` semantics where history has already been
    materialized into ``out`` -- i.e. plain self-referential copy
    starting at out index (op - offset ... ) == 0 boundary handled by
    caller; here source index is (len(out) - offset) per byte, which
    for offset >= 1 is the standard overlap pattern copy.
    """
    src_start = len(out) - offset
    if src_start < 0:
        raise CorruptedData("match underruns output during spanning copy")
    if offset >= count:
        out += out[src_start:src_start + count]
    else:
        pat = bytes(out[src_start:len(out)])
        reps = count // offset + 1
        out += (pat * reps)[:count]


def decompress_safe(src, max_output_size: int) -> bytes:
    """Full-block safe decompression (reference: src/lz4.zig:257-259)."""
    return _decompress_generic(src, max_output_size, None, b"", b"")


def decompress_safe_partial(src, target_output_size: int,
                            max_output_size: int | None = None) -> bytes:
    """Decode at most ``target_output_size`` bytes
    (reference: src/lz4.zig:619-621; C-style clamp semantics)."""
    cap = target_output_size if max_output_size is None else max_output_size
    return _decompress_generic(src, cap, target_output_size, b"", b"")


def decompress_safe_using_dict(src, max_output_size: int, dict_: bytes) -> bytes:
    """Decode with an external dictionary (reference: src/lz4.zig:960-964)."""
    return _decompress_generic(src, max_output_size, None, b"", bytes(dict_))


def decompress_safe_partial_using_dict(src, target_output_size: int,
                                       max_output_size: int,
                                       dict_: bytes) -> bytes:
    """reference: src/lz4.zig:967-970."""
    return _decompress_generic(src, max_output_size, target_output_size,
                               b"", bytes(dict_))


# --- stream stitching (device big-window encode support) ---------------

def _scan_tail(part: bytes):
    """Split a valid LZ4 block stream into (body, tail_literals).

    The final sequence of a block stream is literals-only (token with
    no offset field) -- a form only valid at end-of-block.  Returns
    the stream up to (excluding) that tail sequence's header, plus the
    tail's literal bytes.  A stream ending exactly on a match returns
    (part, b"").  Raises ``CorruptedData`` on a stream cut inside a
    sequence."""
    ip, n = 0, len(part)
    try:
        while ip < n:
            tok_pos = ip
            token = part[ip]
            ip += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    x = part[ip]
                    ip += 1
                    lit += x
                    if x != 255:
                        break
            lit_start = ip
            ip += lit
            if ip == n:                       # literals-only tail
                return part[:tok_pos], part[lit_start:]
            ip += 2                           # offset
            ml = token & 15
            if ml == 15:
                while True:
                    x = part[ip]
                    ip += 1
                    ml += x
                    if x != 255:
                        break
    except IndexError:                    # cut inside a length
        ip = n + 1
    if ip > n:                            # or inside literals or offset
        raise CorruptedData("block stream cut inside a sequence")
    return part, b""


def _tail(part: bytes) -> tuple[int, int, int]:
    """(token position, literals start, literal count) of a stream's
    literals-only tail sequence, ``(n, n, 0)`` where it ends on a match:
    natively where the runtime loaded, else by ``_scan_tail``."""
    got = native_scan_tail(part)
    if got is None:
        body, tail = _scan_tail(part)
        got = len(body), len(part) - len(tail), len(tail)
    return got


_FF_RUN = re.compile(rb"\xff*")


def _first_run(part: bytes) -> tuple[int, int]:
    """(literal count, header length) of a stream's first sequence."""
    lit = part[0] >> 4
    if lit < 15:
        return lit, 1
    end = _FF_RUN.match(part, 1).end()       # the 255s of the run's length
    if end >= len(part):
        raise CorruptedData("block stream cut inside a sequence")
    return lit + 255 * (end - 1) + part[end], end + 1


def _emit_run_header(lit_len: int, ml_nibble: int) -> bytes:
    if lit_len < 15:
        return bytes(((lit_len << 4) | ml_nibble,))
    rem = lit_len - 15
    return (bytes(((15 << 4) | ml_nibble,)) + b"\xff" * (rem // 255)
            + bytes((rem % 255,)))


def _concat(parts) -> tuple[bytes, int]:
    """``concat_streams(parts)``, and the number of parts whose tail it
    scanned."""
    # an empty part and a part of one empty sequence add nothing
    parts = [p for p in map(bytes, parts) if p and p != b"\x00"]
    if len(parts) <= 1:
        return (parts[0] if parts else b""), 0
    out, pending, npend = [], [], 0
    for part in parts[:-1]:
        tok, start, lit = _tail(part)
        view = memoryview(part)
        if tok:                               # a body: pending folds in
            if npend:
                first, h = _first_run(part)
                out += [_emit_run_header(first + npend, part[0] & 15),
                        *pending, view[h:tok]]
            else:
                out.append(view[:tok])
            pending, npend = [], 0
        if lit:                               # all-literal parts cascade
            pending.append(view[start:start + lit])
            npend += lit
    last = parts[-1]                          # its tail never moves
    if npend:
        first, h = _first_run(last)
        out += [_emit_run_header(first + npend, last[0] & 15), *pending,
                memoryview(last)[h:]]
    else:
        out.append(last)
    return b"".join(out), len(parts) - 1


def concat_streams(parts) -> bytes:
    """Concatenate LZ4 block streams into ONE valid block stream.

    Used by the device encoder's big-window path: 1MB/4MB frame
    blocks encode as independent 256KB sub-spans (each with its 64KB
    history prefix in-window), and their streams concatenate into one
    spec-conformant block.  Each part's literals-only tail sequence is
    only valid at end-of-block, so every boundary folds the left
    part's tail literals into the right part's first sequence's
    literal run -- offsets are output-relative and unaffected; only
    literal-run headers are rewritten.  reference wire format:
    src/lz4.zig:89-251 (sequence grammar).

    Only the tails that move are found: those of every part but the
    last (natively where the runtime loaded), and one part comes back
    as it is.  The parts are block streams as an encoder writes them:
    a tail's literal run in its shortest header, with a match-length
    nibble of 0.
    """
    return _concat(parts)[0]
