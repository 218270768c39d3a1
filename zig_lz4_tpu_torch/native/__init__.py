"""C++ native host runtime loader.

Compiles ``native/lz4tpu_native.cpp`` with ``g++`` to a shared library
at first use, into the package's ``_build/`` directory (never beside
the source), and exposes ctypes wrappers.  The host codec paths degrade
to the pure-Python oracle when a compiler is unavailable (set
ZIG_LZ4_TPU_NO_NATIVE=1 to force that).  On the device side
independent frames of blocks up to 64 KB then decode through the
sequence-rebuild kernel; linked frames and larger blocks, which need
the T-map resolvers, raise instead.

The native codec is bit-identical to the oracle (tests enforce it);
it exists so frame serialization, checksums and the decode-path
sequence parsing run at memory bandwidth on the host while the device
does the vectorized heavy lifting.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lz4tpu_native.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "liblz4tpu_native.so")

_lib = None
#: (key, arrays) cache for native_resolve_blocks output buffers
_resolve_bufs = None
#: bumped on every reuse-mode resolve (stale-view guard rail)
_resolve_gen = 0


def resolve_generation() -> int:
    """Generation counter of the shared resolve-buffer cache: views
    returned by a reuse-mode ``native_resolve_blocks`` call are valid
    only while this counter equals its value at call time."""
    return _resolve_gen
_lock = threading.Lock()
_tried = False


def _build() -> bool:
    # several processes may build at once: each writes its own file and
    # renames it into place
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-pthread", "-o", tmp, _SRC]
    try:
        os.makedirs(_BUILD, exist_ok=True)
        r = subprocess.run(cmd, capture_output=True, timeout=240)
        if r.returncode != 0:
            # retry without -march=native (portability)
            cmd.remove("-march=native")
            r = subprocess.run(cmd, capture_output=True, timeout=240)
        if r.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ZIG_LZ4_TPU_NO_NATIVE"):
            return None
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)

        lib.lz4tpu_xxh32.restype = ctypes.c_uint32
        lib.lz4tpu_xxh32.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]

        lib.lz4tpu_compress_fast.restype = ctypes.c_int64
        lib.lz4tpu_compress_fast.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, ctypes.c_int]

        lib.lz4tpu_compress_window.restype = ctypes.c_int64
        lib.lz4tpu_compress_window.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
            u8p, ctypes.c_size_t, i64p, ctypes.c_int64, ctypes.c_int64]

        lib.lz4tpu_decompress_generic.restype = ctypes.c_int64
        lib.lz4tpu_decompress_generic.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, ctypes.c_int64,
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]

        lib.lz4tpu_decompress_safe.restype = ctypes.c_int64
        lib.lz4tpu_decompress_safe.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]

        lib.lz4tpu_parse_sequences.restype = ctypes.c_int64
        lib.lz4tpu_parse_sequences.argtypes = [
            u8p, ctypes.c_size_t, i32p, i32p, i32p, i32p, ctypes.c_size_t,
            ctypes.c_size_t]

        lib.lz4tpu_parse_blocks.restype = ctypes.c_int64
        lib.lz4tpu_parse_blocks.argtypes = [
            u8p, i64p, i64p, ctypes.c_size_t, i32p, i32p, i32p, i32p,
            i32p, ctypes.c_size_t, ctypes.c_size_t]

        lib.lz4tpu_scan_tail.restype = ctypes.c_int64
        lib.lz4tpu_scan_tail.argtypes = [
            u8p, ctypes.c_size_t, i64p, i64p, i64p]

        lib.lz4tpu_resolve_blocks.restype = ctypes.c_int64
        lib.lz4tpu_resolve_blocks.argtypes = [
            u8p, i64p, i64p, ctypes.c_size_t, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, ctypes.c_size_t, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]

        lib.lz4tpu_resolve_tmap.restype = ctypes.c_int64
        lib.lz4tpu_resolve_tmap.argtypes = [
            u8p, i64p, i64p, ctypes.c_size_t, i32p, ctypes.c_int64,
            i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]

        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.lz4tpu_resolve_tmap_linked.restype = ctypes.c_int64
        lib.lz4tpu_resolve_tmap_linked.argtypes = [
            u8p, i64p, i64p, i64p, i8p, ctypes.c_size_t,
            ctypes.c_int64, ctypes.c_int64, i32p, ctypes.c_int64,
            i64p, ctypes.c_int64]

        lib.lz4tpu_compress_blocks.restype = ctypes.c_int64
        lib.lz4tpu_compress_blocks.argtypes = [
            u8p, ctypes.c_size_t, i64p, ctypes.c_size_t, u8p,
            ctypes.c_size_t, i64p, ctypes.c_int]

        lib.lz4tpu_decompress_blocks.restype = ctypes.c_int64
        lib.lz4tpu_decompress_blocks.argtypes = [
            u8p, i64p, i64p, ctypes.c_size_t, u8p, ctypes.c_size_t, i64p,
            ctypes.c_int32]

        lib.lz4tpu_compress_hc.restype = ctypes.c_int64
        lib.lz4tpu_compress_hc.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, ctypes.c_int]

        lib.lz4tpu_compress_hc_blocks.restype = ctypes.c_int64
        lib.lz4tpu_compress_hc_blocks.argtypes = [
            u8p, ctypes.c_size_t, i64p, ctypes.c_size_t, u8p,
            ctypes.c_size_t, i64p, ctypes.c_int]

        lib.lz4tpu_compress_hc_window.restype = ctypes.c_int64
        lib.lz4tpu_compress_hc_window.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_size_t, u8p,
            ctypes.c_size_t, ctypes.c_int]

        lib.lz4tpu_hc_stream_create.restype = ctypes.c_void_p
        lib.lz4tpu_hc_stream_create.argtypes = []
        lib.lz4tpu_hc_stream_free.restype = None
        lib.lz4tpu_hc_stream_free.argtypes = [ctypes.c_void_p]
        lib.lz4tpu_hc_stream_reset.restype = None
        lib.lz4tpu_hc_stream_reset.argtypes = [ctypes.c_void_p]
        lib.lz4tpu_hc_stream_compress.restype = ctypes.c_int64
        lib.lz4tpu_hc_stream_compress.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t, ctypes.c_size_t,
            u8p, ctypes.c_size_t, ctypes.c_int]
        lib.lz4tpu_hc_stream_state_size.restype = ctypes.c_int64
        lib.lz4tpu_hc_stream_state_size.argtypes = [ctypes.c_void_p]
        lib.lz4tpu_hc_stream_export.restype = ctypes.c_int64
        lib.lz4tpu_hc_stream_export.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t]
        lib.lz4tpu_hc_stream_import.restype = ctypes.c_int64
        lib.lz4tpu_hc_stream_import.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_size_t]

        _bind_xxh32_stream(lib)
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def _buf(data: bytes):
    return ctypes.cast(ctypes.create_string_buffer(data, len(data)),
                       ctypes.POINTER(ctypes.c_uint8))


def native_xxh32(data: bytes, seed: int = 0) -> int | None:
    lib = _load()
    if lib is None:
        return None
    data = bytes(data)
    arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else \
        (ctypes.c_uint8 * 1)()
    return lib.lz4tpu_xxh32(arr, len(data), seed & 0xFFFFFFFF)


def native_compress_fast(src: bytes, acceleration: int = 1,
                         max_output: int | None = None) -> bytes | None:
    """Returns compressed bytes, or None if native unavailable.
    Raises the block error taxonomy on budget overrun."""
    lib = _load()
    if lib is None:
        return None
    from ..constants import compress_bound
    from ..errors import raise_block_error
    src = bytes(src)
    cap = compress_bound(len(src)) if max_output is None else max_output
    sbuf = (ctypes.c_uint8 * max(len(src), 1)).from_buffer_copy(
        src if src else b"\x00")
    dbuf = (ctypes.c_uint8 * max(cap, 1))()
    r = lib.lz4tpu_compress_fast(sbuf, len(src), dbuf, cap, acceleration)
    if r < 0:
        raise_block_error(-r, "native compress_fast")
    return bytes(dbuf[:r])


def native_decompress(src: bytes, cap: int, target: int | None = None,
                      prefix: bytes = b"", dict_: bytes = b"") -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    from ..errors import raise_block_error
    src = bytes(src)
    sbuf = (ctypes.c_uint8 * max(len(src), 1)).from_buffer_copy(
        src if src else b"\x00")
    dbuf = (ctypes.c_uint8 * max(cap, 1))()
    pbuf = (ctypes.c_uint8 * max(len(prefix), 1)).from_buffer_copy(
        prefix if prefix else b"\x00")
    xbuf = (ctypes.c_uint8 * max(len(dict_), 1)).from_buffer_copy(
        dict_ if dict_ else b"\x00")
    r = lib.lz4tpu_decompress_generic(
        sbuf, len(src), dbuf, cap, -1 if target is None else target,
        pbuf, len(prefix), xbuf, len(dict_))
    if r < 0:
        raise_block_error(-r, "native decompress")
    return bytes(dbuf[:r])


def native_parse_sequences(comp: bytes, nseq_cap: int,
                           history_len: int = 0):
    """Parse a compressed block into numpy sequence arrays, or None.
    Returns (lit, lsrc, ml, off, nseq) as int32 numpy arrays.
    ``history_len`` extends offset validity behind the block."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..errors import raise_block_error
    comp = bytes(comp)
    cbuf = (ctypes.c_uint8 * max(len(comp), 1)).from_buffer_copy(
        comp if comp else b"\x00")
    lit = np.zeros(nseq_cap, np.int32)
    lsrc = np.zeros(nseq_cap, np.int32)
    ml = np.zeros(nseq_cap, np.int32)
    off = np.ones(nseq_cap, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    r = lib.lz4tpu_parse_sequences(
        cbuf, len(comp),
        lit.ctypes.data_as(i32p), lsrc.ctypes.data_as(i32p),
        ml.ctypes.data_as(i32p), off.ctypes.data_as(i32p), nseq_cap,
        history_len)
    if r < 0:
        raise_block_error(-r, "native parse_sequences")
    return lit, lsrc, ml, off, np.int32(r)


def _u8view(buf):
    """Zero-copy uint8 pointer view of bytes/ndarray."""
    import numpy as np
    arr = np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes,
                        bytearray, memoryview)) else np.ascontiguousarray(
        buf, np.uint8)
    if arr.size == 0:
        arr = np.zeros(1, np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def native_parse_blocks(comp, offs, lens, nseq_cap: int,
                        history_len: int = 0):
    """Parse many compressed blocks in one native call (zero-copy).

    comp: concatenated payload bytes/array; offs/lens: int64 arrays
    delimiting each block.  Returns (lit, lsrc, ml, off, nseq) numpy
    arrays of shape [nblocks, nseq_cap] / [nblocks].
    """
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..errors import raise_block_error
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    nb = len(offs)
    lit = np.zeros((nb, nseq_cap), np.int32)
    lsrc = np.zeros((nb, nseq_cap), np.int32)
    ml = np.zeros((nb, nseq_cap), np.int32)
    off = np.ones((nb, nseq_cap), np.int32)
    ns = np.zeros(nb, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    _, cptr = _u8view(comp)
    r = lib.lz4tpu_parse_blocks(
        cptr, offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p), nb,
        lit.ctypes.data_as(i32p), lsrc.ctypes.data_as(i32p),
        ml.ctypes.data_as(i32p), off.ctypes.data_as(i32p),
        ns.ctypes.data_as(i32p), nseq_cap, history_len)
    if r < 0:
        raise_block_error(3, f"native parse_blocks: block {-int(r)-1} "
                          "corrupt")
    return lit, lsrc, ml, off, ns


def native_scan_tail(part):
    """The tail of one block stream (zero-copy), or None without the
    native runtime: ``(tok_pos, lit_start, lit_len)``, the position of
    its final literals-only sequence's token and that sequence's
    literals; ``(n, n, 0)`` for a stream that ends on a match.  Raises
    ``CorruptedData`` on a stream cut inside a sequence."""
    lib = _load()
    if lib is None:
        return None
    arr, ptr = _u8view(part)
    tok, start, lit = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    r = lib.lz4tpu_scan_tail(ptr, len(part), ctypes.byref(tok),
                             ctypes.byref(start), ctypes.byref(lit))
    if r < 0:
        from ..errors import raise_block_error
        raise_block_error(-r, "native scan_tail: stream cut inside a "
                          "sequence")
    return tok.value, start.value, lit.value


def native_compress_hc(src, level: int = 9,
                       max_output: int | None = None) -> bytes | None:
    """One-shot HC compression, bit-identical to ops/hc.compress_hc
    (the oracle; tests enforce parity).  None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..constants import compress_bound
    from ..errors import raise_block_error
    src = bytes(src)
    if not src:
        return b""
    cap = compress_bound(len(src)) if max_output is None else max_output
    sarr = np.frombuffer(src, np.uint8)
    dst = np.zeros(max(cap, 1), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    r = lib.lz4tpu_compress_hc(
        sarr.ctypes.data_as(u8p), len(src),
        dst.ctypes.data_as(u8p), cap, level)
    if r < 0:
        raise_block_error(-r, "native compress_hc")
    return dst[:r].tobytes()


def native_compress_hc_window(window, start: int, level: int = 9,
                              max_output: int | None = None) \
        -> bytes | None:
    """Windowed HC: compress window[start:] against the history
    prefix window[:start] (the StreamHC fast path -- chain tables are
    rebuilt over the <= 128KB window per call).  None if native
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..constants import compress_bound
    from ..errors import raise_block_error
    window = bytes(window)
    n = len(window)
    if start >= n:
        return b""
    cap = (compress_bound(n - start) if max_output is None
           else max_output)
    sarr = np.frombuffer(window, np.uint8)
    dst = np.zeros(max(cap, 1), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    r = lib.lz4tpu_compress_hc_window(
        sarr.ctypes.data_as(u8p), n, start,
        dst.ctypes.data_as(u8p), cap, level)
    if r < 0:
        raise_block_error(-r, "native compress_hc_window")
    return dst[:r].tobytes()


def native_compress_hc_blocks(blocks, lens, level: int = 9):
    """Batched one-shot HC over [nblocks, blk] rows; None if native
    unavailable.  Returns (dst [nblocks, bound], out_lens int64)."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..constants import compress_bound
    from ..errors import raise_block_error
    blocks = np.ascontiguousarray(blocks, np.uint8)
    nb, blk = blocks.shape
    lens = np.ascontiguousarray(lens, np.int64)
    dcap = compress_bound(blk)
    dst = np.zeros((nb, dcap), np.uint8)
    outl = np.zeros(nb, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    r = lib.lz4tpu_compress_hc_blocks(
        blocks.ctypes.data_as(u8p), blk, lens.ctypes.data_as(i64p), nb,
        dst.ctypes.data_as(u8p), dcap, outl.ctypes.data_as(i64p), level)
    if r < 0:
        raise_block_error(1, f"native compress_hc_blocks: blk {-int(r)-1}")
    return dst, outl


def resolver_threads() -> int:
    """Worker-thread count for the batched native entry points:
    LZ4TPU_THREADS env override, else the host's CPU count (blocks
    are independent; resolve/decompress scale near-linearly with
    cores -- on pod hosts this keeps one host feeding many chips)."""
    env = os.environ.get("LZ4TPU_THREADS")
    if env:
        return max(int(env), 1)
    return max(os.cpu_count() or 1, 1)


def native_resolve_blocks(comp, offs, lens, fcap: int,
                          out_cap: int = 4 << 20, hist_len: int = 0,
                          split_max: int = 8, round_limit: int = 4,
                          reuse_buffers: bool = True,
                          n_threads: int | None = None):
    """Resolve many compressed blocks into fragments for the
    round-bounded device decoder (zero-copy in/out).

    A match that would split into more than ``split_max`` fragments
    becomes one PER copy-fragment with a deeper round (up to
    ``round_limit``) instead -- fragment counts stay near the
    sequence count on match-dense data.  ``out_cap`` bounds the
    declared output size (over-cap blocks are marked, like budget
    overflows); ``hist_len`` shifts LIT sources for a
    [history | comp] device fetch buffer (dictionary decode).

    ``n_threads`` (default: resolver_threads()) fans the independent
    blocks over a native thread pool with per-thread scratch; output
    rows are disjoint, so the resolve itself is thread-safe at any
    count.

    WARNING: with ``reuse_buffers`` (the default) the five big
    fragment arrays are views of a module-level cache -- the NEXT
    call with the same (nblocks, fcap) overwrites them in place, and
    concurrent CALLS from multiple Python threads race on that cache
    (the internal worker threads do not).  Consume (or copy /
    device_put) the results before resolving again, or pass
    ``reuse_buffers=False`` to own the arrays (costs
    first-touch page faults at bench scale -- the reason the cache
    exists).  Guard rails: ``resolve_generation()`` returns a counter
    bumped by every reuse-mode call, so defensive callers can
    snapshot it with their views and assert staleness before use;
    setting ``ZIG_LZ4_TPU_RESOLVE_FRESH=1`` forces fresh arrays
    process-wide (debugging aid).

    Returns (fdst, flen, fsrc, fper, fphase [nb, fcap] i32,
    nfrag [nb] i32 (-1 = budget/output-cap overflow for that block),
    rounds [nb] i32, out_lens [nb] i64), or None if native is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..errors import raise_block_error
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    nb = len(offs)
    # Reuse the big fragment arrays across calls: freshly-mmapped
    # np.empty buffers cost first-touch page faults on every call, more
    # than the resolve itself at bench scale.  The device
    # decoder masks rows >= nfrag, so stale contents are harmless.
    global _resolve_bufs, _resolve_gen
    key = (nb, fcap)
    if os.environ.get("ZIG_LZ4_TPU_RESOLVE_FRESH"):
        reuse_buffers = False
    if not reuse_buffers:
        fdst, flen, fsrc, fper, fphase = (
            np.empty((nb, fcap), np.int32) for _ in range(5))
    else:
        _resolve_gen += 1
        if _resolve_bufs is None or _resolve_bufs[0] != key:
            _resolve_bufs = (key,
                             [np.empty((nb, fcap), np.int32)
                              for _ in range(5)])
        fdst, flen, fsrc, fper, fphase = _resolve_bufs[1]
    nfrag = np.zeros(nb, np.int32)
    rounds = np.zeros(nb, np.int32)
    out_lens = np.zeros(nb, np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    _, cptr = _u8view(comp)
    r = lib.lz4tpu_resolve_blocks(
        cptr, offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p), nb,
        fdst.ctypes.data_as(i32p), flen.ctypes.data_as(i32p),
        fsrc.ctypes.data_as(i32p), fper.ctypes.data_as(i32p),
        fphase.ctypes.data_as(i32p), nfrag.ctypes.data_as(i32p),
        rounds.ctypes.data_as(i32p), fcap,
        out_lens.ctypes.data_as(i64p), out_cap, hist_len,
        split_max, round_limit,
        resolver_threads() if n_threads is None else int(n_threads))
    if r < 0:
        raise_block_error(3, f"native resolve_blocks: block {-int(r)-1}"
                          " corrupt")
    return fdst, flen, fsrc, fper, fphase, nfrag, rounds, out_lens


_tmap_bufs = None


def native_resolve_tmap(comp, offs, lens, out_cap: int,
                        hist_len: int = 0, reuse_buffers: bool = True,
                        n_threads: int | None = None):
    """Per-byte literal-source maps for the one-merge device decoder.

    Host-side FULL path compression (round 5): T[b, p] is the fetch
    coordinate ([history | payload] space) whose byte equals output
    byte p of block b -- match heads memcpy the source span's T,
    self-overlap tails period-double, so the fill runs at memcpy
    class and NO LZ77 chains survive to the device (ops/torch_decode
    ``_decode_block_tmap`` is one parity-keyed merge, 100% coverage).

    Same reuse-buffer contract as native_resolve_blocks (the T cache
    is overwritten by the next same-shape call; pass
    reuse_buffers=False to own the array).

    Returns (T [nb, out_cap] int32, out_lens [nb] int64 with -1
    marking blocks that overrun out_cap), or None if native is
    unavailable.  reference decode semantics: src/lz4.zig:89-251."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..errors import raise_block_error
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    nb = len(offs)
    global _tmap_bufs, _resolve_gen
    key = (nb, out_cap)
    if os.environ.get("ZIG_LZ4_TPU_RESOLVE_FRESH"):
        reuse_buffers = False
    if not reuse_buffers:
        T = np.empty((nb, out_cap), np.int32)
    else:
        _resolve_gen += 1
        if _tmap_bufs is None or _tmap_bufs[0] != key:
            _tmap_bufs = (key, np.empty((nb, out_cap), np.int32))
        T = _tmap_bufs[1]
    out_lens = np.zeros(nb, np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    _, cptr = _u8view(comp)
    r = lib.lz4tpu_resolve_tmap(
        cptr, offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p), nb,
        T.ctypes.data_as(i32p), out_cap,
        out_lens.ctypes.data_as(i64p), out_cap, hist_len,
        resolver_threads() if n_threads is None else int(n_threads))
    if r < 0:
        raise_block_error(3, f"native resolve_tmap: block {-int(r)-1}"
                          " corrupt")
    return T, out_lens


def native_resolve_tmap_linked(comp, offs, lens, lit_base, is_raw,
                               dict_len: int, total_cap: int,
                               blk_cap: int, dict_base: int = 0):
    """Frame-contiguous T-map for a LINKED-mode block window.

    Blocks share one T array in global output coordinates and
    history-reaching matches path-compress through earlier blocks' T
    entries, so every byte of the window resolves to STATIC fetch
    data ([window-entry history at dict_base | payloads at
    lit_base[b]]) and device decode is one flat batch-parallel merge
    (ops/torch_decode.linked_tmap_step).  ``is_raw`` marks
    store-uncompressed records (their bytes are fetch data).

    Returns (T int32[total_cap], out_lens int64[nb], total int) or
    None if native is unavailable; raises the block taxonomy on
    corruption.  reference: src/lz4.zig:870-957."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..errors import raise_block_error
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    lit_base = np.ascontiguousarray(lit_base, np.int64)
    is_raw = np.ascontiguousarray(is_raw, np.int8)
    nb = len(offs)
    T = np.empty(total_cap, np.int32)
    out_lens = np.zeros(nb, np.int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    _, cptr = _u8view(comp)
    r = lib.lz4tpu_resolve_tmap_linked(
        cptr, offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p),
        lit_base.ctypes.data_as(i64p), is_raw.ctypes.data_as(i8p), nb,
        dict_base, dict_len, T.ctypes.data_as(i32p), total_cap,
        out_lens.ctypes.data_as(i64p), blk_cap)
    if r < 0:
        raise_block_error(3, f"native resolve_tmap_linked: block "
                          f"{-int(r)-1} corrupt")
    return T, out_lens, int(r)


def native_compress_blocks(blocks, lens, acceleration: int = 1):
    """Compress [nblocks, blk] rows in one native call.

    Returns (dst uint8[nblocks, bound(blk)], out_lens int64[nblocks]).
    """
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..constants import compress_bound
    from ..errors import raise_block_error
    blocks = np.ascontiguousarray(blocks, np.uint8)
    nb, blk = blocks.shape
    lens = np.ascontiguousarray(lens, np.int64)
    dcap = compress_bound(blk)
    dst = np.zeros((nb, dcap), np.uint8)
    outl = np.zeros(nb, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    r = lib.lz4tpu_compress_blocks(
        blocks.ctypes.data_as(u8p), blk, lens.ctypes.data_as(i64p), nb,
        dst.ctypes.data_as(u8p), dcap, outl.ctypes.data_as(i64p),
        acceleration)
    if r < 0:
        raise_block_error(1, f"native compress_blocks: block {-int(r)-1}")
    return dst, outl


def native_decompress_blocks(comp, offs, lens, blk: int,
                             n_threads: int | None = None):
    """Decompress many blocks in one native call, fanned over
    ``n_threads`` workers (default resolver_threads(); rows are
    independent and outputs disjoint, so any count is safe).

    Returns (dst uint8[nblocks, blk], out_lens int64[nblocks]).
    """
    lib = _load()
    if lib is None:
        return None
    import numpy as np
    from ..errors import raise_block_error
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    nb = len(offs)
    dst = np.zeros((nb, blk), np.uint8)
    outl = np.zeros(nb, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    _, cptr = _u8view(comp)
    r = lib.lz4tpu_decompress_blocks(
        cptr, offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p), nb,
        dst.ctypes.data_as(u8p), blk, outl.ctypes.data_as(i64p),
        resolver_threads() if n_threads is None else int(n_threads))
    if r < 0:
        raise_block_error(3, f"native decompress_blocks: block "
                          f"{-int(r)-1}")
    return dst, outl


class NativeStreamTable:
    """Caller-owned 4096-entry int64 hash table for streaming compress."""

    def __init__(self):
        self.arr = (ctypes.c_int64 * 4096)()

    def reset(self):
        ctypes.memset(self.arr, 0, ctypes.sizeof(self.arr))


def native_compress_window(window: bytes, start: int, acceleration: int,
                           table: NativeStreamTable, base: int,
                           window_floor: int = 0,
                           max_output: int | None = None) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    from ..constants import compress_bound
    from ..errors import raise_block_error
    window = bytes(window)
    cap = (compress_bound(len(window) - start)
           if max_output is None else max_output)
    wbuf = (ctypes.c_uint8 * max(len(window), 1)).from_buffer_copy(
        window if window else b"\x00")
    dbuf = (ctypes.c_uint8 * max(cap, 1))()
    r = lib.lz4tpu_compress_window(
        wbuf, len(window), start, acceleration, dbuf, cap,
        ctypes.cast(table.arr, ctypes.POINTER(ctypes.c_int64)),
        base, window_floor)
    if r < 0:
        raise_block_error(-r, "native compress_window")
    return bytes(dbuf[:r])


class NativeHCStream:
    """Persistent native StreamHC context.

    Carries the HC hash/chain (and MID) tables across compress calls
    in global int64 index space -- the reference's StreamHC does the
    same (src/lz4hc.zig:1601-1660); the per-call windowed entry
    (``native_compress_hc_window``) rebuilds them over the <= 128KB
    window every block (~32x redundant insertion at 4KB blocks).
    ``export_state``/``import_state`` give byte-exact checkpoint
    resume.  NOTE: outputs are valid LZ4 with true cross-block
    matching but are NOT byte-identical to the windowed rebuild
    (chain walks may spend attempts on pre-window entries the rebuild
    never stores) -- both backends' outputs cross-decode.
    """

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native backend unavailable")
        self._lib = lib
        self._ptr = lib.lz4tpu_hc_stream_create()

    def __del__(self):                   # pragma: no cover - gc path
        try:
            if getattr(self, "_ptr", None):
                self._lib.lz4tpu_hc_stream_free(self._ptr)
                self._ptr = None
        except Exception:
            pass

    def reset(self):
        self._lib.lz4tpu_hc_stream_reset(self._ptr)

    def compress(self, window, start: int, level: int,
                 max_output: int | None = None) -> bytes:
        """Compress window[start:] against the carried state; the
        caller guarantees window[:start] is the stream's trailing
        history (ops/hc.py StreamHC maintains exactly that)."""
        from ..constants import compress_bound
        from ..errors import raise_block_error
        window = bytes(window)
        n = len(window)
        if start >= n:
            return b""
        cap = (compress_bound(n - start) if max_output is None
               else max_output)
        wbuf = (ctypes.c_uint8 * max(n, 1)).from_buffer_copy(
            window if window else b"\x00")
        dbuf = (ctypes.c_uint8 * max(cap, 1))()
        r = self._lib.lz4tpu_hc_stream_compress(
            self._ptr, wbuf, n, start, dbuf, cap, level)
        if r < 0:
            raise_block_error(-r, "native hc_stream_compress")
        return bytes(dbuf[:r])

    def export_state(self) -> bytes:
        size = self._lib.lz4tpu_hc_stream_state_size(self._ptr)
        buf = (ctypes.c_uint8 * size)()
        r = self._lib.lz4tpu_hc_stream_export(self._ptr, buf, size)
        if r < 0:
            raise RuntimeError("hc stream export failed")
        return bytes(buf[:r])

    def import_state(self, blob: bytes) -> None:
        blob = bytes(blob)
        buf = (ctypes.c_uint8 * max(len(blob), 1)).from_buffer_copy(
            blob if blob else b"\x00")
        r = self._lib.lz4tpu_hc_stream_import(self._ptr, buf, len(blob))
        if r < 0:
            raise ValueError("corrupt hc stream state blob")


class NativeXXH32:
    """Streaming xxh32 backed by the native runtime."""

    def __init__(self, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native backend unavailable")
        self._lib = lib
        size = lib.lz4tpu_xxh32_state_size()
        self._st = ctypes.create_string_buffer(size)
        self.seed = seed & 0xFFFFFFFF
        self.reset()

    def reset(self):
        self._lib.lz4tpu_xxh32_init(self._st, self.seed)

    def update(self, data):
        data = bytes(data)
        if data:
            buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            self._lib.lz4tpu_xxh32_update(self._st, buf, len(data))
        return self

    def digest(self) -> int:
        return self._lib.lz4tpu_xxh32_digest(self._st) & 0xFFFFFFFF


def _bind_xxh32_stream(lib):
    lib.lz4tpu_xxh32_state_size.restype = ctypes.c_size_t
    lib.lz4tpu_xxh32_state_size.argtypes = []
    lib.lz4tpu_xxh32_init.restype = None
    lib.lz4tpu_xxh32_init.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.lz4tpu_xxh32_update.restype = None
    lib.lz4tpu_xxh32_update.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    lib.lz4tpu_xxh32_digest.restype = ctypes.c_uint32
    lib.lz4tpu_xxh32_digest.argtypes = [ctypes.c_char_p]
