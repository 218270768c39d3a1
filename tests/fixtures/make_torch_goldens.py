"""Write the JAX reference's outputs that the port is held to.

The port (zig_lz4_tpu_torch) is compared byte for byte with these:

* ``l9_corpus64k.npz`` -- ``encode_blocks_jax(..., hc=9)`` payloads of
  a few 64 KB ``make_corpus`` blocks (tests/test_torch_encode.py).
  Compiling the JAX encoder at 64 KB windows takes minutes on a CPU.
* ``l9_frames4k.npz`` -- the JAX ``ShardedFrameCodec`` level-9 frames,
  with ``block_size``/``window`` shrunk to 4 KB, of the conftest
  ``corpus`` entries and a multi-block corpus slice
  (tests/test_torch_codec.py).  Each test file that compiles the JAX
  encoder live pays ~1 min of CPU, so the frame test reads these and
  leaves the live 4 KB encoder parity to test_torch_encode.py.

* ``levels4k.npz`` -- ``encode_blocks_jax`` payloads at 4 KB windows of
  the static inputs of tests/test_torch_encode.py (cases, corpus
  slices, history and fuzz rows) for every configuration below level
  9: ``hc=0`` with ``accel`` 1, 2, 4, 8 and ``hc`` 2..8 (eleven JAX
  compiles).
* ``levels_corpus64k.npz`` -- the 64 KB blocks of ``l9_corpus64k.npz``
  at levels 0 and 4.
* ``levels_frames4k.npz`` -- the JAX codec's level-0 and level-5 frames
  of the inputs of ``l9_frames4k.npz``.

* ``deep4k.npz`` -- the static 4 KB inputs again at the deep
  configurations ``(hc, deep)`` = (8, 1), (8, 2), (8, 3) and (4, 1):
  rank tiers, price parse, extension and absorb (levels 10-12 and the
  reference's fuzz configuration).
* ``deep_corpus64k_l{10,11,12}.npz`` -- the 64 KB blocks of
  ``l9_corpus64k.npz`` plus a byte run, a period-300 block, a
  code-like block (matches far over 1024 bytes) and a short text
  window with ``start > 0``, at levels 10, 11 and 12; one group and one
  file per level, since each compiles the JAX encoder at 64 KB.
* ``deep_frames4k.npz`` -- the JAX codec's level-12 frames of the
  inputs of ``l9_frames4k.npz``.
* ``seqdec4k.npz`` -- ``decode_blocks_jax`` (the sequence-rebuild
  decoder) on the level-8 payloads of ``levels4k.npz``: the rows with
  ``start == 0`` without a history, and every row with its history
  right-aligned in a 4 KB window.
* ``wide_deep_corpus.npz`` -- the deep levels at windows over 64 KB:
  ``encode_blocks_jax(..., hc=8, deep=d)`` payloads of the ``WIDE_SETS``
  windows at level 12 at all three widths and at levels 10 and 11 at
  131,072 bytes, with an all-zero window beside the 131,072-byte rows
  at levels 10 and 12 (group ``wide_deep``).
* ``wide_deep_frames.npz`` -- the SHA-256 of the JAX codec's frames of a
  400,000-byte corpus prefix at levels 12 (1 MB blocks; 64 KB blocks
  behind the dictionary) and 10 (256 KB blocks), and the short frames of
  ``WIDE_DEEP_SMALL`` (group ``wide_deep_frames``).
* ``narrow_frames.npz`` -- the SHA-256 of the JAX codec's level-9
  frames at 1 MB blocks of inputs shorter than one sub-span window
  (``NARROW_FRAMES``): single blocks of 48,771, 65,536 and 98,304 corpus
  bytes, one 499,712-byte block (two sub-spans) and 65,536 bytes of
  ``ff_words`` (group ``narrow``).  The port launches such windows
  narrower than the reference's 327,680 bytes (``parallel/sharded.py``,
  ``_sub_width``); these hold it to the reference's frames.
* ``frags4k.npz`` -- the three fragment-ladder decoders
  (``_decode_block_frags``, ``_decode_block_frags_win``,
  ``_decode_block_frags_chase``), jitted and vmapped, on the fragment
  tables of tests/test_torch_frags.py at the configurations that file
  does not run live: ``out`` and, where the function returns it, ``ok``.

Run once from the repository root (needs JAX):

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_goldens.py

or name groups as arguments (``64k``, ``frames4k``, ``levels4k``,
``levels64k``, ``levels_frames4k``, ``deep4k``, ``deep64k_l10``,
``deep64k_l11``, ``deep64k_l12``, ``deep_frames4k``, ``seqdec4k``,
``frags4k``, ``wide``, ``wide_deep``, ``wide_deep_frames``, ``narrow``,
``sort2``);
the groups are independent, so they may run as separate processes side
by side (``seqdec4k`` reads the ``levels4k`` file).
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)

#: make_corpus(CORPUS_MB), 64 KB blocks at these indices: records,
#: random into byte runs, byte runs, text, text into XML, XML, random,
#: code
CORPUS_MB = 2
BLOCKS = (0, 5, 7, 9, 13, 18, 27, 29)
BLK = 65536
OUT = os.path.join(HERE, "l9_corpus64k.npz")
#: frame goldens: 4 KB blocks and windows on both codecs
SMALL = 4096
FRAMES_OUT = os.path.join(HERE, "l9_frames4k.npz")
#: configurations below level 9: name -> (hc, accel)
LEVEL_CONFIGS = {**{f"hc0_a{a}": (0, a) for a in (1, 2, 4, 8)},
                 **{f"hc{h}": (h, 1) for h in range(2, 9)}}
LEVELS4K_OUT = os.path.join(HERE, "levels4k.npz")
#: levels of the 64 KB payload and the 4 KB frame goldens
LEVELS64K = (0, 4)
LEVELS64K_OUT = os.path.join(HERE, "levels_corpus64k.npz")
FRAME_LEVELS = (0, 5)
LEVEL_FRAMES_OUT = os.path.join(HERE, "levels_frames4k.npz")
#: the deep configurations: name -> (hc, deep)
DEEP_CONFIGS = {"hc8_d1": (8, 1), "hc8_d2": (8, 2), "hc8_d3": (8, 3),
                "hc4_d1": (4, 1)}
DEEP4K_OUT = os.path.join(HERE, "deep4k.npz")
DEEP_LEVELS = (10, 11, 12)
DEEP64K_OUT = os.path.join(HERE, "deep_corpus64k_l{}.npz")
DEEP_FRAMES_OUT = os.path.join(HERE, "deep_frames4k.npz")
SEQDEC_OUT = os.path.join(HERE, "seqdec4k.npz")
FRAGS_OUT = os.path.join(HERE, "frags4k.npz")
WIDE_OUT = os.path.join(HERE, "wide_corpus.npz")
#: wide window goldens: name -> (window bytes, [(corpus offset, valid
#: length)], emission start, hc values); a length past the corpus's end
#: is cut to it
WIDE_SETS = {
    "w131k": (131072, [(8 * BLK, 131072), (17 * BLK, 131072)], 65536,
              (9, 0)),
    "w262k": (262144, [(28 * BLK, 262144)], 0, (9,)),
    "w327k": (327680, [(15 * BLK, 327680), (0, 65536 + 70_000)], 65536,
              (9, 0)),
}
#: the frame goldens' input, and the dictionary of the dictionary frame
WIDE_FRAME = slice(0, 1_400_000)
WIDE_DICT = slice(9 * BLK, 9 * BLK + 70_000)
#: frame golden name -> (block size name, level, with the dictionary)
WIDE_FRAMES = {"max1MB_l9": ("max1MB", 9, False),
               "max4MB_l9": ("max4MB", 9, False),
               "max256KB_l0": ("max256KB", 0, False),
               "dict_l9": ("max64KB", 9, True)}
#: the two short frames of test_torch_codec's
#: test_outside_the_slice_raises_not_implemented: name -> (data, block
#: size name, level, dictionary)
WIDE_SMALL = {"small_dict": (b"dictionary encode", "max64KB", 0,
                             b"0123456789" * 10),
              "small_256k": (b"256 KB blocks", "max256KB", 9, None)}
#: the deep levels at windows over 64 KB: WIDE_SETS name -> levels
WIDE_DEEP_OUT = os.path.join(HERE, "wide_deep_corpus.npz")
WIDE_DEEP_LEVELS = {"w131k": (10, 11, 12), "w262k": (12,), "w327k": (12,)}
#: level -> valid length of an all-zero 131,072-byte window that emits
#: from 0, appended to the w131k rows at that level
WIDE_DEEP_ZERO = {10: 1000, 12: 0}
WIDE_DEEP_FRAMES_OUT = os.path.join(HERE, "wide_deep_frames.npz")
#: the deep frame goldens' input: short enough for the plain versions
WIDE_DEEP_FRAME = slice(0, 400_000)
WIDE_DEEP_FRAMES = {"max1MB_l12": ("max1MB", 12, False),
                    "dict_l12": ("max64KB", 12, True),
                    "max256KB_l10": ("max256KB", 10, False)}
#: short deep frames, laid out as WIDE_SMALL: a dictionary of 100 bytes
#: (a window of 65,636 bytes, not a multiple of 32) at levels 10 and 12,
#: 256 KB blocks at level 12, and 9 bytes behind a dictionary and in
#: 4 MB blocks at level 12
WIDE_DEEP_SMALL = {
    "small_dict_l10": (b"dictionary encode", "max64KB", 10,
                       b"0123456789" * 10),
    "small_dict_l12": (b"dictionary encode", "max64KB", 12,
                       b"0123456789" * 10),
    "small_256k_l12": (b"256 KB blocks", "max256KB", 12, None),
    "deep_wide_dict_l12": (b"deep wide", "max64KB", 12, b"d" * 100),
    "deep_wide_4m_l12": (b"deep wide", "max4MB", 12, None)}
#: level-9 frames at 1 MB blocks of inputs shorter than a sub-span
#: window: name -> (make_corpus(CORPUS_MB) offset, length), or (None,
#: length) for ``ff_words(length)``
NARROW_OUT = os.path.join(HERE, "narrow_frames.npz")
NARROW_FRAMES = {"b48771": (3 * BLK, 48_771), "b65536": (18 * BLK, 65_536),
                 "b98304": (29 * BLK, 98_304),
                 "b499712": (4 * BLK, 499_712), "ff65536": (None, 65_536)}
SORT2_OUT = os.path.join(HERE, "sort2_probe.npz")
#: keys of the probe golden: 65,536 from [0, SORT2_RANGE), seed 2
SORT2_RANGE = 64
SORT2_HEAD = 512
#: the "multi" input: 11 blocks of 4 KB across the text/XML boundary
MULTI = slice(13 * BLK, 13 * BLK + 45_000)


def _dense(out, out_len):
    """(out_len int32[B], the payloads back to back)."""
    out, out_len = np.asarray(out), np.asarray(out_len).astype(np.int32)
    return out_len, np.concatenate([out[k, :out_len[k]]
                                    for k in range(len(out_len))])


def _golden_rows(corpus: bytes):
    rows = np.stack([np.frombuffer(corpus[i * BLK:(i + 1) * BLK], np.uint8)
                     for i in BLOCKS])
    return rows, np.full(len(BLOCKS), BLK, np.int32)


def payloads64k(corpus: bytes) -> None:
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax

    rows, lens = _golden_rows(corpus)
    out_len, payloads = _dense(*encode_blocks_jax(rows, lens, blk=BLK,
                                                  hc=9))
    np.savez_compressed(OUT, blocks=np.array(BLOCKS, np.int32),
                        out_len=out_len, payloads=payloads)
    for b, n in zip(BLOCKS, out_len):
        print(f"block {b}: {int(n)} bytes (ratio {BLK / int(n):.3f})")


def levels64k(corpus: bytes) -> None:
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax, level_params

    rows, lens = _golden_rows(corpus)
    arrays = {"blocks": np.array(BLOCKS, np.int32)}
    for level in LEVELS64K:
        hc, deep = level_params(level)
        out_len, payloads = _dense(*encode_blocks_jax(
            rows, lens, blk=BLK, hc=hc, deep=deep))
        arrays[f"out_len_l{level}"] = out_len
        arrays[f"payloads_l{level}"] = payloads
        print(f"level {level}: {out_len.tolist()}")
    np.savez_compressed(LEVELS64K_OUT, **arrays)


def levels4k() -> None:
    import test_torch_encode as tte     # the inputs the test packs

    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax

    _rows, windows, lens, starts = tte._pack(tte._static_inputs())
    arrays = {}
    for name, (hc, accel) in LEVEL_CONFIGS.items():
        out_len, payloads = _dense(*encode_blocks_jax(
            windows, lens, blk=tte.BLK, starts=starts, hc=hc, accel=accel))
        arrays[f"out_len_{name}"] = out_len
        arrays[f"payloads_{name}"] = payloads
        print(f"{name}: {len(out_len)} windows, {int(out_len.sum())} bytes",
              flush=True)
    np.savez_compressed(LEVELS4K_OUT, **arrays)


def deep4k() -> None:
    import test_torch_encode as tte

    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax

    _rows, windows, lens, starts = tte._pack(tte._static_inputs())
    arrays = {}
    for name, (hc, deep) in DEEP_CONFIGS.items():
        out_len, payloads = _dense(*encode_blocks_jax(
            windows, lens, blk=tte.BLK, starts=starts, hc=hc, deep=deep))
        arrays[f"out_len_{name}"] = out_len
        arrays[f"payloads_{name}"] = payloads
        print(f"{name}: {len(out_len)} windows, {int(out_len.sum())} bytes",
              flush=True)
    np.savez_compressed(DEEP4K_OUT, **arrays)


def deep_rows(corpus: bytes):
    """(windows, lens, starts) of the 64 KB deep goldens: the corpus
    blocks, then a byte run, a period-300 block, a code-like block and
    a 50,000-byte text window that starts emission at 20,000."""
    rows, lens = _golden_rows(corpus)
    rng = np.random.default_rng(300)
    period = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    crng = np.random.default_rng(0xC0FFEE)
    lines = [b"    if (state->pos + len > state->cap) return -1;",
             b"    memcpy(dst + op, src + ip, run_length);",
             b"    for (size_t i = 0; i < n; ++i) acc += table[i];",
             b"    return lz4_emit_sequence(ctx, literals, match);",
             b"    uint32_t h = (seq * 2654435761u) >> shift;"]
    code = b"\n".join(lines[i] for i in
                      crng.integers(0, len(lines), BLK // 30))[:BLK]
    extra = [b"\x61" * BLK, (period * (BLK // 300 + 1))[:BLK], code,
             corpus[9 * BLK:9 * BLK + 50_000]]
    windows = np.zeros((len(rows) + len(extra), BLK), np.uint8)
    windows[:len(rows)] = rows
    for k, d in enumerate(extra):
        windows[len(rows) + k, :len(d)] = np.frombuffer(d, np.uint8)
    lens = np.concatenate([lens, [len(d) for d in extra]]).astype(np.int32)
    starts = np.zeros(len(lens), np.int32)
    starts[-1] = 20_000
    return windows, lens, starts


def deep64k(corpus: bytes, level: int) -> None:
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax, level_params

    windows, lens, starts = deep_rows(corpus)
    hc, deep = level_params(level)
    out_len, payloads = _dense(*encode_blocks_jax(
        windows, lens, blk=BLK, starts=starts, hc=hc, deep=deep))
    print(f"level {level}: {out_len.tolist()}")
    np.savez_compressed(DEEP64K_OUT.format(level),
                        blocks=np.array(BLOCKS, np.int32), out_len=out_len,
                        payloads=payloads)


def deep_frames4k(corpus: bytes) -> None:
    np.savez_compressed(DEEP_FRAMES_OUT, **{
        f"l12_{name}": f for name, f in _frames(corpus, 12).items()})


def seqdec4k() -> None:
    import test_torch_encode as tte

    from zig_lz4_tpu.ops.jax_decode import (MAX_SEQS, decode_blocks_jax,
                                            parse_sequences, seqs_to_arrays)

    _rows, windows, lens, starts = tte._pack(tte._static_inputs())
    z = np.load(LEVELS4K_OUT)
    ends = np.cumsum(z["out_len_hc8"])
    pays = [z["payloads_hc8"][e - n:e].tobytes()
            for e, n in zip(ends, z["out_len_hc8"])]
    blk, cap = tte.BLK, MAX_SEQS(tte.BLK)
    arrays = {}
    for name, sel in (("nohist", np.flatnonzero(starts == 0)),
                      ("hist", np.arange(len(lens)))):
        comp = np.zeros((len(sel), 4096 + 64), np.uint8)
        hists = np.zeros((len(sel), blk), np.uint8)
        seqs = []
        for j, r in enumerate(sel):
            comp[j, :len(pays[r])] = np.frombuffer(pays[r], np.uint8)
            if starts[r]:
                hists[j, blk - starts[r]:] = windows[r, :starts[r]]
            seqs.append(seqs_to_arrays(
                parse_sequences(pays[r], int(starts[r])), cap))
        lit, lsrc, ml, off = (np.stack([s[k] for s in seqs])
                              for k in range(4))
        ns = np.array([s[4] for s in seqs], np.int32)
        out, out_len = decode_blocks_jax(
            comp, lit, lsrc, ml, off, ns, blk,
            hists=hists if name == "hist" else None)
        out, out_len = np.asarray(out), np.asarray(out_len)
        for j, r in enumerate(sel):
            assert out[j, :out_len[j]].tobytes() == \
                windows[r, starts[r]:lens[r]].tobytes(), (name, r)
        arrays[f"rows_{name}"] = sel.astype(np.int32)
        arrays[f"out_{name}"] = out
        arrays[f"out_len_{name}"] = out_len.astype(np.int32)
        print(f"{name}: {len(sel)} blocks, {int(out_len.sum())} bytes")
    np.savez_compressed(SEQDEC_OUT, **arrays)


def frags4k() -> None:
    import test_torch_frags as ttf      # the tables the test builds

    arrays = {"names": np.array(ttf.NAMES)}
    for name in ttf.GOLDEN:
        out, ok = ttf.jax_outputs(name)
        arrays[f"out_{name}"] = out
        if ok is not None:
            arrays[f"ok_{name}"] = ok
        print(f"{name}: ok {None if ok is None else ok.astype(int).tolist()}",
              flush=True)
    np.savez_compressed(FRAGS_OUT, **arrays)


def wide_windows(corpus: bytes, name: str):
    """(windows uint8[W, blk], lens int32[W], starts int32[W]) of one
    ``WIDE_SETS`` entry."""
    blk, rows, start, _hcs = WIDE_SETS[name]
    windows = np.zeros((len(rows), blk), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for k, (off, n) in enumerate(rows):
        piece = corpus[off:off + min(n, blk)]
        windows[k, :len(piece)] = np.frombuffer(piece, np.uint8)
        lens[k] = len(piece)
    return windows, lens, np.full(len(rows), start, np.int32)


def wide_frame_inputs(corpus: bytes):
    """(data, dictionary) of the wide frame goldens."""
    return corpus[WIDE_FRAME], corpus[WIDE_DICT]


def wide(corpus: bytes) -> None:
    import hashlib

    from zig_lz4_tpu import frame as ref_frame
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax
    from zig_lz4_tpu.parallel import ShardedFrameCodec

    arrays = {"corpus_mb": np.int64(CORPUS_MB)}
    for name, (blk, rows, start, hcs) in WIDE_SETS.items():
        windows, lens, starts = wide_windows(corpus, name)
        arrays[f"{name}_blk"] = np.int64(blk)
        arrays[f"{name}_offsets"] = np.array([o for o, _n in rows], np.int64)
        arrays[f"{name}_lens"] = lens
        arrays[f"{name}_start"] = np.int64(start)
        arrays[f"{name}_hcs"] = np.array(hcs, np.int64)
        for hc in hcs:
            out_len, payloads = _dense(*encode_blocks_jax(
                windows, lens, blk=blk, starts=starts, hc=hc))
            arrays[f"{name}_hc{hc}_out_len"] = out_len
            arrays[f"{name}_hc{hc}_payloads"] = payloads
            print(f"{name} hc={hc}: {out_len.tolist()}", flush=True)
    data, dictionary = wide_frame_inputs(corpus)
    for name, (bsid, level, with_dict) in WIDE_FRAMES.items():
        ref = ShardedFrameCodec(
            compression_level=level,
            block_size_id=getattr(ref_frame.BlockSizeID, bsid),
            dictionary=dictionary if with_dict else None)
        frame = ref.compress_frame(data)
        assert ref_frame.decompress_frame(
            frame, dictionary=dictionary if with_dict else None) == data
        arrays[f"frame_{name}_len"] = np.int64(len(frame))
        arrays[f"frame_{name}_sha256"] = np.array(
            hashlib.sha256(frame).hexdigest())
        print(f"frame {name}: {len(frame)} bytes", flush=True)
    arrays.update(_small_frames(WIDE_SMALL))
    np.savez_compressed(WIDE_OUT, **arrays)


def ff_words(n: int, seed: int = 23) -> bytes:
    """``n`` bytes in groups of four words: 0xFFFFFFFF, zero, then two
    words each zero, small (2-255) or random below 2^24, so that many
    positions carry the 12-byte sort key ``(0xFFFFFFFF, 0, 0)`` of the
    bytes past a window's valid end, or a key just after it.  The last 56 bytes end
    the whole words: ``(0xFFFFFFFF, 0, 0)``, then ``(0xFFFFFFFF, 5)`` and
    ``(0xFFFFFFFF, 6)``, two words that occur nowhere else, and, 16 bytes
    before the end, the one position keyed ``(0xFFFFFFFF, 0, 1)``, which
    sorts right after the bytes past the end: with too few of those
    between, its probe reaches the first position and takes it.  The
    bytes past the last whole word are 0xFF."""
    rng = np.random.default_rng(seed)
    g = np.zeros((-(-n // 16), 4), np.uint64)
    g[:, 0] = 0xFFFFFFFF
    for c in (2, 3):
        kind = rng.integers(0, 3, len(g))
        g[:, c] = np.where(kind == 0, 0, np.where(
            kind == 1, rng.integers(2, 256, len(g)),
            rng.integers(2, 1 << 24, len(g))))
    data = bytearray(g.astype("<u4").tobytes()[:n - n % 4])
    if len(data) >= 56:
        F = 0xFFFFFFFF
        data[-56:] = np.array([F, 0, 0, 0, F, 5, F, 6, 0x9E3779B9,
                               0x7F4A7C15, F, 0, 1, 7], "<u4").tobytes()
    return bytes(data) + b"\xff" * (n % 4)


def narrow_input(corpus: bytes, name: str) -> bytes:
    """The input of ``NARROW_FRAMES`` entry ``name``."""
    off, n = NARROW_FRAMES[name]
    return ff_words(n) if off is None else corpus[off:off + n]


def narrow(corpus: bytes) -> None:
    import hashlib

    from zig_lz4_tpu import frame as ref_frame
    from zig_lz4_tpu.parallel import ShardedFrameCodec

    ref = ShardedFrameCodec(compression_level=9,
                            block_size_id=ref_frame.BlockSizeID.max1MB)
    arrays = {"corpus_mb": np.int64(CORPUS_MB)}
    for name in NARROW_FRAMES:
        data = narrow_input(corpus, name)
        frame = ref.compress_frame(data)
        assert ref_frame.decompress_frame(frame) == data
        arrays[f"frame_{name}_len"] = np.int64(len(frame))
        arrays[f"frame_{name}_sha256"] = np.array(
            hashlib.sha256(frame).hexdigest())
        print(f"frame {name}: {len(data)} -> {len(frame)} bytes", flush=True)
    np.savez_compressed(NARROW_OUT, **arrays)


def _small_frames(entries: dict) -> dict:
    """frame_<name> -> the JAX codec's frame of each ``WIDE_SMALL``-like
    entry (data, block size name, level, dictionary)."""
    from zig_lz4_tpu import frame as ref_frame
    from zig_lz4_tpu.parallel import ShardedFrameCodec

    arrays = {}
    for name, (small, bsid, level, dct) in entries.items():
        ref = ShardedFrameCodec(
            compression_level=level,
            block_size_id=getattr(ref_frame.BlockSizeID, bsid),
            dictionary=dct)
        # the reference's greedy scan (and at the deep levels its price
        # scan) cuts the window into rows of 32 positions
        # (jax_block.py:579-581, :724-739) and raises on a window of any
        # other width, such as 100 + 65,536 bytes; the bytes past the
        # valid length take no part in the encode, so over the window
        # rounded up to 32 it writes the frame of the window itself
        ref.window = -(-ref.window // 32) * 32
        frame = ref.compress_frame(small)
        assert ref_frame.decompress_frame(frame, dictionary=dct) == small
        arrays[f"frame_{name}"] = np.frombuffer(frame, np.uint8)
        print(f"small frame {name}: {len(frame)} bytes", flush=True)
    return arrays


def wide_deep_windows(corpus: bytes, name: str, level: int):
    """(windows, lens, starts) of the deep goldens of ``WIDE_SETS`` entry
    ``name`` at ``level``: its windows, and at the levels of
    ``WIDE_DEEP_ZERO`` the all-zero 131,072-byte window after them."""
    windows, lens, starts = wide_windows(corpus, name)
    if name == "w131k" and level in WIDE_DEEP_ZERO:
        windows = np.concatenate([windows, np.zeros_like(windows[:1])])
        lens = np.append(lens, np.int32(WIDE_DEEP_ZERO[level]))
        starts = np.append(starts, np.int32(0))
    return windows, lens, starts


def wide_deep(corpus: bytes) -> None:
    from zig_lz4_tpu.ops.jax_block import encode_blocks_jax, level_params

    arrays = {}
    for name, levels in WIDE_DEEP_LEVELS.items():
        blk = WIDE_SETS[name][0]
        for level in levels:
            hc, deep = level_params(level)
            windows, lens, starts = wide_deep_windows(corpus, name, level)
            out_len, payloads = _dense(*encode_blocks_jax(
                windows, lens, blk=blk, starts=starts, hc=hc, deep=deep))
            arrays[f"{name}_l{level}_lens"] = lens
            arrays[f"{name}_l{level}_out_len"] = out_len
            arrays[f"{name}_l{level}_payloads"] = payloads
            print(f"{name} level {level}: {out_len.tolist()}", flush=True)
    np.savez_compressed(WIDE_DEEP_OUT, **arrays)


def wide_deep_frames(corpus: bytes) -> None:
    import hashlib

    from zig_lz4_tpu import frame as ref_frame
    from zig_lz4_tpu.parallel import ShardedFrameCodec

    data = corpus[WIDE_DEEP_FRAME]
    dictionary = corpus[WIDE_DICT]
    arrays = {}
    for name, (bsid, level, with_dict) in WIDE_DEEP_FRAMES.items():
        dct = dictionary if with_dict else None
        ref = ShardedFrameCodec(
            compression_level=level,
            block_size_id=getattr(ref_frame.BlockSizeID, bsid),
            dictionary=dct)
        frame = ref.compress_frame(data)
        assert ref_frame.decompress_frame(frame, dictionary=dct) == data
        arrays[f"frame_{name}_len"] = np.int64(len(frame))
        arrays[f"frame_{name}_sha256"] = np.array(
            hashlib.sha256(frame).hexdigest())
        print(f"frame {name}: {len(frame)} bytes", flush=True)
    arrays.update(_small_frames(WIDE_DEEP_SMALL))
    np.savez_compressed(WIDE_DEEP_FRAMES_OUT, **arrays)


def sort2() -> None:
    import hashlib

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "experiments"))
    import pallas_sort_probe as probe

    keys = np.random.default_rng(2).integers(
        0, SORT2_RANGE, probe.N).astype(np.int32)
    vals = np.arange(probe.N, dtype=np.int32)
    shape = jax.ShapeDtypeStruct((probe.ROWS, probe.LANE), jnp.int32)
    ko, vo = pl.pallas_call(probe._kernel, out_shape=(shape, shape),
                            interpret=True)(
        keys.reshape(probe.ROWS, probe.LANE),
        vals.reshape(probe.ROWS, probe.LANE))
    ko = np.asarray(ko).reshape(-1)
    vo = np.asarray(vo).reshape(-1)
    assert (ko == np.sort(keys)).all() and (keys[vo] == ko).all()
    stable = np.argsort(keys, kind="stable")
    print(f"payload differs from a stable sort at "
          f"{int((vo != stable).sum())} of {probe.N} places")
    np.savez_compressed(
        SORT2_OUT, n=np.int64(probe.N), key_range=np.int64(SORT2_RANGE),
        sha256=np.array(hashlib.sha256(ko.tobytes() + vo.tobytes())
                        .hexdigest()),
        vals_head=vo[:SORT2_HEAD])


def _frames(corpus: bytes, level: int) -> dict:
    """name -> the JAX codec's frame of each codec-test input, at 4 KB
    blocks and windows."""
    import conftest     # the tests' corpus and 8-device CPU mesh

    from zig_lz4_tpu.parallel import ShardedFrameCodec

    inputs = dict(conftest.corpus.__wrapped__())
    inputs["multi"] = corpus[MULTI]
    ref = ShardedFrameCodec(compression_level=level)
    ref.block_size = ref.window = SMALL
    frames = {name: np.frombuffer(ref.compress_frame(data), np.uint8)
              for name, data in inputs.items()}
    for name, f in frames.items():
        print(f"level {level} {name}: {len(inputs[name])} bytes -> frame "
              f"{f.size} bytes")
    return frames


def frames4k(corpus: bytes) -> None:
    np.savez_compressed(FRAMES_OUT, **_frames(corpus, 9))


def level_frames4k(corpus: bytes) -> None:
    np.savez_compressed(LEVEL_FRAMES_OUT, **{
        f"l{level}_{name}": f for level in FRAME_LEVELS
        for name, f in _frames(corpus, level).items()})


def main():
    import conftest  # noqa: F401  (sets up JAX before anything imports it)
    from bench import make_corpus

    corpus = make_corpus(CORPUS_MB)
    groups = {"64k": lambda: payloads64k(corpus),
              "frames4k": lambda: frames4k(corpus),
              "levels4k": levels4k,
              "levels64k": lambda: levels64k(corpus),
              "levels_frames4k": lambda: level_frames4k(corpus),
              "deep4k": deep4k,
              **{f"deep64k_l{lv}": (lambda lv=lv: deep64k(corpus, lv))
                 for lv in DEEP_LEVELS},
              "deep_frames4k": lambda: deep_frames4k(corpus),
              "seqdec4k": seqdec4k,
              "frags4k": frags4k,
              "wide": lambda: wide(corpus),
              "wide_deep": lambda: wide_deep(corpus),
              "wide_deep_frames": lambda: wide_deep_frames(corpus),
              "narrow": lambda: narrow(corpus),
              "sort2": sort2}
    for name in sys.argv[1:] or groups:
        groups[name]()


if __name__ == "__main__":
    main()
