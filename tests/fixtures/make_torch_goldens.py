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

Run once from the repository root (needs JAX):

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_goldens.py

or name groups as arguments (``64k``, ``frames4k``, ``levels4k``,
``levels64k``, ``levels_frames4k``); the groups are independent, so
they may run as separate processes side by side.
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
              "levels_frames4k": lambda: level_frames4k(corpus)}
    for name in sys.argv[1:] or groups:
        groups[name]()


if __name__ == "__main__":
    main()
