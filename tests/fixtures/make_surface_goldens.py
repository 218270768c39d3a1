"""Write the JAX package's outputs on its user surfaces, which the
port's surfaces are held to byte for byte (tests/test_torch_cli.py,
test_torch_parallel.py, test_torch_multihost.py, test_torch_entry.py).

Each group writes ``surface_<group>.json`` beside this file: lengths and
SHA-256 digests of what the reference wrote.

* ``entry`` -- the root ``__graft_entry__.entry()`` step, run once:
  ``out_len`` and the digest of each row of ``out`` (4 x 64 KB windows
  at level 0; one JAX compile at 64 KB).
* ``cli`` -- the reference CLI's ``--engine tpu`` frames of the CLI
  tests' sample and of a corpus slice (``CLI_GOLDENS``; three compiles
  at 64 KB).
* ``multihost`` -- the reference ``MultiHostFrameCodec``'s frame of the
  multi-host tests' corpus in 4 KB blocks, in one process (whose frame
  equals a two-process run's, tests/test_multihost2.py), with and
  without the content hash.
* ``mesh`` -- the reference codec's frames on its 8-device CPU mesh of
  the mesh tests' deep-chain input in 2 KB blocks at levels 9 and 0.
* ``factories`` -- ``jax_block.make_block_encoder``'s payloads of the
  ``factory_windows`` at levels 0, 9 and 12 (1 KB windows; three
  compiles).

The inputs are made here, from seeds, and the tests import them from
this module.  Run from the repository root (needs JAX; each group may
run as its own process):

    JAX_PLATFORMS=cpu python tests/fixtures/make_surface_goldens.py [group ...]
"""

import hashlib
import json
import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
ROOT = os.path.dirname(TESTS)
#: the reduced block sizes of the multi-host and mesh goldens
#: (tests/test_multihost.py:30-32 and tests/test_parallel.py:48-49
#: shrink theirs the same way)
SMALL = 4096
DEEP_BLK = 2048
#: the CLI goldens: (input, level flag), each run with ``--engine tpu``;
#: "corpus" is ``make_corpus(2)[CLI_CORPUS]``, text into XML
CLI_GOLDENS = (("sample", "-1"), ("sample", "-4"), ("corpus", "-1"),
               ("corpus", "-9"))
CLI_CORPUS = slice(13 * 65536, 13 * 65536 + 150_000)
MESH_LEVELS = (9, 0)
#: the single-window factories' window and levels
FACTORY_BLK = 1024
FACTORY_LEVELS = (0, 9, 12)


def path(group: str) -> str:
    return os.path.join(HERE, f"surface_{group}.json")


def load(group: str) -> dict:
    with open(path(group)) as f:
        return json.load(f)


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def cli_sample() -> bytes:
    """The CLI tests' input (tests/test_cli.py:17-24)."""
    rng = random.Random(7)
    return ((b"a quick brown fox " * 400)
            + bytes(rng.randrange(256) for _ in range(4000))
            + b"z" * 9000)


def multihost_corpus() -> bytes:
    """Text, then random bytes: 20 blocks of 4 KB (the layout of
    tests/test_multihost2.py:48-49, cut to a tenth)."""
    rng = np.random.default_rng(77)
    return ((b"multi host corpus block " * 4000)[:70_000]
            + rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes())


def deep_chain(n: int = 16384, seg: int = 64, k: int = 2,
               seed: int = 5) -> bytes:
    """Segments of ``seg`` bytes, each the one before with ``k`` bytes
    changed: every segment copies the one before it in short pieces, so
    in ``DEEP_BLK`` blocks the fragment resolver's chains run 8 to 11
    rounds deep, past the second ladder tier's 8 and into the deep
    tier's 12."""
    rng = random.Random(seed)
    cur = bytearray(rng.randrange(256) for _ in range(seg))
    out = bytearray(cur)
    while len(out) < n:
        for _ in range(k):
            cur[rng.randrange(seg)] = rng.randrange(256)
        out += cur
    return bytes(out[:n])


def factory_windows():
    """[(window uint8[FACTORY_BLK], n, start)]: text, a byte run, random
    bytes, a word salad, a period-37 run, a short window, an empty one,
    and a text window that emits from 300 behind its first 300 bytes."""
    rng = np.random.default_rng(15)
    blk = FACTORY_BLK
    text = (b"the single-window factory encodes one window " * 40)[:blk]
    salad = bytes(rng.choice(np.frombuffer(b"abcdefgh ", np.uint8), blk))
    period = bytes(rng.integers(0, 256, 37, dtype=np.uint8)) * 28
    rows = [(text, blk, 0), (b"\x61" * blk, blk, 0),
            (rng.integers(0, 256, blk, dtype=np.uint8).tobytes(), blk, 0),
            (salad, blk, 0), (period[:blk], blk, 0), (text, 100, 0),
            (b"", 0, 0), (text[:300] + salad[:blk - 300], blk, 300)]
    out = []
    for data, n, start in rows:
        w = np.zeros(blk, np.uint8)
        w[:len(data)] = np.frombuffer(data, np.uint8)
        out.append((w, n, start))
    return out


def factories() -> dict:
    from zig_lz4_tpu.ops.jax_block import level_params, make_block_encoder
    res = {}
    for level in FACTORY_LEVELS:
        enc = make_block_encoder(FACTORY_BLK, *level_params(level))
        rows = []
        for w, n, start in factory_windows():
            out, m = enc(w, np.int32(n), start)
            out = np.asarray(out)
            rows.append({"len": int(m), "out_sha256": sha(out.tobytes()),
                         "width": int(out.shape[0])})
        res[f"level {level}"] = rows
    return res


def entry() -> dict:
    import jax
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g
    fn, args = g.entry()
    out, olen = jax.jit(fn)(*args)
    out, olen = np.asarray(out), np.asarray(olen)
    return {"shape": list(out.shape), "out_len": [int(x) for x in olen],
            "out_sha256": [sha(row.tobytes()) for row in out]}


def cli() -> dict:
    import tempfile

    from bench import make_corpus
    from zig_lz4_tpu.cli import main
    inputs = {"sample": cli_sample(), "corpus": make_corpus(2)[CLI_CORPUS]}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, lv in CLI_GOLDENS:
            src = os.path.join(tmp, name)
            with open(src, "wb") as f:
                f.write(inputs[name])
            dst = os.path.join(tmp, f"{name}{lv}.lz4")
            assert main([lv, "-f", "-q", "--engine", "tpu", src, dst]) == 0
            with open(dst, "rb") as f:
                frame = f.read()
            res[f"{name} {lv}"] = {"len": len(frame), "sha256": sha(frame)}
    return res


def multihost() -> dict:
    from zig_lz4_tpu.parallel.multihost import MultiHostFrameCodec
    c = MultiHostFrameCodec(block_checksum=True)
    c.block_size = c.local.block_size = c.local.window = SMALL
    res = {}
    for h in (False, True):
        frame = c.compress_corpus(multihost_corpus(), content_hash=h)
        res[f"content_hash={h}"] = {"len": len(frame), "sha256": sha(frame)}
    return res


def mesh() -> dict:
    import jax
    from zig_lz4_tpu.parallel import ShardedFrameCodec
    assert jax.device_count() == 8
    res = {}
    for level in MESH_LEVELS:
        c = ShardedFrameCodec(compression_level=level)
        c.block_size = c.window = DEEP_BLK
        frame = c.compress_frame(deep_chain())
        res[f"level {level}"] = {"len": len(frame), "sha256": sha(frame)}
    return res


GROUPS = {"entry": entry, "cli": cli, "multihost": multihost, "mesh": mesh,
          "factories": factories}


def main():
    sys.path.insert(0, TESTS)
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (JAX on the 8-device CPU mesh)
    for name in sys.argv[1:] or GROUPS:
        res = GROUPS[name]()
        with open(path(name), "w") as f:
            json.dump(res, f, indent=1, sort_keys=True)
            f.write("\n")
        print(name, res)


if __name__ == "__main__":
    main()
