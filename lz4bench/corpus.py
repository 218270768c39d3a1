"""The benchmark's synthetic corpus, seeded.

A copy of ``zig_lz4_tpu_torch/corpus.py``'s ``make_corpus`` (itself the
JAX bench's, ``bench.py:64-122``): the same six generators (word text,
XML-like rows, code lines, binary records, random bytes, byte runs) in
the same shares, cut into 256 KB slices and permuted, drawn from
``numpy.random.default_rng(seed)`` in place of the fixed ``0xC0FFEE``.
At that seed the bytes equal the port's corpus.  ``order_seed``, where
given, draws the slices' order in place of ``seed``, so that the
content types lie where they lie at that seed while ``seed`` draws the
bytes within them.  Only the joins are written to run faster; the
draws and the bytes are the same.
"""

import numpy as np

__all__ = ["make_corpus"]

_WORDS = [b"the", b"of", b"and", b"to", b"in", b"that", b"was", b"his",
          b"he", b"it", b"with", b"is", b"for", b"as", b"had", b"you",
          b"not", b"be", b"her", b"on", b"at", b"by", b"which", b"have",
          b"or", b"from", b"this", b"him", b"but", b"all", b"she", b"they",
          b"were", b"compression", b"dictionary", b"entropy", b"silesia"]
_LINES = [b"    if (state->pos + len > state->cap) return -1;",
          b"    memcpy(dst + op, src + ip, run_length);",
          b"    for (size_t i = 0; i < n; ++i) acc += table[i];",
          b"    return lz4_emit_sequence(ctx, literals, match);",
          b"    uint32_t h = (seq * 2654435761u) >> shift;"]


def make_corpus(nbytes: int = 48 << 20, seed: int = 0xC0FFEE,
                order_seed: int | None = None) -> bytes:
    """About ``nbytes`` of the corpus drawn from ``seed`` (any
    non-negative int): exactly ``nbytes`` at 48 MiB, where a generator's
    last item can fall short of its share at smaller sizes.  The slices'
    order is drawn from ``order_seed`` where it is given."""
    rng = np.random.default_rng(seed)

    def text(n):
        idx = rng.integers(0, len(_WORDS), n // 4)
        return b" ".join([_WORDS[i] for i in idx.tolist()])[:n]

    def xmlish(n):
        tags = [b"<row Id=\"%d\" Count=\"%d\"/>" % (i, int(rng.integers(999)))
                for i in range(200)]
        idx = rng.integers(0, len(tags), n // 16)
        return b"\n".join([tags[i] for i in idx.tolist()])[:n]

    def codeish(n):
        idx = rng.integers(0, len(_LINES), n // 30)
        return b"\n".join([_LINES[i] for i in idx.tolist()])[:n]

    def records(n):
        k = n // 16
        rec = np.zeros((k, 16), np.uint8)
        rec[:, 0] = rng.integers(0, 4, k)
        rec[:, 1] = 0xAB
        rec[:, 2:6] = np.arange(k, dtype=np.uint32).view(np.uint8) \
            .reshape(k, 4) if k else 0
        rec[:, 6:10] = rng.integers(0, 3, (k, 4))
        return rec.tobytes()

    def random_(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def rle(n):
        out = bytearray()
        while len(out) < n:
            out += bytes([int(rng.integers(256))]) * int(rng.integers(20, 400))
        return bytes(out[:n])

    recipe = [(text, 14), (xmlish, 8), (codeish, 7), (records, 9),
              (random_, 6), (rle, 4)]
    total = sum(w for _, w in recipe)
    blob = b"".join(gen(nbytes * w // total) for gen, w in recipe)
    s = 256 * 1024
    slices = [blob[i:i + s] for i in range(0, len(blob), s)]
    order = (rng if order_seed is None else
             np.random.default_rng(order_seed)).permutation(len(slices))
    return b"".join([slices[i] for i in order])
