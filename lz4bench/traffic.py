"""The one traffic generator: a mix file's parameters, the cell's
configuration and a seed give the corpus, the frames written in set-up
and the request sequence.

A mix is ``traffic/<mix>.json``:

``corpus_bytes``  bytes of the seeded corpus (``corpus.make_corpus``).
``sizes``         ``{"law": "whole"}``: every block is the whole corpus;
                  ``{"law": "table"}``: the blocks a column store forms
                  when it writes the configuration's ``table``, part
                  after part, in the order it forms them
                  (``part_block_sizes``), the same at every seed.
                  Blocks are cut from the corpus one after another from
                  a seeded start (0 for "whole" and a fixed layout), the
                  next at 0 where one would cross the end.
``layout``        ``"seeded"`` (default): the seed draws the order of the
                  corpus's 256 KB slices and the start; ``"fixed"``: the
                  order is ``FIXED_ORDER``'s and the start 0, so every
                  seed puts the same content types in the same blocks
                  and draws only the bytes within them.
``mix``           ``{"compress": c, "decompress": d}``: every cycle of
                  c + d requests holds c that compress a new block and d
                  that decompress the frame the last compress wrote,
                  in a seeded order, or compresses first where
                  ``"ordered"`` is true.  A mix with c 0 reads only:
                  set-up writes a frame of each block of one cycle of
                  the size law (``setup_blocks``), and every cycle of
                  requests decodes each of those frames d times, in an
                  order drawn from the seed.

The loop is closed: one caller sends a request when the last returned.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os

import numpy as np

from .corpus import make_corpus

__all__ = ["Mix", "Request", "load_mix", "column_bytes",
           "part_block_sizes"]

_KEYS = {"corpus_bytes", "sizes", "mix", "layout", "why"}
#: the slices' order of a fixed layout: the port's own corpus seed
FIXED_ORDER = 0xC0FFEE


@dataclasses.dataclass(frozen=True)
class Request:
    """One request: ``compress`` of corpus bytes [offset, offset +
    size), or ``decompress`` of the frame the last compress returned --
    in a mix that reads only, of the frame set-up wrote of corpus bytes
    [offset, offset + size)."""
    kind: str
    offset: int = 0
    size: int = 0


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


class Mix:
    """A traffic mix's parameters, with the corpus and the requests they
    give at a seed."""

    def __init__(self, params: dict, name: str = "",
                 table: dict | None = None):
        unknown = set(params) - _KEYS
        if unknown:
            raise ValueError(f"traffic {name}: unknown keys {sorted(unknown)}")
        self.name = name
        self.params = params
        self.corpus_bytes = int(params["corpus_bytes"])
        self.sizes = dict(params["sizes"])
        self.mix = dict(params["mix"])
        self.layout = params.get("layout", "seeded")
        if self.layout not in ("seeded", "fixed"):
            raise ValueError(f"traffic {name}: layout {self.layout}")
        if self.sizes["law"] not in ("whole", "table"):
            raise ValueError(f"traffic {name}: size law {self.sizes['law']}")
        if self.sizes["law"] == "table" and not table:
            raise ValueError(f"traffic {name}: the configuration has no "
                             "table")
        self.table = table
        if self.mix.get("compress", 0) < 0 or self.mix.get("decompress", 0) < 0:
            raise ValueError(f"traffic {name}: negative mix")

    def corpus(self, seed: int) -> bytes:
        return make_corpus(self.corpus_bytes, seed & (2 ** 64 - 1),
                           FIXED_ORDER if self.layout == "fixed" else None)

    def size_cycle(self) -> list[int]:
        """The block sizes of one cycle of the size law."""
        if self.sizes["law"] == "whole":
            return [self.corpus_bytes]
        return part_block_sizes(self.table)

    @property
    def reads_only(self) -> bool:
        """Whether no request compresses: the frames read are written
        in set-up."""
        return not self.mix.get("compress", 0)

    def setup_blocks(self, seed: int, corpus_len: int) -> list:
        """The (offset, size) of the blocks of one cycle of the size
        law, each once: those whose frames a mix that reads only
        writes in set-up."""
        cycle = itertools.islice(self.blocks(seed, corpus_len),
                                 len(self.size_cycle()))
        return list(dict.fromkeys(cycle))

    def blocks(self, seed: int, corpus_len: int):
        """The (offset, size) of every block the compress requests
        write, endlessly."""
        rng = _rng(seed, 1)
        pos = int(rng.integers(0, corpus_len)) if \
            self.sizes["law"] != "whole" and self.layout == "seeded" else 0
        cycle = self.size_cycle()
        while True:
            for size in cycle:
                size = min(size, corpus_len)
                if pos + size > corpus_len:
                    pos = 0
                yield pos, size
                pos += size
                if pos >= corpus_len:
                    pos = 0

    def requests(self, seed: int, corpus_len: int):
        """The request sequence at ``seed``, endlessly."""
        if self.reads_only:
            return self._reads(seed, corpus_len)
        return self._round_trips(seed, corpus_len)

    def _reads(self, seed: int, corpus_len: int):
        frames = self.setup_blocks(seed, corpus_len)
        reads = frames * int(self.mix.get("decompress", 0))
        if not reads:
            raise ValueError(f"traffic {self.name}: empty mix")
        rng = _rng(seed, 3)
        while True:
            for i in rng.permutation(len(reads)):
                yield Request("decompress", *reads[i])

    def _round_trips(self, seed: int, corpus_len: int):
        blocks = self.blocks(seed, corpus_len)
        rng = _rng(seed, 2)
        kinds = (["compress"] * int(self.mix.get("compress", 0))
                 + ["decompress"] * int(self.mix.get("decompress", 0)))
        if not kinds:
            raise ValueError(f"traffic {self.name}: empty mix")
        while True:
            cycle = kinds if self.mix.get("ordered") else \
                [kinds[i] for i in rng.permutation(len(kinds))]
            for kind in cycle:
                if kind == "compress":
                    off, size = next(blocks)
                    yield Request("compress", off, size)
                else:
                    yield Request("decompress")


def column_bytes(table: dict) -> list[int]:
    """Bytes a row of each of ``table``'s columns takes: its type's
    width, or for a string a varint length and the value's assumed mean
    bytes (``string_value_bytes``, 0 where a column is not named)."""
    out = []
    for name, typ in table["columns"]:
        if typ in table["type_bytes"]:
            out.append(int(table["type_bytes"][typ]))
        elif typ in table["string_types"]:
            n = int(table["string_value_bytes"].get(name, 0))
            out.append(n + 1 + (n >= 128))
        else:
            raise ValueError(f"column {name}: no width for type {typ}")
    return out


def part_block_sizes(table: dict) -> list[int]:
    """The uncompressed sizes of the blocks a MergeTree writer compresses
    for one part of ``max_insert_block_size`` rows, in the order it
    compresses them.  Marks of ``index_granularity`` rows are written
    column after column; a column's buffer is compressed at the start of
    a mark where it holds ``min_compress_block_size`` bytes or more, and
    whenever it fills ``max_compress_block_size``; what is left is
    compressed at the part's end."""
    widths = column_bytes(table)
    rows, g = table["max_insert_block_size"], table["index_granularity"]
    lo, hi = table["min_compress_block_size"], table["max_compress_block_size"]
    held, out = [0] * len(widths), []
    for start in range(0, rows, g):
        n = min(g, rows - start)
        for i, w in enumerate(widths):
            if held[i] >= lo:
                out.append(held[i])
                held[i] = 0
            b = held[i] + n * w
            while b >= hi:
                out.append(hi)
                b -= hi
            held[i] = b
    out += [b for b in held if b]
    return out


def load_mix(root: str, name: str, overrides: dict | None = None,
             table: dict | None = None) -> Mix:
    """The mix ``traffic/<name>.json`` under ``root`` (the benchmark's
    folder), with ``overrides`` laid over its parameters; ``table`` is
    the configuration's, which the "table" size law writes."""
    path = os.path.join(root, "traffic", f"{name}.json")
    with open(path) as f:
        params = json.load(f)
    params.update(overrides or {})
    return Mix(params, name, table)
