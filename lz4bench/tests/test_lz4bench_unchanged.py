"""The cells that compress keep their set-up frames and requests byte
for byte: at a small size on the port's CPU route, every frame each of
them writes and every output it reads back, in set-up and in its first
requests, and the head of its request sequence at its own size, against
what the harness of the commit before the decode-only mix gave
(``fixtures/compress_cells.json``, made by ``python
lz4bench/tests/test_lz4bench_unchanged.py <checkout root>``)."""

import hashlib
import itertools
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "fixtures", "compress_cells.json")
SEED = 3_000_000_019
#: a cell of four chips over hc9-64k.bulk's configuration and mix, as
#: ``BENCHMARK.json`` holds it
CELLS = ("hc9-64k.bulk", "l1-4m.bulk", "hits-hc9.insert", "hc12-4m.bulk",
         "hc9-64k.mesh4")
SMALL = {"hc9-64k.bulk": 96 << 10, "l1-4m.bulk": 96 << 10,
         "hits-hc9.insert": 256 << 10, "hc12-4m.bulk": 96 << 10,
         "hc9-64k.mesh4": 256 << 10}
#: the hits table's first eight columns, in marks of 64 rows and blocks
#: of 1-16 KB
SMALL_TABLE = {"index_granularity": 64, "min_compress_block_size": 1024,
               "max_compress_block_size": 16384,
               "max_insert_block_size": 1000}
HEAD = 1000


def _sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def fingerprint(cell: str) -> dict:
    """What ``cell`` writes and reads in a run of four requests at its
    small size (every ``compress_frame`` and ``decompress_frame`` call's
    input and output, set-up's first, by SHA-256), and the first
    ``HEAD`` requests of its mix at its own size."""
    from lz4bench import harness
    from zig_lz4_tpu_torch.parallel import sharded
    bench = harness.load_benchmark()
    _cell, config, mix = harness.cell_parts(bench, cell)
    cfg = None
    if "table" in config:
        table = dict(config["table"], **SMALL_TABLE)
        table["columns"] = table["columns"][:8]
        cfg = {"table": table}
    log = []
    cls = sharded.ShardedFrameCodec
    enc, dec = cls.compress_frame, cls.decompress_frame

    def compress_frame(self, data, *a, **k):
        out = enc(self, data, *a, **k)
        log.append(("enc", _sha(data), _sha(out)))
        return out

    def decompress_frame(self, comp):
        out = dec(self, comp)
        log.append(("dec", _sha(comp), _sha(out)))
        return out

    cls.compress_frame, cls.decompress_frame = compress_frame, decompress_frame
    try:
        r = harness.run_cell(cell, SEED, 60.0, False, device="cpu",
                             bench=bench,
                             mix_overrides={"corpus_bytes": SMALL[cell]},
                             config_overrides=cfg, workers=0, max_requests=4)
    finally:
        cls.compress_frame, cls.decompress_frame = enc, dec
    head = [[q.kind, q.offset, q.size] for q in itertools.islice(
        mix.requests(SEED, mix.corpus_bytes), HEAD)]
    return {"correct": r["correct"], "calls": len(log),
            "calls_sha256": _sha(json.dumps(log).encode()),
            "requests_sha256": _sha(json.dumps(head).encode())}


@pytest.mark.parametrize("cell", CELLS)
def test_compress_cells_as_before(cell):
    with open(ORACLE) as f:
        want = json.load(f)[cell]
    assert fingerprint(cell) == want


if __name__ == "__main__":
    # the oracle, from the harness of the checkout named (default: this)
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(HERE)))
    sys.path.insert(0, root)
    print(json.dumps({c: fingerprint(c) for c in CELLS}, indent=1))
