"""The traffic generator and the seeded corpus."""

import itertools
import json
import os

import pytest

from lz4bench import harness
from lz4bench.corpus import make_corpus
from lz4bench.traffic import Mix, Request, load_mix, part_block_sizes

MIXES = ("bulk", "insert", "read")
HITS = json.load(open(os.path.join(harness.HERE, "configs",
                                   "clickhouse-hits-lz4hc9.json")))["table"]


def _mix(name):
    return load_mix(harness.HERE, name, table=HITS)


def _head(mix, seed, n=200, corpus_len=50331648):
    return list(itertools.islice(mix.requests(seed, corpus_len), n))


def test_corpus_equals_the_ports_at_its_seed():
    from zig_lz4_tpu_torch.corpus import make_corpus as port_corpus
    assert make_corpus(48 << 20, 0xC0FFEE) == port_corpus(48)


def test_corpus_is_seeded():
    a = make_corpus(1 << 18, 2 ** 31 + 7)
    assert a == make_corpus(1 << 18, 2 ** 31 + 7)
    assert a != make_corpus(1 << 18, 2 ** 31 + 8)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    mix = _mix(name)
    seed = 4_000_000_123                 # over 32 signed bits
    assert _head(mix, seed) == _head(mix, seed)
    assert mix.corpus(seed) == mix.corpus(seed)


def test_other_seed_other_traffic():
    # a seeded layout: other offsets, the same sizes
    mix = _mix("bulk")
    seeded = Mix(dict(mix.params, sizes={"law": "table"}), "t", HITS)
    assert _head(seeded, 11) != _head(seeded, 12)
    assert [r.size for r in _head(seeded, 11)] == \
        [r.size for r in _head(seeded, 12)]
    assert seeded.corpus(11) != seeded.corpus(12)


def test_fixed_layout_draws_only_the_bytes():
    mix = Mix(dict(_mix("insert").params, corpus_bytes=6 << 18), "t", HITS)
    assert _head(mix, 11) == _head(mix, 12)
    assert _head(mix, 11)[0].offset == 0
    a, b = mix.corpus(11), mix.corpus(12)
    assert a != b and len(a) == len(b)
    # the same content type in every 256 KB slice: the byte runs' slice
    # (the one with the fewest distinct pairs of bytes) lies alike
    s = 256 << 10

    def runs_slice(c):
        return min(range(len(c) // s),
                   key=lambda i: len(set(c[i * s:(i + 1) * s:97])))
    assert runs_slice(a) == runs_slice(b)
    assert mix.corpus(11) == a


def test_bulk_is_whole_round_trips():
    mix = _mix("bulk")
    reqs = _head(mix, 5, 6, corpus_len=1000)
    assert [r.kind for r in reqs] == ["compress", "decompress"] * 3
    assert all((r.offset, r.size) == (0, 1000) for r in reqs
               if r.kind == "compress")


def test_read_decodes_the_frame_setup_writes():
    mix = _mix("read")
    assert mix.reads_only and not _mix("bulk").reads_only
    assert mix.setup_blocks(5, 1000) == [(0, 1000)]
    reqs = _head(mix, 5, 6, corpus_len=1000)
    assert reqs == [Request("decompress", 0, 1000)] * 6


def test_reads_only_mix_reads_each_setup_frame_in_a_seeded_order():
    # the insert mix's blocks, read back instead of written
    mix = Mix(dict(_mix("insert").params, corpus_bytes=6 << 18,
                   mix={"compress": 0, "decompress": 2}), "t", HITS)
    frames = mix.setup_blocks(11, 6 << 18)
    assert frames == mix.setup_blocks(12, 6 << 18)      # a fixed layout
    assert len(frames) == len(set(frames)) > 100
    n = 2 * len(frames)
    a, b = _head(mix, 11, 2 * n, 6 << 18), _head(mix, 12, 2 * n, 6 << 18)
    assert {r.kind for r in a} == {"decompress"}
    for cycle in (a[:n], a[n:], b[:n]):   # each frame twice a cycle
        assert sorted((r.offset, r.size) for r in cycle) == sorted(frames * 2)
    assert a[:n] != a[n:] and a != b
    assert a == _head(mix, 11, 2 * n, 6 << 18)


def _table(columns, **kw):
    t = {"columns": columns, "string_types": ["TEXT"],
         "type_bytes": {"INTEGER": 4, "BIGINT": 8},
         "string_value_bytes": {}, "index_granularity": 8192,
         "min_compress_block_size": 65536,
         "max_compress_block_size": 1048576,
         "max_insert_block_size": 8192 * 8}
    t.update(kw)
    return t


def test_write_rule_as_the_docs_give_it():
    # ClickHouse's min_compress_block_size example: a 4-byte column
    # makes 32 KB a mark, so a block every two marks
    assert part_block_sizes(_table([["c", "INTEGER"]])) == [65536] * 4
    # a URL String of 60 bytes a value: a block each mark
    url = _table([["URL", "TEXT"]], string_value_bytes={"URL": 60})
    assert part_block_sizes(url) == [8192 * 61] * 8
    # a column past max_compress_block_size a mark is cut at it
    wide = _table([["T", "TEXT"]], string_value_bytes={"T": 199})
    sizes = part_block_sizes(wide)
    assert max(sizes) == 1048576 and sum(sizes) == 8192 * 8 * 201
    # the part's last mark may be short, and what is left goes last
    short = _table([["c", "INTEGER"], ["w", "BIGINT"]],
                   max_insert_block_size=8192 * 2 + 100)
    assert part_block_sizes(short) == [65536] * 3 + [400, 800]


def test_hits_part():
    sizes = part_block_sizes(HITS)
    assert len(HITS["columns"]) == 105
    assert sum(sizes) == 1048449 * 455          # bytes of a row: 455
    assert max(sizes) == 8192 * 61 and min(sizes) > 0
    assert sizes.count(65536) == 4014 and len(sizes) == 4689


def test_insert_writes_only_in_the_rules_sizes():
    mix = _mix("insert")
    reqs = _head(mix, 9, 5000)
    assert {r.kind for r in reqs} == {"compress"}
    assert [r.size for r in reqs[:4689]] == part_block_sizes(HITS)
    for a, b in zip(reqs, reqs[1:]):
        assert b.offset == a.offset + a.size or b.offset == 0
        assert b.offset + b.size <= 50331648


def test_the_table_law_needs_a_table():
    with pytest.raises(ValueError):
        load_mix(harness.HERE, "insert")


def test_unknown_keys_are_refused():
    with pytest.raises(ValueError):
        Mix({"corpus_bytes": 1, "sizes": {"law": "whole"},
             "mix": {"compress": 1}, "rate": 5})
