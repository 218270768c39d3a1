"""Whole runs of every cell on the port's CPU route at a small size,
past the harness's look for a card: sound, then with the timed path
broken underneath, and under the control.  ``correct`` has to come out
true for the sound run and false for each fault:

* a step that returns its state unchanged: ``decompress_frame`` hands
  back the frame it was given, ``compress_frame`` the input;
* half of the batch left out: the frame holds the first half of the
  blocks (the header still declares the whole), the output half of the
  bytes;
* an answer altered where it is produced: one byte of a frame's block,
  or of an output, flipped;
* the exchange between chips left out: the last shard's rows of each
  launch never gathered (they come back as zeros), in a cell of four
  chips.

``MESH`` is such a cell, built here and not held in ``BENCHMARK.json``:
``hc9-64k.bulk``'s configuration and mix over a mesh of four devices,
``cpu`` four times on the CPU route.  Its frames have to equal the
one-chip cell's byte for byte.  ``READ`` decodes only: its faults are
the decoder's, planted in what ``decompress_frame`` returns, and on the
CPU its blocks are 64 KB, so that its small frame holds linked blocks.
The same runs go on the card with the ``cuda`` marker; a cell that
needs more cards than are present skips there, by name."""

import pytest

from lz4bench import control, harness

#: a cell of four chips over hc9-64k.bulk's configuration and mix
MESH = "hc9-64k.mesh4"
READ = "l1-4m-linked.read"
CELLS = ("hc9-64k.bulk", "l1-4m.bulk", "hits-hc9.insert", MESH, READ)
SMALL = {"hc9-64k.bulk": {"corpus_bytes": 96 << 10},
         "l1-4m.bulk": {"corpus_bytes": 96 << 10},
         "hits-hc9.insert": {"corpus_bytes": 256 << 10},
         MESH: {"corpus_bytes": 256 << 10},     # 4 blocks: a shard a device
         READ: {"corpus_bytes": 256 << 10}}     # 4 linked blocks of 64 KB
#: the bulk mix four times over (4 x 48 MiB), as a mesh of four cards
#: would take it
MESH_CORPUS = {"corpus_bytes": 4 * 48 << 20}
#: the hits table cut to marks of 64 rows and blocks of 1-16 KB on the
#: CPU: its first eight columns, the write rule unchanged
SMALL_TABLE = {"hits-hc9.insert": {
    "index_granularity": 64, "min_compress_block_size": 1024,
    "max_compress_block_size": 16384, "max_insert_block_size": 1000}}


class Faulty:
    """The port's codec with one fault planted in the window's calls."""

    def __init__(self, codec, fault):
        self.codec, self.fault = codec, fault
        if fault == "exchange":
            codec._round_trip = _last_shard_lost(codec)

    def compress_frame(self, data):
        frame = self.codec.compress_frame(data)
        if self.fault == "unchanged":
            return bytes(data)
        if self.fault == "half":
            return _half_frame(frame)
        if self.fault == "altered":
            return _flip_middle(frame)
        return frame

    def decompress_frame(self, frame):
        out = self.codec.decompress_frame(frame)
        if self.fault == "unchanged":
            return bytes(frame)
        if self.fault == "half":
            return out[:len(out) // 2]
        if self.fault == "altered":
            return _flip_middle(out)
        return out


def _last_shard_lost(codec):
    """``codec._round_trip`` with the rows of the last shard of each
    launch zeroed in what it gathers, as if never exchanged."""
    round_trip = codec._round_trip

    def lost(prefix, arrays, launch):
        out = round_trip(prefix, arrays, launch)
        lo = codec.mesh.shards(len(arrays[0]))[-1][1]
        for a in out:
            a[lo:] = 0
        return out
    return lost


def _flip_middle(b):
    b = bytearray(b)
    b[len(b) // 2] ^= 0x01
    return bytes(b)


def _half_frame(frame):
    """The frame with the second half of its blocks left out (of its
    one block's payload, where it has one), the rest as written."""
    from lz4bench import reference as R
    hdr, p = R.parse_header(frame)
    records, _end = R.read_blocks(frame, p, hdr.block_checksum)
    keep = records[:len(records) // 2] if len(records) > 1 else \
        [(records[0][0][:len(records[0][0]) // 2], records[0][1])]
    body = b"".join((len(pl) | (R.STORED if st else 0)).to_bytes(4, "little")
                    + pl for pl, st in keep)
    return frame[:p] + body + frame[-8:]


def _bench():
    """BENCHMARK.json with ``MESH`` added."""
    bench = harness.load_benchmark()
    base = next(w for w in bench["workloads"] if w["name"] == "hc9-64k.bulk")
    bench["workloads"].append(dict(base, name=MESH, chips=4))
    return bench


def _small_config(cell):
    if cell == READ:
        return {"block_size": 64 << 10}
    if cell not in SMALL_TABLE:
        return None
    cfg = harness.cell_parts(_bench(), cell)[1]
    table = dict(cfg["table"], **SMALL_TABLE[cell])
    table["columns"] = table["columns"][:8]
    return {"table": table}


class Kept:
    """The port's codec, keeping every frame the window's calls wrote."""

    def __init__(self, codec):
        self.codec, self.frames = codec, []

    def compress_frame(self, data):
        self.frames.append(self.codec.compress_frame(data))
        return self.frames[-1]

    def decompress_frame(self, frame):
        return self.codec.decompress_frame(frame)


def _run(cell, device="cpu", fault=None, settings=None, requests=4,
         traced=False, workers=0, **kw):
    """One run of ``cell``; ``kw`` goes to ``run_cell`` (``devices``, or
    ``mix_overrides`` and ``wrap`` in place of this file's)."""
    cpu = device == "cpu"
    kw.setdefault("mix_overrides", SMALL[cell] if cpu else None)
    kw.setdefault("wrap",
                  (lambda codec: Faulty(codec, fault)) if fault else None)
    return harness.run_cell(
        cell, 20240601, 60.0, traced, device=device, bench=_bench(),
        config_overrides=_small_config(cell) if cpu else None,
        settings=settings, workers=workers, max_requests=requests, **kw)


def _kept_run(cell, **kw):
    """(result, frames written) of a run of ``cell``."""
    kept = []

    def wrap(codec):
        kept.append(Kept(codec))
        return kept[0]
    return _run(cell, wrap=wrap, **kw), kept[0].frames


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 4 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert not r["correct"], (fault, r["checks"])


def test_mesh_exchange_left_out_is_not_correct():
    r = _run(MESH, fault="exchange")
    assert not r["correct"], r["checks"]
    assert r["checks"]["frames_bad"]["value"] > 0


def test_mesh_frames_equal_one_chips():
    from zig_lz4_tpu_torch import trace
    trace.reset()
    try:
        r, frames = _kept_run(MESH, traced=True)
        totals = trace.totals()
    finally:
        trace.reset()
    one, one_frames = _kept_run("hc9-64k.bulk", mix_overrides=SMALL[MESH])
    assert r["correct"] and one["correct"], (r["checks"], one["checks"])
    assert frames == one_frames and len(frames) == 2
    # the CPU route's four virtual devices count as four
    assert r["device"]["count"] == 4 and one["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes_by_card"] == [0] * 4
    assert r["device"]["busy_union_s"] == r["device"]["busy_s"] == 0
    # four shards staged and launched a launch group, gathered once
    for kind in ("enc", "dec"):
        groups = totals[f"{kind}.collect"]["count"]
        assert groups >= 1
        assert totals[f"{kind}.stage"]["count"] == 4 * groups
        assert totals[f"{kind}.launch"]["count"] == 4 * groups


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg = harness.cell_parts(_bench(), cell)[1]
    how = control.control_run(cfg)
    r = _run(cell, **how)
    assert not r["correct"]
    if "wrap" in how:           # the read verifies nothing; frames sound
        assert r["checks"]["corrupt_reads_returned"]["value"] > 0
        assert r["checks"]["frames_bad"]["value"] == 0
        assert r["checks"]["outputs_bad"]["value"] == 0
    else:
        assert r["checks"]["frames_bad"]["value"] > 0


def _cards(cell):
    """Skip unless the cards ``cell`` needs are present."""
    import torch
    n = next(w["chips"] for w in _bench()["workloads"] if w["name"] == cell)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"{cell} needs {n} NVIDIA card(s), {have} present")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_at_the_cells_size(cell, fault):
    _cards(cell)
    r = _run(cell, device="cuda:0", fault=fault, requests=6)
    assert r["correct"] == (fault is None), (fault, r["checks"])


@pytest.mark.cuda
def test_mesh_exchange_left_out_on_the_cards():
    _cards(MESH)
    r = _run(MESH, device="cuda:0", fault="exchange", requests=2)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["one card", "four cards"])
def test_mesh_at_four_times_the_bulk(where):
    """``MESH`` over 4 x 48 MiB, its four shards on one card or on four,
    frames equal to the one-chip cell's at the same corpus; traced, the
    cards' union of busy time between one card's and their sum."""
    _cards("hc9-64k.bulk" if where == "one card" else MESH)
    devices = ["cuda:0"] * 4 if where == "one card" else None
    r, frames = _kept_run(MESH, device="cuda:0", devices=devices,
                          mix_overrides=MESH_CORPUS, requests=2,
                          workers=None, traced=True)
    one, one_frames = _kept_run("hc9-64k.bulk", device="cuda:0",
                                mix_overrides=MESH_CORPUS, requests=2,
                                workers=None)
    print(where, "device", r["device"], "one card", one["device"])
    assert r["correct"] and one["correct"], (r["checks"], one["checks"])
    assert frames == one_frames and len(frames) == 1
    dev, cards = r["device"], 1 if where == "one card" else 4
    assert dev["count"] == cards
    assert len(dev["memory_peak_bytes_by_card"]) == cards
    assert dev["busy_s"] * (1 - 1e-9) <= dev["busy_union_s"] <= \
        cards * dev["busy_s"] * (1 + 1e-9)
