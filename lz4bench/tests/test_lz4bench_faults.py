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
  or of an output, flipped.

The exchange between chips does not exist in these one-chip cells.
The same runs go on the card with the ``cuda`` marker."""

import pytest

from lz4bench import control, harness

CELLS = ("hc9-64k.bulk", "l1-4m.bulk", "hits-hc9.insert")
SMALL = {"hc9-64k.bulk": {"corpus_bytes": 96 << 10},
         "l1-4m.bulk": {"corpus_bytes": 96 << 10},
         "hits-hc9.insert": {"corpus_bytes": 256 << 10}}
#: the hits table cut to marks of 64 rows and blocks of 1-16 KB on the
#: CPU: its first eight columns, the write rule unchanged
SMALL_TABLE = {"hits-hc9.insert": {
    "index_granularity": 64, "min_compress_block_size": 1024,
    "max_compress_block_size": 16384, "max_insert_block_size": 1000}}


class Faulty:
    """The port's codec with one fault planted in the window's calls."""

    def __init__(self, codec, fault):
        self.codec, self.fault = codec, fault

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


def _small_config(cell):
    if cell not in SMALL_TABLE:
        return None
    cfg = harness.cell_parts(harness.load_benchmark(), cell)[1]
    table = dict(cfg["table"], **SMALL_TABLE[cell])
    table["columns"] = table["columns"][:8]
    return {"table": table}


def _run(cell, device="cpu", fault=None, settings=None, requests=4):
    cpu = device == "cpu"
    return harness.run_cell(
        cell, 20240601, 60.0, False, device=device,
        mix_overrides=SMALL[cell] if cpu else None,
        config_overrides=_small_config(cell) if cpu else None,
        wrap=(lambda codec: Faulty(codec, fault)) if fault else None,
        settings=settings, workers=0, max_requests=requests)


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


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg = harness.cell_parts(harness.load_benchmark(), cell)[1]
    r = _run(cell, settings=control.control_settings(cfg))
    assert not r["correct"]
    assert r["checks"]["frames_bad"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_at_the_cells_size(cell, fault):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = _run(cell, device="cuda:0", fault=fault, requests=6)
    assert r["correct"] == (fault is None), (fault, r["checks"])
