"""The decode-only cell ``l1-4m-linked.read``, built through
``cell_parts`` and run whole on the port's CPU route at a small size
(256 KB in 64 KB blocks, so that the frame holds linked blocks): the
frame set-up writes is linked and its blocks reach into earlier ones,
every read decodes it back on the linked route alone, and the run is
correct; a decode that raises, a byte altered in what
``decompress_frame`` returns, a set-up frame written with independent
blocks, a read that skips the content checksum (the control) and a
read handed to the host frame layer (the native runtime missing) are
not.  The same on the card at the cell's own size with the ``cuda``
marker."""

import json

import pytest

from lz4bench import control, harness, reference as R

CELL = "l1-4m-linked.read"
SEED = 3_000_000_023
SMALL_MIX = {"corpus_bytes": 256 << 10}
SMALL_CONFIG = {"block_size": 64 << 10}


class _Reads:
    """The codec with each output kept, and a fault planted."""

    def __init__(self, codec, fault=None):
        self.codec, self.fault, self.outputs = codec, fault, []

    def decompress_frame(self, frame):
        if self.fault == "raises":
            raise ValueError("planted")
        if self.fault == "unverified":
            frame = control.without_checksum(frame)
        out = self.codec.decompress_frame(frame)
        if self.fault == "altered":
            out = bytearray(out)
            out[len(out) // 3] ^= 0x01
            out = bytes(out)
        self.outputs.append(out)
        return out


def _run(monkeypatch, capsys=None, fault=None, device="cpu", requests=4,
         independent=False):
    """(result, set-up frames with their sources, the codec wrapper,
    blocks by route) of a run of ``CELL``."""
    written, held = [], []
    host_frame = harness.host_frame

    def write(data, config, args):
        if independent:                 # the fault: the linked bit set
            config = dict(config, independent_blocks=True)
        written.append((host_frame(data, config, args), data))
        return written[-1][0]
    monkeypatch.setattr(harness, "host_frame", write)

    def wrap(codec):
        held.append(_Reads(codec, fault))
        return held[0]
    cpu = device == "cpu"
    r = harness.run_cell(CELL, SEED, 60.0, False, device=device,
                         mix_overrides=SMALL_MIX if cpu else None,
                         config_overrides=SMALL_CONFIG if cpu else None,
                         wrap=wrap, workers=0 if cpu else None,
                         max_requests=requests)
    routes = None
    if capsys is not None:
        err = capsys.readouterr().err
        line = next(x for x in err.splitlines()
                    if x.startswith("blocks by route: "))
        routes = json.loads(line[len("blocks by route: "):])
    return r, written, held[0], routes


def test_the_cell_is_made_of_its_files():
    cell, config, mix = harness.cell_parts(harness.load_benchmark(), CELL)
    assert cell["chips"] == 1 and mix.reads_only
    assert not config["independent_blocks"]
    assert mix.setup_blocks(SEED, mix.corpus_bytes) == [(0, 48 << 20)]
    bulk = harness.cell_parts(harness.load_benchmark(), "l1-4m.bulk")[2]
    with pytest.raises(ValueError):           # the card writes no such frame
        harness.codec_settings(config, bulk)
    assert harness.codec_settings(config, mix)["block_size_id"] == 7


def test_sound_read_is_correct(monkeypatch, capsys):
    r, written, reads, routes = _run(monkeypatch, capsys)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 4 and r["failed"] == 0
    assert r["checks"]["corrupt_reads_returned"]["value"] == 0
    assert r["checks"]["host_route_blocks"]["value"] == 0
    assert "decompress_gbps" in r["metrics"]
    assert "compression_ratio" not in r["metrics"]
    [(frame, src)] = written                  # one frame, written once
    assert len(src) == len(reads.outputs[0]) > 3 * (64 << 10)
    assert reads.outputs == [src] * 4
    hdr, p = R.parse_header(frame)
    assert not hdr.flg & 0x20 and not hdr.independent   # linked
    assert hdr.content_checksum and hdr.content_size is None
    # the reference decodes it as linked blocks, and some match reaches
    # into an earlier block: decoded independently it breaks
    records, _end = R.read_blocks(frame, p, hdr.block_checksum)
    assert len(records) == 4
    assert bytes(R.decode_records(records, False, hdr.block_max)[0]) == src
    with pytest.raises(R.FrameError, match="before the window"):
        R.decode_records(records, True, hdr.block_max)
    assert routes == {"linked": 4 * 4}        # 4 reads of 4 blocks


@pytest.mark.parametrize("fault,check,count", [
    ("altered", "outputs_bad", 4), ("raises", "requests_failed", 4),
    # the checksum taken out before each read: every output sound, and
    # the one frame read with its checksum altered comes back
    ("unverified", "corrupt_reads_returned", 1)])
def test_decoder_fault_is_not_correct(monkeypatch, fault, check, count):
    r, _written, _reads, _routes = _run(monkeypatch, fault=fault)
    assert not r["correct"]
    assert r["checks"][check]["value"] == count, r["checks"]
    assert sum(c["value"] for c in r["checks"].values()) == count


def test_read_on_the_host_route_is_not_correct(monkeypatch, capsys):
    from zig_lz4_tpu_torch.parallel import sharded
    # as where the native runtime did not load: the linked resolver
    # gives nothing, and the frame goes to the host frame layer
    monkeypatch.setattr(sharded, "native_resolve_tmap_linked",
                        lambda *a, **k: None)
    r, _written, reads, routes = _run(monkeypatch, capsys)
    assert routes == {"host": 4 * 4}
    assert reads.outputs[0] == _written[0][1]
    assert not r["correct"]
    assert r["checks"]["host_route_blocks"]["value"] == 16
    assert r["checks"]["outputs_bad"]["value"] == 0


def test_independent_setup_frame_is_not_correct(monkeypatch):
    r, written, _reads, _routes = _run(monkeypatch, independent=True)
    assert R.parse_header(written[0][0])[0].independent
    assert not r["correct"]
    assert r["checks"]["frames_bad"]["value"] == 1
    assert r["checks"]["outputs_bad"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "altered", "raises"])
def test_on_the_card_at_the_cells_size(monkeypatch, capsys, fault):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r, written, _reads, routes = _run(monkeypatch, capsys, fault=fault,
                                      device="cuda:0", requests=3)
    assert r["correct"] == (fault is None), r["checks"]
    [(frame, src)] = written
    assert len(src) == 48 << 20
    if fault != "raises":
        assert routes == {"linked": 3 * 12}
