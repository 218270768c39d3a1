"""The control of the judgement: the cell run as it is, with the port's
codec made to break one guarantee its configuration states, which has to
come out not correct.

The guarantee broken is the content checksum, the step a change that
skips the host's xxh32 to gain speed would take.  Where the
configuration states that every frame carries the xxh32 of its input,
the control writes frames without it.  Where it states besides that
every read verifies that checksum (``reads_verify_checksum``), the
control reads instead: the timed decoder is handed each frame with its
checksum taken out, so that it decodes everything and verifies nothing.
Every other part of the run is the benchmark's own.

    python3 lz4bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

prints one JSON line a seed (``correct`` and the numbers compared) and
exits 0 only where every seed came out not correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == \
        os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = _ROOT
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def control_settings(config: dict) -> dict:
    """Codec arguments that break the configuration's content checksum."""
    return {"content_checksum": not config["content_checksum"]}


def without_checksum(frame: bytes) -> bytes:
    """``frame`` (one LZ4 frame with a content checksum) with that
    checksum taken out: the FLG bit cleared, the header checksum
    written anew, the last four bytes left off."""
    from lz4bench import reference as R
    _hdr, p = R.parse_header(frame)
    head = bytearray(frame[:p])
    head[4] &= ~0x04
    head[-1] = (R.xxh32(bytes(head[4:-1])) >> 8) & 0xFF
    return bytes(head) + frame[p:-4]


class Unverified:
    """The codec, reading each frame with its content checksum taken
    out (``without_checksum``): a read that verifies nothing."""

    def __init__(self, codec):
        self.codec = codec

    def decompress_frame(self, frame):
        return self.codec.decompress_frame(without_checksum(frame))

    def __getattr__(self, name):
        return getattr(self.codec, name)


def control_run(config: dict) -> dict:
    """``run_cell`` arguments that break the content checksum: the read
    where reads verify it, else the frames written."""
    if config.get("reads_verify_checksum"):
        return {"wrap": Unverified}
    return {"settings": control_settings(config)}


def run_control(workload, seeds, seconds, device="cuda:0", **kw) -> list:
    from lz4bench import harness
    bench = harness.load_benchmark()
    _cell, config, _mix = harness.cell_parts(bench, workload)
    out = []
    for seed in seeds:
        r = harness.run_cell(workload, seed, seconds, False, bench=bench,
                             device=device, **control_run(config), **kw)
        out.append({"workload": workload, "seed": seed,
                    "correct": r["correct"], "attempted": r["attempted"],
                    "checks": r["checks"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    lines = run_control(a.workload, a.seeds, a.seconds)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0 if not any(x["correct"] for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
