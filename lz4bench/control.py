"""The control of the judgement: the cell run as it is, with the port's
codec made to break one guarantee its configuration states, which has to
come out not correct.

The guarantee broken is the content checksum (every frame carries the
xxh32 of its input): the control writes frames without it, the step a
change that skips the host's xxh32 to gain speed would take.  Every
other part of the run is the benchmark's own.

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


def run_control(workload, seeds, seconds, device="cuda:0", **kw) -> list:
    from lz4bench import harness
    bench = harness.load_benchmark()
    _cell, config, _mix = harness.cell_parts(bench, workload)
    out = []
    for seed in seeds:
        r = harness.run_cell(workload, seed, seconds, False, bench=bench,
                             device=device,
                             settings=control_settings(config), **kw)
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
