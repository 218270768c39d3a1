"""One run of one cell: set-up, the measured window, the judgement and
the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<name>.json``, its
traffic mix in ``traffic/<mix>.json`` (read by ``traffic.py``), each
metric's reader in ``metrics/<name>.py`` or, for a name with a suffix
such as ``device_idle_pct.enc``, in ``metrics/<base>.py`` called with
the suffix.  Nothing here names a cell, a mix or a metric.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from . import judge as judging
from . import reference
from . import tracing
from .traffic import load_mix

__all__ = ["Call", "Run", "load_benchmark", "cell_parts", "run_cell",
           "forbidden_modules", "result_line"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package (compared whole: the port's name only begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "zig_lz4_tpu")
#: the numbers compared that decide ``correct``, each with its limit:
#: exact counts, so every limit is 0.  ``host_route_blocks`` counts the
#: blocks the window's reads handed to the host frame layer instead of
#: the device (``codec.routes["host"]``: the native runtime did not
#: load); ``corrupt_reads_returned``, where the configuration states
#: that a read verifies the content checksum, the reads of a frame
#: whose stored checksum was altered that returned instead of raising
LIMITS = {"requests_failed": 0, "frames_bad": 0, "outputs_bad": 0,
          "host_route_blocks": 0, "corrupt_reads_returned": 0}
#: source bytes of the distinct frames the reference judges after a run:
#: all of them up to this, else a sample drawn from the seed (the
#: largest frame always in it), so that judging stays shorter than the
#: window
JUDGE_BYTES = 256 << 20


@dataclasses.dataclass
class Call:
    """One request of the window: ``kind`` ``enc`` (compress) or ``dec``
    (decompress), its host-clock seconds, its uncompressed and frame
    bytes, whether it returned (``ok``), and whether it completed
    before the window closed (``counted``)."""
    kind: str
    seconds: float
    content: int
    frame: int
    ok: bool
    counted: bool


@dataclasses.dataclass
class Run:
    """What the metric readers read: the calls, the set-up's seconds,
    the trace of a traced run, the device's peak memory bandwidth, and
    the port's ``codec.routes`` summed over the window's decompress
    calls (blocks by the route that decoded them)."""
    calls: list
    setup_s: float
    trace: object = None
    peak_bytes_per_s: float | None = None
    routes: dict = dataclasses.field(default_factory=dict)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell_parts(bench: dict, workload: str, mix_overrides=None,
               config_overrides=None):
    """(cell, configuration, mix) of cell ``workload``; the overrides
    are laid over the mix's parameters and the configuration's."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[workload]
    config = _json("configs", f"{cell['config']}.json")
    config.update(config_overrides or {})
    return cell, config, load_mix(HERE, cell["traffic"], mix_overrides,
                                  config.get("table"))


def cell_metrics(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries cell ``workload`` reports: its end-to-end
    metrics in a run with ``--trace 0``, its per-layer ones with 1."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [w["name"] for w in
                                                bench["workloads"]])]


def reader(name: str):
    """(read function, suffix) of metric ``name``."""
    base, kind = name, None
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        base, kind = name.rsplit(".", 1)
        path = os.path.join(HERE, "metrics", f"{base}.py")
    spec = importlib.util.spec_from_file_location(
        f"lz4bench.metrics.{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read, kind


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def codec_settings(config: dict, mix=None) -> dict:
    """``ShardedFrameCodec`` arguments for a configuration.  One of
    linked blocks is taken only for a ``mix`` that reads only: its
    frames are written on the host (``host_frame``), and the codec only
    decodes them.  Without a mix (the port's own tests call it so) the
    codec has to write the frames."""
    if not (config["independent_blocks"] or (mix and mix.reads_only)) \
            or config.get("dictionary"):
        raise ValueError("the port's frame codec writes independent "
                         "blocks without a dictionary only")
    bsid = {v: k for k, v in reference.BLOCK_SIZES.items()}[
        config["block_size"]]
    return dict(compression_level=config["compression_level"],
                block_size_id=bsid,
                content_checksum=config["content_checksum"],
                block_checksum=config["block_checksum"])


def host_frame(data: bytes, config: dict, args: dict) -> bytes:
    """A frame of ``data`` as ``config`` states it, written by the
    port's host frame layer (``zig_lz4_tpu_torch.frame``) with the codec
    arguments ``args`` (level, block size, checksums): linked blocks
    through its stream compressors, which keep the last 64 KB as
    history, as ``lz4 -BD`` does.  The frame layer runs its fast codec
    at levels up to 0 (acceleration 1 - level) and HC from 1; liblz4's
    frame API runs levels below 3 on its fast path at acceleration 1,
    so those are written at 0."""
    from zig_lz4_tpu_torch import frame as lz4f
    level = args["compression_level"]
    info = lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID(args["block_size_id"]),
        block_mode=(lz4f.BlockMode.independent if config["independent_blocks"]
                    else lz4f.BlockMode.linked),
        content_checksum=args["content_checksum"],
        block_checksum=args["block_checksum"],
        content_size=len(data) if config["content_size"] else 0)
    return lz4f.compress_frame(data, lz4f.Preferences(
        frame_info=info, compression_level=level if level >= 3
        else min(level, 0)))


def checksum_altered(frame: bytes) -> bytes | None:
    """``frame`` with one bit of its stored content checksum flipped, or
    None where its header declares no content checksum."""
    try:
        hdr, _p = reference.parse_header(frame)
    except reference.FrameError:
        return None
    if not hdr.content_checksum:
        return None
    return frame[:-1] + bytes([frame[-1] ^ 0x01])


def corrupt_reads_returned(codec, frames) -> int:
    """How many of ``frames``, each with its stored content checksum
    altered (``checksum_altered``), ``codec.decompress_frame`` returned
    instead of rejecting."""
    returned = 0
    for frame in frames:
        bad = checksum_altered(frame)
        if bad is None:
            continue
        try:
            codec.decompress_frame(bad)
        except Exception:               # noqa: BLE001  rejected
            continue
        returned += 1
    return returned


def _nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda:0", devices: list | None = None,
             bench: dict | None = None,
             t_start: float | None = None, mix_overrides=None,
             config_overrides=None, wrap=None, settings=None,
             workers: int | None = None, max_requests: int | None = None) -> dict:
    """Run cell ``workload`` once and return its result object.

    ``device`` is where the codec runs (``cpu`` runs the port's plain
    routes, for tests).  A cell of ``chips`` n runs over a
    ``blocks_mesh`` of n devices: ``device`` where n is 1, else the
    first n CUDA devices, or n times ``cpu`` on the CPU route;
    ``devices`` lays the mesh over the devices given instead (tests:
    ``["cuda:0"] * 4`` on one card).  ``t_start`` is the host clock at
    the process's start (set-up is counted from it); ``mix_overrides``
    and ``config_overrides`` lay parameters over the mix and the
    configuration (tests shrink the corpus and the table); ``wrap``
    wraps the codec the window calls, once set-up is over (tests plant
    faults); ``settings`` replace codec arguments (the control);
    ``workers`` processes judge the frames (default: one a core, at most
    8); ``max_requests`` ends the window after that many requests
    (tests)."""
    t0 = time.perf_counter() if t_start is None else t_start
    bench = bench or load_benchmark()
    cell, config, mix = cell_parts(bench, workload, mix_overrides,
                                   config_overrides)
    import torch
    import zig_lz4_tpu_torch
    from zig_lz4_tpu_torch import kernels, native
    from zig_lz4_tpu_torch.parallel import blocks_mesh
    marks = [("imports", time.perf_counter())]
    n = cell["chips"]
    if devices is None:
        devices = ([f"cuda:{k}" for k in range(n)]
                   if n > 1 and device.startswith("cuda") else [device] * n)
    mesh = blocks_mesh(n, devices=devices)
    #: the CUDA cards of the run, each once
    cards = sorted({d.index or 0 for d in mesh.devices if d.type == "cuda"})
    if cards:
        for k in cards:                 # each card's context
            torch.zeros(1, device=f"cuda:{k}")
            torch.cuda.reset_peak_memory_stats(k)   # this run's peak alone
        _synchronize(torch, cards)
        kernels.library()               # built here in a checkout's first run
        marks.append(("CUDA context and kernel library", time.perf_counter()))
    native.is_available()               # the host runtime, likewise
    marks.append(("host runtime", time.perf_counter()))

    corpus = mix.corpus(seed)
    marks.append(("corpus", time.perf_counter()))
    view = memoryview(corpus)
    args = codec_settings(config, mix)
    args.update(settings or {})
    codec = zig_lz4_tpu_torch.ShardedFrameCodec(mesh=mesh, **args)

    requests = mix.requests(seed, len(corpus))
    reads = mix.mix.get("decompress", 0) > 0
    last = last_block = None
    frames: dict = {}          # block -> [[frame, calls that wrote it]]
    if mix.reads_only:
        # set-up: the frames the requests read, each written once on
        # the host and read back once
        for o, s in mix.setup_blocks(seed, len(corpus)):
            frame = host_frame(corpus[o:o + s], config, args)
            codec.decompress_frame(frame)
            frames[(o, s)] = [[frame, 1]]
    else:
        # set-up: a block of each size the requests write, compressed
        # (and read back, where the mix reads)
        for size in sorted({min(s, len(corpus)) for s in mix.size_cycle()}):
            frame = codec.compress_frame(corpus[:size])
            if reads:
                codec.decompress_frame(frame)
            last, last_block = frame, (0, size)
    _synchronize(torch, cards)
    gc.collect()
    marks.append(("frames and warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    timed = wrap(codec) if wrap is not None else codec

    calls: list[Call] = []
    bad_outputs = 0
    routes: dict = {}

    def window():
        nonlocal last, last_block, bad_outputs
        close = time.perf_counter() + seconds
        for req in requests:
            if time.perf_counter() >= close or len(calls) == max_requests:
                break
            n = len(calls)
            if req.kind == "compress":
                block = (req.offset, req.size)
                src = corpus[req.offset:req.offset + req.size]
                ctx = tracing.record(f"enc#{n}") if traced else _Null()
                a = time.perf_counter()
                try:
                    with ctx:
                        frame = timed.compress_frame(src)
                    ok = True
                except Exception as exc:        # noqa: BLE001  a failure
                    _log(f"compress failed: {exc!r}")
                    frame, ok = b"", False
                b = time.perf_counter()
                calls.append(Call("enc", b - a, len(src) if ok else 0,
                                  len(frame), ok, b <= close))
                if ok:
                    held = frames.setdefault(block, [])
                    for h in held:
                        if h[0] == frame:
                            h[1] += 1
                            break
                    else:
                        held.append([frame, 1])
                    last, last_block = frame, block
            else:
                if mix.reads_only:
                    block = (req.offset, req.size)
                    frame = frames[block][0][0]
                else:
                    frame, block = last, last_block
                ctx = tracing.record(f"dec#{n}") if traced else _Null()
                a = time.perf_counter()
                try:
                    with ctx:
                        out = timed.decompress_frame(frame)
                    ok = True
                except Exception as exc:        # noqa: BLE001  a failure
                    _log(f"decompress failed: {exc!r}")
                    out, ok = b"", False
                b = time.perf_counter()
                calls.append(Call("dec", b - a, len(out), len(frame), ok,
                                  b <= close))
                if ok:
                    o, s = block
                    bad_outputs += view[o:o + s] != out
                    for k, v in codec.routes.items():
                        routes[k] = routes.get(k, 0) + v

    events = None
    if traced:
        _, events = tracing.profile(window, cards)
    else:
        window()
    _synchronize(torch, cards)
    dev = _device(torch, mesh.devices, cards)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    # the judgement: the distinct frames the window wrote (all, or a
    # sample drawn from the seed), by the reference; each read's output
    # was compared with its source.  Where reads verify the content
    # checksum, the timed codec reads each with that checksum altered
    every = [((o, s), frame, n) for (o, s), held in frames.items()
             for frame, n in held]
    chosen = judged_sample([s for (_o, s), _f, _n in every], seed)
    checks = {"host_route_blocks": routes.get("host", 0)}
    if config.get("reads_verify_checksum"):
        checks["corrupt_reads_returned"] = corrupt_reads_returned(
            timed, [every[i][1] for i in chosen])
        _log(f"corrupt reads: {checks['corrupt_reads_returned']} of "
             f"{len(chosen)} frames with an altered content checksum "
             f"returned")
    del codec, timed
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    smi = _nvidia_smi() if cards else "cpu"

    items = [(every[i][1], view[every[i][0][0]:sum(every[i][0])])
             for i in chosen]
    weights = [every[i][2] for i in chosen]
    tj = time.perf_counter()
    if workers is None:
        workers = min(len(os.sched_getaffinity(0)), 8)
    reasons = judging.check_frames(items, config, workers)
    judge_s = time.perf_counter() - tj
    bad_frames = sum(w for w, r in zip(weights, reasons) if r)
    for r in sorted({r for r in reasons if r}):
        _log(f"frame rejected: {r}")
    checks.update({"requests_failed": sum(not c.ok for c in calls),
                   "frames_bad": bad_frames, "outputs_bad": int(bad_outputs)})
    checks = {k: checks[k] for k in LIMITS if k in checks}

    peaks = _json("peaks.json")
    run = Run(calls, setup_s,
              peak_bytes_per_s=peaks.get(dev["kind"], {}).get(
                  "memory_bytes_per_s"), routes=routes)
    if traced:
        run.trace = tracing.Trace(
            events, {i: (c.content, c.frame) for i, c in enumerate(calls)
                     if c.counted and c.ok}, cards or None)
        dev["busy_s"], dev["window_s"] = run.trace.window_busy()
        dev["busy_union_s"] = run.trace.window_busy_union()
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        read, kind = reader(m["name"])
        value = read(run, kind)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    counted = [c for c in calls if c.counted]
    _log(f"device: {dev['kind']} x{dev['count']}; nvidia-smi: {smi}")
    _log(f"calls: {len(calls)} attempted, {len(counted)} completed in the "
         f"{seconds} s window ({sum(c.kind == 'enc' for c in counted)} "
         f"compress, {sum(c.kind == 'dec' for c in counted)} decompress); "
         f"set-up {setup_s:.3f} s; judged {len(items)} of {len(every)} "
         f"distinct frames ({sum(len(src) for _f, src in items)} of "
         f"{sum(s for (_o, s), _f, _n in every)} source bytes, written by "
         f"{sum(weights)} of {sum(n for _b, _f, n in every)} calls) in "
         f"{judge_s:.3f} s")
    for kind in ("enc", "dec"):
        ms = [1e3 * c.seconds for c in counted if c.kind == kind and c.ok]
        if len(ms) >= 4:
            q = [round(x, 3) for x in statistics.quantiles(ms, n=4)]
            k = len(ms) // 4
            by_q = [round(sum(ms[i * k:(i + 1) * k]) / k, 3) for i in range(4)]
            _log(f"{kind} ms: min {min(ms):.3f} quartiles {q} max "
                 f"{max(ms):.3f}; mean by quarter of the window {by_q}")
    prev, parts = t0, []
    for what, t in marks:
        parts.append(f"{what} {t - prev:.3f}")
        prev = t
    _log(f"set-up by part (s): {'; '.join(parts)}")
    _log(f"launches: {json.dumps(launches, sort_keys=True)}")
    _log(f"blocks by route: {json.dumps(routes, sort_keys=True)}")
    result = {"correct": all(checks[k] <= LIMITS[k] for k in checks),
              "attempted": len(calls),
              "failed": checks["requests_failed"],
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                        for k in checks}
    found = forbidden_modules()         # the readers have loaded too
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    return result


def judged_sample(sizes: list, seed: int, budget: int = JUDGE_BYTES) -> list:
    """Indices of the frames to judge, by their sources' ``sizes``:
    every one where they sum to ``budget`` or less; else the largest,
    then others in an order drawn from ``seed``, while they fit."""
    if sum(sizes) <= budget:
        return list(range(len(sizes)))
    first = max(range(len(sizes)), key=lambda i: sizes[i])
    chosen, total = [first], sizes[first]
    order = np.random.default_rng([seed & (2 ** 64 - 1), 3]).permutation(
        len(sizes))
    for i in order:
        if i != first and total + sizes[i] <= budget:
            chosen.append(int(i))
            total += sizes[i]
    return sorted(chosen)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _synchronize(torch, cards: list) -> None:
    """Wait until every CUDA card of the run has finished its work."""
    for k in cards:
        torch.cuda.synchronize(k)


def _device(torch, placed, cards: list) -> dict:
    """The result's ``device`` for a run over the mesh devices ``placed``
    and the CUDA ``cards`` among them, each once: ``count`` is the
    number of cards (on the CPU route, of the mesh's virtual devices),
    ``memory_peak_bytes`` the fullest card's peak and
    ``memory_peak_bytes_by_card`` each card's, in the order of
    ``cards``; ``kind`` is the first card's name."""
    if not cards:
        return {"platform": "cpu", "kind": "cpu", "count": len(placed),
                "memory_peak_bytes": 0,
                "memory_peak_bytes_by_card": [0] * len(placed)}
    names = {k: torch.cuda.get_device_name(k) for k in cards}
    if len(set(names.values())) > 1:
        _log(f"cards differ: {json.dumps(names, sort_keys=True)}")
    peaks = [int(torch.cuda.max_memory_allocated(k)) for k in cards]
    return {"platform": "gpu", "kind": names[cards[0]], "count": len(cards),
            "memory_peak_bytes": max(peaks),
            "memory_peak_bytes_by_card": peaks}


def result_line(result: dict) -> str:
    """The result's last lines on standard error (each number compared
    beside its limit) and its one line for standard output."""
    for k, v in result["checks"].items():
        _log(f"check {k} {v['value']} limit {v['limit']}")
    return json.dumps(result)
