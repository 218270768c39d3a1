#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zig_lz4_tpu_torch) on one GPU.

Builds the CUDA kernels and the C++ host runtime from the sources in
this checkout, holds each kernel against its plain PyTorch version on
the card, and drives these paths over the bench's 48 MB corpus in 64 KB
blocks, most of them through ``ShardedFrameCodec``:

* level 9: ``compress_frame`` and ``decompress_frame`` of independent
  blocks (kernels ``enc_match``, ``enc_parse_emit``, ``tmap_gather``);
* level 0: the same with the fast finder (``enc_match_fast``), and the
  acceleration ratios and a level-4 round trip;
* linked frames: ``decompress_frame`` of a linked-block frame written
  by the host frame layer (``linked_tmap_step``, one launch per
  non-empty window for both the window and the new history), and
  dictionary frames of both kinds;
* windows over 64 KB (``enc_match_wide`` with ``enc_parse_emit``): the
  two kernels against their plain versions on wide edge windows, corpus
  sub-span windows and windows dense in ties, the JAX payloads of
  ``tests/fixtures/wide_corpus.npz``, then ``compress_frame`` and both
  decoders of 16 MB with a 70,000-byte dictionary at levels 9 and 0
  (131,072-byte windows), of 16 MB in 256 KB blocks at level 9, of the
  corpus in 1 MB blocks at levels 9 and 0 and of 16 MB in 4 MB blocks
  at level 9 (327,680-byte sub-span windows);
* levels 10-12 in windows over 64 KB (``enc_deep_match_wide`` with
  ``enc_deep_dp`` and ``enc_deep_emit``): the three kernels against their
  plain versions at deep 1, 2 and 3 on wide edge windows, corpus
  sub-span windows and windows dense in ties, the JAX payloads of
  ``tests/fixtures/wide_deep_corpus.npz``, then ``compress_frame`` and
  both decoders of the corpus in 1 MB blocks at level 12, of 16 MB with
  the 70,000-byte dictionary at level 10 and of 16 MB in 4 MB blocks at
  level 11;
* levels 10, 11 and 12: ``compress_frame`` through the deep finder, the
  price parse and the extension (``enc_deep_match``, ``enc_deep_dp``,
  ``enc_deep_emit``), each frame decoded by the host decoder and by the
  port;
* the block codec ``get_codec("cuda12")``: ``compress`` then
  ``decompress`` of one block through the sequence-rebuild decoder
  (``seq_decode``); the batched ``decode_blocks`` over the compressed
  blocks of the level-12 frame, and the serial decoder (``serial_decode``,
  the counterpart of the Pallas decoder ``experiments/pallas_decode.py``)
  over the same blocks; and ``decompress_frame`` of an independent frame
  in a child process that runs without the native host runtime
  (``ZIG_LZ4_TPU_NO_NATIVE=1``), where ``seq_decode`` takes the place of
  the T-map decoder;
* the fragment ladder: ``decompress_frame`` under ``decode_engine``
  "mixed", "win" and "chase" of the level-9 frame and under "mixed" of
  the level-0 frame (``frag_decode_win``, ``frag_decode_chase``, and
  ``tmap_gather`` for what the ladder leaves), of a frame of 256 KB
  blocks under "win" (``frag_decode``), of a frame of 1 MB blocks under
  "mixed" (the narrow big-block tiers of ``frag_decode_chase``) and of
  a dictionary frame under "chase"; each path prints its blocks by
  route;
* the bitonic probe (``bitonic_sort2``, the counterpart of the Pallas
  sort ``experiments/pallas_sort_probe.py``; one thread-block cluster a
  row) at 1 and 64 rows of 65,536 int32 keys and payloads, against its
  plain version and ``torch.sort``.

The plain versions of the deep encoder kernels run Python loops over
every position, so those kernels are held against them on the edge-case
windows and on every 12th corpus block (64 windows, every content
type); all 768 windows are held by the level-12 ratio, by the checked-in
JAX payloads and by the round trips.  The wide kernels meet their plain
versions on every 12th window of the 1 MB paths as well.

``enc_match`` and ``enc_parse_emit`` meet their plain versions on 22
edge windows (eight of them dense in ties), on every window of the 64 KB
paths at levels 9, 4 and 0, and ``enc_parse_emit`` on every window of
the wide paths at levels 0-9; ``enc_match_fast`` meets its plain
version at accelerations 1, 2, 4 and 8 on the 22 edge windows, at 1 on
every window of the level-0 path and at 2, 4 and 8 on every 12th.  The
three are timed phase by phase: the smoke builds ``encode_block.cu``
four more times with ``-DZL4_STOP=k``, which stops each kernel after its
k-th phase, and times every cut on the same inputs; ``enc_match``'s
12-byte order and ``enc_match_fast``'s s0 order are held against a
batched stable ``torch.sort`` of their three words and their one word,
which is timed beside each as a yardstick for that sort alone.  The two wide finders, which sort
by radix passes across a thread-block cluster a window, get the same
at the 1 MB paths' launch (192 windows of 327,680 bytes): cuts of
``encode_wide.cu`` (level 9) and ``encode_deep_wide.cu`` (level 12)
timed phase by phase, their first orders held against ``torch.sort``
of their three or eight words, their launch shape and
``cudaOccupancyMaxActiveClusters``, ptxas's registers and spills, and
each finder timed at every one of its launches on the nine wide paths
(launches x ms).  So does the 64 KB deep finder ``enc_deep_match``,
which sorts by radix passes in one block's shared memory: the cuts of
``encode_deep.cu`` (eight more builds) at levels 12 and 10, its 32-byte
order against ``torch.sort`` of its eight words, and ptxas; every cut
also stops ``enc_deep_dp`` after its chain extension, which splits that
kernel into its chain and its warp-parallel price parse, and stops
``enc_deep_emit`` after its take mask (cut 1), its walk (cut 2) or its
compaction (cuts 3-8), which splits it into its mask, walk, absorb and
emission at 64 KB (levels 12 and 10) and at the 1 MB level-12 launch.
``enc_deep_emit`` also meets its plain version on a window whose capped
chosen rows outnumber its extension pool of 512.  The three
deep kernels are timed at every one of their launches on the counted
paths (the three 64 KB levels, the block codec and, for ``enc_deep_dp``
and ``enc_deep_emit``, the three wide deep paths), and the ``[rank]``
line prices them by those sums.

It checks the round trips and the ratios, shows by launch counts that
each path went through its kernels (the wide paths through
``enc_match_wide`` or ``enc_deep_match_wide`` and never the 64 KB
finders), times paths and kernels
with CUDA events, and computes each kernel's bound from this run's
inputs.  Kernels small enough for the launch to matter (the linked step,
the bitonic probe) and their library calls get two times: "launch ms",
20 calls through their wrappers between CUDA events, host work inside;
and "device ms", 20 launches captured in one CUDA graph and replayed
between CUDA events, on tensors allocated before the capture.  It also
prints the host microseconds a call of ``kernels.launch`` costs, beside
those of the parent commit's wrapper (``parent_launch`` below).

``seq_decode``, ``serial_decode``, ``frag_decode_chase``,
``frag_decode_win`` and ``frag_decode``, which rebuild a block in shared
memory (by pointer jumping; by a serial walk of the matches; the last
three in a thread-block cluster's shared memory), are timed phase by
phase from the cuts of ``seq_decode.cu``, ``serial_decode.cu`` and
``frag_decode.cu`` (-DZL4_STOP=1..3; 1..2 for the serial walk and the
byte-granular decoder), and held against plain on their worst cases:
64 KB chains through every sequence (with no history and into a 64 KB
history) and a 65,535-byte run at offset 1; ``serial_decode`` also at
262,144-byte rows (its warp route, past the shared-memory row); the chase
at every configuration on 256 KB blocks (a cluster of 8) and 1 MB blocks
(device scratch), the windowed decoder at every windowed configuration
and the byte-granular decoder at every byte-granular one on 256 KB
blocks (a cluster of 8) and 512 KB rows (device scratch), at both
launches of the level-9 "win" path and at the 256 KB "win" path's
launch, each with its launch shape and occupancy; the 256 KB "win" path
also by stage.

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

To compare the encoder kernels of two checkouts in one call (at the
64 KB and the 1 MB paths' shapes), run ``python3 /path/to/chip_smoke.py
--time-encoder-kernels`` from each checkout's root in turns
(``time_encoder_kernels`` below); ``--time-decode-kernels`` does the
same for ``seq_decode`` (the level-12 frame's 672 blocks and 32 of
them), ``serial_decode`` (the 672 blocks), ``frag_decode_chase`` (the
"chase" path's 141-block launch), ``frag_decode_win`` (both launches
of the "win" path) and ``frag_decode`` (the 256 KB "win" path's launch)
(``time_decode_kernels``).

Exits non-zero on any failed check.  Imports no JAX.  The last two
lines of stdout are the card's name and power limit as nvidia-smi
reports them, then ``{"ok": true, "device": {...}}``; before them one
JSON line lists every kernel with its launches, error, times and bound.
"""

import gc
import hashlib
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

BLK = 65536
#: the bench trims the corpus to whole batches of 64 blocks
BENCH_BATCH = 64
#: ratios n / sum(out_len) of the reference on the same corpus; they
#: depend on the bytes alone: level 9, level 0, and level 0's finder at
#: acceleration 2, 4, 8
EXPECT_RATIO = 3.1493
EXPECT_RATIO_FAST = 2.4175
EXPECT_RATIO_ACCEL = {2: 2.3525, 4: 2.2022, 8: 2.0919}
#: the deep levels; the reference recorded a ratio at level 12 only
DEEP_LEVELS = (10, 11, 12)
EXPECT_RATIO_DEEP = {12: 3.3168}
#: JAX payloads of the same make_corpus(2) blocks at a deep level
DEEP_GOLDENS = os.path.join("tests", "fixtures", "deep_corpus64k_l{}.npz")
#: the deep kernels meet their plain versions on every 12th block of the
#: corpus, whose content types change every 256 KB (4 blocks)
PLAIN_STRIDE = 12
#: blocks of the frame that the child process decodes without the native
#: host runtime (every 12th: parsing and checksums run in Python there),
#: and blocks of the level-12 frame that meet the plain sequence decoder
CHILD_FLAG = "--decode-without-native"
#: the mode that times the encoder kernels alone at the 64 KB and 1 MB
#: paths' shapes, with the package of the current directory
#: (time_encoder_kernels)
ENCODER_FLAG = "--time-encoder-kernels"
#: the mode that times the decode kernels alone at the paths' shapes
#: (time_decode_kernels)
DECODE_FLAG = "--time-decode-kernels"
DEEP_KERNELS = ("enc_deep_match", "enc_deep_dp", "enc_deep_emit")
#: the CLI's compress runs over the corpus with --engine cuda: flag ->
#: the kernels the run must launch
CLI_ENCODES = {"-1": ("enc_match_fast", "enc_parse_emit"),
               "-9": ("enc_match", "enc_parse_emit"),
               "-12": DEEP_KERNELS,
               "-B5": ("enc_match_wide", "enc_parse_emit")}
#: argument of the two-process run's children: coordinator, rank, corpus;
#: or ``env`` and the corpus under torchrun
MULTIHOST_FLAG = "--multihost-rank"
SEQ_PLAIN_BLOCKS = 32
#: make_corpus(2) blocks (one per content type) with their JAX payloads
#: at level 9, and at levels 0 and 4
GOLDENS = os.path.join("tests", "fixtures", "l9_corpus64k.npz")
LEVEL_GOLDENS = os.path.join("tests", "fixtures", "levels_corpus64k.npz")
#: configurations held against plain on the edge-case windows: (hc, accel)
EDGE_CONFIGS = [(9, 1), (0, 1), (0, 2), (0, 4), (0, 8), (2, 1), (5, 1),
                (8, 1)]
#: timed runs of each path's calls
REPS = 5
#: the ladder kernels against their plain versions: (split_max,
#: round_limit) of the resolve, then the configurations.  ``clears``
#: marks a configuration that must clear ``ok`` on some block.
LADDER_FRAGS = ((8, 12), [dict(rounds=2), dict(rounds=12),
                          dict(rounds=0, clears=True)])
LADDER_WIN = ((8, 12), [
    dict(rounds=2, g=16), dict(rounds=8, g=8, fcap=16384),
    dict(rounds=8, g=8), dict(rounds=8, g=16, fcap=16384),
    dict(rounds=12, g=16, lit_wins=0, lit_pool=0),
    dict(rounds=12, g=8, pool=4, clears=True)])
LADDER_CHASE = ((8, 64), [
    dict(dense=3, doublings=0, qcap=0), dict(dense=4, doublings=0, qcap=0),
    dict(dense=5, doublings=1, qcap=4096),
    dict(dense=0, doublings=1, qcap=0, clears=True)])
#: windows over 64 KB (enc_match_wide): make_corpus(2) windows and their
#: JAX payloads; the width of the sub-span windows of 1 MB and 4 MB
#: blocks; the configurations held against plain on the wide edge
#: windows: (hc, accel)
WIDE_GOLDENS = os.path.join("tests", "fixtures", "wide_corpus.npz")
SUB_WINDOW = 327680
WIDE_CONFIGS = [(9, 1), (4, 1), (0, 1), (0, 8)]
#: wide windows of the 1 MB path held against the plain versions (every
#: 12th of 192)
WIDE_PLAIN_STRIDE = 12
#: levels 10-12 in windows over 64 KB (enc_deep_match_wide with
#: enc_deep_dp and enc_deep_emit): make_corpus(2) windows and their JAX
#: payloads; deep level -> (131,072-byte edge windows, 327,680-byte corpus
#: windows) held against the plain versions; the windows of the 1 MB
#: level-12 path held against them (every 48th of 192)
WIDE_DEEP_GOLDENS = os.path.join("tests", "fixtures", "wide_deep_corpus.npz")
WIDE_DEEP_EDGE = {1: ([0, 3, 4], [0]), 2: ([1, 5, 6], [1]),
                  3: ([0, 1, 2, 3, 4, 5, 6, 7], [0, 1])}
WIDE_DEEP_PLAIN_STRIDE = 48
WIDE_KERNELS = ("enc_match_wide", "enc_parse_emit", "tmap_gather")
WIDE_DEEP_KERNELS = ("enc_deep_match_wide", "enc_deep_dp", "enc_deep_emit",
                     "tmap_gather")
#: the phase cuts (-DZL4_STOP=1..k) built beside the library, by source:
#: enc_match and enc_parse_emit (encode_block.cu), the two wide finders,
#: enc_deep_match with enc_deep_dp (encode_deep.cu), seq_decode, the
#: shared-memory route of serial_decode, and the cluster routes of
#: frag_decode, frag_decode_chase and frag_decode_win (frag_decode.cu)
PHASE_CUTS = {"encode_block.cu": 4, "encode_wide.cu": 4,
              "encode_deep_wide.cu": 8, "encode_deep.cu": 8,
              "seq_decode.cu": 3, "frag_decode.cu": 3, "serial_decode.cu": 2}
#: phases of seq_decode, of serial_decode's shared-memory route and of
#: the cluster routes of frag_decode_chase and frag_decode_win, one a cut
#: (1, 2, 3) and the last the rest
SEQ_PHASES = ("seg_start", "fill", "rounds", "write-out")
SERIAL_PHASES = ("literals", "walk", "write-out")
CHASE_PHASES = ("one-hop sources", "dense rounds", "frontier", "final gather")
WIN_PHASES = ("sources and coverage", "pools", "rounds", "ok and store")
#: phases of frag_decode's cluster route, one a cut (1, 2) and the last the
#: rest
FRAG_PHASES = ("sources and literals", "rounds", "ok and store")
#: phases of the wide finders and of enc_deep_match, one a cut and the
#: last the rest
WIDE_PHASES = ("window words", "12-byte sort", "probes +-9", "s0 sort",
               "fallback probes")
WIDE_DEEP_PHASES = ("window words", "32-byte sort", "32-byte rank numbering",
                    "256-byte rank sort", "256-byte rank numbering",
                    "grand sort", "tier probes", "s0 sort",
                    "fallback probes")
#: phases of enc_deep_emit, one a cut (1, 2, 3) and the last the rest
DEEP_EMIT_PHASES = ("take mask", "walk", "absorb and compaction", "emission")
#: kernels whose registers and spills the build log gives
PTXAS_KERNELS = ("enc_match_kernel", "enc_match_fast_kernel",
                 "enc_parse_emit_kernel", "enc_deep_emit_kernel",
                 "enc_match_wide_kernel<20>", "enc_match_wide_kernel<32>",
                 "enc_deep_match_wide_kernel<20>",
                 "enc_deep_match_wide_kernel<32>", "enc_deep_match_kernel",
                 "enc_deep_dp_kernel", "seq_decode_kernel",
                 "frag_chase_cluster_kernel", "frag_decode_chase_kernel",
                 "serial_smem_kernel", "serial_decode_kernel",
                 "frag_win_cluster_kernel<8>", "frag_win_cluster_kernel<16>",
                 "frag_decode_win_kernel<8>", "frag_decode_win_kernel<16>",
                 "frag_win_cluster_kernel<0>", "frag_decode_kernel")
#: n / frame bytes of the 1 MB-block paths (the reference's frames, whose
#: SHA-256 the wide goldens hold, give the same)
EXPECT_RATIO_WIDE = {"1 MB blocks, level 9": 3.253950,
                     "1 MB blocks, level 12": 3.444090}
#: rows of the bitonic probe (P2), 65,536 int32 keys each
SORT_BATCHES = (1, 64)
#: published peaks of one H100 SXM: device memory bytes/s, and 32-bit
#: scalar operations/s outside the tensor cores (the float32 rate; the
#: kernels' compares and shifts are counted against it)
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=1):
    """Mean milliseconds of ``fn()`` between CUDA events (host work
    inside ``fn`` is inside the window), and its last result."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        res = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, res


def graph_ms(fn, reps=20):
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in
    one CUDA graph, replayed between CUDA events.  ``fn`` must allocate
    nothing that outlives the capture."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def parent_launch(name, *args):
    """``kernels.launch`` as the parent commit had it, kept to time the
    wrapper's host cost against: the device guard, the stream object and
    the function's lookup on every call."""
    import torch
    from zig_lz4_tpu_torch import kernels
    fn, _src, argtypes, _ref = kernels.KERNELS[name]
    dev = None
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device.type != "cuda" or not a.is_contiguous():
                raise ValueError(f"{name}: tensors must be contiguous "
                                 f"CUDA tensors, got {a.device}")
            if dev is not None and a.device != dev:
                raise ValueError(f"{name}: tensors on {dev} and {a.device}")
            dev = a.device
            cargs.append(a.data_ptr())
        else:
            cargs.append(int(a))
    if len(cargs) != len(argtypes):
        raise TypeError(f"{name}: {len(argtypes)} arguments, got "
                        f"{len(cargs)}")
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    kernels.LAUNCHES[name] += 1


def host_us(fn, calls=1000):
    """Host microseconds a call of ``fn``, after 50 warm-up calls; the
    device drains before and after."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def start_phase_builds(kernels):
    """Start one nvcc a phase cut (-DZL4_STOP=k) of each timed source --
    ``encode_block.cu`` (k = 1..4), ``encode_wide.cu`` (1..4),
    ``encode_deep_wide.cu`` (1..8) and ``encode_deep.cu`` (1..8) -- each
    into a library of its own under
    the kernels' build directory, all at once; returns [(source, k,
    library path, process)]."""
    csrc = os.path.join(os.path.dirname(kernels.__file__), "csrc")
    out = os.path.join(os.path.dirname(os.path.dirname(kernels.__file__)),
                       "_build")
    os.makedirs(out, exist_ok=True)
    jobs = []
    for src, cuts in PHASE_CUTS.items():
        for k in range(1, cuts + 1):
            so = os.path.join(out, f"{src[:-3]}_stop{k}.so")
            cmd = [kernels._nvcc(), "-gencode",
                   "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-Xcompiler", "-fPIC", "-shared", f"-DZL4_STOP={k}",
                   "-o", so, os.path.join(csrc, src)]
            jobs.append((src, k, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    return jobs


def finish_phase_builds(jobs):
    """Wait for the phase cuts' builds: {source: {k: loaded library}}."""
    import ctypes
    libs = {}
    for src, k, so, proc in jobs:
        log = proc.communicate()[0]
        check(proc.returncode == 0,
              f"nvcc -DZL4_STOP={k} {src} failed:\n{log}")
        libs.setdefault(src, {})[k] = ctypes.CDLL(so)
    return libs


def phase_split(libs, w, l, s, pk, hc, capped_ml):
    """Milliseconds of each phase cut of ``enc_match`` (at ``hc``), of
    ``enc_parse_emit`` (on ``pk``, HC parse) and of ``enc_match_fast``
    (acceleration 1; its cuts 1 and 2) at the windows ``w``, from the
    cuts of ``encode_block.cu``, called through ctypes (not counted as
    launches), and what the ZL4_STOP=2 cuts of the two finders leave:
    each window's order after its 12-byte sort and after its s0 sort.
    Returns ({k: match ms}, {k: emit ms}, {k: fast ms}, order, s0
    order)."""
    import ctypes

    import torch
    from zig_lz4_tpu_torch.constants import compress_bound
    from zig_lz4_tpu_torch.ops import torch_block as tb
    B, blk = w.shape
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    cap = compress_bound(blk)
    cut = torch.empty_like(pk)
    mlw = torch.empty_like(pk)
    runs = torch.empty((B, (blk // 4 + 1) + 3 * (blk // 4 + 2)),
                       dtype=torch.int32, device=w.device)
    out = torch.empty((B, cap), dtype=torch.uint8, device=w.device)
    olen = torch.empty(B, dtype=torch.int32, device=w.device)
    W, probes = tb.fast_params(1)
    m_ms, e_ms, f_ms, order, order_s0 = {}, {}, {}, None, None
    for k, lib in libs["encode_block.cu"].items():
        fm, fe = lib.zl4_enc_match, lib.zl4_enc_parse_emit
        ff = lib.zl4_enc_match_fast
        fm.argtypes, fm.restype = [P] * 3 + [I] * 3 + [P], I
        fe.argtypes, fe.restype = [P] * 8 + [I] * 6 + [P], I
        ff.argtypes, ff.restype = [P] * 3 + [I] * 4 + [P], I

        def match():
            check(fm(w.data_ptr(), l.data_ptr(), cut.data_ptr(), B, blk, hc,
                     stream) == 0, f"enc_match cut {k} did not launch")

        def emit():
            check(fe(w.data_ptr(), l.data_ptr(), s.data_ptr(), pk.data_ptr(),
                     mlw.data_ptr(), runs.data_ptr(), out.data_ptr(),
                     olen.data_ptr(), B, blk, cap, runs.shape[1], capped_ml,
                     1, stream) == 0, f"enc_parse_emit cut {k} did not "
                  "launch")
        def fast():
            check(ff(w.data_ptr(), l.data_ptr(), cut.data_ptr(), B, blk, W,
                     probes, stream) == 0, f"enc_match_fast cut {k} did not "
                  "launch")
        match()
        emit()
        m_ms[k] = cuda_ms(match, 2)[0]
        e_ms[k] = cuda_ms(emit, 2)[0]
        if k == 2:
            order = cut.clone()
        if k <= 2:
            fast()
            f_ms[k] = cuda_ms(fast, 2)[0]
        if k == 2:
            order_s0 = cut.clone()
    return m_ms, e_ms, f_ms, order, order_s0


def wide_phase_split(libs, w, l, hc, deep=0):
    """Milliseconds of each phase cut of ``enc_match_wide`` (``deep`` 0)
    or ``enc_deep_match_wide`` at the windows ``w`` (the cuts of
    ``encode_wide.cu`` or ``encode_deep_wide.cu``, through ctypes, not
    counted), and what the ZL4_STOP=2 cut leaves: each window's order
    after its first sort (the 12-byte order at hc >= 1, the 32-byte order
    of the deep finder).  Returns ({k: ms}, order)."""
    import ctypes

    import torch
    from zig_lz4_tpu_torch.ops import torch_block as tb
    B, blk = w.shape
    C, J = tb.wide_cluster_shape(blk)
    nwords = (blk + 64) // 4 + 1
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    words = torch.empty((B, nwords), dtype=torch.int32, device=w.device)
    ranks = torch.empty((B, 2 if deep == 3 else 1, blk), dtype=torch.int32,
                        device=w.device)
    cut = torch.empty((B, blk), dtype=torch.int32, device=w.device)
    ms, order = {}, None
    src = "encode_deep_wide.cu" if deep else "encode_wide.cu"
    for k, lib in libs[src].items():
        if deep:
            f = lib.zl4_enc_deep_match_wide
            f.argtypes = [P] * 5 + [I] * 7 + [P]
            args = (w.data_ptr(), l.data_ptr(), words.data_ptr(),
                    ranks.data_ptr(), cut.data_ptr(), B, blk, nwords, C, J,
                    hc, deep, stream)
        else:
            f = lib.zl4_enc_match_wide
            f.argtypes = [P] * 4 + [I] * 8 + [P]
            args = (w.data_ptr(), l.data_ptr(), words.data_ptr(),
                    cut.data_ptr(), B, blk, nwords, C, J, hc, 8,
                    tb.fast_params(1)[1], stream)
        f.restype = I

        def run():
            check(f(*args) == 0, f"{src} cut {k} did not launch")
        run()
        ms[k] = cuda_ms(run, 2)[0]
        if k == 2:
            order = cut.clone()
    return ms, order


def deep_phase_split(libs, w, l, s, pk, hc, deep):
    """Milliseconds of each phase cut of ``enc_deep_match`` at ``deep`` on
    the windows ``w`` (the cuts of ``encode_deep.cu``, through ctypes, not
    counted), what its ZL4_STOP=2 cut leaves (each window's 32-byte
    order), and the milliseconds of ``enc_deep_dp``'s chain extension
    alone on the candidates ``pk`` (every cut stops that kernel there).
    Returns ({k: ms}, order, chain ms)."""
    import ctypes

    import torch
    from zig_lz4_tpu_torch.ops import torch_block as tb
    B, blk = w.shape
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    ranks = torch.empty((B, 2 if deep == 3 else 1, blk), dtype=torch.int32,
                        device=w.device)
    cut = torch.empty((B, blk), dtype=torch.int32, device=w.device)
    st = torch.empty_like(cut)
    ms, order = {}, None
    for k, lib in libs["encode_deep.cu"].items():
        f = lib.zl4_enc_deep_match
        f.argtypes, f.restype = [P] * 4 + [I] * 4 + [P], I

        def run():
            check(f(w.data_ptr(), l.data_ptr(), ranks.data_ptr(),
                    cut.data_ptr(), B, blk, hc, deep, stream) == 0,
                  f"encode_deep.cu cut {k} did not launch")
        run()
        ms[k] = cuda_ms(run, 2)[0]
        if k == 2:
            order = cut.clone()
    g = libs["encode_deep.cu"][1].zl4_enc_deep_dp
    g.argtypes, g.restype = [P] * 4 + [I] * 4 + [P], I

    def chain():
        check(g(l.data_ptr(), s.data_ptr(), pk.data_ptr(), st.data_ptr(), B,
                blk, 4 + 4 * tb._W, deep, stream) == 0,
              "enc_deep_dp's chain cut did not launch")
    chain()
    return ms, order, cuda_ms(chain, 2)[0]


def deep_emit_phase_split(libs, w, l, s, pk, st):
    """Milliseconds of the phase cuts 1-3 of ``enc_deep_emit`` (the cuts of
    ``encode_deep.cu``, through ctypes, not counted) on the windows ``w``
    with the finder's candidates ``pk`` and the state words ``st``: the
    take mask, then the walk, then the absorb and compaction.  Returns
    {k: ms}."""
    import ctypes

    import torch
    from zig_lz4_tpu_torch.constants import compress_bound
    B, blk = w.shape
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    cap, chcap = compress_bound(blk), blk // 4 + 1
    chosen = torch.empty((B, chcap), dtype=torch.int32, device=w.device)
    ents = torch.empty((B, 4 * chcap), dtype=torch.int32, device=w.device)
    runs = torch.empty((B, 3 * (blk // 4 + 2)), dtype=torch.int32,
                       device=w.device)
    out = torch.empty((B, cap), dtype=torch.uint8, device=w.device)
    olen = torch.empty(B, dtype=torch.int32, device=w.device)
    ms = {}
    for k in (1, 2, 3):
        f = libs["encode_deep.cu"][k].zl4_enc_deep_emit
        f.argtypes, f.restype = [P] * 10 + [I] * 5 + [P], I

        def run():
            check(f(w.data_ptr(), l.data_ptr(), s.data_ptr(), pk.data_ptr(),
                    st.data_ptr(), chosen.data_ptr(), ents.data_ptr(),
                    runs.data_ptr(), out.data_ptr(), olen.data_ptr(), B, blk,
                    cap, runs.shape[1], chcap, stream) == 0,
                  f"enc_deep_emit cut {k} did not launch")
        run()
        ms[k] = cuda_ms(run, 2)[0]
    return ms


def overflow_window(np, seed=11, blk=BLK):
    """A window whose capped chosen rows at level 12 outnumber
    ``enc_deep_emit``'s extension pool of 512 (the recipe of
    ``overflow_window`` in tests/test_torch_deep_emit_scan.py): lines of
    36 to 45 bytes drawn from 400 random ones, each within two lines of
    the one before."""
    rng = np.random.default_rng(seed)
    lines = [rng.integers(0, 256, int(rng.integers(36, 46)), dtype=np.uint8)
             for _ in range(400)]
    out, k = [], 0
    while sum(map(len, out)) < blk:
        k = (k + int(rng.integers(-2, 3))) % len(lines)
        out.append(lines[k])
    return np.concatenate(out)[:blk]


def torch_sort_words(torch, w, l, nw=3):
    """The batched stable torch.sort of the nw words (s0, at(p+4), ...,
    at(p+4(nw-1))) of every window, least significant first
    (_stable_order of the plain version over every window at once): the
    12-byte order at nw = 3, the 32-byte order at nw = 8, the s0 order at
    nw = 1.  Returns the windows' position orders, and a function that
    sorts again from the same keys (for timing the sorts alone)."""
    B, blk = w.shape
    idx = torch.arange(blk, device=w.device)
    b = torch.where(idx < l[:, None], w.long(), 0)
    bp = torch.nn.functional.pad(b, (0, 4 * nw + 4))
    ext = blk + 4 * (nw - 1)
    su = (bp[:, :ext] | (bp[:, 1:ext + 1] << 8)
          | (bp[:, 2:ext + 2] << 16) | (bp[:, 3:ext + 3] << 24))
    del b, bp
    s0 = torch.where(idx > l[:, None] - 4, 0xFFFFFFFF, su[:, :blk])
    keys = (s0,) + tuple(su[:, 4 * k:4 * k + blk] for k in range(1, nw))

    def sort():
        order = idx.expand(B, blk)
        for k in reversed(keys):
            order = order.gather(1, torch.sort(k.gather(1, order), dim=1,
                                               stable=True).indices)
        return order
    return sort(), sort


def ptxas_lines(log, names):
    """name -> ptxas's "registers" and "spill" lines for the entry
    function whose mangled name holds ``name`` (a kernel's name, or a
    template's name and arguments as ``enc_match_wide_kernel<20>``), from
    an nvcc build log written with -Xptxas -v."""
    def mangled(k):
        base, _, arg = k.partition("<")
        return f"{len(base)}{base}" + (f"ILi{arg[:-1]}E" if arg else "")
    found, fn = {}, None
    for ln in open(log):
        if "Compiling entry function" in ln:
            fn = next((k for k in names if mangled(k) in ln), None)
        elif fn and ("registers" in ln or "spill" in ln):
            found.setdefault(fn, []).append(
                ln.split("info    : ")[-1].strip())
    return found


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the scalar rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def match_ops(B, blk, hc, W, probes):
    """Operations of the match finders on B windows of blk bytes: a
    comparison sort needs blk * log2(blk) key comparisons (3 words a key
    for the 12-byte order, 1 for the 4-byte order), and every probe
    compares the 4-byte string, W windows and 2 back bytes."""
    lg = max(blk - 1, 1).bit_length()
    per_probe = W + 3
    if hc:
        ops = blk * lg * 3 + blk * 2 * hc * per_probe       # 12-byte order
        ops += blk * lg + blk * 2 * per_probe               # fallback
    else:
        ops = blk * lg + blk * probes * per_probe
    return B * ops


def tie_dense(np, blk, seed=0):
    """Windows dense in ties for the finders' sorts, as bytes: all 0x00,
    all 0xFF, periods 1, 2, 3, 4 and 7, and random bytes over {0, 1}
    (the recipe of tests/test_torch_encode.py's tie_dense)."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(blk, np.uint8), np.full(blk, 0xFF, np.uint8)]
    for per in (1, 2, 3, 4, 7):
        rows.append(np.resize(rng.integers(0, 256, per, dtype=np.uint8),
                              blk))
    rows.append(rng.integers(0, 2, blk, dtype=np.uint8))
    return [r.tobytes() for r in rows]


def edge_inputs(make_corpus, np):
    """8 corpus blocks (one per content type), a 1-byte, an empty and
    an incompressible block, as 64 KB windows; then a byte run, a
    period-300 block and a 50,000-byte text window whose emission starts
    at 20,000; then the 8 tie-dense windows.  Returns (windows, lens,
    starts, goldens); the goldens cover the first 8."""
    gold = np.load(GOLDENS)
    corpus = make_corpus(2)
    rows = [corpus[i * BLK:(i + 1) * BLK] for i in gold["blocks"]]
    rows += [b"\x2a", b"",
             np.random.default_rng(7).integers(0, 256, BLK, np.uint8)
             .tobytes()]
    period = np.random.default_rng(300).integers(0, 256, 300, np.uint8)
    rows += [b"\x61" * BLK, (period.tobytes() * (BLK // 300 + 1))[:BLK],
             corpus[9 * BLK:9 * BLK + 50_000]]
    rows += tie_dense(np, BLK)
    windows = np.zeros((len(rows), BLK), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for k, r in enumerate(rows):
        windows[k, :len(r)] = np.frombuffer(r, np.uint8)
        lens[k] = len(r)
    starts = np.zeros(len(rows), np.int32)
    starts[13] = 20_000
    return windows, lens, starts, gold


def equals_goldens(out_h, olen_h, out_len, payloads):
    """The first len(out_len) rows equal the payloads packed back to
    back in ``payloads``."""
    pos, ok = 0, True
    for k, n in enumerate(out_len):
        n = int(n)
        ok &= (int(olen_h[k]) == n
               and out_h[k, :n].tobytes() == payloads[pos:pos + n].tobytes())
        pos += n
    return ok


def frame_payloads(frame, lz4f):
    """(block indices, payloads) of the compressed (not stored) blocks
    of a frame."""
    idx, recs, pos, k = [], [], lz4f.parse_frame_header(frame)[1], 0
    while True:
        word = int.from_bytes(frame[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            return idx, recs
        blen = word & 0x7FFFFFFF
        if not word & 0x80000000:
            idx.append(k)
            recs.append(frame[pos:pos + blen])
        pos += blen
        k += 1


def deep_match_ops(B, blk, hc, deep):
    """Operations of the deep finder on B windows of blk bytes: the
    32-byte rank order compares 8 words a key, the 256-byte rank order
    (level 12) 8 ranks, the grand order its NK tier operands, and every
    probe the 4-byte string, 8 windows, 2 back bytes and the tier
    chain; then the fallback as in ``match_ops``."""
    lg = max(blk - 1, 1).bit_length()
    tiers = {1: 4, 2: 8, 3: 11}[deep]
    ops = blk * lg * 8 + (blk * lg * 8 if deep == 3 else 0)
    ops += blk * lg * (8 if deep == 2 else 4)
    ops += blk * 2 * hc * (11 + tiers)
    ops += blk * lg + blk * 2 * 11
    return B * ops


def wide_edge_inputs(np, data):
    """Windows over 64 KB that the goldens do not cover, 131,072 bytes
    wide: all zero, random, n == start, n < 4, n % 4 != 0, a match
    exactly 65,535 bytes back into the history, a history of 10,000
    bytes, and a corpus block behind the 64 KB before it; then two
    327,680-byte sub-span windows of the corpus.  Returns ((windows,
    lens, starts) at 131,072, the same at 327,680)."""
    blk, h = 2 * BLK, BLK
    rng = np.random.default_rng(65535)
    rows = [(np.zeros(blk, np.uint8), blk, h),
            (rng.integers(0, 256, blk, dtype=np.uint8), blk, h),
            (rng.integers(0, 256, blk, dtype=np.uint8), h, h),
            (rng.integers(0, 256, blk, dtype=np.uint8), 3, 0),
            (rng.integers(0, 4, blk, dtype=np.uint8), 100_003, 0)]
    far = rng.integers(0, 256, blk, dtype=np.uint8)
    far[h + 1000:h + 1100] = far[1001:1101]         # offset 65,535
    rows.append((far, blk, h))
    short = rng.integers(0, 256, blk, dtype=np.uint8)
    short[20_000:20_300] = short[500:800]
    rows.append((short, 70_000, 10_000))
    rows.append((np.frombuffer(data[40 * BLK:42 * BLK], np.uint8), blk, h))
    sets = []
    for width, rows_ in ((blk, rows), (SUB_WINDOW, [
            (np.frombuffer(data[o:o + SUB_WINDOW], np.uint8), SUB_WINDOW, h)
            for o in (0, 60 * BLK)])):
        windows = np.stack([r for r, _n, _s in rows_])
        assert windows.shape[1] == width
        sets.append((windows, np.array([n for _r, n, _s in rows_], np.int32),
                     np.array([s_ for _r, _n, s_ in rows_], np.int32)))
    return sets


class EncodeRecorder:
    """Records what the frame codec hands to ``encode_blocks`` while a
    path runs, so that the kernels can be timed alone at the path's
    shapes afterwards."""

    def __init__(self, sh):
        self.sh, self.calls = sh, []

    def __enter__(self):
        self.real = self.sh.encode_blocks

        def call(*a, **k):
            self.calls.append((a, k))
            return self.real(*a, **k)
        self.sh.encode_blocks = call
        return self

    def __exit__(self, *exc):
        self.sh.encode_blocks = self.real


def decode_without_native():
    """The child process of the no-native check: reads a frame from
    stdin, decodes it on the card with the native host runtime switched
    off, and prints the content's SHA-256 and the launch counts."""
    import torch

    from zig_lz4_tpu_torch import ShardedFrameCodec, native
    from zig_lz4_tpu_torch.kernels import LAUNCHES
    check(os.environ.get("ZIG_LZ4_TPU_NO_NATIVE") == "1"
          and not native.is_available(),
          "the child process has the native host runtime")
    check(torch.cuda.is_available(), "the child process sees no card")
    frame = sys.stdin.buffer.read()
    content = ShardedFrameCodec(device="cuda").decompress_frame(frame)
    torch.cuda.synchronize()
    print(json.dumps({"sha256": hashlib.sha256(content).hexdigest(),
                      "bytes": len(content), "launches": dict(LAUNCHES)}))
    return 0


def multihost_rank(*args):
    """A rank of the two-process run.  Its arguments are the coordinator,
    the rank and the corpus's path: it joins the gloo group at the
    coordinator.  Or ``env`` and the path, under ``torchrun``: it joins
    with ``initialize()`` alone, from the launcher's variables, and
    reads its rank back from the group.  It compresses the corpus with
    ``MultiHostFrameCodec`` on its local card and decodes the frame
    back; prints the frame's SHA-256, its times and its launch counts as
    one JSON line."""
    t0 = time.perf_counter()
    import torch
    import torch.distributed as dist

    from zig_lz4_tpu_torch.kernels import LAUNCHES
    from zig_lz4_tpu_torch.parallel import multihost
    check(torch.cuda.is_available(), "the rank sees no card")
    if args[0] == "env":
        path = args[1]
        multihost.initialize()
    else:
        coord, rank, path = args
        multihost.initialize(coord, 2, int(rank))
    rank = dist.get_rank()
    with open(path, "rb") as f:
        data = f.read()
    codec = multihost.MultiHostFrameCodec()
    t_start = time.perf_counter() - t0
    t1 = time.perf_counter()
    frame = codec.compress_corpus(data, content_hash=True)
    t_c = time.perf_counter() - t1
    t1 = time.perf_counter()
    back = codec.decompress_corpus(frame)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t1
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "roundtrip": back == data,
                      "sha256": hashlib.sha256(frame).hexdigest(),
                      "start_s": t_start, "compress_s": t_c,
                      "decompress_s": t_d, "launches": dict(LAUNCHES)}),
          flush=True)
    return 0


def launch_ranks(cmds, timeout):
    """Runs each command of ``cmds`` in a session of its own and waits
    for all within ``timeout`` seconds in all.  Fails, with the stderr
    of the first that did, if one exits non-zero or is still running
    then (its session is stopped: a launcher's workers too).
    Returns each rank's JSON line, found by its content (a launcher may
    prefix or interleave its workers' lines), sorted by rank."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for c in cmds]
    told = []
    end = time.perf_counter() + timeout
    try:
        for p_ in procs:
            try:
                out_, err_ = p_.communicate(
                    timeout=max(end - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                raise Failed(f"{' '.join(p_.args[1:5])} still running "
                             f"after {timeout} s") from None
            check(p_.returncode == 0, f"{' '.join(p_.args[1:5])} exited "
                  f"{p_.returncode}:\n{err_[-3000:]}")
            for line in out_.splitlines():
                at = line.find('{"rank": ')
                if at >= 0:
                    told.append(json.loads(line[at:]))
    finally:
        for p_ in procs:
            if p_.poll() is None:
                # SIGTERM first: torchrun stops its workers, which run in
                # sessions of their own, only when it is let to
                os.killpg(p_.pid, signal.SIGTERM)
                try:
                    p_.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(p_.pid, signal.SIGKILL)
                    p_.wait()
    return sorted(told, key=lambda t_: t_["rank"])


def subspan_windows(np, data, block=1 << 20):
    """The windows a frame of ``block``-byte blocks encodes: each block's
    256 KB sub-spans behind the 64 KB before them (none for the first),
    as ``ShardedFrameCodec._encode_span`` builds them without a
    dictionary.  Returns (windows, lens, starts) of SUB_WINDOW bytes."""
    sub, hist = SUB_WINDOW - BLK, BLK
    rows = []
    for b0 in range(0, len(data), block):
        raw = data[b0:b0 + block]
        for s0 in range(0, len(raw), sub):
            rows.append((raw[max(s0 - hist, 0):s0], raw[s0:s0 + sub]))
    windows = np.zeros((len(rows), SUB_WINDOW), np.uint8)
    lens = np.zeros(len(rows), np.int32)
    starts = np.zeros(len(rows), np.int32)
    for k, (h, span) in enumerate(rows):
        windows[k, :len(h) + len(span)] = np.frombuffer(h + span, np.uint8)
        lens[k], starts[k] = len(h) + len(span), len(h)
    return windows, lens, starts


def seq_worst_cases(np, blk=BLK):
    """Tables of 64 KB blocks that are worst cases for seq_decode's
    rounds: a chain in which each sequence is 1 literal and a 4-byte
    match at offset 5, so that every match reads the one before it (its
    chains run through every sequence), with its root in 4 literals or
    in a 64 KB history; and a 65,535-byte match at offset 1.  Returns
    [(name, (comp, lit_len, lit_src, mlen, off, nseq), history or
    None)]."""
    cases = []
    rng = np.random.default_rng(65535)
    for into_history in (False, True):
        ns = blk // 5 if into_history else (blk - 4) // 5
        comp = rng.integers(65, 91, (1, ns + 8), dtype=np.uint8)
        lit = np.ones((1, ns), np.int32)
        lsrc = (np.arange(ns, dtype=np.int32) + 4)[None]
        if not into_history:
            lit[0, 0], lsrc[0, 0] = 5, 0
        tabs = (comp, lit, lsrc, np.full((1, ns), 4, np.int32),
                np.full((1, ns), 5, np.int32), np.array([ns], np.int32))
        hist = (rng.integers(0, 256, blk, dtype=np.uint8)
                if into_history else None)
        cases.append((f"chain of {ns} sequences"
                      + (" into a 64 KB history" if into_history else ""),
                      tabs, hist))
    one = lambda v: np.array([[v]], np.int32)            # noqa: E731
    cases.append(("65,535-byte run at offset 1",
                  (np.array([[0x61, 0, 0, 0]], np.uint8), one(1), one(0),
                   one(blk - 1), one(1), np.array([1], np.int32)), None))
    return cases


def seq_phase_split(libs, seq_in, blk, reps=5):
    """Milliseconds of each phase cut of ``seq_decode``
    (``seq_decode.cu`` -DZL4_STOP=1..3) on ``seq_in``, through ctypes
    (not counted as launches): {k: median of ``reps``}."""
    import ctypes

    import torch
    P, I = ctypes.c_void_p, ctypes.c_int
    comp, ll, ls, ml, off, nseq = seq_in
    B, ccap = comp.shape
    cap = ll.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    ss = torch.empty((B, cap), dtype=torch.int32, device=comp.device)
    out = torch.empty((B, blk), dtype=torch.uint8, device=comp.device)
    olen, ok = (torch.empty(B, dtype=torch.int32, device=comp.device)
                for _ in range(2))
    ms = {}
    for k, lib in libs["seq_decode.cu"].items():
        fn = lib.zl4_seq_decode
        fn.argtypes, fn.restype = [P] * 12 + [I] * 6 + [P], I

        def cut():
            check(fn(*(t.data_ptr() for t in (comp, comp, ll, ls, ml, off,
                                              nseq, ss, out, olen, ok)),
                     None, B, ccap, 0, 0, cap, blk, stream) == 0,
                  f"seq_decode cut {k} did not launch")
        cut()
        ms[k] = statistics.median(cuda_ms(cut)[0] for _ in range(reps))
    return ms


def chase_phase_split(libs, a, kw, reps=5):
    """Milliseconds of each phase cut of ``frag_decode_chase``'s cluster
    route (``frag_decode.cu`` -DZL4_STOP=1..3) at a recorded call of
    ``decode_blocks_frags_chase`` (arguments ``a``, ``kw``), through
    ctypes (not counted): {k: median of ``reps``}."""
    import ctypes
    import inspect

    import torch
    from zig_lz4_tpu_torch.ops import torch_frags as tfr
    P, I = ctypes.c_void_p, ctypes.c_int
    bound_ = inspect.signature(tfr.decode_blocks_frags_chase).bind(*a, **kw)
    bound_.apply_defaults()
    arg = bound_.arguments
    tables = [arg[k].contiguous() for k in ("comp", "fdst", "fsrc", "fper",
                                            "fphase", "nfrag", "out_len")]
    blk, dense, doublings = arg["blk"], arg["dense"], arg["doublings"]
    q = min(tfr._chase_pool(blk, arg["qcap"]), blk) if doublings > 0 else 1
    C = tfr.chase_cluster_size(blk)
    check(C > 0, f"no cluster route at {blk}-byte blocks")
    B = tables[0].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((B, blk), dtype=torch.uint8, device=tables[0].device)
    ok = torch.empty(B, dtype=torch.int32, device=tables[0].device)
    ms = {}
    for k, lib in libs["frag_decode.cu"].items():
        fn = lib.zl4_frag_decode_chase
        fn.argtypes, fn.restype = [P] * 13 + [I] * 8 + [P], I

        def cut():
            check(fn(*(t.data_ptr() for t in tables), None, None, None,
                     out.data_ptr(), ok.data_ptr(), None, B,
                     tables[0].shape[1], tables[1].shape[1], blk, dense,
                     doublings, q, C, stream) == 0,
                  f"frag_decode_chase cut {k} did not launch")
        cut()
        ms[k] = statistics.median(cuda_ms(cut)[0] for _ in range(reps))
    return ms


def serial_phase_split(libs, seq_in, blk, reps=5):
    """Milliseconds of each phase cut of ``serial_decode``'s shared-memory
    route (``serial_decode.cu`` -DZL4_STOP=1..2) on ``seq_in``, and of the
    library's kernel launched the same way (key "whole": the kernel
    without its wrapper's host work and out_len), through ctypes (not
    counted as launches): {k: median of ``reps``}."""
    import ctypes

    import torch
    from zig_lz4_tpu_torch.kernels import library
    P, I = ctypes.c_void_p, ctypes.c_int
    comp, ll, ls, ml, off, nseq = seq_in
    B, ccap = comp.shape
    out = torch.empty((B, blk), dtype=torch.uint8, device=comp.device)
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for k, lib in [*libs["serial_decode.cu"].items(), ("whole", library())]:
        fn = lib.zl4_serial_decode
        fn.argtypes, fn.restype = [P] * 7 + [I] * 5 + [P], I

        def cut():
            check(fn(*(t.data_ptr() for t in (comp, ll, ls, ml, off, nseq,
                                              out)),
                     B, ccap, ll.shape[1], blk, 1, stream) == 0,
                  f"serial_decode cut {k} did not launch")
        cut()
        ms[k] = statistics.median(cuda_ms(cut)[0] for _ in range(reps))
    return ms


def win_phase_split(libs, a, kw, reps=5):
    """Milliseconds of each phase cut of ``frag_decode_win``'s cluster
    route (``frag_decode.cu`` -DZL4_STOP=1..3) at a recorded call of
    ``decode_blocks_frags_win`` (arguments ``a``, ``kw``), and of the
    library's kernel launched the same way (key "whole"), through ctypes
    (not counted): {k: median of ``reps``}."""
    import ctypes
    import inspect

    import torch
    from zig_lz4_tpu_torch.kernels import library
    from zig_lz4_tpu_torch.ops import torch_frags as tfr
    P, I = ctypes.c_void_p, ctypes.c_int
    bound_ = inspect.signature(tfr.decode_blocks_frags_win).bind(*a, **kw)
    bound_.apply_defaults()
    arg = bound_.arguments
    tables = [arg[k].contiguous() for k in ("comp", "fdst", "fsrc", "fper",
                                            "fphase", "nfrag", "out_len")]
    blk, rounds, g = arg["blk"], max(int(arg["rounds"]), 0), arg["g"]
    cfg = tfr._win_config(blk, arg["fcap"] or tables[1].shape[1], rounds,
                          arg["wins"], arg["pool"], arg["lit_wins"],
                          arg["lit_pool"], g)
    C = tfr.win_cluster_size(blk)
    check(C > 0, f"no cluster route at {blk}-byte blocks")
    B = tables[0].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((B, blk), dtype=torch.uint8, device=tables[0].device)
    ok = torch.empty(B, dtype=torch.int32, device=tables[0].device)
    ms = {}
    for k, lib in [*libs["frag_decode.cu"].items(), ("whole", library())]:
        fn = lib.zl4_frag_decode_win
        fn.argtypes, fn.restype = [P] * 12 + [I] * 11 + [P], I

        def cut():
            check(fn(*(t.data_ptr() for t in tables), None, None, None,
                     out.data_ptr(), ok.data_ptr(), B, tables[0].shape[1],
                     tables[1].shape[1], blk, rounds, g, cfg["wins"],
                     cfg["pool"], cfg["lit_wins"], cfg["lit_pool"], C,
                     stream) == 0,
                  f"frag_decode_win cut {k} did not launch")
        cut()
        ms[k] = statistics.median(cuda_ms(cut)[0] for _ in range(reps))
    return ms


def frag_phase_split(libs, a, kw, reps=5):
    """Milliseconds of each phase cut of ``frag_decode``'s cluster route
    (``frag_decode.cu`` -DZL4_STOP=1..2; its cut 3 is the whole kernel) at
    a recorded call of ``decode_blocks_frags`` (arguments ``a``, ``kw``),
    and of the library's kernel launched the same way (key "whole"), and
    at ``rounds`` 0, 1, 2 and 4 (keys ("rounds", r)), through ctypes (not
    counted): {k: median of ``reps``}."""
    import ctypes
    import inspect

    import torch
    from zig_lz4_tpu_torch.kernels import library
    from zig_lz4_tpu_torch.ops import torch_frags as tfr
    P, I = ctypes.c_void_p, ctypes.c_int
    bound_ = inspect.signature(tfr.decode_blocks_frags).bind(*a, **kw)
    arg = bound_.arguments
    tables = [arg[k].contiguous() for k in ("comp", "fdst", "fsrc", "fper",
                                            "fphase", "nfrag", "out_len")]
    blk, rounds = arg["blk"], max(int(arg["rounds"]), 0)
    C = tfr.frag_cluster_size(blk)
    check(C > 0, f"no cluster route at {blk}-byte blocks")
    B = tables[0].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((B, blk), dtype=torch.uint8, device=tables[0].device)
    ok = torch.empty(B, dtype=torch.int32, device=tables[0].device)
    cuts = {k: lib for k, lib in libs["frag_decode.cu"].items()
            if k < len(FRAG_PHASES)}
    runs = [(k, lib, rounds) for k, lib in cuts.items()] + [
        ("whole", library(), rounds)] + [
        (("rounds", r), library(), r) for r in (0, 1, 2, 4) if r < rounds]
    ms = {}
    for k, lib, r in runs:
        fn = lib.zl4_frag_decode
        fn.argtypes, fn.restype = [P] * 11 + [I] * 6 + [P], I

        def cut():
            check(fn(*(t.data_ptr() for t in tables), None, None,
                     out.data_ptr(), ok.data_ptr(), B, tables[0].shape[1],
                     tables[1].shape[1], blk, r, C, stream) == 0,
                  f"frag_decode cut {k} did not launch")
        cut()
        ms[k] = statistics.median(cuda_ms(cut)[0] for _ in range(reps))
    return ms


def by_phase(names, cuts, whole):
    """{phase: ms} from the cuts' times (a phase = the difference of two
    cuts; the last phase the whole less the last cut)."""
    t = [0.0] + [cuts[k] for k in sorted(cuts)] + [whole]
    return {n: t[i + 1] - t[i] for i, n in enumerate(names)}


def decode_inputs(torch, np, data, dev):
    """What the two decoders' timing needs, made with the package of the
    current directory from calls every version of the port has: the
    level-12 frame's compressed blocks parsed into sequence tables on the
    card, and the calls the level-9 frame's "chase" decode makes of
    ``decode_blocks_frags_chase``, its "win" decode of
    ``decode_blocks_frags_win`` and the "win" decode of a frame of 256 KB
    blocks of ``decode_blocks_frags`` (recorded).  Returns (seq_in, chase
    calls, win calls, byte-granular calls), each call (args, kwargs)."""
    from zig_lz4_tpu_torch import ShardedFrameCodec, native
    from zig_lz4_tpu_torch import frame as lz4f
    from zig_lz4_tpu_torch.constants import compress_bound
    from zig_lz4_tpu_torch.ops import torch_decode as td
    from zig_lz4_tpu_torch.parallel import sharded as sh
    fr12 = ShardedFrameCodec(compression_level=12,
                             device="cuda").compress_frame(data)
    _idx, recs = frame_payloads(fr12, lz4f)
    plen = np.array([len(p) for p in recs], np.int64)
    offs = np.zeros_like(plen)
    offs[1:] = np.cumsum(plen)[:-1]
    tabs = native.native_parse_blocks(b"".join(recs), offs, plen,
                                      td.MAX_SEQS(BLK))
    comp = np.zeros((len(recs), compress_bound(BLK)), np.uint8)
    for k, p_ in enumerate(recs):
        comp[k, :len(p_)] = np.frombuffer(p_, np.uint8)
    seq_in = [torch.from_numpy(x).to(dev) for x in (comp, *tabs)]
    fr9 = ShardedFrameCodec(compression_level=9,
                            device="cuda").compress_frame(data)
    part256 = data[:16 << 20]
    fr256 = lz4f.compress_frame(part256, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(
            block_size_id=lz4f.BlockSizeID.max256KB,
            block_mode=lz4f.BlockMode.independent, content_checksum=True),
        compression_level=9))
    calls = {}
    for engine, attr, fr, want in (
            ("chase", "decode_blocks_frags_chase", fr9, data),
            ("win", "decode_blocks_frags_win", fr9, data),
            ("win", "decode_blocks_frags", fr256, part256)):
        real, got = getattr(sh, attr), calls.setdefault(attr, [])

        def record(*a, _real=real, _got=got, **k):
            _got.append((a, k))
            return _real(*a, **k)
        setattr(sh, attr, record)
        try:
            back = ShardedFrameCodec(device="cuda", decode_engine=engine
                                     ).decompress_frame(fr)
        finally:
            setattr(sh, attr, real)
        check(back == want, f"{engine} decode through {attr}")
    return (seq_in, calls["decode_blocks_frags_chase"],
            calls["decode_blocks_frags_win"], calls["decode_blocks_frags"])


def time_decode_kernels():
    """``python3 /path/to/chip_smoke.py --time-decode-kernels``: times
    ``seq_decode``, ``serial_decode``, ``frag_decode_chase`` and
    ``frag_decode_win`` with the package of the current directory first
    on the module path, so that two checkouts (one unpacked from the
    parent commit with ``git archive``) can be compared in turns in one
    call: ``decode_blocks`` over the level-12 frame's compressed 64 KB
    blocks of the bench corpus and over 32 of them,
    ``decode_blocks_serial`` over the same 672 blocks,
    ``decode_blocks_frags_chase`` at the largest launch of the level-9
    frame's "chase" decode (141 blocks), ``decode_blocks_frags_win`` at
    both launches of its "win" decode (g 16 and g 8) and
    ``decode_blocks_frags`` at the launch of the "win" decode of 16 MB in
    256 KB blocks (23 blocks).  It uses only what
    every version of the port has (``decode_inputs``).  Each time is the
    median of 5 calls between CUDA events, after one warm-up call, and
    beside it the median of 5 means of 20 calls back to back, in which
    the wrapper's host work overlaps the kernels before it; it prints one
    line."""
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np

    from zig_lz4_tpu_torch.corpus import make_corpus
    from zig_lz4_tpu_torch.ops import torch_decode as td
    from zig_lz4_tpu_torch.ops import torch_frags as tfr
    from zig_lz4_tpu_torch.probes import serial_decode as sd
    smi = nvidia_smi()
    data = make_corpus(48)
    data = data[:len(data) - len(data) % (BLK * BENCH_BATCH)]
    seq_in, chase_calls, win_calls, frag_calls = decode_inputs(
        torch, np, data, torch.device("cuda"))
    step = max(seq_in[0].shape[0] // SEQ_PLAIN_BLOCKS, 1)
    sub = [t[::step].contiguous() for t in seq_in]
    a, kw = max(chase_calls, key=lambda c: c[0][0].shape[0])
    calls = {f"seq_decode at {seq_in[0].shape[0]} x 64 KB":
             lambda: td.decode_blocks(*seq_in, BLK),
             f"seq_decode at {sub[0].shape[0]} x 64 KB":
             lambda: td.decode_blocks(*sub, BLK),
             f"serial_decode at {seq_in[0].shape[0]} x 64 KB":
             lambda: sd.decode_blocks_serial(*seq_in, BLK),
             f"frag_decode_chase at {a[0].shape[0]} blocks "
             f"({list(a[7:])} {kw})":
             lambda: tfr.decode_blocks_frags_chase(*a, **kw)}
    for a_w, kw_w in win_calls:
        calls[f"frag_decode_win at {a_w[0].shape[0]} blocks "
              f"({list(a_w[7:])} {kw_w})"] = (
            lambda a_w=a_w, kw_w=kw_w:
            tfr.decode_blocks_frags_win(*a_w, **kw_w))
    for a_f, kw_f in frag_calls:
        calls[f"frag_decode at {a_f[0].shape[0]} blocks "
              f"({list(a_f[7:])} {kw_f})"] = (
            lambda a_f=a_f, kw_f=kw_f: tfr.decode_blocks_frags(*a_f, **kw_f))
    ms = {}
    for k, fn in calls.items():
        fn()
        ms[k] = (statistics.median(cuda_ms(fn)[0] for _ in range(5)),
                 statistics.median(cuda_ms(fn, 20)[0] for _ in range(5)))
    print(f"[decode kernels] {smi}: package {os.path.dirname(td.__file__)}: "
          + ", ".join(f"{k} {v:.4f} ms ({v20:.4f} back to back)"
                      for k, (v, v20) in ms.items()), flush=True)
    return 0


def time_encoder_kernels():
    """``python3 /path/to/chip_smoke.py --time-encoder-kernels``: times
    the encoder's finders and ``enc_parse_emit`` with the package of the
    current directory first on the module path, as time_main_path.py
    does, so that two checkouts (one unpacked from the parent commit with
    ``git archive``) can be compared in turns in one call: at the main
    path's shapes, 768 x 64 KB windows of the bench corpus, ``enc_match``
    (hc 9 and 4), ``enc_match_fast`` (hc 0 at accelerations 1, 2, 4 and
    8), ``enc_deep_match`` (levels 12 and 10), ``enc_deep_dp`` and
    ``enc_deep_emit`` (level 12) and ``enc_parse_emit`` (levels 9 and 0);
    at the 1 MB paths' shapes, the corpus's 192 sub-span windows of
    327,680 bytes, ``enc_match_wide`` (hc 9 and 0), ``enc_parse_emit``
    (level 9), ``enc_deep_match_wide``, ``enc_deep_dp`` and
    ``enc_deep_emit`` (level 12).  It uses only what every version of the
    port has: ``torch_block.match_candidates``, ``deep_dp``,
    ``deep_emit``, ``parse_emit`` and ``corpus.make_corpus``.  Each time is
    the median of 5 calls between CUDA events, after one warm-up call; it
    prints one line."""
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np

    from zig_lz4_tpu_torch.corpus import make_corpus
    from zig_lz4_tpu_torch.ops import torch_block as tb
    smi = nvidia_smi()
    data = make_corpus(48)
    nb = len(data) // (BLK * BENCH_BATCH) * BENCH_BATCH
    w = torch.frombuffer(bytearray(data[:nb * BLK]), dtype=torch.uint8) \
        .view(nb, BLK).cuda()
    n = torch.full((nb,), BLK, dtype=torch.int32, device=w.device)
    st = torch.zeros_like(n)
    ww, nw, sw = (torch.from_numpy(a).cuda()
                  for a in subspan_windows(np, data[:nb * BLK]))
    pk9, pk0 = tb.match_candidates(w, n, 9), tb.match_candidates(w, n, 0)
    pk12 = tb.match_candidates(w, n, 8, 1, 3)
    pkw12 = tb.match_candidates(ww, nw, 8, 1, 3)
    pkw9 = tb.match_candidates(ww, nw, 9)
    sd12, sdw12 = tb.deep_dp(n, st, pk12, 3), tb.deep_dp(nw, sw, pkw12, 3)
    calls = {"enc_match hc=9": lambda: tb.match_candidates(w, n, 9),
             "enc_match hc=4": lambda: tb.match_candidates(w, n, 4),
             "enc_match_fast hc=0": lambda: tb.match_candidates(w, n, 0),
             "enc_match_fast accel 2":
             lambda: tb.match_candidates(w, n, 0, 2),
             "enc_match_fast accel 4":
             lambda: tb.match_candidates(w, n, 0, 4),
             "enc_match_fast accel 8":
             lambda: tb.match_candidates(w, n, 0, 8),
             "enc_deep_match level 12":
             lambda: tb.match_candidates(w, n, 8, 1, 3),
             "enc_deep_match level 10":
             lambda: tb.match_candidates(w, n, 8, 1, 1),
             "enc_deep_dp level 12": lambda: tb.deep_dp(n, st, pk12, 3),
             "enc_deep_emit level 12":
             lambda: tb.deep_emit(w, n, st, pk12, sd12),
             "enc_parse_emit level 9": lambda: tb.parse_emit(w, n, st, pk9),
             "enc_parse_emit level 0": lambda: tb.parse_emit(w, n, st, pk0,
                                                             0),
             f"enc_match_wide hc=9 at {ww.shape[0]} x {SUB_WINDOW}":
             lambda: tb.match_candidates(ww, nw, 9),
             "enc_match_wide hc=0": lambda: tb.match_candidates(ww, nw, 0),
             "enc_parse_emit level 9 at the 1 MB shape":
             lambda: tb.parse_emit(ww, nw, sw, pkw9),
             "enc_deep_match_wide level 12":
             lambda: tb.match_candidates(ww, nw, 8, 1, 3),
             "enc_deep_dp level 12 at the 1 MB shape":
             lambda: tb.deep_dp(nw, sw, pkw12, 3),
             "enc_deep_emit level 12 at the 1 MB shape":
             lambda: tb.deep_emit(ww, nw, sw, pkw12, sdw12)}
    ms = {}
    for k, fn in calls.items():
        fn()
        ms[k] = statistics.median(cuda_ms(fn)[0] for _ in range(5))
    print(f"[encoder kernels] {smi}: {nb} x 64 KB, package "
          f"{os.path.dirname(tb.__file__)}: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
    return 0


def main():
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import numpy as np

    from zig_lz4_tpu_torch import ShardedFrameCodec, get_codec, native
    from zig_lz4_tpu_torch import frame as lz4f
    from zig_lz4_tpu_torch import kernels as kernels_mod
    from zig_lz4_tpu_torch.constants import compress_bound
    from zig_lz4_tpu_torch.corpus import make_corpus
    from zig_lz4_tpu_torch.kernels import (KERNELS, LAUNCHES, build, launch,
                                           reference_path,
                                           reset_launch_counts)
    from zig_lz4_tpu_torch.ops import torch_block as tb
    from zig_lz4_tpu_torch.ops import torch_decode as td
    from zig_lz4_tpu_torch.ops.block import (decompress_safe,
                                             decompress_safe_using_dict)
    from zig_lz4_tpu_torch.parallel.sharded import _scan_blocks

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {name} x{torch.cuda.device_count()} | nvidia-smi: "
          f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # --- phase 1: build the host runtime and the kernels
    t0 = time.perf_counter()
    check(native.is_available(),
          "the port's native host runtime did not build or load (g++): "
          "without it xxh32 runs in Python and T-map decode cannot run")
    t_native = time.perf_counter() - t0
    check(os.path.dirname(native._SO).endswith("_build"),
          f"native runtime loaded from {native._SO}")
    phase_jobs = start_phase_builds(kernels_mod)
    t_build = build()
    log = os.path.join(os.path.dirname(tb.__file__), "..", "_build",
                       "build.log")
    regs, ptxas = [], {}
    if os.path.exists(log):
        regs = [ln.split("info    : ")[-1].strip() for ln in open(log)
                if "registers" in ln]
    print(f"[build] host runtime {t_native:.2f} s, kernels {t_build:.2f} s "
          f"(0 = up to date); ptxas: " + " | ".join(regs))
    if os.path.exists(log):
        for k, v in ptxas_lines(log, PTXAS_KERNELS).items():
            print(f"[build] ptxas {k}: " + "; ".join(v))
            ptxas[k] = v
    wide_shapes = {f"{blk_} x {'deep' if deep_ else 'levels 0-9'}":
                   tb.wide_launch_shape(blk_, deep_)
                   for blk_ in (2 * BLK, SUB_WINDOW) for deep_ in (0, 3)}
    print("[build] the wide finders' launch shape by window bytes (CTAs a "
          "cluster, threads, rows a thread, shared bytes a CTA, clusters "
          f"the card holds at once): {wide_shapes}")
    check(all(v["active_clusters"] > 0 for v in wide_shapes.values()),
          "a wide finder's cluster cannot be scheduled")

    def lz4f_block_decode(comp, history, size):
        """One block by the host oracle, behind ``history``."""
        if not size:
            return b""
        if history:
            return decompress_safe_using_dict(comp, size, history)
        return decompress_safe(comp, size)

    results = {k: {} for k in KERNELS}
    counts = {k: 0 for k in KERNELS}
    paths = {}

    def counted(path, fn, expect):
        """Run ``fn`` as one of the main paths: counts set to 0 just
        before, read just after; the kernels ``expect`` must each have
        launched in that run."""
        torch.cuda.synchronize()
        reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        paths[path] = dict(LAUNCHES)
        for k, v in paths[path].items():
            counts[k] += v
        print(f"[launches] {path}: {paths[path]}")
        check(all(paths[path][k] > 0 for k in expect),
              f"the {path} path did not launch every kernel of {expect}")
        return res

    # --- phase 2a: encoder kernels against their plain versions, every
    # configuration, on the edge-case windows
    windows, lens, starts, gold = edge_inputs(make_corpus, np)
    w_d = w_deep = torch.from_numpy(windows).to(dev)
    l_d = l_deep = torch.from_numpy(lens).to(dev)
    s_d = s_deep = torch.from_numpy(starts).to(dev)
    tb.parse_emit(w_d, l_d, s_d, tb.match_candidates(w_d, l_d))  # warm-up
    tb.match_candidates(w_d, l_d, 0, 1)
    edge_err = {"enc_match": 0, "enc_match_fast": 0, "enc_parse_emit": 0}
    edge_out = {}
    for hc, accel in EDGE_CONFIGS:
        ms_m, pk = cuda_ms(lambda: tb.match_candidates(w_d, l_d, hc, accel),
                           reps=3)
        pms_m, pk_plain = cuda_ms(
            lambda: tb.match_candidates_plain(w_d, l_d, hc, accel))
        err_m = max_abs_err(pk, pk_plain)
        ms_p, (out, olen) = cuda_ms(
            lambda: tb.parse_emit(w_d, l_d, s_d, pk, hc, accel), reps=3)
        pms_p, (out_p, olen_p) = cuda_ms(
            lambda: tb.parse_emit_plain(w_d, l_d, s_d, pk, hc, accel))
        err_p = max(max_abs_err(out, out_p), max_abs_err(olen, olen_p))
        kern = "enc_match" if hc else "enc_match_fast"
        edge_err[kern] = max(edge_err[kern], err_m)
        edge_err["enc_parse_emit"] = max(edge_err["enc_parse_emit"], err_p)
        edge_out[hc, accel] = (out.cpu().numpy(), olen.cpu().numpy())
        print(f"[K2/K3] hc={hc} accel={accel} at {len(lens)} x 64 KB: "
              f"{kern} {ms_m:.2f} ms (plain {pms_m:.1f} ms) max_abs_err "
              f"{err_m}; enc_parse_emit {ms_p:.2f} ms (plain {pms_p:.1f} "
              f"ms) max_abs_err {err_p}; out_len "
              f"{edge_out[hc, accel][1].tolist()}")
        check(err_m == 0 and err_p == 0,
              f"encoder kernels differ from plain at hc={hc} accel={accel}")
    # the 8 corpus blocks against the JAX reference's payloads
    level_gold = np.load(LEVEL_GOLDENS)
    gold_ok = {9: equals_goldens(*edge_out[9, 1], gold["out_len"],
                                 gold["payloads"]),
               0: equals_goldens(*edge_out[0, 1], level_gold["out_len_l0"],
                                 level_gold["payloads_l0"])}
    out4, olen4 = tb.encode_blocks(w_d[:8], l_d[:8], hc=4)
    gold_ok[4] = equals_goldens(out4.cpu().numpy(), olen4.cpu().numpy(),
                                level_gold["out_len_l4"],
                                level_gold["payloads_l4"])
    print(f"[K2/K3] {len(gold['out_len'])} corpus blocks == JAX goldens by "
          f"level: {gold_ok}")
    check(all(gold_ok.values()), "encoder output differs from JAX goldens")

    # --- phase 2b: the deep kernels against their plain versions, each
    # on the kernel's own inputs, every deep configuration, on the
    # edge-case windows
    deep_err = {"enc_deep_match": 0, "enc_deep_match_wide": 0,
                "enc_deep_dp": 0, "enc_deep_emit": 0}

    def deep_against_plain(what, w, ln, st_, hc, deep):
        """Runs the three deep kernels and their plain versions on
        windows ``w``; returns the kernels' (out, out_len) and the
        plain versions' milliseconds by kernel.  Windows over 64 KB
        take the wide finder."""
        finder = "enc_deep_match_wide" if w.shape[1] > BLK else \
            "enc_deep_match"
        pk = tb.match_candidates(w, ln, hc, 1, deep)
        p_m, pk_p = cuda_ms(
            lambda: tb.match_candidates_plain(w, ln, hc, 1, deep))
        st = tb.deep_dp(ln, st_, pk, deep)
        p_d, st_p = cuda_ms(lambda: tb.deep_dp_plain(ln, st_, pk, deep))
        out, olen = tb.deep_emit(w, ln, st_, pk, st)
        p_e, (out_p, olen_p) = cuda_ms(
            lambda: tb.deep_emit_plain(w, ln, st_, pk, st))
        errs = {finder: max_abs_err(pk, pk_p),
                "enc_deep_dp": max_abs_err(st, st_p),
                "enc_deep_emit": max(max_abs_err(out, out_p),
                                     max_abs_err(olen, olen_p))}
        tiers = ((pk >> 2) & 15)[pk != 0]
        print(f"[K4] {what}, hc={hc} deep={deep} at {w.shape[0]} x "
              f"{w.shape[1]} bytes: max_abs_err vs plain {errs}; plain ms: "
              f"{finder} {p_m:.1f}, enc_deep_dp {p_d:.1f}, enc_deep_emit "
              f"{p_e:.1f}; "
              f"deepest tier {int(tiers.max()) if tiers.numel() else 0}, "
              f"cut rows {int(((st & 0xFFFFF) == 18).sum())}")
        for k, v in errs.items():
            deep_err[k] = max(deep_err[k], v)
        check(not any(errs.values()),
              f"deep kernels differ from plain at hc={hc} deep={deep} "
              f"({what}): {errs}")
        return (out, olen), {finder: p_m, "enc_deep_dp": p_d,
                             "enc_deep_emit": p_e}

    deep_gold_ok = {}
    for hc, deep in ((8, 1), (8, 2), (8, 3), (4, 1)):
        (out, olen), _ms = deep_against_plain(
            "edge windows", w_deep, l_deep, s_deep, hc, deep)
        out_h, olen_h = out.cpu().numpy(), olen.cpu().numpy()
        for k in range(w_deep.shape[0]):        # the host oracle decodes each
            n_k, s_k = int(l_deep[k]), int(s_deep[k])
            got = lz4f_block_decode(out_h[k, :olen_h[k]].tobytes(),
                                    windows[k, :s_k].tobytes(), n_k - s_k)
            check(got == windows[k, s_k:n_k].tobytes(),
                  f"deep payload of edge window {k} does not decode")
        if hc == 8:
            dg = np.load(DEEP_GOLDENS.format(9 + deep))
            deep_gold_ok[9 + deep] = equals_goldens(
                out_h, olen_h, dg["out_len"][:len(gold["out_len"])],
                dg["payloads"])
    print(f"[K4] {len(gold['out_len'])} corpus blocks == JAX goldens by "
          f"level: {deep_gold_ok}; every edge payload decodes with the "
          f"host block decoder")
    check(all(deep_gold_ok.values()),
          "deep encoder output differs from JAX goldens")
    # enc_deep_emit where its extension pool overflows: more capped chosen
    # rows than P = 512, so only the first 512 by position are extended
    w_ov = torch.from_numpy(overflow_window(np)[None]).to(dev)
    l_ov = torch.full((1,), BLK, dtype=torch.int32, device=dev)
    s_ov = torch.zeros_like(l_ov)
    deep_against_plain("pool-overflow window", w_ov, l_ov, s_ov, 8, 3)
    st_ov = tb.deep_dp(l_ov, s_ov, tb.match_candidates(w_ov, l_ov, 8, 1, 3),
                       3)[0].long().cpu()
    chosen_ov = tb._greedy(((st_ov >> 30) & 1).bool(),
                           (st_ov & 0xFFFFF).tolist())
    capped_ov = int(((st_ov[chosen_ov] >> 29) & 1).sum())
    print(f"[K4] pool-overflow window: {len(chosen_ov)} chosen rows, "
          f"{capped_ov} of them capped, beside a pool of 512")
    check(capped_ov > 512, "the pool-overflow window does not overflow")
    del w_ov, st_ov

    # --- phase 2c: K1 against its plain version, on T-maps of 16
    # level-9 corpus blocks
    print("[corpus] generating make_corpus(48) ...", flush=True)
    t0 = time.perf_counter()
    data = make_corpus(48)
    n = len(data) - len(data) % (BLK * BENCH_BATCH)
    data = data[:n]
    nb = n // BLK
    print(f"[corpus] {n} bytes, {nb} blocks of 64 KB "
          f"({time.perf_counter() - t0:.1f} s)")
    codec = ShardedFrameCodec(compression_level=9, device="cuda")
    pays = [c for _r, c in codec._encode_span(data[:16 * BLK])]
    plen = np.array([len(p) for p in pays], np.int64)
    offs = np.zeros_like(plen)
    offs[1:] = np.cumsum(plen)[:-1]
    T, ol = native.native_resolve_tmap(b"".join(pays), offs, plen, BLK,
                                       reuse_buffers=False)
    check((ol == BLK).all(), "T-map resolve of the 16 blocks")
    fetch = np.zeros((len(pays), int(plen.max())), np.uint8)
    for k, p in enumerate(pays):
        fetch[k, :len(p)] = np.frombuffer(p, np.uint8)
    f_d, T_d = torch.from_numpy(fetch).to(dev), torch.from_numpy(T).to(dev)
    ol_d = torch.from_numpy(ol.astype(np.int32)).to(dev)
    dec = td.decode_blocks_tmap(f_d, T_d, ol_d)
    dec_p = td.decode_blocks_tmap_plain(f_d, T_d, ol_d)
    err_k1 = max_abs_err(dec, dec_p)
    same = dec.cpu().numpy().tobytes() == data[:16 * BLK]
    print(f"[K1] tmap_gather vs plain max_abs_err {err_k1}; 16 blocks "
          f"== input: {same}")
    check(err_k1 == 0 and same, "K1 differs from plain or input")

    def timed(fn, reps=REPS):
        """(median, min, max) milliseconds of ``reps`` runs of ``fn``."""
        ts = [cuda_ms(fn)[0] for _ in range(reps)]
        return statistics.median(ts), min(ts), max(ts)

    def fmt(t):
        return f"{t[0]:.2f} ms ({t[1]:.2f}-{t[2]:.2f})"

    def time_round_trip(what, cdc, fr, reps=REPS):
        """Times of ``cdc.compress_frame(data)`` and of
        ``cdc.decompress_frame(fr)`` on a ``[time]`` line."""
        t_e = timed(lambda: cdc.compress_frame(data), reps)
        t_d = timed(lambda: cdc.decompress_frame(fr), reps)
        gbs = 2 * n / ((t_e[0] + t_d[0]) / 1e3) / 1e9
        print(f"[time] {smi}: {what}, median of {reps}: compress_frame "
              f"{fmt(t_e)}, decompress_frame {fmt(t_d)} -> "
              f"2n/(t_enc+t_dec) = {gbs:.4f} GB/s over {n} bytes")

    # --- phase 3: the level-9 path, counted, then timed
    independent = lz4f.Preferences(frame_info=lz4f.FrameInfo(
        block_mode=lz4f.BlockMode.independent, content_checksum=True))
    host_frame = lz4f.compress_frame(data, independent)

    def level9_path():
        frame = codec.compress_frame(data)
        return (frame, codec.decompress_frame(frame),
                codec.decompress_frame(host_frame))

    frame, back, back_host = counted(
        "level 9", level9_path, ("enc_match", "enc_parse_emit", "tmap_gather"))
    check(lz4f.decompress_frame(frame) == data,
          "host decoder differs on the port's frame")
    check(back == data, "port decode of the port's frame")
    check(back_host == data, "port decode of the host frame")
    total = sum(len(c) for _r, c in codec._encode_span(data))
    ratio = n / total
    print(f"[main] {n} bytes -> frame {len(frame)} bytes; host decode "
          f"ok; port decode ok; port decode of host frame "
          f"({len(host_frame)} bytes) ok; level-9 ratio n/sum(out_len) "
          f"= {ratio:.6f} (expect {EXPECT_RATIO})")
    check(round(ratio, 4) == EXPECT_RATIO, f"ratio {ratio:.6f}")
    time_round_trip("level 9", codec, frame)

    # --- phase 4: level 0 at full width, counted, then timed;
    # acceleration; level 4
    codec0 = ShardedFrameCodec(compression_level=0, device="cuda")

    def level0_path():
        frame0 = codec0.compress_frame(data)
        return frame0, codec0.decompress_frame(frame0)

    frame0, back0 = counted(
        "level 0", level0_path,
        ("enc_match_fast", "enc_parse_emit", "tmap_gather"))
    check(lz4f.decompress_frame(frame0) == data,
          "host decoder differs on the port's level-0 frame")
    check(back0 == data, "port decode of the port's level-0 frame")
    time_round_trip("level 0", codec0, frame0)
    w_all = torch.from_numpy(np.frombuffer(data, np.uint8).copy()
                             .reshape(nb, BLK)).to(dev)
    l_all = torch.full((nb,), BLK, dtype=torch.int32, device=dev)
    s_all = torch.zeros_like(l_all)
    ratios = {}
    for accel in (1, 2, 4, 8):
        _o, olen_a = tb.encode_blocks(w_all, l_all, hc=0, accel=accel)
        ratios[accel] = n / int(olen_a.sum())
    print(f"[fast] {n} bytes -> level-0 frame {len(frame0)} bytes; host "
          f"decode ok; port decode ok; ratios n/sum(out_len) by accel: "
          + ", ".join(f"{a}: {r:.6f}" for a, r in ratios.items())
          + f" (expect 1: {EXPECT_RATIO_FAST}, {EXPECT_RATIO_ACCEL})")
    check(round(ratios[1], 4) == EXPECT_RATIO_FAST,
          f"level-0 ratio {ratios[1]:.6f}")
    for accel, want in EXPECT_RATIO_ACCEL.items():
        check(round(ratios[accel], 4) == want,
              f"accel {accel} ratio {ratios[accel]:.6f}")
    codec4 = ShardedFrameCodec(compression_level=4, device="cuda")
    frame4 = codec4.compress_frame(data)
    check(lz4f.decompress_frame(frame4) == data
          and codec4.decompress_frame(frame4) == data,
          "level-4 round trip")
    ratio4 = n / sum(len(c) for _r, c in codec4._encode_span(data))
    print(f"[level 4] frame {len(frame4)} bytes; host decode ok; port "
          f"decode ok; ratio n/sum(out_len) = {ratio4:.6f}")

    # --- phase 5: linked frames at full width, counted, then timed;
    # dictionaries
    linked = lz4f.Preferences(frame_info=lz4f.FrameInfo(
        block_size_id=lz4f.BlockSizeID.max64KB,
        block_mode=lz4f.BlockMode.linked, content_checksum=True))
    linked_frame = lz4f.compress_frame(data, linked)
    check(lz4f.parse_frame_header(linked_frame)[0].block_mode
          == lz4f.BlockMode.linked, "the host frame is not linked")
    back_l = counted("linked", lambda: codec.decompress_frame(linked_frame),
                     ("linked_tmap_step",))
    check(back_l == data, "port decode of the linked frame")
    t_decl = timed(lambda: codec.decompress_frame(linked_frame))
    print(f"[time] {smi}: linked frame ({len(linked_frame)} bytes), median "
          f"of {REPS}: decompress_frame {fmt(t_decl)} = "
          f"{n / (t_decl[0] / 1e3) / 1e9:.4f} GB/s of output")
    # one window's step against its plain version, and its library call
    info_l, pos_l = lz4f.parse_frame_header(linked_frame)
    records, _end = _scan_blocks(linked_frame, pos_l, info_l.block_checksum)
    windows_l = list(codec._resolve_linked_windows(records, BLK))
    pay_w, T_w, total_w = windows_l[1]          # entered with history
    at_w = windows_l[0][2]                      # where window 1 starts
    check(at_w >= BLK and total_w >= BLK,
          f"linked windows of {at_w} and {total_w} bytes")
    # one launch per non-empty window, and no other kernel
    live_w = sum(1 for w in windows_l if w[2])
    check(paths["linked"]["linked_tmap_step"] == live_w
          and sum(paths["linked"].values()) == live_w,
          f"the linked path launched {paths['linked']} for {live_w} "
          "non-empty windows")
    hist_w = np.frombuffer(data[at_w - BLK:at_w], np.uint8)
    h_d = torch.from_numpy(hist_w.copy()).to(dev)
    p_d = torch.from_numpy(np.frombuffer(pay_w, np.uint8).copy()).to(dev)
    t_stage_w, Tw_d = cuda_ms(lambda: torch.from_numpy(T_w[:total_w]).to(dev))
    td.linked_tmap_step(h_d, p_d, Tw_d, total_w)
    out_w, hist_n = td.linked_tmap_step(h_d, p_d, Tw_d, total_w)
    out_wp, hist_np = td.linked_tmap_step_plain(h_d, p_d, Tw_d, total_w)
    err_lg = max(max_abs_err(out_w, out_wp), max_abs_err(hist_n, hist_np))
    same_w = out_w.cpu().numpy().tobytes() == data[at_w:at_w + total_w]
    print(f"[K5] window 1 of {len(windows_l)} (payloads {len(pay_w)} bytes, "
          f"output {total_w}): linked_tmap_step (one launch per window, "
          f"{live_w} on the path) vs plain max_abs_err {err_lg} over the "
          f"window and the new history; window == input: {same_w}")
    check(err_lg == 0 and same_w, "K5 differs from plain or input")
    # dictionary frames of both kinds, a few MB each
    part = data[5 << 20:9 << 20]
    d = data[(5 << 20) - 70_000:5 << 20]
    codec_d = ShardedFrameCodec(device="cuda", dictionary=d)
    for mode, prefs in (("linked", linked), ("independent", independent)):
        fr_d = lz4f.compress_frame(part, prefs, dictionary=d)
        check(codec_d.decompress_frame(fr_d) == part,
              f"port decode of the {mode} dictionary frame")
        check(lz4f.decompress_frame(fr_d, dictionary=d) == part,
              f"host decode of the {mode} dictionary frame")
    print(f"[dict] linked and independent frames of {len(part)} bytes with "
          f"a {len(d)}-byte dictionary: port decode ok")

    # --- phase 5b: windows over 64 KB.  enc_match_wide and enc_parse_emit
    # against their plain versions, every configuration, on the wide edge
    # windows and two sub-span windows of the corpus; then the JAX
    # payloads of the wide goldens
    from zig_lz4_tpu_torch.parallel import sharded as sh
    wide_err = {"enc_match_wide": 0, "enc_parse_emit": 0}
    for windows_w, lens_w, starts_w in wide_edge_inputs(np, data):
        w_e, l_e, s_e = (torch.from_numpy(a).to(dev)
                         for a in (windows_w, lens_w, starts_w))
        width = windows_w.shape[1]
        for hc, accel in (WIDE_CONFIGS if width < SUB_WINDOW
                          else [(9, 1), (0, 1)]):
            pk_e = tb.match_candidates(w_e, l_e, hc, accel)
            pk_ep = tb.match_candidates_plain(w_e, l_e, hc, accel)
            out_e, olen_e = tb.parse_emit(w_e, l_e, s_e, pk_e, hc, accel)
            out_ep, olen_ep = tb.parse_emit_plain(w_e, l_e, s_e, pk_e, hc,
                                                  accel)
            err_m = max_abs_err(pk_e, pk_ep)
            err_p = max(max_abs_err(out_e, out_ep),
                        max_abs_err(olen_e, olen_ep))
            wide_err["enc_match_wide"] = max(wide_err["enc_match_wide"],
                                             err_m)
            wide_err["enc_parse_emit"] = max(wide_err["enc_parse_emit"],
                                             err_p)
            out_h, olen_h = out_e.cpu().numpy(), olen_e.cpu().numpy()
            for k in range(len(lens_w)):      # the host oracle decodes each
                n_k, s_k = int(lens_w[k]), int(starts_w[k])
                got = lz4f_block_decode(out_h[k, :olen_h[k]].tobytes(),
                                        windows_w[k, :s_k].tobytes(),
                                        n_k - s_k)
                check(got == windows_w[k, s_k:n_k].tobytes(),
                      f"wide payload {k} at {width} bytes, hc={hc} does "
                      "not decode")
            print(f"[wide] hc={hc} accel={accel} at {len(lens_w)} x {width} "
                  f"bytes: enc_match_wide vs plain max_abs_err {err_m}, "
                  f"enc_parse_emit vs plain max_abs_err {err_p}; out_len "
                  f"{olen_h.tolist()}; every payload decodes")
            check(err_m == 0 and err_p == 0,
                  f"wide kernels differ from plain at {width}, hc={hc}")
    # the tie-dense windows at both widths, every finder configuration:
    # one length in two leaves tail rows (s0's override) and zero bytes
    for blk_t in (2 * BLK, SUB_WINDOW):
        w_t = torch.from_numpy(np.stack([
            np.frombuffer(r, np.uint8) for r in tie_dense(np, blk_t)])).to(dev)
        l_t = torch.full((w_t.shape[0],), blk_t, dtype=torch.int32,
                         device=dev)
        l_t[1::2] -= 5
        errs_t = {}
        for hc, deep in ((9, 0), (3, 0), (0, 0), (8, 1), (8, 2), (8, 3)):
            err_t = max_abs_err(
                tb.match_candidates(w_t, l_t, hc, 1, deep),
                tb.match_candidates_plain(w_t, l_t, hc, 1, deep))
            kern = "enc_deep_match_wide" if deep else "enc_match_wide"
            errs_t[f"{kern} hc={hc} deep={deep}"] = err_t
            if deep:
                deep_err[kern] = max(deep_err[kern], err_t)
            else:
                wide_err[kern] = max(wide_err[kern], err_t)
        print(f"[wide] {w_t.shape[0]} tie-dense windows of {blk_t} bytes: "
              f"finders vs plain max_abs_err {errs_t}")
        check(not any(errs_t.values()),
              f"a wide finder differs from plain on tie-dense windows of "
              f"{blk_t} bytes")
    del w_e, pk_e, pk_ep, out_e, out_ep, w_t
    wg = np.load(WIDE_GOLDENS)
    corpus_g = make_corpus(int(wg["corpus_mb"]))
    wide_gold_ok, wide_gold_in = {}, {}
    for gname in ("w131k", "w262k", "w327k"):
        blk_g, start_g = int(wg[f"{gname}_blk"]), int(wg[f"{gname}_start"])
        lens_g = wg[f"{gname}_lens"]
        windows_g = np.zeros((len(lens_g), blk_g), np.uint8)
        for k, (o, n_) in enumerate(zip(wg[f"{gname}_offsets"], lens_g)):
            windows_g[k, :n_] = np.frombuffer(corpus_g[o:o + n_], np.uint8)
        w_g = torch.from_numpy(windows_g).to(dev)
        l_g = torch.from_numpy(lens_g).to(dev)
        s_g = torch.full_like(l_g, start_g)
        wide_gold_in[gname] = (windows_g, lens_g, start_g)
        for hc in wg[f"{gname}_hcs"].tolist():
            out_g, olen_g = tb.encode_blocks(w_g, l_g, s_g, hc=hc)
            wide_gold_ok[f"{gname} hc={hc}"] = equals_goldens(
                out_g.cpu().numpy(), olen_g.cpu().numpy(),
                wg[f"{gname}_hc{hc}_out_len"], wg[f"{gname}_hc{hc}_payloads"])
    print(f"[wide] make_corpus(2) windows == JAX goldens: {wide_gold_ok}")
    check(all(wide_gold_ok.values()), "wide encode differs from JAX goldens")

    # --- phase 5c: frames whose windows are over 64 KB, counted,
    # round-tripped by the host decoder and by the port, then timed:
    # dictionary frames (windows of 131,072 bytes), 256 KB blocks, and 1 MB
    # and 4 MB blocks as 327,680-byte sub-span windows
    wide_rec, wide_ratio = {}, {}

    def wide_path(what, cdc, part_w, plain_ratio=None, expect=WIDE_KERNELS,
                  forbid=("enc_match", "enc_match_fast")):
        """``cdc.compress_frame(part_w)`` and its decode, counted: the
        kernels ``expect`` launched, the kernels ``forbid`` did not."""
        def run():
            fr_w = cdc.compress_frame(part_w)
            return fr_w, cdc.decompress_frame(fr_w)
        with EncodeRecorder(sh) as rec:
            fr_w, back_w = counted(what, run, expect)
        check(not any(paths[what][k] for k in forbid),
              f"{what}: a window went to one of {forbid}")
        check(back_w == part_w, f"{what}: port decode of the port's frame")
        check(lz4f.decompress_frame(fr_w, dictionary=cdc.dict or None)
              == part_w, f"{what}: host decode of the port's frame")
        wide_rec[what] = rec.calls
        wide_ratio[what] = len(part_w) / len(fr_w)
        t_w = timed(lambda: cdc.compress_frame(part_w), 3)
        print(f"[wide] {what}: {len(part_w)} bytes -> frame {len(fr_w)} "
              f"bytes in {sum(c[0][0].shape[0] for c in rec.calls)} windows "
              f"of {rec.calls[0][0][0].shape[1]} bytes; host decode ok; port "
              f"decode ok; n / frame bytes = {wide_ratio[what]:.6f}"
              + (f" (without the dictionary: {plain_ratio:.6f})"
                 if plain_ratio else ""))
        print(f"[time] {smi}: {what}, median of 3: compress_frame "
              f"{fmt(t_w)}")
        return fr_w

    part_d = data[5 << 20:21 << 20]
    for level, cdc_plain in ((9, codec), (0, codec0)):
        wide_path(f"dictionary, level {level}",
                  ShardedFrameCodec(device="cuda", dictionary=d,
                                    compression_level=level), part_d,
                  len(part_d) / len(cdc_plain.compress_frame(part_d)))
    wide_path("256 KB blocks, level 9", ShardedFrameCodec(
        device="cuda", compression_level=9,
        block_size_id=lz4f.BlockSizeID.max256KB), data[:16 << 20])
    for level in (9, 0):
        wide_path(f"1 MB blocks, level {level}", ShardedFrameCodec(
            device="cuda", compression_level=level,
            block_size_id=lz4f.BlockSizeID.max1MB), data)
    wide_path("4 MB blocks, level 9", ShardedFrameCodec(
        device="cuda", compression_level=9,
        block_size_id=lz4f.BlockSizeID.max4MB), data[:16 << 20])

    # --- phase 5d: levels 10-12 in windows over 64 KB.  The three deep
    # kernels against their plain versions at deep 1, 2 and 3 on wide edge
    # windows and corpus sub-span windows, the JAX payloads of
    # wide_deep_corpus.npz, then the frames, counted, round-tripped by the
    # host decoder and by the port, and timed
    edge_sets = wide_edge_inputs(np, data)
    for deep, rows_by_set in WIDE_DEEP_EDGE.items():
        for (windows_w, lens_w, starts_w), rows, what in zip(
                edge_sets, rows_by_set,
                ("wide edge windows", "corpus sub-span windows")):
            w_e, l_e, s_e = (torch.from_numpy(a[rows]).to(dev)
                             for a in (windows_w, lens_w, starts_w))
            (out_e, olen_e), _ms = deep_against_plain(what, w_e, l_e, s_e, 8,
                                                      deep)
            out_h, olen_h = out_e.cpu().numpy(), olen_e.cpu().numpy()
            for j, k in enumerate(rows):       # the host oracle decodes each
                n_k, s_k = int(lens_w[k]), int(starts_w[k])
                got = lz4f_block_decode(out_h[j, :olen_h[j]].tobytes(),
                                        windows_w[k, :s_k].tobytes(),
                                        n_k - s_k)
                check(got == windows_w[k, s_k:n_k].tobytes(),
                      f"wide deep payload {k} at {windows_w.shape[1]} "
                      f"bytes, deep={deep} does not decode")
    del w_e, out_e
    wdg = np.load(WIDE_DEEP_GOLDENS)
    wide_deep_gold_ok = {}
    for gname, (windows_g, lens_g, start_g) in wide_gold_in.items():
        for level in DEEP_LEVELS:
            if f"{gname}_l{level}_lens" not in wdg:
                continue
            lens_d = wdg[f"{gname}_l{level}_lens"]
            starts_d = np.full(len(lens_d), start_g, np.int32)
            windows_d = np.zeros((len(lens_d), windows_g.shape[1]), np.uint8)
            windows_d[:len(lens_g)] = windows_g
            starts_d[len(lens_g):] = 0      # the all-zero window after them
            hc, deep = tb.level_params(level)
            out_g, olen_g = tb.encode_blocks(
                *(torch.from_numpy(a).to(dev)
                  for a in (windows_d, lens_d, starts_d)), hc=hc, deep=deep)
            wide_deep_gold_ok[f"{gname} level {level}"] = equals_goldens(
                out_g.cpu().numpy(), olen_g.cpu().numpy(),
                wdg[f"{gname}_l{level}_out_len"],
                wdg[f"{gname}_l{level}_payloads"])
    print(f"[wide deep] make_corpus(2) windows == JAX goldens: "
          f"{wide_deep_gold_ok}")
    check(all(wide_deep_gold_ok.values()),
          "wide deep encode differs from JAX goldens")
    no_64k = ("enc_deep_match", "enc_match", "enc_match_fast",
              "enc_match_wide")
    wide_path("1 MB blocks, level 12", ShardedFrameCodec(
        device="cuda", compression_level=12,
        block_size_id=lz4f.BlockSizeID.max1MB), data,
        expect=WIDE_DEEP_KERNELS, forbid=no_64k)
    wide_path("dictionary, level 10",
              ShardedFrameCodec(device="cuda", dictionary=d,
                                compression_level=10), part_d,
              expect=WIDE_DEEP_KERNELS, forbid=no_64k)
    wide_path("4 MB blocks, level 11", ShardedFrameCodec(
        device="cuda", compression_level=11,
        block_size_id=lz4f.BlockSizeID.max4MB), data[:16 << 20],
        expect=WIDE_DEEP_KERNELS, forbid=no_64k)
    print("[wide deep] n / frame bytes: "
          + ", ".join(f"{k} {wide_ratio[k]:.6f}" for k in (
              "1 MB blocks, level 12", "1 MB blocks, level 9",
              "dictionary, level 10", "dictionary, level 9",
              "4 MB blocks, level 11", "4 MB blocks, level 9")))
    for what, want in EXPECT_RATIO_WIDE.items():
        check(round(wide_ratio[what], 6) == want,
              f"{what}: n / frame bytes {wide_ratio[what]:.6f}, not {want}")

    # --- phase 6: the deep levels at full width, counted, then timed
    deep_frames, deep_ratio = {}, {}
    for level in DEEP_LEVELS:
        cdc = ShardedFrameCodec(compression_level=level, device="cuda")

        def deep_path():
            fr = cdc.compress_frame(data)
            return fr, cdc.decompress_frame(fr)

        fr, back_d = counted(f"level {level}", deep_path,
                             DEEP_KERNELS + ("tmap_gather",))
        check(lz4f.decompress_frame(fr) == data,
              f"host decoder differs on the port's level-{level} frame")
        check(back_d == data, f"port decode of the port's level-{level} "
              "frame")
        _o, olen_d = tb.encode_blocks(w_all, l_all, hc=cdc.hc, deep=cdc.deep)
        deep_ratio[level] = n / int(olen_d.sum())
        deep_frames[level] = fr
        print(f"[deep] level {level}: {n} bytes -> frame {len(fr)} bytes; "
              f"host decode ok; port decode ok; ratio n/sum(out_len) = "
              f"{deep_ratio[level]:.6f}"
              + (f" (expect {EXPECT_RATIO_DEEP[level]})"
                 if level in EXPECT_RATIO_DEEP else ""))
        time_round_trip(f"level {level}", cdc, fr, reps=3)
    for level, want in EXPECT_RATIO_DEEP.items():
        check(round(deep_ratio[level], 4) == want,
              f"level-{level} ratio {deep_ratio[level]:.6f}")
    check(deep_ratio[12] > ratio,
          f"deep ratios {deep_ratio} beside level 9's {ratio:.6f}")
    # every 12th corpus block against the plain versions, at each level
    sel = torch.arange(0, nb, PLAIN_STRIDE, device=dev)
    w_sel, l_sel, s_sel = w_all[sel], l_all[sel], s_all[sel]
    deep_plain_ms = {}
    for level in DEEP_LEVELS:
        hc, deep = tb.level_params(level)
        _out, deep_plain_ms[level] = deep_against_plain(
            f"every {PLAIN_STRIDE}th corpus block", w_sel, l_sel, s_sel, hc,
            deep)

    # --- phase 7: the sequence-rebuild decoder: the block codec, the
    # batched entry point over the level-12 frame's compressed blocks,
    # and a frame decoded without the native host runtime
    block_codec = get_codec("cuda12")
    check(type(block_codec).__name__ == "CUDACodec"
          and block_codec.level == 12, "get_codec('cuda12')")
    idx12, recs12 = frame_payloads(deep_frames[12], lz4f)
    at = idx12[len(idx12) // 2]                 # a block that compresses
    one = data[at * BLK:(at + 1) * BLK]

    def block_path():
        comp = block_codec.compress(one)
        return comp, block_codec.decompress(comp, BLK)

    comp_one, back_one = counted("block codec, level 12", block_path,
                                 DEEP_KERNELS + ("seq_decode",))
    check(back_one == one and decompress_safe(comp_one, BLK) == one
          and comp_one == recs12[len(idx12) // 2],
          "CUDACodec round trip of one 64 KB block")
    print(f"[block codec] get_codec('cuda12'): block {at}, {len(one)} bytes "
          f"-> {len(comp_one)} (the frame's payload) -> decompress ok; host "
          f"block decoder ok")

    plen12 = np.array([len(p) for p in recs12], np.int64)
    offs12 = np.zeros_like(plen12)
    offs12[1:] = np.cumsum(plen12)[:-1]
    concat12 = b"".join(recs12)
    t_parse = time.perf_counter()
    tabs = native.native_parse_blocks(concat12, offs12, plen12,
                                      td.MAX_SEQS(BLK))
    t_parse = time.perf_counter() - t_parse
    comp12 = np.zeros((len(recs12), compress_bound(BLK)), np.uint8)
    for k, p_ in enumerate(recs12):
        comp12[k, :len(p_)] = np.frombuffer(p_, np.uint8)
    t_stage_s, seq_in = cuda_ms(lambda: [
        torch.from_numpy(a).to(dev) for a in (comp12, *tabs)])

    def seq_path():
        return td.decode_blocks(*seq_in, BLK)

    out_s, olen_s, ok_s = counted("decode_blocks, level-12 frame", seq_path,
                                  ("seq_decode",))
    want12 = b"".join(data[k * BLK:(k + 1) * BLK] for k in idx12)
    same_s = (bool(ok_s.all()) and bool((olen_s == BLK).all())
              and out_s.cpu().numpy().tobytes() == want12)
    # the other route over the same blocks: T-map resolve and tmap_gather
    T12, ol12 = native.native_resolve_tmap(concat12, offs12, plen12, BLK,
                                           reuse_buffers=False)
    f12_d = torch.from_numpy(comp12[:, :int(plen12.max())].copy()).to(dev)
    T12_d = torch.from_numpy(T12).to(dev)
    ol12_d = torch.from_numpy(ol12.astype(np.int32)).to(dev)
    k1_out = td.decode_blocks_tmap(f12_d, T12_d, ol12_d)
    err_s_k1 = max_abs_err(out_s, k1_out)
    k_seq, _ = cuda_ms(seq_path, 5)
    k1_same, _ = cuda_ms(lambda: td.decode_blocks_tmap(f12_d, T12_d, ol12_d),
                         5)
    del T12_d, k1_out
    # against the plain version on blocks spread over the frame
    step = max(len(recs12) // SEQ_PLAIN_BLOCKS, 1)
    sub = [a[::step].contiguous() for a in seq_in]
    p_seq, plain_s = cuda_ms(lambda: td.decode_blocks_plain(*sub, BLK))
    k_seq_sub, kern_s = cuda_ms(lambda: td.decode_blocks(*sub, BLK))
    err_seq = max(max_abs_err(a, b) for a, b in zip(kern_s, plain_s))
    nseq_live = int(tabs[4].sum())
    print(f"[K6] seq_decode over the {len(recs12)} compressed blocks of the "
          f"level-12 frame ({nseq_live} sequences): == input {same_s}; vs "
          f"tmap_gather on the same blocks max_abs_err {err_s_k1}; vs plain "
          f"on {sub[0].shape[0]} blocks max_abs_err {err_seq}")
    check(same_s and err_s_k1 == 0 and err_seq == 0,
          "K6 differs from the input, from K1 or from plain")
    b_seq = bound(len(concat12) + 16 * nseq_live + 4 * len(recs12)
                  + len(recs12) * (BLK + 8), len(recs12) * BLK)
    results["seq_decode"].update(
        max_abs_err=max(err_seq, err_s_k1), ms=k_seq, plain_ms=p_seq,
        plain_blocks=int(sub[0].shape[0]), bound_ms=b_seq[0],
        bound_by=b_seq[1], library_ms=None, tmap_gather_ms=k1_same)
    print(f"[time] {smi}: seq_decode at {len(recs12)} x 64 KB {k_seq:.3f} ms "
          f"(bound {b_seq[0]:.4f} ms by {b_seq[1]}; tmap_gather on the same "
          f"blocks {k1_same:.4f} ms; host parse {t_parse * 1e3:.2f} ms, "
          f"staging {t_stage_s:.2f} ms); at {sub[0].shape[0]} blocks "
          f"{k_seq_sub:.3f} ms, plain {p_seq:.1f} ms")

    # seq_decode by phase (the cuts of seq_decode.cu), its rounds, and its
    # worst cases against plain: chains through every sequence and a
    # 65,535-byte run
    t_k6 = time.perf_counter()
    phase_libs = finish_phase_builds(phase_jobs)
    seq_rounds = torch.zeros(len(recs12), dtype=torch.int32, device=dev)
    out_r = td.decode_blocks(*seq_in, BLK, rounds=seq_rounds)
    check(torch.equal(out_r[0], out_s), "seq_decode with its rounds differs")
    seq_phases = by_phase(SEQ_PHASES, seq_phase_split(phase_libs, seq_in, BLK),
                          k_seq)
    seq_phases_sub = by_phase(SEQ_PHASES,
                              seq_phase_split(phase_libs, sub, BLK),
                              k_seq_sub)
    rounds_h = seq_rounds.cpu().numpy()
    worst = {}
    for what, tabs_w, hist_w in seq_worst_cases(np):
        a_w = [torch.from_numpy(x).to(dev) for x in tabs_w]
        h_w = None if hist_w is None else torch.from_numpy(hist_w).to(dev)
        r_w = torch.zeros(1, dtype=torch.int32, device=dev)
        got_w = td.decode_blocks(*a_w, BLK, hists=h_w, rounds=r_w)
        want_w = td.decode_blocks_plain(*a_w, BLK, hists=h_w)
        err_w = max(max_abs_err(x, y) for x, y in zip(got_w, want_w))
        check(err_w == 0 and bool(got_w[2].all()),
              f"seq_decode differs from plain on the {what}")
        worst[what] = dict(max_abs_err=err_w, rounds=int(r_w[0]))
    print(f"[K6] seq_decode on its worst cases vs plain: {worst} (these "
          f"checks and the phase cuts {time.perf_counter() - t_k6:.1f} s)")
    print(f"[time] {smi}: seq_decode at {len(recs12)} x 64 KB by phase (cuts "
          "of seq_decode.cu, -DZL4_STOP=1..3): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in seq_phases.items())
          + f"; whole {k_seq:.4f} ms; at {sub[0].shape[0]} blocks: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in seq_phases_sub.items())
          + f"; whole {k_seq_sub:.4f} ms; rounds a block: max "
          f"{int(rounds_h.max())}, mean {float(rounds_h.mean()):.4f}")
    results["seq_decode"].update(
        ms_32_blocks=k_seq_sub, phase_ms=seq_phases,
        phase_ms_32_blocks=seq_phases_sub, rounds_max=int(rounds_h.max()),
        rounds_mean=float(rounds_h.mean()), worst_cases=worst,
        max_abs_err=max(results["seq_decode"]["max_abs_err"],
                        *(w["max_abs_err"] for w in worst.values())))
    del out_r, seq_rounds

    # P1: the serial decoder over the same 672 blocks, counted; against
    # seq_decode's out (the other route for the same semantics), and
    # against its plain version on the same 32 blocks
    from zig_lz4_tpu_torch.probes import serial_decode as sd
    out_p1, olen_p1 = counted("serial decode, level-12 frame",
                              lambda: sd.decode_blocks_serial(*seq_in, BLK),
                              ("serial_decode",))
    err_p1_k6 = max(max_abs_err(out_p1, out_s),
                    max_abs_err(olen_p1, olen_s))
    k_p1, _ = cuda_ms(lambda: sd.decode_blocks_serial(*seq_in, BLK), 5)
    p_p1, plain_p1 = cuda_ms(lambda: sd.decode_blocks_serial_plain(*sub,
                                                                    BLK))
    _k, kern_p1 = cuda_ms(lambda: sd.decode_blocks_serial(*sub, BLK))
    err_p1 = max(max_abs_err(a, b) for a, b in zip(kern_p1, plain_p1))
    print(f"[P1] serial_decode over the {len(recs12)} compressed blocks of "
          f"the level-12 frame: vs seq_decode's out and out_len max_abs_err "
          f"{err_p1_k6}; vs plain on {sub[0].shape[0]} blocks max_abs_err "
          f"{err_p1}")
    check(err_p1_k6 == 0 and err_p1 == 0,
          "P1 differs from seq_decode or from plain")
    # its phases (the cuts of serial_decode.cu), its launch shape, and the
    # warp route (blocks past the shared-memory row) against plain on the
    # same 32 blocks
    serial_cuts = serial_phase_split(phase_libs, seq_in, BLK)
    serial_raw = serial_cuts.pop("whole")
    serial_phases = by_phase(SERIAL_PHASES, serial_cuts, serial_raw)
    serial_shape = sd.serial_launch_shape(BLK)
    check(serial_shape["shared_row"] and serial_shape["ctas_per_sm"] > 0,
          f"serial_decode's shared-memory route at 64 KB: {serial_shape}")
    big = 4 * BLK
    check(not sd.serial_launch_shape(big)["shared_row"],
          f"serial_decode keeps {big}-byte rows in shared memory")
    k_big, kern_big = cuda_ms(lambda: sd.decode_blocks_serial(*sub, big))
    plain_big = sd.decode_blocks_serial_plain(*sub, big)
    err_big = max(max_abs_err(a, b) for a, b in zip(kern_big, plain_big))
    check(err_big == 0, "serial_decode's warp route differs from plain")
    # the walk's work: matches of one round of a byte a lane (at most 32
    # bytes, not overlapping themselves) and the others, with their bytes
    ns_h = seq_in[5].cpu().numpy().astype(np.int64)
    live_h = np.arange(seq_in[1].shape[1])[None, :] < ns_h[:, None]
    m_h = np.where(live_h, np.maximum(seq_in[3].cpu().numpy(), 0), 0)
    one_h = live_h & (m_h <= 32) & (m_h <= np.maximum(
        seq_in[4].cpu().numpy(), 1))
    walk = {"one_round": int(one_h.sum()),
            "one_round_bytes": int(m_h[one_h].sum()),
            "longer": int((live_h & ~one_h & (m_h > 0)).sum()),
            "longer_bytes": int(m_h[~one_h].sum()),
            "sequences_max_a_block": int(ns_h.max())}
    print(f"[P1] serial_decode launch shape at 64 KB {serial_shape}; the warp "
          f"route ({big}-byte rows) on {sub[0].shape[0]} blocks vs plain "
          f"max_abs_err {err_big}, {k_big:.3f} ms; the walk's matches {walk}")
    results["serial_decode"].update(
        max_abs_err=max(err_p1, err_p1_k6, err_big), ms=k_p1, plain_ms=p_p1,
        plain_blocks=int(sub[0].shape[0]), bound_ms=b_seq[0],
        bound_by=b_seq[1], library_ms=None, seq_decode_ms=k_seq,
        kernel_ms=serial_raw, phase_ms=serial_phases,
        launch_shape=serial_shape, warp_route_ms_32_blocks=k_big,
        walk=walk)
    print(f"[time] {smi}: serial_decode at {len(recs12)} x 64 KB "
          f"{k_p1:.3f} ms (bound {b_seq[0]:.4f} ms by {b_seq[1]}; seq_decode "
          f"on the same blocks {k_seq:.3f} ms), plain at {sub[0].shape[0]} "
          f"blocks {p_p1:.1f} ms; the kernel alone {serial_raw:.4f} ms, by "
          "phase (cuts of serial_decode.cu, -DZL4_STOP=1..2): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in serial_phases.items()))
    del seq_in, out_s, sub, kern_s, plain_s, out_p1, kern_p1, plain_p1
    del kern_big, plain_big

    # a frame of every 12th block, decoded by a child process that runs
    # without the native host runtime: seq_decode instead of tmap_gather
    part12 = b"".join(data[k * BLK:(k + 1) * BLK]
                      for k in range(0, nb, PLAIN_STRIDE))
    frame_part = ShardedFrameCodec(compression_level=12, device="cuda"
                                   ).compress_frame(part12)
    t_child = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), CHILD_FLAG],
        input=frame_part, capture_output=True, timeout=600,
        env={**os.environ, "ZIG_LZ4_TPU_NO_NATIVE": "1"})
    t_child = time.perf_counter() - t_child
    check(child.returncode == 0,
          f"the no-native child failed: {child.stderr.decode()[-2000:]}")
    told = json.loads(child.stdout.decode().strip().splitlines()[-1])
    check(told["sha256"] == hashlib.sha256(part12).hexdigest()
          and told["bytes"] == len(part12),
          "the no-native decode differs from the input")
    check(told["launches"]["seq_decode"] > 0
          and told["launches"]["tmap_gather"] == 0,
          f"the no-native decode launched {told['launches']}")
    print(f"[no native] ZIG_LZ4_TPU_NO_NATIVE=1 child: decompress_frame of a "
          f"level-12 frame of {len(part12)} bytes ok in {t_child:.1f} s "
          f"(process start and Python parse included); launches "
          f"{ {k: v for k, v in told['launches'].items() if v} }")


    # --- phase 7b: the fragment ladder.  First the three kernels against
    # their plain versions on the same CUDA tensors: edge tables (an
    # empty block, one byte, periods 1-13, a chain in which every copy
    # reads the one before) and every 12th corpus block at levels 9 and 0
    from zig_lz4_tpu_torch.ops import torch_frags as tfr
    from zig_lz4_tpu_torch.ops.block import compress_fast
    from zig_lz4_tpu_torch.parallel import sharded as sh

    def chain_block():
        piece = np.random.default_rng(7).integers(65, 91, 40, np.uint8)
        out = bytearray(piece.tobytes())
        while len(out) < BLK:
            out += out[-37:]
        return bytes(out[:BLK])

    edge_blocks = [b"", b"\x2a", chain_block()] + [
        (bytes(range(65, 65 + p)) * (BLK // p + 1))[:BLK]
        for p in range(1, 14)]
    ladder_pays = [compress_fast(b) if b else b"\x00" for b in edge_blocks]
    ladder_want = list(edge_blocks)
    for fr_l in (frame, frame0):
        idx_l, recs_l = frame_payloads(fr_l, lz4f)
        for k, p_ in zip(idx_l, recs_l):
            if k % PLAIN_STRIDE == 0:
                ladder_pays.append(p_)
                ladder_want.append(data[k * BLK:(k + 1) * BLK])

    def ladder_tables(pays, split_max, round_limit, fcap=BLK, bs=BLK):
        """The resolver's tables of ``pays`` on the card, cut to the
        largest fragment count: (args of the wrappers, rounds, nfrag)."""
        ln = np.array([len(p_) for p_ in pays], np.int64)
        of = np.zeros_like(ln)
        of[1:] = np.cumsum(ln)[:-1]
        fd, _fl, fs, fp, fh, nf, rd, ol = native.native_resolve_blocks(
            b"".join(pays), of, ln, fcap, out_cap=bs, split_max=split_max,
            round_limit=round_limit, reuse_buffers=False)
        check((nf >= 0).all(), "a block overflowed the resolver's budget")
        ncol = max(int(nf.max()), 1)
        comp_ = np.zeros((len(pays), int(ln.max())), np.uint8)
        for k, p_ in enumerate(pays):
            comp_[k, :len(p_)] = np.frombuffer(p_, np.uint8)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            comp_, fd[:, :ncol], fs[:, :ncol], fp[:, :ncol], fh[:, :ncol],
            nf, ol.astype(np.int32))]
        return args, rd, nf

    ladder_err = {"frag_decode": 0, "frag_decode_win": 0,
                  "frag_decode_chase": 0}

    def ladder_against_plain(kern, fn, fn_plain, spec):
        (split_max, round_limit), configs = spec
        args, rd, nf = ladder_tables(ladder_pays, split_max, round_limit)
        for cfg in configs:
            cfg = dict(cfg)
            clears = cfg.pop("clears", None)
            if kern == "frag_decode_chase":
                call = lambda f: f(*args, BLK, **cfg)          # noqa: E731
            else:
                kw = {k: v for k, v in cfg.items() if k != "rounds"}
                call = lambda f: f(*args, cfg["rounds"], BLK,  # noqa: E731
                                   **kw)
            out_k, ok_k = call(fn)
            torch.cuda.synchronize()
            out_p, ok_p = call(fn_plain)
            err = max(max_abs_err(out_k, out_p), max_abs_err(ok_k, ok_p))
            ladder_err[kern] = max(ladder_err[kern], err)
            out_h, ok_h = out_k.cpu().numpy(), ok_k.cpu().numpy()
            whole = all(out_h[k, :len(w)].tobytes() == w
                        for k, w in enumerate(ladder_want) if ok_h[k])
            print(f"[K7] {kern} {cfg} on {len(ladder_pays)} x 64 KB (resolve "
                  f"split {split_max}, rounds <= {round_limit}: up to "
                  f"{int(nf.max())} fragments, depth {int(rd.max())}): vs "
                  f"plain max_abs_err {err} on out and ok; ok set on "
                  f"{int(ok_h.sum())} blocks, each == input: {whole}")
            check(err == 0 and whole, f"{kern} differs from plain or input "
                  f"at {cfg}")
            check(clears is None or bool(ok_h.all()) != clears,
                  f"{kern} at {cfg}: ok is {ok_h.tolist()}")

    ladder_against_plain("frag_decode", tfr.decode_blocks_frags,
                         tfr.decode_blocks_frags_plain, LADDER_FRAGS)
    ladder_against_plain("frag_decode_win", tfr.decode_blocks_frags_win,
                         tfr.decode_blocks_frags_win_plain, LADDER_WIN)
    ladder_against_plain("frag_decode_chase", tfr.decode_blocks_frags_chase,
                         tfr.decode_blocks_frags_chase_plain, LADDER_CHASE)

    # the ladder paths, counted, then timed.  A probe records what each
    # path hands to the three wrappers, so that the kernels can be timed
    # alone at the paths' shapes afterwards.
    class Probe:
        names = {"frag_decode": "decode_blocks_frags",
                 "frag_decode_win": "decode_blocks_frags_win",
                 "frag_decode_chase": "decode_blocks_frags_chase"}

        def __init__(self):
            self.calls, self.tier, self.at = [], [], 0
            #: (fcap, rounds) of the tier of each call
            self.call_tiers, self.cur = [], None

        def __enter__(self):
            self.real = {k: getattr(sh, v) for k, v in self.names.items()}
            self.run_tier = sh.ShardedFrameCodec._run_tier
            for kern, attr in self.names.items():
                setattr(sh, attr, self.recorder(kern))
            probe = self

            def run_tier(codec_, payloads, bs, grp, rows, *a):
                probe.tier, probe.at = [grp[j] for j in rows], 0
                probe.cur = tuple(a[1:3])
                return probe.run_tier(codec_, payloads, bs, grp, rows, *a)
            sh.ShardedFrameCodec._run_tier = run_tier
            return self

        def recorder(self, kern):
            def call(*a, **k):
                nblk = a[0].shape[0]        # the tier's next blocks
                self.calls.append((kern, a, k,
                                   self.tier[self.at:self.at + nblk]))
                self.call_tiers.append(self.cur)
                self.at += nblk
                return self.real[kern](*a, **k)
            return call

        def __exit__(self, *exc):
            for kern, attr in self.names.items():
                setattr(sh, attr, self.real[kern])
            sh.ShardedFrameCodec._run_tier = self.run_tier

    probes, ladder_routes, want_of = {}, {}, {}

    def ladder_path(what, cdc, fr, want, expect, reps=3):
        """``cdc.decompress_frame(fr)``, counted (with the probe on),
        checked and timed; the kernels ``expect`` must have launched and
        decoded blocks."""
        with Probe() as probe:
            got = counted(what, lambda: cdc.decompress_frame(fr), expect)
        check(got == want, f"{what}: the content differs from the input")
        routes, members = dict(cdc.routes), dict(cdc.tier_members)
        by_kernel = {"frag_decode": "frags ", "frag_decode_win": "win",
                     "frag_decode_chase": "chase ", "tmap_gather": "tmap"}
        for kern in expect:
            nblk = sum(v for k, v in routes.items()
                       if k.startswith(by_kernel[kern]))
            check(nblk > 0, f"{what}: {kern} decoded no block ({routes})")
        check(routes.get("leftover", 0) == routes.get("tmap", 0),
              f"{what}: leftovers {routes}")
        t_p = timed(lambda: cdc.decompress_frame(fr), reps)
        print(f"[ladder] {what}: content == input; blocks by route {routes}; "
              f"blocks handed to each tier {members}")
        print(f"[time] {smi}: {what}, median of {reps}: decompress_frame "
              f"{fmt(t_p)} = {len(want) / (t_p[0] / 1e3) / 1e9:.4f} GB/s of "
              f"output")
        probes[what], ladder_routes[what] = probe, routes
        want_of[what] = want
        return probe

    def engine_codec(engine, **kw):
        return ShardedFrameCodec(device="cuda", decode_engine=engine, **kw)

    ladder_path("level-9 frame, mixed", engine_codec("mixed"), frame, data,
                ("frag_decode_win", "frag_decode_chase"))
    ladder_path("level-9 frame, win", engine_codec("win"), frame, data,
                ("frag_decode_win",))
    ladder_path("level-9 frame, chase", engine_codec("chase"), frame, data,
                ("frag_decode_chase",))
    ladder_path("level-0 frame, mixed", engine_codec("mixed"), frame0, data,
                ("frag_decode_chase",))
    # big blocks, frames written by the host frame layer: 256 KB blocks
    # reach the byte-granular decoder (the windowed packs do not cover
    # them); 1 MB blocks the narrow chase tiers, whose budgets of bs/64
    # and bs/256 fragments only a highly compressible block meets
    part256 = data[:16 << 20]
    frame256 = lz4f.compress_frame(part256, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(
            block_size_id=lz4f.BlockSizeID.max256KB,
            block_mode=lz4f.BlockMode.independent, content_checksum=True),
        compression_level=9))
    ladder_path("256 KB blocks, win", engine_codec("win"), frame256, part256,
                ("frag_decode",))
    # (the 40,000 bytes at block 300, database-like records, repeat into
    # about 9,000 fragments a block; text overflows both budgets)
    part1m = (data[300 * BLK:300 * BLK + 40_000] * 420)[:16 << 20]
    frame1m = lz4f.compress_frame(part1m, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(
            block_size_id=lz4f.BlockSizeID.max1MB,
            block_mode=lz4f.BlockMode.independent, content_checksum=True)))
    ladder_path("1 MB blocks, mixed", engine_codec("mixed"), frame1m, part1m,
                ("frag_decode_chase",))
    # a dictionary: LIT sources shifted by its length, PER sources not
    fr_dict = lz4f.compress_frame(part, independent, dictionary=d)
    cdc_dict = engine_codec("chase", dictionary=d)
    check(cdc_dict.decompress_frame(fr_dict) == part
          and sum(cdc_dict.tier_members.values()) > 0,
          "chase decode of the dictionary frame")
    print(f"[dict] independent frame of {len(part)} bytes with a {len(d)}-"
          f"byte dictionary under chase: ok; blocks by route "
          f"{cdc_dict.routes}")

    # each kernel alone at its path's shape: the launch of most blocks,
    # against its plain version, with its bound and with tmap_gather on
    # the same blocks (the other route); then the path by stage
    def ladder_kernel(kern, what, fr, plain_fn, bs):
        probe = probes[what]
        _k, a, kw, blocks = max((c for c in probe.calls if c[0] == kern),
                                key=lambda c: c[1][0].shape[0])
        fn = probe.names[kern]
        k_ms, (out_k, ok_k) = cuda_ms(lambda: getattr(tfr, fn)(*a, **kw), 5)
        p_ms, (out_p, ok_p) = cuda_ms(lambda: plain_fn(*a, **kw))
        err = max(max_abs_err(out_k, out_p), max_abs_err(ok_k, ok_p))
        check(err == 0, f"{kern} differs from plain at the shape of {what}")
        comp_, nf_, ol_ = a[0], a[5], a[6]
        B_, live_ = comp_.shape[0], int(ol_.sum())
        nfr = int(nf_.sum())
        # fetch rows, four table columns up to nfrag, nfrag and out_len
        # in; out and ok out; a binary search and a few steps a byte
        steps = max(int(nf_.max()), 2).bit_length() + 8
        b_ms, b_by = bound(comp_.numel() + 16 * nfr + 8 * B_ + B_ * bs
                           + 4 * B_, live_ * steps)
        # the other route over the same blocks
        recs_f = dict(zip(*frame_payloads(fr, lz4f)))
        pays_b = [recs_f[k] for k in blocks]
        ln = np.array([len(p_) for p_ in pays_b], np.int64)
        of = np.zeros_like(ln)
        of[1:] = np.cumsum(ln)[:-1]
        T_b, ol_b = native.native_resolve_tmap(b"".join(pays_b), of, ln, bs,
                                               reuse_buffers=False)
        f_b = np.zeros((len(pays_b), int(ln.max())), np.uint8)
        for k, p_ in enumerate(pays_b):
            f_b[k, :len(p_)] = np.frombuffer(p_, np.uint8)
        tm_in = [torch.from_numpy(x).to(dev)
                 for x in (f_b, T_b, ol_b.astype(np.int32))]
        td.decode_blocks_tmap(*tm_in)
        tm_ms, out_t = cuda_ms(lambda: td.decode_blocks_tmap(*tm_in), 5)
        okb = ok_k.bool()
        check(bool(okb.any()) and torch.equal(out_k[okb], out_t[okb]),
              f"{kern} differs from tmap_gather on the same blocks")
        staged = sum(t.numel() * t.element_size() for t in a
                     if isinstance(t, torch.Tensor))
        results[kern].update(
            max_abs_err=max(ladder_err[kern], err), ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            tmap_gather_ms=tm_ms, at=what, blocks=B_, block_bytes=bs,
            fragments=nfr, config=dict(kw, args=[int(x) for x in a[7:]]),
            staged_bytes=staged,
            tmap_staged_bytes=int(f_b.nbytes + 4 * ol_b.sum()))
        print(f"[time] {smi}: {kern} at {B_} x {bs} bytes ({what}; {nfr} "
              f"fragments, arguments {list(a[7:])} {kw}): {k_ms:.4f} ms (plain {p_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}, no library call computes it; "
              f"tmap_gather on the same blocks {tm_ms:.4f} ms); staged "
              f"{staged} bytes against {f_b.nbytes + 4 * int(ol_b.sum())} "
              f"of the T-map route")

    ladder_kernel("frag_decode", "256 KB blocks, win", frame256,
                  tfr.decode_blocks_frags_plain, 262144)
    ladder_kernel("frag_decode_win", "level-9 frame, win", frame,
                  tfr.decode_blocks_frags_win_plain, BLK)
    ladder_kernel("frag_decode_chase", "level-9 frame, chase", frame,
                  tfr.decode_blocks_frags_chase_plain, BLK)
    # the chase by phase (cuts of frag_decode.cu, the cluster route), its
    # rounds and launch shape at that launch; then both routes against
    # plain at every chase configuration on 256 KB (a cluster of 8) and
    # 1 MB blocks (device scratch)
    t_k7 = time.perf_counter()
    _k, a_c, kw_c, _b = max((c for c in probes["level-9 frame, chase"].calls
                             if c[0] == "frag_decode_chase"),
                            key=lambda c: c[1][0].shape[0])
    r_c = torch.zeros(a_c[0].shape[0], dtype=torch.int32, device=dev)
    got_c = tfr.decode_blocks_frags_chase(*a_c, **kw_c, rounds=r_c)
    want_c = tfr.decode_blocks_frags_chase(*a_c, **kw_c)
    check(all(torch.equal(x, y) for x, y in zip(got_c, want_c)),
          "frag_decode_chase with its rounds differs")
    r_h = r_c.cpu().numpy()
    dense_r, front_r = r_h & 0xFFFF, r_h >> 16
    chase_phases = by_phase(CHASE_PHASES,
                            chase_phase_split(phase_libs, a_c, kw_c),
                            results["frag_decode_chase"]["ms"])
    chase_shape = {bs_: tfr.chase_launch_shape(bs_)
                   for bs_ in (BLK, 262144, 1 << 20)}
    check(all(v["active_clusters"] > 0 for v in chase_shape.values()
              if v["ctas"]), f"the chase's cluster {chase_shape}")
    route_err = {}
    for what, fr_r, bs_ in (("256 KB blocks", frame256, 262144),
                            ("1 MB blocks", frame1m, 1 << 20)):
        pays_r = frame_payloads(fr_r, lz4f)[1]
        args_r, _rd, nf_r = ladder_tables(pays_r, *LADDER_CHASE[0],
                                          fcap=bs_, bs=bs_)
        for cfg in LADDER_CHASE[1]:
            cfg = {k: v for k, v in cfg.items() if k != "clears"}
            got_r = tfr.decode_blocks_frags_chase(*args_r, bs_, **cfg)
            want_r = tfr.decode_blocks_frags_chase_plain(*args_r, bs_, **cfg)
            err_r = max(max_abs_err(x, y) for x, y in zip(got_r, want_r))
            route_err[f"{what}, {cfg}"] = err_r
            check(err_r == 0, f"frag_decode_chase differs from plain on "
                  f"{what} at {cfg}")
        del args_r
    print(f"[K7] frag_decode_chase vs plain at every chase configuration "
          f"on 256 KB blocks (a cluster of 8) and 1 MB blocks (device "
          f"scratch): max_abs_err {route_err}; launch shape by block bytes "
          f"(CTAs a cluster, 0 = device scratch; threads and shared bytes "
          f"a CTA; clusters the card holds at once): {chase_shape} (these "
          f"checks and the phase cuts {time.perf_counter() - t_k7:.1f} s)")
    print(f"[time] {smi}: frag_decode_chase at {a_c[0].shape[0]} x 64 KB "
          "(level-9 frame, chase) by phase (cuts of frag_decode.cu, "
          "-DZL4_STOP=1..3): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in chase_phases.items())
          + f"; whole {results['frag_decode_chase']['ms']:.4f} ms; rounds "
          f"a block: dense max {int(dense_r.max())} mean "
          f"{float(dense_r.mean()):.4f}, frontier max {int(front_r.max())} "
          f"mean {float(front_r.mean()):.4f}")
    results["frag_decode_chase"].update(
        phase_ms=chase_phases, dense_rounds_max=int(dense_r.max()),
        dense_rounds_mean=float(dense_r.mean()),
        frontier_rounds_max=int(front_r.max()),
        frontier_rounds_mean=float(front_r.mean()),
        launch_shape=chase_shape, routes_max_abs_err=route_err,
        max_abs_err=max(results["frag_decode_chase"]["max_abs_err"],
                        *route_err.values()))
    del got_c, want_c, r_c

    # the windowed decoder at both launches of the level-9 "win" path, by
    # phase at the largest (cuts of frag_decode.cu, the cluster route), its
    # launch shape, and both routes against plain at every windowed
    # configuration on 256 KB blocks (a cluster of 8) and on 512 KB rows
    # (device scratch)
    t_k7b = time.perf_counter()
    win_calls = [c for c in probes["level-9 frame, win"].calls
                 if c[0] == "frag_decode_win"]
    win_ms = []
    for _k, a_w, kw_w, _b in win_calls:
        ms_w, _ = cuda_ms(lambda: tfr.decode_blocks_frags_win(*a_w, **kw_w),
                          5)
        win_ms.append(dict(blocks=int(a_w[0].shape[0]), g=kw_w.get("g", 8),
                           args=[int(x) for x in a_w[7:]], ms=ms_w))
    _k, a_w, kw_w, _b = max(win_calls, key=lambda c: c[1][0].shape[0])
    win_cuts = win_phase_split(phase_libs, a_w, kw_w)
    win_raw = win_cuts.pop("whole")
    win_phases = by_phase(WIN_PHASES, win_cuts, win_raw)
    win_shape = {f"{bs_} g{g_}": tfr.win_launch_shape(bs_, g_)
                 for bs_ in (BLK, 2 * BLK, 262080, 1 << 19) for g_ in (8, 16)}
    check(all(v["active_clusters"] > 0 for v in win_shape.values()
              if v["ctas"]), f"the windowed decoder's cluster {win_shape}")
    win_route_err = {}
    for bs_ in (262144, 1 << 19):
        args_r, _rd, _nf = ladder_tables(frame_payloads(frame256, lz4f)[1],
                                         *LADDER_WIN[0], fcap=bs_, bs=bs_)
        for cfg in LADDER_WIN[1]:
            cfg = {k: v for k, v in cfg.items() if k != "clears"}
            kw_r = {k: v for k, v in cfg.items() if k != "rounds"}
            got_r = tfr.decode_blocks_frags_win(*args_r, cfg["rounds"], bs_,
                                                **kw_r)
            want_r = tfr.decode_blocks_frags_win_plain(*args_r,
                                                       cfg["rounds"], bs_,
                                                       **kw_r)
            err_r = max(max_abs_err(x, y) for x, y in zip(got_r, want_r))
            win_route_err[f"{bs_}, {cfg}"] = err_r
            check(err_r == 0, f"frag_decode_win differs from plain at "
                  f"{bs_}-byte rows at {cfg}")
        del args_r
    print(f"[K7] frag_decode_win vs plain at every windowed configuration on "
          f"the 256 KB frame's blocks at 262,144-byte rows (a cluster of 8) "
          f"and 524,288 (device scratch): max_abs_err {win_route_err}; "
          f"launch shape by block bytes and g (CTAs a cluster, 0 = device "
          f"scratch; threads and shared bytes a CTA; clusters the card "
          f"holds at once): {win_shape} (these checks and the phase cuts "
          f"{time.perf_counter() - t_k7b:.1f} s)")
    print(f"[time] {smi}: frag_decode_win at each launch of the level-9 "
          f"frame's win path: {win_ms}; at {a_w[0].shape[0]} x 64 KB by "
          "phase (cuts of frag_decode.cu, -DZL4_STOP=1..3): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in win_phases.items())
          + f"; the kernel alone {win_raw:.4f} ms, with its wrapper "
          f"{results['frag_decode_win']['ms']:.4f} ms")
    results["frag_decode_win"].update(
        kernel_ms=win_raw, phase_ms=win_phases, launches_ms=win_ms,
        launch_shape=win_shape, routes_max_abs_err=win_route_err,
        max_abs_err=max(results["frag_decode_win"]["max_abs_err"],
                        *win_route_err.values()))

    # the byte-granular decoder at the 256 KB "win" path's launch by phase
    # (cuts of frag_decode.cu, the cluster route), its launch shape, and
    # both routes against plain at every byte-granular configuration on
    # the 256 KB frame's blocks at 262,144-byte rows (a cluster of 8) and
    # 524,288 (device scratch)
    t_k7a = time.perf_counter()
    _k, a_f, kw_f, _b = max((c for c in probes["256 KB blocks, win"].calls
                             if c[0] == "frag_decode"),
                            key=lambda c: c[1][0].shape[0])
    frag_cuts = frag_phase_split(phase_libs, a_f, kw_f)
    frag_raw = frag_cuts.pop("whole")
    frag_by_rounds = {k[1]: frag_cuts.pop(k) for k in list(frag_cuts)
                      if isinstance(k, tuple)}
    frag_by_rounds[int(a_f[7])] = frag_raw
    frag_phases = by_phase(FRAG_PHASES, frag_cuts, frag_raw)
    # where the PER bytes' sources lie: in the byte's own CTA or another
    T_f, per_f, live_f = tfr._sources(*a_f[:7], int(a_f[8]))
    per_f &= live_f
    j_f = torch.arange(int(a_f[8]), device=dev)
    per_n = int(per_f.sum())
    per_remote = int((per_f & ((T_f >> 15) != (j_f >> 15))).sum())
    del T_f, per_f, live_f
    frag_shape = {bs_: tfr.frag_launch_shape(bs_)
                  for bs_ in (BLK, 2 * BLK, 262144, 1 << 19)}
    check(all(v["active_clusters"] > 0 for v in frag_shape.values()
              if v["ctas"]) and frag_shape[262144]["ctas"] == 8,
          f"the byte-granular decoder's cluster {frag_shape}")
    frag_route_err = {}
    for bs_ in (262144, 1 << 19):
        args_r, _rd, _nf = ladder_tables(frame_payloads(frame256, lz4f)[1],
                                         *LADDER_FRAGS[0], fcap=bs_, bs=bs_)
        for cfg in LADDER_FRAGS[1]:
            cfg = dict(cfg)
            clears = cfg.pop("clears", None)
            got_r = tfr.decode_blocks_frags(*args_r, cfg["rounds"], bs_)
            want_r = tfr.decode_blocks_frags_plain(*args_r, cfg["rounds"],
                                                   bs_)
            err_r = max(max_abs_err(x, y) for x, y in zip(got_r, want_r))
            frag_route_err[f"{bs_}, {cfg}"] = err_r
            check(err_r == 0, f"frag_decode differs from plain at "
                  f"{bs_}-byte rows at {cfg}")
            check(clears is None or not bool(got_r[1].all()),
                  f"frag_decode at {bs_}-byte rows at {cfg}: ok is "
                  f"{got_r[1].tolist()}")
        del args_r
    print(f"[K7] frag_decode vs plain at every byte-granular configuration "
          f"on the 256 KB frame's blocks at 262,144-byte rows (a cluster of "
          f"8) and 524,288 (device scratch): max_abs_err {frag_route_err}; "
          f"launch shape by block bytes (CTAs a cluster, 0 = device "
          f"scratch; threads and shared bytes a CTA; clusters the card "
          f"holds at once): {frag_shape} (these checks and the phase cuts "
          f"{time.perf_counter() - t_k7a:.1f} s)")
    print(f"[time] {smi}: frag_decode at {a_f[0].shape[0]} x "
          f"{int(a_f[8])} bytes (256 KB blocks, win) by phase (cuts of "
          "frag_decode.cu, -DZL4_STOP=1..2): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in frag_phases.items())
          + f"; the kernel alone {frag_raw:.4f} ms, with its wrapper "
          f"{results['frag_decode']['ms']:.4f} ms; the kernel alone by "
          f"rounds: {frag_by_rounds}; {per_n} PER bytes of "
          f"{int(a_f[6].sum())} live, {per_remote} of them with a source "
          f"in another CTA")
    results["frag_decode"].update(
        kernel_ms=frag_raw, phase_ms=frag_phases, launch_shape=frag_shape,
        kernel_ms_by_rounds=frag_by_rounds, per_bytes=per_n,
        per_bytes_remote=per_remote,
        routes_max_abs_err=frag_route_err,
        max_abs_err=max(results["frag_decode"]["max_abs_err"],
                        *frag_route_err.values()))

    def ladder_stages(what, cdc, fr, bs):
        """The path by stage: the host resolve as the path makes it, the
        staging of what it staged, every ladder launch again."""
        probe = probes[what]
        _idx, recs_f = frame_payloads(fr, lz4f)
        ln = np.array([len(p_) for p_ in recs_f], np.int64)
        of = np.zeros_like(ln)
        of[1:] = np.cumsum(ln)[:-1]
        tiers_f, rmax_f = cdc._ladder_tiers(bs)
        fcap_hi = max(f for f, _r, _q in tiers_f)
        group = max(sh._FRAG_TABLE_BYTES // (20 * fcap_hi), 1)
        concat_f = b"".join(recs_f)
        t0_ = time.perf_counter()
        for g0 in range(0, len(recs_f), group):
            native.native_resolve_blocks(
                concat_f, of[g0:g0 + group], ln[g0:g0 + group], fcap_hi,
                out_cap=bs, split_max=sh._FRAG_SPLIT_MAX,
                round_limit=rmax_f)
        t_res_f = (time.perf_counter() - t0_) * 1e3
        host = [[t.cpu() for t in a if isinstance(t, torch.Tensor)]
                for _k, a, _kw, _b in probe.calls]
        nbytes = sum(t.numel() * t.element_size() for h in host for t in h)
        t_stage_f, _ = cuda_ms(lambda: [[t.to(dev) for t in h]
                                        for h in host])
        t_kern, _ = cuda_ms(lambda: [
            getattr(tfr, probe.names[k])(*a, **kw)
            for k, a, kw, _b in probe.calls])
        decoded = sum(int(a[6][probe.real[k](*a, **kw)[1].bool()].sum())
                      for k, a, kw, _b in probe.calls)
        left = ladder_routes[what].get("leftover", 0)
        # what T-map stages for every compressed block of the frame: 4
        # bytes of T an output byte and the payload rows
        out_f = len(want_of[what]) - bs * ladder_routes[what].get("stored",
                                                                  0)
        tmap_f = 4 * out_f + len(recs_f) * int(ln.max())
        print(f"[time] {smi}: {what} by stage: host resolve (fcap "
              f"{fcap_hi}, {-(-len(recs_f) // group)} groups) "
              f"{t_res_f:.2f} ms, staging {t_stage_f:.2f} ms ({nbytes} "
              f"bytes, pageable), {len(probe.calls)} ladder launches "
              f"{t_kern:.3f} ms -> {decoded} bytes decoded = "
              f"{nbytes / max(decoded, 1):.4f} staged bytes per output byte "
              f"(T-map over the frame's {len(recs_f)} compressed blocks: "
              f"{tmap_f} bytes = {tmap_f / out_f:.4f} per output byte); "
              f"{left} blocks left to T-map")

    ladder_stages("level-9 frame, mixed", engine_codec("mixed"), frame, BLK)
    ladder_stages("level-9 frame, win", engine_codec("win"), frame, BLK)
    ladder_stages("level-9 frame, chase", engine_codec("chase"), frame, BLK)
    ladder_stages("level-0 frame, mixed", engine_codec("mixed"), frame0, BLK)
    ladder_stages("256 KB blocks, win", engine_codec("win"), frame256, 262144)
    probes.clear()

    # --- phase 7c: P2, the bitonic probe: bitonic_sort2 at 1 and 64 rows
    # of 65,536 keys, counted, against its plain version and torch.sort
    from zig_lz4_tpu_torch.probes import sort_probe as sp
    gen = torch.Generator().manual_seed(80)
    sort_in = {}
    for B_s in SORT_BATCHES:
        keys_s = torch.randint(0, 1 << 30, (B_s, sp.N), generator=gen,
                               dtype=torch.int32)
        keys_s[:, ::3] = keys_s[:, :1]          # ties keep their pairs
        sort_in[B_s] = (keys_s.to(dev), torch.arange(
            sp.N, dtype=torch.int32).repeat(B_s, 1).to(dev))
    sorted_s = counted("bitonic probe, 1 and 64 rows", lambda: {
        B_s: sp.bitonic_sort2(*a) for B_s, a in sort_in.items()},
        ("bitonic_sort2",))
    err_sort = 0
    for B_s, (ko, vo) in sorted_s.items():
        kp, vp = sp.bitonic_sort2_plain(*sort_in[B_s])
        kl, _vl = sp.library_sort2(*sort_in[B_s])
        err_sort = max(err_sort, max_abs_err(ko, kp), max_abs_err(vo, vp),
                       max_abs_err(ko, kl))
        check(torch.equal(torch.gather(sort_in[B_s][0], 1, vo.long()), ko),
              "P2 payload is not the keys' permutation")
    check(err_sort == 0, "P2 differs from plain or from torch.sort's keys")
    sort_ms, shapes = {}, {}
    for B_s, a in sort_in.items():
        shapes[B_s] = sp.cluster_shape(B_s, sp.N)
        check(shapes[B_s]["cluster"] >= 2
              and shapes[B_s]["max_active_clusters"] > 0,
              f"bitonic_sort2's launch shape {shapes[B_s]} at {B_s} rows")
        # outputs made ahead, for the graphs
        ko_, vo_, ks_, vs_ = (torch.empty_like(a[0]) for _ in range(4))
        idx_ = torch.empty(a[0].shape, dtype=torch.long, device=dev)

        def k_sort():
            launch("bitonic_sort2", a[0], a[1], ko_, vo_, B_s, sp.N)

        def lib_sort():
            torch.sort(a[0], dim=-1, out=(ks_, idx_))
            torch.gather(a[1], 1, idx_, out=vs_)
        sp.library_sort2(*a)
        sort_ms[B_s] = dict(
            ms=cuda_ms(lambda: sp.bitonic_sort2(*a), 20)[0],
            device_ms=graph_ms(k_sort),
            plain_ms=cuda_ms(lambda: sp.bitonic_sort2_plain(*a), 2)[0],
            library_ms=cuda_ms(lambda: sp.library_sort2(*a), 20)[0],
            library_device_ms=graph_ms(lib_sort))
        check(torch.equal(ko_, sorted_s[B_s][0])
              and torch.equal(vo_, sorted_s[B_s][1])
              and torch.equal(ks_, sorted_s[B_s][0]),
              "P2 replayed from a graph differs")
    B_s = max(SORT_BATCHES)
    # 16 bytes a pair in and out; 136 stages of N/2 compare-exchanges of a
    # compare and two selects
    b_sort = bound(16 * B_s * sp.N, 3 * 136 * (sp.N // 2) * B_s)
    results["bitonic_sort2"].update(
        max_abs_err=err_sort, bound_ms=b_sort[0], bound_by=b_sort[1],
        rows=B_s, **sort_ms[B_s],
        **{f"{key}_by_rows": {b: v[key] for b, v in sort_ms.items()}
           for key in ("ms", "device_ms", "library_ms",
                       "library_device_ms")},
        shape_by_rows=shapes)
    print(f"[P2] bitonic_sort2 vs plain and vs torch.sort's keys max_abs_err "
          f"{err_sort} at {list(SORT_BATCHES)} rows of {sp.N}; launch shape "
          f"by rows (CTAs a cluster, threads and shared bytes a CTA, "
          f"clusters the card holds at once): {shapes}")
    for B_s, t_ in sort_ms.items():
        print(f"[time] {smi}: bitonic_sort2 at {B_s} x {sp.N} int32 pairs: "
              f"device {t_['device_ms']:.4f} ms, launch {t_['ms']:.4f} ms "
              f"(plain {t_['plain_ms']:.2f} ms; torch.sort with the payload "
              f"gathered: device {t_['library_device_ms']:.4f} ms, launch "
              f"{t_['library_ms']:.4f} ms)"
              + (f"; bound {b_sort[0]:.5f} ms by {b_sort[1]}"
                 if B_s == max(SORT_BATCHES) else ""))
    del sort_in, sorted_s

    # --- phase 7d: the user surfaces over the corpus: the CLI, a mesh of
    # two shards on the card, two gloo processes, the single-block
    # factories and the entry points with their dryrun
    from zig_lz4_tpu_torch import cli
    from zig_lz4_tpu_torch import entry as pe
    from zig_lz4_tpu_torch.parallel import blocks_mesh
    from zig_lz4_tpu_torch.parallel.multihost import MultiHostFrameCodec
    t_surf = time.perf_counter()
    #: kernel -> max_abs_err against plain at this phase's new geometries,
    #: folded into the kernels' line
    extra_err = {}
    #: path -> its deep and wide encoder launches ((windows, lens,
    #: starts), keywords), timed alone in phase 9 with the others
    surface_rec = {}
    ladder_kernels = ("frag_decode", "frag_decode_win", "frag_decode_chase")
    surface = {}
    with tempfile.TemporaryDirectory(prefix="zl4_smoke_") as tmpd:
        src = os.path.join(tmpd, "corpus.bin")
        with open(src, "wb") as f:
            f.write(data)

        def run_cli(path, args, expect):
            """``cli.main(args)`` as a counted path: (seconds, rc)."""
            t_ = time.perf_counter()
            rc = counted(path, lambda: cli.main(args), expect)
            return time.perf_counter() - t_, rc

        cli_frames = {}
        for flag, expect in CLI_ENCODES.items():
            dst = os.path.join(tmpd, f"corpus{flag}.lz4")
            with EncodeRecorder(sh) as rec_c:
                t_c, rc = run_cli(f"cli {flag} --engine cuda",
                                  [flag, "-f", "-q", "--engine", "cuda", src,
                                   dst], expect)
            surface_rec[f"cli {flag}"] = [
                c for c in rec_c.calls
                if c[1].get("deep") or c[0][0].shape[1] > BLK]
            with open(dst, "rb") as f:
                fr_c = f.read()
            check(rc == 0 and lz4f.decompress_frame(fr_c) == data,
                  f"cli {flag}: rc {rc}, or the host frame layer's decode "
                  "of its frame differs from the input")
            cli_frames[flag] = dst
            surface[f"cli {flag} compress MB/s"] = n / t_c / 1e6
            print(f"[cli] {smi}: {flag} --engine cuda: {n} -> {len(fr_c)} "
                  f"bytes in {t_c:.3f} s = {n / t_c / 1e6:.1f} MB/s (file "
                  "read and write, checksum and frame inside); host frame "
                  "layer decode ok")
            same = {"-1": frame0, "-9": frame, "-12": deep_frames[12]}
            check(flag not in same or fr_c == same[flag],
                  f"cli {flag}: the frame differs from ShardedFrameCodec's")
        for flag, dst in cli_frames.items():
            for eng in ("mixed", "win", "chase"):
                back_c = os.path.join(tmpd, "back.bin")
                what = f"cli -d of the {flag} frame, {eng}"
                t_d, rc = run_cli(what, ["-d", "-f", "-q", "--engine", "cuda",
                                         "--decode-engine", eng, dst,
                                         back_c], ())
                with open(back_c, "rb") as f:
                    check(rc == 0 and f.read() == data,
                          f"{what}: rc {rc} or the output differs")
                check(any(paths[what][k] for k in ladder_kernels),
                      f"{what}: no ladder kernel launched: {paths[what]}")
                surface[f"{what} MB/s"] = n / t_d / 1e6
                print(f"[cli] {smi}: {what}: {t_d:.3f} s = "
                      f"{n / t_d / 1e6:.1f} MB/s of output")
        linked_c = os.path.join(tmpd, "linked.lz4")
        back_c = os.path.join(tmpd, "back.bin")
        t_h, rc = run_cli("cli -BD host", ["-BD", "-f", "-q", src, linked_c],
                          ())
        check(rc == 0, "cli -BD with the host engine")
        t_l, rc = run_cli("cli -d of a host -BD frame", [
            "-d", "-f", "-q", "--engine", "cuda", linked_c, back_c],
            ("linked_tmap_step",))
        with open(back_c, "rb") as f:
            check(rc == 0 and f.read() == data,
                  "cli -d of the host -BD frame differs from the input")
        print(f"[cli] {smi}: -BD frame by the host engine {t_h:.3f} s; "
              f"decoded with --engine cuda in {t_l:.3f} s = "
              f"{n / t_l / 1e6:.1f} MB/s")
        t_p = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "zig_lz4_tpu_torch.cli", "-c", "-q",
             "--engine", "cuda", "-1", src], capture_output=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        t_p = time.perf_counter() - t_p
        with open(cli_frames["-1"], "rb") as f:
            check(child.returncode == 0 and child.stdout == f.read(),
                  "python -m zig_lz4_tpu_torch.cli -c: "
                  f"{child.stderr.decode()[-2000:]}")
        print(f"[cli] python -m zig_lz4_tpu_torch.cli -c -q --engine cuda -1: "
              f"the in-process frame on stdout in {t_p:.1f} s (process start "
              "included)")

        # the mesh: two shards a batch on the one card
        mesh2 = blocks_mesh(devices=["cuda:0"] * 2)
        cm = ShardedFrameCodec(mesh=mesh2, compression_level=9)
        fr_m = counted("mesh x2, level 9 compress",
                       lambda: cm.compress_frame(data),
                       ("enc_match", "enc_parse_emit"))
        check(fr_m == frame, "the mesh's frame differs from one device's")
        deep_tier = (BLK, 12)
        for eng, plain_of in (
                ("mixed", {"frag_decode_chase":
                           tfr.decode_blocks_frags_chase_plain}),
                ("win", {"frag_decode_win":
                         tfr.decode_blocks_frags_win_plain})):
            cme = ShardedFrameCodec(mesh=mesh2, compression_level=9,
                                    decode_engine=eng)
            what = f"mesh x2, level-9 frame, {eng}"
            with Probe() as probe:
                back_m = counted(what, lambda: cme.decompress_frame(frame),
                                 tuple(plain_of))
            check(back_m == data, f"{what}: the content differs")
            deep = {k: v for k, v in cme.routes.items() if "rounds=12" in k}
            check(sum(deep.values()) > 0,
                  f"{what}: the deep tier took no block: {cme.routes}")
            calls = [c for c, t in zip(probe.calls, probe.call_tiers)
                     if t == deep_tier]
            err_d, n_d = 0, 0
            for kern, a, kw, _blk in calls:
                out_k, ok_k = getattr(tfr, probe.names[kern])(*a, **kw)
                out_p, ok_p = plain_of[kern](*a, **kw)
                err_d = max(err_d, max_abs_err(out_k, out_p),
                            max_abs_err(ok_k, ok_p))
                n_d += a[0].shape[0]
                extra_err[kern] = max(extra_err.get(kern, 0), err_d)
            check(calls and err_d == 0, f"{what}: the deep tier's "
                  f"launches differ from plain (max_abs_err {err_d})")
            t_m = timed(lambda: cme.decompress_frame(frame), 3)
            surface[f"{what} ms"] = t_m
            print(f"[mesh] {smi}: {what}: content == input; blocks by route "
                  f"{cme.routes}; handed to each tier {cme.tier_members}; "
                  f"deep tier (fcap {BLK}, 12 rounds): {len(calls)} launches "
                  f"over {n_d} blocks vs plain max_abs_err {err_d}; "
                  f"decompress_frame, median of 3: {fmt(t_m)}")

        # two gloo processes on localhost, both on cuda:0: given the
        # coordinator and their ranks, then started by torchrun and
        # joining from its environment
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{sk.getsockname()[1]}"
        here = os.path.abspath(__file__)
        t_mh = time.perf_counter()
        told = launch_ranks([[sys.executable, here, MULTIHOST_FLAG, coord,
                              str(r), src] for r in (0, 1)], 300)
        t_mh = time.perf_counter() - t_mh
        t_tr = time.perf_counter()
        told_tr = launch_ranks([[
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nnodes=1", "--nproc_per_node=2", here, MULTIHOST_FLAG, "env",
            src]], 300)
        t_tr = time.perf_counter() - t_tr
    mh1 = MultiHostFrameCodec()
    fr_1 = counted("multi-host, one process",
                   lambda: mh1.compress_corpus(data, content_hash=True),
                   ("enc_match_fast", "enc_parse_emit"))
    sha_1 = hashlib.sha256(fr_1).hexdigest()
    check(mh1.decompress_corpus(fr_1) == data
          and lz4f.decompress_frame(fr_1) == data,
          "the one-process multi-host frame does not round-trip")
    for how, ranks, wall, key in (
            ("given the coordinator and ranks", told, t_mh, ""),
            ("started by torchrun", told_tr, t_tr, " torchrun")):
        check([t_["rank"] for t_ in ranks] == [0, 1],
              f"{how}: ranks {[t_['rank'] for t_ in ranks]} answered")
        check(all(t_["sha256"] == sha_1 and t_["roundtrip"] for t_ in ranks),
              f"{how}: the ranks' frames differ from the one-process "
              f"frame: {ranks}")
        for t_ in ranks:
            check(all(t_["launches"][k] > 0 for k in (
                "enc_match_fast", "enc_parse_emit", "frag_decode_win")),
                f"{how}: rank {t_['rank']} launched {t_['launches']}")
        surface[f"multi-host two processes{key} s"] = wall
        print(f"[multihost] {smi}: two gloo processes on cuda:0, {how}, "
              f"{n} bytes: both ranks wrote the one-process frame "
              f"({len(fr_1)} bytes) and decoded it; wall {wall:.1f} s "
              "(process start included); by rank "
              + "; ".join(f"{t_['rank']}: start {t_['start_s']:.1f} s, "
                          f"compress {t_['compress_s']:.3f} s, decompress "
                          f"{t_['decompress_s']:.3f} s, launches "
                          + ", ".join(f"{k} {t_['launches'][k]}" for k in (
                              "enc_match_fast", "enc_parse_emit",
                              "frag_decode_win", "tmap_gather"))
                          for t_ in ranks))

    # the single-block factories at 64 KB, against the frames' payloads
    both = sorted(set.intersection(*(set(frame_payloads(f_, lz4f)[0])
                                     for f_ in (frame, frame0,
                                                deep_frames[12]))))
    k_f = both[len(both) // 2]
    w_f = np.frombuffer(data[k_f * BLK:(k_f + 1) * BLK], np.uint8).copy()
    for level, fr_f, expect in ((0, frame0, ("enc_match_fast",)),
                                (9, frame, ("enc_match",)),
                                (12, deep_frames[12], DEEP_KERNELS)):
        enc = tb.make_block_encoder(BLK, *tb.level_params(level))
        dec = td.make_block_decoder(BLK)

        def factory_path():
            out_f, n_f = enc(w_f, BLK)
            comp_f = out_f[:int(n_f)].cpu().numpy().tobytes()
            seqs = td.parse_sequences(comp_f)
            got, m_f = dec(comp_f, *td.seqs_to_arrays(seqs,
                                                     td.MAX_SEQS(BLK)))
            return comp_f, got[:int(m_f)].cpu().numpy().tobytes()
        with EncodeRecorder(tb) as rec_f:
            comp_f, back_f = counted(f"factories, level {level}",
                                     factory_path, expect + ("seq_decode",))
        surface_rec[f"factories, level {level}"] = [
            c for c in rec_f.calls if c[1].get("deep")]
        want_f = dict(zip(*frame_payloads(fr_f, lz4f)))[k_f]
        check(comp_f == want_f and back_f == w_f.tobytes(),
              f"the level-{level} factories differ from the frame codec")
    print(f"[factories] make_block_encoder at levels 0, 9, 12 and "
          f"make_block_decoder on corpus block {k_f} (64 KB): the frame "
          "codec's payloads, decoded to the block")

    # the entry step, then its dryrun over two shards on the card; the
    # dryrun's launches recorded and held against their plain versions
    fn_e, args_e = pe.entry()
    out_e, olen_e = counted("entry()", lambda: fn_e(*args_e),
                            ("enc_match_fast", "enc_parse_emit"))
    out_ep, olen_ep = tb.encode_blocks_plain(*args_e, hc=0)
    check(max_abs_err(out_e, out_ep) == 0
          and torch.equal(olen_e.cpu(), olen_ep.cpu()),
          "entry() differs from the plain encoder")
    rec = {"enc": [], "dec": []}
    real_enc, real_dec = pe.encode_blocks, pe.decode_blocks_frags

    def rec_enc(*a, **k):
        rec["enc"].append((a, k))
        return real_enc(*a, **k)

    def rec_dec(*a):
        rec["dec"].append(a)
        return real_dec(*a)
    pe.encode_blocks, pe.decode_blocks_frags = rec_enc, rec_dec
    try:
        counted("dryrun_multichip(2)",
                lambda: pe.dryrun_multichip(2, devices=["cuda:0"] * 2),
                DEEP_KERNELS + ("enc_match_fast", "enc_parse_emit",
                                "frag_decode"))
    finally:
        pe.encode_blocks, pe.decode_blocks_frags = real_enc, real_dec
    err_e = {"enc_deep_match": 0, "enc_deep_dp": 0, "enc_deep_emit": 0,
             "frag_decode": 0}
    surface_rec["dryrun_multichip(2)"] = [c for c in rec["enc"]
                                          if c[1].get("deep")]
    for (w_e, l_e, s_e), kw in surface_rec["dryrun_multichip(2)"]:
        hc_e, deep_e = kw["hc"], kw["deep"]
        pk = tb.match_candidates(w_e, l_e, hc_e, 1, deep_e)
        err_e["enc_deep_match"] = max(err_e["enc_deep_match"], max_abs_err(
            pk, tb.match_candidates_plain(w_e, l_e, hc_e, 1, deep_e)))
        st = tb.deep_dp(l_e, s_e, pk, deep_e)
        err_e["enc_deep_dp"] = max(err_e["enc_deep_dp"], max_abs_err(
            st, tb.deep_dp_plain(l_e, s_e, pk, deep_e)))
        o_k, n_k = tb.deep_emit(w_e, l_e, s_e, pk, st)
        o_p, n_p = tb.deep_emit_plain(w_e, l_e, s_e, pk, st)
        err_e["enc_deep_emit"] = max(err_e["enc_deep_emit"],
                                     max_abs_err(o_k, o_p),
                                     max_abs_err(n_k, n_p))
    shapes_e = []
    for a in rec["dec"]:
        o_k, ok_k = tfr.decode_blocks_frags(*a)
        o_p, ok_p = tfr.decode_blocks_frags_plain(*a)
        err_e["frag_decode"] = max(err_e["frag_decode"], max_abs_err(o_k, o_p),
                                   max_abs_err(ok_k, ok_p))
        shapes_e.append((a[0].shape[0], a[8], a[7], a[1].shape[1]))
    check(not any(err_e.values()) and len(rec["dec"]) == 4,
          f"the dryrun's kernels differ from plain: {err_e}")
    for k, v in err_e.items():
        extra_err[k] = max(extra_err.get(k, 0), v)
    print(f"[entry] entry(): out {tuple(out_e.shape)}, out_len "
          f"{olen_e.tolist()} == plain; dryrun_multichip(2) on cuda:0 x 2 "
          f"ok; its deep encodes (1,280-byte windows behind 256 bytes, hc 8, "
          f"deep 1) and fragment decodes (blocks, blk, rounds, columns "
          f"{shapes_e}) vs plain max_abs_err {err_e}")
    surface["entry and dryrun errors"] = err_e
    print(f"[surfaces] {json.dumps(surface)} "
          f"({time.perf_counter() - t_surf:.1f} s for the phase)")
    # what the phase staged goes before the kernels are timed alone
    del probe, calls, rec, out_e, out_ep, a, o_k, o_p, ok_k, ok_p
    gc.collect()

    # --- phase 8: launch counts over the paths
    print(f"[launches] all paths: {counts}")
    check(all(counts[k] > 0 for k in KERNELS),
          "a kernel was not launched on any path: "
          + ", ".join(k for k in KERNELS if not counts[k]))

    # --- phase 9: kernels alone at the paths' shapes, each against its
    # plain version on the same inputs, with its bound
    cap = out4.shape[1]
    tb.match_candidates(w_all, l_all)
    k_match, pk_all = cuda_ms(lambda: tb.match_candidates(w_all, l_all), 2)
    tb.parse_emit(w_all, l_all, s_all, pk_all)
    k_emit, (out_all, olen_all) = cuda_ms(
        lambda: tb.parse_emit(w_all, l_all, s_all, pk_all), 2)
    k_match4, pk4 = cuda_ms(lambda: tb.match_candidates(w_all, l_all, 4), 2)
    tb.match_candidates(w_all, l_all, 0)
    k_fast, pk_fast = cuda_ms(lambda: tb.match_candidates(w_all, l_all, 0), 2)
    # the other accelerations: timed at the path's shape, against plain on
    # every PLAIN_STRIDE-th window
    fast_ms, fast_err = {1: k_fast}, {}
    for accel in (2, 4, 8):
        tb.match_candidates(w_all, l_all, 0, accel)
        fast_ms[accel], pk_a = cuda_ms(
            lambda: tb.match_candidates(w_all, l_all, 0, accel), 2)
        fast_err[accel] = max_abs_err(
            pk_a[sel], tb.match_candidates_plain(w_sel, l_sel, 0, accel))
    del pk_a
    print(f"[K3] enc_match_fast at accelerations 2, 4, 8 vs plain on "
          f"{int(sel.numel())} x 64 KB windows: max_abs_err {fast_err}")
    check(not any(fast_err.values()),
          "enc_match_fast differs from plain at an acceleration")
    tb.parse_emit(w_all, l_all, s_all, pk_fast, 0)
    k_emit0, (out_f, olen_f) = cuda_ms(
        lambda: tb.parse_emit(w_all, l_all, s_all, pk_fast, 0), 2)
    # the two redesigned kernels phase by phase, on the same inputs: each
    # ZL4_STOP cut of encode_block.cu against the whole kernel
    cut_m, cut_e, cut_f, cut_order, cut_s0 = phase_split(
        phase_libs, w_all, l_all, s_all, pk_all, 9, 4 + 4 * 8)
    match_phases = dict(zip(
        ("window load", "12-byte sort", "probes +-9", "s0 sort",
         "fallback probes"),
        [cut_m[1], cut_m[2] - cut_m[1], cut_m[3] - cut_m[2],
         cut_m[4] - cut_m[3], k_match - cut_m[4]]))
    emit_phases = dict(zip(
        ("chain", "lazy mask", "walk", "emission"),
        [cut_e[1], cut_e[2] - cut_e[1], cut_e[3] - cut_e[2],
         k_emit - cut_e[3]]))
    fast_phases = {accel: {"window load": cut_f[1],
                           "s0 sort": cut_f[2] - cut_f[1],
                           "probes": t - cut_f[2]}
                   for accel, t in fast_ms.items()}
    order_ts, sort_again = torch_sort_words(torch, w_all, l_all)
    k_tsort, _o = cuda_ms(sort_again, 2)
    same_order = torch.equal(order_ts.int(), cut_order)
    order_ts, sort_again = torch_sort_words(torch, w_all, l_all, 1)
    k_tsort_s0, _o = cuda_ms(sort_again, 2)
    same_s0 = torch.equal(order_ts.int(), cut_s0)
    del order_ts, sort_again, _o, cut_order, cut_s0
    print(f"[time] {smi}: enc_match (hc=9) at {nb} x 64 KB by phase (cuts "
          "of encode_block.cu, -DZL4_STOP=1..4, each timed whole; a phase = "
          "difference of two cuts): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in match_phases.items())
          + f"; cuts {cut_m}; whole {k_match:.3f} ms")
    print(f"[time] {smi}: enc_parse_emit (level 9) at {nb} x 64 KB by "
          "phase: " + ", ".join(f"{k} {v:.3f} ms"
                                for k, v in emit_phases.items())
          + f"; cuts {cut_e}; whole {k_emit:.3f} ms")
    print(f"[time] {smi}: yardstick for the 12-byte sort alone: the batched "
          f"stable torch.sort of its three words (_stable_order over all "
          f"{nb} windows) {k_tsort:.3f} ms against the radix passes' "
          f"{match_phases['12-byte sort']:.3f} ms; orders equal: "
          f"{same_order}")
    check(same_order, "enc_match's 12-byte order differs from torch.sort's")
    print(f"[time] {smi}: enc_match_fast at {nb} x 64 KB by acceleration "
          "and phase (cuts 1 and 2 of encode_block.cu; the probes = whole - "
          "cut 2): " + "; ".join(
              f"accel {a}: " + ", ".join(f"{k} {v:.3f} ms"
                                         for k, v in ph.items())
              + f", whole {fast_ms[a]:.3f} ms"
              for a, ph in fast_phases.items())
          + f"; cuts {cut_f}; yardstick for the s0 sort alone: the batched "
          f"stable torch.sort of its one word {k_tsort_s0:.3f} ms against "
          f"the radix passes' {fast_phases[1]['s0 sort']:.3f} ms; orders "
          f"equal: {same_s0}")
    check(same_s0, "enc_match_fast's s0 order differs from torch.sort's")
    print(f"[K2/K3] plain versions at {nb} x 64 KB (minutes) ...",
          flush=True)
    p_match, pk_all_p = cuda_ms(lambda: tb.match_candidates_plain(w_all,
                                                                  l_all))
    p_emit, (out_all_p, olen_all_p) = cuda_ms(
        lambda: tb.parse_emit_plain(w_all, l_all, s_all, pk_all))
    p_fast, pk_fast_p = cuda_ms(
        lambda: tb.match_candidates_plain(w_all, l_all, 0))
    p_emit0, (out_f_p, olen_f_p) = cuda_ms(
        lambda: tb.parse_emit_plain(w_all, l_all, s_all, pk_fast, 0))
    # level 4, the other hc of the 64 KB paths
    pk4_p = tb.match_candidates_plain(w_all, l_all, 4)
    out4_k, olen4_k = tb.parse_emit(w_all, l_all, s_all, pk4, 4)
    out4_p, olen4_p = tb.parse_emit_plain(w_all, l_all, s_all, pk4, 4)
    err_m_all = max(max_abs_err(pk_all, pk_all_p), max_abs_err(pk4, pk4_p))
    err_p_all = max(max_abs_err(out_all, out_all_p),
                    max_abs_err(olen_all, olen_all_p),
                    max_abs_err(out4_k, out4_p), max_abs_err(olen4_k, olen4_p))
    err_f_all = max_abs_err(pk_fast, pk_fast_p)
    err_p0_all = max(max_abs_err(out_f, out_f_p),
                     max_abs_err(olen_f, olen_f_p))
    print(f"[K2/K3] at {nb} x 64 KB: enc_match vs plain max_abs_err "
          f"{err_m_all} (hc=9 and hc=4); enc_parse_emit vs plain max_abs_err "
          f"{err_p_all} (levels 9 and 4), {err_p0_all} (level 0); "
          f"enc_match_fast vs plain max_abs_err {err_f_all}")
    check(err_m_all == 0 and err_p_all == 0 and err_f_all == 0
          and err_p0_all == 0,
          "encoder kernels differ from plain at the paths' shapes")
    del pk_all_p, out_all_p, pk_fast_p, out_f_p, pk4_p, out4_k, out4_p, pk4
    in_bytes = nb * BLK + 4 * nb                # windows and lengths
    b_match = bound(in_bytes + 4 * nb * BLK, match_ops(nb, BLK, 9, 8, 2))
    b_fast = bound(in_bytes + 4 * nb * BLK, match_ops(nb, BLK, 0, 8, 2))
    # parse and emission: windows, candidates, lengths and starts in;
    # the zero-padded payload rows and their lengths out; about 12
    # operations a position (unpack, chain, clamp, lazy, mask)
    b_emit = bound(in_bytes + 4 * nb + 4 * nb * BLK + nb * cap + 4 * nb,
                   12 * nb * BLK)
    results["enc_match"].update(
        max_abs_err=max(edge_err["enc_match"], err_m_all), ms=k_match,
        plain_ms=p_match, bound_ms=b_match[0], bound_by=b_match[1],
        library_ms=None, ms_hc4=k_match4, phase_ms=match_phases,
        torch_sort_12_byte_order_ms=k_tsort)
    results["enc_match_fast"].update(
        max_abs_err=max(edge_err["enc_match_fast"], err_f_all,
                        *fast_err.values()), ms=k_fast,
        plain_ms=p_fast, bound_ms=b_fast[0], bound_by=b_fast[1],
        library_ms=k_tsort_s0,
        library_call="batched stable torch.sort of the s0 order's one word "
        "(the sort alone)", ms_by_accel=fast_ms, phase_ms=fast_phases,
        ptxas={k: v for k, v in ptxas.items()
               if k == "enc_match_fast_kernel"})
    results["enc_parse_emit"].update(
        max_abs_err=max(edge_err["enc_parse_emit"], err_p_all, err_p0_all),
        ms=k_emit, plain_ms=p_emit, bound_ms=b_emit[0], bound_by=b_emit[1],
        library_ms=None, ms_level0=k_emit0, phase_ms=emit_phases)

    # the deep kernels at the paths' shapes; their plain versions ran on
    # every PLAIN_STRIDE-th window of these (phase 6); every launch of the
    # three on the counted paths, each timed on its own inputs
    k_deep, deep_phases, dp_phases, emit_phases_d = {}, {}, {}, {}
    deep_launch_ms = {k: [] for k in DEEP_KERNELS}
    for level in DEEP_LEVELS:
        hc, deep = tb.level_params(level)
        k_dm, pk_d = cuda_ms(
            lambda: tb.match_candidates(w_all, l_all, hc, 1, deep), 2)
        k_dd, st_d = cuda_ms(lambda: tb.deep_dp(l_all, s_all, pk_d, deep), 2)
        k_de, _od = cuda_ms(
            lambda: tb.deep_emit(w_all, l_all, s_all, pk_d, st_d), 2)
        k_deep[level] = {"enc_deep_match": k_dm, "enc_deep_dp": k_dd,
                         "enc_deep_emit": k_de}
        if level in (12, 10):
            # enc_deep_match by phase (cuts of encode_deep.cu) and the
            # chain extension of enc_deep_dp alone; at level 12 the
            # 32-byte order against the batched stable torch.sort
            cut_dm, order32, k_chain_d = deep_phase_split(
                phase_libs, w_all, l_all, s_all, pk_d, hc, deep)
            deep_phases[level] = dict(zip(WIDE_DEEP_PHASES, [cut_dm[1]] + [
                cut_dm[k] - cut_dm[k - 1] for k in range(2, 9)]
                + [k_dm - cut_dm[8]]))
            dp_phases[level] = {"chain": k_chain_d, "DP": k_dd - k_chain_d}
            cut_de = deep_emit_phase_split(phase_libs, w_all, l_all, s_all,
                                           pk_d, st_d)
            emit_phases_d[f"level {level}, {nb} x 64 KB"] = dict(zip(
                DEEP_EMIT_PHASES, [cut_de[1], cut_de[2] - cut_de[1],
                                   cut_de[3] - cut_de[2], k_de - cut_de[3]]))
            print(f"[time] {smi}: enc_deep_match (level {level}) at {nb} x "
                  "64 KB by phase (cuts of encode_deep.cu, -DZL4_STOP=1..8): "
                  + ", ".join(f"{k} {v:.3f} ms"
                              for k, v in deep_phases[level].items())
                  + f"; cuts {cut_dm}; whole {k_dm:.3f} ms; enc_deep_dp by "
                  "phase: " + ", ".join(f"{k} {v:.3f} ms"
                                        for k, v in dp_phases[level].items())
                  + f" of {k_dd:.3f} ms; enc_deep_emit by phase (cuts "
                  "1-3): " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in emit_phases_d[
                          f"level {level}, {nb} x 64 KB"].items())
                  + f" of {k_de:.3f} ms")
            if level == 12:
                order_ts, sort_again = torch_sort_words(torch, w_all, l_all,
                                                        8)
                k_tsort32_64k = cuda_ms(sort_again, 2)[0]
                same32 = torch.equal(order_ts.int(), order32)
                del order_ts, sort_again
                print(f"[time] {smi}: yardstick for enc_deep_match's 32-byte "
                      "sort alone: the batched stable torch.sort of its "
                      f"eight words over all {nb} windows "
                      f"{k_tsort32_64k:.3f} ms against the radix passes' "
                      f"{deep_phases[12]['32-byte sort']:.3f} ms; orders "
                      f"equal: {same32}")
                check(same32, "enc_deep_match's 32-byte order differs from "
                      "torch.sort's")
            del order32
    # the block codec's launches: one 64 KB window at level 12
    w_one = torch.frombuffer(bytearray(one), dtype=torch.uint8).view(
        1, BLK).to(dev)
    l_one = torch.tensor([len(one)], dtype=torch.int32, device=dev)
    s_one = torch.zeros_like(l_one)
    tb.match_candidates(w_one, l_one, 8, 1, 3)
    k_dm1, pk_1 = cuda_ms(lambda: tb.match_candidates(w_one, l_one, 8, 1, 3),
                          2)
    k_dd1, st_1 = cuda_ms(lambda: tb.deep_dp(l_one, s_one, pk_1, 3), 2)
    k_de1, _od = cuda_ms(
        lambda: tb.deep_emit(w_one, l_one, s_one, pk_1, st_1), 2)
    for k, v in (("enc_deep_match", k_dm1), ("enc_deep_dp", k_dd1),
                 ("enc_deep_emit", k_de1)):
        deep_launch_ms[k] += [dict(path=f"level {lv}", windows=nb,
                                   window_bytes=BLK, ms=k_deep[lv][k])
                              for lv in DEEP_LEVELS]
        deep_launch_ms[k].append(dict(path="block codec, level 12",
                                      windows=1, window_bytes=BLK, ms=v))
    del pk_d, st_d, _od, pk_1, st_1
    b_deep = {
        "enc_deep_match": bound(in_bytes + 4 * nb * BLK,
                                deep_match_ops(nb, BLK, 8, 3)),
        # candidates, lengths and starts in, state words out; about 30
        # operations a position (unpack, tier, chain, clamp, three costs)
        "enc_deep_dp": bound(8 * nb * BLK + 8 * nb, 30 * nb * BLK),
        # windows, candidates, state words, lengths and starts in; the
        # zero-padded payload rows and their lengths out
        "enc_deep_emit": bound(in_bytes + 4 * nb + 8 * nb * BLK + nb * cap
                               + 4 * nb, 8 * nb * BLK)}
    for k, (b_ms, b_by) in b_deep.items():
        results[k].update(
            max_abs_err=deep_err[k], ms=k_deep[12][k],
            ms_by_level={lv: k_deep[lv][k] for lv in DEEP_LEVELS},
            plain_ms=deep_plain_ms[12][k], plain_windows=int(sel.numel()),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    results["enc_deep_match"].update(
        library_ms=k_tsort32_64k,
        library_call="batched stable torch.sort of the 32-byte order's "
        "eight words (the first sort alone)", phase_ms=deep_phases,
        ptxas={k: v for k, v in ptxas.items() if k == "enc_deep_match_kernel"})
    results["enc_deep_dp"].update(
        phase_ms=dp_phases,
        ptxas={k: v for k, v in ptxas.items() if k == "enc_deep_dp_kernel"})
    results["enc_deep_emit"].update(
        phase_ms=emit_phases_d,
        ptxas={k: v for k, v in ptxas.items()
               if k == "enc_deep_emit_kernel"})
    print(f"[time] {smi}: deep kernels at {nb} x 64 KB by level: "
          + "; ".join(f"level {lv}: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in k_deep[lv].items())
              for lv in DEEP_LEVELS)
          + "; bounds at level 12: " + ", ".join(
              f"{k} {b[0]:.4f} ms by {b[1]}" for k, b in b_deep.items())
          + f"; plain versions at {int(sel.numel())} x 64 KB, level 12: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in deep_plain_ms[12].items()))

    # every wide finder launch of the nine wide paths, timed alone on the
    # inputs the path gave it: ms at each launch, and launches x ms
    wide_launch_ms = {"enc_match_wide": [], "enc_deep_match_wide": []}
    for what, calls in wide_rec.items():
        for (w_r, l_r, s_r), kw in calls:
            hc_r, deep_r = kw["hc"], kw.get("deep", 0)
            tb.match_candidates(w_r, l_r, hc_r, 1, deep_r)
            t_r, _pk = cuda_ms(
                lambda: tb.match_candidates(w_r, l_r, hc_r, 1, deep_r), 2)
            shape = dict(path=what, windows=w_r.shape[0],
                         window_bytes=w_r.shape[1])
            wide_launch_ms["enc_deep_match_wide" if deep_r
                           else "enc_match_wide"].append(dict(shape, ms=t_r))
            if deep_r:  # the two other deep kernels on this launch's inputs
                tb.deep_dp(l_r, s_r, _pk, deep_r)
                t_d, _st = cuda_ms(lambda: tb.deep_dp(l_r, s_r, _pk, deep_r),
                                   2)
                t_e, _o = cuda_ms(
                    lambda: tb.deep_emit(w_r, l_r, s_r, _pk, _st), 2)
                deep_launch_ms["enc_deep_dp"].append(dict(shape, ms=t_d))
                deep_launch_ms["enc_deep_emit"].append(dict(shape, ms=t_e))
                del _st, _o
    del _pk
    # phase 7d's launches: the deep kernels at 64 KB and at the dryrun's
    # 1,280-byte windows, and enc_match_wide on the CLI's 256 KB blocks
    for what, calls in surface_rec.items():
        for (w_r, l_r, s_r), kw in calls:
            hc_r, deep_r, ac_r = kw["hc"], kw.get("deep", 0), kw.get("accel",
                                                                    1)
            tb.match_candidates(w_r, l_r, hc_r, ac_r, deep_r)
            t_r, _pk = cuda_ms(
                lambda: tb.match_candidates(w_r, l_r, hc_r, ac_r, deep_r), 2)
            shape = dict(path=what, windows=w_r.shape[0],
                         window_bytes=w_r.shape[1])
            if not deep_r:
                wide_launch_ms["enc_match_wide"].append(dict(shape, ms=t_r))
                continue
            t_d, _st = cuda_ms(lambda: tb.deep_dp(l_r, s_r, _pk, deep_r), 2)
            t_e, _o = cuda_ms(lambda: tb.deep_emit(w_r, l_r, s_r, _pk, _st),
                              2)
            for k, t_ in zip(DEEP_KERNELS, (t_r, t_d, t_e)):
                deep_launch_ms[k].append(dict(shape, ms=t_))
            del _st, _o
    del _pk, surface_rec
    for kern, rows_ in deep_launch_ms.items():
        check(len(rows_) == counts[kern],
              f"{kern}: {len(rows_)} launches timed, {counts[kern]} counted")
        print(f"[time] {smi}: {kern} at each of its {len(rows_)} launches "
              "on the counted paths: " + "; ".join(
                  f"{r['path']} ({r['windows']} x {r['window_bytes']}) "
                  f"{r['ms']:.2f} ms" for r in rows_)
              + f"; launches x ms {sum(r['ms'] for r in rows_):.2f} ms")
        results[kern].update(launch_ms=rows_,
                             launches_x_ms=sum(r["ms"] for r in rows_))
    for kern, rows_ in wide_launch_ms.items():
        print(f"[time] {smi}: {kern} at each of its {len(rows_)} launches "
              "on the wide paths: " + "; ".join(
                  f"{r['path']} ({r['windows']} x {r['window_bytes']}) "
                  f"{r['ms']:.2f} ms" for r in rows_)
              + f"; launches x ms {sum(r['ms'] for r in rows_):.2f} ms")

    # the wide kernels at the launches of the 1 MB paths (192 sub-span
    # windows), against their plain versions on every 12th window; at
    # level 9 phase by phase, and the 12-byte sort against torch.sort
    wide_ms = {}
    for level in (9, 0):
        (w_1m, l_1m, s_1m), kw_1m = wide_rec[f"1 MB blocks, level {level}"][0]
        hc = kw_1m["hc"]
        tb.match_candidates(w_1m, l_1m, hc)
        k_wm, pk_1m = cuda_ms(lambda: tb.match_candidates(w_1m, l_1m, hc), 2)
        tb.parse_emit(w_1m, l_1m, s_1m, pk_1m, hc)
        k_we, _o = cuda_ms(
            lambda: tb.parse_emit(w_1m, l_1m, s_1m, pk_1m, hc), 2)
        sel_w = torch.arange(0, w_1m.shape[0], WIDE_PLAIN_STRIDE, device=dev)
        w_s, l_s, s_s, pk_s = w_1m[sel_w], l_1m[sel_w], s_1m[sel_w], \
            pk_1m[sel_w]
        p_wm, pk_sp = cuda_ms(lambda: tb.match_candidates_plain(w_s, l_s,
                                                                hc))
        p_we, (out_sp, olen_sp) = cuda_ms(
            lambda: tb.parse_emit_plain(w_s, l_s, s_s, pk_s, hc))
        out_sk, olen_sk = tb.parse_emit(w_s, l_s, s_s, pk_s, hc)
        err_wm = max_abs_err(pk_s, pk_sp)
        err_we = max(max_abs_err(out_sk, out_sp),
                     max_abs_err(olen_sk, olen_sp))
        check(err_wm == 0 and err_we == 0,
              f"wide kernels differ from plain on the 1 MB level-{level} "
              "windows")
        wide_err["enc_match_wide"] = max(wide_err["enc_match_wide"], err_wm)
        wide_err["enc_parse_emit"] = max(wide_err["enc_parse_emit"], err_we)
        B_w, blk_w = w_1m.shape
        b_wm = bound(B_w * blk_w + 4 * B_w + 4 * B_w * blk_w,
                     match_ops(B_w, blk_w, hc, 8, 2))
        wide_ms[level] = dict(match=k_wm, emit=k_we, plain_match=p_wm,
                              plain_emit=p_we, bound=b_wm, B=B_w,
                              plain_windows=int(sel_w.numel()))
        if hc:
            cut_w, order_w = wide_phase_split(phase_libs, w_1m, l_1m, hc)
            wide_ms[level]["phases"] = dict(zip(WIDE_PHASES, [
                cut_w[1], cut_w[2] - cut_w[1], cut_w[3] - cut_w[2],
                cut_w[4] - cut_w[3], k_wm - cut_w[4]]))
            order_ts, sort_again = torch_sort_words(torch, w_1m, l_1m)
            wide_ms[level]["torch_sort"] = cuda_ms(sort_again, 2)[0]
            same_w = torch.equal(order_ts.int(), order_w)
            del order_ts, sort_again, order_w
            print(f"[time] {smi}: enc_match_wide (hc={hc}) at {B_w} x "
                  f"{blk_w} by phase (cuts of encode_wide.cu, -DZL4_STOP="
                  "1..4): " + ", ".join(
                      f"{k} {v:.3f} ms"
                      for k, v in wide_ms[level]["phases"].items())
                  + f"; cuts {cut_w}; whole {k_wm:.3f} ms; yardstick for "
                  "the 12-byte sort alone: the batched stable torch.sort of "
                  f"its three words {wide_ms[level]['torch_sort']:.3f} ms; "
                  f"orders equal: {same_w}")
            check(same_w, "enc_match_wide's 12-byte order differs from "
                  "torch.sort's")
        print(f"[time] {smi}: 1 MB blocks, level {level}: {B_w} x {blk_w} "
              f"windows: enc_match_wide {k_wm:.2f} ms (plain at "
              f"{sel_w.numel()} windows {p_wm:.1f} ms; bound "
              f"{b_wm[0]:.4f} ms by {b_wm[1]}), enc_parse_emit {k_we:.2f} ms "
              f"(plain at {sel_w.numel()} windows {p_we:.1f} ms); vs plain "
              f"max_abs_err {err_wm}, {err_we}")
    # enc_parse_emit against its plain version on every window of every
    # wide path at levels 0-9, on the finder's candidates for them
    for what, calls in wide_rec.items():
        for (w_r, l_r, s_r), kw in calls:
            if kw.get("deep"):
                continue
            pk_r = tb.match_candidates(w_r, l_r, kw["hc"])
            o_k, ol_k = tb.parse_emit(w_r, l_r, s_r, pk_r, kw["hc"])
            o_p, ol_p = tb.parse_emit_plain(w_r, l_r, s_r, pk_r, kw["hc"])
            err_r = max(max_abs_err(o_k, o_p), max_abs_err(ol_k, ol_p))
            print(f"[wide] {what}: enc_parse_emit vs plain on all "
                  f"{w_r.shape[0]} x {w_r.shape[1]} windows: max_abs_err "
                  f"{err_r}")
            check(err_r == 0, f"enc_parse_emit differs from plain on the "
                  f"{what} path")
            wide_err["enc_parse_emit"] = max(wide_err["enc_parse_emit"],
                                             err_r)
    del pk_r, o_k, ol_k, o_p, ol_p

    # the deep kernels at the launch of the 1 MB level-12 path (192
    # sub-span windows), against their plain versions on every 48th window
    (w_1m, l_1m, s_1m), _kw = wide_rec["1 MB blocks, level 12"][0]
    tb.match_candidates(w_1m, l_1m, 8, 1, 3)
    k_wdm, pk_1m = cuda_ms(lambda: tb.match_candidates(w_1m, l_1m, 8, 1, 3),
                           2)
    k_wdd, st_1m = cuda_ms(lambda: tb.deep_dp(l_1m, s_1m, pk_1m, 3), 2)
    k_wde, _o = cuda_ms(
        lambda: tb.deep_emit(w_1m, l_1m, s_1m, pk_1m, st_1m), 2)
    cut_wde = deep_emit_phase_split(phase_libs, w_1m, l_1m, s_1m, pk_1m,
                                    st_1m)
    emit_phases_d[f"level 12, {w_1m.shape[0]} x {w_1m.shape[1]}"] = \
        wide_emit_phases = dict(zip(DEEP_EMIT_PHASES, [
            cut_wde[1], cut_wde[2] - cut_wde[1], cut_wde[3] - cut_wde[2],
            k_wde - cut_wde[3]]))
    print(f"[time] {smi}: enc_deep_emit (level 12) at {w_1m.shape[0]} x "
          f"{w_1m.shape[1]} by phase (cuts 1-3 of encode_deep.cu): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in wide_emit_phases.items())
          + f"; cuts {cut_wde}; whole {k_wde:.3f} ms")
    sel_w = torch.arange(0, w_1m.shape[0], WIDE_DEEP_PLAIN_STRIDE, device=dev)
    _out, wide_deep_plain_ms = deep_against_plain(
        f"every {WIDE_DEEP_PLAIN_STRIDE}th window of the 1 MB level-12 path",
        w_1m[sel_w], l_1m[sel_w], s_1m[sel_w], 8, 3)
    B_w, blk_w = w_1m.shape
    cut_d, order_d = wide_phase_split(phase_libs, w_1m, l_1m, 8, 3)
    wide_deep_phases = dict(zip(WIDE_DEEP_PHASES, [cut_d[1]] + [
        cut_d[k] - cut_d[k - 1] for k in range(2, 9)] + [k_wdm - cut_d[8]]))
    order_ts, sort_again = torch_sort_words(torch, w_1m, l_1m, 8)
    k_tsort32 = cuda_ms(sort_again, 2)[0]
    same_d = torch.equal(order_ts.int(), order_d)
    del order_ts, sort_again, order_d
    print(f"[time] {smi}: enc_deep_match_wide (level 12) at {B_w} x {blk_w} "
          "by phase (cuts of encode_deep_wide.cu, -DZL4_STOP=1..8): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in wide_deep_phases.items())
          + f"; cuts {cut_d}; whole {k_wdm:.3f} ms; yardstick for the "
          "32-byte sort alone: the batched stable torch.sort of its eight "
          f"words {k_tsort32:.3f} ms; orders equal: {same_d}")
    check(same_d, "enc_deep_match_wide's 32-byte order differs from "
          "torch.sort's")
    b_wide_deep = {
        "enc_deep_match_wide": bound(B_w * blk_w + 4 * B_w
                                     + 4 * B_w * blk_w,
                                     deep_match_ops(B_w, blk_w, 8, 3)),
        "enc_deep_dp": bound(8 * B_w * blk_w + 8 * B_w, 30 * B_w * blk_w),
        "enc_deep_emit": bound(B_w * blk_w + 8 * B_w + 8 * B_w * blk_w
                               + B_w * compress_bound(blk_w) + 4 * B_w,
                               8 * B_w * blk_w)}
    k_wide_deep = {"enc_deep_match_wide": k_wdm, "enc_deep_dp": k_wdd,
                   "enc_deep_emit": k_wde}
    print(f"[time] {smi}: 1 MB blocks, level 12: deep kernels at {B_w} x "
          f"{blk_w} windows: " + ", ".join(
              f"{k} {v:.2f} ms (plain at {sel_w.numel()} windows "
              f"{wide_deep_plain_ms[k]:.1f} ms; bound {b_wide_deep[k][0]:.4f} "
              f"ms by {b_wide_deep[k][1]})" for k, v in k_wide_deep.items()))
    # the wide deep finder, and the wide launches of the other two; the
    # error of the other two is the largest over both widths
    results["enc_deep_match_wide"].update(
        max_abs_err=deep_err["enc_deep_match_wide"],
        ms=k_wide_deep["enc_deep_match_wide"],
        plain_ms=wide_deep_plain_ms["enc_deep_match_wide"],
        plain_windows=int(sel_w.numel()), windows=B_w, window_bytes=blk_w,
        bound_ms=b_wide_deep["enc_deep_match_wide"][0],
        bound_by=b_wide_deep["enc_deep_match_wide"][1],
        library_ms=k_tsort32,
        library_call="batched stable torch.sort of the 32-byte order's "
        "eight words (the first sort alone)",
        phase_ms=wide_deep_phases,
        launch_ms=wide_launch_ms["enc_deep_match_wide"],
        launches_x_ms=sum(r["ms"]
                          for r in wide_launch_ms["enc_deep_match_wide"]),
        launch_shape={k: v for k, v in wide_shapes.items() if "deep" in k},
        ptxas={k: v for k, v in ptxas.items() if "deep_match_wide" in k})
    for k in ("enc_deep_dp", "enc_deep_emit"):
        results[k].update(
            wide_ms=k_wide_deep[k], wide_plain_ms=wide_deep_plain_ms[k],
            wide_bound_ms=b_wide_deep[k][0], wide_bound_by=b_wide_deep[k][1],
            wide_windows=B_w, wide_window_bytes=blk_w)
    del w_1m, pk_1m, st_1m, _o, _out, wide_rec
    results["enc_match_wide"].update(
        max_abs_err=wide_err["enc_match_wide"], ms=wide_ms[9]["match"],
        ms_level0=wide_ms[0]["match"], plain_ms=wide_ms[9]["plain_match"],
        plain_windows=wide_ms[9]["plain_windows"], windows=wide_ms[9]["B"],
        window_bytes=SUB_WINDOW, bound_ms=wide_ms[9]["bound"][0],
        bound_by=wide_ms[9]["bound"][1], library_ms=wide_ms[9]["torch_sort"],
        library_call="batched stable torch.sort of the 12-byte order's "
        "three words (the first sort alone)",
        phase_ms=wide_ms[9]["phases"],
        launch_ms=wide_launch_ms["enc_match_wide"],
        launches_x_ms=sum(r["ms"] for r in wide_launch_ms["enc_match_wide"]),
        launch_shape={k: v for k, v in wide_shapes.items()
                      if "deep" not in k},
        ptxas={k: v for k, v in ptxas.items() if "enc_match_wide" in k})
    results["enc_parse_emit"].update(
        max_abs_err=max(results["enc_parse_emit"]["max_abs_err"],
                        wide_err["enc_parse_emit"]),
        wide_ms={lv: v["emit"] for lv, v in wide_ms.items()},
        wide_plain_ms={lv: v["plain_emit"] for lv, v in wide_ms.items()},
        wide_max_abs_err=wide_err["enc_parse_emit"])

    # decode: every compressed block of the level-9 frame in one launch
    _idx, recs = frame_payloads(frame, lz4f)
    plen = np.array([len(p) for p in recs], np.int64)
    offs = np.zeros_like(plen)
    offs[1:] = np.cumsum(plen)[:-1]
    concat = b"".join(recs)
    t_res = time.perf_counter()
    T, ol = native.native_resolve_tmap(concat, offs, plen, BLK,
                                       reuse_buffers=False)
    t_res = time.perf_counter() - t_res
    fetch = np.zeros((len(recs), int(plen.max())), np.uint8)
    for k, p in enumerate(recs):
        fetch[k, :len(p)] = np.frombuffer(p, np.uint8)
    t_stage, (f_d, T_d, ol_d) = cuda_ms(lambda: (
        torch.from_numpy(fetch).to(dev), torch.from_numpy(T).to(dev),
        torch.from_numpy(ol.astype(np.int32)).to(dev)))
    td.decode_blocks_tmap(f_d, T_d, ol_d)
    k_dec, dec_all = cuda_ms(lambda: td.decode_blocks_tmap(f_d, T_d, ol_d),
                             5)
    p_dec, dec_all_p = cuda_ms(
        lambda: td.decode_blocks_tmap_plain(f_d, T_d, ol_d), 5)
    # the library call: one torch.gather over an int64 index made ahead
    idx64 = T_d.long().clamp_(0, fetch.shape[1] - 1)
    torch.gather(f_d, 1, idx64)
    lib_dec, dec_lib = cuda_ms(lambda: torch.gather(f_d, 1, idx64), 5)
    err_k1_all = max(max_abs_err(dec_all, dec_all_p),
                     max_abs_err(dec_all, dec_lib))
    print(f"[K1] at {len(recs)} x 64 KB: tmap_gather vs plain and vs "
          f"torch.gather max_abs_err {err_k1_all}")
    check(err_k1_all == 0, "K1 differs from plain at the main path's shapes")
    del idx64, dec_lib, dec_all_p
    live = int(ol.sum())
    b_dec = bound(fetch.nbytes + 4 * live + 4 * len(recs) + T.shape[0] * BLK,
                  live)
    results["tmap_gather"].update(
        max_abs_err=max(err_k1, err_k1_all), ms=k_dec, plain_ms=p_dec,
        bound_ms=b_dec[0], bound_by=b_dec[1], library_ms=lib_dec)

    # linked step: window 1 of the linked frame (tensors from phase 5),
    # through its wrapper, and through launch on outputs made ahead
    k_step, _ = cuda_ms(
        lambda: td.linked_tmap_step(h_d, p_d, Tw_d, total_w), 20)
    out_s, new_s = torch.empty_like(out_w), torch.empty_like(h_d)
    H, PCQ = h_d.shape[0], p_d.shape[0]
    step_args = (h_d, p_d, Tw_d, out_s, new_s, H, PCQ, total_w, total_w)
    k_launch, _ = cuda_ms(lambda: launch("linked_tmap_step", *step_args), 20)
    d_step = graph_ms(lambda: launch("linked_tmap_step", *step_args))
    check(torch.equal(out_s, out_w) and torch.equal(new_s, hist_n),
          "K5 launched apart differs")
    p_link, _ = cuda_ms(
        lambda: td.linked_tmap_step_plain(h_d, p_d, Tw_d, total_w), 5)
    # the library pair: one torch.gather over an int64 index made ahead,
    # then the new history as a slice copy
    fetch_cat = torch.cat([h_d, p_d])
    idx_w = Tw_d.long().clamp_(0, fetch_cat.shape[0] - 1)
    out_lib, hist_lib = torch.empty_like(out_w), torch.empty_like(h_d)

    def lib_step():
        torch.gather(fetch_cat, 0, idx_w, out=out_lib)
        hist_lib.copy_(out_lib[total_w - H:total_w])
    lib_step()
    check(torch.equal(out_lib, out_w) and torch.equal(hist_lib, hist_n),
          "K5 differs from the library calls")
    lib_launch, _ = cuda_ms(lib_step, 20)
    lib_dev = graph_ms(lib_step)
    # the host cost of a launch: the parent's wrapper and this one, in turns
    us = {"parent": [], "launch": []}
    for tag, fn in (("parent", parent_launch), ("launch", launch),
                    ("launch", launch), ("parent", parent_launch)):
        us[tag].append(host_us(lambda: fn("linked_tmap_step", *step_args)))
    # H bytes of history and PCQ of payloads read, 4 of T a live byte,
    # the window and the new history written; one fetch an output byte
    b_lg = bound(2 * H + PCQ + 5 * total_w, total_w + H)
    results["linked_tmap_step"].update(
        max_abs_err=err_lg, ms=k_launch, device_ms=d_step,
        wrapper_ms=k_step, plain_ms=p_link, bound_ms=b_lg[0],
        bound_by=b_lg[1], library_ms=lib_launch, library_device_ms=lib_dev,
        host_us_per_launch=us["launch"],
        parent_host_us_per_launch=us["parent"])

    # linked decode by stage: resolve on the host, staging, the kernels
    t_r0 = time.perf_counter()
    wins = list(codec._resolve_linked_windows(records, BLK))
    t_resolve_l = time.perf_counter() - t_r0
    t_stage_l, staged = cuda_ms(lambda: [
        (torch.from_numpy(np.frombuffer(p, np.uint8).copy()).to(dev),
         torch.from_numpy(T_[:t]).to(dev), t) for p, T_, t in wins])
    hist0 = torch.zeros(H, dtype=torch.uint8, device=dev)

    def chain():
        h, outs = hist0, []
        for p_, T_, t in staged:
            o, h = td.linked_tmap_step(h, p_, T_, t)
            outs.append(o)
        return outs
    k_chain, outs = cuda_ms(chain)
    t_back, content = cuda_ms(lambda: torch.cat(outs).cpu().numpy().tobytes())
    check(content == data, "staged linked decode differs from the input")
    staged_bytes = sum(4 * t + len(p) for p, _T, t in wins)
    del staged, outs

    print(f"[time] {smi}: kernels at {nb} x 64 KB: enc_match (hc=9) "
          f"{k_match:.2f} ms (plain {p_match:.1f} ms, bound "
          f"{b_match[0]:.4f} ms by {b_match[1]}), enc_match (hc=4) "
          f"{k_match4:.2f} ms, enc_match_fast {k_fast:.2f} ms (plain "
          f"{p_fast:.1f} ms, bound {b_fast[0]:.4f} ms by {b_fast[1]}), "
          f"enc_parse_emit {k_emit:.2f} ms at level 9 (plain {p_emit:.1f} "
          f"ms), {k_emit0:.2f} ms at level 0 (plain {p_emit0:.1f} ms; bound "
          f"{b_emit[0]:.4f} ms by {b_emit[1]})")
    print(f"[time] {smi}: decode of {len(recs)} compressed blocks: host "
          f"resolve {t_res * 1e3:.2f} ms, staging {t_stage:.2f} ms "
          f"({T.nbytes + fetch.nbytes} bytes), tmap_gather {k_dec:.4f} ms "
          f"(plain {p_dec:.4f} ms, torch.gather {lib_dec:.4f} ms, bound "
          f"{b_dec[0]:.4f} ms by {b_dec[1]})")
    print(f"[time] {smi}: linked window (H {H}, payloads {PCQ}, output "
          f"{total_w}): linked_tmap_step device {d_step:.5f} ms, launch "
          f"{k_launch:.5f} ms, through its wrapper {k_step:.5f} ms (plain "
          f"{p_link:.4f} ms; torch.gather + slice copy: device "
          f"{lib_dev:.5f} ms, launch {lib_launch:.5f} ms; bound "
          f"{b_lg[0]:.5f} ms by {b_lg[1]}); staging of its T "
          f"{t_stage_w:.2f} ms ({4 * total_w} bytes)")
    print(f"[time] {smi}: host us a call of kernels.launch "
          f"(linked_tmap_step, 1000 calls, two turns each): this commit "
          f"{us['launch']}, the parent's wrapper {us['parent']}")
    print(f"[time] {smi}: linked decode by stage, {len(wins)} windows: host "
          f"resolve {t_resolve_l * 1e3:.2f} ms, staging {t_stage_l:.2f} ms "
          f"({staged_bytes} bytes, pageable), kernels {k_chain:.3f} ms, "
          f"copy back and join {t_back:.2f} ms")

    # the first path again: what the process's state at the end of the
    # run (device and host memory in use) does to the same calls
    del w_all, pk_all, pk_fast, out_all, out_f, T_d, f_d
    time_round_trip("level 9 again, at the end of the run", codec, frame)

    kernels = []
    for k, (_fn, src, _args, _ref) in KERNELS.items():
        kernels.append(dict(
            name=k, route="cuda",
            source=f"zig_lz4_tpu_torch/kernels/csrc/{src}",
            replaces=reference_path(k), launches=counts[k],
            launches_by_path={p: c[k] for p, c in paths.items()},
            **results[k]))
    for entry in kernels:
        missing = [key for key in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")
                   if key not in entry]
        check(not missing, f"{entry['name']} lacks {missing}")
        if entry["name"] in extra_err:
            entry["surface_max_abs_err"] = extra_err[entry["name"]]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       extra_err[entry["name"]])
    # the next redesign's ranking: each kernel's launches on the counted
    # paths times (ms - bound_ms); the wide finders' and the three deep
    # kernels' ms summed over their launches, each timed on its own inputs,
    # the others' ms at the shape each is timed at above
    ranking = {}
    for entry in kernels:
        if "launches_x_ms" in entry:
            x = entry["launches_x_ms"] - entry["launches"] * entry["bound_ms"]
        else:
            x = entry["launches"] * (entry["ms"] - entry["bound_ms"])
        ranking[entry["name"]] = x
    print("[rank] launches x (ms - bound_ms) over the counted paths (the "
          "wide finders and the deep kernels timed at each launch, the "
          "others at one shape): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              ranking.items(), key=lambda kv: -kv[1])))
    print(f"[total] {time.perf_counter() - t_run:.1f} s, the kernels' build "
          "included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(decode_without_native() if sys.argv[1:] == [CHILD_FLAG]
                 else multihost_rank(*sys.argv[2:])
                 if sys.argv[1:2] == [MULTIHOST_FLAG]
                 else time_encoder_kernels()
                 if sys.argv[1:] == [ENCODER_FLAG]
                 else time_decode_kernels()
                 if sys.argv[1:] == [DECODE_FLAG] else main())
    except Failed as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
