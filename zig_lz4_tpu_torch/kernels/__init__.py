"""Builds, loads and launches the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) by
``nvcc``, one process per source and all started together, and linked
into one shared library with a plain C interface, at first use, into
``zig_lz4_tpu_torch/_build/`` -- the same build-on-first-use scheme as
the host runtime (``native/__init__.py``), without PyTorch's headers,
so a build takes seconds.  The library is rebuilt when any source is
newer than it.  Nothing is built or loaded at import time.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``launch`` raises if that is not 0 and counts the launch in
``LAUNCHES``, which is the only place a launch is counted.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

__all__ = ["LAUNCHES", "KERNELS", "build", "launch", "library",
           "reference_path", "reset_launch_counts"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "libzl4_kernels.so")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: kernel name -> (C entry point, source file, argument types before
#: the stream, function of the JAX reference it replaces as
#: ``file:line`` inside the reference package, or from the repository
#: root for the reference's retired Pallas probes under ``experiments/``)
KERNELS = {
    "tmap_gather": ("zl4_tmap_gather", "tmap_gather.cu",
                    [_P, _P, _P, _P, _I, _I, _I],
                    "ops/jax_decode.py:1043"),
    "enc_match": ("zl4_enc_match", "encode_block.cu",
                  [_P, _P, _P, _I, _I, _I],
                  "ops/jax_block.py:249"),
    "enc_match_fast": ("zl4_enc_match_fast", "encode_block.cu",
                       [_P, _P, _P, _I, _I, _I, _I],
                       "ops/jax_block.py:348"),
    "enc_match_wide": ("zl4_enc_match_wide", "encode_wide.cu",
                       [_P] * 4 + [_I] * 8,
                       "ops/jax_block.py:249"),
    "enc_parse_emit": ("zl4_enc_parse_emit", "encode_block.cu",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I],
                       "ops/jax_block.py:522"),
    "enc_deep_match": ("zl4_enc_deep_match", "encode_deep.cu",
                       [_P, _P, _P, _P, _I, _I, _I, _I],
                       "ops/jax_block.py:274"),
    "enc_deep_match_wide": ("zl4_enc_deep_match_wide", "encode_deep_wide.cu",
                            [_P] * 5 + [_I] * 7,
                            "ops/jax_block.py:274"),
    "enc_deep_dp": ("zl4_enc_deep_dp", "encode_deep.cu",
                    [_P, _P, _P, _P, _I, _I, _I, _I],
                    "ops/jax_block.py:556"),
    "enc_deep_emit": ("zl4_enc_deep_emit", "encode_deep.cu",
                      [_P] * 10 + [_I] * 5,
                      "ops/jax_block.py:748"),
    "linked_tmap_step": ("zl4_linked_tmap_step", "linked_tmap.cu",
                         [_P] * 5 + [_I] * 4,
                         "ops/jax_decode.py:1123"),
    "seq_decode": ("zl4_seq_decode", "seq_decode.cu",
                   [_P] * 12 + [_I] * 6,
                   "ops/jax_decode.py:120"),
    "frag_decode": ("zl4_frag_decode", "frag_decode.cu",
                    [_P] * 11 + [_I] * 5,
                    "ops/jax_decode.py:342"),
    "frag_decode_win": ("zl4_frag_decode_win", "frag_decode.cu",
                        [_P] * 12 + [_I] * 11,
                        "ops/jax_decode.py:461"),
    "frag_decode_chase": ("zl4_frag_decode_chase", "frag_decode.cu",
                          [_P] * 13 + [_I] * 8,
                          "ops/jax_decode.py:798"),
    "serial_decode": ("zl4_serial_decode", "serial_decode.cu",
                      [_P] * 7 + [_I] * 5,
                      "experiments/pallas_decode.py:127"),
    "bitonic_sort2": ("zl4_bitonic_sort2", "sort_probe.cu",
                      [_P] * 4 + [_I] * 2,
                      "experiments/pallas_sort_probe.py:80"),
}
#: launches per kernel since the last reset_launch_counts()
LAUNCHES = {name: 0 for name in KERNELS}

_lib = None
_lock = threading.Lock()
#: kernel name -> its bound ctypes function, filled at first launch
_BOUND: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reference_path(name: str) -> str:
    """``file:line`` of the reference function kernel ``name``
    replaces, from the repository root: the reference package lies
    beside this one and has its name without the ``_torch`` suffix;
    the retired Pallas probes lie under ``experiments/``."""
    ref = KERNELS[name][3]
    if ref.startswith("experiments/"):
        return ref
    pkg = os.path.basename(os.path.dirname(_HERE)).removesuffix("_torch")
    return f"{pkg}/{ref}"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    return any(os.path.getmtime(s) > built
               for s in glob.glob(os.path.join(_CSRC, "*.cu*")))


def build() -> float:
    """Compile the kernels if the library is missing or stale; returns
    the seconds spent (0.0 when nothing was built).  A failed build
    raises with nvcc's output."""
    with _lock:
        if not _stale():
            return 0.0
        os.makedirs(_BUILD, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{os.getpid()}.tmp"
        flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC"]
        t0 = time.perf_counter()
        jobs = []
        for src in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))):
            obj = os.path.join(_BUILD, f"{os.path.basename(src)}.{tag}.o")
            cmd = [nvcc, *flags, "-Xptxas", "-v", "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], False
        for cmd, _obj, proc in jobs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            failed |= proc.returncode != 0
        objs = [obj for _cmd, obj, _proc in jobs]
        try:
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(log))
            tmp = f"{_SO}.{tag}"
            cmd = [nvcc, *flags, "-shared", "-o", tmp, *objs]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                                   f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        with open(os.path.join(_BUILD, "build.log"), "w") as f:
            f.write("\n".join(log))
        os.replace(tmp, _SO)
        return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        build()
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(_SO)
                for fn, _src, args, _ref in KERNELS.values():
                    getattr(lib, fn).argtypes = args + [_P]
                    getattr(lib, fn).restype = _I
                _lib = lib
    return _lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use: for the C
    entry points that launch nothing (a launch shape, an occupancy)."""
    return _load()


def _bind(name: str):
    fn = getattr(_load(), KERNELS[name][0])
    _BOUND[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream.  Tensor
    arguments must be contiguous CUDA tensors on one device; ints pass
    as C ints.  The bound C function is looked up once per name, the
    stream is read as the raw handle PyTorch's own kernel launchers read
    (``torch._C._cuda_getCurrentRawStream``), and the device is made
    current only when it is not."""
    nargs = len(KERNELS[name][2])
    if len(args) != nargs:
        raise TypeError(f"{name}: {nargs} arguments, got {len(args)}")
    dev = -1
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_contiguous():
                raise ValueError(f"{name}: tensors must be contiguous")
            if not a.is_cuda:
                raise ValueError(f"{name}: tensors must be CUDA tensors, "
                                 f"got {a.device}")
            d = a.get_device()
            if dev >= 0 and d != dev:
                raise ValueError(f"{name}: tensors on cuda:{dev} and "
                                 f"cuda:{d}")
            dev = d
            cargs.append(a.data_ptr())
        else:
            cargs.append(int(a))
    if dev < 0:
        raise ValueError(f"{name}: no tensor argument names the device")
    fn = _BOUND.get(name) or _bind(name)
    if dev == torch._C._cuda_getDevice():
        err = fn(*cargs, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*cargs, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
