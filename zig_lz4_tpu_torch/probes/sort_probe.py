"""Batched key+payload bitonic sort for the H100, with its plain PyTorch
version.

Counterpart of the JAX package's retired Pallas probe
``experiments/pallas_sort_probe.py`` (``pallas_sort2``, ``:80``): a
bitonic network over rows of 65,536 int32 keys with an int32 payload.
Its 136 stages pair row ``g`` with ``g ^ d``; the last merge is all
ascending; a row takes its partner's pair only when the partner's key is
strictly smaller (where the row keeps the minimum) or strictly larger, so
equal keys keep their pairs and the result is not a stable sort's
(``:60-74``).  The kernel (``kernels/csrc/sort_probe.cu``,
``bitonic_sort2``; network in ``sort_cluster.cuh``) sorts a batch of rows
in one launch, one thread-block cluster a row (16 CTAs of 4,096 pairs at
65,536), and gives the probe's pairs, ties included.

The probe asked whether such a sort, held in fast memory, beats the
library's batched sort.  ``main`` asks it on the card: the kernel against
``torch.sort`` with the payload gathered, at one row and at 64.

    python -m zig_lz4_tpu_torch.probes.sort_probe
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..kernels import launch, library

__all__ = ["N", "bitonic_sort2", "bitonic_sort2_plain", "cluster_shape",
           "main"]

#: keys per row of the probe (``ROWS * LANE``, ``:34-36``)
N = 65536


def _check(keys: torch.Tensor, vals: torch.Tensor) -> None:
    for name, t in (("keys", keys), ("vals", vals)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be int32[B, N]")
    if keys.shape != vals.shape or keys.device != vals.device:
        raise ValueError("keys and vals must have one shape and device")
    n = keys.shape[1]
    if n < 2 or n & (n - 1) or n > 1 << 24:
        raise ValueError(f"rows of {n} keys: a power of two from 2 to 2^24")


def bitonic_sort2_plain(keys: torch.Tensor, vals: torch.Tensor):
    """Plain version of the ``bitonic_sort2`` kernel: the probe's stages
    as torch ops, every row at once.  At stride ``d`` the partner of row
    ``g`` is ``g ^ d``: viewed as [B, n / 2d, 2, d], each pair is the
    (lower, upper) entry of one column, and the probe's take-partner rule
    exchanges the two exactly when the upper key is strictly smaller in
    an ascending run, strictly larger in a descending one.  Returns
    (keys, vals) sorted by key."""
    _check(keys, vals)
    k, v = keys.clone(), vals.clone()
    B, n = keys.shape
    nbits = n.bit_length() - 1
    for kk in range(1, nbits + 1):
        for j in range(kk - 1, -1, -1):
            d = 1 << j
            k4, v4 = k.view(B, n // (2 * d), 2, d), v.view(B, n // (2 * d),
                                                          2, d)
            lo, hi, vlo, vhi = k4[:, :, 0], k4[:, :, 1], v4[:, :, 0], \
                v4[:, :, 1]
            # the run of 2^kk rows a pair lies in is ascending when bit kk
            # of its first row is clear: always at kk == nbits
            first = torch.arange(n // (2 * d), device=k.device) * (2 * d)
            asc = ((first & (1 << kk)) == 0)[:, None]
            swap = torch.where(asc, hi < lo, hi > lo)
            k = torch.stack([torch.where(swap, hi, lo),
                             torch.where(swap, lo, hi)], 2).view(B, n)
            v = torch.stack([torch.where(swap, vhi, vlo),
                             torch.where(swap, vlo, vhi)], 2).view(B, n)
    return k, v


def bitonic_sort2(keys: torch.Tensor, vals: torch.Tensor):
    """Sort each row of ``keys`` int32[B, N] (N a power of two; the
    probe's is 65,536) with its payload ``vals`` by the probe's bitonic
    network.  Returns new (keys, vals).  The ``bitonic_sort2`` kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if keys.device.type == "cpu":
        return bitonic_sort2_plain(keys, vals)
    _check(keys, vals)
    keys, vals = keys.contiguous(), vals.contiguous()
    B, n = keys.shape
    kout, vout = torch.empty_like(keys), torch.empty_like(vals)
    if B:
        launch("bitonic_sort2", keys, vals, kout, vout, B, n)
    return kout, vout


def cluster_shape(B: int, n: int) -> dict:
    """How ``bitonic_sort2`` lays out B rows of n keys on the current
    CUDA device: CTAs a cluster, threads and shared-memory bytes a CTA,
    and how many such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: the shape cannot run)."""
    lib = library()
    out = (ctypes.c_int * 4)()
    fn = lib.zl4_bitonic_sort2_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(B, n, out)
    if err != 0:
        raise RuntimeError(f"bitonic_sort2 shape: CUDA error {err}")
    return dict(cluster=out[0], threads=out[1], smem=out[2],
                max_active_clusters=out[3])


def library_sort2(keys: torch.Tensor, vals: torch.Tensor):
    """One ``torch.sort`` of the keys with the payload gathered: the
    yardstick.  Its keys equal the network's; its payload may differ
    among equal keys."""
    ks, idx = torch.sort(keys, dim=-1)
    return ks, torch.gather(vals, 1, idx)


def main() -> int:
    """The probe's question on the card: the kernel against
    ``torch.sort`` at one row and at 64 rows of random keys."""
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    ok = True
    for B in (1, 64):
        keys = torch.randint(0, 1 << 30, (B, N), generator=gen,
                             dtype=torch.int32).to(dev)
        vals = torch.arange(N, dtype=torch.int32).repeat(B, 1).to(dev)
        times = {}
        for name, fn in (("bitonic_sort2", bitonic_sort2),
                         ("torch.sort", library_sort2)):
            fn(keys, vals)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                res = fn(keys, vals)
            t1.record()
            torch.cuda.synchronize()
            times[name] = (t0.elapsed_time(t1) / 20, res)
        (k_ms, (ko, vo)), (l_ms, (kl, _vl)) = times.values()
        kp, vp = bitonic_sort2_plain(keys, vals)
        same = (torch.equal(ko, kp) and torch.equal(vo, vp)
                and torch.equal(ko, kl)
                and torch.equal(torch.gather(keys, 1, vo.long()), ko))
        ok &= same
        print(f"{smi}: B={B} rows of {N} int32 key+payload: bitonic_sort2 "
              f"{k_ms:.4f} ms ({k_ms / B:.4f} a row), torch.sort "
              f"{l_ms:.4f} ms ({l_ms / B:.4f} a row); equals plain and "
              f"torch.sort's keys: {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
