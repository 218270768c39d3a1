"""Serial per-block LZ4 rebuild for the H100, with its plain PyTorch
version.

Counterpart of the JAX package's retired Pallas decoder
``experiments/pallas_decode.py`` (``make_pallas_decoder``, ``:127``, and
its wrapper ``decode_blocks_pallas``, ``:179-206``): a block is rebuilt
from its payload and the host parser's sequence table
(``ops/torch_decode.parse_sequences`` and ``seqs_to_arrays``) by walking
the sequences in order.  A literal run is copied from the payload; a
match copies ``min(rem, avail)`` bytes a round from ``op - off`` to the
end of what is written, ``avail`` starting at ``off`` and growing by
what each round wrote (``:108-120``), so a match that overlaps itself
(``off < mlen``) is exact.  There is no history, and bytes from the end
of the last sequence on are zero.  The CUDA kernel is
``kernels/csrc/serial_decode.cu`` (``serial_decode``): for blocks up to
``ROW_MAX`` bytes one CTA a block holds the block's row in shared memory,
places every literal at once, and one warp walks the matches in order;
larger blocks go to one warp a block writing device memory directly.
The route depends on ``blk`` alone.

The probe's ``_BCHUNK = 4`` blocks per ``pallas_call`` (``:176``) and its
rounding of the sequence axis up to a multiple of 512 (``:190-193``) are
budgets of the TPU's VMEM; they change no byte and are left out: one
launch takes every block at the table's own width.

For the tables ``parse_sequences`` produces (offsets inside the block,
at most ``blk`` bytes in all) the bytes are the probe's.  Outside them
the probe's Mosaic slices are undefined; here a source before the block
or past the payload reads 0, a byte at or past ``blk`` is dropped and a
negative length counts as 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import launch, library

__all__ = ["ROW_MAX", "decode_blocks_serial", "decode_blocks_serial_plain",
           "serial_launch_shape"]

#: the largest block whose row the kernel keeps in shared memory
#: (``serial_decode.cu`` kRowMax); larger blocks take the warp route
ROW_MAX = 220 * 1024


def _check(comp, lit, lsrc, ml, off, nseq, blk: int) -> None:
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise TypeError("comp must be uint8[B, ccap]")
    B = comp.shape[0]
    for name, t in (("lit", lit), ("lsrc", lsrc), ("ml", ml), ("off", off)):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != B
                or t.shape != lit.shape or t.shape[1] < 1):
            raise TypeError(f"{name} must be int32[B, ncap]")
    if nseq.dtype != torch.int32 or nseq.shape != (B,):
        raise TypeError("nseq must be int32[B]")
    if any(t.device != comp.device for t in (lit, lsrc, ml, off, nseq)):
        raise ValueError("every tensor must be on one device")
    if not isinstance(blk, int) or not 0 < blk < 2 ** 31:
        raise ValueError(f"blk={blk!r}")


def _out_len(lit, ml, nseq) -> torch.Tensor:
    """Sum of the literal and match lengths of the live sequences, as the
    probe's wrapper computes it from the parse (``:203-205``)."""
    live = (torch.arange(lit.shape[1], device=lit.device)[None, :]
            < nseq[:, None])
    return (torch.where(live, lit, 0).sum(1)
            + torch.where(live, ml, 0).sum(1)).to(torch.int64)


def _rebuild(comp: bytes, seqs, blk: int) -> bytearray:
    """One block: ``seqs`` = [(lit, lsrc, ml, off)] in order."""
    out = bytearray(blk)
    ccap = len(comp)
    op = 0
    for lit, src, m, o in seqs:
        lit, m, o = max(lit, 0), max(m, 0), max(o, 1)
        lend = min(lit, blk - op)
        if lend > 0:        # bytes of comp[src + k] that exist
            k0, k1 = min(max(-src, 0), lend), max(min(lend, ccap - src), 0)
            if k1 > k0:
                out[op + k0:op + k1] = comp[src + k0:src + k1]
        op += lit
        mop, avail, rem = op, o, m
        while rem > 0 and mop < blk:
            c = min(rem, avail)
            cend = min(c, blk - mop)
            s0 = mop - avail        # s0 + c <= mop: no overlap in a round
            z = min(max(-s0, 0), cend)
            out[mop + z:mop + cend] = out[s0 + z:s0 + cend]
            mop, rem, avail = mop + c, rem - c, avail + c
        op = mop + rem
    return out


def decode_blocks_serial_plain(comp: torch.Tensor, lit: torch.Tensor,
                               lsrc: torch.Tensor, ml: torch.Tensor,
                               off: torch.Tensor, nseq: torch.Tensor,
                               blk: int):
    """Plain version of the ``serial_decode`` kernel: (out uint8[B, blk],
    out_len int64[B])."""
    _check(comp, lit, lsrc, ml, off, nseq, blk)
    dev = comp.device
    B, ncap = lit.shape
    tabs = [t.cpu().tolist() for t in (lit, lsrc, ml, off)]
    ns = nseq.cpu().tolist()
    rows = comp.cpu().numpy()
    out = torch.zeros((B, blk), dtype=torch.uint8)
    for b in range(B):
        q = min(max(ns[b], 0), ncap)
        seqs = zip(*(t[b][:q] for t in tabs))
        out[b] = torch.frombuffer(_rebuild(rows[b].tobytes(), seqs, blk),
                                  dtype=torch.uint8)
    return out.to(dev), _out_len(lit, ml, nseq)


def decode_blocks_serial(comp: torch.Tensor, lit: torch.Tensor,
                         lsrc: torch.Tensor, ml: torch.Tensor,
                         off: torch.Tensor, nseq: torch.Tensor, blk: int):
    """Rebuild blocks of up to ``blk`` bytes from their payloads ``comp``
    uint8[B, ccap] and sequence tables ``lit``/``lsrc``/``ml``/``off``
    int32[B, ncap], ``nseq`` int32[B] (``seqs_to_arrays``), as
    ``decode_blocks_pallas`` does.  Returns (out uint8[B, blk], zero past
    the last sequence; out_len int64[B], the sum of the live sequences'
    lengths).  The ``serial_decode`` kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if comp.device.type == "cpu":
        return decode_blocks_serial_plain(comp, lit, lsrc, ml, off, nseq, blk)
    _check(comp, lit, lsrc, ml, off, nseq, blk)
    B, ncap = lit.shape
    comp, lit, lsrc, ml, off, nseq = (t.contiguous() for t in
                                      (comp, lit, lsrc, ml, off, nseq))
    out = torch.empty((B, blk), dtype=torch.uint8, device=comp.device)
    if B:
        launch("serial_decode", comp, lit, lsrc, ml, off, nseq, out, B,
               comp.shape[1], ncap, blk, int(blk <= ROW_MAX))
    return out, _out_len(lit, ml, nseq)


def serial_launch_shape(blk: int) -> dict:
    """The kernel's launch for ``blk``-byte blocks on the current CUDA
    device: whether the row lies in shared memory (else one warp a block
    in device memory), its shared-memory bytes a CTA of 256 threads, and
    the CTAs an SM holds at once."""
    out = (ctypes.c_int * 3)()
    fn = library().zl4_serial_decode_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(blk, out)
    if err:
        raise RuntimeError(f"serial launch shape: CUDA error {err}")
    return {"shared_row": bool(out[0]), "threads": 256,
            "smem_bytes": out[1], "ctas_per_sm": out[2]}
