"""Block rebuilds for the H100, with their plain PyTorch versions.

Counterpart of the T-map decoders (``ops/jax_decode.py:1033-1149``) and
of the sequence-rebuild decoder (``_decode_block``, ``:120-290``) of
the JAX reference.

* Independent blocks (``device_tmap_decoder_supports``,
  ``_decode_block_tmap`` and its batched form, ``:1033-1081``): the host
  resolver (``native_resolve_tmap``) maps every output byte to the
  fetch-buffer byte it equals, so a block is rebuilt by one gather:
  ``out[b, j] = fetch[b, clip(T[b, j], 0, F - 1)]`` for
  ``j < out_len[b]``, else 0.  The CUDA kernel is
  ``kernels/csrc/tmap_gather.cu``.  ``resolve_tmap_py`` is the
  reference's pure-Python mirror of that resolver (``:968-1030``).
* Linked frames (``_linked_tmap_step`` over ``_decode_flat_fetch``,
  ``:1084-1143``): a window of blocks is rebuilt by one flat gather
  from ``[history | payloads]`` by the global T-map of
  ``native_resolve_tmap_linked``, and the last ``H`` bytes of
  ``[history | output]`` become the next window's history, so the
  windows of a frame chain on the device.  The CUDA kernels are in
  ``kernels/csrc/linked_tmap.cu``.
* Blocks from parsed sequences (``parse_sequences``, ``seqs_to_arrays``,
  ``decode_blocks``; reference ``:39-117``, ``_decode_block`` and
  ``decode_blocks_jax``, ``:1395``): the host parses a payload into the
  table ``(lit_len, lit_src, mlen, off, nseq)`` and the device rebuilds
  the block from the payload, the table and an optional history window
  (a dictionary or a streaming prefix).  This route needs no native
  runtime.  The CUDA kernel is ``kernels/csrc/seq_decode.cu``.
* Blocks from fragment tables (``:292-965``, ``:1152-1340``): the three
  fragment-ladder decoders live in ``ops/torch_frags.py`` and are
  re-exported here, where the reference has them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import compress_bound
from ..errors import CorruptedData
from ..kernels import launch
from .torch_frags import _rounds_arg
from .torch_frags import (decode_blocks_frags,  # noqa: F401  (re-exported)
                          decode_blocks_frags_chase,
                          decode_blocks_frags_chase_plain,
                          decode_blocks_frags_plain, decode_blocks_frags_win,
                          decode_blocks_frags_win_plain,
                          device_chase_decoder_supports,
                          device_frag_decoder_supports,
                          device_win_decoder_supports, resolve_fragments_py,
                          win_tier_config)

__all__ = ["device_tmap_decoder_supports", "resolve_tmap_py",
           "decode_blocks_tmap",
           "decode_blocks_tmap_plain", "linked_tmap_step",
           "linked_tmap_step_plain", "MAX_SEQS", "parse_sequences",
           "seqs_to_arrays", "device_seq_decoder_supports",
           "decode_blocks", "decode_blocks_plain", "make_block_decoder",
           "device_frag_decoder_supports", "device_win_decoder_supports",
           "device_chase_decoder_supports", "win_tier_config",
           "resolve_fragments_py", "decode_blocks_frags",
           "decode_blocks_frags_plain", "decode_blocks_frags_win",
           "decode_blocks_frags_win_plain", "decode_blocks_frags_chase",
           "decode_blocks_frags_chase_plain"]

#: largest block, and largest history, the sequence-rebuild kernel
#: takes: the output block lives in one thread block's shared memory
_SEQ_MAX_BLK = 65536


def device_tmap_decoder_supports(blk: int,
                                 fetch_cap: int | None = None) -> bool:
    """True when the gather covers this (block, fetch buffer) geometry.
    Unlike the TPU merge, whose 9-bit byte pack caps the fetch buffer
    (``jax_decode.py:1033-1040``), a gather only needs int32 T entries
    and grid rows, so every frame block size qualifies."""
    return 0 < blk < 2 ** 31 and (fetch_cap is None
                                  or 0 < fetch_cap < 2 ** 31)


def resolve_tmap_py(comp: bytes, out_cap: int, hist_len: int = 0):
    """Pure-Python mirror of the native per-byte literal-source map
    resolver (``native_resolve_tmap``): T[p] is the fetch coordinate in
    ``[history | payload]`` whose byte equals output byte p, with every
    match chain path-compressed on the host.  Returns (T int32[out_cap],
    out_len), or None when the block decodes past ``out_cap``; raises
    ``CorruptedData`` on a malformed payload (reference:
    ``jax_decode.resolve_tmap_py``, ``ops/jax_decode.py:968-1030``)."""
    T = np.zeros(out_cap, np.int32)
    ip, n, op = 0, len(comp), 0

    def length(v: int, what: str) -> int:
        nonlocal ip
        if v == 15:             # 255-escaped continuation bytes
            while True:
                if ip >= n:
                    raise CorruptedData(f"truncated {what} length")
                x = comp[ip]
                ip += 1
                v += x
                if x != 255:
                    break
        return v

    while ip < n:
        token = comp[ip]
        ip += 1
        lit = length(token >> 4, "literal")
        if ip + lit > n:
            raise CorruptedData("literal overrun")
        if lit:
            if op + lit > out_cap:
                return None
            T[op:op + lit] = hist_len + np.arange(ip, ip + lit)
            op += lit
            ip += lit
        if ip >= n:
            break
        if ip + 2 > n:
            raise CorruptedData("truncated offset")
        off = comp[ip] | (comp[ip + 1] << 8)
        ip += 2
        if off == 0 or off > op + hist_len:
            raise CorruptedData(f"bad offset {off} at {op}")
        ml = length(token & 15, "match") + 4
        if op + ml > out_cap:
            return None
        take = min(ml, off)
        s = op - off
        if s >= 0:
            T[op:op + take] = T[s:s + take]
        else:                   # the head reaches into the history
            hb = min(-s, take)
            T[op:op + hb] = hist_len + s + np.arange(hb)
            if take > hb:
                T[op + hb:op + take] = T[:take - hb]
        done = take
        while done < ml:        # period-doubling tail
            c = min(done, ml - done)
            T[op + done:op + done + c] = T[op:op + c]
            done += c
        op += ml
    return T, op


def _check(fetch, T, out_len) -> None:
    if fetch.dtype != torch.uint8 or fetch.dim() != 2:
        raise TypeError("fetch must be uint8[B, F]")
    if T.dtype != torch.int32 or T.dim() != 2 or T.shape[0] != fetch.shape[0]:
        raise TypeError("T must be int32[B, blk]")
    if out_len.dtype != torch.int32 or out_len.shape != (fetch.shape[0],):
        raise TypeError("out_len must be int32[B]")
    if fetch.shape[1] < 1:
        raise ValueError("empty fetch rows")
    if not (fetch.device == T.device == out_len.device):
        raise ValueError("fetch, T and out_len must share a device")


def decode_blocks_tmap_plain(fetch: torch.Tensor, T: torch.Tensor,
                             out_len: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``tmap_gather`` kernel: uint8[B, blk]."""
    _check(fetch, T, out_len)
    F = fetch.shape[1]
    j = torch.arange(T.shape[1], device=T.device)
    live = j[None, :] < out_len[:, None]
    src = torch.where(live, T, 0).long().clamp(0, F - 1)
    return torch.where(live, torch.gather(fetch, 1, src), 0).to(torch.uint8)


def decode_blocks_tmap(fetch: torch.Tensor, T: torch.Tensor,
                       out_len: torch.Tensor) -> torch.Tensor:
    """Rebuild blocks from fetch buffers ``fetch`` uint8[B, F], T-maps
    ``T`` int32[B, blk] and lengths ``out_len`` int32[B]; the
    ``tmap_gather`` kernel for CUDA tensors, the plain version for CPU
    tensors.  Rows of T at or past out_len are never read."""
    if fetch.device.type == "cpu":
        return decode_blocks_tmap_plain(fetch, T, out_len)
    _check(fetch, T, out_len)
    B, blk = T.shape
    if B > 65535:
        raise ValueError(f"{B} blocks in one launch (grid rows <= 65535)")
    fetch, T, out_len = fetch.contiguous(), T.contiguous(), out_len.contiguous()
    out = torch.empty((B, blk), dtype=torch.uint8, device=T.device)
    if B and blk:
        launch("tmap_gather", fetch, T, out_len, out, B, fetch.shape[1], blk)
    return out


def _check_linked(hist, payloads, T, total: int) -> None:
    for name, t in (("hist", hist), ("payloads", payloads)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise TypeError(f"{name} must be uint8[N]")
    if T.dtype != torch.int32 or T.dim() != 1:
        raise TypeError("T must be int32[NOUT]")
    if hist.shape[0] < 1 or T.shape[0] < 1:
        raise ValueError("empty history or T")
    if not (hist.device == payloads.device == T.device):
        raise ValueError("hist, payloads and T must share a device")
    if hist.shape[0] + payloads.shape[0] + T.shape[0] >= 2 ** 31:
        raise ValueError("window too large for int32 coordinates")
    if not isinstance(total, int):
        raise TypeError("total must be an int")


def linked_tmap_step_plain(hist: torch.Tensor, payloads: torch.Tensor,
                           T: torch.Tensor, total: int):
    """Plain version of the ``linked_tmap_step`` kernel: (out
    uint8[NOUT], new_hist uint8[H])."""
    _check_linked(hist, payloads, T, total)
    H, nout = hist.shape[0], T.shape[0]
    fetch = torch.cat([hist, payloads])
    live = torch.arange(nout, device=T.device) < total
    src = torch.where(live, T, 0).long().clamp(0, fetch.shape[0] - 1)
    out = torch.where(live, fetch[src], 0).to(torch.uint8)
    shift = min(max(total, 0), nout)
    return out, torch.cat([hist, out])[shift:shift + H]


def linked_tmap_step(hist: torch.Tensor, payloads: torch.Tensor,
                     T: torch.Tensor, total: int):
    """One window of a linked frame: ``hist`` uint8[H] is the history at
    the window's entry, right-aligned; ``payloads`` uint8[PCQ] the
    window's block payloads; ``T`` int32[NOUT] its global T-map over
    ``[hist | payloads]``; ``total`` its live output length.  Returns
    (out uint8[NOUT], zero from ``total`` on; new_hist uint8[H], the H
    bytes of ``[hist | out]`` from ``clip(total, 0, NOUT)`` on -- a new
    tensor, ``hist`` is left as it was).  The ``linked_tmap_step``
    kernel, one launch for both outputs, for CUDA tensors, the plain
    version for CPU tensors.  Rows of T at or past ``total`` are never
    read."""
    if hist.device.type == "cpu":
        return linked_tmap_step_plain(hist, payloads, T, total)
    _check_linked(hist, payloads, T, total)
    hist, payloads, T = hist.contiguous(), payloads.contiguous(), \
        T.contiguous()
    H, nout = hist.shape[0], T.shape[0]
    out = torch.empty(nout, dtype=torch.uint8, device=T.device)
    new_hist = torch.empty_like(hist)
    launch("linked_tmap_step", hist, payloads, T, out, new_hist, H,
           payloads.shape[0], nout, total)
    return out, new_hist


# ---------------------------------------------------------------------
# rebuild from parsed sequences
# ---------------------------------------------------------------------

def MAX_SEQS(blk: int) -> int:
    """Worst-case sequence count for decoding a blk-byte block."""
    return blk // 4 + 2


def parse_sequences(comp: bytes, history_len: int = 0):
    """Host-side token parse: compressed block -> sequence list.

    Returns a list of (lit_len, lit_comp_start, match_len, offset); the
    tail sequence has match_len == 0.  Validates structure and raises
    ``CorruptedData`` on corruption.  ``history_len`` extends the
    reachable window behind the block (streaming prefix or dictionary).
    This is the cheap serial part of decode; the reconstruction runs on
    the device (reference: ``jax_decode.py:48-102``).
    """
    seqs = []
    ip, iend = 0, len(comp)
    op = 0
    while ip < iend:
        token = comp[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= iend:
                    raise CorruptedData("truncated literal length")
                x = comp[ip]
                ip += 1
                lit += x
                if x != 255:
                    break
        if ip + lit > iend:
            raise CorruptedData("literal run overruns input")
        lit_start = ip
        ip += lit
        op += lit
        if ip >= iend:
            seqs.append((lit, lit_start, 0, 0))
            break
        if ip + 2 > iend:
            raise CorruptedData("truncated offset")
        off = comp[ip] | (comp[ip + 1] << 8)
        ip += 2
        if off == 0 or off > op + history_len:
            raise CorruptedData(f"bad offset {off} at output pos {op}")
        ml = token & 15
        if ml == 15:
            while True:
                if ip >= iend:
                    raise CorruptedData("truncated match length")
                x = comp[ip]
                ip += 1
                ml += x
                if x != 255:
                    break
        ml += 4
        op += ml
        seqs.append((lit, lit_start, ml, off))
    return seqs


def seqs_to_arrays(seqs, nseq_cap: int):
    """Pack parsed sequences into fixed-shape numpy arrays for the
    device: (lit_len, lit_src, mlen, off) int32[nseq_cap] and the
    count (reference: ``jax_decode.py:105-117``)."""
    ns = len(seqs)
    if ns > nseq_cap:
        raise ValueError(f"{ns} sequences exceed capacity {nseq_cap}")
    lit = np.zeros(nseq_cap, np.int32)
    lsrc = np.zeros(nseq_cap, np.int32)
    ml = np.zeros(nseq_cap, np.int32)
    off = np.ones(nseq_cap, np.int32)
    for k, (a, b_, c, d) in enumerate(seqs):
        lit[k], lsrc[k], ml[k], off[k] = a, b_, c, max(d, 1)
    return lit, lsrc, ml, off, np.int32(ns)


def device_seq_decoder_supports(blk: int, hcap: int = 0) -> bool:
    """True when the sequence-rebuild kernel takes ``blk``-byte blocks
    behind a ``hcap``-byte history: up to 64 KB each (the reference's
    packs stop at the same place, ``jax_decode.py:156``)."""
    return 0 < blk <= _SEQ_MAX_BLK and 0 <= hcap <= _SEQ_MAX_BLK


def _check_seq(comp, lit_len, lit_src, mlen, off, nseq, blk, hists):
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise TypeError("comp must be uint8[B, ccap]")
    B = comp.shape[0]
    for name, t in (("lit_len", lit_len), ("lit_src", lit_src),
                    ("mlen", mlen), ("off", off)):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != B
                or t.shape != lit_len.shape or t.shape[1] < 1):
            raise TypeError(f"{name} must be int32[B, nseq_cap]")
    if nseq.dtype != torch.int32 or nseq.shape != (B,):
        raise TypeError("nseq must be int32[B]")
    hcap = 0
    if hists is not None:
        if hists.dtype != torch.uint8 or hists.dim() not in (1, 2) or (
                hists.dim() == 2 and hists.shape[0] != B):
            raise TypeError("hists must be uint8[hcap] or uint8[B, hcap]")
        hcap = hists.shape[-1]
    tensors = [comp, lit_len, lit_src, mlen, off, nseq] + (
        [] if hists is None else [hists])
    if any(t.device != comp.device for t in tensors):
        raise ValueError("every tensor must be on one device")
    if not device_seq_decoder_supports(blk, hcap):
        raise NotImplementedError(
            f"{blk}-byte blocks behind {hcap} bytes of history: the "
            f"sequence-rebuild decoder takes up to {_SEQ_MAX_BLK} bytes of "
            "each; larger blocks decode through the T-map path "
            "(decode_blocks_tmap)")
    return hcap


def decode_blocks_plain(comp: torch.Tensor, lit_len: torch.Tensor,
                        lit_src: torch.Tensor, mlen: torch.Tensor,
                        off: torch.Tensor, nseq: torch.Tensor, blk: int,
                        hists: torch.Tensor | None = None):
    """Plain version of the ``seq_decode`` kernel: (out uint8[B, blk],
    zero from out_len on; out_len int32[B]; ok int32[B]).  Literal runs
    are one gather per block; the matches are copied in sequence order,
    an overlapping one as the repeated ``off`` bytes before it."""
    hcap = _check_seq(comp, lit_len, lit_src, mlen, off, nseq, blk, hists)
    B, ccap = comp.shape
    cap = lit_len.shape[1]
    dev = comp.device
    out = torch.zeros((B, blk), dtype=torch.uint8)
    out_len = torch.zeros(B, dtype=torch.int32)
    ok = torch.zeros(B, dtype=torch.int32)
    comp, lit_len, lit_src, mlen, off, nseq = (
        t.cpu() for t in (comp, lit_len, lit_src, mlen, off, nseq))
    if hists is not None:
        hists = hists.cpu()
    for b in range(B):
        ns = min(max(int(nseq[b]), 0), cap)
        ll, ls, ml = (t[b, :ns].long() for t in (lit_len, lit_src, mlen))
        o = off[b, :ns].long().clamp(min=1)
        good = ns == int(nseq[b]) and bool((ll >= 0).all()
                                           and (ml >= 0).all())
        ll, ml = ll.clamp(0, blk + 1), ml.clamp(0, blk + 1)
        seg = ll + ml
        start = torch.cumsum(seg, 0) - seg
        total = int(seg.sum())
        out_len[b] = min(total, blk + 1)
        good = good and total <= blk and bool(
            ((ll == 0) | ((ls >= 0) & (ls + ll <= ccap))).all()
            and ((ml == 0) | (start + ll - o >= -hcap)).all())
        ok[b] = int(good)
        if not good:
            continue
        # literals: byte k of run q goes from comp[ls + k] to start + k
        q = torch.repeat_interleave(torch.arange(ns), ll)
        k = torch.arange(q.shape[0]) - (torch.cumsum(ll, 0) - ll)[q]
        row = torch.zeros(blk, dtype=torch.uint8)
        row[start[q] + k] = comp[b][ls[q] + k]
        # matches, in order, over [history | block]
        hist = b"" if hists is None else bytes(
            (hists if hists.dim() == 1 else hists[b]).numpy())
        full = bytearray(hist) + bytearray(row.numpy())
        for d0, m, oo in zip((start + ll + hcap).tolist(), ml.tolist(),
                             o.tolist()):
            if m:
                pat = full[d0 - oo:d0 - oo + min(oo, m)]
                full[d0:d0 + m] = (pat * (m // len(pat) + 1))[:m]
        out[b] = torch.frombuffer(full, dtype=torch.uint8)[hcap:]
        out[b, total:] = 0
    return out.to(dev), out_len.to(dev), ok.to(dev)


def decode_blocks(comp: torch.Tensor, lit_len: torch.Tensor,
                  lit_src: torch.Tensor, mlen: torch.Tensor,
                  off: torch.Tensor, nseq: torch.Tensor, blk: int,
                  hists: torch.Tensor | None = None, *,
                  rounds: torch.Tensor | None = None):
    """Rebuild blocks of up to ``blk`` bytes from parsed sequences,
    counterpart of ``decode_blocks_jax``: ``comp`` uint8[B, ccap] the
    payloads, ``lit_len``/``lit_src``/``mlen``/``off`` int32[B,
    nseq_cap] and ``nseq`` int32[B] the tables of ``seqs_to_arrays``,
    ``hists`` uint8[B, hcap] (or uint8[hcap], shared by every block)
    the bytes that logically precede each block, right-aligned.
    Returns (out uint8[B, blk], zero from out_len on; out_len int32[B];
    ok int32[B]).  ``ok`` is 0, and the row zero, for a table that
    ``parse_sequences`` would not have produced for a block of at most
    ``blk`` bytes: sources outside the payload or before the history,
    or more than ``blk`` bytes of output.  The ``seq_decode`` kernel
    for CUDA tensors, the plain version for CPU tensors.  ``rounds``, an
    int32[B] CUDA tensor, receives each block's number of pointer-jumping
    rounds from the kernel (the plain version has no rounds: it is
    ignored on the CPU)."""
    if comp.device.type == "cpu":
        return decode_blocks_plain(comp, lit_len, lit_src, mlen, off, nseq,
                                   blk, hists)
    hcap = _check_seq(comp, lit_len, lit_src, mlen, off, nseq, blk, hists)
    B, ccap = comp.shape
    cap = lit_len.shape[1]
    dev = comp.device
    comp, lit_len, lit_src, mlen, off, nseq = (
        t.contiguous() for t in (comp, lit_len, lit_src, mlen, off, nseq))
    hists = comp if hists is None else hists.contiguous()   # never read
    out = torch.empty((B, blk), dtype=torch.uint8, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.int32, device=dev)
    seg_start = torch.empty((B, cap), dtype=torch.int32, device=dev)
    rounds = _rounds_arg(rounds, B, dev)
    if B:
        launch("seq_decode", comp, hists, lit_len, lit_src, mlen, off, nseq,
               seg_start, out, out_len, ok, rounds, B, ccap, hcap,
               hcap if hists.dim() == 2 and hcap else 0, cap, blk)
    return out, out_len, ok


@functools.lru_cache(maxsize=None)
def make_block_decoder(blk: int, ccap: int | None = None,
                       nseq_cap: int | None = None, hcap: int = 1,
                       device: str | torch.device = "cuda"):
    """The single-block decoder of ``jax_decode.make_block_decoder``
    (``jax_decode.py:1366-1386``), one per geometry: ``call(comp, lit,
    lsrc, ml, off, ns, hist=None) -> (out uint8[blk], out_len int32)``
    from a payload ``comp`` (bytes, an array or a tensor, zero-padded
    to ``ccap`` bytes, by default ``compress_bound(blk)``), the table of
    ``seqs_to_arrays`` (each column ``nseq_cap`` long, by default
    ``MAX_SEQS(blk)``) and ``hist``,
    the ``hcap`` bytes before the block (zeros when omitted).  It runs
    ``decode_blocks`` over a batch of one on ``device`` (``seq_decode``
    on a CUDA device, the plain version on the CPU, which must be asked
    for) and raises ``CorruptedData`` where that reports the table bad,
    which the reference does not check."""
    from ..parallel.device import resolve_device
    ccap = ccap or compress_bound(blk)
    nseq_cap = nseq_cap or MAX_SEQS(blk)
    dev = resolve_device(device)
    zeros = torch.zeros(hcap, dtype=torch.uint8, device=dev)

    def tensor(a, dtype):
        if isinstance(a, (bytes, bytearray)):
            a = np.frombuffer(a, np.uint8).copy()
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(device=dev, dtype=dtype)

    def call(comp, lit, lsrc, ml, off, ns, hist=None):
        c = tensor(comp, torch.uint8).reshape(-1)
        if c.shape[0] < ccap:
            c = torch.nn.functional.pad(c, (0, ccap - c.shape[0]))
        tabs = [tensor(a, torch.int32).reshape(1, -1)
                for a in (lit, lsrc, ml, off)]
        if any(t.shape[1] != nseq_cap for t in tabs):
            raise TypeError(f"the sequence columns must be int32[{nseq_cap}]")
        h = zeros if hist is None else tensor(hist, torch.uint8).reshape(-1)
        if h.shape[0] != hcap:
            raise TypeError(f"hist must be uint8[{hcap}]")
        n = torch.tensor([int(ns)], dtype=torch.int32, device=dev)
        out, out_len, ok = decode_blocks(c.reshape(1, -1).contiguous(),
                                         *tabs, n, blk, hists=h)
        if not int(ok[0]):
            raise CorruptedData(
                f"the block decodes to more than its capacity of {blk} "
                "bytes, or its table reaches outside its payload or "
                "history")
        return out[0], out_len[0]
    return call
