"""T-map rebuilds for the H100, with their plain PyTorch versions.

Counterpart of the T-map decoders of the JAX reference
(``ops/jax_decode.py:1033-1149``).

* Independent blocks (``device_tmap_decoder_supports``,
  ``_decode_block_tmap`` and its batched form, ``:1033-1081``): the host
  resolver (``native_resolve_tmap``) maps every output byte to the
  fetch-buffer byte it equals, so a block is rebuilt by one gather:
  ``out[b, j] = fetch[b, clip(T[b, j], 0, F - 1)]`` for
  ``j < out_len[b]``, else 0.  The CUDA kernel is
  ``kernels/csrc/tmap_gather.cu``.
* Linked frames (``_linked_tmap_step`` over ``_decode_flat_fetch``,
  ``:1084-1143``): a window of blocks is rebuilt by one flat gather
  from ``[history | payloads]`` by the global T-map of
  ``native_resolve_tmap_linked``, and the last ``H`` bytes of
  ``[history | output]`` become the next window's history, so the
  windows of a frame chain on the device.  The CUDA kernels are in
  ``kernels/csrc/linked_tmap.cu``.
"""

from __future__ import annotations

import torch

from ..kernels import launch

__all__ = ["device_tmap_decoder_supports", "decode_blocks_tmap",
           "decode_blocks_tmap_plain", "linked_tmap_step",
           "linked_tmap_step_plain"]


def device_tmap_decoder_supports(blk: int,
                                 fetch_cap: int | None = None) -> bool:
    """True when the gather covers this (block, fetch buffer) geometry.
    Unlike the TPU merge, whose 9-bit byte pack caps the fetch buffer
    (``jax_decode.py:1033-1040``), a gather only needs int32 T entries
    and grid rows, so every frame block size qualifies."""
    return 0 < blk < 2 ** 31 and (fetch_cap is None
                                  or 0 < fetch_cap < 2 ** 31)


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
    """Plain version of the ``linked_tmap_step`` and
    ``linked_hist_shift`` kernels: (out uint8[NOUT], new_hist
    uint8[H])."""
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
    tensor, ``hist`` is left as it was).  The ``linked_tmap_step`` and
    ``linked_hist_shift`` kernels for CUDA tensors, the plain version
    for CPU tensors.  Rows of T at or past ``total`` are never read."""
    if hist.device.type == "cpu":
        return linked_tmap_step_plain(hist, payloads, T, total)
    _check_linked(hist, payloads, T, total)
    hist, payloads, T = hist.contiguous(), payloads.contiguous(), \
        T.contiguous()
    H, nout = hist.shape[0], T.shape[0]
    out = torch.empty(nout, dtype=torch.uint8, device=T.device)
    new_hist = torch.empty_like(hist)
    launch("linked_tmap_step", hist, payloads, T, out, H,
           payloads.shape[0], nout, total)
    launch("linked_hist_shift", hist, out, new_hist, H, nout, total)
    return out, new_hist
