"""LZ4 block encoder for the H100, levels 0-9, with its plain PyTorch
version.

Counterpart of ``_encode_block`` in the JAX reference's
``ops/jax_block.py`` at ``deep=0``: the fast finder (``hc=0``, levels
<= 1, with the acceleration knob of ``fast_params``) and the HC finder
(``hc`` 2..9 = the level).  The JAX function builds every stage out of
sorts and packed cummax fills because gathers are slow on a TPU; here
the same semantics are computed by hand-written CUDA kernels
(``kernels/csrc/encode_block.cu``):

* ``enc_match`` (``hc >= 1``) -- window build, the 12-byte grouping
  sort, the +-1..+-hc sorted-neighbour probes, the positional fallback
  sort and its +1/+2 probes.
* ``enc_match_fast`` (``hc == 0``) -- window build, one grouping sort
  by the 4-byte string, probes +1..+probes over ``W`` carried windows.
  Both write one packed candidate word per position,
  ``((cand + 1) << 12) | (fine ml << 6) | back`` (0 = no candidate),
  the same pack the reference unsorts (``jax_block.py:459-466``).
* ``enc_parse_emit`` -- same-offset chain extension, the ``n - 5``
  clamp, two-step lazy deferral (HC only), the greedy parse and the
  emission of the LZ4 sequences.

Each kernel has a plain version in this module
(``match_candidates_plain`` and ``parse_emit_plain``), written with
torch ops and short Python loops.  The wrappers take the plain
version only for tensors on the CPU; for a CUDA tensor they launch
the kernel or raise.
"""

from __future__ import annotations

import torch

from ..constants import compress_bound
from ..kernels import launch

__all__ = ["level_params", "fast_params", "device_encoder_supports",
           "encode_blocks", "encode_blocks_plain", "match_candidates",
           "match_candidates_plain", "parse_emit", "parse_emit_plain"]

#: carried u32 windows (jax_block.py:100) -> fine ml up to 4 + 4*W
_W = 8
#: largest window the kernels take: sort indices are u16 and the
#: window plus its index array must fit one block's shared memory
_MAX_BLK = 65536


def level_params(level: int) -> tuple[int, int]:
    """Map a compression level to (hc probes, deep rank rounds), as
    ``jax_block.level_params`` does (``jax_block.py:1106-1122``)."""
    level = int(level)
    if level <= 1:
        return 0, 0
    if level <= 9:
        return level, 0
    return 8, min(level - 9, 3)


def fast_params(accel: int) -> tuple[int, int]:
    """Map the fast-mode acceleration knob to (W, probes), as
    ``jax_block.fast_params`` does (``jax_block.py:179-197``): fewer
    carried windows and one probe less trade ratio for speed."""
    accel = max(int(accel), 1)
    if accel <= 1:
        return _W, 2
    if accel == 2:
        return 4, 2
    if accel <= 4:
        return 2, 1
    return 1, 1


def _finder(hc: int, deep: int, accel: int) -> tuple[int, int]:
    """(W, fast probes) of a configuration
    (``jax_block.py:1144``); the deep levels are not ported."""
    if deep:
        raise NotImplementedError(
            f"deep={deep}: the rank tiers and price parse of levels "
            "10-12 are not ported yet (ROADMAP Queue 1 item 8)")
    if hc < 0:
        raise ValueError(f"hc={hc}")
    return fast_params(accel) if not hc else (_W, 2)


def device_encoder_supports(blk: int) -> bool:
    """True when ``blk``-byte windows fit the encoder kernels: u16 sort
    indices and one window plus its index array in shared memory
    (65536 * 2 + 65536 + 64 bytes of the 227 KB a block may use)."""
    return 0 < blk <= _MAX_BLK


def _check(blocks: torch.Tensor, lens: torch.Tensor,
           starts: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError("blocks must be uint8[B, blk]")
    if not device_encoder_supports(blocks.shape[1]):
        raise NotImplementedError(
            f"{blocks.shape[1]}-byte windows: the encoder takes windows "
            f"up to {_MAX_BLK} bytes (ROADMAP Queue 1 item 6)")
    for name, t in (("lens", lens), ("starts", starts)):
        if t.dtype != torch.int32 or t.shape != (blocks.shape[0],):
            raise TypeError(f"{name} must be int32[B]")
        if t.device != blocks.device:
            raise ValueError(f"{name} is on {t.device}, blocks on "
                             f"{blocks.device}")


# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------

def _windows(row: torch.Tensor, n: int):
    """(s0, wins[1..8], wb16) of one window as int64 (u32 values):
    jax_block.py:249-267.  Bytes at or past ``n`` read as zero, so a
    configuration with W < 8 uses the first W windows of these."""
    blk = row.shape[0]
    idx = torch.arange(blk, device=row.device)
    b = torch.where(idx < n, row.long(), 0)
    ext = 4 * (_W + 1)
    bp = torch.nn.functional.pad(b, (0, ext + 4))
    su = (bp[:blk + ext] | (bp[1:blk + ext + 1] << 8)
          | (bp[2:blk + ext + 2] << 16) | (bp[3:blk + ext + 3] << 24))
    s0 = torch.where(idx > n - 4, 0xFFFFFFFF, su[:blk])
    wins = [su[4 * k:4 * k + blk] for k in range(1, _W + 1)]
    bb = torch.nn.functional.pad(b, (2, 2))
    wb16 = bb[:blk] | (bb[1:blk + 1] << 8)
    return s0, wins, wb16


def _stable_order(keys) -> torch.Tensor:
    """Positions ordered by ``keys`` (most significant first), ties by
    position: one stable sort per key, least significant first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _probe(shift: int, order, s0, wins, wb16, n: int):
    """cand_at (jax_block.py:379-426) against the sorted row ``shift``
    places earlier (a negative shift looks later), with no wrap.
    Returns (cand, ml, back) per sorted row; cand = -1 when rejected."""
    blk = order.shape[0]
    t = torch.arange(blk, device=order.device)
    u = t - shift
    edge = (u >= 0) & (u < blk)
    u = u.clamp(0, blk - 1)
    p, q = order, order[u]
    ok = (edge & (p <= n - 4) & (q <= n - 4) & (s0[p] == s0[q])
          & (q < p) & (p - q <= 65535))
    ml = torch.full_like(p, 4)
    still = ok
    for wk in wins:
        x = wk[p] ^ wk[q]
        eq = x == 0
        pb = torch.where((x & 0xFF) == 0,
                         torch.where((x & 0xFFFF) == 0,
                                     torch.where((x & 0xFFFFFF) == 0,
                                                 3, 2), 1), 0)
        ml = ml + torch.where(still & eq, 4, 0) \
            + torch.where(still & ~eq, pb, 0)
        still = still & eq
    bx = wb16[p] ^ wb16[q]
    bk = torch.where((bx & 0xFF00) != 0, 0, torch.where(bx != 0, 1, 2))
    return (torch.where(ok, q, -1), torch.where(ok, ml, 0),
            torch.where(ok, bk, 0))


def _pack(cand, ml, back):
    return torch.where(cand >= 0, ((cand + 1) << 12) | (ml << 6) | back, 0)


def _nearest(order, s0, wins, wb16, n: int, probes: int):
    """Probes +1..+probes of an order grouped by ``s0`` alone, where a
    group is in position order: the nearest previous occurrences.  A
    later probe wins only when strictly longer (jax_block.py:433-450,
    :498-504).  Returns the packed candidates in position order."""
    cand, ml, back = _probe(1, order, s0, wins, wb16, n)
    for s in range(2, probes + 1):
        c, m, k = _probe(s, order, s0, wins, wb16, n)
        better = m > ml
        cand = torch.where(better, c, cand)
        ml = torch.where(better, m, ml)
        back = torch.where(better, k, back)
    pk = torch.empty_like(order)
    pk[order] = _pack(cand, ml, back)                 # unsort
    return pk


def _match_one(row: torch.Tensor, n: int, hc: int, W: int,
               probes: int) -> torch.Tensor:
    s0, wins, wb16 = _windows(row, n)
    wins = wins[:W]
    if not hc:
        # fast finder: one grouping sort by s0 (jax_block.py:348-352)
        return _nearest(_stable_order((s0,)), s0, wins, wb16, n,
                        probes).to(torch.int32)

    # 12-byte grouping order, +-1..+-hc probes (jax_block.py:349-450)
    order = _stable_order((s0, wins[0], wins[1]))
    shifts = [s for k in range(1, hc + 1) for s in (k, -k)]
    cand, ml, back = _probe(shifts[0], order, s0, wins, wb16, n)
    for s in shifts[1:]:
        c, m, k = _probe(s, order, s0, wins, wb16, n)
        better = (m > ml) | ((m == ml) & (c > cand))
        cand = torch.where(better, c, cand)
        ml = torch.where(better, m, ml)
        back = torch.where(better, k, back)
    pk = torch.empty_like(order)
    pk[order] = _pack(cand, ml, back)                 # unsort

    # positional fallback: order by s0 alone, probes +1 then +2
    # (jax_block.py:471-516)
    pk2 = _nearest(_stable_order((s0,)), s0, wins, wb16, n, 2)
    fb_better = ((pk2 >> 6) & 63) > ((pk >> 6) & 63)
    return torch.where(fb_better, pk2, pk).to(torch.int32)


def match_candidates_plain(blocks: torch.Tensor, lens: torch.Tensor,
                           hc: int = 9, accel: int = 1) -> torch.Tensor:
    """Plain version of the ``enc_match`` (``hc >= 1``) and
    ``enc_match_fast`` (``hc == 0``) kernels: int32[B, blk] packed
    candidates ``((cand + 1) << 12) | (fine ml << 6) | back``."""
    W, probes = _finder(hc, 0, accel)
    if not blocks.shape[0]:
        return torch.zeros(blocks.shape, dtype=torch.int32,
                           device=blocks.device)
    return torch.stack([_match_one(blocks[i], int(lens[i]), hc, W, probes)
                        for i in range(blocks.shape[0])])


def _parse_one(pk: torch.Tensor, n: int, start: int, capped_ml: int,
               lazy: bool):
    """Chain extension, clamp, lazy deferral (``lazy``: HC only) and
    greedy parse of one window (jax_block.py:522-555, :684-743).  A
    fine ml at or above ``capped_ml`` = 4 + 4 * W saturated the
    windows (``mlf >= max_sort_ml - 3``, :536).  Returns the chosen
    positions and, per position, (ml, off, back)."""
    blk = pk.shape[0]
    idx = torch.arange(blk, device=pk.device)
    pk = pk.long()
    cand = (pk >> 12) - 1
    mlf = (pk >> 6) & 63
    back = pk & 3
    valid = (cand >= 0) & (idx <= n - 13)
    ml = torch.where(valid, mlf, 0)
    off = torch.where(valid, idx - cand, 1 << 20)

    # same-offset chains: a capped row takes its length from the
    # nearest chain boundary at or after it
    capped = valid & (mlf >= capped_ml)
    off_next = torch.cat([off[1:], off.new_full((1,), 1 << 21)])
    valid_next = torch.cat([valid[1:], valid.new_zeros(1)])
    link = capped & valid_next & (off_next == off)
    bnd_at = torch.where(~link, idx, blk)
    nb = torch.flip(torch.cummin(torch.flip(bnd_at, (0,)), 0).values, (0,))
    bml = torch.minimum(ml[nb], torch.tensor(2047, device=pk.device))
    ml = torch.where(capped, torch.maximum((nb - idx) + bml, ml), ml)
    ml = torch.minimum(ml, (n - 5 - idx).clamp(min=0))
    is_match = valid & (ml >= 4) & (idx >= start)

    if lazy:
        is_match = is_match & ~_lazy_defer(ml, is_match)

    # greedy parse: the lowest match position not yet covered
    ml_l = ml.tolist()
    chosen = []
    end = 0
    for p in torch.nonzero(is_match).flatten().tolist():
        if p >= end:
            chosen.append(p)
            end = p + ml_l[p]
    return chosen, ml_l, off.tolist(), back.tolist()


def _lazy_defer(ml: torch.Tensor, is_match: torch.Tensor) -> torch.Tensor:
    """Two-step lazy deferral (jax_block.py:684-710): rows that give
    way to a strictly more profitable match at +1 or +2."""
    def sh(x, k):
        return torch.cat([x[k:], x.new_zeros(k)])

    ml1, im1 = sh(ml, 1), sh(is_match, 1)
    ml2, im2 = sh(ml, 2), sh(is_match, 2)
    g1 = im1 & (ml1 > ml + 1)
    g2 = im2 & (ml2 > ml + 2)
    d0 = g1 | g2
    d0_1, d0_2 = sh(d0, 1), sh(d0, 2)
    return is_match & ((g1 & ~d0_1) | (g2 & ~d0_2 & (d0_1 | ~im1)))


def _put_len(out: bytearray, v: int) -> None:
    """LZ4 length continuation bytes for a field whose token nibble
    saturated (v = length - 15)."""
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def _emit_one(data: bytes, n: int, start: int, chosen, ml, off,
              back) -> bytes:
    """The LZ4 sequences of one window (jax_block.py:871-1103):
    chosen selections that continue each other at one offset merge
    into one match, each head extends back over up to ``back``
    literals, then the tail literal run."""
    if n == start:
        return b""
    seqs = []                   # [lit start, match start, off, end]
    last_e = -1
    for p in chosen:
        e, o = p + ml[p], off[p]
        if seqs and last_e == p and seqs[-1][2] == o:
            seqs[-1][3] = e
        else:
            prev_end = max(last_e, start)
            bq = max(min(back[p], p - prev_end, p - o), 0)
            seqs.append([prev_end, p - bq, o, e])
        last_e = e
    out = bytearray()
    for ls, ms, o, e in seqs:
        lit, mml = ms - ls, e - ms
        out.append((min(lit, 15) << 4) | min(mml - 4, 15))
        if lit >= 15:
            _put_len(out, lit - 15)
        out += data[ls:ms]
        out += bytes((o & 0xFF, o >> 8))
        if mml - 4 >= 15:
            _put_len(out, mml - 19)
    tail = max(last_e, start)
    lit = n - tail
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        _put_len(out, lit - 15)
    out += data[tail:n]
    return bytes(out)


def parse_emit_plain(blocks: torch.Tensor, lens: torch.Tensor,
                     starts: torch.Tensor, pk: torch.Tensor,
                     hc: int = 9, accel: int = 1):
    """Plain version of the ``enc_parse_emit`` kernel: (out
    uint8[B, compress_bound(blk)], zero past out_len; out_len
    int32[B])."""
    W, _probes = _finder(hc, 0, accel)
    B, blk = blocks.shape
    cap = compress_bound(blk)
    out = torch.zeros((B, cap), dtype=torch.uint8)
    out_len = torch.zeros(B, dtype=torch.int32)
    rows = blocks.cpu().numpy()
    for i in range(B):
        n, start = int(lens[i]), int(starts[i])
        chosen, ml, off, back = _parse_one(pk[i], n, start, 4 + 4 * W,
                                           hc > 0)
        comp = _emit_one(rows[i].tobytes(), n, start, chosen, ml, off,
                         back)
        if comp:
            out[i, :len(comp)] = torch.frombuffer(bytearray(comp),
                                                  dtype=torch.uint8)
        out_len[i] = len(comp)
    return out.to(blocks.device), out_len.to(blocks.device)


def encode_blocks_plain(blocks: torch.Tensor, lens: torch.Tensor,
                        starts: torch.Tensor | None = None,
                        hc: int = 9, deep: int = 0, accel: int = 1):
    """Plain encode of uint8[B, blk] windows: (out
    uint8[B, compress_bound(blk)], out_len int32[B])."""
    _finder(hc, deep, accel)
    if starts is None:
        starts = torch.zeros_like(lens)
    _check(blocks, lens, starts)
    pk = match_candidates_plain(blocks, lens, hc, accel)
    return parse_emit_plain(blocks, lens, starts, pk, hc, accel)


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def match_candidates(blocks: torch.Tensor, lens: torch.Tensor,
                     hc: int = 9, accel: int = 1) -> torch.Tensor:
    """Packed candidates per position; for CUDA tensors the
    ``enc_match`` kernel (``hc >= 1``) or the ``enc_match_fast`` kernel
    (``hc == 0``, with ``fast_params(accel)``), the plain version for
    CPU tensors."""
    if blocks.device.type == "cpu":
        return match_candidates_plain(blocks, lens, hc, accel)
    W, probes = _finder(hc, 0, accel)
    blocks, lens = blocks.contiguous(), lens.contiguous()
    B, blk = blocks.shape
    pk = torch.empty((B, blk), dtype=torch.int32, device=blocks.device)
    if B and hc:
        launch("enc_match", blocks, lens, pk, B, blk, hc)
    elif B:
        launch("enc_match_fast", blocks, lens, pk, B, blk, W, probes)
    return pk


def parse_emit(blocks: torch.Tensor, lens: torch.Tensor,
               starts: torch.Tensor, pk: torch.Tensor,
               hc: int = 9, accel: int = 1):
    """Parse and emission; the ``enc_parse_emit`` kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if blocks.device.type == "cpu":
        return parse_emit_plain(blocks, lens, starts, pk, hc, accel)
    W, _probes = _finder(hc, 0, accel)
    B, blk = blocks.shape
    if pk.shape != (B, blk) or pk.dtype != torch.int32:
        raise TypeError("pk must be int32[B, blk]")
    blocks, lens, starts, pk = (t.contiguous() for t in
                                (blocks, lens, starts, pk))
    cap = compress_bound(blk)
    dev = blocks.device
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    # per position: final ml with the is_match bit; per window: the
    # literal runs (src, dst, len) the parse records for the copy
    mlw = torch.empty((B, blk), dtype=torch.int32, device=dev)
    # (a window has at most blk // 4 matches, so blk // 4 + 1 runs)
    runs = torch.empty((B, 3 * (blk // 4 + 2)), dtype=torch.int32,
                       device=dev)
    if B:
        launch("enc_parse_emit", blocks, lens, starts, pk, mlw, runs,
               out, out_len, B, blk, cap, runs.shape[1], 4 + 4 * W,
               int(hc > 0))
    return out, out_len


def encode_blocks(blocks: torch.Tensor, lens: torch.Tensor,
                  starts: torch.Tensor | None = None,
                  hc: int = 9, deep: int = 0, accel: int = 1):
    """Encode uint8[B, blk] windows with valid lengths ``lens`` and
    emission starts ``starts`` (default 0), counterpart of
    ``encode_blocks_jax(..., hc, deep, accel)`` (the defaults here are
    level 9).  Returns (out uint8[B, compress_bound(blk)], zero past
    out_len; out_len int32[B])."""
    _finder(hc, deep, accel)
    if starts is None:
        starts = torch.zeros_like(lens)
    _check(blocks, lens, starts)
    pk = match_candidates(blocks, lens, hc, accel)
    return parse_emit(blocks, lens, starts, pk, hc, accel)
