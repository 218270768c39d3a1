"""LZ4 block encoder for the H100, levels 0-12, with its plain PyTorch
version.

Counterpart of ``_encode_block`` in the JAX reference's
``ops/jax_block.py``: the fast finder (``hc=0``, levels <= 1, with the
acceleration knob of ``fast_params``), the HC finder (``hc`` 2..9 = the
level) and the deep levels 10-12 (``hc=8``, ``deep`` 1..3: exact rank
tiers, a price-aware parse, exact extension of capped matches).  The
JAX function builds every stage out of sorts and packed cummax fills
because gathers are slow on a TPU; here the same semantics are
computed by hand-written CUDA kernels (``kernels/csrc/encode_block.cu``
and, for the deep levels, ``kernels/csrc/encode_deep.cu``):

* ``enc_match`` (``hc >= 1``) -- window build, the 12-byte grouping
  sort, the +-1..+-hc sorted-neighbour probes, the positional fallback
  sort and its +1/+2 probes.  Both sorts are stable byte-digit radix
  passes (``kernels/csrc/sort_radix.cuh``), 12 and 4 of them.
* ``enc_match_fast`` (``hc == 0``) -- window build, one grouping sort
  by the 4-byte string (the 4 byte passes of ``enc_match``'s fallback),
  probes +1..+probes over ``W`` carried windows.
  Both write one packed candidate word per position,
  ``((cand + 1) << 12) | (fine ml << 6) | back`` (0 = no candidate),
  the same pack the reference unsorts (``jax_block.py:459-466``).
  Both hold the window and a u16 order in shared memory, so they take
  windows up to 64 KB.
* ``enc_match_wide`` (``kernels/csrc/encode_wide.cu``) -- either finder
  for the windows over 64 KB that the reference encodes on its device
  (``device_encoder_supports``): ``[dictionary | block]`` windows, 256 KB
  blocks and the 327,680-byte sub-span windows of 1 MB and 4 MB blocks.
  One thread-block cluster a window (``wide_cluster_shape``, or up to 16
  CTAs where the launch holds few windows: ``wide_spread_shape``) holds
  its u32 position order in shared memory, sorted by stable byte-digit
  radix passes across the cluster; the window words live in device
  scratch.
* ``enc_parse_emit`` -- same-offset chain extension, the ``n - 5``
  clamp, two-step lazy deferral (HC only), the greedy parse (one thread,
  reading lengths staged in shared memory) and the emission of the LZ4
  sequences, placed by block scans over the chosen rows.  A launch of
  few windows spreads each window over a thread-block cluster of up to
  16 CTAs (``parse_spread_shape``; ``kernels/csrc/parse_cluster.cuh``):
  the same phases split by rows, the walk as one speculative path a
  slice joined by a fix-up.
* ``enc_deep_match`` (``deep`` 1..3) -- the finder of the deep levels:
  exact 32-byte ranks (and 256-byte ranks at ``deep=3``), the grand
  grouping sort by the deepest tier operands, +-1..+-hc probes with
  nested tier lengths, then the positional fallback; its orders are
  stable byte radix sorts in one block's shared memory, as
  ``enc_match``'s, two passes a rank key.  The pack gains a
  4-bit tier field: ``((cand + 1) << 12) | (fine ml << 6) | (tier << 2)
  | back`` (``jax_block.py:459-461``).
* ``enc_deep_match_wide`` (``kernels/csrc/encode_deep_wide.cu``) -- the
  same finder for the windows over 64 KB, its order in a cluster as
  ``enc_match_wide`` keeps it, its ranks sorted by radix passes too and
  numbered by a scan across the cluster.
* ``enc_deep_dp`` -- chain extension with the tier lengths, then the
  backward price parse with the 18-byte cut (``run_dp``,
  ``jax_block.py:556-683``), relaxed as the reference does in chunks of
  32 positions, one warp a window and a position a lane: per position
  the final length, the ``take`` bit and the capped-end bit.
* ``enc_deep_emit`` -- the greedy parse over ``take`` (the walk of
  ``enc_parse_emit``), the pooled exact extension of capped chosen ends
  and the absorb (``jax_block.py:748-863``; 512 pooled rows per 64 KB of
  window), tile by tile over the chosen rows with block scans for the
  pool rank, the running cover and the compaction, then the same
  emission as ``enc_parse_emit``.

Every level takes every window that ``device_encoder_supports`` takes.
Each kernel has a plain version in this module
(``match_candidates_plain``, ``parse_emit_plain`` and, for the two
halves of the deep parse, ``deep_dp_plain`` and ``deep_emit_plain``),
written with torch ops and short Python loops.  The wrappers take the plain
version only for tensors on the CPU; for a CUDA tensor they launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import trace
from ..constants import compress_bound
from ..kernels import launch, library

__all__ = ["level_params", "fast_params", "device_encoder_supports",
           "encode_blocks", "encode_blocks_plain", "match_candidates",
           "match_candidates_plain", "parse_emit", "parse_emit_plain",
           "deep_dp", "deep_dp_plain", "deep_emit", "deep_emit_plain",
           "tier_lengths", "wide_cluster_shape", "wide_spread_shape",
           "wide_launch_shape", "parse_spread_shape",
           "hc_probes", "make_block_encoder", "make_block_decoder",
           "decode_blocks", "parse_sequences", "seqs_to_arrays",
           "MAX_SEQS"]

#: carried u32 windows (jax_block.py:100) -> fine ml up to 4 + 4*W
_W = 8
#: largest window of the shared-memory finders (u16 sort indices; the
#: window and its order fill 196 KB of shared memory at 64 KB); wider
#: windows go to ``enc_match_wide`` and ``enc_deep_match_wide``
_MAX_SHARED_BLK = 65536
#: a launch group of sub-span windows runs at the least multiple of
#: _FIT_STEP at least _FIT_PAD bytes past its longest window, and at
#: least _FIT_MIN, the first such multiple past the shared-memory
#: finders' windows, so the group stays on the wide finder (``_sub_width``)
_FIT_STEP = 4096
_FIT_PAD = 16
_FIT_MIN = _MAX_SHARED_BLK + _FIT_STEP
#: the candidate pack ((cand + 1) << 12) | ... fits int32 only while
#: cand + 1 < 2^19 (jax_block.py:458)
_PACK_LIMIT = 1 << 19
#: price parse: cost ring size, so jumps are priced at min(ml, 512);
#: cost scale and the cost of one literal (jax_block.py:136-141, :577)
_DP_R = 512
_DP_SCALE = 256
#: extension of capped chosen ends: bytes measured and rows pooled per
#: 64 KB of window (jax_block.py: _EXT_BYTES, _EXT_POOL)
_EXT_BYTES = 32
_EXT_POOL = 512


def level_params(level: int) -> tuple[int, int]:
    """Map a compression level to (hc probes, deep rank rounds), as
    ``jax_block.level_params`` does (``jax_block.py:1106-1122``)."""
    level = int(level)
    if level <= 1:
        return 0, 0
    if level <= 9:
        return level, 0
    return 8, min(level - 9, 3)


def hc_probes(level: int) -> int:
    """The probe depth of a level alone (``jax_block.py:1125-1127``)."""
    return level_params(level)[0]


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


def tier_lengths(deep: int) -> list[int]:
    """Match length each rank tier of a deep configuration proves, by
    tier index (``jax_block.py:307-321``): 32-byte steps over the
    32-byte rank, then at ``deep=3`` 256-byte steps over the 256-byte
    rank.  Tier ``t`` of the pack is ``tier_lengths(deep)[t - 1]``."""
    if not deep:
        return []
    if deep == 1:
        return [32 * (k + 1) for k in range(4)]
    if deep == 2:
        return [32 * (k + 1) for k in range(8)]
    return [32 * (k + 1) for k in range(7)] + [256 * (k + 1)
                                               for k in range(4)]


def _finder(hc: int, deep: int, accel: int) -> tuple[int, int]:
    """(W, fast probes) of a configuration (``jax_block.py:1144``)."""
    if hc < 0:
        raise ValueError(f"hc={hc}")
    if deep:
        if not 1 <= deep <= 3 or not hc:
            raise ValueError(f"deep={deep} with hc={hc}: the deep levels "
                             "take deep 1..3 over the HC finder")
    W, probes = fast_params(accel) if not hc else (_W, 2)
    # the 32-byte rank reads s0 and seven carried windows
    # (jax_block.py:306)
    assert not deep or W >= 7, "the deep ranks need W >= 7"
    return W, probes


def _bits(v: int) -> int:
    return max(int(v).bit_length(), 1)


def device_encoder_supports(blk: int) -> bool:
    """True when the reference encodes ``blk``-byte windows on its
    device, which this port does too: the reference's predicate on its
    emission packs (``jax_block.py:160-169``), true through the
    327,680-byte sub-span windows and false at 512 KB.  Within it
    ``blk < 2^19``, so the candidate pack fits int32."""
    cap_bits = _bits(compress_bound(blk) + 2)
    return (blk > 0 and cap_bits + 9 <= 31
            and cap_bits - 9 <= 31 - _bits(blk)
            and _bits(max(blk // 255 + 8, 8) + 2) + cap_bits <= 31)


def _check_pack_width(blk: int) -> None:
    if blk >= _PACK_LIMIT:
        raise NotImplementedError(f"{blk}-byte windows: the candidate pack "
                                  f"takes fewer than {_PACK_LIMIT}")


def _check(blocks: torch.Tensor, lens: torch.Tensor,
           starts: torch.Tensor) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError("blocks must be uint8[B, blk]")
    blk = blocks.shape[1]
    if not device_encoder_supports(blk):
        raise NotImplementedError(
            f"{blk}-byte windows: the encoder takes the windows the "
            "reference encodes on its device (device_encoder_supports); "
            "frame blocks over 256 KB encode as 327,680-byte sub-span "
            "windows (parallel/sharded.py)")
    assert blk < _PACK_LIMIT
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


def _sorted_env(order, s0, wins, wb16, tiers=()):
    """The probe operands in the sorted order ``order``: s0, the carried
    windows as one [W, blk] tensor, wb16 and the tier operands."""
    # the window words only meet in XORs and equalities, which int32
    # keeps bit for bit
    return (order, s0[order],
            torch.stack([wk[order] for wk in wins]).to(torch.int32),
            wb16[order], [(L, op[order]) for L, op in tiers])


def _probe(shift: int, env, n: int):
    """cand_at (jax_block.py:379-426) against the sorted row ``shift``
    places earlier (a negative shift looks later), with no wrap, over
    ``env`` = ``_sorted_env(...)``.  The fine length is 4, plus 4 for
    each carried window equal from the first on, plus the equal low
    bytes of the first window that differs.  Tiers are nested: a tier
    counts only while every shallower one matched, and proves ``L``
    equal bytes.  Returns (cand, total ml, fine ml, tier, back) per
    sorted row; cand = -1 when rejected."""
    order, s0s, ws, wbs, tiers_s = env
    blk = order.shape[0]
    t = torch.arange(blk, device=order.device)
    edge = (t >= shift) if shift > 0 else (t < blk + shift)

    def nb(x):              # x at the sorted row ``shift`` places earlier
        return torch.roll(x, shift, -1)

    p, q = order, nb(order)
    ok = (edge & (p <= n - 4) & (q <= n - 4) & (s0s == nb(s0s))
          & (q < p) & (p - q <= 65535))
    x = ws ^ nb(ws)
    still = torch.ones_like(ok)
    lead = torch.zeros_like(p)          # windows equal from the first on
    for xk in x:
        still = still & (xk == 0)
        lead = lead + still
    xf = x.gather(0, lead.clamp(max=x.shape[0] - 1)[None])[0]
    pb = torch.where((xf & 0xFF) == 0,
                     torch.where((xf & 0xFFFF) == 0,
                                 torch.where((xf & 0xFFFFFF) == 0, 3, 2), 1),
                     0)
    ml = 4 + 4 * lead + torch.where(lead < x.shape[0], pb, 0)
    tier = torch.zeros_like(p)
    dml = torch.zeros_like(p)
    still_t = ok
    for tk, (L, op) in enumerate(tiers_s):
        still_t = still_t & (op == nb(op))
        tier = torch.where(still_t, tk + 1, tier)
        dml = torch.where(still_t, L, dml)
    bx = wbs ^ nb(wbs)
    bk = torch.where((bx & 0xFF00) != 0, 0, torch.where(bx != 0, 1, 2))
    return (torch.where(ok, q, -1), torch.where(ok, torch.maximum(ml, dml), 0),
            torch.where(ok, ml, 0), tier, torch.where(ok, bk, 0))


def _pack(cand, mlf, back, tier=0):
    return torch.where(cand >= 0, ((cand + 1) << 12) | (mlf << 6)
                       | (tier << 2) | back, 0)


def _shl(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[i + k], -1 past the end (jax_block.py:277-283).  The equal
    fills make tail rows look alike; the reference keeps that, and so
    does this."""
    if k >= x.shape[0]:
        return torch.full_like(x, -1)
    return torch.cat([x[k:], x.new_full((k,), -1)])


def _ranks(keys) -> torch.Tensor:
    """Exact rank of each position under the order of ``keys``: equal
    key tuples share a rank, ranks count from 1 in key order
    (``ranksN``, jax_block.py:285-296)."""
    order = _stable_order(keys)
    newg = torch.zeros_like(order, dtype=torch.bool)
    for k in keys:
        ks = k[order]
        newg[1:] |= ks[1:] != ks[:-1]
    newg[0] = True
    r = torch.empty_like(order)
    r[order] = torch.cumsum(newg.long(), 0)
    return r


def _rank_tiers(s0, wins, deep: int):
    """([(L, operand)] nested, number of grouping keys) of a deep
    configuration (jax_block.py:306-322)."""
    r = _ranks((s0,) + tuple(wins[:7]))               # 32-byte rank
    n32 = {1: 4, 2: 8, 3: 7}[deep]
    ops = [_shl(r, 32 * k) for k in range(n32)]
    if deep == 3:
        r2 = _ranks(tuple(ops) + (_shl(r, 224),))     # 256-byte rank
        ops += [_shl(r2, 256 * k) for k in range(4)]
    return list(zip(tier_lengths(deep), ops)), (8 if deep == 2 else 4)


def _nearest(order, s0, wins, wb16, n: int, probes: int):
    """Probes +1..+probes of an order grouped by ``s0`` alone, where a
    group is in position order: the nearest previous occurrences.  A
    later probe wins only when strictly longer (jax_block.py:433-450,
    :498-504).  Returns the packed candidates in position order."""
    env = _sorted_env(order, s0, wins, wb16)
    cand, ml, _mf, _t, back = _probe(1, env, n)
    for s in range(2, probes + 1):
        c, m, _mf, _t, k = _probe(s, env, n)
        better = m > ml
        cand = torch.where(better, c, cand)
        ml = torch.where(better, m, ml)
        back = torch.where(better, k, back)
    pk = torch.empty_like(order)
    pk[order] = _pack(cand, ml, back)                 # unsort
    return pk


def _match_one(row: torch.Tensor, n: int, hc: int, W: int,
               probes: int, deep: int = 0) -> torch.Tensor:
    s0, wins, wb16 = _windows(row, n)
    wins = wins[:W]
    if not hc:
        # fast finder: one grouping sort by s0 (jax_block.py:348-352)
        return _nearest(_stable_order((s0,)), s0, wins, wb16, n,
                        probes).to(torch.int32)

    if deep:
        # grand order by the deepest NK tier operands; the shallower
        # tiers ride along (jax_block.py:322, :341-346)
        tiers, nk = _rank_tiers(s0, wins, deep)
        order = _stable_order(tuple(op for _L, op in tiers[-nk:]))
    else:
        # 12-byte grouping order (jax_block.py:349-350)
        tiers = []
        order = _stable_order((s0, wins[0], wins[1]))
    # +-1..+-hc probes; ties on the total length go to the larger
    # (nearer) candidate (jax_block.py:432-450)
    shifts = [s for k in range(1, hc + 1) for s in (k, -k)]
    env = _sorted_env(order, s0, wins, wb16, tiers)
    cand, ml, mlf, tier, back = _probe(shifts[0], env, n)
    for s in shifts[1:]:
        c, m, mf, t, k = _probe(s, env, n)
        better = (m > ml) | ((m == ml) & (c > cand))
        cand = torch.where(better, c, cand)
        ml = torch.where(better, m, ml)
        mlf = torch.where(better, mf, mlf)
        tier = torch.where(better, t, tier)
        back = torch.where(better, k, back)
    pk = torch.empty_like(order)
    pk[order] = _pack(cand, mlf, back, tier)          # unsort
    ml_u = torch.empty_like(order)
    ml_u[order] = ml

    # positional fallback: order by s0 alone, probes +1 then +2; it
    # wins when its fine length beats the total length, and then the
    # tier is cleared (jax_block.py:471-516)
    pk2 = _nearest(_stable_order((s0,)), s0, wins, wb16, n, 2)
    fb_better = ((pk2 >> 6) & 63) > ml_u
    return torch.where(fb_better, pk2, pk).to(torch.int32)


def match_candidates_plain(blocks: torch.Tensor, lens: torch.Tensor,
                           hc: int = 9, accel: int = 1,
                           deep: int = 0) -> torch.Tensor:
    """Plain version of the ``enc_match`` (``hc >= 1``),
    ``enc_match_fast`` (``hc == 0``) and ``enc_deep_match`` (``deep``
    1..3) kernels: int32[B, blk] packed candidates ``((cand + 1) << 12)
    | (fine ml << 6) | (tier << 2) | back``."""
    W, probes = _finder(hc, deep, accel)
    if not blocks.shape[0]:
        return torch.zeros(blocks.shape, dtype=torch.int32,
                           device=blocks.device)
    return torch.stack([_match_one(blocks[i], int(lens[i]), hc, W, probes,
                                   deep)
                        for i in range(blocks.shape[0])])


def _chain_lengths(pk: torch.Tensor, n: int, start: int, capped_ml: int,
                   tiers=()):
    """Per position (ml, off, back, is_match, cap_end) after the
    same-offset chain extension and the ``n - 5`` clamp
    (jax_block.py:522-555).  A fine ml at or above ``capped_ml`` =
    4 + 4 * W saturated the windows (``mlf >= max_sort_ml - 3``, :536);
    at the deep levels the pack's tier field gives ``ml = max(fine ml,
    tiers[tier - 1])`` (:467-469) and a length that came from a tier is
    capped too.  ``cap_end``: the row's chain ends at a capped row, so
    its length may still fall short."""
    blk = pk.shape[0]
    idx = torch.arange(blk, device=pk.device)
    pk = pk.long()
    cand = (pk >> 12) - 1
    mlf = (pk >> 6) & 63
    tier = (pk >> 2) & 15
    back = pk & 3
    ml = mlf
    for tk, L in enumerate(tiers):
        ml = torch.where(tier == tk + 1, mlf.clamp(min=L), ml)
    valid = (cand >= 0) & (idx <= n - 13)
    mlf = torch.where(valid, mlf, 0)
    ml = torch.where(valid, ml, 0)
    off = torch.where(valid, idx - cand, 1 << 20)

    # same-offset chains: a capped row takes its length from the
    # nearest chain boundary at or after it
    capped = valid & ((mlf >= capped_ml) | (ml > mlf))
    off_next = torch.cat([off[1:], off.new_full((1,), 1 << 21)])
    valid_next = torch.cat([valid[1:], valid.new_zeros(1)])
    link = capped & valid_next & (off_next == off)
    bnd_at = torch.where(~link, idx, blk)
    nb = torch.flip(torch.cummin(torch.flip(bnd_at, (0,)), 0).values, (0,))
    bml = torch.minimum(ml[nb], torch.tensor(2047, device=pk.device))
    cap_end = valid & capped[nb]
    ml = torch.where(capped, torch.maximum((nb - idx) + bml, ml), ml)
    ml = torch.minimum(ml, (n - 5 - idx).clamp(min=0))
    is_match = valid & (ml >= 4) & (idx >= start)
    return ml, off, back, is_match, cap_end


def _greedy(is_match: torch.Tensor, ml_l: list) -> list:
    """Greedy parse (jax_block.py:716-743): the lowest match position
    not yet covered, again and again."""
    chosen = []
    end = 0
    for p in torch.nonzero(is_match).flatten().tolist():
        if p >= end:
            chosen.append(p)
            end = p + ml_l[p]
    return chosen


def _parse_one(pk: torch.Tensor, n: int, start: int, capped_ml: int,
               lazy: bool):
    """Chain extension, clamp, lazy deferral (``lazy``: HC only) and
    greedy parse of one window at ``deep=0`` (jax_block.py:522-555,
    :684-743).  Returns the chosen positions and, per position, (ml,
    off, back)."""
    ml, off, back, is_match, _cap_end = _chain_lengths(pk, n, start,
                                                       capped_ml)
    if lazy:
        is_match = is_match & ~_lazy_defer(ml, is_match)
    ml_l = ml.tolist()
    return _greedy(is_match, ml_l), ml_l, off.tolist(), back.tolist()


#: fields of the deep parse's state word beside the length
_TAKE_BIT = 1 << 30
_CAPEND_BIT = 1 << 29
_ML_MASK = (1 << 20) - 1


def _deep_dp_one(pk: torch.Tensor, n: int, start: int, capped_ml: int,
                 deep: int) -> torch.Tensor:
    """State word per position of one window after the price parse
    (``run_dp``, jax_block.py:556-683): ``ml | take << 30 | cap_end <<
    29``.  The reference relaxes 32-position chunks to the fixpoint of
    ``cost[i] = min(LITC + cost[i + 1], price[i] + cost[i + jmp[i]],
    3 * 256 + cost[i + 18])`` with ``cost = 0`` past the window; this
    is that recurrence, run backwards."""
    ml, _off, _back, is_match, cap_end = _chain_lengths(
        pk, n, start, capped_ml, tier_lengths(deep))
    blk = pk.shape[0]
    R, S = min(_DP_R, blk), _DP_SCALE
    ml_l, im_l = ml.tolist(), is_match.tolist()
    cost = [0] * (blk + R + 1)
    take = [False] * blk
    cut = [False] * blk
    for i in range(blk - 1, -1, -1):
        lit = S + cost[i + 1]
        if not im_l[i]:
            cost[i] = lit
            continue
        jmp = min(ml_l[i], R)
        esc = 1 + max(jmp - 19, 0) // 255 if jmp - 4 >= 15 else 0
        best = S * (3 + esc) + cost[i + jmp]
        if R >= 18 and jmp > 18:
            a_tr = 3 * S + cost[i + 18]
            if a_tr < best:             # the 18-byte cut, strictly cheaper
                cut[i] = True
                best = a_tr
        take[i] = best <= lit           # ties go to the match
        cost[i] = min(best, lit)
    dev = pk.device
    cut_t = torch.tensor(cut, device=dev)
    ml = torch.where(cut_t, ml.clamp(max=18), ml)
    cap_end = cap_end & ~cut_t
    st = (ml | torch.where(torch.tensor(take, device=dev), _TAKE_BIT, 0)
          | torch.where(cap_end, _CAPEND_BIT, 0))
    return st.to(torch.int32)


def _deep_select_one(row: torch.Tensor, pk: torch.Tensor, st: torch.Tensor,
                     n: int):
    """Greedy parse over the ``take`` bits, exact extension of the
    capped chosen ends and the one-pass absorb (jax_block.py:716-743,
    :748-863).  Returns the chosen positions and, per position, (ml,
    off, back)."""
    blk = pk.shape[0]
    dev = pk.device
    idx = torch.arange(blk, device=dev)
    pk, st = pk.long(), st.long()
    ml = st & _ML_MASK
    cap_end = (st & _CAPEND_BIT) != 0
    cand = (pk >> 12) - 1
    valid = (cand >= 0) & (idx <= n - 13)
    off = torch.where(valid, idx - cand, 1 << 20)
    back = pk & 3
    ml_l = ml.tolist()
    chosen_l = _greedy((st & _TAKE_BIT) != 0, ml_l)
    chosen = torch.zeros(blk, dtype=torch.bool, device=dev)
    chosen[chosen_l] = True

    # exact extension: the first P capped chosen ends by position, up
    # to 32 bytes each, two rounds of four u32 compares at the match's
    # own offset; word indices clip to the window (jax_block.py:774-819)
    P = min(_EXT_POOL * max(blk // 65536, 1), blk)
    b = torch.where(idx < n, row.long(), 0)
    bp = torch.nn.functional.pad(b, (0, 3))
    su = bp[:blk] | (bp[1:blk + 1] << 8) | (bp[2:blk + 2] << 16) \
        | (bp[3:blk + 3] << 24)
    i_p = torch.nonzero(chosen & cap_end).flatten()[:P]
    E_p = i_p + ml[i_p]
    off_p = off[i_p]
    cap_p = (n - 5 - E_p).clamp(0, _EXT_BYTES)
    e_p = torch.zeros_like(i_p)
    alive = cap_p > 0
    offs4 = torch.arange(0, 16, 4, device=dev)
    for _ in range(max(_EXT_BYTES // 16, 1)):
        base = E_p + e_p
        ia = (base[:, None] + offs4).clamp(0, blk - 1)
        ib = ((base - off_p)[:, None] + offs4).clamp(0, blk - 1)
        x = su[ia] ^ su[ib]
        eq = x == 0
        pb = torch.where((x & 0xFF) == 0,
                         torch.where((x & 0xFFFF) == 0,
                                     torch.where((x & 0xFFFFFF) == 0,
                                                 3, 2), 1), 0)
        adv = torch.zeros_like(i_p)
        still = torch.ones_like(alive)
        for w in range(4):
            adv = adv + torch.where(still, torch.where(eq[:, w], 4,
                                                       pb[:, w]), 0)
            still = still & eq[:, w]
        adv = torch.where(alive, torch.minimum(adv, cap_p - e_p), 0)
        e_p = e_p + adv
        alive = alive & still & (e_p < cap_p)
    ml = ml.clone()
    ml[i_p] += e_p

    # one-pass absorb: a chosen match that the extended ends before it
    # cover is dropped, or moved to its trimmed start when 4 bytes or
    # more remain; only the first P moved matches are re-inserted
    # (jax_block.py:838-863)
    Ev = idx + ml
    fC = torch.cummax(torch.where(chosen, Ev, 0), 0).values
    prevcov = torch.cat([fC.new_zeros(1), fC[:-1]])
    keep = chosen & (Ev - torch.maximum(idx, prevcov) >= 4)
    moved = keep & (prevcov > idx)
    chosen = keep & ~moved
    m_i = torch.nonzero(moved).flatten()[:P]
    tgt, Em, offm = prevcov[m_i], Ev[m_i], off[m_i]
    off, back = off.clone(), back.clone()
    chosen[tgt] = True
    ml[tgt] = Em - tgt
    off[tgt] = offm
    back[tgt] = 0
    return (torch.nonzero(chosen).flatten().tolist(), ml.tolist(),
            off.tolist(), back.tolist())


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


def _emit_rows(blocks, lens, starts, select):
    """Emission of every window: ``select(i, n, start)`` gives the
    chosen positions and per-position (ml, off, back) of window i."""
    B, blk = blocks.shape
    cap = compress_bound(blk)
    out = torch.zeros((B, cap), dtype=torch.uint8)
    out_len = torch.zeros(B, dtype=torch.int32)
    rows = blocks.cpu().numpy()
    for i in range(B):
        n, start = int(lens[i]), int(starts[i])
        chosen, ml, off, back = select(i, n, start)
        comp = _emit_one(rows[i].tobytes(), n, start, chosen, ml, off,
                         back)
        if comp:
            out[i, :len(comp)] = torch.frombuffer(bytearray(comp),
                                                  dtype=torch.uint8)
        out_len[i] = len(comp)
    return out.to(blocks.device), out_len.to(blocks.device)


def parse_emit_plain(blocks: torch.Tensor, lens: torch.Tensor,
                     starts: torch.Tensor, pk: torch.Tensor,
                     hc: int = 9, accel: int = 1):
    """Plain version of the ``enc_parse_emit`` kernel (``deep=0``):
    (out uint8[B, compress_bound(blk)], zero past out_len; out_len
    int32[B])."""
    W, _probes = _finder(hc, 0, accel)
    return _emit_rows(blocks, lens, starts, lambda i, n, start: _parse_one(
        pk[i], n, start, 4 + 4 * W, hc > 0))


def deep_dp_plain(lens: torch.Tensor, starts: torch.Tensor,
                  pk: torch.Tensor, deep: int) -> torch.Tensor:
    """Plain version of the ``enc_deep_dp`` kernel: int32[B, blk] state
    words ``ml | take << 30 | cap_end << 29`` after the chain extension
    and the price parse."""
    if not pk.shape[0]:
        return torch.zeros_like(pk)
    return torch.stack([
        _deep_dp_one(pk[i], int(lens[i]), int(starts[i]), 4 + 4 * _W, deep)
        for i in range(pk.shape[0])])


def deep_emit_plain(blocks: torch.Tensor, lens: torch.Tensor,
                    starts: torch.Tensor, pk: torch.Tensor,
                    st: torch.Tensor):
    """Plain version of the ``enc_deep_emit`` kernel: greedy parse over
    the state words' ``take`` bits, extension, absorb and emission;
    (out, out_len) as ``parse_emit_plain``."""
    return _emit_rows(blocks, lens, starts,
                      lambda i, n, start: _deep_select_one(
                          blocks[i], pk[i], st[i], n))


def encode_blocks_plain(blocks: torch.Tensor, lens: torch.Tensor,
                        starts: torch.Tensor | None = None,
                        hc: int = 9, deep: int = 0, accel: int = 1):
    """Plain encode of uint8[B, blk] windows: (out
    uint8[B, compress_bound(blk)], out_len int32[B])."""
    _finder(hc, deep, accel)
    if starts is None:
        starts = torch.zeros_like(lens)
    _check(blocks, lens, starts)
    pk = match_candidates_plain(blocks, lens, hc, accel, deep)
    if deep:
        st = deep_dp_plain(lens, starts, pk, deep)
        return deep_emit_plain(blocks, lens, starts, pk, st)
    return parse_emit_plain(blocks, lens, starts, pk, hc, accel)


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------

def match_candidates(blocks: torch.Tensor, lens: torch.Tensor,
                     hc: int = 9, accel: int = 1,
                     deep: int = 0) -> torch.Tensor:
    """Packed candidates per position; for CUDA tensors, at windows up to
    64 KB the ``enc_deep_match`` kernel (``deep`` 1..3), the ``enc_match``
    kernel (``hc >= 1``) or the ``enc_match_fast`` kernel (``hc == 0``,
    with ``fast_params(accel)``), at wider ones the ``enc_deep_match_wide``
    kernel (``deep`` 1..3) or the ``enc_match_wide`` kernel, at the
    cluster shape ``wide_spread_shape`` gives the launch's windows
    (counted in ``enc.spread_windows`` where it is wider than the
    least); the plain version for CPU tensors."""
    if blocks.device.type == "cpu":
        return match_candidates_plain(blocks, lens, hc, accel, deep)
    W, probes = _finder(hc, deep, accel)
    blocks, lens = blocks.contiguous(), lens.contiguous()
    B, blk = blocks.shape
    _check_pack_width(blk)
    dev = blocks.device
    pk = torch.empty((B, blk), dtype=torch.int32, device=dev)
    if B and deep:
        # the exact ranks reach blk, past u16, so they live in device
        # memory: 4 bytes per position for the 32-byte rank, 4 more at
        # deep=3 for the 256-byte rank
        ranks = torch.empty((B, 2 if deep == 3 else 1, blk),
                            dtype=torch.int32, device=dev)
    if B and blk > _MAX_SHARED_BLK:
        # device scratch a window: the window as words with 64 zero bytes
        # past it (320 KB at 327,680 bytes); the order lives in the
        # shared memory of the window's cluster
        nwords = (blk + 64) // 4 + 1
        words = torch.empty((B, nwords), dtype=torch.int32, device=dev)
        C, J = wide_spread_shape(blk, B, functools.partial(
            _active_clusters, blocks.get_device(), bool(deep), blk))
        if C > wide_cluster_shape(blk)[0]:
            trace.count("enc.spread_windows", B)
        if deep:
            launch("enc_deep_match_wide", blocks, lens, words, ranks, pk, B,
                   blk, nwords, C, J, hc, deep)
        else:
            launch("enc_match_wide", blocks, lens, words, pk, B, blk,
                   nwords, C, J, hc, W, probes)
    elif B and deep:
        launch("enc_deep_match", blocks, lens, ranks, pk, B, blk, hc, deep)
    elif B and hc:
        launch("enc_match", blocks, lens, pk, B, blk, hc)
    elif B:
        launch("enc_match_fast", blocks, lens, pk, B, blk, W, probes)
    return pk


def _sub_width(longest: int, width: int, deep: int = 0) -> int:
    """Width of a launch group of sub-span windows ``width`` bytes wide
    whose longest window holds ``longest`` bytes: ``longest + _FIT_PAD``
    rounded up to ``_FIT_STEP``, at least ``_FIT_MIN`` and at most
    ``width``, so a group that holds a full window launches at ``width``.

    Below the deep levels the payloads do not depend on the width: a
    probe rejects any neighbour past ``n - 4``, and the rows from
    ``n - 3`` on share one key and sort as one group by position, so
    with 19 or more of them no probe (at most 9 sorted rows away)
    reaches across them to another valid row.  The deep levels
    (``deep`` 1..3) keep ``width``: their extension pool grows with the
    width (``_EXT_POOL`` chosen rows a 64 KB of it), and their tier
    operands read ranks up to 1 KB past a row, so their bytes may
    depend on it."""
    if deep:
        return width
    w = -(-(longest + _FIT_PAD) // _FIT_STEP) * _FIT_STEP
    return min(max(w, _FIT_MIN), width)


#: rows a thread of a wide finder's CTA holds in registers during a radix
#: pass: at most 20 while the cluster may still grow (327,680 rows over 16
#: CTAs), at most 32 past that (2^19 rows over 16 CTAs of 1024 threads);
#: the kernels are built for these two bounds
_WIDE_ROWS, _WIDE_MAX_ROWS = 20, 32
_WIDE_THREADS, _WIDE_MAX_CLUSTER = 1024, 16


def wide_cluster_shape(blk: int) -> tuple[int, int]:
    """(C, J) of a wide finder's launch (``enc_match_wide``,
    ``enc_deep_match_wide``): each window's position order is cut into C
    slices of ``1024 * J`` rows, one a CTA of 1024 threads, J rows a
    thread; C is the least power of two up to 16 that keeps J at 20 or
    under (C = 8 at 131,072 bytes, 16 at 262,144 and 327,680), and J the
    least that covers ``blk`` rows.  A launch of few windows may take a
    wider C (``wide_spread_shape``)."""
    C = 1
    while C < _WIDE_MAX_CLUSTER and -(-blk // C) > _WIDE_ROWS * _WIDE_THREADS:
        C *= 2
    J = -(-blk // (C * _WIDE_THREADS))
    assert J <= _WIDE_MAX_ROWS, blk
    return C, J


def wide_spread_shape(blk: int, windows: int, active) -> tuple[int, int]:
    """(C, J) of a wide finder's launch of ``windows`` windows of ``blk``
    bytes: the widest power of two C from 16 down to
    ``wide_cluster_shape(blk)``'s at which ``active(C, J)``, the clusters
    of that shape the card holds at once, takes every window of the
    launch, with J the least that covers ``blk`` rows at that C; the
    least shape (``wide_cluster_shape``) where no wider C takes them all.
    A launch of one or two windows so spreads each window's rows, and
    its probes, over up to 16 SMs (a lone 69,632-byte window: 16 CTAs of
    5 rows a thread, not 4 of 17); a launch of many windows, which fills
    the card at the least shape, keeps it.  The bytes do not depend on
    the shape: every pass is stable and a probe reads across a slice's
    edge."""
    least = wide_cluster_shape(blk)
    C = _WIDE_MAX_CLUSTER
    while C > least[0]:
        J = -(-blk // (C * _WIDE_THREADS))
        if active(C, J) >= windows:
            return C, J
        C //= 2
    return least


def _wide_query(blk: int, C: int, J: int, deep: bool) -> tuple[int, int]:
    """(shared memory a CTA in bytes, clusters the card holds at once) of
    the wide finder (``enc_deep_match_wide`` when ``deep``) at shape
    (C, J) for ``blk``-byte windows on the current CUDA device."""
    out = (ctypes.c_int * 2)()
    fn = getattr(library(), "zl4_enc_deep_match_wide_shape" if deep
                 else "zl4_enc_match_wide_shape")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(blk, C, J, out)
    if err:
        raise RuntimeError(f"wide launch shape: CUDA error {err}")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _active_clusters(device: int, deep: bool, blk: int, C: int,
                     J: int) -> int:
    """The clusters of C CTAs of J rows a thread that CUDA device
    ``device`` holds at once for the wide finder at ``blk``-byte windows
    (``cudaOccupancyMaxActiveClusters``), asked once a (device, kernel,
    blk, C): J follows from blk and C."""
    with torch.cuda.device(device):
        return _wide_query(blk, C, J, deep)[1]


def wide_launch_shape(blk: int, deep: int = 0) -> dict:
    """The least launch shape (``wide_cluster_shape``) of the wide finder
    (``enc_deep_match_wide`` when ``deep``) for ``blk``-byte windows on
    the current CUDA device: CTAs a cluster, threads a CTA, rows a
    thread, shared memory a CTA in bytes, and the clusters the card holds
    at once (``cudaOccupancyMaxActiveClusters``)."""
    C, J = wide_cluster_shape(blk)
    smem, active = _wide_query(blk, C, J, bool(deep))
    return {"ctas": C, "threads": _WIDE_THREADS, "rows_a_thread": J,
            "smem_bytes": smem, "active_clusters": active}


#: rows a slice of ``enc_parse_emit``'s spread route holds at most: its
#: staged successors, speculative path and the places on it fill 174 KB
#: of a CTA's shared memory there
_SPREAD_MAX_ROWS = 24_576


def parse_spread_shape(blk: int, windows: int, active) -> int:
    """CTAs a window of ``enc_parse_emit``'s launch of ``windows``
    windows of ``blk`` bytes: the widest power of two C from 16 down to
    2 at which a slice of the window's rows (``32 * ceil(ceil(blk / 32)
    / C)``) holds at most ``_SPREAD_MAX_ROWS`` rows and ``active(C)``,
    the clusters of C CTAs of 1024 threads the card holds at once, takes
    every window of the launch; else 1, one CTA of 256 threads a window.
    A launch of one or two windows so spreads each window's parse over up
    to 16 SMs (an insert call's lone 69,632-byte window: 16 slices of
    4,352 rows); a launch of many windows, which fills the card with one
    CTA a window, keeps that launch.  The bytes do not depend on C."""
    C = _WIDE_MAX_CLUSTER
    while C > 1:
        if _spread_fits(blk, C) and active(C) >= windows:
            return C
        C //= 2
    return 1


def _spread_fits(blk: int, C: int) -> bool:
    """A slice of a ``blk``-row window over C CTAs holds at most
    ``_SPREAD_MAX_ROWS`` rows (whole 32-row words)."""
    words = -(-blk // 32)
    return 32 * -(-words // C) <= _SPREAD_MAX_ROWS


@functools.lru_cache(maxsize=None)
def _parse_active(device: int, blk: int, C: int) -> int:
    """The clusters of C CTAs of ``enc_parse_emit``'s spread route that
    CUDA device ``device`` holds at once at ``blk``-byte windows
    (``cudaOccupancyMaxActiveClusters``), asked once a (device, blk,
    C)."""
    out = (ctypes.c_int * 2)()   # shared memory a CTA, clusters at once
    fn = library().zl4_enc_parse_emit_shape
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(blk, C, out)
    if err:
        raise RuntimeError(f"parse launch shape: CUDA error {err}")
    return out[1]


def _check_pk(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32[B, blk]")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, not on {like.device}")


def deep_dp(lens: torch.Tensor, starts: torch.Tensor, pk: torch.Tensor,
            deep: int) -> torch.Tensor:
    """State words ``ml | take << 30 | cap_end << 29`` of the deep
    parse; the ``enc_deep_dp`` kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not 1 <= deep <= 3:
        raise ValueError(f"deep={deep}")
    if pk.device.type == "cpu":
        return deep_dp_plain(lens, starts, pk, deep)
    if pk.dim() != 2 or pk.dtype != torch.int32:
        raise TypeError("pk must be int32[B, blk]")
    B, blk = pk.shape
    _check_pack_width(blk)
    lens, starts, pk = (t.contiguous() for t in (lens, starts, pk))
    st = torch.empty_like(pk)
    if B:
        launch("enc_deep_dp", lens, starts, pk, st, B, blk, 4 + 4 * _W, deep)
    return st


def deep_emit(blocks: torch.Tensor, lens: torch.Tensor,
              starts: torch.Tensor, pk: torch.Tensor, st: torch.Tensor):
    """Greedy parse over the ``take`` bits, extension, absorb and
    emission; the ``enc_deep_emit`` kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if blocks.device.type == "cpu":
        return deep_emit_plain(blocks, lens, starts, pk, st)
    _check_pk("pk", pk, blocks)
    _check_pk("st", st, blocks)
    B, blk = blocks.shape
    _check_pack_width(blk)
    blocks, lens, starts, pk, st = (t.contiguous() for t in
                                    (blocks, lens, starts, pk, st))
    cap = compress_bound(blk)
    dev = blocks.device
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    # per window: the chosen rows of the greedy parse (a window has at
    # most blk // 4 + 1), the kept entries (p, e, off, back) and the long
    # literal runs (src, dst, len; at most blk // 4 + 2)
    chcap = blk // 4 + 1
    chosen = torch.empty((B, chcap), dtype=torch.int32, device=dev)
    ents = torch.empty((B, 4 * chcap), dtype=torch.int32, device=dev)
    runs = torch.empty((B, 3 * (blk // 4 + 2)), dtype=torch.int32,
                       device=dev)
    if B:
        launch("enc_deep_emit", blocks, lens, starts, pk, st, chosen, ents,
               runs, out, out_len, B, blk, cap, runs.shape[1], chcap)
    return out, out_len


def parse_emit(blocks: torch.Tensor, lens: torch.Tensor,
               starts: torch.Tensor, pk: torch.Tensor,
               hc: int = 9, accel: int = 1):
    """Parse and emission; the ``enc_parse_emit`` kernel for CUDA
    tensors, one CTA a window or, for a launch of few windows, the
    cluster ``parse_spread_shape`` gives (counted in
    ``enc.spread_parses``); the plain version for CPU tensors."""
    if blocks.device.type == "cpu":
        return parse_emit_plain(blocks, lens, starts, pk, hc, accel)
    W, _probes = _finder(hc, 0, accel)
    B, blk = blocks.shape
    _check_pk("pk", pk, blocks)
    blocks, lens, starts, pk = (t.contiguous() for t in
                                (blocks, lens, starts, pk))
    cap = compress_bound(blk)
    dev = blocks.device
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    # per position: final ml with the is_match bit; per window: the
    # chosen rows, then the literal runs (src, dst, len) of the emission
    # (a window has at most blk // 4 + 1 chosen rows, so at most
    # blk // 4 + 2 runs)
    mlw = torch.empty((B, blk), dtype=torch.int32, device=dev)
    runs = torch.empty((B, (blk // 4 + 1) + 3 * (blk // 4 + 2)),
                       dtype=torch.int32, device=dev)
    if B:
        C = parse_spread_shape(blk, B, functools.partial(
            _parse_active, blocks.get_device(), blk))
        if C > 1:
            trace.count("enc.spread_parses", B)
        launch("enc_parse_emit", blocks, lens, starts, pk, mlw, runs,
               out, out_len, B, blk, cap, runs.shape[1], 4 + 4 * W,
               int(hc > 0), C)
    return out, out_len


def encode_blocks(blocks: torch.Tensor, lens: torch.Tensor,
                  starts: torch.Tensor | None = None,
                  hc: int = 9, deep: int = 0, accel: int = 1):
    """Encode uint8[B, blk] windows with valid lengths ``lens`` and
    emission starts ``starts`` (default 0), counterpart of
    ``encode_blocks_jax(..., hc, deep, accel)`` (the defaults here are
    level 9; ``level_params`` maps levels 0-12 to ``(hc, deep)``).  Returns (out uint8[B, compress_bound(blk)], zero past
    out_len; out_len int32[B])."""
    _finder(hc, deep, accel)
    if starts is None:
        starts = torch.zeros_like(lens)
    _check(blocks, lens, starts)
    pk = match_candidates(blocks, lens, hc, accel, deep)
    if deep:
        st = deep_dp(lens, starts, pk, deep)
        return deep_emit(blocks, lens, starts, pk, st)
    return parse_emit(blocks, lens, starts, pk, hc, accel)


@functools.lru_cache(maxsize=None)
def make_block_encoder(blk: int, hc: int = 0, deep: int = 0,
                       accel: int = 1, device: str | torch.device = "cuda"):
    """The single-window encoder of ``jax_block.make_block_encoder``
    (``jax_block.py:1130-1151``), one per configuration: ``call(data,
    n, start=0) -> (out uint8[compress_bound(blk)], out_len int32)``, a
    window ``data`` of ``blk`` bytes (a numpy array or a tensor) of
    which ``n`` are valid, emitting from ``start`` (a dictionary or
    history before it).  It runs ``encode_blocks`` over a batch of one
    on ``device``: the kernels on a CUDA device, their plain versions
    on the CPU, which must be asked for."""
    from ..parallel.device import resolve_device
    _finder(hc, deep, accel)
    dev = resolve_device(device)

    def call(data, n, start=0):
        w = torch.as_tensor(np.asarray(data, np.uint8) if not isinstance(
            data, torch.Tensor) else data)
        if w.dtype != torch.uint8 or tuple(w.shape) != (blk,):
            raise TypeError(f"data must be uint8[{blk}]")
        lens = torch.tensor([int(n)], dtype=torch.int32, device=dev)
        starts = torch.tensor([int(start)], dtype=torch.int32, device=dev)
        out, out_len = encode_blocks(w.to(dev).reshape(1, blk), lens, starts,
                                     hc=hc, deep=deep, accel=accel)
        return out[0], out_len[0]
    return call


# ---------------------------------------------------------------------
# DECODE: the decode surface lives in ops/torch_decode.py and
# ops/torch_frags.py; the reference's block module re-exports its decode
# names (jax_block.py:1175-1188), and so does this one, so that imports
# written for it resolve here.  ``decode_blocks`` stands for the
# reference's ``decode_blocks_jax``.  At the bottom, as there, so that
# the decode modules may import this one.
# ---------------------------------------------------------------------
from .torch_decode import (  # noqa: E402,F401
    MAX_SEQS, decode_blocks, decode_blocks_frags,
    device_chase_decoder_supports, device_frag_decoder_supports,
    device_tmap_decoder_supports, device_win_decoder_supports,
    make_block_decoder, parse_sequences, resolve_fragments_py,
    resolve_tmap_py, seqs_to_arrays, win_tier_config)
