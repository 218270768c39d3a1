"""Fragment-ladder block decoders for the H100, with their plain
PyTorch versions.

Counterpart of the three fragment engines of the JAX reference
(``ops/jax_decode.py``): ``_decode_block_frags`` (``:342``, byte
granular rounds), ``_decode_block_frags_win`` (``:461``, windowed
rounds) and ``_decode_block_frags_chase`` (``:798``, pointer doubling),
with their geometry predicates (``:292-339``, ``:784-795``), the
windowed decoder's per-tier configuration (``:1161``) and the Python
mirror of the host resolver (``:1213``).

The host resolver (``native_resolve_blocks``) turns a compressed block
into a table of fragments in increasing ``fdst`` that tile
``[0, out_len)``; a fragment's length is the next ``fdst`` (or
``out_len``) minus its own:

  LIT (fper == 0): out[fdst + k] = fetch[fsrc + k]
  PER (fper > 0):  out[fdst + k] = out[fsrc + (fphase + k) % fper]

where ``fetch`` is the block's fetch buffer ``[dictionary | payload]``.
Every output byte therefore has a one-hop source ``T``: a fetch
coordinate for a LIT byte, an output coordinate for a PER byte.  The
three engines differ in how they follow the PER hops, and in which
blocks they finish; each returns ``ok`` per block, set when every live
byte was rebuilt, and the caller re-routes the blocks whose ``ok`` is
clear.  What resolves in which round follows the reference exactly, so
a block takes the same route in both packages:

* byte granular: in each of ``rounds`` rounds a PER byte becomes known
  when its source was known at the start of the round;
* windowed: the same, but a byte can only ever resolve when it is
  *covered*: by one of the ``wins`` (``lit_wins`` on the literal side)
  aligned ``2g``-byte source windows of its ``g``-byte output group, or
  by being among the first ``pool`` (``lit_pool``) uncovered bytes of
  the block in position order;
* chase: ``nx`` is ``T`` for a PER byte and ``T + blk`` for a LIT byte
  (fetch-space positions are fixpoints); ``dense`` times
  ``nx = nx[nx]`` on every unconverged byte, then ``doublings`` times
  on the first ``qcap`` unconverged bytes in position order.

The TPU versions are built from sorts and packed cummax fills because
gathers are slow there; the CUDA kernels (``kernels/csrc/frag_decode.cu``)
gather.  The geometry predicates, which on the TPU say whether the
packs fit int32, stay as the gate that decides which tier takes a
block.  The tables may be staged narrower than the tier's ``fcap``:
columns at or past a block's ``nfrag`` are never read.
"""

from __future__ import annotations

import bisect
import ctypes

import torch

from ..constants import compress_bound
from ..errors import CorruptedData
from ..kernels import launch, library

__all__ = ["device_frag_decoder_supports", "device_win_decoder_supports",
           "device_chase_decoder_supports", "win_tier_config",
           "resolve_fragments_py", "decode_blocks_frags",
           "decode_blocks_frags_plain", "decode_blocks_frags_win",
           "decode_blocks_frags_win_plain", "decode_blocks_frags_chase",
           "decode_blocks_frags_chase_plain"]


def _bits(v: int) -> int:
    return max(int(v).bit_length(), 1)


def _frag_geometry(blk: int, fcap: int, fetch_cap: int):
    """Chunk layout of the reference's rank-prefixed fragment packs:
    (CW, r1, r2, r3, r4), or None when the layout does not fit int32
    (``jax_decode.py:292-314``).  The port packs nothing; the layout
    only decides which geometries a tier accepts."""
    QB = _bits(fcap + 1)
    CW = 31 - QB
    r1 = max(_bits(blk) - CW, 0)
    r2 = max(_bits(max(fetch_cap, blk)) - CW, 0)
    r3 = max(16 - CW, 0)
    r4 = r3
    if CW < 1 or r1 + r2 + r3 + r4 > CW or _bits(fetch_cap) + 10 > 31:
        return None
    return CW, r1, r2, r3, r4


def device_frag_decoder_supports(blk: int, fcap: int | None = None,
                                 fetch_cap: int | None = None) -> bool:
    """True when the byte-granular tier takes ``blk``-byte outputs
    fetching from ``fetch_cap`` source bytes."""
    fcap = fcap or blk // 2
    fetch_cap = fetch_cap or compress_bound(blk)
    return (_frag_geometry(blk, fcap, fetch_cap) is not None
            and _bits(blk) + 10 <= 31)


def device_win_decoder_supports(blk: int, fcap: int | None = None,
                                fetch_cap: int | None = None) -> bool:
    """True when the windowed tier takes this geometry (64 KB blocks;
    256 KB ones stay on the byte-granular decoder)."""
    fcap = fcap or blk // 2
    fetch_cap = fetch_cap or compress_bound(blk)
    return (blk % 64 == 0
            and _frag_geometry(blk, fcap, fetch_cap) is not None
            and _bits(blk // 8 + 1) + 16 <= 31
            and _bits(fetch_cap + 1) + 9 <= 31)


def device_chase_decoder_supports(blk: int, fcap: int | None = None,
                                  fetch_cap: int | None = None) -> bool:
    """True when the chase tier takes this geometry."""
    fcap = fcap or blk // 2
    fetch_cap = fetch_cap or compress_bound(blk)
    return (_frag_geometry(blk, fcap, fetch_cap) is not None
            and 31 - _bits(blk + 1) >= 4
            and _bits(fetch_cap + 1) + 9 <= 31)


def win_tier_config(blk: int, fcap: int, rounds: int) -> dict:
    """Per-tier configuration of the windowed decoder: the periodic
    side needs 2 windows and a few hundred pool slots; the literal side
    3-4 windows on the shallow tiers, and stays byte granular on the
    match-dense deep tier."""
    if rounds <= 2:
        return dict(wins=2, pool=256, lit_wins=3, lit_pool=1024)
    if fcap < blk:
        return dict(wins=2, pool=512, lit_wins=4, lit_pool=2048)
    return dict(wins=2, pool=512, lit_wins=0, lit_pool=0)


def resolve_fragments_py(comp: bytes, fcap: int = 1 << 30,
                         out_cap: int = 4 << 20, hist_len: int = 0,
                         split_max: int = 8, round_limit: int = 4):
    """Pure-Python mirror of the native fragment resolver
    (``lz4tpu_resolve_blocks``): per-match splitting capped at
    ``split_max`` segments; a match that would split further becomes
    one PER copy-fragment with round = 1 + the deepest round of the
    bytes it reads (up to ``round_limit``); LIT sources are shifted by
    ``hist_len`` for a [history | comp] fetch buffer.  Returns (list of
    (dst, len, src, per, phase, round), rounds, out_len), or None on
    fragment-budget or ``out_cap`` overflow."""
    frags = []          # (dst, len, src, per, phase, round)
    ip, n = 0, len(comp)
    op = 0
    max_round = 0
    round_limit = min(round_limit, 250)

    dsts = []
    byte_round = bytearray(out_cap + 1)

    def walk(s, take, count_only, d=0):
        """Split [s, s+take) over covering fragments; returns segment
        count (count_only) or emits fragments (-1 = budget hit)."""
        nonlocal max_round
        cur, remaining = s, take
        nseg = 0
        while remaining > 0:
            if cur < 0:
                seg = min(-cur, remaining)
                if not count_only:
                    if len(frags) >= fcap:
                        return -1
                    frags.append((d, seg, hist_len + cur, 0, 0, 0))
                    dsts.append(d)
                    byte_round[d:d + seg] = bytes(seg)
                    d += seg
                nseg += 1
                cur += seg
                remaining -= seg
                continue
            fi = bisect.bisect_right(dsts, cur) - 1
            fd, flen_, fs, fp, fh, fr = frags[fi]
            into = cur - fd
            seg = min(flen_ - into, remaining)
            if not count_only:
                if len(frags) >= fcap:
                    return -1
                if fp == 0:
                    frags.append((d, seg, fs + into, 0, 0, 0))
                    byte_round[d:d + seg] = bytes(seg)
                else:
                    frags.append((d, seg, fs, fp, (fh + into) % fp, fr))
                    byte_round[d:d + seg] = bytes([min(fr, 250)]) * seg
                    max_round = max(max_round, fr)
                dsts.append(d)
                d += seg
            nseg += 1
            if count_only and nseg > split_max:
                return nseg
            cur += seg
            remaining -= seg
        return nseg

    while ip < n:
        token = comp[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise CorruptedData("truncated literal length")
                x = comp[ip]
                ip += 1
                lit += x
                if x != 255:
                    break
        if ip + lit > n:
            raise CorruptedData("literal overrun")
        if lit:
            if len(frags) >= fcap or op + lit > out_cap:
                return None
            frags.append((op, lit, hist_len + ip, 0, 0, 0))
            dsts.append(op)
            byte_round[op:op + lit] = bytes(lit)
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
        ml = token & 15
        if ml == 15:
            while True:
                if ip >= n:
                    raise CorruptedData("truncated match length")
                x = comp[ip]
                ip += 1
                ml += x
                if x != 255:
                    break
        ml += 4
        if op + ml > out_cap:
            return None
        take = min(ml, off)
        s = op - off

        def copy_frag():
            """One PER copy-fragment for the whole head, round
            permitting."""
            nonlocal max_round
            r = 1 + max(byte_round[s:s + take])
            if r > round_limit or len(frags) >= fcap:
                return False
            frags.append((op, take, s, off, 0, r))
            dsts.append(op)
            byte_round[op:op + take] = bytes([r]) * take
            max_round = max(max_round, r)
            return True

        split_ok = walk(s, take, count_only=True) <= split_max
        if not split_ok and s >= 0:
            if not copy_frag():
                split_ok = True
        elif not split_ok:
            split_ok = True         # history-reaching head: must split
        if split_ok:
            nf0 = len(frags)
            mr0 = max_round
            if walk(s, take, count_only=False, d=op) < 0:
                # budget pressure mid-split: roll back and prefer the
                # single copy-fragment, like the native resolver
                del frags[nf0:]
                del dsts[nf0:]
                max_round = mr0
                if s < 0 or not copy_frag():
                    return None

        if ml > take:
            # flattened tail: reads the pre-existing window
            # [s, s+read_n) -- the same bytes, one round shallower than
            # reading the head's output whenever the head was a
            # copy-fragment; a history-reaching head (s < 0) keeps the
            # head-window form
            read_n = min(ml - take, off)
            tsrc = s if s >= 0 else op
            r = 1 + max(byte_round[tsrc:tsrc + read_n])
            if len(frags) >= fcap:
                return None
            frags.append((op + take, ml - take, tsrc, off, 0, r))
            dsts.append(op + take)
            byte_round[op + take:op + ml] = bytes([min(r, 250)]) * (ml - take)
            max_round = max(max_round, r)
        op += ml
    return frags, max_round, op


# ---------------------------------------------------------------------
# shared: argument checks and the one-hop sources (the reference's
# merge A, jax_decode.py:371-416)
# ---------------------------------------------------------------------

def _check(comp, fdst, fsrc, fper, fphase, nfrag, out_len, blk: int):
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] < 1:
        raise TypeError("comp must be uint8[B, fetch]")
    B = comp.shape[0]
    for name, t in (("fdst", fdst), ("fsrc", fsrc), ("fper", fper),
                    ("fphase", fphase)):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != B
                or t.shape != fdst.shape):
            raise TypeError(f"{name} must be int32[B, columns]")
    for name, t in (("nfrag", nfrag), ("out_len", out_len)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise TypeError(f"{name} must be int32[B]")
    if any(t.device != comp.device
           for t in (fdst, fsrc, fper, fphase, nfrag, out_len)):
        raise ValueError("every tensor must be on one device")
    if not 0 < blk < 2 ** 29 or comp.shape[1] >= 2 ** 29:
        raise ValueError("block or fetch buffer too large for int32 "
                         "coordinates")


def _sources(comp, fdst, fsrc, fper, fphase, nfrag, out_len, blk: int):
    """(T, per, live), each [B, blk]: for byte ``j`` the covering
    fragment is the last one with ``fdst <= j`` among the first
    ``nfrag``; ``T = fsrc + rel`` clamped to the fetch buffer for a LIT
    fragment and ``fsrc + (fphase + rel) % fper`` clamped to the block
    for a PER one, ``rel = j - fdst``."""
    B, ncol = fdst.shape
    dev = comp.device
    j = torch.arange(blk, device=dev, dtype=torch.int32)
    live = j[None, :] < out_len[:, None]
    if ncol == 0:
        zero = torch.zeros((B, blk), dtype=torch.int64, device=dev)
        return zero, torch.zeros_like(live), live
    q = torch.arange(ncol, device=dev, dtype=torch.int32)
    stale = q[None, :] >= nfrag[:, None]
    keys = torch.where(stale, 1 << 30, fdst)
    idx = torch.searchsorted(keys, j[None, :].expand(B, blk).contiguous(),
                             right=True) - 1
    found = idx >= 0
    idx = idx.clamp(min=0)
    fd, fs, fp, fh = (t.gather(1, idx).long()
                      for t in (fdst, fsrc, fper, fphase))
    rel = j[None, :].long() - fd
    per = found & (fp > 0)
    t_per = (fs + torch.remainder(fh + rel, fp.clamp(min=1))).clamp(0, blk - 1)
    t_lit = (fs + rel).clamp(0, comp.shape[1] - 1)
    T = torch.where(per, t_per, torch.where(found, t_lit, 0))
    return T, per, live


def _rounds(value, known, T, reach, rounds: int):
    """``rounds`` times: every unknown byte of ``reach`` whose source
    ``T`` was known at the start of the round takes its value."""
    for _ in range(max(rounds, 0)):
        got = reach & ~known & known.gather(1, T)
        if not bool(got.any()):
            break
        value = torch.where(got, value.gather(1, T), value)
        known = known | got
    return value, known


def _finish(value, known, live):
    out = torch.where(live & known, value, 0).to(torch.uint8)
    return out, known.all(dim=1).to(torch.int32)


# ---------------------------------------------------------------------
# byte-granular rounds
# ---------------------------------------------------------------------

def decode_blocks_frags_plain(comp_blocks, fdst, fsrc, fper, fphase, nfrag,
                              out_lens, rounds: int, blk: int):
    """Plain version of the ``frag_decode`` kernel: (out uint8[B, blk],
    ok int32[B])."""
    _check(comp_blocks, fdst, fsrc, fper, fphase, nfrag, out_lens, blk)
    T, per, live = _sources(comp_blocks, fdst, fsrc, fper, fphase, nfrag,
                            out_lens, blk)
    lit = live & ~per
    value = torch.where(lit, comp_blocks.gather(1, torch.where(lit, T, 0)),
                        0)
    value, known = _rounds(value, ~live | lit, torch.where(per, T, 0),
                           live & per, rounds)
    return _finish(value, known, live)


def _scratch_words(B: int, rows: int, blk: int, dev) -> torch.Tensor:
    """Bit-mask scratch: ``rows`` masks of one bit a byte per block."""
    return torch.empty((B, rows, (blk + 31) // 32), dtype=torch.int32,
                       device=dev)


def _rounds_arg(rounds, B: int, dev):
    """A kernel's optional rounds output: ``rounds`` (int32[B] on
    ``dev``) or 0, the null pointer."""
    if rounds is None:
        return 0
    if (rounds.dtype != torch.int32 or rounds.shape != (B,)
            or rounds.device != dev):
        raise TypeError("rounds must be int32[B] on the tables' device")
    return rounds


def _kernel_io(tables, blk: int):
    """(the checked tables, contiguous; out uint8[B, blk]; ok int32[B])
    for a kernel launch."""
    _check(*tables, blk)
    tables = [t.contiguous() for t in tables]
    B, dev = tables[0].shape[0], tables[0].device
    return (tables, torch.empty((B, blk), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev))


def decode_blocks_frags(comp_blocks, fdst, fsrc, fper, fphase, nfrag,
                        out_lens, rounds: int, blk: int):
    """Rebuild blocks of up to ``blk`` bytes from fragment tables in at
    most ``rounds`` dependency levels, counterpart of
    ``decode_blocks_frags`` of the reference, with its parameter names
    (``jax_decode.py:1202``): ``comp_blocks`` uint8[B, fetch] the fetch
    buffers, ``fdst``/``fsrc``/``fper``/``fphase`` int32[B,
    columns] and ``nfrag`` int32[B] the resolver's tables, ``out_lens``
    int32[B].  Returns (out uint8[B, blk], zero where a byte did not
    resolve and from out_lens on; ok int32[B], 1 when every live byte
    resolved -- the reference returns no flag and trusts the tier).  The
    ``frag_decode`` kernel for CUDA tensors -- its state in a
    thread-block cluster's shared memory for blocks up to 256 KB whose
    size is a multiple of 64 (``frag_cluster_size``), in device scratch
    for the others -- the plain version for CPU tensors."""
    if comp_blocks.device.type == "cpu":
        return decode_blocks_frags_plain(comp_blocks, fdst, fsrc, fper,
                                         fphase, nfrag, out_lens, rounds, blk)
    tables, out, ok = _kernel_io(
        (comp_blocks, fdst, fsrc, fper, fphase, nfrag, out_lens), blk)
    B, dev = out.shape[0], out.device
    if B:
        C = frag_cluster_size(blk)
        if C:       # the state in the cluster's shared memory: no scratch
            src = known = 0
        else:
            src = torch.empty((B, blk), dtype=torch.int32, device=dev)
            known = _scratch_words(B, 2, blk, dev)
        launch("frag_decode", *tables, src, known, out, ok, B,
               comp_blocks.shape[1], fdst.shape[1], blk, max(int(rounds), 0),
               C)
    return out, ok


# ---------------------------------------------------------------------
# the cluster routes of the windowed decoder and the chase
# ---------------------------------------------------------------------

#: positions of a block's state that one CTA holds in shared memory, and
#: the largest cluster (the portable size): the three decoders keep the
#: state of blocks up to 256 KB in one cluster's shared memory
#: (``frag_decode.cu``)
_CLUSTER_ROWS = 1 << 15
_MAX_CLUSTER = 8


def _cluster_ctas(blk: int) -> int:
    C = -(-blk // _CLUSTER_ROWS)
    return C if C <= _MAX_CLUSTER else 0


def _cluster_shape(entry: str, blk: int, *extra) -> dict:
    """A cluster route's launch for ``blk``-byte blocks on the current
    CUDA device, from the C entry point ``entry``."""
    out = (ctypes.c_int * 3)()
    fn = getattr(library(), entry)
    fn.argtypes = [ctypes.c_int] * (1 + len(extra)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(blk, *extra, out)
    if err:
        raise RuntimeError(f"{entry}({blk}): CUDA error {err}")
    return {"ctas": out[0], "threads": 1024, "smem_bytes": out[1],
            "active_clusters": out[2]}


def frag_cluster_size(blk: int) -> int:
    """CTAs of the thread-block cluster whose shared memory holds the
    byte-granular decoder's state of a ``blk``-byte block, ``ceil(blk /
    32768)``; 0 when that takes more than 8 CTAs or ``blk % 64`` is not
    0, and the state lies in device scratch."""
    return 0 if blk % 64 else _cluster_ctas(blk)


def frag_launch_shape(blk: int) -> dict:
    """The byte-granular kernel's launch for ``blk``-byte blocks on the
    current CUDA device: CTAs a cluster (0: the device-scratch route),
    threads and shared-memory bytes a CTA, and the clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    return _cluster_shape("zl4_frag_decode_shape", blk)


# ---------------------------------------------------------------------
# windowed rounds
# ---------------------------------------------------------------------

def _reach(T, unres, nwins: int, npool: int, g: int):
    """The bytes of ``unres`` that the windowed decoder can resolve
    (``windows_and_pool``, jax_decode.py:571-613): those whose source
    lies in one of ``nwins`` aligned 2g-byte windows of their g-byte
    group -- the first at the source of the group's first byte of
    ``unres``, the second ending at the source of its last, each later
    one at the source of the first byte the earlier ones miss -- and
    the first ``npool`` other bytes of the block in position order."""
    B, blk = T.shape
    gsh = g.bit_length() - 1
    Tg = T.view(B, blk // g, g)
    ug = unres.view(B, blk // g, g)
    kidx = torch.arange(g, device=T.device)

    def window(mask, last: bool):
        if last:
            pos = torch.where(mask, kidx, -1).amax(-1)
        else:
            pos = torch.where(mask, kidx, g).amin(-1)
        has = mask.any(-1)
        at = Tg.gather(-1, pos.clamp(0, g - 1)[..., None]).squeeze(-1)
        if last:
            at = (at - (g - 1)).clamp(min=0)
        d = Tg - ((at >> gsh) << gsh)[..., None]
        return has[..., None] & (d >= 0) & (d < 2 * g)

    cov = window(ug, False)
    if nwins >= 2:
        cov = cov | window(ug, True)
    for _ in range(nwins - 2):
        cov = cov | window(ug & ~cov, False)
    cov = cov.view(B, blk)
    uncovered = unres & ~cov
    in_pool = uncovered & (torch.cumsum(uncovered, 1) <= npool)
    return unres & (cov | in_pool)


def _win_config(blk, fcap, rounds, wins, pool, lit_wins, lit_pool, g):
    cfg = win_tier_config(blk, fcap, rounds)
    for key, v in (("wins", wins), ("pool", pool), ("lit_wins", lit_wins),
                   ("lit_pool", lit_pool)):
        if v is not None:
            cfg[key] = int(v)
    if g not in (8, 16):
        raise ValueError("the windowed decoder takes g 8 or 16")
    if blk % 64 or blk >= 2 ** 28:
        raise ValueError("the windowed decoder needs blk % 64 == 0, and "
                         "sources that leave two flag bits in an int32")
    if cfg["wins"] < 1 or min(cfg["pool"], cfg["lit_wins"],
                              cfg["lit_pool"]) < 0:
        raise ValueError(f"windowed decoder configuration {cfg}")
    return cfg


def decode_blocks_frags_win_plain(comp, fdst, fsrc, fper, fphase, nfrag,
                                  out_len, rounds: int, blk: int, *,
                                  fcap: int | None = None, wins=None,
                                  pool=None, lit_wins=None, lit_pool=None,
                                  g: int = 8):
    """Plain version of the ``frag_decode_win`` kernel: (out uint8[B,
    blk], ok int32[B])."""
    _check(comp, fdst, fsrc, fper, fphase, nfrag, out_len, blk)
    cfg = _win_config(blk, fcap or fdst.shape[1], rounds, wins, pool,
                      lit_wins, lit_pool, g)
    T, per, live = _sources(comp, fdst, fsrc, fper, fphase, nfrag, out_len,
                            blk)
    lit = live & ~per
    if cfg["lit_wins"]:
        lit = _reach(T, lit, cfg["lit_wins"], cfg["lit_pool"], g)
    value = torch.where(lit, comp.gather(1, torch.where(lit, T, 0)), 0)
    reach = _reach(T, live & per, cfg["wins"], cfg["pool"], g)
    value, known = _rounds(value, ~live | lit, torch.where(per, T, 0),
                           reach, rounds)
    return _finish(value, known, live)


def decode_blocks_frags_win(comp, fdst, fsrc, fper, fphase, nfrag, out_len,
                            rounds: int, blk: int, *,
                            fcap: int | None = None, wins=None, pool=None,
                            lit_wins=None, lit_pool=None, g: int = 8):
    """As ``decode_blocks_frags``, with the windowed decoder's coverage
    (counterpart of ``_batched_frag_decoder_win``): ``fcap`` is the
    tier's fragment budget (default: the tables' columns), from which,
    with ``rounds``, ``win_tier_config`` takes the windows and pools
    that the keyword arguments do not give; ``g`` is the group width, 8
    or 16.  ``ok`` is 0 for a block with a byte that no window and no
    pool slot covers, or that ``rounds`` rounds did not reach.  The
    ``frag_decode_win`` kernel for CUDA tensors -- its state in a
    thread-block cluster's shared memory for blocks up to 256 KB
    (``win_cluster_size``), in device scratch for larger ones -- the
    plain version for CPU tensors."""
    if comp.device.type == "cpu":
        return decode_blocks_frags_win_plain(
            comp, fdst, fsrc, fper, fphase, nfrag, out_len, rounds, blk,
            fcap=fcap, wins=wins, pool=pool, lit_wins=lit_wins,
            lit_pool=lit_pool, g=g)
    tables, out, ok = _kernel_io(
        (comp, fdst, fsrc, fper, fphase, nfrag, out_len), blk)
    cfg = _win_config(blk, fcap or fdst.shape[1], rounds, wins, pool,
                      lit_wins, lit_pool, g)
    B, dev = out.shape[0], out.device
    if B:
        C = win_cluster_size(blk)
        if C:       # the state in the cluster's shared memory: no scratch
            src = known = words = 0
        else:
            src = torch.empty((B, blk), dtype=torch.int32, device=dev)
            known = _scratch_words(B, 2, blk, dev)
            words = _scratch_words(B, 4, blk, dev)
        launch("frag_decode_win", *tables, src, known, words, out, ok, B,
               comp.shape[1], fdst.shape[1], blk, max(int(rounds), 0), g,
               cfg["wins"], cfg["pool"], cfg["lit_wins"], cfg["lit_pool"], C)
    return out, ok


def win_cluster_size(blk: int) -> int:
    """CTAs of the thread-block cluster whose shared memory holds the
    windowed decoder's state of a ``blk``-byte block, ``ceil(blk /
    32768)``; 0 when that takes more than 8 CTAs (past every block that
    ``device_win_decoder_supports`` admits), and the state lies in device
    scratch."""
    return _cluster_ctas(blk)


def win_launch_shape(blk: int, g: int = 8) -> dict:
    """The windowed kernel's launch for ``blk``-byte blocks and group
    width ``g`` on the current CUDA device: CTAs a cluster (0: the
    device-scratch route), threads and shared-memory bytes a CTA, and the
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    return _cluster_shape("zl4_frag_decode_win_shape", blk, g)


# ---------------------------------------------------------------------
# pointer doubling
# ---------------------------------------------------------------------

def _chase_pool(blk: int, qcap: int) -> int:
    return int(qcap) or max(blk // 8, 1024)


def chase_cluster_size(blk: int) -> int:
    """CTAs of the thread-block cluster whose shared memory holds the
    chase state of a ``blk``-byte block, ``ceil(blk / 32768)``; 0 when
    that takes more than 8 CTAs, and the state lies in device scratch."""
    return _cluster_ctas(blk)


def chase_launch_shape(blk: int) -> dict:
    """The chase kernel's launch for ``blk``-byte blocks on the current
    CUDA device: CTAs a cluster (0: the device-memory route), threads
    and shared-memory bytes a CTA, and the clusters the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    return _cluster_shape("zl4_frag_decode_chase_shape", blk)


def decode_blocks_frags_chase_plain(comp, fdst, fsrc, fper, fphase, nfrag,
                                    out_len, blk: int, dense: int = 2,
                                    doublings: int = 4, qcap: int = 0):
    """Plain version of the ``frag_decode_chase`` kernel: (out uint8[B,
    blk], ok int32[B])."""
    _check(comp, fdst, fsrc, fper, fphase, nfrag, out_len, blk)
    T, per, live = _sources(comp, fdst, fsrc, fper, fphase, nfrag, out_len,
                            blk)
    nx = torch.where(live, torch.where(per, T, T + blk), blk)

    def double(nx, which):
        return torch.where(which, nx.gather(1, nx.clamp(max=blk - 1)), nx)

    for _ in range(max(dense, 0)):
        unc = nx < blk
        if not bool(unc.any()):
            break
        nx = double(nx, unc)
    if doublings > 0:
        unc = nx < blk
        in_pool = unc & (torch.cumsum(unc, 1) <= _chase_pool(blk, qcap))
        for _ in range(doublings):
            nx = double(nx, in_pool & (nx < blk))
    conv = nx >= blk
    value = comp.gather(1, (nx - blk).clamp(0, comp.shape[1] - 1))
    return _finish(value, conv, live)


def decode_blocks_frags_chase(comp, fdst, fsrc, fper, fphase, nfrag,
                              out_len, blk: int, dense: int = 2,
                              doublings: int = 4, qcap: int = 0, *,
                              rounds: torch.Tensor | None = None):
    """As ``decode_blocks_frags``, by pointer doubling (counterpart of
    ``_batched_frag_decoder_chase``): chains of up to ``2 ** dense``
    hops converge in the dense rounds; the first ``qcap`` bytes (0:
    ``max(blk / 8, 1024)``) still open after them get ``doublings``
    more.  ``ok`` is 0 for a block with a byte that did not converge.
    The ``frag_decode_chase`` kernel for CUDA tensors -- its state in a
    thread-block cluster's shared memory for blocks up to 256 KB
    (``chase_cluster_size``), in device scratch for larger ones -- the
    plain version for CPU tensors.  ``rounds``, an int32[B] CUDA tensor,
    receives each block's dense rounds plus its frontier rounds << 16
    from the kernel (ignored on the CPU)."""
    if comp.device.type == "cpu":
        return decode_blocks_frags_chase_plain(
            comp, fdst, fsrc, fper, fphase, nfrag, out_len, blk, dense,
            doublings, qcap)
    tables, out, ok = _kernel_io(
        (comp, fdst, fsrc, fper, fphase, nfrag, out_len), blk)
    B, dev = out.shape[0], out.device
    rounds = _rounds_arg(rounds, B, dev)
    if B:
        q = min(_chase_pool(blk, qcap), blk) if doublings > 0 else 1
        C = chase_cluster_size(blk)
        if C:       # the state in the cluster's shared memory: no scratch
            nx = words = pool = 0
        else:
            nx = torch.empty((B, 2, blk), dtype=torch.int32, device=dev)
            words = _scratch_words(B, 2, blk, dev)
            pool = torch.empty((B, q), dtype=torch.int32, device=dev)
        launch("frag_decode_chase", *tables, nx, words, pool, out, ok,
               rounds, B, comp.shape[1],
               fdst.shape[1], blk, max(int(dense), 0),
               max(int(doublings), 0), q, C)
    return out, ok
