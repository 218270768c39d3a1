"""LZ4 HC codec -- high-compression modes, levels 2-12.

Canonical (oracle) implementation of the three HC strategies
(reference: src/lz4hc.zig):

  * LZ4MID   (level 2)      -- dual 4-byte/8-byte hash tables, greedy
                               (reference: src/lz4hc.zig:687-971)
  * hash-chain (levels 3-9) -- chain-table search, 4..256 attempts,
                               pattern analysis at level >= 9
                               (reference: src/lz4hc.zig:976-1064,514-681)
  * optimal (levels 10-12)  -- dynamic-programming parser over up to
                               4096 positions with a byte-exact price
                               model (reference: src/lz4hc.zig:1068-1391)

All strategies operate on a (window, start) pair so the same code
serves one-shot and streaming compression: positions below ``start``
are history (previous blocks / dictionary) that matches may reference
but that is never re-emitted.  Indices live in a global, monotonically
increasing coordinate space beginning at 64KB, mirroring the
reference's index rebase (reference: src/lz4hc.zig:1533-1551) so that
0 remains the empty-slot sentinel.

Documented divergences (wire-valid; ratio >= reference):
  1. Hash-chain matches extend backward into the pending literal run
     (the C reference's behavior); the Zig port passes iLowLimit = ip
     so its ``back`` is always 0.
  2. The optimal parser's early-exit branch (match longer than
     sufficient_len found mid-DP) emits the *reversed path* up to that
     position before the long match.  The Zig port walks raw DP
     entries forward (src/lz4hc.zig:1216-1255), which misinterprets
     "match ending at pos" as "match starting at pos" and can emit
     corrupt sequences; we implement the correct traversal.
  3. ``is_repetitive_pattern`` uses the upstream C predicate (16-bit
     period check); the Zig port's extra byte check reduces it to
     period-1 patterns only.
  4. StreamHC keeps history in one logically contiguous buffer, so
     cross-block matches work for *all* levels including MID (the
     reference's compressMID resets the context per block and its
     fast-path streaming never dictionary-matches at all).
"""

from __future__ import annotations

from ..constants import (
    LASTLITERALS,
    LZ4_DISTANCE_MAX,
    LZ4_MAX_INPUT_SIZE,
    MFLIMIT,
    MINMATCH,
    ML_MASK,
    RUN_MASK,
    WINDOW_SIZE,
)
from ..errors import InputTooLarge, OutputTooSmall
from .block import _count_match, _emit_length, _emit_literals_only

__all__ = [
    "LZ4HC_CLEVEL_MIN", "LZ4HC_CLEVEL_DEFAULT", "LZ4HC_CLEVEL_OPT_MIN",
    "LZ4HC_CLEVEL_MAX", "Strategy", "get_level_params",
    "compress_hc", "compress_hc_ext_state", "sizeof_state_hc",
    "HCContext", "StreamHC",
]

# --- constants (reference: src/lz4hc.zig:27-51) ---

LZ4HC_CLEVEL_MIN = 2
LZ4HC_CLEVEL_DEFAULT = 9
LZ4HC_CLEVEL_OPT_MIN = 10
LZ4HC_CLEVEL_MAX = 12

LZ4HC_DICTIONARY_LOGSIZE = 16
LZ4HC_MAXD = 1 << LZ4HC_DICTIONARY_LOGSIZE          # 65536 chain entries
LZ4HC_MAXD_MASK = LZ4HC_MAXD - 1

LZ4HC_HASH_LOG = 15
LZ4HC_HASHTABLESIZE = 1 << LZ4HC_HASH_LOG           # 32768

LZ4_OPT_NUM = 1 << 12                               # 4096
OPTIMAL_ML = (ML_MASK - 1) + MINMATCH

LZ4MID_HASHLOG = LZ4HC_HASH_LOG - 1                 # 14
LZ4MID_HASHTABLESIZE = 1 << LZ4MID_HASHLOG          # 16384
LZ4MID_HASHSIZE = 8

_HASH_MULT32 = 2654435761
_HASH_MULT64 = 58295818150454627
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

#: Global index space starts here so 0 stays the "empty" sentinel
#: (reference rebases by +64KB, src/lz4hc.zig:1533-1551).
_GLOBAL_BASE = 1 << 16


class Strategy:
    """reference: src/lz4hc.zig:59-65."""
    lz4mid = "lz4mid"
    lz4hc = "lz4hc"
    lz4opt = "lz4opt"


#: Per-level (strategy, nb_searches, target_length)
#: reference: src/lz4hc.zig:72-86.
_CLEVEL_TABLE = {
    2: (Strategy.lz4mid, 2, 16),
    3: (Strategy.lz4hc, 4, 16),
    4: (Strategy.lz4hc, 8, 16),
    5: (Strategy.lz4hc, 16, 16),
    6: (Strategy.lz4hc, 32, 16),
    7: (Strategy.lz4hc, 64, 16),
    8: (Strategy.lz4hc, 128, 16),
    9: (Strategy.lz4hc, 256, 16),
    10: (Strategy.lz4opt, 96, 64),
    11: (Strategy.lz4opt, 512, 128),
    12: (Strategy.lz4opt, 16384, LZ4_OPT_NUM),
}


def get_level_params(level: int):
    """reference: src/lz4hc.zig:88-97 (clamp <1 -> default, >max -> max)."""
    if level < 1:
        level = LZ4HC_CLEVEL_DEFAULT
    if level > LZ4HC_CLEVEL_MAX:
        level = LZ4HC_CLEVEL_MAX
    if level == 1:
        level = LZ4HC_CLEVEL_MIN
    return _CLEVEL_TABLE[level]


# --- hashing (reference: src/lz4hc.zig:126-157) ---

def _hash_hc(seq32: int) -> int:
    return ((seq32 * _HASH_MULT32) & _M32) >> (32 - LZ4HC_HASH_LOG)


def _hash_mid4(seq32: int) -> int:
    return ((seq32 * _HASH_MULT32) & _M32) >> (32 - LZ4MID_HASHLOG)


def _hash_mid8(seq64: int) -> int:
    masked = (seq64 << 8) & _M64
    return ((masked * _HASH_MULT64) & _M64) >> (64 - LZ4MID_HASHLOG)


# --- pattern analysis (reference: src/lz4hc.zig:162-228) ---

def _is_repetitive_pattern(pattern: int) -> bool:
    """Upstream C predicate: 16-bit period (divergence 3)."""
    return (pattern & 0xFFFF) == (pattern >> 16)


def _count_pattern(window, start: int, end: int, pattern: int) -> int:
    """Bytes from ``start`` matching the repeating 4-byte LE pattern."""
    pat = pattern.to_bytes(4, "little")
    n = 0
    limit = end - start
    # compare in growing chunks against a replicated pattern
    rep = pat * 128
    while n + 512 <= limit and window[start + n:start + n + 512] == rep:
        n += 512
    while n < limit and window[start + n] == pat[n & 3]:
        n += 1
    return n


def _reverse_count_pattern(window, start: int, low: int, pattern: int) -> int:
    """Bytes immediately before ``start`` continuing the pattern backward."""
    pat = pattern.to_bytes(4, "little")
    n = 0
    while start - n > low and window[start - n - 1] == pat[3 - (n & 3)]:
        n += 1
    return n


def _count_back(window, ip: int, mp: int, ip_min: int, mp_min: int) -> int:
    """Backward common-byte count; returns a value <= 0.

    reference: src/lz4hc.zig:267-297 (countBack).
    """
    back = 0
    limit = min(ip - ip_min, mp - mp_min)
    while back < limit and window[ip - back - 1] == window[mp - back - 1]:
        back += 1
    return -back


# --- context ---

class HCContext:
    """Hash + chain tables in global index space.

    reference: src/lz4hc.zig:391-446 (Context).  ``base_g`` maps
    window-local index 0 to a global index; ``low_limit_g`` is the
    oldest referenceable global index.
    """

    __slots__ = ("hash_table", "chain_table", "mid4", "mid8",
                 "next_to_update", "base_g", "low_limit_g")

    def __init__(self):
        self.reset()

    def reset(self):
        self.hash_table = [0] * LZ4HC_HASHTABLESIZE
        self.chain_table = [0] * LZ4HC_MAXD
        self.mid4 = None   # allocated lazily by the MID strategy
        self.mid8 = None
        self.next_to_update = _GLOBAL_BASE
        self.base_g = _GLOBAL_BASE
        self.low_limit_g = _GLOBAL_BASE


def _insert_hc(ctx: HCContext, window, target_local: int) -> None:
    """Insert every position in [next_to_update, target) into the
    hash/chain tables (reference: src/lz4hc.zig:491-510)."""
    base = ctx.base_g
    target_g = base + target_local
    idx = ctx.next_to_update
    ht, ct = ctx.hash_table, ctx.chain_table
    from_bytes = int.from_bytes
    while idx < target_g:
        local = idx - base
        h = _hash_hc(from_bytes(window[local:local + 4], "little"))
        prev = ht[h]
        delta = idx - prev if prev <= idx else LZ4_DISTANCE_MAX + 1
        ct[idx & LZ4HC_MAXD_MASK] = min(delta, LZ4_DISTANCE_MAX)
        ht[h] = idx
        idx += 1
    ctx.next_to_update = target_g


def _search(ctx: HCContext, window, ip: int, low_ip: int, high: int,
            longest: int, nb_attempts: int, pattern_analysis: bool):
    """Insert up to ip, then walk the chain for the best match.

    Returns (length, offset, back) with back <= 0; length <= longest
    means no match.  reference: src/lz4hc.zig:514-681
    (insertAndFindBestMatch / insertAndGetWiderMatch).
    """
    _insert_hc(ctx, window, ip)
    base = ctx.base_g
    ip_g = base + ip
    lowest_g = max(ctx.low_limit_g, ip_g - LZ4_DISTANCE_MAX)
    low_floor_local = ctx.low_limit_g - base
    from_bytes = int.from_bytes
    pattern = from_bytes(window[ip:ip + 4], "little")

    best_len, best_off, best_back = longest, 0, 0
    ct = ctx.chain_table
    m_g = ctx.hash_table[_hash_hc(pattern)]
    attempts = nb_attempts

    while m_g > 0 and attempts > 0:
        if m_g > ip_g or ip_g - m_g > LZ4_DISTANCE_MAX:
            break
        attempts -= 1
        if m_g >= lowest_g:
            m_local = m_g - base
            if from_bytes(window[m_local:m_local + 4], "little") == pattern:
                mlt = MINMATCH + _count_match(
                    window, ip + MINMATCH, m_local + MINMATCH, high)
                back = 0
                if ip > low_ip:
                    back = _count_back(window, ip, m_local,
                                       low_ip, low_floor_local)
                total = mlt - back
                if total > best_len:
                    best_len, best_off, best_back = total, ip_g - m_g, back
                    if total > nb_attempts:   # early exit heuristic
                        break                 # (reference: lz4hc.zig:613)
        delta = ct[m_g & LZ4HC_MAXD_MASK]
        if delta == 0 or delta > m_g:
            break
        m_g -= delta

    # pattern-analysis rescue (levels >= 9; reference: lz4hc.zig:626-678)
    if pattern_analysis and best_len > 0 and m_g > 0:
        delta = ct[m_g & LZ4HC_MAXD_MASK]
        if delta == 1 and _is_repetitive_pattern(pattern):
            src_pat_len = _count_pattern(window, ip + 4, high, pattern) + 4
            cand_g = m_g - 1
            if cand_g >= lowest_g:
                cand_local = cand_g - base
                if (cand_local >= 0 and
                        from_bytes(window[cand_local:cand_local + 4],
                                   "little") == pattern):
                    fwd = _count_pattern(window, cand_local + 4, high,
                                         pattern) + 4
                    back_len = _reverse_count_pattern(
                        window, cand_local, max(low_floor_local, 0), pattern)
                    limited_back = cand_g - max(cand_g - back_len, lowest_g)
                    seg = limited_back + fwd
                    max_ml = min(seg, src_pat_len)
                    if seg >= src_pat_len and fwd <= src_pat_len:
                        new_m_g = cand_g + fwd - src_pat_len
                    else:
                        new_m_g = cand_g - limited_back
                    if max_ml > best_len and ip_g - new_m_g <= LZ4_DISTANCE_MAX:
                        best_len, best_off, best_back = max_ml, ip_g - new_m_g, 0

    return best_len, best_off, best_back


# --- sequence emission ---

def _emit_sequence(out: bytearray, window, anchor: int, ip: int,
                   offset: int, mlen: int,
                   max_output: int | None) -> None:
    """Token + literals + offset + extended match length.

    reference: src/lz4hc.zig:301-386 (encodeSequence).
    """
    lit_len = ip - anchor
    token_pos = len(out)
    out.append(0)
    if lit_len >= RUN_MASK:
        out[token_pos] = RUN_MASK << 4
        _emit_length(out, lit_len)
    else:
        out[token_pos] = lit_len << 4
    out += window[anchor:ip]
    out.append(offset & 0xFF)
    out.append(offset >> 8)
    ml_token = mlen - MINMATCH
    if ml_token >= ML_MASK:
        out[token_pos] |= ML_MASK
        _emit_length(out, ml_token)
    else:
        out[token_pos] |= ml_token
    if max_output is not None and len(out) > max_output:
        raise OutputTooSmall(
            f"compressed output {len(out)} exceeds budget {max_output}")


def _final_literals(window, out: bytearray, anchor: int, end: int,
                    max_output: int | None) -> None:
    if end > anchor:
        _emit_literals_only(window, out, anchor, end)
    if max_output is not None and len(out) > max_output:
        raise OutputTooSmall(
            f"compressed output {len(out)} exceeds budget {max_output}")


# --- strategy: LZ4MID (level 2) ---

def _mid_seed_match_start(ctx, window, ip, ilimit, read32, read64):
    """Seed tables at match start +1/+2 (reference: lz4hc.zig:766-779)."""
    base = ctx.base_g
    if ip + 1 <= ilimit:
        ctx.mid8[_hash_mid8(read64(window[ip + 1:ip + 9], "little"))] = base + ip + 1
        ctx.mid4[_hash_mid4(read32(window[ip + 1:ip + 5], "little"))] = base + ip + 1
    if ip + 2 <= ilimit:
        ctx.mid8[_hash_mid8(read64(window[ip + 2:ip + 10], "little"))] = base + ip + 2


def _mid_seed_match_end(ctx, window, ip, start, ilimit, read32, read64):
    """Seed tables at match end -5/-3/-2/-1 (reference: lz4hc.zig:789-819)."""
    base = ctx.base_g
    for off, tables in ((5, ("mid8",)), (3, ("mid8",)),
                        (2, ("mid8", "mid4")), (1, ("mid4",))):
        p = ip - off
        if p >= start and p <= ilimit:
            for t in tables:
                if t == "mid8":
                    ctx.mid8[_hash_mid8(read64(window[p:p + 8], "little"))] = base + p
                else:
                    ctx.mid4[_hash_mid4(read32(window[p:p + 4], "little"))] = base + p


def _compress_mid(ctx: HCContext, window, start: int, out: bytearray,
                  max_output: int | None) -> None:
    """Level-2 dual-table greedy (reference: src/lz4hc.zig:687-971)."""
    if ctx.mid4 is None:
        ctx.mid4 = [0] * LZ4MID_HASHTABLESIZE
        ctx.mid8 = [0] * LZ4MID_HASHTABLESIZE
    n = len(window)
    mflimit = n - MFLIMIT
    match_limit = n - LASTLITERALS
    ilimit = n - LZ4MID_HASHSIZE
    base = ctx.base_g
    lowf = ctx.low_limit_g
    read32 = read64 = int.from_bytes
    h4t, h8t = ctx.mid4, ctx.mid8

    ip = start
    anchor = start

    while ip <= mflimit:
        ip_g = base + ip
        lowest_g = max(lowf, ip_g - LZ4_DISTANCE_MAX)
        m_len = 0
        m_dist = 0

        if ip <= ilimit:
            # long-match probe (8-byte hash)
            h8 = _hash_mid8(read64(window[ip:ip + 8], "little"))
            pos8 = h8t[h8]
            h8t[h8] = ip_g
            if pos8 >= lowest_g and pos8 < ip_g:
                mp = pos8 - base
                mlt = _count_match(window, ip, mp, match_limit)
                if mlt >= MINMATCH:
                    m_len, m_dist = mlt, ip_g - pos8

            if m_len == 0:
                # short-match probe (4-byte hash)
                h4 = _hash_mid4(read32(window[ip:ip + 4], "little"))
                pos4 = h4t[h4]
                h4t[h4] = ip_g
                if pos4 >= lowest_g and pos4 < ip_g:
                    mp = pos4 - base
                    mlt = _count_match(window, ip, mp, match_limit)
                    if mlt >= MINMATCH:
                        m_len, m_dist = mlt, ip_g - pos4
                        # lookahead: longer 8-byte match at ip+1?
                        if ip < mflimit and ip + 1 <= ilimit:
                            h8n = _hash_mid8(
                                read64(window[ip + 1:ip + 9], "little"))
                            pos8n = h8t[h8n]
                            if (pos8n > 0 and pos8n < ip_g + 1
                                    and ip_g + 1 - pos8n <= LZ4_DISTANCE_MAX
                                    and pos8n >= lowest_g):
                                ml2 = _count_match(window, ip + 1,
                                                   pos8n - base, match_limit)
                                if ml2 > m_len:
                                    h8t[h8n] = ip_g + 1
                                    ip += 1
                                    ip_g += 1
                                    m_len, m_dist = ml2, ip_g - pos8n

        if m_len == 0:
            ip += 1 + ((ip - anchor) >> 9)   # incompressible skip
            continue

        _mid_seed_match_start(ctx, window, ip, ilimit, read32, read64)
        _emit_sequence(out, window, anchor, ip, m_dist, m_len, max_output)
        ip += m_len
        anchor = ip
        _mid_seed_match_end(ctx, window, ip, start, ilimit, read32, read64)

    _final_literals(window, out, anchor, n, max_output)


# --- strategy: hash chain (levels 3-9) ---

def _compress_hash_chain(ctx: HCContext, window, start: int,
                         nb_searches: int, out: bytearray,
                         max_output: int | None) -> None:
    """Greedy best-of-chain (reference: src/lz4hc.zig:976-1064), with
    backward extension enabled (divergence 1)."""
    n = len(window)
    pattern_analysis = nb_searches > 128   # levels >= 9
    mflimit = n - MFLIMIT
    match_limit = n - LASTLITERALS
    ip = start
    anchor = start

    while ip <= mflimit:
        mlen, off, back = _search(ctx, window, ip, anchor, match_limit,
                                  MINMATCH - 1, nb_searches,
                                  pattern_analysis)
        if mlen < MINMATCH or off == 0:
            ip += 1
            continue
        start_pos = ip + back
        _emit_sequence(out, window, anchor, start_pos, off, mlen, max_output)
        ip = start_pos + mlen
        anchor = ip

    _final_literals(window, out, anchor, n, max_output)


# --- strategy: optimal parser (levels 10-12) ---

def _literals_price(litlen: int) -> int:
    """reference: src/lz4hc.zig:466-472."""
    price = litlen
    if litlen >= RUN_MASK:
        price += 1 + (litlen - RUN_MASK) // 255
    return price


def _sequence_price(litlen: int, mlen: int) -> int:
    """reference: src/lz4hc.zig:476-486 (requires mlen >= MINMATCH)."""
    price = 3 + _literals_price(litlen)   # token + 16-bit offset
    if mlen >= ML_MASK + MINMATCH:
        price += 1 + (mlen - (ML_MASK + MINMATCH)) // 255
    return price


def _reverse_path(opt, last: int) -> None:
    """In-place reverse traversal: after this, opt[pos] at path nodes
    holds the step *starting* at pos (reference: src/lz4hc.zig:1314-1332)."""
    sel_ml = opt[last][2]
    sel_off = opt[last][1]
    pos = last - sel_ml
    while True:
        nml = opt[pos][2]
        noff = opt[pos][1]
        opt[pos] = (opt[pos][0], sel_off, sel_ml, opt[pos][3])
        sel_ml, sel_off = nml, noff
        if nml > pos:
            break
        pos -= nml


def _emit_path(opt, upto: int, window, ip: int, anchor: int, out,
               max_output):
    """Emit reversed-path sequences for positions [0, upto).
    Returns (new_ip, new_anchor)."""
    rp = 0
    while rp < upto:
        ml = opt[rp][2]
        if ml == 1:
            ip += 1
            rp += 1
            continue
        off = opt[rp][1]
        rp += ml
        _emit_sequence(out, window, anchor, ip, off, ml, max_output)
        ip += ml
        anchor = ip
    return ip, anchor


def _compress_optimal(ctx: HCContext, window, start: int, nb_searches: int,
                      sufficient_len: int, out: bytearray,
                      max_output: int | None) -> None:
    """DP parser (reference: src/lz4hc.zig:1068-1391).

    opt[pos] = (price, off, mlen, litlen): cheapest known way to reach
    ``pos`` bytes past the current anchor point; mlen==1 means the last
    step was a literal.
    """
    TRAILING = 3
    n = len(window)
    mflimit = n - MFLIMIT
    match_limit = n - LASTLITERALS
    if sufficient_len >= LZ4_OPT_NUM:
        sufficient_len = LZ4_OPT_NUM - 1

    ip = start
    anchor = start
    opt = [None] * (LZ4_OPT_NUM + TRAILING)

    while ip <= mflimit:
        llen = ip - anchor
        f_len, f_off, _ = _search(ctx, window, ip, ip, match_limit,
                                  MINMATCH - 1, nb_searches, True)
        if f_len < MINMATCH or f_off == 0:
            ip += 1
            continue

        if f_len > sufficient_len:
            _emit_sequence(out, window, anchor, ip, f_off, f_len, max_output)
            ip += f_len
            anchor = ip
            continue

        # --- init DP with literals and the first match ---
        for r in range(MINMATCH):
            opt[r] = (_literals_price(llen + r), 0, 1, llen + r)
        for ml in range(MINMATCH, f_len + 1):
            opt[ml] = (_sequence_price(llen, ml), f_off, ml, llen)
        last = f_len
        for al in range(1, TRAILING + 1):
            opt[last + al] = (opt[last][0] + _literals_price(al), 0, 1, al)

        # --- explore positions ---
        cur = 1
        early = None
        while cur < last:
            if ip + cur > mflimit:
                break
            if opt[cur + 1][0] <= opt[cur][0]:
                cur += 1
                continue
            m_len, m_off, _ = _search(ctx, window, ip + cur, ip + cur,
                                      match_limit, MINMATCH - 1,
                                      nb_searches, True)
            if m_len < MINMATCH or m_off == 0:
                cur += 1
                continue

            if m_len > sufficient_len or m_len + cur >= LZ4_OPT_NUM:
                early = (cur, m_len, m_off)
                break

            # literal extensions from cur
            base_lit = opt[cur][3]
            for lit in range(1, MINMATCH):
                price = (opt[cur][0] - _literals_price(base_lit)
                         + _literals_price(base_lit + lit))
                pos = cur + lit
                if price < opt[pos][0]:
                    opt[pos] = (price, 0, 1, base_lit + lit)

            # match extensions from cur
            for ml in range(MINMATCH, m_len + 1):
                pos = cur + ml
                if opt[cur][2] == 1:
                    ll = opt[cur][3]
                    prev = opt[cur - ll][0] if cur > ll else 0
                    price = prev + _sequence_price(ll, ml)
                else:
                    ll = 0
                    price = opt[cur][0] + _sequence_price(0, ml)
                if pos > last + TRAILING or price <= opt[pos][0]:
                    if ml == m_len and last < pos:
                        last = pos
                    opt[pos] = (price, m_off, ml, ll)

            for al in range(1, TRAILING + 1):
                opt[last + al] = (opt[last][0] + _literals_price(al),
                                  0, 1, al)
            cur += 1

        if early is not None:
            # A long match at `cur` ends the DP: emit the optimal path
            # up to cur, then the long match (divergence 2: the
            # reference's forward walk of raw DP entries is unsound).
            cur, m_len, m_off = early
            if cur > 0:
                _reverse_path(opt, cur)
                ip, anchor = _emit_path(opt, cur, window, ip, anchor,
                                        out, max_output)
            _emit_sequence(out, window, anchor, ip, m_off, m_len,
                           max_output)
            ip += m_len
            anchor = ip
            continue

        # --- backtrack best path to `last` and emit ---
        _reverse_path(opt, last)
        ip, anchor = _emit_path(opt, last, window, ip, anchor, out,
                                max_output)

    _final_literals(window, out, anchor, n, max_output)


# --- dispatch (reference: src/lz4hc.zig:1440-1494) ---

def _compress_hc_core(ctx: HCContext, window, start: int, level: int,
                      out: bytearray, max_output: int | None) -> None:
    strat, nb, target = get_level_params(level)
    n = len(window)
    if n - start < MFLIMIT + 1:
        _final_literals(window, out, start, n, max_output)
        return
    if strat == Strategy.lz4mid:
        _compress_mid(ctx, window, start, out, max_output)
    elif strat == Strategy.lz4hc:
        _compress_hash_chain(ctx, window, start, nb, out, max_output)
    else:
        _compress_optimal(ctx, window, start, nb, target, out, max_output)


def compress_hc(src, level: int = LZ4HC_CLEVEL_DEFAULT,
                max_output: int | None = None) -> bytes:
    """One-shot HC compression (reference: src/lz4hc.zig:1440-1455).

    Dispatches to the C++ native runtime when available (bit-identical
    to this module's oracle; tests/test_native.py enforces parity)."""
    src = bytes(src)
    n = len(src)
    if n > LZ4_MAX_INPUT_SIZE:
        raise InputTooLarge(f"input {n} > {LZ4_MAX_INPUT_SIZE}")
    if n == 0:
        return b""
    from ..native import native_compress_hc
    out_n = native_compress_hc(src, level, max_output)
    if out_n is not None:
        return out_n
    out = bytearray()
    ctx = HCContext()
    _compress_hc_core(ctx, src, 0, level, out, max_output)
    return bytes(out)


def compress_hc_oracle(src, level: int = LZ4HC_CLEVEL_DEFAULT,
                       max_output: int | None = None) -> bytes:
    """Pure-Python HC (the oracle the native runtime must match)."""
    src = bytes(src)
    if len(src) > LZ4_MAX_INPUT_SIZE:
        raise InputTooLarge(f"input {len(src)} > {LZ4_MAX_INPUT_SIZE}")
    if not src:
        return b""
    out = bytearray()
    _compress_hc_core(HCContext(), src, 0, level, out, max_output)
    return bytes(out)


def compress_hc_ext_state(ctx: HCContext, src,
                          level: int = LZ4HC_CLEVEL_DEFAULT,
                          max_output: int | None = None) -> bytes:
    """Caller-owned-state variant (reference: src/lz4hc.zig:1457-1472).
    The context is reset before use."""
    ctx.reset()
    src = bytes(src)
    if len(src) > LZ4_MAX_INPUT_SIZE:
        raise InputTooLarge(f"input {len(src)} > {LZ4_MAX_INPUT_SIZE}")
    if not src:
        return b""
    out = bytearray()
    _compress_hc_core(ctx, src, 0, level, out, max_output)
    return bytes(out)


def sizeof_state_hc() -> int:
    """reference: src/lz4hc.zig:1490-1494 (hash + chain table bytes)."""
    return LZ4HC_HASHTABLESIZE * 4 + LZ4HC_MAXD * 2


# --- streaming (reference: src/lz4hc.zig:1557-1735) ---

class StreamHC:
    """Stateful HC compressor with true cross-block 64KB history.

    reference: src/lz4hc.zig:1557-1735 (StreamHC) -- re-designed around
    one logically contiguous history buffer in global index space
    (divergence 4), which subsumes the reference's prefix/extDict
    pointer juggling and makes every level (including MID) stream-aware.
    """

    def __init__(self, level: int = LZ4HC_CLEVEL_DEFAULT):
        self.level = level
        self.reset()

    def reset(self, level: int | None = None) -> None:
        if level is not None:
            self.level = level
        self.ctx = HCContext()
        self.buf = b""             # last <= 64KB of history
        # backend choice is per-stream and sticky: the native backend
        # carries PERSISTENT hash/chain tables across blocks
        # (NativeHCStream, reference lz4hc.zig:1601-1660 semantics) --
        # outputs are deterministic within a backend but not byte
        # -identical across backends -- both are valid LZ4 with true
        # cross-block matching and cross-decode freely
        from ..native import is_available
        self._native = is_available()
        self._nstream = None       # lazy NativeHCStream

    def set_compression_level(self, level: int) -> None:
        """reference: setCompressionLevel -- takes effect next block."""
        self.level = level

    def load_dict(self, dictionary) -> int:
        """Prime with a dictionary (reference: src/lz4hc.zig:1662-1695).
        Insertion is lazy: positions enter the chain tables on first
        search, giving full-dictionary matching (the reference inserts
        only the final 3 positions)."""
        d = bytes(dictionary)[-WINDOW_SIZE:]
        self.reset()
        self.buf = d
        return len(d)

    def save_dict(self, max_size: int = WINDOW_SIZE) -> bytes:
        """reference: src/lz4hc.zig:1700-1734."""
        return self.buf[-min(max_size, WINDOW_SIZE):]

    def _native_compress(self, window, start, max_output):
        """Persistent-table native path; None when native is gone.
        On OutputTooSmall the native context marks itself dirty and
        rebuilds from its window on the next call, so the failed
        call's partial insertions never corrupt later blocks."""
        if self._nstream is None:
            try:
                from ..native import NativeHCStream
                self._nstream = NativeHCStream()
            except RuntimeError:
                return None
        return self._nstream.compress(window, start, self.level,
                                      max_output)

    def compress_continue(self, src, max_output: int | None = None) -> bytes:
        """Compress the next block against prior history.

        On ``OutputTooSmall`` the stream state is *not* advanced; the
        caller should re-prime via ``load_dict(save_dict() + raw)`` if
        it stores the block uncompressed (the frame layer does).
        """
        src = bytes(src)
        n = len(src)
        if n > LZ4_MAX_INPUT_SIZE:
            raise InputTooLarge(f"input {n} > {LZ4_MAX_INPUT_SIZE}")
        if n == 0:
            return b""
        window = self.buf + src
        start = len(self.buf)
        if self._native:
            res = self._native_compress(window, start, max_output)
            if res is not None:       # raises OutputTooSmall unslid
                drop = max(len(window) - WINDOW_SIZE, 0)
                self.buf = window[drop:]
                return res
            self._native = False      # native vanished: stay python
        out = bytearray()
        _compress_hc_core(self.ctx, window, start, self.level, out,
                          max_output)
        # commit: slide window, rebase
        drop = max(len(window) - WINDOW_SIZE, 0)
        self.buf = window[drop:]
        self.ctx.base_g += drop
        self.ctx.low_limit_g = self.ctx.base_g
        self.ctx.next_to_update = max(self.ctx.next_to_update,
                                      self.ctx.base_g)
        return bytes(out)

    def state_dict(self) -> dict:
        return {
            "level": self.level,
            "buf": self.buf,
            "native": self._native,
            "hash_table": list(self.ctx.hash_table),
            "chain_table": list(self.ctx.chain_table),
            "mid4": list(self.ctx.mid4) if self.ctx.mid4 else None,
            "mid8": list(self.ctx.mid8) if self.ctx.mid8 else None,
            "next_to_update": self.ctx.next_to_update,
            "base_g": self.ctx.base_g,
            "low_limit_g": self.ctx.low_limit_g,
            # native-mode streams checkpoint the persistent C++ tables
            # byte-exactly, so a restored stream continues
            # byte-identically to the uninterrupted one
            "nstream": (self._nstream.export_state()
                        if self._native and self._nstream is not None
                        else None),
        }

    def load_state_dict(self, st: dict) -> None:
        self.level = st["level"]
        self.buf = bytes(st["buf"])
        c = HCContext()
        c.hash_table = list(st["hash_table"])
        c.chain_table = list(st["chain_table"])
        c.mid4 = list(st["mid4"]) if st["mid4"] else None
        c.mid8 = list(st["mid8"]) if st["mid8"] else None
        c.next_to_update = st["next_to_update"]
        c.base_g = st["base_g"]
        c.low_limit_g = st["low_limit_g"]
        self.ctx = c
        self._nstream = None
        if not st.get("native", False):
            # a python-mode checkpoint carries live chain tables;
            # continue in python mode so the restored stream's output
            # matches the uninterrupted one byte-for-byte
            self._native = False
        else:
            from ..native import is_available
            self._native = is_available()
            blob = st.get("nstream")
            if self._native and blob:
                from ..native import NativeHCStream
                self._nstream = NativeHCStream()
                self._nstream.import_state(blob)
            # native checkpoint restored WITHOUT native available (or
            # without a blob, from an older checkpoint): the stream
            # stays valid -- python mode / a fresh native context
            # rebuilds matching state from ``buf`` -- but post-restore
            # bytes may differ from the uninterrupted stream's
