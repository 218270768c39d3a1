// zig_lz4_tpu_torch native host runtime -- C++ implementation of the
// canonical LZ4 block codec, xxHash32, and the sequence parser that
// feeds the device decode path.
//
// This is a from-scratch implementation of the same canonical
// algorithm as ops/block.py (the Python oracle); outputs
// are byte-identical and tests enforce that.  It plays the role the
// reference implementation's compiled Zig plays on the host: wire
// format serialization at memory bandwidth, so the device pipeline is
// never bottlenecked on Python.
//
// Reference analogs (behavior, not code):
//   compress_fast     -- reference: src/lz4.zig:292-447
//   decompress        -- reference: src/lz4.zig:89-251
//   xxh32             -- Zig std.hash.XxHash32 (frame checksums)
//
// Exported with a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>
#include <thread>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------------
// xxHash32
// ---------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

static const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                      P4 = 668265263u, P5 = 374761393u;

static inline uint32_t read32le(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86/ARM)
}

static inline uint16_t read16le(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

uint32_t lz4tpu_xxh32(const uint8_t* data, size_t len, uint32_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t a1 = seed + P1 + P2, a2 = seed + P2, a3 = seed,
                 a4 = seed - P1;
        const uint8_t* limit = end - 16;
        do {
            a1 = rotl32(a1 + read32le(p) * P2, 13) * P1; p += 4;
            a2 = rotl32(a2 + read32le(p) * P2, 13) * P1; p += 4;
            a3 = rotl32(a3 + read32le(p) * P2, 13) * P1; p += 4;
            a4 = rotl32(a4 + read32le(p) * P2, 13) * P1; p += 4;
        } while (p <= limit);
        h = rotl32(a1, 1) + rotl32(a2, 7) + rotl32(a3, 12) + rotl32(a4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h = rotl32(h + read32le(p) * P3, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h = rotl32(h + (*p) * P5, 11) * P1;
        ++p;
    }
    h ^= h >> 15; h *= P2;
    h ^= h >> 13; h *= P3;
    h ^= h >> 16;
    return h;
}

// streaming xxh32 state (for frame content checksums over big corpora)
struct XXH32State {
    uint32_t a1, a2, a3, a4;
    uint64_t total;
    uint32_t seed;
    uint8_t buf[16];
    uint32_t buflen;
};

void lz4tpu_xxh32_init(XXH32State* st, uint32_t seed) {
    st->a1 = seed + P1 + P2; st->a2 = seed + P2;
    st->a3 = seed; st->a4 = seed - P1;
    st->total = 0; st->seed = seed; st->buflen = 0;
}

void lz4tpu_xxh32_update(XXH32State* st, const uint8_t* data, size_t len) {
    st->total += len;
    if (st->buflen) {
        while (st->buflen < 16 && len) {
            st->buf[st->buflen++] = *data++;
            --len;
        }
        if (st->buflen == 16) {
            const uint8_t* p = st->buf;
            st->a1 = rotl32(st->a1 + read32le(p) * P2, 13) * P1;
            st->a2 = rotl32(st->a2 + read32le(p + 4) * P2, 13) * P1;
            st->a3 = rotl32(st->a3 + read32le(p + 8) * P2, 13) * P1;
            st->a4 = rotl32(st->a4 + read32le(p + 12) * P2, 13) * P1;
            st->buflen = 0;
        }
    }
    while (len >= 16) {
        st->a1 = rotl32(st->a1 + read32le(data) * P2, 13) * P1;
        st->a2 = rotl32(st->a2 + read32le(data + 4) * P2, 13) * P1;
        st->a3 = rotl32(st->a3 + read32le(data + 8) * P2, 13) * P1;
        st->a4 = rotl32(st->a4 + read32le(data + 12) * P2, 13) * P1;
        data += 16; len -= 16;
    }
    while (len--) st->buf[st->buflen++] = *data++;
}

uint32_t lz4tpu_xxh32_digest(const XXH32State* st) {
    uint32_t h;
    if (st->total >= 16) {
        h = rotl32(st->a1, 1) + rotl32(st->a2, 7) + rotl32(st->a3, 12)
            + rotl32(st->a4, 18);
    } else {
        h = st->seed + P5;
    }
    h += (uint32_t)st->total;
    const uint8_t* p = st->buf;
    const uint8_t* end = st->buf + st->buflen;
    while (p + 4 <= end) {
        h = rotl32(h + read32le(p) * P3, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h = rotl32(h + (*p) * P5, 11) * P1;
        ++p;
    }
    h ^= h >> 15; h *= P2;
    h ^= h >> 13; h *= P3;
    h ^= h >> 16;
    return h;
}

size_t lz4tpu_xxh32_state_size() { return sizeof(XXH32State); }

// ---------------------------------------------------------------------
// Canonical fast block compressor (bit-identical to the Python oracle)
// ---------------------------------------------------------------------

static const int HASHLOG = 12;
static const int MINMATCH = 4;
static const int MFLIMIT = 12;
static const int LASTLITERALS = 5;
static const int SKIP_TRIGGER = 6;

static inline uint32_t hash4(uint32_t seq) {
    return (seq * 2654435761u) >> (32 - HASHLOG);
}

// error codes (match errors.py BLOCK_ERROR_CODES)
#define ERR_OUTPUT_TOO_SMALL (-1)
#define ERR_INPUT_TOO_LARGE (-2)
#define ERR_CORRUPT (-3)

static int64_t emit_final_literals(const uint8_t* src, size_t anchor,
                                   size_t n, uint8_t* dst, size_t cap,
                                   size_t op) {
    size_t lit = n - anchor;
    size_t need = 1 + (lit >= 15 ? 1 + (lit - 15) / 255 : 0) + lit;
    if (op + need > cap) return ERR_OUTPUT_TOO_SMALL;
    if (lit >= 15) {
        dst[op++] = 15 << 4;
        size_t v = lit - 15;
        while (v >= 255) { dst[op++] = 255; v -= 255; }
        dst[op++] = (uint8_t)v;
    } else {
        dst[op++] = (uint8_t)(lit << 4);
    }
    std::memcpy(dst + op, src + anchor, lit);
    return (int64_t)(op + lit);
}

// Core loop over window[start..]; table stores (base + pos + 1).
// Mirrors ops/block.py::_compress_sequences exactly.
static int64_t compress_window(const uint8_t* w, size_t n, size_t start,
                               int accel, uint8_t* dst, size_t cap,
                               int64_t* table, int64_t base,
                               int64_t window_floor) {
    if (accel < 1) accel = 1;
    if (accel > 65537) accel = 65537;
    size_t anchor = start;
    size_t ip = (start == 0) ? 1 : start;
    size_t op = 0;
    if (n - start == 0) return 0;
    if (n < MFLIMIT + (size_t)1 + start || n - MFLIMIT <= ip ||
        n - start < MFLIMIT + 1) {
        return emit_final_literals(w, anchor, n, dst, cap, op);
    }
    size_t mflimit = n - MFLIMIT;
    size_t match_limit = n - LASTLITERALS;

    for (;;) {
        // --- search ---
        size_t step = 1;
        size_t search_match_nb = (size_t)accel << SKIP_TRIGGER;
        int64_t cand;
        uint32_t seq;
        for (;;) {
            if (ip >= mflimit)
                return emit_final_literals(w, anchor, n, dst, cap, op);
            seq = read32le(w + ip);
            uint32_t h = hash4(seq);
            int64_t entry = table[h];
            table[h] = base + (int64_t)ip + 1;
            if (entry) {
                cand = entry - 1 - base;
                if (cand >= window_floor &&
                    cand + 65535 >= (int64_t)ip &&
                    cand < (int64_t)ip &&
                    read32le(w + cand) == seq)
                    break;
            }
            ip += step;
            step = search_match_nb >> SKIP_TRIGGER;
            search_match_nb += 1;
        }

        // --- backward extension ---
        while (ip > anchor && cand > window_floor && w[ip - 1] == w[cand - 1]) {
            --ip; --cand;
        }

        // --- match length ---
        size_t mlen = MINMATCH;
        {
            size_t a = ip + MINMATCH, b = (size_t)cand + MINMATCH;
            while (a + 8 <= match_limit) {
                uint64_t x, y;
                std::memcpy(&x, w + a, 8);
                std::memcpy(&y, w + b, 8);
                uint64_t diff = x ^ y;
                if (diff) {
                    mlen += (size_t)(__builtin_ctzll(diff) >> 3);
                    goto have_len;
                }
                a += 8; b += 8; mlen += 8;
            }
            while (a < match_limit && w[a] == w[b]) { ++a; ++b; ++mlen; }
        }
    have_len:;

        // --- emit sequence ---
        {
            size_t lit = ip - anchor;
            size_t ml_token = mlen - MINMATCH;
            size_t need = 1 + (lit >= 15 ? 1 + (lit - 15) / 255 : 0) + lit
                          + 2 + (ml_token >= 15 ? 1 + (ml_token - 15) / 255 : 0);
            if (op + need > cap) return ERR_OUTPUT_TOO_SMALL;
            size_t token_pos = op++;
            if (lit >= 15) {
                dst[token_pos] = 15 << 4;
                size_t v = lit - 15;
                while (v >= 255) { dst[op++] = 255; v -= 255; }
                dst[op++] = (uint8_t)v;
            } else {
                dst[token_pos] = (uint8_t)(lit << 4);
            }
            std::memcpy(dst + op, w + anchor, lit);
            op += lit;
            size_t offset = ip - (size_t)cand;
            dst[op++] = (uint8_t)(offset & 0xFF);
            dst[op++] = (uint8_t)(offset >> 8);
            if (ml_token >= 15) {
                dst[token_pos] |= 15;
                size_t v = ml_token - 15;
                while (v >= 255) { dst[op++] = 255; v -= 255; }
                dst[op++] = (uint8_t)v;
            } else {
                dst[token_pos] |= (uint8_t)ml_token;
            }
        }

        ip += mlen;
        anchor = ip;
        if (ip >= mflimit)
            return emit_final_literals(w, anchor, n, dst, cap, op);

        uint32_t seq2 = read32le(w + ip - 2);
        table[hash4(seq2)] = base + (int64_t)ip - 1;
    }
}

int64_t lz4tpu_compress_fast(const uint8_t* src, size_t n, uint8_t* dst,
                             size_t cap, int accel) {
    if (n > 0x7E000000u) return ERR_INPUT_TOO_LARGE;
    if (n == 0) return 0;
    if (n < MFLIMIT + 1)
        return emit_final_literals(src, 0, n, dst, cap, 0);
    int64_t table[1 << HASHLOG];
    std::memset(table, 0, sizeof(table));
    return compress_window(src, n, 0, accel, dst, cap, table, 0, 0);
}

// Streaming entry: caller owns the table (4096 x int64 storing
// base + pos + 1 in global stream coordinates).
int64_t lz4tpu_compress_window(const uint8_t* window, size_t wlen,
                               size_t start, int accel, uint8_t* dst,
                               size_t cap, int64_t* table, int64_t base,
                               int64_t window_floor) {
    if (wlen - start > 0x7E000000u) return ERR_INPUT_TOO_LARGE;
    if (wlen == start) return 0;
    if (wlen - start < MFLIMIT + 1)
        return emit_final_literals(window, start, wlen, dst, cap, 0);
    return compress_window(window, wlen, start, accel, dst, cap, table,
                           base, window_floor);
}

// ---------------------------------------------------------------------
// Generic decompressor (mirrors ops/block.py::_decompress_generic)
// ---------------------------------------------------------------------

int64_t lz4tpu_decompress_generic(const uint8_t* src, size_t n,
                                  uint8_t* dst, size_t cap,
                                  int64_t target,          // -1 = full
                                  const uint8_t* prefix, size_t plen,
                                  const uint8_t* dict, size_t dlen) {
    if (n == 0) return 0;
    if (cap == 0) return 0;
    size_t full_target = (target < 0) ? cap
                         : ((size_t)target < cap ? (size_t)target : cap);
    size_t ip = 0, op = 0;
    bool partial = target >= 0;

    while (ip < n) {
        uint8_t token = src[ip++];
        size_t lit = token >> 4;
        if (lit == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = src[ip++];
                lit += x;
                if (x != 255) break;
            }
        }
        if (lit) {
            if (ip + lit > n) return ERR_CORRUPT;
            size_t room = full_target - op;
            if (lit > room) {
                if (!partial) return ERR_OUTPUT_TOO_SMALL;
                std::memcpy(dst + op, src + ip, room);
                return (int64_t)(op + room);
            }
            std::memcpy(dst + op, src + ip, lit);
            ip += lit; op += lit;
        }
        if (ip >= n) break;

        if (ip + 2 > n) return ERR_CORRUPT;
        size_t offset = read16le(src + ip);
        ip += 2;
        if (offset == 0) return ERR_CORRUPT;

        size_t ml = token & 15;
        if (ml == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = src[ip++];
                ml += x;
                if (x != 255) break;
            }
        }
        ml += MINMATCH;

        size_t room = full_target - op;
        bool clamped = ml > room;
        if (clamped && !partial) return ERR_OUTPUT_TOO_SMALL;
        size_t take = clamped ? room : ml;

        if (offset <= op) {
            size_t mpos = op - offset;
            if (offset >= take) {
                std::memmove(dst + op, dst + mpos, take);
                op += take;
            } else {
                for (size_t k = 0; k < take; ++k)
                    dst[op + k] = dst[mpos + k];
                op += take;
            }
        } else if (offset <= op + plen) {
            size_t back = offset - op;
            size_t from_prefix = back < take ? back : take;
            std::memcpy(dst + op, prefix + plen - back, from_prefix);
            op += from_prefix;
            size_t rest = take - from_prefix;
            // source index (op + k) - offset is >= 0 here because the
            // prefix bytes were just materialized into dst
            for (size_t k = 0; k < rest; ++k)
                dst[op + k] = dst[(op + k) - offset];
            op += rest;
        } else if (offset <= op + plen + dlen) {
            size_t back = offset - op - plen;
            size_t from_dict = back < take ? back : take;
            std::memcpy(dst + op, dict + dlen - back, from_dict);
            op += from_dict;
            size_t rest = take - from_dict;
            size_t from_pref = rest < plen ? rest : plen;
            std::memcpy(dst + op, prefix, from_pref);
            op += from_pref;
            rest -= from_pref;
            for (size_t k = 0; k < rest; ++k)
                dst[op + k] = dst[(op + k) - offset];
            op += rest;
        } else {
            return ERR_CORRUPT;
        }
        if (clamped) return (int64_t)op;
    }
    return (int64_t)op;
}

int64_t lz4tpu_decompress_safe(const uint8_t* src, size_t n, uint8_t* dst,
                               size_t cap) {
    return lz4tpu_decompress_generic(src, n, dst, cap, -1, nullptr, 0,
                                     nullptr, 0);
}

// ---------------------------------------------------------------------
// Sequence parser for the device decode path (host side of two-phase
// decode; the device does the gather-heavy reconstruction).
// ---------------------------------------------------------------------

int64_t lz4tpu_parse_sequences(const uint8_t* comp, size_t n,
                               int32_t* lit, int32_t* lsrc, int32_t* ml,
                               int32_t* off, size_t cap,
                               size_t history_len) {
    size_t ip = 0, op = 0, q = 0;
    while (ip < n) {
        if (q >= cap) return ERR_CORRUPT;
        uint8_t token = comp[ip++];
        size_t l = token >> 4;
        if (l == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = comp[ip++];
                l += x;
                if (x != 255) break;
            }
        }
        if (ip + l > n) return ERR_CORRUPT;
        lit[q] = (int32_t)l;
        lsrc[q] = (int32_t)ip;
        ip += l; op += l;
        if (ip >= n) {
            ml[q] = 0; off[q] = 1; ++q;
            break;
        }
        if (ip + 2 > n) return ERR_CORRUPT;
        size_t o = read16le(comp + ip);
        ip += 2;
        if (o == 0 || o > op + history_len) return ERR_CORRUPT;
        size_t m = token & 15;
        if (m == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = comp[ip++];
                m += x;
                if (x != 255) break;
            }
        }
        m += MINMATCH;
        op += m;
        ml[q] = (int32_t)m;
        off[q] = (int32_t)o;
        ++q;
    }
    return (int64_t)q;
}

// Batched block parse: one call for a whole frame's worth of blocks.
// comp = concatenated payloads; offs[i]/lens[i] delimit block i.
// Outputs are [nblocks, nseq_cap] row-major int32 arrays + per-block
// sequence counts.  Returns 0, or -(block_index+1) on corruption.
int64_t lz4tpu_parse_blocks(const uint8_t* comp, const int64_t* offs,
                            const int64_t* lens, size_t nblocks,
                            int32_t* lit, int32_t* lsrc, int32_t* ml,
                            int32_t* off, int32_t* nseq,
                            size_t nseq_cap, size_t history_len) {
    for (size_t bi = 0; bi < nblocks; ++bi) {
        int64_t r = lz4tpu_parse_sequences(
            comp + offs[bi], (size_t)lens[bi],
            lit + bi * nseq_cap, lsrc + bi * nseq_cap,
            ml + bi * nseq_cap, off + bi * nseq_cap, nseq_cap,
            history_len);
        if (r < 0) return -(int64_t)(bi + 1);
        nseq[bi] = (int32_t)r;
    }
    return 0;
}

// Tail of one block stream, for joining sub-span streams into one block
// (mirrors ops/block.py::_scan_tail): the position of the final
// literals-only sequence's token, and where its literals start and how
// many there are.  A stream that ends on a match gives (n, n, 0).
// Returns 0, or ERR_CORRUPT on a stream cut inside a sequence.
int64_t lz4tpu_scan_tail(const uint8_t* src, size_t n, int64_t* tok_pos,
                         int64_t* lit_start, int64_t* lit_len) {
    size_t ip = 0;
    while (ip < n) {
        const size_t tp = ip;
        const uint8_t token = src[ip++];
        size_t l = token >> 4;
        if (l == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = src[ip++];
                l += x;
                if (x != 255) break;
            }
        }
        if (l > n - ip) return ERR_CORRUPT;
        const size_t ls = ip;
        ip += l;
        if (ip == n) {
            *tok_pos = (int64_t)tp;
            *lit_start = (int64_t)ls;
            *lit_len = (int64_t)l;
            return 0;
        }
        if (n - ip < 2) return ERR_CORRUPT;
        ip += 2;
        if ((token & 15) == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                if (src[ip++] != 255) break;
            }
        }
    }
    *tok_pos = *lit_start = (int64_t)n;
    *lit_len = 0;
    return 0;
}

// ---------------------------------------------------------------------
// Fragment resolution for round-bounded device decode.
//
// Resolves matches in a compressed block to fragments the device
// reconstructs with sorts + fills.  Every output byte is either
//   LIT  fragment (per == 0): out[dst + k] = fetch[src + k]
//        where fetch = [history | comp] (src already includes the
//        hist_len shift)
//   PER  fragment (per >  0): out[dst + k] = out[src + (phase+k) % per]
//        with [src, src+per) strictly before dst; the byte only
//        reads output bytes of round <= this fragment's round-1.
//
// Fully chasing every match to absolute literal sources (round-1
// behavior) explodes the fragment count on match-dense data (median
// ~33K fragments per 64KB block).  Instead the per-match split is
// capped at `split_max` segments; a match that would over-fragment
// becomes ONE PER copy-fragment referencing the output window
// directly, with round = 1 + max round of the bytes it reads
// (tracked per output byte in `byte_round`).  Device cost grows by
// one cheap merge pass per round; fragment count stays near the
// sequence count.  reference decode semantics: src/lz4.zig:89-251.
//
// Returns per-block fragment counts, or -1 in nfrag[b] when the
// fragment budget overflows (caller falls back to another decoder).
// ---------------------------------------------------------------------

struct Frag {
    int32_t dst, len, src, per, phase, round;
};

static int64_t resolve_block(const uint8_t* comp, size_t n,
                             Frag* frags, size_t fcap, int32_t* rounds_out,
                             uint8_t* byte_round, int32_t* frag_of,
                             int64_t out_cap, int64_t hist_len,
                             int split_max, int round_limit) {
    size_t nf = 0;
    size_t ip = 0, op = 0;
    int32_t max_round = 0;
    if (round_limit > 250) round_limit = 250;   // byte_round is u8

    // frag_of[p] = index of the fragment covering output byte p,
    // maintained on every emission -- O(1) chain chasing (the binary
    // search this replaces dominated resolve time on match-dense
    // blocks)
    auto mark = [&](int32_t d0, int32_t len, int32_t fi) {
        for (int32_t k = 0; k < len; ++k) frag_of[d0 + k] = fi;
    };
    auto find = [&](int32_t p) -> size_t {
        return (size_t)frag_of[p];
    };

    while (ip < n) {
        uint8_t token = comp[ip++];
        size_t lit = token >> 4;
        if (lit == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = comp[ip++];
                lit += x;
                if (x != 255) break;
            }
        }
        if (ip + lit > n) return ERR_CORRUPT;
        if (lit) {
            // over-cap blocks are marked (not errors) so one bad block
            // cannot fail a whole batch; the caller's host route
            // raises the proper taxonomy error
            if (nf >= fcap || (int64_t)(op + lit) > out_cap)
                return -1000;
            frags[nf] = {(int32_t)op, (int32_t)lit,
                         (int32_t)(hist_len + ip), 0, 0, 0};
            mark((int32_t)op, (int32_t)lit, (int32_t)nf);
            ++nf;
            memset(byte_round + op, 0, lit);
            op += lit; ip += lit;
        }
        if (ip >= n) break;
        if (ip + 2 > n) return ERR_CORRUPT;
        size_t off = read16le(comp + ip);
        ip += 2;
        if (off == 0 || (int64_t)off > (int64_t)op + hist_len)
            return ERR_CORRUPT;
        size_t ml = token & 15;
        if (ml == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = comp[ip++];
                ml += x;
                if (x != 255) break;
            }
        }
        ml += MINMATCH;
        if ((int64_t)(op + ml) > out_cap) return -1000;

        // head: the non-self-overlapping part
        size_t take = ml < off ? ml : off;
        int32_t s = (int32_t)op - (int32_t)off;
        int32_t d = (int32_t)op;

        // Walk the covering fragments, emitting up to split_max
        // segments; if the head would over-fragment, ROLL BACK and
        // emit one PER copy-fragment instead (round = 1 + max source
        // byte round, bounded by round_limit).  Single pass: the
        // rollback is a simple nf reset since appends are contiguous.
        size_t nf0 = nf;
        int32_t rmax_seen = max_round;
        bool split_done = false;
        {
            int nseg = 0;
            int32_t cur = s, remaining = (int32_t)take;
            int32_t dd = d;
            bool over = false;
            while (remaining > 0) {
                if (++nseg > split_max && s >= 0) { over = true; break; }
                if (nf >= fcap) {
                    // budget pressure mid-split: prefer the single
                    // rollback copy-fragment (parity with the mirror)
                    if (s >= 0) { over = true; break; }
                    return -1000;
                }
                if (cur < 0) {      // history bytes: direct fetch rows
                    int32_t seg = -cur < remaining ? -cur : remaining;
                    frags[nf] = {dd, seg, (int32_t)(hist_len + cur),
                                 0, 0, 0};
                    mark(dd, seg, (int32_t)nf);
                    ++nf;
                    memset(byte_round + dd, 0, seg);
                    dd += seg; cur += seg; remaining -= seg;
                    continue;
                }
                const Frag f = frags[find(cur)];
                int32_t into = cur - f.dst;
                int32_t seg = f.len - into;
                if (seg > remaining) seg = remaining;
                if (f.per == 0) {
                    frags[nf] = {dd, seg, f.src + into, 0, 0, 0};
                    memset(byte_round + dd, 0, seg);
                } else {
                    int32_t ph = (int32_t)((f.phase + into) % f.per);
                    frags[nf] = {dd, seg, f.src, f.per, ph, f.round};
                    memset(byte_round + dd,
                           (uint8_t)(f.round > 250 ? 250 : f.round), seg);
                    if (f.round > max_round) max_round = f.round;
                }
                mark(dd, seg, (int32_t)nf);
                ++nf;
                dd += seg; cur += seg; remaining -= seg;
            }
            split_done = !over;
        }
        if (!split_done) {
            // copy-fragment round: 1 + max round of the bytes it reads
            int32_t mr = 0;
            for (size_t k = 0; k < take; ++k)
                if (byte_round[s + k] > mr) mr = byte_round[s + k];
            int32_t copy_round = mr + 1;
            if (copy_round <= round_limit) {
                nf = nf0;               // roll back the partial split
                max_round = rmax_seen;
                if (nf >= fcap) return -1000;
                frags[nf] = {d, (int32_t)take, s, (int32_t)off, 0,
                             copy_round};
                mark(d, (int32_t)take, (int32_t)nf);
                ++nf;
                memset(byte_round + d, (uint8_t)copy_round, take);
                if (copy_round > max_round) max_round = copy_round;
            } else {
                // finish the full split from where the walk stopped
                int32_t done = 0;
                for (size_t k = nf0; k < nf; ++k) done += frags[k].len;
                int32_t cur = s + done, remaining = (int32_t)take - done;
                int32_t dd = d + done;
                while (remaining > 0) {
                    if (nf >= fcap) return -1000;
                    const Frag f = frags[find(cur)];
                    int32_t into = cur - f.dst;
                    int32_t seg = f.len - into;
                    if (seg > remaining) seg = remaining;
                    if (f.per == 0) {
                        frags[nf] = {dd, seg, f.src + into, 0, 0, 0};
                        memset(byte_round + dd, 0, seg);
                    } else {
                        int32_t ph = (int32_t)((f.phase + into) % f.per);
                        frags[nf] = {dd, seg, f.src, f.per, ph,
                                     f.round};
                        memset(byte_round + dd,
                               (uint8_t)(f.round > 250 ? 250 : f.round),
                               seg);
                        if (f.round > max_round) max_round = f.round;
                    }
                    mark(dd, seg, (int32_t)nf);
                    ++nf;
                    dd += seg; cur += seg; remaining -= seg;
                }
            }
        }

        // tail: self-overlap -> periodic fragment.  FLATTENED (round
        // 5): the match copies [s, s+off) to [op, op+off), so tail
        // byte q = out[op + (q-op)%off] = out[s + (q-op)%off] -- it
        // can read the PRE-EXISTING window [s, s+read_n) directly, at
        // 1 + THAT span's max round instead of 1 + the head's (one
        // round deeper whenever the head rolled back to a copy
        // -fragment -- exactly the nesting that drove 12-round deep
        // -tier chains).  History-reaching heads (s < 0) keep the
        // head-window form: PER sources must be output positions.
        if (ml > take) {
            if (nf >= fcap) return -1000;
            size_t read_n = ml - take < off ? ml - take : off;
            int32_t tsrc = s >= 0 ? s : (int32_t)op;
            int32_t mr = 0;
            for (size_t k = 0; k < read_n; ++k)
                if (byte_round[tsrc + k] > mr) mr = byte_round[tsrc + k];
            int32_t r = mr + 1;
            frags[nf] = {(int32_t)(op + take), (int32_t)(ml - take),
                         tsrc, (int32_t)off, 0, r};
            mark((int32_t)(op + take), (int32_t)(ml - take),
                 (int32_t)nf);
            ++nf;
            memset(byte_round + op + take, (uint8_t)(r > 250 ? 250 : r),
                   ml - take);
            if (r > max_round) max_round = r;
        }
        op += ml;
    }
    *rounds_out = max_round;
    return (int64_t)nf;
}

// Threaded over blocks (independent work items, dynamic dispatch via
// an atomic cursor so cheap/expensive blocks balance).  Scratch
// buffers are per-thread; the output arrays are written at disjoint
// per-block offsets, so no synchronization is needed beyond the
// cursor and the first-error slot.  n_threads <= 1 runs inline.
int64_t lz4tpu_resolve_blocks(const uint8_t* comp, const int64_t* offs,
                              const int64_t* lens, size_t nblocks,
                              int32_t* fdst, int32_t* flen,
                              int32_t* fsrc, int32_t* fper,
                              int32_t* fphase, int32_t* nfrag,
                              int32_t* rounds, size_t fcap,
                              int64_t* out_lens, int64_t out_cap,
                              int64_t hist_len, int32_t split_max,
                              int32_t round_limit, int32_t n_threads) {
    std::atomic<size_t> cursor(0);
    std::atomic<int64_t> err(0);
    auto worker = [&]() {
        Frag* scratch = new Frag[fcap];
        uint8_t* byte_round = new uint8_t[(size_t)out_cap + 1];
        int32_t* frag_of = new int32_t[(size_t)out_cap + 1];
        for (;;) {
            size_t bi = cursor.fetch_add(1);
            if (bi >= nblocks || err.load(std::memory_order_relaxed))
                break;
            int32_t r = 0;
            int64_t nf = resolve_block(comp + offs[bi], (size_t)lens[bi],
                                       scratch, fcap, &r, byte_round,
                                       frag_of, out_cap, hist_len,
                                       (int)split_max, (int)round_limit);
            if (nf == -1000) {        // budget overflow: mark block
                nfrag[bi] = -1;
                rounds[bi] = 0;
                out_lens[bi] = 0;
                continue;
            }
            if (nf < 0) {
                int64_t want = 0;
                err.compare_exchange_strong(want, -(int64_t)(bi + 1));
                break;
            }
            int64_t ol = 0;
            for (int64_t k = 0; k < nf; ++k) {
                fdst[bi * fcap + k] = scratch[k].dst;
                flen[bi * fcap + k] = scratch[k].len;
                fsrc[bi * fcap + k] = scratch[k].src;
                fper[bi * fcap + k] = scratch[k].per;
                fphase[bi * fcap + k] = scratch[k].phase;
                ol = scratch[k].dst + scratch[k].len;
            }
            nfrag[bi] = (int32_t)nf;
            rounds[bi] = r;
            out_lens[bi] = ol;
        }
        delete[] scratch;
        delete[] byte_round;
        delete[] frag_of;
    };
    size_t nt = n_threads > 0 ? (size_t)n_threads : 1;
    if (nt > nblocks) nt = nblocks ? nblocks : 1;
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> ths;
        ths.reserve(nt);
        for (size_t t = 0; t < nt; ++t) ths.emplace_back(worker);
        for (auto& th : ths) th.join();
    }
    return err.load();
}

// ---------------------------------------------------------------------
// Per-byte literal-source map ("T-map") resolution -- round 5.
//
// Host-side FULL path compression of the LZ77 chain: every output
// byte's value is ultimately some byte of the fetch buffer
// ([history | payload]), and T[p] is that fetch coordinate.  The fill
// is memcpy-class: a match head copies the source span's T values
// (already final -- strictly before the write cursor), and a
// self-overlapping tail period-doubles this match's own just-written
// T prefix.  NO chains survive to the device: decode there is ONE
// parity-keyed fetch merge per block at 100% coverage -- no rounds,
// no tiers, no convergence budget (obsoletes the fragment ladder as
// the production default; the fragment engines remain as options).
// reference decode semantics: src/lz4.zig:89-251.
// ---------------------------------------------------------------------

static int64_t resolve_tmap_block(const uint8_t* comp, size_t n,
                                  int32_t* T, int64_t out_cap,
                                  int64_t hist_len) {
    size_t ip = 0, op = 0;
    while (ip < n) {
        uint8_t token = comp[ip++];
        size_t lit = token >> 4;
        if (lit == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = comp[ip++];
                lit += x;
                if (x != 255) break;
            }
        }
        if (ip + lit > n) return ERR_CORRUPT;
        if (lit) {
            if ((int64_t)(op + lit) > out_cap) return -1000;
            for (size_t k = 0; k < lit; ++k)
                T[op + k] = (int32_t)(hist_len + ip + k);
            op += lit; ip += lit;
        }
        if (ip >= n) break;
        if (ip + 2 > n) return ERR_CORRUPT;
        size_t off = read16le(comp + ip);
        ip += 2;
        if (off == 0 || (int64_t)off > (int64_t)op + hist_len)
            return ERR_CORRUPT;
        size_t ml = token & 15;
        if (ml == 15) {
            for (;;) {
                if (ip >= n) return ERR_CORRUPT;
                uint8_t x = comp[ip++];
                ml += x;
                if (x != 255) break;
            }
        }
        ml += MINMATCH;
        if ((int64_t)(op + ml) > out_cap) return -1000;
        size_t take = ml < off ? ml : off;
        int64_t s = (int64_t)op - (int64_t)off;
        if (s >= 0) {
            // head: the source span's T is final (strictly before op)
            std::memcpy(T + op, T + s, take * sizeof(int32_t));
        } else {
            // history-reaching head: history byte at rel h < 0 IS the
            // fetch coordinate hist_len + h; past the boundary the
            // span continues over this block's own (final) T
            size_t hb = (size_t)(-s) < take ? (size_t)(-s) : take;
            for (size_t k = 0; k < hb; ++k)
                T[op + k] = (int32_t)(hist_len + s + (int64_t)k);
            if (take > hb)
                std::memcpy(T + op + hb, T,
                            (take - hb) * sizeof(int32_t));
        }
        // self-overlap tail: period-double our own just-written span
        size_t done = take;
        while (done < ml) {
            size_t c = done < ml - done ? done : ml - done;
            std::memcpy(T + op + done, T + op, c * sizeof(int32_t));
            done += c;
        }
        op += ml;
    }
    return (int64_t)op;
}

// Threaded over blocks like lz4tpu_resolve_blocks; T rows at stride
// tstride.  out_lens[b] = decoded length, or -1 when the block
// overruns out_cap (caller falls back); corrupt streams return
// -(block+1) for the whole call.
int64_t lz4tpu_resolve_tmap(const uint8_t* comp, const int64_t* offs,
                            const int64_t* lens, size_t nblocks,
                            int32_t* T, int64_t tstride,
                            int64_t* out_lens, int64_t out_cap,
                            int64_t hist_len, int32_t n_threads) {
    std::atomic<size_t> cursor(0);
    std::atomic<int64_t> err(0);
    auto worker = [&]() {
        for (;;) {
            size_t bi = cursor.fetch_add(1);
            if (bi >= nblocks || err.load(std::memory_order_relaxed))
                break;
            int64_t r = resolve_tmap_block(comp + offs[bi],
                                           (size_t)lens[bi],
                                           T + bi * tstride, out_cap,
                                           hist_len);
            if (r == -1000) {
                out_lens[bi] = -1;
                continue;
            }
            if (r < 0) {
                int64_t want = 0;
                err.compare_exchange_strong(want, -(int64_t)(bi + 1));
                break;
            }
            out_lens[bi] = r;
        }
    };
    size_t nt = n_threads > 0 ? (size_t)n_threads : 1;
    if (nt > nblocks) nt = nblocks ? nblocks : 1;
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> ths;
        ths.reserve(nt);
        for (size_t t = 0; t < nt; ++t) ths.emplace_back(worker);
        for (auto& th : ths) th.join();
    }
    return err.load();
}

// Linked-frame T-map: the window's blocks share ONE frame-contiguous
// T array in GLOBAL output coordinates, and history-reaching matches
// path-compress through the previous blocks' T entries (already
// final fetch coordinates) -- so every byte of a linked window
// resolves to STATIC fetch data and device decode becomes as
// batch-parallel as independent-block decode (reference streaming
// prefix semantics: src/lz4.zig:870-957).
//
// lit_base[b] = fetch coordinate of block b's payload byte 0 inside
// the caller's flat fetch buffer; is_raw[b] != 0 marks
// store-uncompressed records (their bytes ARE fetch data).  The
// window-entry history (previous window's tail / dictionary) lives
// at fetch [dict_base, dict_base + dict_len).  Per-block output is
// bounded by blk_cap; sequential by construction (single thread).
// Returns total output length, or -(block+1) on corruption.
int64_t lz4tpu_resolve_tmap_linked(
    const uint8_t* comp, const int64_t* offs, const int64_t* lens,
    const int64_t* lit_base, const int8_t* is_raw, size_t nblocks,
    int64_t dict_base, int64_t dict_len,
    int32_t* T, int64_t tcap, int64_t* out_lens, int64_t blk_cap) {
    int64_t g = 0;                       // global output cursor
    for (size_t bi = 0; bi < nblocks; ++bi) {
        const uint8_t* src = comp + offs[bi];
        size_t n = (size_t)lens[bi];
        if (is_raw[bi]) {
            if (g + (int64_t)n > tcap) return -(int64_t)(bi + 1);
            for (size_t k = 0; k < n; ++k)
                T[g + k] = (int32_t)(lit_base[bi] + k);
            out_lens[bi] = (int64_t)n;
            g += n;
            continue;
        }
        size_t ip = 0;
        int64_t op = 0;                  // block-local output cursor
        while (ip < n) {
            uint8_t token = src[ip++];
            size_t lit = token >> 4;
            if (lit == 15) {
                for (;;) {
                    if (ip >= n) return -(int64_t)(bi + 1);
                    uint8_t x = src[ip++];
                    lit += x;
                    if (x != 255) break;
                }
            }
            if (ip + lit > n) return -(int64_t)(bi + 1);
            if (lit) {
                if (op + (int64_t)lit > blk_cap
                        || g + op + (int64_t)lit > tcap)
                    return -(int64_t)(bi + 1);
                for (size_t k = 0; k < lit; ++k)
                    T[g + op + k] = (int32_t)(lit_base[bi] + ip + k);
                op += lit; ip += lit;
            }
            if (ip >= n) break;
            if (ip + 2 > n) return -(int64_t)(bi + 1);
            size_t off = read16le(src + ip);
            ip += 2;
            if (off == 0 || (int64_t)off > g + op + dict_len)
                return -(int64_t)(bi + 1);
            size_t ml = token & 15;
            if (ml == 15) {
                for (;;) {
                    if (ip >= n) return -(int64_t)(bi + 1);
                    uint8_t x = src[ip++];
                    ml += x;
                    if (x != 255) break;
                }
            }
            ml += MINMATCH;
            if (op + (int64_t)ml > blk_cap
                    || g + op + (int64_t)ml > tcap)
                return -(int64_t)(bi + 1);
            size_t take = ml < off ? ml : off;
            int64_t gs = g + op - (int64_t)off;  // global source
            int64_t d = g + op;
            if (gs >= 0) {
                std::memcpy(T + d, T + gs, take * sizeof(int32_t));
            } else {
                // window-entry history: fetch bytes at the tail of
                // [dict_base, dict_base + dict_len)
                size_t hb = (size_t)(-gs) < take ? (size_t)(-gs)
                                                 : take;
                for (size_t k = 0; k < hb; ++k)
                    T[d + k] = (int32_t)(dict_base + dict_len + gs
                                         + (int64_t)k);
                if (take > hb)
                    std::memcpy(T + d + hb, T,
                                (take - hb) * sizeof(int32_t));
            }
            size_t done = take;
            while (done < ml) {          // period-doubling tail
                size_t c = done < ml - done ? done : ml - done;
                std::memcpy(T + d + done, T + d, c * sizeof(int32_t));
                done += c;
            }
            op += ml;
        }
        out_lens[bi] = op;
        g += op;
    }
    return g;
}

// Batched one-shot block compress: src = [nblocks, blk] row-major
// (lens[i] valid bytes each); outputs into dst rows of stride dcap.
// Returns 0 or -(block_index+1) on error.
int64_t lz4tpu_compress_blocks(const uint8_t* src, size_t blk,
                               const int64_t* lens, size_t nblocks,
                               uint8_t* dst, size_t dcap,
                               int64_t* out_lens, int accel) {
    int64_t table[1 << HASHLOG];
    for (size_t bi = 0; bi < nblocks; ++bi) {
        std::memset(table, 0, sizeof(table));
        size_t n = (size_t)lens[bi];
        const uint8_t* s = src + bi * blk;
        uint8_t* d = dst + bi * dcap;
        int64_t r;
        if (n == 0) r = 0;
        else if (n < (size_t)MFLIMIT + 1)
            r = emit_final_literals(s, 0, n, d, dcap, 0);
        else
            r = compress_window(s, n, 0, accel, d, dcap, table, 0, 0);
        if (r < 0) return -(int64_t)(bi + 1);
        out_lens[bi] = r;
    }
    return 0;
}

// Batched decompress: comp rows delimited by offs/lens; outputs into
// dst rows of stride blk.  Returns 0 or -(block_index+1).
int64_t lz4tpu_decompress_blocks(const uint8_t* comp, const int64_t* offs,
                                 const int64_t* lens, size_t nblocks,
                                 uint8_t* dst, size_t blk,
                                 int64_t* out_lens, int32_t n_threads) {
    size_t nt = n_threads > 0 ? (size_t)n_threads : 1;
    if (nt > nblocks) nt = nblocks ? nblocks : 1;
    if (nt > 1) {                 // independent rows: atomic cursor
        std::atomic<size_t> cursor(0);
        std::atomic<int64_t> err(0);
        auto worker = [&]() {
            for (;;) {
                size_t bi = cursor.fetch_add(1);
                if (bi >= nblocks
                    || err.load(std::memory_order_relaxed)) break;
                int64_t r = lz4tpu_decompress_generic(
                    comp + offs[bi], (size_t)lens[bi], dst + bi * blk,
                    blk, -1, nullptr, 0, nullptr, 0);
                if (r < 0) {
                    int64_t want = 0;
                    err.compare_exchange_strong(want,
                                                -(int64_t)(bi + 1));
                    break;
                }
                out_lens[bi] = r;
            }
        };
        std::vector<std::thread> ths;
        for (size_t t = 0; t < nt; ++t) ths.emplace_back(worker);
        for (auto& th : ths) th.join();
        return err.load();
    }
    for (size_t bi = 0; bi < nblocks; ++bi) {
        int64_t r = lz4tpu_decompress_generic(
            comp + offs[bi], (size_t)lens[bi], dst + bi * blk, blk,
            -1, nullptr, 0, nullptr, 0);
        if (r < 0) return -(int64_t)(bi + 1);
        out_lens[bi] = r;
    }
    return 0;
}

// ---------------------------------------------------------------------
// HC codec: levels 2-12, one-shot (bit-identical to ops/hc.py, which
// is the oracle; tests enforce parity).  Strategies:
//   level 2      LZ4MID dual-table greedy
//   levels 3-9   hash-chain search (4..256 attempts, pattern analysis
//                at >= 9)
//   levels 10-12 optimal parser (DP over <= 4096 positions)
// reference behavior: src/lz4hc.zig (see ops/hc.py for the per-
// function reference line map and documented divergences).
// ---------------------------------------------------------------------

namespace hc {

static const int HASH_LOG = 15;
static const int MAXD = 1 << 16;
static const int MAXD_MASK = MAXD - 1;
static const int MID_HASHLOG = 14;
static const int OPT_NUM = 1 << 12;
static const int64_t GLOBAL_BASE = 1 << 16;
static const size_t DIST_MAX = 65535;
static const int RUN_MASK_ = 15, ML_MASK_ = 15;

static inline uint64_t read64le(const uint8_t* p) {
    uint64_t v; std::memcpy(&v, p, 8); return v;
}
static inline uint32_t hash_hc(uint32_t s) {
    return (s * 2654435761u) >> (32 - HASH_LOG);
}
static inline uint32_t hash_mid4(uint32_t s) {
    return (s * 2654435761u) >> (32 - MID_HASHLOG);
}
static inline uint32_t hash_mid8(uint64_t s) {
    return (uint32_t)(((s << 8) * 58295818150454627ULL) >> (64 - MID_HASHLOG));
}

struct Ctx {
    int64_t* hash_table;     // [1<<15] global indices (0 = empty)
    uint16_t* chain_table;   // [1<<16] deltas
    int64_t* mid4;           // [1<<14]
    int64_t* mid8;           // [1<<14]
    int64_t next_to_update, base_g, low_limit_g;
};

struct Out {
    uint8_t* dst;
    size_t cap, len;
    bool overflow;
    void put(uint8_t b) {
        if (len >= cap) { overflow = true; return; }
        dst[len++] = b;
    }
    void copy(const uint8_t* s, size_t n) {
        if (len + n > cap) { overflow = true; return; }
        std::memcpy(dst + len, s, n);
        len += n;
    }
};

static inline size_t count_match(const uint8_t* w, size_t ip, size_t ref,
                                 size_t limit) {
    size_t n = 0;
    while (ip + n + 8 <= limit) {
        uint64_t x = read64le(w + ip + n) ^ read64le(w + ref + n);
        if (x) return n + (__builtin_ctzll(x) >> 3) <= limit - ip
                   ? n + (__builtin_ctzll(x) >> 3) : limit - ip;
        n += 8;
    }
    while (ip + n < limit && w[ip + n] == w[ref + n]) ++n;
    return n;
}

static inline int count_back(const uint8_t* w, size_t ip, size_t mp,
                             size_t ip_min, size_t mp_min) {
    int back = 0;
    int limit = (int)((ip - ip_min < mp - mp_min) ? ip - ip_min
                                                  : mp - mp_min);
    while (back < limit && w[ip - back - 1] == w[mp - back - 1]) ++back;
    return -back;
}

static inline bool is_rep_pattern(uint32_t p) {
    return (p & 0xFFFF) == (p >> 16);
}

static size_t count_pattern(const uint8_t* w, size_t start, size_t end,
                            uint32_t pattern) {
    uint8_t pat[4];
    std::memcpy(pat, &pattern, 4);
    size_t n = 0, limit = end > start ? end - start : 0;
    while (n < limit && w[start + n] == pat[n & 3]) ++n;
    return n;
}

static size_t rev_count_pattern(const uint8_t* w, size_t start, size_t low,
                                uint32_t pattern) {
    uint8_t pat[4];
    std::memcpy(pat, &pattern, 4);
    size_t n = 0;
    while (start - n > low && w[start - n - 1] == pat[3 - (n & 3)]) ++n;
    return n;
}

static void insert_hc(Ctx& c, const uint8_t* w, size_t target_local) {
    int64_t target_g = c.base_g + (int64_t)target_local;
    int64_t idx = c.next_to_update;
    while (idx < target_g) {
        size_t local = (size_t)(idx - c.base_g);
        uint32_t h = hash_hc(read32le(w + local));
        int64_t prev = c.hash_table[h];
        int64_t delta = (prev > 0 && prev <= idx) ? idx - prev
                                                  : (int64_t)DIST_MAX + 1;
        if (delta > (int64_t)DIST_MAX) delta = DIST_MAX;
        c.chain_table[idx & MAXD_MASK] = (uint16_t)delta;
        c.hash_table[h] = idx;
        ++idx;
    }
    c.next_to_update = target_g;
}

// returns (length via ret), offset + back via pointers
static int search(Ctx& c, const uint8_t* w, size_t ip, size_t low_ip,
                  size_t high, int longest, int nb_attempts,
                  bool pattern_analysis, size_t* off_out, int* back_out) {
    insert_hc(c, w, ip);
    int64_t ip_g = c.base_g + (int64_t)ip;
    int64_t lowest_g = ip_g - (int64_t)DIST_MAX;
    if (lowest_g < c.low_limit_g) lowest_g = c.low_limit_g;
    int64_t low_floor_local = c.low_limit_g - c.base_g;
    uint32_t pattern = read32le(w + ip);

    int best_len = longest;
    size_t best_off = 0;
    int best_back = 0;
    int64_t m_g = c.hash_table[hash_hc(pattern)];
    int attempts = nb_attempts;

    while (m_g > 0 && attempts > 0) {
        if (m_g > ip_g || ip_g - m_g > (int64_t)DIST_MAX) break;
        --attempts;
        if (m_g >= lowest_g) {
            size_t m_local = (size_t)(m_g - c.base_g);
            if (read32le(w + m_local) == pattern) {
                int mlt = MINMATCH + (int)count_match(
                    w, ip + MINMATCH, m_local + MINMATCH, high);
                int back = 0;
                if (ip > low_ip)
                    back = count_back(w, ip, m_local, low_ip,
                                      (size_t)(low_floor_local > 0
                                               ? low_floor_local : 0));
                int total = mlt - back;
                if (total > best_len) {
                    best_len = total;
                    best_off = (size_t)(ip_g - m_g);
                    best_back = back;
                    if (total > nb_attempts) break;
                }
            }
        }
        uint16_t delta = c.chain_table[m_g & MAXD_MASK];
        if (delta == 0 || (int64_t)delta > m_g) break;
        m_g -= delta;
    }

    if (pattern_analysis && best_len > 0 && m_g > 0) {
        uint16_t delta = c.chain_table[m_g & MAXD_MASK];
        if (delta == 1 && is_rep_pattern(pattern)) {
            size_t src_pat_len = count_pattern(w, ip + 4, high, pattern) + 4;
            int64_t cand_g = m_g - 1;
            if (cand_g >= lowest_g) {
                int64_t cand_local = cand_g - c.base_g;
                if (cand_local >= 0 &&
                    read32le(w + cand_local) == pattern) {
                    size_t fwd = count_pattern(w, (size_t)cand_local + 4,
                                               high, pattern) + 4;
                    size_t back_len = rev_count_pattern(
                        w, (size_t)cand_local,
                        (size_t)(low_floor_local > 0 ? low_floor_local : 0),
                        pattern);
                    int64_t lb_g = cand_g - (int64_t)back_len;
                    if (lb_g < lowest_g) lb_g = lowest_g;
                    int64_t limited_back = cand_g - lb_g;
                    int64_t seg = limited_back + (int64_t)fwd;
                    int64_t max_ml = seg < (int64_t)src_pat_len
                                     ? seg : (int64_t)src_pat_len;
                    int64_t new_m_g;
                    if (seg >= (int64_t)src_pat_len &&
                        fwd <= src_pat_len)
                        new_m_g = cand_g + (int64_t)fwd
                                  - (int64_t)src_pat_len;
                    else
                        new_m_g = cand_g - limited_back;
                    if (max_ml > best_len &&
                        ip_g - new_m_g <= (int64_t)DIST_MAX) {
                        best_len = (int)max_ml;
                        best_off = (size_t)(ip_g - new_m_g);
                        best_back = 0;
                    }
                }
            }
        }
    }

    *off_out = best_off;
    *back_out = best_back;
    return best_len;
}

static void emit_length_ext(Out& o, size_t length) {
    length -= RUN_MASK_;
    while (length >= 255) { o.put(255); length -= 255; }
    o.put((uint8_t)length);
}

static void emit_sequence(Out& o, const uint8_t* w, size_t anchor,
                          size_t ip, size_t offset, size_t mlen) {
    size_t lit_len = ip - anchor;
    size_t token_pos = o.len;
    o.put(0);
    if (o.overflow) return;
    if (lit_len >= RUN_MASK_) {
        o.dst[token_pos] = RUN_MASK_ << 4;
        emit_length_ext(o, lit_len);
    } else {
        o.dst[token_pos] = (uint8_t)(lit_len << 4);
    }
    o.copy(w + anchor, lit_len);
    o.put((uint8_t)(offset & 0xFF));
    o.put((uint8_t)(offset >> 8));
    size_t ml_token = mlen - MINMATCH;
    if (o.overflow) return;
    if (ml_token >= ML_MASK_) {
        o.dst[token_pos] |= ML_MASK_;
        emit_length_ext(o, ml_token);
    } else {
        o.dst[token_pos] |= (uint8_t)ml_token;
    }
}

static void final_literals(Out& o, const uint8_t* w, size_t anchor,
                           size_t end) {
    if (end <= anchor) return;
    size_t lit_len = end - anchor;
    if (lit_len >= RUN_MASK_) {
        o.put(RUN_MASK_ << 4);
        emit_length_ext(o, lit_len);
    } else {
        o.put((uint8_t)(lit_len << 4));
    }
    o.copy(w + anchor, lit_len);
}

// --- LZ4MID (level 2) ---

static void mid_seed_start(Ctx& c, const uint8_t* w, size_t ip,
                           size_t ilimit) {
    int64_t base = c.base_g;
    if (ip + 1 <= ilimit) {
        c.mid8[hash_mid8(read64le(w + ip + 1))] = base + (int64_t)ip + 1;
        c.mid4[hash_mid4(read32le(w + ip + 1))] = base + (int64_t)ip + 1;
    }
    if (ip + 2 <= ilimit)
        c.mid8[hash_mid8(read64le(w + ip + 2))] = base + (int64_t)ip + 2;
}

static void mid_seed_end(Ctx& c, const uint8_t* w, size_t ip,
                         size_t start, size_t ilimit) {
    int64_t base = c.base_g;
    const struct { int off; bool h8, h4; } seeds[4] = {
        {5, true, false}, {3, true, false}, {2, true, true},
        {1, false, true}};
    for (auto& s : seeds) {
        if (ip < (size_t)s.off + start) continue;
        size_t p = ip - s.off;
        if (p > ilimit) continue;
        if (s.h8) c.mid8[hash_mid8(read64le(w + p))] = base + (int64_t)p;
        if (s.h4) c.mid4[hash_mid4(read32le(w + p))] = base + (int64_t)p;
    }
}

static void compress_mid(Ctx& c, const uint8_t* w, size_t n, size_t start,
                         Out& o) {
    size_t mflimit = n - MFLIMIT;
    size_t match_limit = n - LASTLITERALS;
    size_t ilimit = n - 8;
    int64_t base = c.base_g, lowf = c.low_limit_g;
    size_t ip = start, anchor = start;

    while (ip <= mflimit && !o.overflow) {
        int64_t ip_g = base + (int64_t)ip;
        int64_t lowest_g = ip_g - (int64_t)DIST_MAX;
        if (lowest_g < lowf) lowest_g = lowf;
        size_t m_len = 0, m_dist = 0;

        if (ip <= ilimit) {
            uint32_t h8 = hash_mid8(read64le(w + ip));
            int64_t pos8 = c.mid8[h8];
            c.mid8[h8] = ip_g;
            if (pos8 >= lowest_g && pos8 < ip_g) {
                size_t mp = (size_t)(pos8 - base);
                size_t mlt = count_match(w, ip, mp, match_limit);
                if (mlt >= MINMATCH) {
                    m_len = mlt; m_dist = (size_t)(ip_g - pos8);
                }
            }
            if (m_len == 0) {
                uint32_t h4 = hash_mid4(read32le(w + ip));
                int64_t pos4 = c.mid4[h4];
                c.mid4[h4] = ip_g;
                if (pos4 >= lowest_g && pos4 < ip_g) {
                    size_t mp = (size_t)(pos4 - base);
                    size_t mlt = count_match(w, ip, mp, match_limit);
                    if (mlt >= MINMATCH) {
                        m_len = mlt; m_dist = (size_t)(ip_g - pos4);
                        if (ip < mflimit && ip + 1 <= ilimit) {
                            uint32_t h8n = hash_mid8(read64le(w + ip + 1));
                            int64_t pos8n = c.mid8[h8n];
                            if (pos8n > 0 && pos8n < ip_g + 1 &&
                                ip_g + 1 - pos8n <= (int64_t)DIST_MAX &&
                                pos8n >= lowest_g) {
                                size_t ml2 = count_match(
                                    w, ip + 1, (size_t)(pos8n - base),
                                    match_limit);
                                if (ml2 > m_len) {
                                    c.mid8[h8n] = ip_g + 1;
                                    ++ip; ++ip_g;
                                    m_len = ml2;
                                    m_dist = (size_t)(ip_g - pos8n);
                                }
                            }
                        }
                    }
                }
            }
        }

        if (m_len == 0) {
            ip += 1 + ((ip - anchor) >> 9);
            continue;
        }
        mid_seed_start(c, w, ip, ilimit);
        emit_sequence(o, w, anchor, ip, m_dist, m_len);
        ip += m_len;
        anchor = ip;
        mid_seed_end(c, w, ip, start, ilimit);
    }
    final_literals(o, w, anchor, n);
}

// --- hash chain (levels 3-9) ---

static void compress_hash_chain(Ctx& c, const uint8_t* w, size_t n,
                                size_t start, int nb, Out& o) {
    bool pa = nb > 128;
    size_t mflimit = n - MFLIMIT;
    size_t match_limit = n - LASTLITERALS;
    size_t ip = start, anchor = start;
    while (ip <= mflimit && !o.overflow) {
        size_t off; int back;
        int mlen = search(c, w, ip, anchor, match_limit, MINMATCH - 1,
                          nb, pa, &off, &back);
        if (mlen < MINMATCH || off == 0) { ++ip; continue; }
        size_t start_pos = ip + back;          // back <= 0
        emit_sequence(o, w, anchor, start_pos, off, (size_t)mlen);
        ip = start_pos + (size_t)mlen;
        anchor = ip;
    }
    final_literals(o, w, anchor, n);
}

// --- optimal parser (levels 10-12) ---

struct OptEntry { int price; int off; int mlen; int litlen; };

static inline int lit_price(int l) {
    int p = l;
    if (l >= RUN_MASK_) p += 1 + (l - RUN_MASK_) / 255;
    return p;
}
static inline int seq_price(int ll, int ml) {
    int p = 3 + lit_price(ll);
    if (ml >= ML_MASK_ + MINMATCH) p += 1 + (ml - (ML_MASK_ + MINMATCH)) / 255;
    return p;
}

static void reverse_path(OptEntry* opt, int last) {
    int sel_ml = opt[last].mlen, sel_off = opt[last].off;
    int pos = last - sel_ml;
    for (;;) {
        int nml = opt[pos].mlen, noff = opt[pos].off;
        opt[pos].off = sel_off;
        opt[pos].mlen = sel_ml;
        sel_ml = nml; sel_off = noff;
        if (nml > pos) break;
        pos -= nml;
    }
}

static void emit_path(OptEntry* opt, int upto, const uint8_t* w,
                      size_t* ip, size_t* anchor, Out& o) {
    int rp = 0;
    while (rp < upto) {
        int ml = opt[rp].mlen;
        if (ml == 1) { ++*ip; ++rp; continue; }
        int off = opt[rp].off;
        rp += ml;
        emit_sequence(o, w, *anchor, *ip, (size_t)off, (size_t)ml);
        *ip += ml;
        *anchor = *ip;
    }
}

static void compress_optimal(Ctx& c, const uint8_t* w, size_t n,
                             size_t start, int nb, int sufficient_len,
                             Out& o, OptEntry* opt) {
    const int TRAILING = 3;
    size_t mflimit = n - MFLIMIT;
    size_t match_limit = n - LASTLITERALS;
    if (sufficient_len >= OPT_NUM) sufficient_len = OPT_NUM - 1;

    size_t ip = start, anchor = start;
    while (ip <= mflimit && !o.overflow) {
        int llen = (int)(ip - anchor);
        size_t f_off; int f_back;
        int f_len = search(c, w, ip, ip, match_limit, MINMATCH - 1, nb,
                           true, &f_off, &f_back);
        if (f_len < MINMATCH || f_off == 0) { ++ip; continue; }

        if (f_len > sufficient_len) {
            emit_sequence(o, w, anchor, ip, f_off, (size_t)f_len);
            ip += (size_t)f_len;
            anchor = ip;
            continue;
        }

        for (int r = 0; r < MINMATCH; ++r)
            opt[r] = {lit_price(llen + r), 0, 1, llen + r};
        for (int ml = MINMATCH; ml <= f_len; ++ml)
            opt[ml] = {seq_price(llen, ml), (int)f_off, ml, llen};
        int last = f_len;
        for (int al = 1; al <= TRAILING; ++al)
            opt[last + al] = {opt[last].price + lit_price(al), 0, 1, al};

        int cur = 1;
        bool early = false;
        int e_cur = 0, e_len = 0;
        size_t e_off = 0;
        while (cur < last) {
            if (ip + (size_t)cur > mflimit) break;
            if (opt[cur + 1].price <= opt[cur].price) { ++cur; continue; }
            size_t m_off; int m_back;
            int m_len = search(c, w, ip + (size_t)cur, ip + (size_t)cur,
                               match_limit, MINMATCH - 1, nb, true,
                               &m_off, &m_back);
            if (m_len < MINMATCH || m_off == 0) { ++cur; continue; }

            if (m_len > sufficient_len || m_len + cur >= OPT_NUM) {
                early = true; e_cur = cur; e_len = m_len; e_off = m_off;
                break;
            }

            int base_lit = opt[cur].litlen;
            for (int lit = 1; lit < MINMATCH; ++lit) {
                int price = opt[cur].price - lit_price(base_lit)
                            + lit_price(base_lit + lit);
                int pos = cur + lit;
                if (price < opt[pos].price)
                    opt[pos] = {price, 0, 1, base_lit + lit};
            }
            for (int ml = MINMATCH; ml <= m_len; ++ml) {
                int pos = cur + ml;
                int ll, price;
                if (opt[cur].mlen == 1) {
                    ll = opt[cur].litlen;
                    int prev = cur > ll ? opt[cur - ll].price : 0;
                    price = prev + seq_price(ll, ml);
                } else {
                    ll = 0;
                    price = opt[cur].price + seq_price(0, ml);
                }
                if (pos > last + TRAILING || price <= opt[pos].price) {
                    if (ml == m_len && last < pos) last = pos;
                    opt[pos] = {price, (int)m_off, ml, ll};
                }
            }
            for (int al = 1; al <= TRAILING; ++al)
                opt[last + al] = {opt[last].price + lit_price(al), 0, 1,
                                  al};
            ++cur;
        }

        if (early) {
            if (e_cur > 0) {
                reverse_path(opt, e_cur);
                emit_path(opt, e_cur, w, &ip, &anchor, o);
            }
            emit_sequence(o, w, anchor, ip, e_off, (size_t)e_len);
            ip += (size_t)e_len;
            anchor = ip;
            continue;
        }

        reverse_path(opt, last);
        emit_path(opt, last, w, &ip, &anchor, o);
    }
    final_literals(o, w, anchor, n);
}

}  // namespace hc

int64_t lz4tpu_compress_hc(const uint8_t* src, size_t n, uint8_t* dst,
                           size_t cap, int level) {
    using namespace hc;
    if (n > 0x7E000000u) return ERR_INPUT_TOO_LARGE;
    if (n == 0) return 0;

    // level table (reference: src/lz4hc.zig:72-86; clamps as ops/hc.py)
    if (level < 1) level = 9;
    if (level > 12) level = 12;
    if (level == 1) level = 2;
    static const int nb_tab[13] = {0, 0, 2, 4, 8, 16, 32, 64, 128, 256,
                                   96, 512, 16384};
    static const int tl_tab[13] = {0, 0, 16, 16, 16, 16, 16, 16, 16, 16,
                                   64, 128, OPT_NUM};
    int nb = nb_tab[level], target = tl_tab[level];

    Out o{dst, cap, 0, false};
    if (n < (size_t)MFLIMIT + 1) {
        final_literals(o, src, 0, n);
        return o.overflow ? ERR_OUTPUT_TOO_SMALL : (int64_t)o.len;
    }

    Ctx c;
    std::vector<int64_t> ht(1 << HASH_LOG, 0);
    std::vector<uint16_t> ct(MAXD, 0);
    std::vector<int64_t> m4, m8;
    c.hash_table = ht.data();
    c.chain_table = ct.data();
    c.mid4 = c.mid8 = nullptr;
    c.next_to_update = GLOBAL_BASE;
    c.base_g = GLOBAL_BASE;
    c.low_limit_g = GLOBAL_BASE;

    if (level == 2) {
        m4.assign(1 << MID_HASHLOG, 0);
        m8.assign(1 << MID_HASHLOG, 0);
        c.mid4 = m4.data();
        c.mid8 = m8.data();
        compress_mid(c, src, n, 0, o);
    } else if (level <= 9) {
        compress_hash_chain(c, src, n, 0, nb, o);
    } else {
        std::vector<OptEntry> opt(OPT_NUM + 8);
        compress_optimal(c, src, n, 0, nb, target, o, opt.data());
    }
    return o.overflow ? ERR_OUTPUT_TOO_SMALL : (int64_t)o.len;
}

// Windowed HC: compress w[start, n) against the full window (history
// [0, start) reachable through the lazy chain insertion the
// compressors already do).  Streaming-HC fast path: the caller keeps
// <= 64KB of history in front of each block (ops/hc.py StreamHC);
// rebuilding the chain tables over the <= 128KB window per call is
// ~0.3 ms -- far cheaper than marshalling persistent tables through
// ctypes.  reference: src/lz4hc.zig:1557-1660 (compressContinue).
int64_t lz4tpu_compress_hc_window(const uint8_t* w, size_t n,
                                  size_t start, uint8_t* dst,
                                  size_t cap, int level) {
    using namespace hc;
    if (n > 0x7E000000u) return ERR_INPUT_TOO_LARGE;
    if (start >= n) return 0;

    if (level < 1) level = 9;
    if (level > 12) level = 12;
    if (level == 1) level = 2;
    static const int nb_tab[13] = {0, 0, 2, 4, 8, 16, 32, 64, 128, 256,
                                   96, 512, 16384};
    static const int tl_tab[13] = {0, 0, 16, 16, 16, 16, 16, 16, 16, 16,
                                   64, 128, OPT_NUM};
    int nb = nb_tab[level], target = tl_tab[level];

    Out o{dst, cap, 0, false};
    if (n - start < (size_t)MFLIMIT + 1 || n < (size_t)MFLIMIT + 1) {
        final_literals(o, w, start, n);
        return o.overflow ? ERR_OUTPUT_TOO_SMALL : (int64_t)o.len;
    }

    Ctx c;
    std::vector<int64_t> ht(1 << HASH_LOG, 0);
    std::vector<uint16_t> ct(MAXD, 0);
    std::vector<int64_t> m4, m8;
    c.hash_table = ht.data();
    c.chain_table = ct.data();
    c.mid4 = c.mid8 = nullptr;
    c.next_to_update = GLOBAL_BASE;
    c.base_g = GLOBAL_BASE;
    c.low_limit_g = GLOBAL_BASE;

    if (level == 2) {
        m4.assign(1 << MID_HASHLOG, 0);
        m8.assign(1 << MID_HASHLOG, 0);
        c.mid4 = m4.data();
        c.mid8 = m8.data();
        // MID inserts eagerly (no lazy catch-up like the chain
        // search), so a fresh context must seed the history
        // positions before compressing against them
        size_t lim4 = n >= 4 ? n - 4 : 0, lim8 = n >= 8 ? n - 8 : 0;
        for (size_t i = 0; i < start; ++i) {
            if (i <= lim4)
                c.mid4[hash_mid4(read32le(w + i))] =
                    GLOBAL_BASE + (int64_t)i;
            if (i <= lim8)
                c.mid8[hash_mid8(read64le(w + i))] =
                    GLOBAL_BASE + (int64_t)i;
        }
        compress_mid(c, w, n, start, o);
    } else if (level <= 9) {
        compress_hash_chain(c, w, n, start, nb, o);
    } else {
        std::vector<OptEntry> opt(OPT_NUM + 8);
        compress_optimal(c, w, n, start, nb, target, o, opt.data());
    }
    return o.overflow ? ERR_OUTPUT_TOO_SMALL : (int64_t)o.len;
}

// --- persistent HC stream context (reference: src/lz4hc.zig:1601-1660
// compressContinue carries its hash/chain tables across blocks) -------
// The windowed entry above rebuilds the tables over the <= 128KB
// window on EVERY call -- ~32x redundant insertion work at 4KB blocks.
// This context keeps them in the global int64 index space the Ctx
// already uses: the caller passes window = [last `start` history
// bytes | new block] and the stream aligns base_g so history
// positions keep their global indices -- insert_hc then continues
// from next_to_update with zero reinsertion.  int64 indices never
// roll over, so the reference's 1GB/2GB rebase resets have no analog.
struct Lz4TpuHCStream {
    std::vector<int64_t> ht;
    std::vector<uint16_t> ct;
    std::vector<int64_t> m4, m8;
    int64_t end_g;           // global index one past the last byte
    int64_t next_to_update;
    int64_t mid_seeded_to;
    bool fresh, dirty;
};

void* lz4tpu_hc_stream_create() {
    auto* s = new Lz4TpuHCStream();
    s->ht.assign(1 << hc::HASH_LOG, 0);
    s->ct.assign(hc::MAXD, 0);
    s->fresh = true;
    s->dirty = false;
    s->end_g = 0;
    s->next_to_update = 0;
    s->mid_seeded_to = 0;
    return s;
}

void lz4tpu_hc_stream_free(void* p) {
    delete (Lz4TpuHCStream*)p;
}

void lz4tpu_hc_stream_reset(void* p) {
    auto* s = (Lz4TpuHCStream*)p;
    std::fill(s->ht.begin(), s->ht.end(), 0);
    std::fill(s->ct.begin(), s->ct.end(), 0);
    std::fill(s->m4.begin(), s->m4.end(), 0);
    std::fill(s->m8.begin(), s->m8.end(), 0);
    s->fresh = true;
    s->dirty = false;
}

// Compress window[start, n) against the carried stream state; the
// caller guarantees window[0, start) equals the last `start` bytes of
// the stream's prior input (dictionary bytes on the first call).
// On ERR_OUTPUT_TOO_SMALL the stream does NOT advance and marks
// itself dirty: the next call rebuilds tables from its window (the
// failed call's partial insertions would otherwise corrupt chains).
int64_t lz4tpu_hc_stream_compress(void* p, const uint8_t* w, size_t n,
                                  size_t start, uint8_t* dst,
                                  size_t cap, int level) {
    using namespace hc;
    auto* s = (Lz4TpuHCStream*)p;
    if (n > 0x7E000000u) return ERR_INPUT_TOO_LARGE;
    if (start >= n) return 0;

    if (level < 1) level = 9;
    if (level > 12) level = 12;
    if (level == 1) level = 2;
    static const int nb_tab[13] = {0, 0, 2, 4, 8, 16, 32, 64, 128, 256,
                                   96, 512, 16384};
    static const int tl_tab[13] = {0, 0, 16, 16, 16, 16, 16, 16, 16, 16,
                                   64, 128, OPT_NUM};
    int nb = nb_tab[level], target = tl_tab[level];

    int64_t base_g = s->fresh ? GLOBAL_BASE
                              : s->end_g - (int64_t)start;
    if (s->fresh || s->dirty) {
        if (s->dirty) {
            std::fill(s->ht.begin(), s->ht.end(), 0);
            std::fill(s->ct.begin(), s->ct.end(), 0);
            std::fill(s->m4.begin(), s->m4.end(), 0);
            std::fill(s->m8.begin(), s->m8.end(), 0);
        }
        s->next_to_update = base_g;
        s->mid_seeded_to = base_g;
        s->dirty = false;
    }

    Out o{dst, cap, 0, false};
    if (n - start < (size_t)MFLIMIT + 1 || n < (size_t)MFLIMIT + 1) {
        final_literals(o, w, start, n);
        if (o.overflow) { s->dirty = true; return ERR_OUTPUT_TOO_SMALL; }
        s->fresh = false;
        s->end_g = base_g + (int64_t)n;
        return (int64_t)o.len;
    }

    Ctx c;
    c.hash_table = s->ht.data();
    c.chain_table = s->ct.data();
    c.mid4 = c.mid8 = nullptr;
    c.base_g = base_g;
    c.low_limit_g = base_g;          // history below the window is gone
    c.next_to_update = s->next_to_update > base_g ? s->next_to_update
                                                  : base_g;

    if (level == 2) {
        if (s->m4.empty()) {
            s->m4.assign(1 << MID_HASHLOG, 0);
            s->m8.assign(1 << MID_HASHLOG, 0);
            s->mid_seeded_to = base_g;
        }
        c.mid4 = s->m4.data();
        c.mid8 = s->m8.data();
        // seed positions the MID tables have not yet seen (first call
        // after a dictionary load, or catch-up after a level switch)
        int64_t from = s->mid_seeded_to > base_g ? s->mid_seeded_to
                                                 : base_g;
        size_t lim4 = n >= 4 ? n - 4 : 0, lim8 = n >= 8 ? n - 8 : 0;
        for (int64_t g = from; g < base_g + (int64_t)start; ++g) {
            size_t i = (size_t)(g - base_g);
            if (i <= lim4) c.mid4[hash_mid4(read32le(w + i))] = g;
            if (i <= lim8) c.mid8[hash_mid8(read64le(w + i))] = g;
        }
        compress_mid(c, w, n, start, o);
    } else if (level <= 9) {
        compress_hash_chain(c, w, n, start, nb, o);
    } else {
        std::vector<OptEntry> opt(OPT_NUM + 8);
        compress_optimal(c, w, n, start, nb, target, o, opt.data());
    }
    if (o.overflow) { s->dirty = true; return ERR_OUTPUT_TOO_SMALL; }
    s->fresh = false;
    s->end_g = base_g + (int64_t)n;
    s->next_to_update = c.next_to_update;
    if (level == 2) s->mid_seeded_to = base_g + (int64_t)n;
    return (int64_t)o.len;
}

// Checkpoint/resume for the persistent stream (SURVEY.md section 5
// checkpoint subsystem): byte-exact export/import of the carried
// tables, so a restored stream continues byte-identically to the
// uninterrupted one.  Layout: u64 magic | u8 flags | 3 x i64 |
// ht | ct | u8 has_mid | [m4 | m8].
static const uint64_t HC_STREAM_MAGIC = 0x4C5A3454505548ULL;  // "LZ4TPUH"

int64_t lz4tpu_hc_stream_state_size(void* p) {
    auto* s = (Lz4TpuHCStream*)p;
    return (int64_t)(8 + 1 + 24 + s->ht.size() * 8 + s->ct.size() * 2
                     + 1 + (s->m4.empty() ? 0 : (s->m4.size()
                                                 + s->m8.size()) * 8));
}

int64_t lz4tpu_hc_stream_export(void* p, uint8_t* buf, size_t cap) {
    auto* s = (Lz4TpuHCStream*)p;
    size_t need = (size_t)lz4tpu_hc_stream_state_size(p);
    if (cap < need) return ERR_OUTPUT_TOO_SMALL;
    uint8_t* q = buf;
    std::memcpy(q, &HC_STREAM_MAGIC, 8); q += 8;
    *q++ = (uint8_t)((s->fresh ? 1 : 0) | (s->dirty ? 2 : 0));
    std::memcpy(q, &s->end_g, 8); q += 8;
    std::memcpy(q, &s->next_to_update, 8); q += 8;
    std::memcpy(q, &s->mid_seeded_to, 8); q += 8;
    std::memcpy(q, s->ht.data(), s->ht.size() * 8); q += s->ht.size() * 8;
    std::memcpy(q, s->ct.data(), s->ct.size() * 2); q += s->ct.size() * 2;
    *q++ = s->m4.empty() ? 0 : 1;
    if (!s->m4.empty()) {
        std::memcpy(q, s->m4.data(), s->m4.size() * 8);
        q += s->m4.size() * 8;
        std::memcpy(q, s->m8.data(), s->m8.size() * 8);
        q += s->m8.size() * 8;
    }
    return (int64_t)(q - buf);
}

int64_t lz4tpu_hc_stream_import(void* p, const uint8_t* buf, size_t n) {
    using namespace hc;
    auto* s = (Lz4TpuHCStream*)p;
    size_t fixed = 8 + 1 + 24;
    size_t base_sz = fixed + (size_t)(1 << HASH_LOG) * 8
                     + (size_t)MAXD * 2 + 1;
    if (n < base_sz) return ERR_CORRUPT;
    uint64_t magic;
    std::memcpy(&magic, buf, 8);
    if (magic != HC_STREAM_MAGIC) return ERR_CORRUPT;
    const uint8_t* q = buf + 8;
    uint8_t flags = *q++;
    std::memcpy(&s->end_g, q, 8); q += 8;
    std::memcpy(&s->next_to_update, q, 8); q += 8;
    std::memcpy(&s->mid_seeded_to, q, 8); q += 8;
    s->ht.assign(1 << HASH_LOG, 0);
    s->ct.assign(MAXD, 0);
    std::memcpy(s->ht.data(), q, s->ht.size() * 8); q += s->ht.size() * 8;
    std::memcpy(s->ct.data(), q, s->ct.size() * 2); q += s->ct.size() * 2;
    uint8_t has_mid = *q++;
    if (has_mid) {
        if (n < base_sz + 2 * (size_t)(1 << MID_HASHLOG) * 8)
            return ERR_CORRUPT;
        s->m4.assign(1 << MID_HASHLOG, 0);
        s->m8.assign(1 << MID_HASHLOG, 0);
        std::memcpy(s->m4.data(), q, s->m4.size() * 8);
        q += s->m4.size() * 8;
        std::memcpy(s->m8.data(), q, s->m8.size() * 8);
        q += s->m8.size() * 8;
    } else {
        s->m4.clear();
        s->m8.clear();
    }
    s->fresh = (flags & 1) != 0;
    s->dirty = (flags & 2) != 0;
    return 0;
}

// Batched HC: src rows [nblocks, blk]; returns 0 or -(block+1).
int64_t lz4tpu_compress_hc_blocks(const uint8_t* src, size_t blk,
                                  const int64_t* lens, size_t nblocks,
                                  uint8_t* dst, size_t dcap,
                                  int64_t* out_lens, int level) {
    for (size_t bi = 0; bi < nblocks; ++bi) {
        int64_t r = lz4tpu_compress_hc(src + bi * blk, (size_t)lens[bi],
                                       dst + bi * dcap, dcap, level);
        if (r < 0) return -(int64_t)(bi + 1);
        out_lens[bi] = r;
    }
    return 0;
}

}  // extern "C"
