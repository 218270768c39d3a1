// Device code shared by the encoder kernels (encode_block.cu: levels 0-9,
// encode_deep.cu: levels 10-12, and the wide finders): the window in shared
// memory, the bitonic sort of positions (enc_match_fast; enc_match and
// enc_deep_match sort by the radix passes of sort_radix.cuh), the probe of
// one sorted neighbour (cand_at of the JAX reference,
// ops/jax_block.py:379-426), the candidate pack, the per-position fields of
// the parse, the position-parallel chain extension of enc_parse_emit and
// enc_deep_dp, and the one-thread sequence emitter of enc_deep_emit
// (enc_parse_emit runs a position-parallel emission, encode_block.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 8;         // u32 windows after s0 (jax_block.py:100)
constexpr int kPad = 64;         // zero bytes past blk (reads reach 4W+7)
constexpr int kMatchThreads = 1024;
constexpr int kParseThreads = 256;
constexpr int kImBit = 1 << 30;  // is_match / take flag beside ml
constexpr int kCapEndBit = 1 << 29;  // the row's chain ends at a capped row
constexpr int kMlMask = (1 << 20) - 1;

struct Window {
  const uint32_t* w;  // little-endian words, zero at and past n
  int n;

  // LE u32 of bytes p..p+3
  __device__ __forceinline__ uint32_t at(int p) const {
    return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
  }
  __device__ __forceinline__ uint32_t s0(int p) const {
    return p > n - 4 ? 0xFFFFFFFFu : at(p);
  }
  __device__ __forceinline__ uint32_t byte(int p) const {
    return p < 0 ? 0u : (w[p >> 2] >> ((p & 3) * 8)) & 0xFFu;
  }
};

// Sorted position order; rows >= blk are padding that sorts last.
template <class Less>
__device__ void bitonic_sort(uint16_t* s, int N, Less less) {
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (N >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int l = i + j;
        const int a = s[i], c = s[l];
        if ((i & k) == 0 ? less(c, a) : less(a, c)) {
          s[i] = (uint16_t)c;
          s[l] = (uint16_t)a;
        }
      }
      __syncthreads();
    }
  }
}

struct Cand {
  int cand, ml, back;
};

// cand_at for sorted row p against neighbour q over nwin carried windows
// (jax_block.py:394-426)
__device__ __forceinline__ Cand probe(const Window& W, int p, int q,
                                      int nwin) {
  const int n = W.n;
  Cand r{-1, 0, 0};
  if (p > n - 4 || q > n - 4 || q >= p || p - q > 65535) return r;
  if (W.at(p) != W.at(q)) return r;
  int ml = 4;
  for (int k = 1; k <= nwin; ++k) {
    const uint32_t x = W.at(p + 4 * k) ^ W.at(q + 4 * k);
    if (x != 0) {
      ml += (__ffs(x) - 1) >> 3;  // equal low bytes, low byte first
      break;
    }
    ml += 4;
  }
  int back;
  if (W.byte(p - 1) != W.byte(q - 1)) back = 0;
  else if (W.byte(p - 2) != W.byte(q - 2)) back = 1;
  else back = 2;
  r.cand = q;
  r.ml = ml;
  r.back = back;
  return r;
}

__device__ __forceinline__ int pack(const Cand& c) {
  return c.cand >= 0 ? ((c.cand + 1) << 12) | (c.ml << 6) | c.back : 0;
}

// The identity order over N rows.
__device__ void identity_order(uint16_t* s, int N) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) s[i] = (uint16_t)i;
  __syncthreads();
}

// The window as zero-padded LE words in shared memory.
__device__ void load_words(const uint8_t* row, int n, uint32_t* words,
                           int nwords) {
  for (int q = threadIdx.x; q < nwords; q += blockDim.x) {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * q + k;
      if (p < n) v |= (uint32_t)row[p] << (8 * k);
    }
    words[q] = v;
  }
}

// The window words, and the identity order over N >= blk rows.
__device__ void load_window(const uint8_t* row, int n, uint32_t* words,
                            int nwords, uint16_t* s, int N) {
  load_words(row, n, words, nwords);
  identity_order(s, N);
}

// Order by s0 alone, ties by position: within a group of equal 4-byte
// strings the rows before t are the nearest previous occurrences.  Rows at
// or past blk are padding and sort last.
struct LessS0 {
  Window W;
  int blk;
  __device__ __forceinline__ bool operator()(int p, int q) const {
    if (p >= blk || q >= blk) return p < q;
    const uint32_t a = W.s0(p), c = W.s0(q);
    if (a != c) return a < c;
    return p < q;
  }
};

__device__ void sort_by_s0(const Window& W, uint16_t* s, int N, int blk) {
  LessS0 less{W, blk};
  bitonic_sort(s, N, less);
}

// Probes +1..+probes of sorted row t; a later probe wins only when
// strictly longer (jax_block.py:445, :500).  ``s`` is the sorted order:
// a pointer, or an accessor with operator[] (the wide finders').
template <class Order>
__device__ __forceinline__ Cand nearest(const Window& W, const Order& s,
                                        int t, int probes, int nwin) {
  Cand best{-1, 0, 0};
  const int p = s[t];
  for (int k = 1; k <= probes && k <= t; ++k) {
    const Cand c = probe(W, p, s[t - k], nwin);
    if (c.ml > best.ml) best = c;
  }
  return best;
}

// Probes +-1..+-hc of sorted row t over all kMaxW windows; ties on the
// length go to the larger (nearer) candidate (jax_block.py:432-450).
template <class Order>
__device__ __forceinline__ Cand nearest_both(const Window& W, const Order& s,
                                             int t, int blk, int hc) {
  Cand best{-1, 0, 0};
  const int p = s[t];
  for (int k = 1; k <= hc; ++k) {
    for (int side = 0; side < 2; ++side) {
      const int u = side ? t + k : t - k;
      if (u < 0 || u >= blk) continue;
      const Cand c = probe(W, p, s[u], kMaxW);
      if (c.ml > best.ml || (c.ml == best.ml && c.cand > best.cand)) best = c;
    }
  }
  return best;
}

// Length a rank tier proves (jax_block.py:307-321): 32-byte steps over the
// 32-byte rank, then at deep == 3 256-byte steps over the 256-byte rank
// from tier 8 on.  Tier 0 = none.
__device__ __forceinline__ int tier_len(int tier, int deep) {
  return deep == 3 && tier > 7 ? 256 * (tier - 7) : 32 * tier;
}

// Per-position fields of the parse, read from the candidate pack
// ((cand + 1) << 12) | (fine ml << 6) | (tier << 2) | back.
struct Fields {
  const int32_t* pk;
  int n, blk;
  int capped_ml;  // a fine ml from here on saturated the carried windows
  int deep;       // 0, or the deep configuration whose tiers pk carries

  __device__ __forceinline__ int cand(int p) const { return (pk[p] >> 12) - 1; }
  __device__ __forceinline__ bool valid(int p) const {
    return p < blk && p <= n - 13 && cand(p) >= 0;
  }
  __device__ __forceinline__ int mlf(int p) const { return (pk[p] >> 6) & 63; }
  // ml before the chain extension: the tier's length when it is longer
  __device__ __forceinline__ int ml0(int p) const {
    if (!valid(p)) return 0;
    return max(mlf(p), tier_len((pk[p] >> 2) & 15, deep));
  }
  // possibly underestimated: the windows saturated, or a tier gave ml
  __device__ __forceinline__ bool capped(int p) const {
    return valid(p) && (mlf(p) >= capped_ml || ml0(p) > mlf(p));
  }
  // row p continues a capped chain at the same offset into p + 1
  __device__ __forceinline__ bool link(int p) const {
    return capped(p) && valid(p + 1) && (p + 1 - cand(p + 1)) == (p - cand(p));
  }
};

constexpr int kBatch = 4;  // rows a thread loads before it stores any

// nxt[w] = the first set bit of mask in the words after w (none if there
// is none), for the nw words of mask: each thread scans a run of words,
// and a reverse min-scan over the threads carries across runs.  tmp:
// kParseThreads / 32 ints of shared memory.
__device__ void next_after_words(const uint32_t* mask, int nw, int none,
                                 int* nxt, int* tmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int run = (nw + kParseThreads - 1) / kParseThreads;
  const int lo = min(tid * run, nw), hi = min(lo + run, nw);
  int first = none;
  for (int w = lo; w < hi; ++w)
    if (mask[w]) {
      first = (w << 5) + __ffs(mask[w]) - 1;
      break;
    }
  int v = first;  // min over this lane and the lanes after it
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane + o < 32) v = min(v, x);
  }
  if (lane == 0) tmp[warp] = v;
  __syncthreads();
  int after = __shfl_down_sync(0xFFFFFFFFu, v, 1);
  if (lane == 31) after = none;
  for (int k = warp + 1; k < kParseThreads / 32; ++k)
    after = min(after, tmp[k]);
  for (int w = hi - 1; w >= lo; --w) {
    nxt[w] = after;
    if (mask[w]) after = (w << 5) + __ffs(mask[w]) - 1;
  }
  __syncthreads();
}

// The first set bit of mask at or after row x, with nxt from
// next_after_words.
__device__ __forceinline__ int first_at_or_after(const uint32_t* mask,
                                                 const int* nxt, int x) {
  const int w = x >> 5;
  const uint32_t bits = mask[w] & (0xFFFFFFFFu << (x & 31));
  return bits ? (w << 5) + __ffs(bits) - 1 : nxt[w];
}

// Row p's word of the parse, ml | is_match << 30 | cap_end << 29, from the
// chain boundaries: a capped row takes its length from the nearest boundary
// at or after it.
__device__ __forceinline__ int chain_word(const Fields& F, int start,
                                          const uint32_t* bnd, const int* nxt,
                                          int p) {
  const int nb = first_at_or_after(bnd, nxt, p);
  int ml = F.ml0(p);
  if (F.capped(p)) ml = max(nb - p + min(F.ml0(nb), 2047), ml);
  ml = min(ml, max(F.n - 5 - p, 0));
  const bool v = F.valid(p);
  const bool im = v && ml >= 4 && p >= start;
  const bool ce = v && F.capped(nb);
  return ml | (im ? kImBit : 0) | (ce ? kCapEndBit : 0);
}

// Same-offset chain extension and the n - 5 clamp (jax_block.py:522-555),
// position-parallel: each capped row takes its length from the nearest
// chain boundary at or after it (a reverse cummax in the reference).
// Writes M[p] = ml | is_match << 30 | cap_end << 29 for every row, kBatch
// rows a thread at a time, so that their loads are in flight together.
// bnd and nxt: nw = ceil(blk / 32) words of shared memory each.
__device__ void chain_lengths_par(const Fields& F, int start, int32_t* M,
                                  uint32_t* bnd, int* nxt, int* tmp) {
  const int blk = F.blk, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = (blk + 31) >> 5;
  // boundary rows (no link into the next row); row blk - 1 always is one
#pragma unroll 4
  for (int base = warp * 32; base < nw * 32; base += kParseThreads) {
    const int p = base + lane;
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, p < blk && !F.link(p));
    if (lane == 0) bnd[base >> 5] = bits;
  }
  __syncthreads();
  next_after_words(bnd, nw, blk, nxt, tmp);
  for (int p0 = tid; p0 < blk; p0 += kBatch * kParseThreads) {
    int word[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kParseThreads;
      word[u] = p < blk ? chain_word(F, start, bnd, nxt, p) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kParseThreads;
      if (p < blk) M[p] = word[u];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void put_len(uint8_t* o, int& op, int v) {
  for (; v >= 255; v -= 255) o[op++] = 255;
  o[op++] = (uint8_t)v;
}

// Sequence emission by one thread (jax_block.py:871-1103): selections that
// continue each other at one offset merge into one match, each head extends
// back over <= ``back`` literals, 255-escapes, LE offsets, then the tail
// literal run.  Headers are written here; literal runs are recorded as
// (src, dst, len) in R for the block's warps to copy.
struct Emitter {
  uint8_t* o;
  int32_t* R;
  int start;
  int op = 0, nr = 0;
  int last_e = -1;
  bool have = false;
  int h_ls = 0, h_ms = 0, h_off = 0, h_e = 0;

  __device__ __forceinline__ void run(int src, int lit) {
    if (lit > 0) {
      R[3 * nr] = src;
      R[3 * nr + 1] = op;
      R[3 * nr + 2] = lit;
      ++nr;
      op += lit;
    }
  }
  __device__ __forceinline__ void flush() {
    const int lit = h_ms - h_ls, mml = h_e - h_ms;
    o[op++] = (uint8_t)((min(lit, 15) << 4) | min(mml - 4, 15));
    if (lit >= 15) put_len(o, op, lit - 15);
    run(h_ls, lit);
    o[op++] = (uint8_t)(h_off & 0xFF);
    o[op++] = (uint8_t)(h_off >> 8);
    if (mml - 4 >= 15) put_len(o, op, mml - 19);
  }
  // the selection at p, ending at e, with its offset and back count
  __device__ __forceinline__ void add(int p, int e, int off, int back) {
    if (have && last_e == p && h_off == off) {
      h_e = e;  // continues the previous match at the same offset
    } else {
      if (have) flush();
      const int prev_end = max(last_e, start);
      const int bq = max(min(min(back, p - prev_end), p - off), 0);
      h_ls = prev_end;
      h_ms = p - bq;
      h_off = off;
      h_e = e;
      have = true;
    }
    last_e = e;
  }
  __device__ __forceinline__ void finish(int n) {
    if (have) flush();
    const int tail = max(last_e, start), lit = n - tail;
    o[op++] = (uint8_t)(min(lit, 15) << 4);
    if (lit >= 15) put_len(o, op, lit - 15);
    run(tail, lit);
  }
};

// The recorded literal runs, one warp each, and zeros past out_len.
__device__ void copy_runs(const uint8_t* row, const int32_t* R, int nr,
                          uint8_t* o, int olen, int cap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nr; r += blockDim.x / 32) {
    const int src = R[3 * r], dst = R[3 * r + 1], len = R[3 * r + 2];
    for (int k = lane; k < len; k += 32) o[dst + k] = row[src + k];
  }
  for (int k = olen + threadIdx.x; k < cap; k += blockDim.x) o[k] = 0;
}

// Sort width, window words and shared memory of a match kernel launch.
struct MatchShape {
  int N, nwords;
  size_t smem;
};

inline MatchShape match_shape(int blk) {
  int N = 1;
  while (N < blk) N <<= 1;
  const int nwords = (blk + kPad) / 4 + 1;
  return {N, nwords, (size_t)nwords * 4 + (size_t)N * 2};
}

}  // namespace
