// The deep finder of levels 10-12.  Semantics, by line of the JAX
// reference's ops/jax_block.py:
//   * the 32-byte rank r (:285-306): the positions sorted by the eight u32
//     words (s0, su[i+4], ..., su[i+28], i) -- compared as unsigned
//     little-endian words, s0 poisoned past n - 4 -- then one scan that
//     numbers the classes in sorted order, stored at the position.
//   * at deep = 3 the 256-byte rank r2 (:316-321) the same way, over the
//     eight keys r[i], r[i+32], ..., r[i+224] (-1 past the end, as shl
//     fills).
//   * the grand grouping sort (:322, :341-346): by the last NK tier operands
//     and the position: r[i+32k], k < 4 at deep 1; k < 8 at deep 2;
//     r2[i+256k], k < 4 at deep 3.  The tier operands are shifts of r and
//     r2, so none is materialised.
//   * the +-1..+-hc probes (:379-450) with the nested tier chain (:412-419):
//     tier t holds while operands 0..t-1 are equal on both rows, and proves
//     tier_len(t) bytes; the longest total ml wins, ties to the larger
//     candidate.  Output: ((cand + 1) << 12) | (fine ml << 6) | (tier << 2)
//     | back, stored at the position (the unsort, :455-469).
//   * the positional fallback (:471-516) as in enc_match; it wins when its
//     fine ml beats the total ml, and then the tier is 0.
// deep_match below runs it over a window of up to 64 KB (enc_deep_match,
// encode_deep.cu: the order u16 in shared memory, comparison sorts by the
// bitonic network); encode_deep_wide.cu runs the same steps over wider
// windows with the radix passes of radix_cluster.cuh, sharing the tier
// operands, the equalities, the tier probe and the fallback's test.  The
// ranks are int32 in device memory: they reach blk, past u16.

#pragma once

#include "encode_common.cuh"

namespace {

// x[p + k], -1 past the end (shl, jax_block.py:277-283)
__device__ __forceinline__ int shl_at(const int32_t* x, int p, int k,
                                      int blk) {
  const int q = p + k;
  return q < blk ? x[q] : -1;
}

// The tier operands of a deep configuration, read from the ranks.
struct Tiers {
  const int32_t* r;   // 32-byte rank
  const int32_t* r2;  // 256-byte rank (deep == 3)
  int blk, deep;

  __device__ __forceinline__ int count() const {
    return deep == 1 ? 4 : deep == 2 ? 8 : 11;
  }
  __device__ __forceinline__ int op(int tk, int p) const {
    if (deep == 3 && tk >= 7) return shl_at(r2, p, 256 * (tk - 7), blk);
    return shl_at(r, p, 32 * tk, blk);
  }
};

// The pack of sorted row t (position p) of the grand order s: the
// +-1..+-hc probes with the nested tier chain; the longest total ml wins,
// ties to the larger candidate.  ``s`` is a pointer or an accessor.
template <class Order>
__device__ __forceinline__ int tier_pack(const Window& W, const Tiers& T,
                                         const Order& s, int t, int p,
                                         int blk, int hc) {
  const int nt = T.count();
  int b_cand = -1, b_ml = 0, b_mlf = 0, b_tier = 0, b_back = 0;
  for (int k = 1; k <= hc; ++k) {
    for (int side = 0; side < 2; ++side) {
      const int u = side ? t + k : t - k;
      if (u < 0 || u >= blk) continue;
      const int q = s[u];
      const Cand c = probe(W, p, q, kMaxW);
      if (c.cand < 0) continue;
      int tier = 0;
      while (tier < nt && T.op(tier, p) == T.op(tier, q)) ++tier;
      const int ml = max(c.ml, tier_len(tier, T.deep));
      if (ml > b_ml || (ml == b_ml && c.cand > b_cand)) {
        b_cand = c.cand;
        b_ml = ml;
        b_mlf = c.ml;
        b_tier = tier;
        b_back = c.back;
      }
    }
  }
  return b_cand >= 0
             ? ((b_cand + 1) << 12) | (b_mlf << 6) | (b_tier << 2) | b_back
             : 0;
}

// The total ml of a pack v: the fine ml, or the tier's length when longer;
// the positional fallback must beat it.
__device__ __forceinline__ int total_ml(int v, int deep) {
  return v ? max((v >> 6) & 63, tier_len((v >> 2) & 15, deep)) : 0;
}

// Number the classes of the sorted order s[0..blk) -- rows t - 1 and t are
// in one class when same(s[t - 1], s[t]) -- from 1 in sorted order, and
// store each row's number at its position (ranksN, jax_block.py:285-296).
template <class Idx, class Same>
__device__ void assign_ranks(const Idx* s, int blk, Same same, int32_t* rank,
                             int* part /* shared, blockDim.x */) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int chunk = (blk + T - 1) / T;
  const int lo = min(tid * chunk, blk), hi = min(lo + chunk, blk);
  int cnt = 0;
  for (int t = lo; t < hi; ++t)
    if (t == 0 || !same(s[t - 1], s[t])) ++cnt;
  part[tid] = cnt;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {  // inclusive scan of the chunk counts
    const int v = tid >= d ? part[tid - d] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - cnt;
  for (int t = lo; t < hi; ++t) {
    if (t == 0 || !same(s[t - 1], s[t])) ++run;
    rank[s[t]] = run;
  }
  __syncthreads();
}

// The 32-byte key (s0, su[i+4], ..., su[i+28]): order, ties by position,
// and equality.  Rows at or past blk are padding and sort last.
struct Less32 {
  Window W;
  int blk;
  __device__ __forceinline__ bool operator()(int p, int q) const {
    if (p >= blk || q >= blk) return p < q;
    uint32_t a = W.s0(p), c = W.s0(q);
    if (a != c) return a < c;
    for (int k = 1; k < 8; ++k) {
      a = W.at(p + 4 * k), c = W.at(q + 4 * k);
      if (a != c) return a < c;
    }
    return p < q;
  }
};

struct Same32 {
  Window W;
  __device__ __forceinline__ bool operator()(int p, int q) const {
    if (W.s0(p) != W.s0(q)) return false;
    for (int k = 1; k < 8; ++k)
      if (W.at(p + 4 * k) != W.at(q + 4 * k)) return false;
    return true;
  }
};

// The nk keys x[p + step * k], k < nk: order, ties by position, and
// equality.
struct LessRanks {
  const int32_t* x;
  int step, nk, blk;
  __device__ __forceinline__ bool operator()(int p, int q) const {
    if (p >= blk || q >= blk) return p < q;
    for (int k = 0; k < nk; ++k) {
      const int a = shl_at(x, p, step * k, blk), c = shl_at(x, q, step * k, blk);
      if (a != c) return a < c;
    }
    return p < q;
  }
};

struct SameRanks {
  const int32_t* x;
  int step, nk, blk;
  __device__ __forceinline__ bool operator()(int p, int q) const {
    for (int k = 0; k < nk; ++k)
      if (shl_at(x, p, step * k, blk) != shl_at(x, q, step * k, blk))
        return false;
    return true;
  }
};

// The deep finder over one window of up to 64 KB (enc_deep_match): s is
// the u16 position order over N >= blk rows in shared memory, the identity
// on entry, sorted by the bitonic network of encode_common.cuh; r (and r2
// at deep == 3) are blk-entry rank scratch, out the window's packs.
__device__ void deep_match(const Window& W, uint16_t* s, int N, int blk,
                           int hc, int deep, int32_t* r, int32_t* r2,
                           int32_t* out, int* part) {
  // 32-byte rank: order by (s0, su[i+4], ..., su[i+28]), then number
  bitonic_sort(s, N, Less32{W, blk});
  assign_ranks(s, blk, Same32{W}, r, part);

  if (deep == 3) {  // 256-byte rank over r[i], r[i+32], ..., r[i+224]
    identity_order(s, N);
    bitonic_sort(s, N, LessRanks{r, 32, 8, blk});
    assign_ranks(s, blk, SameRanks{r, 32, 8, blk}, r2, part);
  }

  // grand order by the last NK tier operands, ties by position
  identity_order(s, N);
  if (deep == 3) bitonic_sort(s, N, LessRanks{r2, 256, 4, blk});
  else bitonic_sort(s, N, LessRanks{r, 32, deep == 2 ? 8 : 4, blk});

  const Tiers T{r, r2, blk, deep};
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    out[p] = tier_pack(W, T, s, t, p, blk, hc);
  }
  __syncthreads();

  // positional fallback: order by s0 alone, probes +1 and +2; it must beat
  // the total ml, and clears the tier
  identity_order(s, N);
  sort_by_s0(W, s, N, blk);
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    const Cand c = nearest(W, s, t, 2, kMaxW);
    if (c.ml > total_ml(out[p], deep)) out[p] = pack(c);
  }
}

}  // namespace
