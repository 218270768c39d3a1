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
// enc_deep_match (encode_deep.cu) runs these steps over a window of up to
// 64 KB, its u16 order in one block's shared memory sorted by the stable
// byte passes of sort_radix.cuh; enc_deep_match_wide (encode_deep_wide.cu)
// over wider windows with the passes of radix_cluster.cuh.  Both share
// what is below: the tier operands, the eight key words of a class (Key32,
// Tiers' ranks as KeyRanks), the tier probe and the fallback's test.  The
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

// The eight key words of a class: the 32-byte key (s0, at(p+4), ...,
// at(p+28)), or the rank keys x[p + step k], k < 8 (-1 past the end).
struct Key32 {
  Window W;
  __device__ __forceinline__ uint32_t operator()(int p, int k) const {
    return k ? W.at(p + 4 * k) : W.s0(p);
  }
};

struct KeyRanks {
  const int32_t* x;
  int step, blk;
  __device__ __forceinline__ uint32_t operator()(int p, int k) const {
    return (uint32_t)shl_at(x, p, step * k, blk);
  }
};

}  // namespace
