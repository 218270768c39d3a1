// LZ4 block encoder, levels 10-12: the deep finder, the price parse, and the
// extension, absorb and emission.
//
// Replaces: the deep branches of _encode_block of the JAX reference
// (ops/jax_block.py:200-1103 at deep = 1, 2, 3 with hc >= 1).  The TPU
// version builds exact ranks by sort + cumsum + unsort rounds, rides the tier
// operands through one grand sort, relaxes the price parse in 32-position
// chunks with one-hot reads, and repairs the parse with pooled gathers and
// scatter.  Here the same bytes come from three kernels:
//
// enc_deep_match (one 1024-thread block per window; the window and the u16
//   sort order in shared memory as in enc_match, the ranks in global memory):
//   * the 32-byte rank r (:285-306): a bitonic sort of the positions by the
//     eight u32 words (s0, su[i+4], ..., su[i+28], i) -- compared as
//     unsigned little-endian words, s0 poisoned past n - 4 -- then one block
//     scan that numbers the classes in sorted order, scattered back to the
//     position.  Ranks reach blk = 65536, one past u16, so they are int32 in
//     global memory: 256 KB per window, which the L2 holds.
//   * at deep = 3 the 256-byte rank r2 (:316-321) the same way, over the
//     eight keys r[i], r[i+32], ..., r[i+224] (-1 past the end, as shl fills).
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
//   Bound: the four sorts (136 bitonic stages each); two of them read their
//   keys from global memory (L2), not shared memory.
//
// enc_deep_dp (one 256-thread block per window):
//   chain extension with tier lengths and the capped-end bit (:522-555),
//   then the backward price parse (run_dp, :556-683).  The reference relaxes
//   chunks of 32 positions to the fixpoint of
//     cost[i] = min(256 + cost[i+1], price(i) + cost[i + min(ml, 512)],
//                   768 + cost[i + 18] where ml > 18)
//   with cost = 0 past the window; one thread runs that recurrence backwards
//   over a 1024-entry cost ring in shared memory, the block staging 4096
//   positions at a time through shared memory.  Output per position:
//   ml (cut to 18 where the 18-byte cut won) | take << 30 | cap_end << 29.
//   Bound: the one thread's dependent chain, 65536 steps a window.
//
// enc_deep_emit (one 256-thread block per window):
//   the greedy parse over the take bits (:716-743) by one thread, which lists
//   the chosen rows and pools the first 512 whose end is capped; the pool's
//   rows measure their exact extension in parallel, two rounds of four u32
//   compares at the match's own offset, word indices clipped to the window
//   (:774-819); then one thread walks the chosen list with the running
//   maximum of the extended ends (the absorb, :838-863): a covered match is
//   dropped, one with >= 4 bytes left moves to its trimmed start with back =
//   0 -- only the first 512 moved matches, as the reference's pool -- and
//   every kept selection goes to the same emitter as enc_parse_emit.

#include "encode_common.cuh"

namespace {

constexpr int kDpRing = 1024;    // >= _DP_R + 1 entries, a power of two
constexpr int kDpR = 512;        // jumps are priced at min(ml, 512)
constexpr int kDpChunk = 4096;   // positions staged per round
constexpr int kExtPool = 512;    // pooled rows per 64 KB of window
constexpr int kExtBytes = 32;

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

// Number the classes of the sorted order s[0..blk) -- rows t - 1 and t are
// in one class when same(s[t - 1], s[t]) -- from 1 in sorted order, and
// store each row's number at its position (ranksN, jax_block.py:285-296).
template <class Same>
__device__ void assign_ranks(const uint16_t* s, int blk, Same same,
                             int32_t* rank, int* part /* shared, 1024 */) {
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

// Sort the positions by nk keys x[p + step * k], k < nk, ties by position.
__device__ void sort_by_ranks(const int32_t* x, int step, int nk, uint16_t* s,
                              int N, int blk) {
  bitonic_sort(s, N, [&](int p, int q) {
    if (p >= blk || q >= blk) return p < q;
    for (int k = 0; k < nk; ++k) {
      const int a = shl_at(x, p, step * k, blk), c = shl_at(x, q, step * k, blk);
      if (a != c) return a < c;
    }
    return p < q;
  });
}

__global__ void __launch_bounds__(kMatchThreads)
enc_deep_match_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens, int32_t* ranks,
                      int32_t* __restrict__ pk, int blk, int N, int nwords,
                      int hc, int deep) {
  extern __shared__ uint32_t smem[];
  __shared__ int part[kMatchThreads];
  uint32_t* words = smem;
  uint16_t* s = reinterpret_cast<uint16_t*>(smem + nwords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  int32_t* r = ranks + (size_t)b * (deep == 3 ? 2 : 1) * blk;
  int32_t* r2 = r + blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, N);
  const Window W{words, n};

  // 32-byte rank: order by (s0, su[i+4], ..., su[i+28]), then number
  bitonic_sort(s, N, [&](int p, int q) {
    if (p >= blk || q >= blk) return p < q;
    uint32_t a = W.s0(p), c = W.s0(q);
    if (a != c) return a < c;
    for (int k = 1; k < 8; ++k) {
      a = W.at(p + 4 * k), c = W.at(q + 4 * k);
      if (a != c) return a < c;
    }
    return p < q;
  });
  assign_ranks(s, blk, [&](int p, int q) {
    if (W.s0(p) != W.s0(q)) return false;
    for (int k = 1; k < 8; ++k)
      if (W.at(p + 4 * k) != W.at(q + 4 * k)) return false;
    return true;
  }, r, part);

  if (deep == 3) {  // 256-byte rank over r[i], r[i+32], ..., r[i+224]
    identity_order(s, N);
    sort_by_ranks(r, 32, 8, s, N, blk);
    assign_ranks(s, blk, [&](int p, int q) {
      for (int k = 0; k < 8; ++k)
        if (shl_at(r, p, 32 * k, blk) != shl_at(r, q, 32 * k, blk))
          return false;
      return true;
    }, r2, part);
  }

  // grand order by the last NK tier operands, ties by position
  identity_order(s, N);
  if (deep == 3) sort_by_ranks(r2, 256, 4, s, N, blk);
  else sort_by_ranks(r, 32, deep == 2 ? 8 : 4, s, N, blk);

  const Tiers T{r, r2, blk, deep};
  const int nt = T.count();
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
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
        const int ml = max(c.ml, tier_len(tier, deep));
        if (ml > b_ml || (ml == b_ml && c.cand > b_cand)) {
          b_cand = c.cand;
          b_ml = ml;
          b_mlf = c.ml;
          b_tier = tier;
          b_back = c.back;
        }
      }
    }
    out[p] = b_cand >= 0 ? ((b_cand + 1) << 12) | (b_mlf << 6) | (b_tier << 2) |
                               b_back
                         : 0;
  }
  __syncthreads();

  // positional fallback: order by s0 alone, probes +1 and +2; it must beat
  // the total ml, and clears the tier
  identity_order(s, N);
  sort_by_s0(W, s, N, blk);
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    const Cand c = nearest(W, s, t, 2, kMaxW);
    const int v = out[p];
    const int ml = v ? max((v >> 6) & 63, tier_len((v >> 2) & 15, deep)) : 0;
    if (c.ml > ml) out[p] = pack(c);
  }
}

__global__ void __launch_bounds__(kParseThreads)
enc_deep_dp_kernel(const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ pk, int32_t* __restrict__ st,
                   int blk, int capped_ml, int deep) {
  __shared__ int first_bnd[kParseThreads];
  __shared__ int ring[kDpRing];
  __shared__ int32_t cm[kDpChunk];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const Fields F{pk + (size_t)b * blk, n, blk, capped_ml, deep};
  int32_t* M = st + (size_t)b * blk;

  chain_lengths(F, start, M, first_bnd);

  for (int k = tid; k < kDpRing; k += kParseThreads) ring[k] = 0;
  const int R = min(kDpR, blk);
  for (int hi = blk; hi > 0; hi -= kDpChunk) {
    const int lo = max(hi - kDpChunk, 0);
    for (int k = lo + tid; k < hi; k += kParseThreads) cm[k - lo] = M[k];
    __syncthreads();
    if (tid == 0) {
      for (int p = hi - 1; p >= lo; --p) {
        const int v = cm[p - lo];
        const int lit = 256 + ring[(p + 1) & (kDpRing - 1)];
        if (!(v & kImBit)) {
          ring[p & (kDpRing - 1)] = lit;
          continue;
        }
        int ml = v & kMlMask;
        const int jmp = min(ml, R);
        const int esc = jmp - 4 >= 15 ? 1 + max(jmp - 19, 0) / 255 : 0;
        int best = 256 * (3 + esc) + ring[(p + jmp) & (kDpRing - 1)];
        bool cut = false;
        if (R >= 18 && jmp > 18) {
          const int a_tr = 768 + ring[(p + 18) & (kDpRing - 1)];
          if (a_tr < best) {  // the 18-byte cut, only when strictly cheaper
            cut = true;
            best = a_tr;
          }
        }
        const bool take = best <= lit;  // ties go to the match
        ring[p & (kDpRing - 1)] = min(best, lit);
        if (cut) ml = min(ml, 18);
        cm[p - lo] = ml | (take ? kImBit : 0) |
                     ((v & kCapEndBit) && !cut ? kCapEndBit : 0);
      }
    }
    __syncthreads();
    for (int k = lo + tid; k < hi; k += kParseThreads) M[k] = cm[k - lo];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kParseThreads)
enc_deep_emit_kernel(const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ pk,
                     const int32_t* __restrict__ st,
                     int32_t* __restrict__ chosen, int32_t* __restrict__ runs,
                     uint8_t* __restrict__ out, int32_t* __restrict__ out_len,
                     int blk, int cap, int runcap, int chcap) {
  extern __shared__ uint32_t imask[];
  __shared__ int pool_i[kExtPool], pool_e[kExtPool];
  __shared__ int s_nch, s_npool, s_nruns, s_olen;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const uint8_t* row = data + (size_t)b * blk;
  const Fields F{pk + (size_t)b * blk, n, blk, 0, 0};
  const int32_t* M = st + (size_t)b * blk;
  int32_t* C = chosen + (size_t)b * chcap;
  int32_t* R = runs + (size_t)b * runcap;
  uint8_t* o = out + (size_t)b * cap;
  // the pool is 512 rows per 64 KB of window; windows here are <= 64 KB
  const int P = min(kExtPool, blk);

  // --- the take bits as a mask
  const int lane = tid & 31, warp = tid >> 5;
  for (int base = warp * 32; base < blk; base += kParseThreads) {
    const int p = base + lane;
    const unsigned bits =
        __ballot_sync(0xFFFFFFFFu, p < blk && (M[p] & kImBit) != 0);
    if (lane == 0) imask[base >> 5] = bits;
  }
  __syncthreads();

  // --- greedy parse: the chosen rows, and the pool of capped ends
  if (tid == 0) {
    const int nw = (blk + 31) >> 5;
    int nch = 0, npool = 0, pos = 0;
    while (n > start) {
      int wi = pos >> 5;
      if (wi >= nw) break;
      uint32_t bits = imask[wi] & (0xFFFFFFFFu << (pos & 31));
      while (bits == 0 && ++wi < nw) bits = imask[wi];
      if (bits == 0) break;
      const int p = (wi << 5) + __ffs(bits) - 1;
      const int v = M[p];
      C[nch++] = p;
      if ((v & kCapEndBit) && npool < P) pool_i[npool++] = p;
      pos = p + (v & kMlMask);
    }
    s_nch = nch;
    s_npool = npool;
  }
  __syncthreads();

  // --- exact extension of the pooled ends
  auto word = [&](int j) {  // LE u32 at the clipped index, zero past n
    j = min(max(j, 0), blk - 1);
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k)
      if (j + k < n) v |= (uint32_t)row[j + k] << (8 * k);
    return v;
  };
  for (int k = tid; k < s_npool; k += kParseThreads) {
    const int i = pool_i[k];
    const int E = i + (M[i] & kMlMask), off = i - F.cand(i);
    const int capv = min(max(n - 5 - E, 0), kExtBytes);
    int e = 0;
    bool alive = capv > 0;
    for (int round = 0; round < kExtBytes / 16; ++round) {
      const int base = E + e;
      int adv = 0;
      bool still = true;
      for (int w = 0; w < 4; ++w) {
        const uint32_t x = word(base + 4 * w) ^ word(base - off + 4 * w);
        if (still) adv += x == 0 ? 4 : (__ffs(x) - 1) >> 3;
        still = still && x == 0;
      }
      adv = alive ? min(adv, capv - e) : 0;
      e += adv;
      alive = alive && still && e < capv;
    }
    pool_e[k] = e;
  }
  __syncthreads();

  // --- absorb and emission (one thread): prevcov is the running maximum
  // of the extended ends over the chosen rows before this one
  if (tid == 0) {
    Emitter em{o, R, start};
    if (n > start) {
      int prevcov = 0, pi = 0, moved = 0;
      const int nch = s_nch, npool = s_npool;
      for (int k = 0; k < nch; ++k) {
        const int i = C[k];
        int ml = M[i] & kMlMask;
        if (pi < npool && pool_i[pi] == i) ml += pool_e[pi++];
        const int Ev = i + ml;
        if (Ev - max(i, prevcov) >= 4) {
          const int off = i - F.cand(i);
          if (prevcov > i) {  // moved to its trimmed start
            if (moved++ < P) em.add(prevcov, Ev, off, 0);
          } else {
            em.add(i, Ev, off, F.pk[i] & 3);
          }
        }
        prevcov = max(prevcov, Ev);
      }
      em.finish(n);
    }
    s_nruns = em.nr;
    s_olen = em.op;
    out_len[b] = em.op;
  }
  __syncthreads();

  copy_runs(row, R, s_nruns, o, s_olen, cap);
}

}  // namespace

extern "C" int zl4_enc_deep_match(const void* data, const void* lens,
                                  void* ranks, void* pk, int B, int blk,
                                  int hc, int deep, void* stream) {
  // ranks: scratch, int32[B, 1, blk] for the 32-byte rank, int32[B, 2, blk]
  // at deep == 3, which adds the 256-byte rank
  if (B <= 0 || blk <= 0 || blk > 65536 || hc < 1 || deep < 1 || deep > 3)
    return (int)cudaErrorInvalidValue;
  const MatchShape m = match_shape(blk);
  cudaError_t err = cudaFuncSetAttribute(
      enc_deep_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)m.smem);
  if (err != cudaSuccess) return (int)err;
  enc_deep_match_kernel<<<B, kMatchThreads, m.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)ranks,
      (int32_t*)pk, blk, m.N, m.nwords, hc, deep);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_deep_dp(const void* lens, const void* starts,
                               const void* pk, void* st, int B, int blk,
                               int capped_ml, int deep, void* stream) {
  if (B <= 0 || blk <= 0 || blk > 65536 || deep < 1 || deep > 3)
    return (int)cudaErrorInvalidValue;
  enc_deep_dp_kernel<<<B, kParseThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)lens, (const int32_t*)starts, (const int32_t*)pk,
      (int32_t*)st, blk, capped_ml, deep);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_deep_emit(const void* data, const void* lens,
                                 const void* starts, const void* pk,
                                 const void* st, void* chosen, void* runs,
                                 void* out, void* out_len, int B, int blk,
                                 int cap, int runcap, int chcap,
                                 void* stream) {
  // chosen: int32[B, chcap] scratch, one entry per selected match (at most
  // blk / 4); runs as in zl4_enc_parse_emit
  if (B <= 0 || blk <= 0 || blk > 65536 || runcap < 3 * (blk / 4 + 1) ||
      chcap < blk / 4 + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((blk + 31) / 32) * 4;
  enc_deep_emit_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const int32_t*)starts,
      (const int32_t*)pk, (const int32_t*)st, (int32_t*)chosen, (int32_t*)runs,
      (uint8_t*)out, (int32_t*)out_len, blk, cap, runcap, chcap);
  return (int)cudaGetLastError();
}
