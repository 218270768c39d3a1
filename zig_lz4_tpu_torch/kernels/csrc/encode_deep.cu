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
// enc_deep_match (one 1024-thread block per window of up to 64 KB; the window
//   and the u16 sort order in shared memory as in enc_match, the ranks in
//   global memory, 256 KB a window at 64 KB, which the L2 holds): the deep
//   finder of encode_deep.cuh -- the 32-byte rank, at deep = 3 the 256-byte
//   rank, the grand grouping sort, the +-1..+-hc probes with the nested tier
//   chain, the positional fallback.  Wider windows go to enc_deep_match_wide
//   (encode_deep_wide.cu), which runs the same steps over a u32 order held
//   by a thread-block cluster and sorted by radix passes.
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
//   positions at a time through shared memory, so any window below 2^19
//   bytes fits.  Costs stay below 256 * blk < 2^27, under the reference's
//   INF_D = 2^28 (:582).  Output per position: ml (cut to 18 where the
//   18-byte cut won) | take << 30 | cap_end << 29.
//   Bound: the one thread's dependent chain, blk steps a window.
//
// enc_deep_emit (one 256-thread block per window):
//   the greedy parse over the take bits (:716-743) by one thread, which lists
//   the chosen rows and pools the first P whose end is capped, with P = 512
//   per 64 KB of window (min(512 * max(blk / 65536, 1), blk), :774); the
//   pool's rows measure their exact extension in parallel, two rounds of
//   four u32 compares at the match's own offset, word indices clipped to the
//   window (:774-819); then one thread walks the chosen list with the
//   running maximum of the extended ends (the absorb, :838-863): a covered
//   match is dropped, one with >= 4 bytes left moves to its trimmed start
//   with back = 0 -- only the first P moved matches, as the reference's pool
//   (:857) -- and every kept selection goes to the one-thread emitter of
//   encode_common.cuh (Emitter), whose bytes enc_parse_emit's parallel
//   emission reproduces.  The take mask and the pool live in dynamic shared
//   memory: 61,440 bytes at 327,680, past the default 48 KB.

#include "encode_deep.cuh"

namespace {

constexpr int kDpRing = 1024;    // >= _DP_R + 1 entries, a power of two
constexpr int kDpR = 512;        // jumps are priced at min(ml, 512)
constexpr int kDpChunk = 4096;   // positions staged per round
constexpr int kExtPool = 512;    // pooled rows per 64 KB of window
constexpr int kExtBytes = 32;

// Extension pool rows of a blk-byte window: 512 per 64 KB (jax_block.py:774)
__host__ __device__ __forceinline__ int ext_pool(int blk) {
  const int P = kExtPool * (blk / 65536 > 1 ? blk / 65536 : 1);
  return P < blk ? P : blk;
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
  int32_t* r = ranks + (size_t)b * (deep == 3 ? 2 : 1) * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, N);
  deep_match(Window{words, n}, s, N, blk, hc, deep, r,
             r + blk, pk + (size_t)b * blk, part);
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
  extern __shared__ uint32_t imask[];  // then pool_i[P], pool_e[P]
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
  const int P = ext_pool(blk);
  int* pool_i = reinterpret_cast<int*>(imask + ((blk + 31) >> 5));
  int* pool_e = pool_i + P;

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
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) || deep < 1 || deep > 3)
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
  // blk / 4); runs: (src, dst, len) of each literal run, 3 ints a run
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) || runcap < 3 * (blk / 4 + 1) ||
      chcap < blk / 4 + 1)
    return (int)cudaErrorInvalidValue;
  // the take mask, then the extension pool's rows and extensions
  const size_t smem = ((size_t)((blk + 31) / 32) + 2 * ext_pool(blk)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      enc_deep_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_deep_emit_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const int32_t*)starts,
      (const int32_t*)pk, (const int32_t*)st, (int32_t*)chosen, (int32_t*)runs,
      (uint8_t*)out, (int32_t*)out_len, blk, cap, runcap, chcap);
  return (int)cudaGetLastError();
}
