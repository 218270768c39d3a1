// LZ4 block encoder, levels 0-9: match finding, parse and emission.
//
// Replaces: _encode_block of the JAX reference (ops/jax_block.py:200-1103)
// at deep=0: hc=0 (the fast finder, W = 8, 4, 2 or 1 carried windows) and
// hc >= 1 (the HC finder, W = 8).  The TPU version is gather-free: stable
// sorts, unsort sorts, packed cummax fills, a chunked scan for the greedy
// parse, and one grand sort that places every output byte.  On Hopper
// gathers and shared memory are cheap, so the same bytes come from these
// kernels:
//
// enc_match (hc >= 1; one 1024-thread block per window of up to 64 KB):
//   window build (:249-272) into shared memory, the stable 3-key sort of
//   :349-350 -- positions ordered by (s0, su[i+4], su[i+8], i) -- as 12
//   stable byte passes of the LSD radix sort of sort_radix.cuh (window
//   bytes i+8..i+11, i+4..i+7, then s0's four bytes, which are 0xFF on the
//   rows past n - 4), the +-1..+-hc probes of cand_at (:379-450) on the
//   sorted rows, the unsort as a store to the position (:455-469), then the
//   fallback order (s0, i) in 4 more passes, with probes +1 and +2
//   (:471-516).  Output per position: the reference's pack
//   ((cand + 1) << 12) | (fine ml << 6) | back, 0 when there is none.
//   Shared memory: the window words (64 KB), one u16 order over the blk rows
//   (128 KB) and the passes' histograms (32 KB), 224 KB at 64 KB, so one
//   window runs per SM; a pass keeps its rows in registers while it
//   scatters them back into the one order buffer.
//   Bound: issue of the passes' ballots and shared-memory accesses, and the
//   probes' shared-memory loads (each compares up to 36 bytes of two rows);
//   not device memory: it reads each window once and writes 4 bytes per
//   position.
//
// enc_match_fast (hc == 0; one 1024-thread block per window): window build,
//   ONE bitonic sort by (s0, i) -- the stable 1-key sort of :348-352 -- and
//   probes +1..+probes against the nearest previous rows of the group, a
//   later probe winning only when strictly longer (:433-450), over W
//   carried windows (fast_params, :179-197).  No fallback pass.  Bound: the
//   one sort, with 4-byte keys.
//
// enc_parse_emit (one 256-thread block per window of up to 2^19 bytes):
//   1. same-offset chain extension (:522-552) and the n-5 clamp (:554-555),
//      position-parallel and coalesced: the chain boundaries as a bit mask
//      by warp ballots, the nearest boundary after each 32-row word by a
//      block-wide reverse scan, then every row's length from its nearest
//      boundary at or after it (a bit scan within its word);
//   2. two-step lazy deferral (:684-710; HC only) into a bit mask of the
//      final match rows, by warp ballots;
//   3. the greedy parse (:716-743): the warps stage, 2,048 rows at a time,
//      each match row's successor -- the first match row at or after its
//      end, found in the mask by a bit scan within a word and a block-wide
//      reverse scan over the words -- into shared memory, and one thread
//      follows the chain through them, one shared load a chosen row, a
//      span behind the warps; it lists the chosen rows and nothing else;
//   4. the emission (:871-1103), in parallel over the list: an entry merges
//      into the one before it when it starts at that one's end at the same
//      offset; the last entry of each merged group finds its head by a
//      block max-scan, computes the group's literal run (from the previous
//      end, extended back over <= back literals) and its header bytes
//      (255-escapes, LE offset), and a block sum-scan of the groups' sizes
//      places it; a literal run under 32 bytes is copied by that thread,
//      longer ones (the tail's too) and the zeros past out_len by all
//      warps.
//   Shared memory: the mask and the next set bit after each of its words
//   (blk / 4 bytes: 16 KB at 64 KB, 80 KB at 327,680) and two staged spans
//   (16 KB).  Bound: the one parsing thread's chain through shared memory,
//   a few tens of cycles a chosen match, and the position-parallel phases'
//   loads; not the bytes it must move.
//
// Built with -DZL4_STOP=k, a kernel stops after its k-th phase and stores
// what that phase left, so that chip_smoke.py can time the phases one by
// one; the library is built without it.

#include "sort_radix.cuh"

#ifdef ZL4_STOP
#define ZL4_STOP_AFTER(k, keep) \
  if (ZL4_STOP == (k)) {        \
    keep;                       \
    return;                     \
  }
#else
#define ZL4_STOP_AFTER(k, keep)
#endif

namespace {

constexpr int kStage = 2048;  // rows of successors the walk stages at a time
constexpr int kShortRun = 32;  // literal runs shorter go byte by byte

__global__ void __launch_bounds__(kRadixThreads)
enc_match_kernel(const uint8_t* __restrict__ data,
                 const int32_t* __restrict__ lens, int32_t* __restrict__ pk,
                 int blk, int nwords, int hc) {
  extern __shared__ uint32_t smem[];
  __shared__ int part[33];
  uint32_t* words = smem;
  uint32_t* hist = smem + nwords;
  uint16_t* s = reinterpret_cast<uint16_t*>(hist + kRadixHistWords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, blk);
  const Window W{words, n};
  ZL4_STOP_AFTER(1, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = words[t % nwords])

  // 12-byte lexicographic order, ties by position
  sort_words(W, s, blk, hist, part, 3);
  ZL4_STOP_AFTER(2, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = s[t])
  for (int t = threadIdx.x; t < blk; t += blockDim.x)
    out[s[t]] = pack(nearest_both(W, s, t, blk, hc));
  __syncthreads();
  ZL4_STOP_AFTER(3, )

  // positional fallback: order by s0 alone, probes +1 and +2
  identity_order(s, blk);
  sort_words(W, s, blk, hist, part, 1);
  ZL4_STOP_AFTER(4, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = s[t])
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    const Cand c = nearest(W, s, t, 2, kMaxW);
    if (c.ml > ((out[p] >> 6) & 63)) out[p] = pack(c);
  }
}

__global__ void __launch_bounds__(kMatchThreads)
enc_match_fast_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      int32_t* __restrict__ pk, int blk, int N, int nwords,
                      int nwin, int probes) {
  extern __shared__ uint32_t smem[];
  uint32_t* words = smem;
  uint16_t* s = reinterpret_cast<uint16_t*>(smem + nwords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, N);
  const Window W{words, n};
  sort_by_s0(W, s, N, blk);
  for (int t = threadIdx.x; t < blk; t += blockDim.x)
    out[s[t]] = pack(nearest(W, s, t, probes, nwin));
}

// Inclusive scan of v over the block's kParseThreads threads under op, with
// the block's total; tmp: kParseThreads / 32 elements of shared memory.
template <class Op>
__device__ __forceinline__ int block_scan(int v, int* tmp, Op op,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nw = kParseThreads / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v = op(v, x);
  }
  if (lane == 31) tmp[warp] = v;
  __syncthreads();
  int pre = tmp[0];
  for (int k = 1; k < warp; ++k) pre = op(pre, tmp[k]);
  if (warp > 0) v = op(pre, v);
  total = tmp[0];
  for (int k = 1; k < nw; ++k) total = op(total, tmp[k]);
  __syncthreads();
  return v;
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return max(a, b);
  }
};
struct SumOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a + b;
  }
};

// The literal run of lit bytes from row[src] to o[dst]: copied here when
// it is shorter than kShortRun, else listed in R (src, dst, len) for the
// warps, at the index the shared counter nlong hands out.
__device__ __forceinline__ void literal_run(const uint8_t* row, int src,
                                            uint8_t* o, int dst, int lit,
                                            int32_t* R, int* nlong) {
  if (lit < kShortRun) {
    for (int k = 0; k < lit; ++k) o[dst + k] = row[src + k];
    return;
  }
  const int r = atomicAdd(nlong, 1);
  R[3 * r] = src;
  R[3 * r + 1] = dst;
  R[3 * r + 2] = lit;
}

// Bytes of the 255-escaped continuation of a length field whose token
// nibble saturated: put_len's count for v = length - 15 >= 0.
__device__ __forceinline__ int len_bytes(int v) {
  return v >= 0 ? v / 255 + 1 : 0;
}

// Two-step lazy deferral (jax_block.py:684-710; lazy = HC only) into the
// bit mask of the final match rows.
__device__ void match_mask(const int32_t* M, int blk, int lazy,
                           uint32_t* imask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int base = warp * 32; base < blk; base += kParseThreads) {
    const int p = base + lane;
    bool keep = false;
    if (p < blk) {
      int m[5];
      bool im[5];
      for (int k = 0; k < 5; ++k) {
        const int v = p + k < blk ? M[p + k] : 0;
        m[k] = v & kMlMask;
        im[k] = (v & kImBit) != 0;
      }
      const bool g1 = im[1] && m[1] > m[0] + 1;
      const bool g2 = im[2] && m[2] > m[0] + 2;
      const bool d0_1 = (im[2] && m[2] > m[1] + 1) || (im[3] && m[3] > m[1] + 2);
      const bool d0_2 = (im[3] && m[3] > m[2] + 1) || (im[4] && m[4] > m[2] + 2);
      const bool defer =
          lazy && im[0] && ((g1 && !d0_1) || (g2 && !d0_2 && (d0_1 || !im[1])));
      keep = im[0] && !defer;
    }
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) imask[base >> 5] = bits;
  }
  __syncthreads();
}

// Greedy parse (jax_block.py:716-743): the lowest match row not yet
// covered, again and again; from a chosen row p the next one is the first
// match row at or after p + ml(p).  The warps stage that next row for
// every match row of a kStage-row span into shared memory (imask and inext
// from next_after_words find it); thread 0 follows the chain, one shared
// load a chosen row, while warps 1.. stage the span after its own into the
// other half of buf.  Lists each chosen row in L; returns the count on
// every thread.  walk: 4 ints of shared memory, the walker's (row, count)
// by the parity of the step, so that it can post a step's while the others
// still read the last one's.
__device__ int greedy_walk(const int32_t* M, const uint32_t* imask,
                           const int* inext, int blk, int* buf, int32_t* L,
                           int* walk) {
  const int tid = threadIdx.x;
  const int nstage = (blk + kStage - 1) / kStage;
  auto stage = [&](int c, int t0, int nt) {
    const int lo = c * kStage, hi = min(lo + kStage, blk);
    int* dst = buf + (c & 1) * kStage - lo;
#pragma unroll 4
    for (int p = lo + t0; p < hi; p += nt)
      if ((imask[p >> 5] >> (p & 31)) & 1u)
        dst[p] = first_at_or_after(imask, inext, p + (M[p] & kMlMask));
  };
  int p = first_at_or_after(imask, inext, 0);
  if (p >= blk) return 0;  // no match row
  int cur = p / kStage, cnt = 0;
  stage(cur, tid, kParseThreads);
  __syncthreads();
  for (int par = 0;; par ^= 2) {
    if (tid == 0) {
      const int hi = min((cur + 1) * kStage, blk);
      const int* nx = buf + (cur & 1) * kStage - cur * kStage;
      while (p < hi) {
        L[cnt++] = p;
        p = nx[p];
      }
      walk[par] = p;
      walk[par + 1] = cnt;
    } else if (tid >= 32 && cur + 1 < nstage) {
      stage(cur + 1, tid - 32, kParseThreads - 32);
    }
    __syncthreads();
    p = walk[par];
    if (p >= blk) {
      cnt = walk[par + 1];
      break;
    }
    const int next = p / kStage;
    if (next != cur + 1) {  // a match or a gap skipped the staged span
      stage(next, tid, kParseThreads);
      __syncthreads();
    }
    cur = next;
  }
  __syncthreads();
  return cnt;
}

__global__ void __launch_bounds__(kParseThreads)
enc_parse_emit_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ pk, int32_t* __restrict__ mlw,
                      int32_t* __restrict__ runs, uint8_t* __restrict__ out,
                      int32_t* __restrict__ out_len, int blk, int cap,
                      int runcap, int capped_ml, int lazy) {
  extern __shared__ uint32_t sm[];
  __shared__ int tmp[kParseThreads / 32];
  __shared__ int s_walk[4];
  __shared__ int s_nlong;
  const int nw = (blk + 31) >> 5;
  uint32_t* mask = sm;                         // boundaries, then match rows
  int* nxt = reinterpret_cast<int*>(sm + nw);  // the next set bit after a word
  int* buf = nxt + nw;                         // the walk's staged spans
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const uint8_t* row = data + (size_t)b * blk;
  const Fields F{pk + (size_t)b * blk, n, blk, capped_ml, 0};
  int32_t* M = mlw + (size_t)b * blk;
  int32_t* L = runs + (size_t)b * runcap;  // chosen rows, blk / 4 + 1
  int32_t* R = L + blk / 4 + 1;            // literal runs (src, dst, len)
  uint8_t* o = out + (size_t)b * cap;

  chain_lengths_par(F, start, M, mask, nxt, tmp);
  ZL4_STOP_AFTER(1, )
  match_mask(M, blk, lazy, mask);
  next_after_words(mask, nw, blk, nxt, tmp);
  ZL4_STOP_AFTER(2, for (int w = tid; w < nw; w += kParseThreads)
                        L[w] = nxt[w])
  const int cnt = n > start ? greedy_walk(M, mask, nxt, blk, buf, L, s_walk)
                            : 0;
  ZL4_STOP_AFTER(3, )

  // --- emission, in tiles of kParseThreads list entries (one a thread);
  // a literal run shorter than kShortRun is copied by the thread that
  // writes its header, a longer one is listed in R for the warps
  if (tid == 0) s_nlong = 0;
  int carry_head = -1, carry_out = 0;  // before this tile
  for (int t0 = 0; t0 < cnt; t0 += kParseThreads) {
    const int i = t0 + tid;
    int p = 0, e = 0, off = 0;
    bool head = false, last = false;
    if (i < cnt) {
      p = L[i];
      e = p + (M[p] & kMlMask);
      off = p - F.cand(p);
      head = true;
      if (i > 0) {  // continues the previous selection at the same offset
        const int pp = L[i - 1];
        head = !(pp + (M[pp] & kMlMask) == p && pp - F.cand(pp) == off);
      }
      last = true;
      if (i + 1 < cnt) {
        const int np = L[i + 1];
        last = !(np == e && np - F.cand(np) == off);
      }
    }
    int tot_h, tot_o;
    const int h = max(carry_head,
                      block_scan(head ? i : -1, tmp, MaxOp{}, tot_h));
    int lit = 0, mml = 0, ls = 0, size = 0;
    if (last) {  // the group h..i: one sequence
      const int ph = L[h];
      const int prev_end =
          h > 0 ? max(L[h - 1] + (M[L[h - 1]] & kMlMask), start) : start;
      const int bq = max(min(min(F.pk[ph] & 3, ph - prev_end), ph - off), 0);
      ls = prev_end;
      lit = ph - bq - prev_end;
      mml = e - (ph - bq);
      size = 1 + len_bytes(lit - 15) + lit + 2 + len_bytes(mml - 19);
    }
    int q = carry_out + block_scan(size, tmp, SumOp{}, tot_o) - size;
    if (last) {
      o[q++] = (uint8_t)((min(lit, 15) << 4) | min(mml - 4, 15));
      if (lit >= 15) put_len(o, q, lit - 15);
      literal_run(row, ls, o, q, lit, R, &s_nlong);
      q += lit;
      o[q++] = (uint8_t)(off & 0xFF);
      o[q++] = (uint8_t)(off >> 8);
      if (mml - 4 >= 15) put_len(o, q, mml - 19);
    }
    carry_head = max(carry_head, tot_h);
    carry_out += tot_o;
  }

  // --- the tail literal run (one thread), then the long literal runs by
  // all warps and zeros past out_len
  if (tid == 0) {
    int q = carry_out;
    if (n > start) {
      const int tail =
          cnt > 0 ? max(L[cnt - 1] + (M[L[cnt - 1]] & kMlMask), start)
                  : start;
      const int lit = n - tail;
      o[q++] = (uint8_t)(min(lit, 15) << 4);
      if (lit >= 15) put_len(o, q, lit - 15);
      literal_run(row, tail, o, q, lit, R, &s_nlong);
      q += lit;
    }
    s_walk[0] = q;
    out_len[b] = q;
  }
  __syncthreads();
  copy_runs(row, R, s_nlong, o, s_walk[0], cap);
}

}  // namespace

extern "C" int zl4_enc_match(const void* data, const void* lens, void* pk,
                             int B, int blk, int hc, void* stream) {
  if (B <= 0 || blk <= 0 || blk > kRadixMaxRows || hc < 1)
    return (int)cudaErrorInvalidValue;
  // the window words, the passes' histograms and the u16 order
  const int nwords = (blk + kPad) / 4 + 1;
  const size_t smem = ((size_t)nwords + kRadixHistWords) * 4 +
                      (size_t)blk * 2;
  cudaError_t err = cudaFuncSetAttribute(
      enc_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_match_kernel<<<B, kRadixThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)pk, blk, nwords,
      hc);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_match_fast(const void* data, const void* lens,
                                  void* pk, int B, int blk, int nwin,
                                  int probes, void* stream) {
  if (B <= 0 || blk <= 0 || blk > 65536 || nwin < 1 || nwin > kMaxW ||
      probes < 1)
    return (int)cudaErrorInvalidValue;
  const MatchShape m = match_shape(blk);
  cudaError_t err = cudaFuncSetAttribute(
      enc_match_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)m.smem);
  if (err != cudaSuccess) return (int)err;
  enc_match_fast_kernel<<<B, kMatchThreads, m.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)pk, blk, m.N,
      m.nwords, nwin, probes);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_parse_emit(const void* data, const void* lens,
                                  const void* starts, const void* pk, void* mlw,
                                  void* runs, void* out, void* out_len, int B,
                                  int blk, int cap, int runcap, int capped_ml,
                                  int lazy, void* stream) {
  // runcap: ints per window of ``runs``: the chosen rows, then the literal
  // runs, 3 ints each.  A window has at most blk / 4 + 1 chosen rows (each
  // match covers >= 4 bytes), so at most blk / 4 + 2 runs.  Windows over
  // 64 KB (enc_match_wide's) are taken up to the candidate pack's 2^19:
  // the 20-bit length field (kMlMask) holds any ml < blk.
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) ||
      runcap < (blk / 4 + 1) + 3 * (blk / 4 + 2))
    return (int)cudaErrorInvalidValue;
  // the two masks' words: the mask, the next set bit after each word; the
  // walk's two staged spans
  const int nw = (blk + 31) / 32;
  const size_t smem = (2 * (size_t)nw + 2 * kStage) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      enc_parse_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_parse_emit_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const int32_t*)starts,
      (const int32_t*)pk, (int32_t*)mlw, (int32_t*)runs, (uint8_t*)out,
      (int32_t*)out_len, blk, cap, runcap, capped_ml, lazy);
  return (int)cudaGetLastError();
}
