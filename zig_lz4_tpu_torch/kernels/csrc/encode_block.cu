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
// enc_match (hc >= 1; one 1024-thread block per window):
//   window build (:249-272) into shared memory, a bitonic sort of the
//   positions by (s0, su[i+4], su[i+8], i) -- the stable 3-key sort of
//   :349-350, since the index breaks every tie -- the +-1..+-hc probes of
//   cand_at (:379-450) on the sorted rows, the unsort as a store to the
//   position (:455-469), then the fallback order (s0, i) with probes +1
//   and +2 (:471-516).  Output per position: the reference's pack
//   ((cand + 1) << 12) | (fine ml << 6) | back, 0 when there is none.
//   Bound: the sort.  65536 u16 indices plus the 64 KB window fill 196 KB
//   of shared memory, so one window runs per SM; each of the 136 bitonic
//   stages recomputes 12-byte keys from the window in shared memory, so
//   the kernel is bound by shared-memory loads and issue, not by device
//   memory (it reads each window once and writes 4 bytes per position).
//
// enc_match_fast (hc == 0; same block shape and shared memory):
//   window build, ONE bitonic sort by (s0, i) -- the stable 1-key sort of
//   :348-352 -- and probes +1..+probes against the nearest previous rows
//   of the group, a later probe winning only when strictly longer
//   (:433-450), over W carried windows (fast_params, :179-197).  No
//   fallback pass.  Bound: the one sort, with 4-byte keys.
//
// enc_parse_emit (one 256-thread block per window, blk / 8 bytes of shared
// memory: 8 KB at 64 KB, 40 KB at the 327,680-byte windows of
// encode_wide.cu):
//   same-offset chain extension (:522-552) as a chunked nearest-boundary
//   scan, the n-5 clamp (:554-555), two-step lazy deferral (:684-710; HC
//   only) as a bit mask built with warp ballots, then one thread walks the
//   mask for the greedy parse (:716-743) -- it jumps from match end to the
//   next set bit, so it costs words + matches, not positions -- and writes
//   the sequence headers (:871-1103: chained selections at one offset
//   merge, heads extend back over <= 2 literals, 255-escapes, LE offsets,
//   the tail literal run).  The literal runs it records are copied by all
//   warps.  Bound: the single parsing thread's dependent loads; the small
//   footprint lets every window of a launch run at once.

#include "encode_common.cuh"

namespace {

__global__ void __launch_bounds__(kMatchThreads)
enc_match_kernel(const uint8_t* __restrict__ data,
                 const int32_t* __restrict__ lens, int32_t* __restrict__ pk,
                 int blk, int N, int nwords, int hc) {
  extern __shared__ uint32_t smem[];
  uint32_t* words = smem;
  uint16_t* s = reinterpret_cast<uint16_t*>(smem + nwords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, N);
  const Window W{words, n};

  // 12-byte lexicographic order, ties by position
  bitonic_sort(s, N, Less12{W, blk});
  for (int t = threadIdx.x; t < blk; t += blockDim.x)
    out[s[t]] = pack(nearest_both(W, s, t, blk, hc));
  __syncthreads();

  // positional fallback: order by s0 alone, probes +1 and +2
  identity_order(s, N);
  sort_by_s0(W, s, N, blk);
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

__global__ void __launch_bounds__(kParseThreads)
enc_parse_emit_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ pk, int32_t* __restrict__ mlw,
                      int32_t* __restrict__ runs, uint8_t* __restrict__ out,
                      int32_t* __restrict__ out_len, int blk, int cap,
                      int runcap, int capped_ml, int lazy) {
  extern __shared__ uint32_t imask[];
  __shared__ int first_bnd[kParseThreads];
  __shared__ int s_nruns, s_olen;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const uint8_t* row = data + (size_t)b * blk;
  const Fields F{pk + (size_t)b * blk, n, blk, capped_ml, 0};
  int32_t* M = mlw + (size_t)b * blk;
  int32_t* R = runs + (size_t)b * runcap;
  uint8_t* o = out + (size_t)b * cap;

  chain_lengths(F, start, M, first_bnd);

  // --- two-step lazy deferral (HC only) into a bit mask of final match
  // rows
  const int lane = tid & 31, warp = tid >> 5;
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

  // --- greedy parse and sequence headers (one thread)
  if (tid == 0) {
    Emitter em{o, R, start};
    if (n > start) {
      const int nw = (blk + 31) >> 5;
      int pos = 0;
      while (true) {
        int wi = pos >> 5;
        if (wi >= nw) break;
        uint32_t bits = imask[wi] & (0xFFFFFFFFu << (pos & 31));
        while (bits == 0 && ++wi < nw) bits = imask[wi];
        if (bits == 0) break;
        const int p = (wi << 5) + __ffs(bits) - 1;
        const int e = p + (M[p] & kMlMask);
        em.add(p, e, p - F.cand(p), F.pk[p] & 3);
        pos = e;
      }
      em.finish(n);
    }
    s_nruns = em.nr;
    s_olen = em.op;
    out_len[b] = em.op;
  }
  __syncthreads();

  // --- literal runs, one warp each; zeros past out_len
  copy_runs(row, R, s_nruns, o, s_olen, cap);
}

}  // namespace

extern "C" int zl4_enc_match(const void* data, const void* lens, void* pk,
                             int B, int blk, int hc, void* stream) {
  if (B <= 0 || blk <= 0 || blk > 65536 || hc < 1)
    return (int)cudaErrorInvalidValue;
  const MatchShape m = match_shape(blk);
  cudaError_t err = cudaFuncSetAttribute(
      enc_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)m.smem);
  if (err != cudaSuccess) return (int)err;
  enc_match_kernel<<<B, kMatchThreads, m.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)pk, blk, m.N,
      m.nwords, hc);
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
  // runcap: ints per window of ``runs``, 3 per literal run; a window has
  // at most blk / 4 matches, so at most blk / 4 + 1 runs.  Windows over
  // 64 KB (enc_match_wide's) are taken up to the candidate pack's 2^19:
  // the 20-bit length field (kMlMask) holds any ml < blk, and the match
  // mask is blk / 32 words, 40 KB at 327,680 bytes.
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) || runcap < 3 * (blk / 4 + 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((blk + 31) / 32) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        enc_parse_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  enc_parse_emit_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const int32_t*)starts,
      (const int32_t*)pk, (int32_t*)mlw, (int32_t*)runs, (uint8_t*)out,
      (int32_t*)out_len, blk, cap, runcap, capped_ml, lazy);
  return (int)cudaGetLastError();
}
