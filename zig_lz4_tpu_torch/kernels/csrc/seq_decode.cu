// LZ4 block rebuild from parsed sequences.
//
// Replaces: _decode_block of the JAX reference (ops/jax_decode.py:120-290;
// batched by _batched_decoder, :1389).  Each block arrives as its compressed
// payload plus the host parser's sequence table (lit_len, lit_src, mlen, off,
// nseq) and an optional history window that logically precedes the output
// (a dictionary or a streaming prefix, right-aligned: output position -k is
// hist[hcap - k]).  The TPU version is gather-free: it merge-fills the
// sequence fields onto the output bytes with sorts, folds self-overlapping
// matches modulo their offset and resolves the rest by rounds of pointer
// jumping.  Those are its formulation, not its output; what it computes is
// the LZ4 decode of the table:
//
//   out_len = sum(lit_len + mlen) over the live sequences
//   out[seg_start + k]           = comp[lit_src + k]            k < lit_len
//   out[mstart + k], mstart = seg_start + lit_len,
//                                = (hist | out)[mstart - off + k % off]
//                                                                k < mlen
//   out[j] = 0 for j >= out_len
//
// seq_decode (one 256-thread block per LZ4 block, the output block in shared
// memory):
//   1. a block scan of lit_len + mlen gives every sequence's seg_start;
//   2. every literal run is independent of every other byte, so all warps
//      copy them, one run per warp at a time;
//   3. a match reads bytes before its own start only (k % off folds an
//      overlapping match onto the off bytes before it), so within a match
//      every byte is independent, and the matches are resolved in sequence
//      order by one warp, 32 bytes a step, which loads the fields of 32
//      sequences at a time and passes them round by shuffles;
//   4. the block is written out, zero from out_len on.
// ok[b] = 0, and the whole row zero, when the table does not describe a
// block of at most blk bytes whose sources all exist: nseq outside
// [0, nseq_cap], a negative length, a literal run outside comp, a match
// that reaches before the history, or out_len > blk.  (The host parser
// rejects such payloads first; the kernel never reads or writes out of
// bounds on them.)
// Bound: the chain of matches in step 3 (one warp, a step per 32 bytes of
// match, a shared-memory round trip each), not bytes: a block moves its
// payload, 16 bytes per sequence and blk bytes out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeqThreads = 256;
constexpr int kMaxBlk = 65536;

__global__ void __launch_bounds__(kSeqThreads)
seq_decode_kernel(const uint8_t* __restrict__ comp,
                  const uint8_t* __restrict__ hist,
                  const int32_t* __restrict__ lit_len,
                  const int32_t* __restrict__ lit_src,
                  const int32_t* __restrict__ mlen,
                  const int32_t* __restrict__ off,
                  const int32_t* __restrict__ nseq,
                  int32_t* __restrict__ seg_start, uint8_t* __restrict__ out,
                  int32_t* __restrict__ out_len, int32_t* __restrict__ ok,
                  int ccap, int hcap, int hstride, int nseq_cap, int blk) {
  extern __shared__ uint8_t sout[];
  __shared__ int part[kSeqThreads];
  __shared__ int s_ok;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = kSeqThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const uint8_t* C = comp + (size_t)b * ccap;
  const uint8_t* H = hist + (size_t)b * hstride;
  const int32_t* LL = lit_len + (size_t)b * nseq_cap;
  const int32_t* LS = lit_src + (size_t)b * nseq_cap;
  const int32_t* ML = mlen + (size_t)b * nseq_cap;
  const int32_t* OF = off + (size_t)b * nseq_cap;
  int32_t* SS = seg_start + (size_t)b * nseq_cap;
  const int ns = min(max(nseq[b], 0), nseq_cap);
  if (tid == 0) s_ok = ns == nseq[b];
  __syncthreads();

  // --- 1. seg_start: exclusive scan of lit_len + mlen.  A length is cut to
  // blk + 1 (and flagged below, by out_len > blk), so the sum fits an int.
  auto seg_of = [&](int q) {
    const int l = LL[q], m = ML[q];
    if (l < 0 || m < 0) s_ok = 0;
    return min(max(l, 0), blk + 1) + min(max(m, 0), blk + 1);
  };
  const int chunk = (ns + T - 1) / T;
  const int lo = min(tid * chunk, ns), hi = min(lo + chunk, ns);
  long long sum = 0;
  for (int q = lo; q < hi; ++q) sum += seg_of(q);
  part[tid] = (int)min(sum, (long long)blk + 1);
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {  // inclusive scan, saturating at blk + 1
    const int v = tid >= d ? part[tid - d] : 0;
    __syncthreads();
    part[tid] = min(part[tid] + v, blk + 1);
    __syncthreads();
  }
  // exact while the block is valid: a saturated sum means out_len > blk
  const int total = part[T - 1];
  int run = tid ? part[tid - 1] : 0;
  for (int q = lo; q < hi; ++q) {
    SS[q] = run;
    run = min(run + seg_of(q), blk + 1);
  }
  if (tid == 0 && total > blk) s_ok = 0;
  __syncthreads();

  // --- 2. literal runs, one per warp at a time
  for (int q = warp; q < ns; q += T / 32) {
    const int d0 = SS[q], n = min(max(LL[q], 0), blk + 1), src = LS[q];
    if (n > 0 && (src < 0 || src > ccap - n)) s_ok = 0;
    for (int k = lane; k < n; k += 32) {
      const int d = d0 + k, s = src + k;
      if (d < blk) sout[d] = s >= 0 && s < ccap ? C[s] : 0;
    }
  }
  __syncthreads();

  // --- 3. matches, in sequence order, by one warp
  if (warp == 0) {
    for (int q0 = 0; q0 < ns; q0 += 32) {
      const int q = q0 + lane;
      int my_m = 0, my_o = 1, my_d = 0;
      if (q < ns) {
        my_m = min(max(ML[q], 0), blk + 1);
        my_o = max(OF[q], 1);
        my_d = SS[q] + min(max(LL[q], 0), blk + 1);
      }
      const int cnt = min(32, ns - q0);
      for (int i = 0; i < cnt; ++i) {
        const int m = __shfl_sync(0xFFFFFFFFu, my_m, i);
        const int o = __shfl_sync(0xFFFFFFFFu, my_o, i);
        const int d0 = __shfl_sync(0xFFFFFFFFu, my_d, i);
        if (m == 0) continue;
        const int s0 = d0 - o;  // first source byte, before the match
        if (s0 < -hcap) s_ok = 0;
        for (int k = lane; k < m; k += 32) {
          const int d = d0 + k;
          if (d >= blk) break;
          const int s = s0 + k % o;
          uint8_t v = 0;
          if (s >= 0) v = sout[s];  // s < d0 <= d < blk
          else if (s >= -hcap) v = H[hcap + s];
          sout[d] = v;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // --- 4. the block, zero from out_len on; all zero when not ok
  const int live = s_ok ? min(total, blk) : 0;
  uint8_t* O = out + (size_t)b * blk;
  for (int j = tid; j < blk; j += T) O[j] = j < live ? sout[j] : 0;
  if (tid == 0) {
    out_len[b] = total;
    ok[b] = s_ok;
  }
}

}  // namespace

extern "C" int zl4_seq_decode(const void* comp, const void* hist,
                              const void* lit_len, const void* lit_src,
                              const void* mlen, const void* off,
                              const void* nseq, void* seg_start, void* out,
                              void* out_len, void* ok, int B, int ccap,
                              int hcap, int hstride, int nseq_cap, int blk,
                              void* stream) {
  // hist: uint8[hcap] shared by every block (hstride 0) or uint8[B, hcap]
  // (hstride hcap); never read when hcap is 0.  seg_start: int32[B, nseq_cap]
  // scratch.
  if (B <= 0 || blk <= 0 || blk > kMaxBlk || ccap <= 0 || hcap < 0 ||
      hcap > kMaxBlk || nseq_cap <= 0 || (hstride != 0 && hstride != hcap))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      seq_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, blk);
  if (err != cudaSuccess) return (int)err;
  seq_decode_kernel<<<B, kSeqThreads, blk, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const uint8_t*)hist, (const int32_t*)lit_len,
      (const int32_t*)lit_src, (const int32_t*)mlen, (const int32_t*)off,
      (const int32_t*)nseq, (int32_t*)seg_start, (uint8_t*)out,
      (int32_t*)out_len, (int32_t*)ok, ccap, hcap, hstride, nseq_cap, blk);
  return (int)cudaGetLastError();
}
