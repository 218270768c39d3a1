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
// seq_decode (one 1024-thread block per LZ4 block of at most 64 KB; the
// whole block's state in dynamic shared memory: the output bytes sout
// uint8[blk], the pending source of every byte nx uint16[blk], and two
// masks of one "final" bit a byte, 212,992 bytes at 64 KB):
//   1. seg_start, by a block scan of lit_len + mlen (each cut to blk + 1,
//      the sums saturating at blk + 1);
//   2. the fill, a warp a batch of 32 sequences, its lanes over the
//      batch's literal bytes and then its match bytes, each byte's
//      sequence found by a search over the lanes' exclusive counts.  A
//      literal byte gets comp[lit_src + k] and is final.  A match byte
//      at d = mstart + k gets its folded source s = mstart - off +
//      k % off (the reference's self-overlap fold, jax_decode.py:132-134):
//      before the block (s < 0) it reads the history and is final; else
//      nx[d] = s and it is pending.  nx starts as 0xFFFF, which no source
//      can be (s < d <= 65535), and a pass over nx sets the masks;
//   3. rounds of pointer jumping over all pending bytes at once: a byte j
//      whose source p = nx[j] was final at the start of the round (the
//      `cur` mask, read-only in the round) copies sout[p] and sets its
//      bit in `nxt`; otherwise it jumps, nx[j] = nx[p].  The jump is made
//      in place: nx[p], old or new, lies on j's own chain, before j, so
//      any value a racing thread leaves is a correct source (nx is read
//      and written through volatile, so the compiler keeps both).
//      sout[p] is read only when p was final at the round's start, so no
//      byte is read while it is written.  A barrier merges the masks and
//      __syncthreads_or ends the rounds when no byte jumped;
//   4. the block is written out, zero from out_len on.
// Round bound: let D(j) be the hops from byte j to a final byte.  After
// round r every byte with D <= 2^r - 1 is final, and every other byte's
// source lies 2^r hops down its chain or further: round 1 resolves D = 1
// and moves each other byte 2 hops; in round r + 1 a byte whose source
// (at least 2^r hops on) has D <= 2^r - 1 finishes, and the others add
// their source's 2^r hops to their own.  So a block of chain depth D
// takes ceil(log2(D + 1)) <= ceil(log2 D) + 1 rounds, at most 16 for 64 KB
// (a chain through every sequence included); no loop runs over the
// matches in sequence order.
// ok[b] = 0, and the whole row zero, when the table does not describe a
// block of at most blk bytes whose sources all exist: nseq outside
// [0, nseq_cap], a negative length, a literal run outside comp, a match
// that reaches before the history, or out_len > blk.  (The host parser
// rejects such payloads first; the kernel never reads or writes out of
// bounds on them.)  rounds[b], when asked for, is the block's number of
// rounds.
// Bound on the H100: bytes -- a block moves its payload, 16 bytes per
// sequence and blk bytes out; the rounds stay in shared memory, a round
// a few shared-memory accesses per pending byte.
// Built with -DZL4_STOP=k the kernel stops after its k-th phase (1
// seg_start, 2 the fill, 3 the rounds) so that chip_smoke.py can time the
// phases one by one; the library is built without it.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kSeqThreads = 1024;
constexpr int kSeqWarps = kSeqThreads / 32;
constexpr int kMaxBlk = 65536;
constexpr unsigned kFull = 0xffffffffu;
// nx of a byte that copies from no earlier byte of the block
constexpr uint16_t kNoSource = 0xFFFF;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Dynamic shared memory of a blk-byte block: sout, nx, the two masks.
__host__ __device__ constexpr size_t seq_smem(int blk) {
  return align16(blk) + align16(2 * (size_t)blk) +
         8 * (size_t)((blk + 31) / 32);
}

// Exclusive sum of v over the block; *total gets the whole sum.  Every
// thread calls it; it ends on a barrier.
__device__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_sum[kSeqWarps];
  __shared__ int total_s;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[wid] = x;
  __syncthreads();
  if (wid == 0) {
    const int s = warp_sum[lane];
    int xs = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, xs, o);
      if (lane >= o) xs += y;
    }
    warp_sum[lane] = xs - s;
    if (lane == 31) total_s = xs;
  }
  __syncthreads();
  const int r = warp_sum[wid] + x - v;
  *total = total_s;
  __syncthreads();
  return r;
}

// The last lane whose `start` is <= idx; the lanes' starts do not
// decrease and lane 0's is 0 <= idx.  Every lane of the warp calls it.
__device__ __forceinline__ int owner_lane(int start, int idx) {
  int l = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1) {
    const int s = __shfl_sync(kFull, start, l + step);
    if (s <= idx) l += step;
  }
  return l;
}

__global__ void __launch_bounds__(kSeqThreads, 1)
seq_decode_kernel(const uint8_t* __restrict__ comp,
                  const uint8_t* __restrict__ hist,
                  const int32_t* __restrict__ lit_len,
                  const int32_t* __restrict__ lit_src,
                  const int32_t* __restrict__ mlen,
                  const int32_t* __restrict__ off,
                  const int32_t* __restrict__ nseq,
                  int32_t* __restrict__ seg_start, uint8_t* __restrict__ out,
                  int32_t* __restrict__ out_len, int32_t* __restrict__ ok,
                  int32_t* __restrict__ rounds, int ccap, int hcap,
                  int hstride, int nseq_cap, int blk) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sout = smem;
  uint16_t* nx = reinterpret_cast<uint16_t*>(smem + align16(blk));
  const int nwords = (blk + 31) >> 5;
  uint32_t* cur = reinterpret_cast<uint32_t*>(smem + align16(blk) +
                                              align16(2 * (size_t)blk));
  uint32_t* nxt = cur + nwords;
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
  {  // every byte starts with no pending source
    uint4* p = reinterpret_cast<uint4*>(nx);
    const uint4 none = make_uint4(kFull, kFull, kFull, kFull);
    for (int i = tid; i < (int)(align16(2 * (size_t)blk) / 16); i += T)
      p[i] = none;
  }
  __syncthreads();

  // --- 1. seg_start: exclusive scan of lit_len + mlen.  A length is cut to
  // blk + 1 (and flagged below, by out_len > blk), so the sums fit an int;
  // a sum past blk + 1 is held there.
  auto seg_of = [&](int q) {
    const int l = LL[q], m = ML[q];
    if (l < 0 || m < 0) s_ok = 0;
    return min(max(l, 0), blk + 1) + min(max(m, 0), blk + 1);
  };
  const int chunk = (ns + T - 1) / T;
  const int lo = min(tid * chunk, ns), hi = min(lo + chunk, ns);
  long long sum = 0;
  for (int q = lo; q < hi; ++q) sum += seg_of(q);
  int total;
  int run = block_exclusive_sum((int)min(sum, (long long)blk + 1), &total);
  total = min(total, blk + 1);  // exact while the block is valid
  run = min(run, blk + 1);
  for (int q = lo; q < hi; ++q) {
    SS[q] = run;
    run = min(run + seg_of(q), blk + 1);
  }
  if (tid == 0 && total > blk) s_ok = 0;
  __syncthreads();
  ZL4_STOP_AFTER(1, )

  // --- 2. the fill: a warp a batch of 32 sequences, a lane a byte
  for (int q0 = warp * 32; q0 < ns; q0 += T) {
    const int q = q0 + lane;
    int st = blk, n = 0, m = 0, o = 1, src = 0;
    if (q < ns) {
      st = SS[q];
      n = min(max(LL[q], 0), blk + 1);
      m = min(max(ML[q], 0), blk + 1);
      o = max(OF[q], 1);
      src = LS[q];
      if (n > 0 && (src < 0 || src > ccap - n)) s_ok = 0;
      if (m > 0 && st + n - o < -hcap) s_ok = 0;  // before the history
    }
    // the bytes of the sequence inside the block
    const int ms = min(st + n, blk);
    const int nl = max(min(n, blk - st), 0), nm = max(min(m, blk - ms), 0);
    int xl = nl, xm = nm;
    for (int d = 1; d < 32; d <<= 1) {
      const int yl = __shfl_up_sync(kFull, xl, d);
      const int ym = __shfl_up_sync(kFull, xm, d);
      if (lane >= d) {
        xl += yl;
        xm += ym;
      }
    }
    const int lits = __shfl_sync(kFull, xl, 31);
    const int matches = __shfl_sync(kFull, xm, 31);
    const int lo_l = xl - nl, lo_m = xm - nm;
#pragma unroll 4
    for (int base = 0; base < lits; base += 32) {
      const int idx = base + lane;
      const int l = owner_lane(lo_l, idx);
      const int k = idx - __shfl_sync(kFull, lo_l, l);
      const int d = __shfl_sync(kFull, st, l) + k;
      const int s = __shfl_sync(kFull, src, l) + k;
      if (idx < lits) sout[d] = s >= 0 && s < ccap ? C[s] : 0;
    }
    for (int base = 0; base < matches; base += 32) {
      const int idx = base + lane;
      const int l = owner_lane(lo_m, idx);
      const int k = idx - __shfl_sync(kFull, lo_m, l);
      const int d0 = __shfl_sync(kFull, ms, l);
      const int oo = __shfl_sync(kFull, o, l);
      if (idx < matches) {
        const int s = d0 - oo + (k < oo ? k : k % oo);
        if (s >= 0) nx[d0 + k] = (uint16_t)s;
        else if (s >= -hcap) sout[d0 + k] = H[hcap + s];
      }
    }
  }
  __syncthreads();
  int pending = 0;
  for (int w = warp; w < nwords; w += kSeqWarps) {
    const int j = (w << 5) + lane;
    const uint32_t pw =
        __ballot_sync(kFull, j < blk && nx[j] != kNoSource);
    if (lane == 0) cur[w] = ~pw;
    pending |= pw != 0;
  }
  pending = __syncthreads_or(pending);
  ZL4_STOP_AFTER(2, if (tid == 0) ok[b] = sout[0] + nx[0] + cur[0])

  // --- 3. pointer jumping over every pending byte
  volatile uint16_t* vnx = nx;
  int nround = 0;
  while (pending) {
    int moved = 0;
    for (int w = warp; w < nwords; w += kSeqWarps) {
      const uint32_t cw = cur[w];
      uint32_t got = 0;
      if (cw != kFull) {  // the whole warp
        bool newly = false;
        if (!(cw >> lane & 1)) {
          const int j = (w << 5) + lane, p = vnx[j];
          if (cur[p >> 5] >> (p & 31) & 1) {
            sout[j] = sout[p];
            newly = true;
          } else {
            vnx[j] = vnx[p];
            moved = 1;
          }
        }
        got = __ballot_sync(kFull, newly);
      }
      if (lane == 0) nxt[w] = cw | got;
    }
    ++nround;
    pending = __syncthreads_or(moved);
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  ZL4_STOP_AFTER(3, if (tid == 0) ok[b] = sout[0] + cur[0])

  // --- 4. the block, zero from out_len on; all zero when not ok
  const int live = s_ok ? min(total, blk) : 0;
  uint8_t* O = out + (size_t)b * blk;
  if ((blk & 3) == 0) {
    uint32_t* O4 = reinterpret_cast<uint32_t*>(O);
    const uint32_t* S4 = reinterpret_cast<const uint32_t*>(sout);
    for (int w = tid; w < blk >> 2; w += T) {
      const int lim = live - 4 * w;  // live bytes of this word
      uint32_t v = lim > 0 ? S4[w] : 0u;
      if (lim > 0 && lim < 4) v &= (1u << (8 * lim)) - 1u;
      O4[w] = v;
    }
  } else {
    for (int j = tid; j < blk; j += T) O[j] = j < live ? sout[j] : 0;
  }
  if (tid == 0) {
    out_len[b] = total;
    ok[b] = s_ok;
    if (rounds) rounds[b] = nround;
  }
}

}  // namespace

extern "C" int zl4_seq_decode(const void* comp, const void* hist,
                              const void* lit_len, const void* lit_src,
                              const void* mlen, const void* off,
                              const void* nseq, void* seg_start, void* out,
                              void* out_len, void* ok, void* rounds, int B,
                              int ccap, int hcap, int hstride, int nseq_cap,
                              int blk, void* stream) {
  // hist: uint8[hcap] shared by every block (hstride 0) or uint8[B, hcap]
  // (hstride hcap); never read when hcap is 0.  seg_start: int32[B,
  // nseq_cap] scratch.  rounds: int32[B], or null.
  if (B <= 0 || blk <= 0 || blk > kMaxBlk || ccap <= 0 || hcap < 0 ||
      hcap > kMaxBlk || nseq_cap <= 0 || (hstride != 0 && hstride != hcap))
    return (int)cudaErrorInvalidValue;
  static unsigned raised = 0;  // devices whose limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(seq_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)seq_smem(kMaxBlk));
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) raised |= 1u << dev;
  }
  seq_decode_kernel<<<B, kSeqThreads, seq_smem(blk), (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const uint8_t*)hist, (const int32_t*)lit_len,
      (const int32_t*)lit_src, (const int32_t*)mlen, (const int32_t*)off,
      (const int32_t*)nseq, (int32_t*)seg_start, (uint8_t*)out,
      (int32_t*)out_len, (int32_t*)ok, (int32_t*)rounds, ccap, hcap, hstride,
      nseq_cap, blk);
  return (int)cudaGetLastError();
}
