// Shared by the three fragment-ladder decoders (frag_decode.cu): the
// one-hop source of an output byte from the resolver's fragment table
// (the reference's merge A, ops/jax_decode.py:371-416), found by
// bisection or, for the cluster kernels on a table in increasing fdst, by
// a scan of the fragment starts over a CTA's positions; bit masks of one
// bit per output byte, a block-wide prefix count over such a mask, and the
// round loop of the byte-granular decoder.
//
// One thread block of kThreads threads rebuilds one LZ4 block, or, for
// the windowed decoder and the chase of blocks up to 256 KB, one
// thread-block cluster of up to 8 whose CTAs hold the state in shared
// memory (frag_decode.cu).  Device scratch that the wrapper allocates
// holds the state of the byte-granular decoder, and of the windowed
// decoder and the chase above 256 KB: 256-512 KB a 64 KB block, which the
// 50 MB L2 holds for one block but not for the 100-odd blocks of a tier
// batch at once.  State that other threads of the block rewrite between
// barriers is read there with __ldcg (from the L2), never through a stale
// L1 line.  A table's columns at or past nfrag are never read: the search
// for a byte's fragment runs over the first nfrag.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zl4frag {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One block's view of the batch.
struct Block {
  const uint8_t* comp;   // fetch buffer [fetch]
  const int32_t* fdst;   // tables [ncol], live below nfrag
  const int32_t* fsrc;
  const int32_t* fper;
  const int32_t* fphase;
  int nfrag, out_len, fetch, blk, nwords;
};

// Block b's view of the batch.
__device__ __forceinline__ Block
block_view(const uint8_t* comp, const int32_t* fdst, const int32_t* fsrc,
           const int32_t* fper, const int32_t* fphase, const int32_t* nfrag,
           const int32_t* out_len, int fetch, int ncol, int blk, size_t b) {
  Block v;
  v.comp = comp + b * fetch;
  v.fdst = fdst + b * ncol;
  v.fsrc = fsrc + b * ncol;
  v.fper = fper + b * ncol;
  v.fphase = fphase + b * ncol;
  v.nfrag = clampi(nfrag[b], 0, ncol);
  v.out_len = clampi(out_len[b], 0, blk);
  v.fetch = fetch;
  v.blk = blk;
  v.nwords = (blk + 31) >> 5;
  return v;
}

// The view of the grid's block blockIdx.x.
__device__ __forceinline__ Block
block_view(const uint8_t* comp, const int32_t* fdst, const int32_t* fsrc,
           const int32_t* fper, const int32_t* fphase, const int32_t* nfrag,
           const int32_t* out_len, int fetch, int ncol, int blk) {
  return block_view(comp, fdst, fsrc, fper, fphase, nfrag, out_len, fetch,
                    ncol, blk, blockIdx.x);
}

// The fragment that covers byte j: the last one with fdst <= j among
// the first nfrag (the tables come in increasing fdst), by bisection;
// -1 when there is none.  On an unsorted table this is the bisection's
// answer, as torch.searchsorted's.
__device__ __forceinline__ int fragment_of(const Block& v, int j) {
  int lo = 0, hi = v.nfrag;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(v.fdst + mid) <= j) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// Source of byte j in fragment q (q < 0: none, the fetch byte 0).  A LIT
// byte's source is a fetch coordinate, a PER byte's an output
// coordinate; both are clamped, so a malformed table reads nothing out
// of bounds.
__device__ __forceinline__ int source_in(const Block& v, int j, int q,
                                         bool* per) {
  *per = false;
  if (q < 0) return 0;
  const int rel = j - __ldg(v.fdst + q);
  const int s = __ldg(v.fsrc + q), p = __ldg(v.fper + q);
  if (p > 0) {
    *per = true;
    const long long x = (long long)__ldg(v.fphase + q) + rel;
    long long ph;
    if (x >= 0 && x <= 0x7fffffffll) {  // a sound table's case, 32 bits
      ph = (unsigned)x % (unsigned)p;
    } else {
      ph = x % p;
      if (ph < 0) ph += p;
    }
    const long long t = (long long)s + ph;
    return (int)min(max(t, 0ll), (long long)v.blk - 1);
  }
  const long long t = (long long)s + rel;
  return (int)min(max(t, 0ll), (long long)v.fetch - 1);
}

// Source of byte j, its fragment found by bisection.
__device__ __forceinline__ int source_of(const Block& v, int j, bool* per) {
  return source_in(v, j, fragment_of(v, j), per);
}

// prefix[w] = number of set bits in words[0..w); returns the total.
// Every thread of the block calls it, after a barrier behind the last
// write of `words` (in shared memory when kShared, else in device
// memory, read from the L2); it ends on a barrier.
template <bool kShared = false>
__device__ int prefix_popc(const uint32_t* words, int32_t* prefix,
                           int nwords) {
  auto word = [&](int i) {
    if constexpr (kShared) return words[i];
    else return __ldcg(words + i);
  };
  __shared__ int warp_sum[32];
  __shared__ int total_s;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int per_thread = (nwords + kThreads - 1) / kThreads;
  const int lo = min(tid * per_thread, nwords);
  const int hi = min(lo + per_thread, nwords);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += __popc(word(i));
  int x = sum;
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
  int run = warp_sum[wid] + x - sum;
  for (int i = lo; i < hi; ++i) {
    prefix[i] = run;
    run += __popc(word(i));
  }
  const int total = total_s;
  __syncthreads();
  return total;
}

// The fragments of a CTA's positions [j0, j0 + nloc) of block v, for the
// cluster kernels.  On a table in increasing fdst a byte's fragment is the
// largest index among the fragments that start at or before it: each
// fragment that starts in the CTA's positions writes its index there
// (atomicMax, for fragments of no bytes), a warp max-scan over each
// warp's span of positions spreads them, and the fragments before the
// CTA's first position give the carry; the fragments before the CTA's
// positions (q_lo) and before its end (q_hi) are counted in the pass that
// checks the order.  Position i's fragment is then max(idx[i],
// span_pre[i >> span_log]) (scanned_fragment).  On any other table
// `unsorted` is set, idx is not written, and each byte bisects
// (fragment_of), as torch.searchsorted does.  Every thread of the CTA
// calls it; it ends on a barrier.
struct FragScan {
  int unsorted, span_log;
  const int* span_pre;
};

__device__ __forceinline__ FragScan fragment_scan(const Block& v, int j0,
                                                  int nloc, int32_t* idx) {
  __shared__ int span_pre[32], q_lo, q_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) q_lo = q_hi = 0;
  __syncthreads();
  int unsorted = 0, n_lo = 0, n_hi = 0;
  for (int q = tid; q < v.nfrag; q += kThreads) {
    const int d = __ldg(v.fdst + q);
    if (q + 1 < v.nfrag) unsorted |= d > __ldg(v.fdst + q + 1);
    n_lo += d < j0;
    n_hi += d < j0 + nloc;
  }
  n_lo = __reduce_add_sync(kFull, n_lo);
  n_hi = __reduce_add_sync(kFull, n_hi);
  if (lane == 0) {
    atomicAdd(&q_lo, n_lo);
    atomicAdd(&q_hi, n_hi);
  }
  unsorted = __syncthreads_or(unsorted);
  // warp w's span of positions: a power of two >= nloc / 32, >= 32
  const int span_log = 32 - __clz(max((nloc + 31) >> 5, 32) - 1);
  if (!unsorted) {
    for (int i = tid; i < nloc; i += kThreads) idx[i] = -1;
    __syncthreads();
    for (int q = q_lo + tid; q < q_hi; q += kThreads)
      atomicMax(idx + (__ldg(v.fdst + q) - j0), q);
    __syncthreads();
    // warp w scans positions [w << span_log, (w + 1) << span_log)
    int run = q_lo - 1;
    const int w_hi = min((warp + 1) << span_log, nloc);
    for (int base = warp << span_log; base < w_hi; base += 32) {
      const int i = base + lane;
      int x = i < nloc ? idx[i] : -1;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = max(x, y);
      }
      x = max(x, run);
      if (i < nloc) idx[i] = x;
      run = __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) span_pre[warp] = run;
    __syncthreads();
    if (warp == 0) {  // the carry into each warp's span: a max-scan
      int x = span_pre[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = max(x, y);
      }
      const int before = __shfl_up_sync(kFull, x, 1);
      span_pre[lane] = lane ? before : q_lo - 1;
    }
    __syncthreads();
  }
  return FragScan{unsorted, span_log, span_pre};
}

// Position i's fragment after fragment_scan on a sorted table.
__device__ __forceinline__ int scanned_fragment(const FragScan& f,
                                                const int32_t* idx, int i) {
  return max(idx[i], f.span_pre[i >> f.span_log]);
}

// The rounds of the byte-granular decoder and of the windowed decoder's
// device-scratch kernel.  src[j] is the output
// coordinate a still unknown byte j copies from, or -1 when it can
// never resolve; cur holds the known bits at entry.  In each round a
// byte becomes known when its source was known at the START of the
// round: the round reads `cur` and writes `nxt`, and a byte that is
// written in a round is unknown in `cur`, so no thread reads it.
// Stops early when a round changes nothing (later ones would not
// either).  Returns the mask that holds the final state.
__device__ uint32_t* resolve_rounds(const int32_t* src, uint32_t* cur,
                                    uint32_t* nxt, uint8_t* out, int nwords,
                                    int rounds) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < rounds; ++r) {
    int progress = 0;
    for (int base = 0; base < nwords * 32; base += kThreads) {
      const int j = base + threadIdx.x, w = j >> 5;
      if (w >= nwords) continue;           // whole warps only
      uint32_t kw = __ldcg(cur + w);
      if (kw != kFull) {
        bool newly = false;
        if (!((kw >> lane) & 1)) {
          const int s = src[j];
          if (s >= 0 && ((__ldcg(cur + (s >> 5)) >> (s & 31)) & 1)) {
            out[j] = __ldcg(out + s);
            newly = true;
          }
        }
        const uint32_t got = __ballot_sync(kFull, newly);
        kw |= got;
        progress |= got != 0;
      }
      if (lane == 0) nxt[w] = kw;
    }
    const int any = __syncthreads_or(progress);
    uint32_t* t = cur; cur = nxt; nxt = t;
    if (!any) break;
  }
  return cur;
}

// ok[b] = every bit of the mask is set (dead bytes count as known).
__device__ void write_ok(const uint32_t* mask, int nwords, int32_t* ok) {
  int bad = 0;
  for (int w = threadIdx.x; w < nwords; w += kThreads)
    bad |= __ldcg(mask + w) != kFull;
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) ok[blockIdx.x] = !bad;
}

}  // namespace zl4frag
