// Stable least-significant-digit radix passes over a u32 position order
// spread over the shared memory of one thread-block cluster, one byte digit
// a pass: the sorts of the match finders of windows over 64 KB
// (encode_wide.cu, encode_deep_wide.cu).
//
// sort_radix.cuh sorts up to 65,536 u16 rows held by one block.  A window
// of up to 2^19 - 1 bytes has that many u32 rows (1.3 MB at 327,680), more
// than one SM holds, so the order is cut into C slices of R = 1024 Jr rows
// (C a power of two up to 16, Jr rows a thread): CTA r of the cluster holds
// rows [r R, r R + R) of the current order in its shared memory.  A pass:
//   1. each warp of each CTA takes a contiguous run of its slice, Jr tiles
//      of 32 rows, loads them into registers, reads each row's digit (one
//      window byte, or one byte of a rank, from device memory) and counts
//      the digits into the warp's histogram;
//   2. per digit, an exclusive prefix over the CTA's warps, and the CTA's
//      total published in its shared memory; cluster.sync(); every CTA
//      reads every CTA's totals over distributed shared memory and so has
//      each digit's first destination for its own rows: the rows of smaller
//      digits, then those of this digit in earlier CTAs.  That is one
//      exclusive scan over (digit, CTA, warp), digit-major, with CTAs in
//      slice order.  A digit that holds every row ends the pass here (the
//      order stays as it is);
//   3. each warp scatters its rows from registers, tile by tile in order,
//      with ranks among same-digit lanes from __match_any_sync, to their
//      destination row in whichever CTA's slice holds it, through
//      distributed shared memory; cluster.sync().
// Rows of a warp keep their order within a digit, warps and then CTAs are
// in order, so the pass is stable.  The order is overwritten in place: the
// cluster.sync() of step 2 comes after every row of every CTA is in a
// register, so no store lands before its row was read.  Only the rows
// [0, rows) take part (rows = the window's blk); there is no padding.
// On the H100 the digit loads and counts, the ranking and the remote
// stores each take a comparable share of a pass; placing each CTA's rows
// in its own digit order first, so that the remote stores run in
// coalesced runs, took longer, and so did keys held in distributed shared
// memory in place of the device-memory digit loads (PERF.md, section 6).
//
// Between sorts the order stays in the slices: WideOrder's operator[]
// reads row t from the local slice or, near a slice's edge, from its
// owner's over distributed shared memory, for the probes and the rank
// numbering.  A CTA's slice is rewritten only after a cluster.sync() that
// ends every such read (identity()), and no CTA leaves before the last one.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWideThreads = 1024;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideStride = 257;  // histogram words a warp (spreads banks)
constexpr int kWideHistWords = kWideWarps * kWideStride;
constexpr int kWidePart = kWideThreads + 64;  // scan scratch, ints
constexpr int kWideFlag = kWideThreads + 48;  // part[]: "one digit holds all"
constexpr int kWideBase = kWideThreads + 49;  // part[]: the CTA's rank base
constexpr int kWideMaxCluster = 16;
constexpr int kWideMaxJ = 32;  // rows a thread: 2^19 rows over 16 CTAs

// Dynamic shared memory of a CTA holding 1024 Jr rows: the slice, the
// histograms, the CTA's digit totals, each digit's first destination, and
// the scan scratch.
__host__ __device__ __forceinline__ size_t wide_smem(int Jr) {
  return 4 * ((size_t)kWideThreads * Jr + kWideHistWords + 2 * 256 +
              kWidePart);
}

// A cluster shape that covers rows: C * 1024 * Jr >= rows.
__host__ __device__ __forceinline__ bool wide_shape_ok(int rows, int C,
                                                       int Jr) {
  return C >= 1 && C <= kWideMaxCluster && (C & (C - 1)) == 0 && Jr >= 1 &&
         Jr <= kWideMaxJ && (long long)C * kWideThreads * Jr >= rows;
}

struct WideOrder {
  uint32_t* s;      // this CTA's slice: rows [lo, lo + nloc) of the order
  uint32_t* hist;   // kWideWarps histograms of kWideStride words
  int* cnt;         // 256 digit totals of this CTA, read by the cluster
  int* dbase;       // 256 first destinations of this CTA's rows by digit
  int* part;        // kWidePart ints of scan scratch
  int rows;         // rows of the order
  int R, Jr;        // rows a slice holds (1024 Jr), rows a thread
  int C, r;         // CTAs of the cluster, this CTA's rank
  int lo, nloc;     // first row of the slice, rows in it
  unsigned mJ;      // ceil(2^16 / Jr): the CTA of row g, see cta_of

  // (g / 1024) / Jr exactly for g < 2^19: (g >> 10) < 512, so the
  // rounding of mJ adds under 1/128 to a quotient whose fraction is at
  // most 1 - 1/Jr <= 1 - 1/32
  __device__ __forceinline__ int cta_of(int g) const {
    return (int)(((unsigned)(g >> 10) * mJ) >> 16);
  }
  // row t of the order, t in [0, rows)
  __device__ __forceinline__ uint32_t operator[](int t) const {
    const unsigned i = (unsigned)(t - lo);
    if (i < (unsigned)nloc) return s[i];
    const int c = cta_of(t);
    return cg::this_cluster().map_shared_rank(s, c)[t - c * R];
  }
};

__device__ __forceinline__ WideOrder wide_order(uint32_t* smem, int rows,
                                                int Jr) {
  cg::cluster_group cluster = cg::this_cluster();
  WideOrder o;
  o.R = kWideThreads * Jr;
  o.Jr = Jr;
  o.s = smem;
  o.hist = smem + o.R;
  o.cnt = reinterpret_cast<int*>(o.hist + kWideHistWords);
  o.dbase = o.cnt + 256;
  o.part = o.dbase + 256;
  o.rows = rows;
  o.C = (int)cluster.num_blocks();
  o.r = (int)cluster.block_rank();
  o.lo = min(o.r * o.R, rows);
  o.nloc = min(o.R, rows - o.lo);
  o.mJ = (65536u + (unsigned)Jr - 1u) / (unsigned)Jr;
  return o;
}

// The identity order, once no CTA reads the slices any more.
__device__ __forceinline__ void wide_identity(const WideOrder& o) {
  cg::this_cluster().sync();
  for (int i = threadIdx.x; i < o.nloc; i += kWideThreads) o.s[i] = o.lo + i;
  __syncthreads();
}

// The window as zero-padded LE words in device scratch, each CTA building
// its share; after the cluster.sync() every CTA reads all of it.
__device__ __forceinline__ void wide_words(const uint8_t* row, int n,
                                           uint32_t* wd, int nwords,
                                           const WideOrder& o) {
  const int per = (nwords + o.C - 1) / o.C;
  const int q1 = min(o.r * per + per, nwords);
  for (int q = o.r * per + threadIdx.x; q < q1; q += kWideThreads) {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * q + k;
      if (p < n) v |= (uint32_t)row[p] << (8 * k);
    }
    wd[q] = v;
  }
  cg::this_cluster().sync();
}

// One stable pass over the order by digit(row) (0..255).  Every thread of
// every CTA of the cluster calls it; J >= Jr is the registers' bound.
template <int J, class Digit>
__device__ void wide_pass(const WideOrder& o, Digit digit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int Jr = o.Jr, base = warp * Jr * 32;
  uint32_t* h = o.hist + warp * kWideStride;
  for (int d = lane; d < 256; d += 32) h[d] = 0;
  if (tid == 0) o.part[kWideFlag] = 0;
  __syncwarp();

  // 1. rows into registers, their digits (loads all in flight), counts
  uint32_t reg[J], dg[(J + 3) / 4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = base + j * 32 + lane;
    reg[j] = j < Jr && i < o.nloc ? o.s[i] : 0u;
  }
#pragma unroll
  for (int j = 0; j < (J + 3) / 4; ++j) dg[j] = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = base + j * 32 + lane;
    if (j < Jr && i < o.nloc)
      dg[j >> 2] |= digit((int)reg[j]) << (8 * (j & 3));
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = base + j * 32 + lane;
    if (j < Jr && i < o.nloc)
      atomicAdd(&h[(dg[j >> 2] >> (8 * (j & 3))) & 0xFFu], 1u);
  }
  __syncthreads();

  // 2. per digit: exclusive prefix over this CTA's warps, the CTA's total
  const int d = tid;  // threads past 255 carry zeros
  if (d < 256) {
    uint32_t run = 0;
    for (int w = 0; w < kWideWarps; ++w) {
      const uint32_t c = o.hist[w * kWideStride + d];
      o.hist[w * kWideStride + d] = run;
      run += c;
    }
    o.cnt[d] = (int)run;
  }
  cluster.sync();  // every total published, every row in a register
  int tot = 0, pre = 0;
  if (d < 256) {
    int v[kWideMaxCluster];  // the C remote loads all in flight
#pragma unroll
    for (int c = 0; c < kWideMaxCluster; ++c)
      v[c] = c < o.C ? cluster.map_shared_rank(o.cnt, c)[d] : 0;
#pragma unroll
    for (int c = 0; c < kWideMaxCluster; ++c) {
      tot += v[c];
      pre += c < o.r ? v[c] : 0;
    }
  }
  int x = tot;  // inclusive scan of the digit totals over each warp
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, k);
    if (lane >= k) x += y;
  }
  if (lane == 31 && warp < 8) o.part[kWideThreads + warp] = x;
  __syncthreads();
  if (d < 256) {
    int wpre = 0;
    for (int w = 0; w < warp; ++w) wpre += o.part[kWideThreads + w];
    o.dbase[d] = wpre + x - tot + pre;
    if (tot == o.rows) o.part[kWideFlag] = 1;
  }
  __syncthreads();

  // 3. stable scatter from registers, unless one digit holds every row
  if (!o.part[kWideFlag]) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j < Jr) {
        const int i = base + j * 32 + lane;
        const bool ok = i < o.nloc;
        const unsigned dj = (dg[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, dj) &
                               __ballot_sync(0xFFFFFFFFu, ok);
        const int leader = ok ? __ffs(peers) - 1 : lane;
        uint32_t at = 0;
        if (ok && lane == leader) {
          at = h[dj];
          h[dj] = at + __popc(peers);
        }
        at = __shfl_sync(0xFFFFFFFFu, at, leader);
        if (ok) {
          const int g = o.dbase[dj] + (int)at + __popc(peers & lt);
          const int c = o.cta_of(g);
          cluster.map_shared_rank(o.s, c)[g - c * o.R] = reg[j];
        }
        __syncwarp();
      }
    }
  }
  cluster.sync();  // every row in place; the totals and the flag are free
}

// Byte k of each row's window key: window byte p + k, zero at and past n,
// read from the input row; on the passes over s0's bytes (s0 = true) 0xFF
// on the rows past n - 4, whose s0 is 0xFFFFFFFF (Window::s0).
struct WideKeyByte {
  const uint8_t* row;
  int n, k;
  bool s0;
  __device__ __forceinline__ unsigned operator()(int p) const {
    if (s0 && p > n - 4) return 0xFFu;
    const int q = p + k;
    return q < n ? (unsigned)__ldg(row + q) : 0u;
  }
};

// The lexicographic order of the nw words (s0, at(p+4), ..., at(p+4(nw-1)))
// of each row, ties by position: 4 nw passes, the last word first, each
// word from its low byte up (the 12-byte order: nw = 3; (s0, p): 1; the
// 32-byte order: 8).
template <int J>
__device__ void wide_sort_window(const WideOrder& o, const uint8_t* row,
                                 int n, int nw) {
  wide_identity(o);
#pragma unroll 1
  for (int i = 0; i < 4 * nw; ++i) {
    const int wk = nw - 1 - i / 4;
    wide_pass<J>(o, WideKeyByte{row, n, 4 * wk + (i & 3), wk == 0});
  }
}

// Byte b of x[p + off] + 1 with x = -1 past the rows (shl_at): ranks are
// below 2^19 + 1, so three bytes order them and -1 comes first.
struct RankByte {
  const int32_t* x;
  int off, rows, b;
  __device__ __forceinline__ unsigned operator()(int p) const {
    const int q = p + off;
    const unsigned v = q < rows ? (unsigned)(x[q] + 1) : 0u;
    return (v >> (8 * b)) & 0xFFu;
  }
};

// The order of the nk keys x[p + step k], k < nk, ties by position
// (LessRanks): 3 nk passes, the last key first.
template <int J>
__device__ void wide_sort_ranks(const WideOrder& o, const int32_t* x,
                                int step, int nk) {
  wide_identity(o);
#pragma unroll 1
  for (int i = 0; i < 3 * nk; ++i)
    wide_pass<J>(o, RankByte{x, step * (nk - 1 - i / 3), o.rows, i % 3});
}

// The launch of B windows in clusters of C CTAs holding 1024 Jr rows each
// (cluster_launch), the kernel's shared-memory limit raised for J.
template <class... Args>
cudaError_t wide_launch(void (*kernel)(Args...), unsigned* raised, int J,
                        int B, int C, int Jr, void* stream,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  return cluster_launch(kernel, raised, wide_smem(J), B, C, kWideThreads,
                        wide_smem(Jr), stream, cfg, attr);
}

}  // namespace

#ifdef ZL4_STOP
// Built with -DZL4_STOP=k, a wide finder stops after its k-th phase and
// stores what that phase left, so that chip_smoke.py can time the phases
// one by one; the library is built without it.
#define ZL4_WIDE_STOP(k, keep)   \
  if (ZL4_STOP == (k)) {         \
    keep;                        \
    cg::this_cluster().sync();   \
    return;                      \
  }
#else
#define ZL4_WIDE_STOP(k, keep)
#endif
