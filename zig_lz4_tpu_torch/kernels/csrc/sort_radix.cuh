// Stable least-significant-digit radix sort of a u16 position order held in
// shared memory by one 1024-thread block, one byte digit a pass.
//
// A lexicographic order over window bytes with the position as the last key
// is exactly what a chain of stable byte passes, least significant digit
// first, makes of the identity order; so the encoders' comparison orders
// (enc_match: the 12-byte order in 12 passes, (s0, p) in 4; enc_deep_match:
// the 32-byte order in 32, its rank orders in 2 a rank key, encode_deep.cu)
// come out of these passes with every tie broken by the position, as a
// comparison network's comparator broke it.  Each pass reads ONE byte per
// row, where a network stage recomputed 4-32-byte keys at two random rows
// per compare.
//
// A pass over `rows` rows (<= 65,536):
//   1. each warp takes a contiguous slice of the current order, J tiles of
//      32 rows; its lanes load their rows into registers (64 a thread at
//      65,536 rows, two u16 to a register) and count the digits into the
//      warp's own histogram with shared-memory atomics (counting needs no
//      order);
//   2. one block scan over (digit, warp), digit-major, turns the counts
//      into each warp's first destination row for each digit; a digit that
//      holds every row leaves the order as it is and the pass ends here;
//   3. each warp scatters its rows from registers, tile by tile in order:
//      a lane's rank among the lanes of its tile with the same digit comes
//      from __match_any_sync (faster on the H100 than eight ballots, one a
//      digit bit, which spend ~25 instructions), the lowest such lane bumps
//      the warp's running offset for the digit and shuffles the old value
//      to its peers.  Rows of a warp keep their order within a digit, and
//      warps are in order, so the pass is stable.
// The one shared order buffer is overwritten in place: every row is in a
// register before the first store.  Shared memory beside the order: the
// histograms, 32 x 257 u32 (the odd stride spreads both the atomics of
// step 1 and the scan's strided reads over the banks), and 33 ints.

#pragma once

#include "encode_common.cuh"

namespace {

constexpr int kRadixThreads = 1024;
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kRadixMaxRows = 65536;
constexpr int kRadixTiles = kRadixMaxRows / kRadixThreads;  // a warp, at most
constexpr int kRadixScanThreads = kRadixThreads / 256;  // threads a digit
constexpr int kRadixStride = 257;      // histogram words a warp
constexpr int kRadixHistWords = kRadixWarps * kRadixStride;

// One stable pass: the rows s[0, rows) reordered by digit(row) (0..255),
// ties in their current order.  hist: kRadixHistWords words of shared
// memory; part: 33 ints of shared memory.  All kRadixThreads threads call
// it.
template <class Digit>
__device__ void radix_pass(uint16_t* s, int rows, uint32_t* hist, int* part,
                           Digit digit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int J = (rows + kRadixThreads - 1) / kRadixThreads;  // tiles a warp
  const int base = warp * J * 32;
  uint32_t* h = hist + warp * kRadixStride;
  for (int d = lane; d < 256; d += 32) h[d] = 0;
  if (threadIdx.x == 0) part[32] = 0;  // "one digit holds every row"
  __syncwarp();

  // 1. rows into registers, digit counts
  uint32_t reg[kRadixTiles / 2];
#pragma unroll
  for (int j = 0; j < kRadixTiles; ++j) {
    if (j < J) {
      const int i = base + j * 32 + lane;
      const uint32_t p = i < rows ? s[i] : 0u;
      if (j & 1) reg[j >> 1] |= p << 16;
      else reg[j >> 1] = p;
      if (i < rows) atomicAdd(&h[digit((int)p)], 1u);
    }
  }
  __syncthreads();

  // 2. exclusive offsets over (digit, warp), digit-major: each digit's
  // warps are split over kRadixScanThreads consecutive threads
  {
    constexpr int kW = kRadixWarps / kRadixScanThreads;  // warps a thread
    const int d = threadIdx.x / kRadixScanThreads;
    const int w0 = (threadIdx.x % kRadixScanThreads) * kW;
    uint32_t c[kW], sum = 0;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      c[k] = hist[(w0 + k) * kRadixStride + d];
      sum += c[k];
    }
    uint32_t tot = sum;
#pragma unroll
    for (int o = 1; o < kRadixScanThreads; o <<= 1)
      tot += __shfl_xor_sync(0xFFFFFFFFu, tot, o);
    if (tot == (uint32_t)rows) part[32] = 1;
    uint32_t v = sum;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t x = __shfl_up_sync(0xFFFFFFFFu, v, o);
      if (lane >= o) v += x;
    }
    if (lane == 31) part[warp] = (int)v;
    __syncthreads();
    if (warp == 0) {
      const uint32_t x = lane < kRadixWarps ? (uint32_t)part[lane] : 0u;
      uint32_t y = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t z = __shfl_up_sync(0xFFFFFFFFu, y, o);
        if (lane >= o) y += z;
      }
      if (lane < kRadixWarps) part[lane] = (int)(y - x);
    }
    __syncthreads();
    uint32_t run = (uint32_t)part[warp] + v - sum;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      hist[(w0 + k) * kRadixStride + d] = run;
      run += c[k];
    }
  }
  __syncthreads();
  // every row has the same digit: the order stays as it is.  All threads
  // read the flag before the next pass can clear it.
  const bool same = part[32] != 0;
  __syncthreads();
  if (same) return;

  // 3. stable scatter from registers
#pragma unroll
  for (int j = 0; j < kRadixTiles; ++j) {
    if (j < J) {
      const int i = base + j * 32 + lane;
      const bool ok = i < rows;
      const uint32_t p = (reg[j >> 1] >> ((j & 1) * 16)) & 0xFFFFu;
      const unsigned d = ok ? digit((int)p) : 0u;
      const unsigned peers =
          __match_any_sync(0xFFFFFFFFu, d) & __ballot_sync(0xFFFFFFFFu, ok);
      const int leader = ok ? __ffs(peers) - 1 : lane;
      uint32_t at = 0;
      if (ok && lane == leader) {
        at = h[d];
        h[d] = at + __popc(peers);
      }
      at = __shfl_sync(0xFFFFFFFFu, at, leader);
      if (ok) s[at + __popc(peers & lt)] = (uint16_t)p;
      __syncwarp();
    }
  }
  __syncthreads();
}

// Byte k of each row's key for one radix pass: window byte p + k, or, on
// the s0 passes (s0 = true), 0xFF on the rows past n - 4, whose s0 is
// 0xFFFFFFFF (Window::s0).  Bytes at and past n read as zero.
struct KeyByte {
  const uint32_t* w;
  int n, k;
  bool s0;
  __device__ __forceinline__ unsigned operator()(int p) const {
    if (s0 && p > n - 4) return 0xFFu;
    const int q = p + k;
    return (w[q >> 2] >> ((q & 3) * 8)) & 0xFFu;
  }
};

// The lexicographic order of the nw words (s0, at(p+4), ..., at(p+4(nw-1)))
// of each row, ties by position, from the identity order: 4 nw passes over
// window bytes, the last word first, each word from its low byte up
// (Less12 of the reference's HC finder: nw = 3; the order (s0, p): 1; the
// deep finder's 32-byte order: 8).
__device__ void sort_words(const Window& W, uint16_t* s, int rows,
                           uint32_t* hist, int* part, int nw) {
#pragma unroll 1
  for (int i = 0; i < 4 * nw; ++i) {
    const int wk = nw - 1 - i / 4;
    radix_pass(s, rows, hist, part, KeyByte{W.w, W.n, 4 * wk + (i & 3),
                                            wk == 0});
  }
}

}  // namespace
