// A bitonic network over rows in device memory, one thread block per row.
//
// Used by the match finders of windows over 64 KB (encode_wide.cu, and
// encode_deep_wide.cu through encode_deep.cuh), whose rows do not fit one
// block's shared memory: the position order of a 327,680-byte window is
// 2^19 u32 rows, 2 MB.  (The batched key+payload sort of sort_probe.cu runs
// the same network inside a thread-block cluster, sort_cluster.cuh.)
//
// The network is the one of bitonic_sort in encode_common.cuh and of the
// Pallas sort probe: stages k = 2, 4, ..., N and, in each, j = k/2, ..., 1; the pair
// (i, i + j) with bit j of i clear is ascending when bit k of i is clear (so
// the last merge, k = N, is all ascending), and its two rows are exchanged
// only when strictly out of order, so equal keys keep their rows and the
// network is not stable.
//
// Where the rows live: a stage whose stride j is below the shared-memory
// tile (tile_n rows) pairs rows inside one tile, so the block loads a tile,
// runs every such stage of the current k there, and writes it back; the
// first tile_n-wide sort of every tile runs there whole.  Only the stages
// with j >= tile_n are passes over the row in device memory.  At N = 2^19
// and 8,192-row tiles that leaves 21 of the 190 stages to device memory.
// A row never spans blocks, so a __syncthreads() between passes orders
// them; the row is read and written with plain loads and stores by one
// block only.
//
// Bound: per stage N/2 compare-exchanges; what a compare costs is the
// comparator's (a key load for the probe, a window read for the matcher).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One stage over the rows [0, n) of ``a`` (a tile or a whole row), whose
// first row has index ``base`` in the network.
template <class T, class Less>
__device__ __forceinline__ void bitonic_stage(T* a, int n, int base, int k,
                                              int j, Less& less) {
  for (int q = threadIdx.x; q < (n >> 1); q += blockDim.x) {
    const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
    const int l = i + j;
    const T x = a[i], y = a[l];
    if (((base + i) & k) == 0 ? less(y, x) : less(x, y)) {
      a[i] = y;
      a[l] = x;
    }
  }
}

// Every tile of the row through shared memory: with k == 0 the network up
// to k = tn inside each tile, else the stages (k, j0), (k, j0 / 2), ...,
// (k, 1).
template <class T, class Less>
__device__ void bitonic_tiles(T* row, int N, T* tile, int tn, int k, int j0,
                              Less& less) {
  for (int t0 = 0; t0 < N; t0 += tn) {
    for (int i = threadIdx.x; i < tn; i += blockDim.x) tile[i] = row[t0 + i];
    __syncthreads();
    if (k == 0) {
      for (int kk = 2; kk <= tn; kk <<= 1) {
        for (int j = kk >> 1; j > 0; j >>= 1) {
          bitonic_stage(tile, tn, t0, kk, j, less);
          __syncthreads();
        }
      }
    } else {
      for (int j = j0; j > 0; j >>= 1) {
        bitonic_stage(tile, tn, t0, k, j, less);
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < tn; i += blockDim.x) row[t0 + i] = tile[i];
    __syncthreads();
  }
}

// Sorts row[0, N) (N a power of two) by ``less`` through the network above.
// ``tile`` is shared memory for tile_n rows (a power of two).
template <class T, class Less>
__device__ void bitonic_sort_global(T* row, int N, T* tile, int tile_n,
                                    Less less) {
  const int tn = min(tile_n, N);
  bitonic_tiles(row, N, tile, tn, 0, 0, less);  // k = 2 .. tn in each tile
  for (int k = tn << 1; k <= N; k <<= 1) {
    int j = k >> 1;
    for (; j >= tn; j >>= 1) {  // strides past a tile: device memory
      bitonic_stage(row, N, 0, k, j, less);
      __syncthreads();
    }
    bitonic_tiles(row, N, tile, tn, k, j, less);
  }
}

}  // namespace
