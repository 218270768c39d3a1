// Batched key+payload bitonic sort of int32 rows.
//
// Replaces: pallas_sort2 of the JAX package's retired probe
// experiments/pallas_sort_probe.py (:80; pl.pallas_call :81, _kernel
// :54-76, _partner :39-51), a bitonic network over 65,536 int32 keys with an
// int32 payload held in VMEM: 136 compare-exchange stages, the last merge
// all ascending, and a row takes its partner's pair only when the partner's
// key is strictly smaller (or larger), so equal keys keep their pairs and
// the network is not stable.  The probe sorted one row per call; its note
// (:16-21) says the kernel needed to batch rows to be of use.
//
// bitonic_sort2 (one 1024-thread block per row): the row's (key, payload)
// pairs as int2 in device scratch, the same network by sort_global.cuh --
// 8,192-pair tiles (64 KB) of shared memory for the strides below a tile,
// passes over device memory for the 6 longer-stride stages of the 136 at
// N = 65,536 -- then keys and payloads written apart.  The same pairs come
// out as from the probe, ties included.
// Bound: per row 136 stages of N / 2 compare-exchanges of 8-byte pairs; the
// tiles keep them in shared memory, so the passes over device memory (the
// load and store of every tile once per k, and the long strides) set the
// time, not the 16 bytes a pair that the function must move.

#include "sort_global.cuh"

namespace {

constexpr int kSortThreads = 1024;
constexpr int kSortTile = 8192;  // int2 pairs of the shared-memory tile

struct KeyLess {
  __device__ __forceinline__ bool operator()(const int2& a,
                                             const int2& b) const {
    return a.x < b.x;
  }
};

__global__ void __launch_bounds__(kSortThreads)
bitonic_sort2_kernel(const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ vals, int2* pairs,
                     int32_t* __restrict__ kout, int32_t* __restrict__ vout,
                     int N) {
  extern __shared__ int2 tile2[];
  const size_t base = (size_t)blockIdx.x * N;
  int2* row = pairs + base;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    row[i] = make_int2(keys[base + i], vals[base + i]);
  __syncthreads();
  bitonic_sort_global(row, N, tile2, kSortTile, KeyLess{});
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int2 p = row[i];
    kout[base + i] = p.x;
    vout[base + i] = p.y;
  }
}

}  // namespace

extern "C" int zl4_bitonic_sort2(const void* keys, const void* vals,
                                 void* pairs, void* kout, void* vout, int B,
                                 int N, void* stream) {
  // pairs: int2[B, N] scratch; N a power of two
  if (B <= 0 || N < 2 || (N & (N - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (N < kSortTile ? N : kSortTile) * (int)sizeof(int2);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_sort2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bitonic_sort2_kernel<<<B, kSortThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int32_t*)vals, (int2*)pairs,
      (int32_t*)kout, (int32_t*)vout, N);
  return (int)cudaGetLastError();
}
