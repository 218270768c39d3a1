// T-map block rebuild: one gather per output byte.
//
// Replaces: _decode_block_tmap of the JAX reference
// (ops/jax_decode.py:1043-1075), batched by _batched_tmap_decoder
// (:1078-1081).  The TPU version merges
// the fetch buffer against T with two sorts and a packed cummax because
// gathers are slow there; it computes
//     out[b, j] = fetch[b, clip(T[b, j], 0, F - 1)]   for j < out_len[b]
//     out[b, j] = 0                                   otherwise.
// Rows of T at or past out_len are uninitialized (the host resolver
// leaves them so) and are never read here.
//
// Bound on the H100: device memory.  Each output byte reads 4 bytes of T
// and one byte of fetch and writes one byte; the fetch row of a block
// (<= compress_bound(blk)) stays in L1/L2, so the stream is ~5 bytes per
// output byte.  Design: each thread takes 4 consecutive outputs, with one
// 16-byte load of T and one 4-byte store when every row of T starts on
// 16 bytes (blk % 4 == 0 and an aligned base); grid = (output tiles,
// blocks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t fetch_at(const uint8_t* f, int t, int F) {
  return f[min(max(t, 0), F - 1)];
}

__global__ void __launch_bounds__(kThreads)
tmap_gather_kernel(const uint8_t* __restrict__ fetch,
                   const int32_t* __restrict__ T,
                   const int32_t* __restrict__ out_len,
                   uint8_t* __restrict__ out, int F, int blk) {
  const int b = blockIdx.y;
  const long long j0 = 4ll * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (j0 >= blk) return;
  const int L = out_len[b];
  const int32_t* t = T + (size_t)b * blk;
  const uint8_t* f = fetch + (size_t)b * F;
  uint8_t* o = out + (size_t)b * blk;
  if ((blk & 3) == 0 && (reinterpret_cast<uintptr_t>(T) & 15) == 0) {
    uint8_t v[4] = {0, 0, 0, 0};
    if (j0 < L) {
      const int4 t4 = *reinterpret_cast<const int4*>(t + j0);
      v[0] = fetch_at(f, t4.x, F);
      if (j0 + 1 < L) v[1] = fetch_at(f, t4.y, F);
      if (j0 + 2 < L) v[2] = fetch_at(f, t4.z, F);
      if (j0 + 3 < L) v[3] = fetch_at(f, t4.w, F);
    }
    *reinterpret_cast<uchar4*>(o + j0) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < 4 && j0 + k < blk; ++k) {
      const long long j = j0 + k;
      o[j] = j < L ? fetch_at(f, t[j], F) : 0;
    }
  }
}

}  // namespace

extern "C" int zl4_tmap_gather(const void* fetch, const void* T,
                               const void* out_len, void* out, int B, int F,
                               int blk, void* stream) {
  if (B <= 0 || blk <= 0) return 0;
  const long long tiles = ((long long)blk + 4ll * kThreads - 1) / (4ll * kThreads);
  const dim3 grid((unsigned)tiles, (unsigned)B);
  tmap_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)fetch, (const int32_t*)T, (const int32_t*)out_len,
      (uint8_t*)out, F, blk);
  return (int)cudaGetLastError();
}
