// Linked-frame window step: a flat gather and the history shift.
//
// Replaces: _linked_tmap_step over _decode_flat_fetch of the JAX reference
// (ops/jax_decode.py:1123-1143, :1084-1114).  The TPU version concatenates
// [hist | payloads] into one fetch buffer, merges it against T with two
// sorts and a packed cummax, concatenates [hist | out] and slices the new
// history out of it.  Here, with fetch = [hist (H bytes) | payloads (PCQ
// bytes)]:
//
// linked_gather:      out[j] = fetch[clip(T[j], 0, H + PCQ - 1)]  j < total
//                     out[j] = 0                                  otherwise
//   Coordinates below H read hist, the rest payloads, so no concatenated
//   buffer is built.  Rows of T at or past total are uninitialized (the
//   host resolver leaves them so) and are never read.
//
// linked_hist_shift:  new_hist = the H bytes of [hist | out] that start at
//                     clip(total, 0, NOUT)
//   It writes a second buffer, since the old history is an input of both
//   kernels; the caller swaps the two.  Launched after linked_gather on the
//   same stream, so it reads the finished window.
//
// Bound on the H100: device memory.  The gather reads 4 bytes of T and one
// fetch byte and writes one byte per live output byte (the fetch bytes of a
// window stay in L2), and one zero byte per dead one; the shift moves H
// bytes.  Design: as tmap_gather, each thread takes 4 consecutive outputs
// with one 16-byte load of T and one 4-byte store when T and out are
// aligned for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t fetch_at(const uint8_t* hist,
                                            const uint8_t* pay, int t, int H,
                                            int FC) {
  t = min(max(t, 0), FC - 1);
  return t < H ? hist[t] : pay[t - H];
}

__global__ void __launch_bounds__(kThreads)
linked_gather_kernel(const uint8_t* __restrict__ hist,
                     const uint8_t* __restrict__ pay,
                     const int32_t* __restrict__ T, uint8_t* __restrict__ out,
                     int H, int FC, int nout, int total) {
  const long long j0 = 4ll * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (j0 >= nout) return;
  const bool wide = j0 + 3 < nout &&
                    (reinterpret_cast<uintptr_t>(T) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  if (wide) {
    uint8_t v[4] = {0, 0, 0, 0};
    if (j0 < total) {
      const int4 t4 = *reinterpret_cast<const int4*>(T + j0);
      v[0] = fetch_at(hist, pay, t4.x, H, FC);
      if (j0 + 1 < total) v[1] = fetch_at(hist, pay, t4.y, H, FC);
      if (j0 + 2 < total) v[2] = fetch_at(hist, pay, t4.z, H, FC);
      if (j0 + 3 < total) v[3] = fetch_at(hist, pay, t4.w, H, FC);
    }
    *reinterpret_cast<uchar4*>(out + j0) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < 4 && j0 + k < nout; ++k) {
      const long long j = j0 + k;
      out[j] = j < total ? fetch_at(hist, pay, T[j], H, FC) : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
linked_hist_shift_kernel(const uint8_t* __restrict__ hist,
                         const uint8_t* __restrict__ out,
                         uint8_t* __restrict__ new_hist, int H, int shift) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= H) return;
  const long long src = (long long)shift + i;
  new_hist[i] = src < H ? hist[src] : out[src - H];
}

}  // namespace

extern "C" int zl4_linked_gather(const void* hist, const void* pay,
                                 const void* T, void* out, int H, int PCQ,
                                 int nout, int total, void* stream) {
  if (H < 0 || PCQ < 0 || H + PCQ < 1 || nout <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)nout + 4ll * kThreads - 1) / (4ll * kThreads);
  linked_gather_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)hist, (const uint8_t*)pay, (const int32_t*)T,
      (uint8_t*)out, H, H + PCQ, nout, total);
  return (int)cudaGetLastError();
}

extern "C" int zl4_linked_hist_shift(const void* hist, const void* out,
                                     void* new_hist, int H, int nout,
                                     int total, void* stream) {
  if (H <= 0 || nout < 0) return (int)cudaErrorInvalidValue;
  const int shift = total < 0 ? 0 : (total > nout ? nout : total);
  linked_hist_shift_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)hist, (const uint8_t*)out, (uint8_t*)new_hist, H, shift);
  return (int)cudaGetLastError();
}
