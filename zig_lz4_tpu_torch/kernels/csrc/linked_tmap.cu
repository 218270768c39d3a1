// Linked-frame window step: the flat gather and the history shift in one
// launch.
//
// Replaces: _linked_tmap_step of the JAX reference (ops/jax_decode.py:1123-
// 1143), with the _decode_flat_fetch it calls (:1084-1114).  The TPU version
// concatenates [hist | payloads] into one fetch buffer, merges it against T
// with two sorts and a packed cummax, concatenates [hist | out] and slices
// the new history out of it.  Here, with fetch = [hist (H bytes) | payloads
// (PCQ bytes)]:
//
//   out[j]      = fetch[clip(T[j], 0, H + PCQ - 1)]   j < total
//   out[j]      = 0                                   otherwise
//   new_hist[i] = the byte of [hist | out] at s = clip(total, 0, NOUT) + i
//
// Coordinates below H read hist, the rest payloads, so no concatenated buffer
// is built.  Rows of T at or past total are uninitialized (the host resolver
// leaves them so) and are never read.
//
// linked_tmap_step: the blocks past the output's tiles write new_hist.  A
// history byte at s < H is hist[s]; one at s >= H is out's byte s - H, which
// the thread recomputes from T and fetch rather than reading it back, so no
// block waits on another.  hist is only read and new_hist is a second
// buffer, so the step has no ordering hazard; the caller swaps the two.
//
// Bound on the H100: device memory.  The gather reads 4 bytes of T and one
// fetch byte and writes one byte per live output byte (the fetch bytes of a
// window stay in L2), and one zero byte per dead one; the shift reads H
// bytes and writes H.  A 2 MB window moves ~11 MB, a few microseconds at
// 3.35 TB/s, so the launch (one, not two) sets the time.  Design: as
// tmap_gather, each thread takes 4 consecutive outputs with one 16-byte load
// of T and one 4-byte store when T and out are aligned for it.

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
linked_tmap_step_kernel(const uint8_t* __restrict__ hist,
                        const uint8_t* __restrict__ pay,
                        const int32_t* __restrict__ T,
                        uint8_t* __restrict__ out,
                        uint8_t* __restrict__ new_hist, int H, int FC,
                        int nout, int total, int out_tiles, int shift) {
  if ((int)blockIdx.x >= out_tiles) {  // the history shift
    const int i0 = 4 * (((int)blockIdx.x - out_tiles) * kThreads +
                        (int)threadIdx.x);
    for (int i = i0; i < i0 + 4 && i < H; ++i) {
      const long long s = (long long)shift + i;
      const long long j = s - H;  // < nout, since shift <= nout
      new_hist[i] = j < 0 ? hist[s]
                          : (j < total ? fetch_at(hist, pay, T[j], H, FC) : 0);
    }
    return;
  }
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

}  // namespace

extern "C" int zl4_linked_tmap_step(const void* hist, const void* pay,
                                    const void* T, void* out, void* new_hist,
                                    int H, int PCQ, int nout, int total,
                                    void* stream) {
  if (H <= 0 || PCQ < 0 || nout <= 0) return (int)cudaErrorInvalidValue;
  const int per = 4 * kThreads;
  const long long out_tiles = ((long long)nout + per - 1) / per;
  const long long hist_tiles = ((long long)H + per - 1) / per;
  const int shift = total < 0 ? 0 : (total > nout ? nout : total);
  linked_tmap_step_kernel<<<(unsigned)(out_tiles + hist_tiles), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)hist, (const uint8_t*)pay, (const int32_t*)T,
      (uint8_t*)out, (uint8_t*)new_hist, H, H + PCQ, nout, total,
      (int)out_tiles, shift);
  return (int)cudaGetLastError();
}
