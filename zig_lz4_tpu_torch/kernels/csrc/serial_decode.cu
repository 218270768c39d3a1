// LZ4 block rebuild from parsed sequences, one warp per block, in order.
//
// Replaces: the Pallas decoder make_pallas_decoder of the JAX package's
// retired probe experiments/pallas_decode.py (:127; _kernel :53-123,
// pl.pallas_call :149, wrapper decode_blocks_pallas :179-206).  The TPU
// kernel holds one block in VMEM and walks its sequences serially: a
// literal run comp[lit_src : lit_src + lit_len] goes to out[op :], then a
// match copies min(rem, avail) bytes a round from out[op - off :] to the
// end of what is written, avail starting at off and growing by what each
// round wrote (:108-120), so a match that overlaps itself (off < mlen)
// takes log2(mlen / off) rounds and each round's source lies wholly before
// its destination.  Bytes from the last sequence's end on are zero.  It
// takes no history: a match reaches into the block only.
//
// serial_decode (one warp per block, four blocks per 128-thread CTA): the
// warp walks the sequence table in order, 32 entries loaded at a time and
// passed round by shuffles; the 32 lanes copy each literal run and each
// match round, a byte a lane, with a __syncwarp() before a round reads
// what the previous one wrote.  The output row is written in device memory
// directly, zero from the end of the last sequence on.
// For tables that parse_sequences produces (offsets inside the block, a
// total of at most blk bytes) the bytes are the probe's.  Outside them the
// probe's Mosaic slices are undefined; here a source before the block or
// past the payload reads 0, a destination at or past blk is dropped and a
// negative length counts as 0.
// Bound: the chain of sequences -- each is a few dependent rounds of
// device-memory latency for one warp -- not bytes: a block moves its
// payload, 16 bytes a sequence and blk bytes out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(32 * kWarps)
serial_decode_kernel(const uint8_t* __restrict__ comp,
                     const int32_t* __restrict__ lit_len,
                     const int32_t* __restrict__ lit_src,
                     const int32_t* __restrict__ mlen,
                     const int32_t* __restrict__ off,
                     const int32_t* __restrict__ nseq, uint8_t* out, int B,
                     int ccap, int ncap, int blk) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const uint8_t* C = comp + (size_t)b * ccap;
  const int32_t* LL = lit_len + (size_t)b * ncap;
  const int32_t* LS = lit_src + (size_t)b * ncap;
  const int32_t* ML = mlen + (size_t)b * ncap;
  const int32_t* OF = off + (size_t)b * ncap;
  uint8_t* O = out + (size_t)b * blk;
  const int ns = min(max(nseq[b], 0), ncap);

  long long op = 0;  // may pass blk on a table that overruns the block
  for (int q0 = 0; q0 < ns; q0 += 32) {
    const int q = q0 + lane;
    int my_l = 0, my_s = 0, my_m = 0, my_o = 1;
    if (q < ns) {
      my_l = max(LL[q], 0);
      my_s = LS[q];
      my_m = max(ML[q], 0);
      my_o = max(OF[q], 1);
    }
    const int cnt = min(32, ns - q0);
    for (int i = 0; i < cnt; ++i) {
      const int l = __shfl_sync(0xFFFFFFFFu, my_l, i);
      const int src = __shfl_sync(0xFFFFFFFFu, my_s, i);
      const int m = __shfl_sync(0xFFFFFFFFu, my_m, i);
      const int o = __shfl_sync(0xFFFFFFFFu, my_o, i);
      // the literal run (what lies past blk is dropped, so not copied)
      const long long lend = l < blk - op ? l : blk - op;
      for (long long k = lane; k < lend; k += 32) {
        const long long s = (long long)src + k;
        O[op + k] = s >= 0 && s < ccap ? C[s] : 0;
      }
      op += l;
      // the match: rounds of min(rem, avail) bytes from op - o, until it
      // ends or reaches blk
      long long mop = op, avail = o, rem = m;
      while (rem > 0 && mop < blk) {
        const long long c = rem < avail ? rem : avail;
        const long long cend = c < blk - mop ? c : blk - mop;
        const long long s0 = mop - avail;
        __syncwarp();
        for (long long k = lane; k < cend; k += 32) {
          const long long s = s0 + k;
          O[mop + k] = s >= 0 ? O[s] : 0;  // s < mop < blk
        }
        mop += c;
        rem -= c;
        avail += c;
      }
      op = mop + rem;
    }
  }
  __syncwarp();
  for (long long k = (op < blk ? op : blk) + lane; k < blk; k += 32) O[k] = 0;
}

}  // namespace

extern "C" int zl4_serial_decode(const void* comp, const void* lit_len,
                                 const void* lit_src, const void* mlen,
                                 const void* off, const void* nseq, void* out,
                                 int B, int ccap, int ncap, int blk,
                                 void* stream) {
  if (B <= 0 || ccap <= 0 || ncap <= 0 || blk <= 0)
    return (int)cudaErrorInvalidValue;
  serial_decode_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)lit_len, (const int32_t*)lit_src,
      (const int32_t*)mlen, (const int32_t*)off, (const int32_t*)nseq,
      (uint8_t*)out, B, ccap, ncap, blk);
  return (int)cudaGetLastError();
}
