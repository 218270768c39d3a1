// LZ4 block rebuild from parsed sequences, the matches walked in order.
//
// Replaces: the Pallas decoder make_pallas_decoder of the JAX package's
// retired probe experiments/pallas_decode.py (:127; _kernel :53-123,
// pl.pallas_call :149, wrapper decode_blocks_pallas :179-206).  The TPU
// kernel holds one block in VMEM (:62, :157-163) and walks its sequences
// serially: a literal run comp[lit_src : lit_src + lit_len] goes to
// out[op :], then a match copies min(rem, avail) bytes a round from
// out[op - off :] to the end of what is written, avail starting at off
// and growing by what each round wrote (:108-120), so a match that
// overlaps itself (off < mlen) takes log2(mlen / off) rounds and each
// round's source lies wholly before its destination.  Bytes from the last
// sequence's end on are zero.  It takes no history: a match reaches into
// the block only.
//
// serial_smem (blocks up to kRowMax = 225,280 bytes, 220 KB): one CTA of
// 256 threads a block, the block's output row in dynamic shared memory
// (blk bytes: at 64 KB three CTAs fit an SM), in three phases.
//   1. Literals, by the whole CTA.  The sequences' start positions are a
//      block-wide exclusive scan, in int64, of max(lit, 0) + max(ml, 0),
//      taken 256 sequences at a time with a carry; each chunk's literal
//      bytes inside the block are spread over the threads, a byte finding
//      its sequence by bisection of the chunk's literal prefix.  This is
//      exact: sequence q's literal and match cover [op_q, op_q+1), these
//      ranges are disjoint, and a match reads only below its own start, so
//      no literal is read before it is placed and no match reads a later
//      literal.
//   2. Matches, by warp 0 in sequence order: the probe's serial walk, its
//      rounds of min(rem, avail) bytes a byte a lane with a __syncwarp()
//      between rounds, every read and write in shared memory.  Only the
//      copies are serial: the matches' starts come from a warp scan of a
//      batch of 32 table entries, and the next 32 entries are loaded while
//      the warp walks the current 32, since neither depends on the chain.
//      Each batch's matches, as {start, length inside the block, offset},
//      are staged in shared memory, and the warp reads the next while it
//      copies the current.  A match of at most 32 bytes that does not
//      overlap itself (most are) is one round of a byte a lane; a longer
//      round takes 32 bytes a step.
//   3. Write-out, by the whole CTA: the row to `out` in 16-byte stores,
//      zero from min(op_end, blk) on.
// serial_decode (larger blocks): one warp a block, four blocks a 128-thread
// CTA, the same walk with literals and matches written in device memory
// directly, zero from the end of the last sequence on.  The wrapper picks
// the route from blk alone (probes/serial_decode.py).
// For tables that parse_sequences produces (offsets inside the block, a
// total of at most blk bytes) the bytes are the probe's.  Outside them the
// probe's Mosaic slices are undefined; here a source before the block or
// past the payload reads 0, a destination at or past blk is dropped and a
// negative length counts as 0; op is 64-bit, so the lengths may sum past
// blk or past int32.
// Bound: the chain of matches, not bytes (a block moves its payload,
// 16 bytes a sequence and blk bytes out): on the shared-memory route each
// match is a dependent shared-memory load and store of one warp and the
// loop around them, a long round one such step for each 32 bytes, and
// three CTAs an SM at 64 KB give three walks an SM at once; the warp route
// pays a round trip to the L2 for each.  Built with -DZL4_STOP=k
// the shared-memory kernel stops after its k-th phase (1 the literals,
// 2 the walk; the write-out is the rest) so that chip_smoke.py can time
// the phases one by one; the library is built without it.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef ZL4_STOP
#define ZL4_SERIAL_STOP(k)                    \
  if (ZL4_STOP == (k)) {                      \
    __syncthreads();                          \
    if (threadIdx.x == 0) O[0] = row[0];      \
    return;                                   \
  }
#else
#define ZL4_SERIAL_STOP(k)
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------
// one warp a block, the row in device memory
// ---------------------------------------------------------------------

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
      const int l = __shfl_sync(kFull, my_l, i);
      const int src = __shfl_sync(kFull, my_s, i);
      const int m = __shfl_sync(kFull, my_m, i);
      const int o = __shfl_sync(kFull, my_o, i);
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

// ---------------------------------------------------------------------
// one CTA a block, the row in shared memory
// ---------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRowMax = 220 * 1024;  // the largest blk of this route

// Block-wide exclusive scan of x (every thread calls it); *total gets
// the sum.  `part` holds kThreads / 32 entries of shared memory; ends on
// a barrier, after which `part` may be reused.
template <typename T>
__device__ __forceinline__ T block_excl_scan(T x, T* part, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T s = x;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) part[warp] = s;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const T p = part[w];
    before += w < warp ? p : 0;
    all += p;
  }
  __syncthreads();
  *total = all;
  return before + s - x;
}

__global__ void __launch_bounds__(kThreads)
serial_smem_kernel(const uint8_t* __restrict__ comp,
                   const int32_t* __restrict__ lit_len,
                   const int32_t* __restrict__ lit_src,
                   const int32_t* __restrict__ mlen,
                   const int32_t* __restrict__ off,
                   const int32_t* __restrict__ nseq, uint8_t* out, int ccap,
                   int ncap, int blk) {
  extern __shared__ __align__(16) uint8_t row[];
  __shared__ int s_lpre[kThreads], s_dst[kThreads], s_src[kThreads];
  __shared__ long long part64[kThreads / 32];
  __shared__ int part32[kThreads / 32];
  __shared__ int4 desc[32];  // the walk's batch of matches
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t b = blockIdx.x;
  const uint8_t* C = comp + b * ccap;
  const int32_t* LL = lit_len + b * ncap;
  const int32_t* LS = lit_src + b * ncap;
  const int32_t* ML = mlen + b * ncap;
  const int32_t* OF = off + b * ncap;
  uint8_t* O = out + b * blk;
  const int ns = min(max(nseq[b], 0), ncap);

  // 1. the literals: sequence starts by an int64 scan, a chunk of
  // kThreads sequences at a time; each chunk's literal bytes inside the
  // block spread over the threads
  long long carry = 0;
  for (int base = 0; base < ns; base += kThreads) {
    const int q = base + tid;
    int l = 0, m = 0, src = 0;
    if (q < ns) {
      l = max(LL[q], 0);
      m = max(ML[q], 0);
      src = LS[q];
    }
    long long seg_total;
    const long long op =
        carry + block_excl_scan<long long>((long long)l + m, part64,
                                           &seg_total);
    const long long room = (long long)blk - op;
    const int lend = room <= 0 ? 0 : (int)(l < room ? l : room);
    int nlit;
    const int lpre = block_excl_scan<int>(lend, part32, &nlit);
    s_lpre[tid] = lpre;
    s_dst[tid] = lend ? (int)op : 0;
    s_src[tid] = src;
    __syncthreads();
    for (int t = tid; t < nlit; t += kThreads) {
      int i = 0;  // the last sequence whose literal prefix is <= t
#pragma unroll
      for (int step = kThreads / 2; step; step >>= 1)
        if (s_lpre[i + step] <= t) i += step;
      const int k = t - s_lpre[i];
      const long long s = (long long)s_src[i] + k;
      row[s_dst[i] + k] = s >= 0 && s < ccap ? C[s] : 0;
    }
    carry += seg_total;
    __syncthreads();  // before the next chunk rewrites the staging
  }
  ZL4_SERIAL_STOP(1)

  // 2. the matches, by warp 0 in sequence order
  if (tid < 32) {
    // the next batch's entries, loaded a batch ahead and clamped where
    // they are used, so that the walk never waits for the load
    int nl = 0, nm = 0, no = 1;
    if (lane < ns) {
      nl = LL[lane];
      nm = ML[lane];
      no = OF[lane];
    }
    long long op = 0;  // where the batch starts
    for (int q0 = 0; q0 < ns && op < blk; q0 += 32) {
      const int my_l = max(nl, 0), my_m = max(nm, 0), my_o = max(no, 1);
      const int qn = q0 + 32 + lane;
      nl = 0, nm = 0, no = 1;
      if (qn < ns) {
        nl = LL[qn];
        nm = ML[qn];
        no = OF[qn];
      }
      // the batch's match starts by an int64 warp scan, off the chain;
      // lane q's match is the `len` bytes at d inside the block
      long long x = (long long)my_l + my_m;
      for (int k = 1; k < 32; k <<= 1) {
        const long long y = __shfl_up_sync(kFull, x, k);
        if (lane >= k) x += y;
      }
      const long long mop = op + x - my_m;
      op += __shfl_sync(kFull, x, 31);
      const bool in = mop < blk;
      const int d = in ? (int)mop : 0;
      const int len = in ? (int)min((long long)my_m, blk - mop) : 0;
      // the walk, in sequence order: each match's {d, len, offset} staged
      // in shared memory and read one match ahead, so that only the copies
      // stand on the chain
      desc[lane] = make_int4(d, len, my_o, 0);
      __syncwarp();
      const int cnt = min(32, ns - q0);
      int4 cur = desc[0];
      for (int i = 0; i < cnt; ++i) {
        const int4 nxt = desc[i + 1 < cnt ? i + 1 : i];
        const int dd = cur.x, o = cur.z;
        int rem = cur.y;
        __syncwarp();
        if (rem <= 32 && rem <= o) {  // one round, a byte a lane
          const int s = dd - o + lane;
          if (lane < rem) row[dd + lane] = s >= 0 ? row[s] : 0;
        } else {
          // rounds of min(rem, avail) bytes from mo - avail (the bytes
          // past blk are not counted in rem, so not copied)
          int mo = dd;
          long long avail = o;
          while (rem > 0) {
            const int c = (int)(rem < avail ? rem : avail);
            const long long s0 = mo - avail;
            for (int k = lane; k < c; k += 32) {
              const long long s = s0 + k;  // s < mo < blk
              row[mo + k] = s >= 0 ? row[(int)s] : 0;
            }
            mo += c;
            rem -= c;
            avail += c;
            __syncwarp();
          }
        }
        cur = nxt;
      }
      __syncwarp();  // before the next batch rewrites desc
    }
  }
  ZL4_SERIAL_STOP(2)
  __syncthreads();

  // 3. the write-out, zero from the end of the last sequence on
  const int end = (int)(carry < blk ? carry : blk);
  if ((blk & 15) == 0 && ((uintptr_t)O & 15) == 0) {
    for (int i = tid; i < blk >> 4; i += kThreads) {
      uint4 v = reinterpret_cast<const uint4*>(row)[i];
      const int p = i << 4;
      if (p + 16 > end) {
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = min(max(end - (p + 4 * k), 0), 4);
          w[k] &= n == 4 ? kFull : (1u << (8 * n)) - 1u;
        }
      }
      reinterpret_cast<uint4*>(O)[i] = v;
    }
  } else {
    for (int i = tid; i < blk; i += kThreads) O[i] = i < end ? row[i] : 0;
  }
}

// Raises serial_smem_kernel's shared-memory limit once per device.
cudaError_t raise_row_limit() {
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && raised >> dev & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(serial_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRowMax);
  if (err == cudaSuccess && dev < 32) raised |= 1u << dev;
  return err;
}

int row_bytes(int blk) { return (blk + 15) & ~15; }

}  // namespace

// smem: 1 for the shared-memory route (blk <= kRowMax), 0 for the warp
// route; any other value, or one that does not match blk, is refused.
extern "C" int zl4_serial_decode(const void* comp, const void* lit_len,
                                 const void* lit_src, const void* mlen,
                                 const void* off, const void* nseq, void* out,
                                 int B, int ccap, int ncap, int blk, int smem,
                                 void* stream) {
  if (B <= 0 || ccap <= 0 || ncap <= 0 || blk <= 0 ||
      smem != (blk <= kRowMax ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  if (!smem) {
    serial_decode_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int32_t*)lit_len,
        (const int32_t*)lit_src, (const int32_t*)mlen, (const int32_t*)off,
        (const int32_t*)nseq, (uint8_t*)out, B, ccap, ncap, blk);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = raise_row_limit();
  if (err != cudaSuccess) return (int)err;
  serial_smem_kernel<<<B, kThreads, row_bytes(blk), (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)lit_len, (const int32_t*)lit_src,
      (const int32_t*)mlen, (const int32_t*)off, (const int32_t*)nseq,
      (uint8_t*)out, ccap, ncap, blk);
  return (int)cudaGetLastError();
}

// The launch shape for blk-byte blocks on the current device: out[0] 1
// for the shared-memory route (0: the warp route), out[1] its dynamic
// shared-memory bytes a CTA, out[2] its CTAs an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int zl4_serial_decode_shape(int blk, int* out) {
  if (blk <= 0) return (int)cudaErrorInvalidValue;
  out[0] = blk <= kRowMax;
  out[1] = out[2] = 0;
  if (!out[0]) return (int)cudaSuccess;
  const cudaError_t err = raise_row_limit();
  if (err != cudaSuccess) return (int)err;
  out[1] = row_bytes(blk);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], serial_smem_kernel, kThreads, row_bytes(blk));
}
