// LZ4 block encoder, levels 0-9: match finding in windows over 64 KB.
//
// Replaces: _encode_block of the JAX reference (ops/jax_block.py:200-1103)
// at deep=0 and 65,536 < blk, where device_encoder_supports (:160-169)
// holds: [dictionary | block] windows of up to 131,072 bytes, 256 KB
// blocks, and the 327,680-byte sub-span windows (64 KB history + 256 KB)
// that 1 MB and 4 MB frame blocks are encoded as (parallel/sharded.py,
// _SUB and _SUBH).  The reference sorts with lax.sort(..., is_stable=True)
// (:341-352) and its wide branch keeps idx and wb16 as two sort operands
// instead of one packed word (:268-272, pack_iw); the order is the same,
// since the position is the sort's last key.
//
// enc_match_wide (one thread-block cluster of C CTAs x 1024 threads per
// window, C = 8 at 131,072 bytes and 16 at 262,144 and 327,680, or up to
// 16 at any width where the launch holds few windows,
// torch_block.wide_spread_shape): the same
// semantics as enc_match (hc >= 1: the 12-byte grouping order, probes
// +-1..+-hc, the unsort as a store to the position, the fallback order
// (s0, i) with probes +1 and +2, taken only when strictly longer) and
// enc_match_fast (hc == 0: the order (s0, i), probes +1..+probes over nwin
// carried windows) of encode_block.cu.  A 327,680-byte window's order is
// 1.3 MB of u32 rows, more than one SM holds, so
//   * the order lives in the cluster's shared memory, 1024 Jr rows a CTA
//     (20,480 at 327,680), and is sorted by stable byte-digit LSD radix
//     passes across the cluster (radix_cluster.cuh): 12 passes for the
//     12-byte order (window bytes p+8..p+11, p+4..p+7, then s0's four
//     bytes, 0xFF on the rows past n - 4), 4 for the order (s0, p); a
//     pass whose digit is the same on every row is skipped;
//   * each pass reads one byte a row from the input row (the read-only
//     path), where the bitonic network this replaces re-read 4-12 key
//     bytes of two rows at each of its 190 stages;
//   * the window words are built once into device scratch (words), which
//     the L1 and L2 serve to the probes; a probe reads its sorted
//     neighbour from the local slice or, at a slice's edge, from the
//     neighbouring CTA's over distributed shared memory.
// Output per position: the pack ((cand + 1) << 12) | (fine ml << 6) | back,
// which needs cand + 1 < 2^19; the wrapper and the entry point hold
// blk < 2^19.
// Bound: not the bytes it must move (each window once, 4 bytes out per
// position) but issue and latency.  At the 1 MB paths' launch (192 windows
// of 327,680 bytes, hc = 9) on the H100 the +-9 probes take about half the
// kernel and the fallback probes a tenth -- each probe reloads its window
// words through the L1 and L2, which hold a fraction of a 320 KB window --
// and the 16 passes about a third: per pass a dependent device-memory byte
// load, a shared-memory atomic and a remote shared-memory store a row, and
// two cluster barriers (radix_cluster.cuh).  The probes are the same code
// as at 64 KB (nearest_both, nearest), reading the order through
// WideOrder.
//
// Built with -DZL4_STOP=k (chip_smoke.py), the kernel stops after phase k:
// 1 window words, 2 the first sort, 3 its probes, 4 the s0 sort, 5 the
// fallback probes.

#include "encode_common.cuh"
#include "radix_cluster.cuh"

namespace {

template <int J>
__global__ void __launch_bounds__(kWideThreads, 1)
enc_match_wide_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens, uint32_t* words,
                      int32_t* __restrict__ pk, int blk, int nwords, int Jr,
                      int hc, int nwin, int probes) {
  extern __shared__ uint32_t wide_smem_buf[];
  const WideOrder o = wide_order(wide_smem_buf, blk, Jr);
  const int b = blockIdx.x / o.C;
  const int n = min(max(lens[b], 0), blk);
  const uint8_t* row = data + (size_t)b * blk;
  uint32_t* wd = words + (size_t)b * nwords;
  int32_t* out = pk + (size_t)b * blk;

  wide_words(row, n, wd, nwords, o);
  const Window W{wd, n};
  ZL4_WIDE_STOP(1, for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
                       out[o.lo + i] = wd[(o.lo + i) % nwords])

  if (!hc) {
    wide_sort_window<J>(o, row, n, 1);
    ZL4_WIDE_STOP(2, for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
                         out[o.lo + i] = o.s[i])
    for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
      out[o.s[i]] = pack(nearest(W, o, o.lo + i, probes, nwin));
    cg::this_cluster().sync();  // no CTA leaves while another reads it
    return;
  }

  // 12-byte lexicographic order, ties by position, and its probes
  wide_sort_window<J>(o, row, n, 3);
  ZL4_WIDE_STOP(2, for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
                       out[o.lo + i] = o.s[i])
  for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
    out[o.s[i]] = pack(nearest_both(W, o, o.lo + i, blk, hc));
  ZL4_WIDE_STOP(3, )

  // positional fallback: order by s0 alone, probes +1 and +2; the packs it
  // reads were stored by other CTAs before the sort's barriers (L2 reads)
  wide_sort_window<J>(o, row, n, 1);
  ZL4_WIDE_STOP(4, for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
                       out[o.lo + i] = o.s[i])
  for (int i = threadIdx.x; i < o.nloc; i += kWideThreads) {
    const int p = o.s[i];
    const Cand c = nearest(W, o, o.lo + i, 2, kMaxW);
    if (c.ml > ((__ldcg(out + p) >> 6) & 63)) out[p] = pack(c);
  }
  cg::this_cluster().sync();
}

unsigned raised_match[2];  // devices whose limits are raised, by J

// The kernel for Jr rows a thread: 20 at most (windows up to 327,680
// bytes), else 32; the phase-cut builds have only the first.
template <class F>
cudaError_t with_match_kernel(int Jr, F f) {
  if (Jr <= 20) return f(enc_match_wide_kernel<20>, &raised_match[0], 20);
#ifndef ZL4_STOP
  return f(enc_match_wide_kernel<32>, &raised_match[1], 32);
#else
  return cudaErrorInvalidValue;
#endif
}

}  // namespace

extern "C" int zl4_enc_match_wide(const void* data, const void* lens,
                                  void* words, void* pk, int B, int blk,
                                  int nwords, int C, int Jr, int hc,
                                  int nwin, int probes, void* stream) {
  // words: u32[B, (blk + kPad) / 4 + 1]; C CTAs a window holding 1024 Jr
  // rows each; hc >= 1 takes all kMaxW windows
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) ||
      nwords != window_words(blk) || !wide_shape_ok(blk, C, Jr) ||
      hc < 0 || nwin < 1 || nwin > kMaxW || probes < 1)
    return (int)cudaErrorInvalidValue;
  return (int)with_match_kernel(Jr, [&](auto kernel, unsigned* raised,
                                        int J) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        wide_launch(kernel, raised, J, B, C, Jr, stream, &cfg, &attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)data,
                             (const int32_t*)lens, (uint32_t*)words,
                             (int32_t*)pk, blk, nwords, Jr, hc, nwin, probes);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  });
}

// The launch shape of one window on the current device: out[0] bytes of
// shared memory a CTA, out[1] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 means the shape cannot be scheduled).
extern "C" int zl4_enc_match_wide_shape(int blk, int C, int Jr, int* out) {
  if (blk <= 0 || blk >= (1 << 19) || !wide_shape_ok(blk, C, Jr))
    return (int)cudaErrorInvalidValue;
  return (int)with_match_kernel(Jr, [&](auto kernel, unsigned* raised,
                                        int J) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        wide_launch(kernel, raised, J, 1, C, Jr, nullptr, &cfg, &attr);
    if (err != cudaSuccess) return err;
    out[0] = (int)cfg.dynamicSmemBytes;
    return cudaOccupancyMaxActiveClusters(&out[1], kernel, &cfg);
  });
}
