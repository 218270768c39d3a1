// LZ4 block encoder, levels 10-12: the deep finder in windows over 64 KB.
//
// Replaces: the deep finder of _encode_block of the JAX reference
// (ops/jax_block.py:274-516 at deep = 1, 2, 3 with hc >= 1) at 65,536 < blk,
// where device_encoder_supports (:160-169) holds: [dictionary | block]
// windows of up to 131,072 bytes, 256 KB blocks, and the 327,680-byte
// sub-span windows (64 KB history + 256 KB) that 1 MB and 4 MB frame blocks
// are encoded as (parallel/sharded.py, _SUB and _SUBH).  Its sorts are
// stable (lax.sort(..., is_stable=True), :341-352; ranksN, :285-296), and
// its wide branch carries idx and wb16 as two sort operands instead of one
// packed word (:268-272, pack_iw); the order is the same, since the
// position is the last key here.
//
// enc_deep_match_wide (one thread-block cluster of C CTAs x 1024 threads
// per window, as enc_match_wide, encode_wide.cu): the steps of the deep
// finder of encode_deep.cuh -- the 32-byte rank, at deep = 3 the 256-byte
// rank, the grand grouping sort, the probes with the nested tier chain,
// the positional fallback -- over an order held in the cluster's shared
// memory and sorted by the stable byte-digit LSD radix passes of
// radix_cluster.cuh, where the bitonic network this replaces re-read up to
// 32 window bytes or eight ranks of two rows at each of its 190 stages:
//   * the 32-byte order (s0, at(p+4), ..., at(p+28), p): 32 passes over
//     window bytes read from the input row, s0's four bytes 0xFF on the
//     rows past n - 4, every at() byte zero at and past n;
//   * the rank orders (LessRanks: x[p + step k], k < nk, then p) in three
//     passes a key over the bytes of x + 1, with x = -1 past the end, so
//     that -1 sorts first: 24 for the 256-byte rank (r, step 32, 8 keys),
//     12 for the grand order at deep 1 (r, 4 keys) and at deep 3 (r2, step
//     256, 4 keys), 24 at deep 2 (r, 8 keys); the ranks stay below
//     2^19 + 1, so a pass over their third byte is mostly skipped, as is
//     any pass whose digit is the same on every row;
//   * the class numbering of a sorted order (ranksN) as a scan across the
//     cluster: each CTA counts the class boundaries of its slice, the row
//     before its first coming from the CTA before it over distributed
//     shared memory, and adds the counts of the CTAs before it;
//   * the ranks are int32 in device scratch as at 64 KB: [B, 1, blk], or
//     [B, 2, blk] at deep = 3; the window words too, built once.
// Output per position: the pack ((cand + 1) << 12) | (fine ml << 6) |
// (tier << 2) | back, which needs cand + 1 < 2^19; the wrapper and the entry
// point hold blk < 2^19.
// Bound: not the bytes it must move but issue and latency.  At the 1 MB
// paths' level-12 launch (192 windows of 327,680 bytes) on the H100 the
// sorts take about three fifths of the kernel (72 passes less the skipped
// ones; per pass a dependent device-memory load of a window byte or a
// rank, a shared-memory atomic and a remote shared-memory store a row),
// the tier probes about a quarter (tier_pack, as at 64 KB: up to 36 window
// bytes and eleven ranks of two rows from the L1 and L2), the class
// numberings and the fallback the rest.
//
// Built with -DZL4_STOP=k (chip_smoke.py), the kernel stops after phase k:
// 1 window words, 2 the 32-byte sort, 3 its class numbering, 4 the 256-byte
// rank's sort and 5 its numbering (deep 3), 6 the grand sort, 7 the tier
// probes, 8 the s0 sort, 9 the fallback probes.

#include "encode_deep.cuh"
#include "radix_cluster.cuh"

namespace {

// Number the classes of the cluster's sorted order -- rows t - 1 and t are
// in one class when their eight key words are equal -- from 1 in sorted
// order, and store each row's number at its position (ranksN,
// jax_block.py:285-296; block_ranks of encode_deep.cu across the
// cluster).  A thread takes a run of at most 32 rows of its CTA's slice,
// keeps the previous row's key in registers and its class boundaries as a
// bit mask, so each row's key is read once; the row before a slice comes
// from the CTA before it.
template <class Key>
__device__ void wide_ranks(const WideOrder& o, Key key, int32_t* rank) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (o.nloc + kWideThreads - 1) / kWideThreads;  // <= Jr
  const int i0 = min(tid * chunk, o.nloc), i1 = min(i0 + chunk, o.nloc);
  uint32_t prev[8] = {}, bounds = 0;
  if (i0 < i1 && o.lo + i0 > 0) {
    const int q = o[o.lo + i0 - 1];
#pragma unroll
    for (int k = 0; k < 8; ++k) prev[k] = key(q, k);
  }
  for (int i = i0; i < i1; ++i) {
    const int p = o.s[i];
    bool same = o.lo + i > 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t v = key(p, k);
      same &= v == prev[k];
      prev[k] = v;
    }
    bounds |= (uint32_t)!same << (i - i0);
  }
  const int cnt = __popc(bounds);
  int x = cnt;  // inclusive scan of the chunk counts over the CTA
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, k);
    if (lane >= k) x += y;
  }
  if (lane == 31) o.part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = o.part[lane];
    int y = v;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int z = __shfl_up_sync(0xFFFFFFFFu, y, k);
      if (lane >= k) y += z;
    }
    o.part[lane] = y - v;
    if (lane == 31) o.cnt[0] = y;  // the CTA's classes, for the cluster
  }
  __syncthreads();
  x += o.part[warp];
  cluster.sync();
  if (tid == 0) {
    int base = 0;
    for (int c = 0; c < o.r; ++c) base += cluster.map_shared_rank(o.cnt, c)[0];
    o.part[kWideBase] = base;
  }
  __syncthreads();
  int run = o.part[kWideBase] + x - cnt;
  for (int i = i0; i < i1; ++i) {
    run += (bounds >> (i - i0)) & 1u;
    rank[o.s[i]] = run;
  }
  cluster.sync();  // every rank stored; the counts are free again
}

template <int J>
__global__ void __launch_bounds__(kWideThreads, 1)
enc_deep_match_wide_kernel(const uint8_t* __restrict__ data,
                           const int32_t* __restrict__ lens, uint32_t* words,
                           int32_t* ranks, int32_t* __restrict__ pk, int blk,
                           int nwords, int Jr, int hc, int deep) {
  extern __shared__ uint32_t wide_smem_buf[];
  const WideOrder o = wide_order(wide_smem_buf, blk, Jr);
  const int b = blockIdx.x / o.C;
  const int n = min(max(lens[b], 0), blk);
  const uint8_t* row = data + (size_t)b * blk;
  uint32_t* wd = words + (size_t)b * nwords;
  int32_t* r = ranks + (size_t)b * (deep == 3 ? 2 : 1) * blk;
  int32_t* r2 = r + blk;
  int32_t* out = pk + (size_t)b * blk;

  wide_words(row, n, wd, nwords, o);
  const Window W{wd, n};
#define ZL4_KEEP_ORDER                                           \
  for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)       \
    out[o.lo + i] = o.s[i]
  ZL4_WIDE_STOP(1, for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
                       out[o.lo + i] = wd[(o.lo + i) % nwords])

  // 32-byte rank: order by (s0, at(p+4), ..., at(p+28)), then number
  wide_sort_window<J>(o, row, n, 8);
  ZL4_WIDE_STOP(2, ZL4_KEEP_ORDER)
  wide_ranks(o, Key32{W}, r);
  ZL4_WIDE_STOP(3, for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
                       out[o.lo + i] = r[o.lo + i])

  if (deep == 3) {  // 256-byte rank over r[i], r[i+32], ..., r[i+224]
    wide_sort_ranks<J>(o, r, 32, 8);
    ZL4_WIDE_STOP(4, ZL4_KEEP_ORDER)
    wide_ranks(o, KeyRanks{r, 32, blk}, r2);
    ZL4_WIDE_STOP(5, for (int i = threadIdx.x; i < o.nloc; i += kWideThreads)
                         out[o.lo + i] = r2[o.lo + i])
  }

  // grand order by the last NK tier operands, ties by position
  if (deep == 3) wide_sort_ranks<J>(o, r2, 256, 4);
  else wide_sort_ranks<J>(o, r, 32, deep == 2 ? 8 : 4);
  ZL4_WIDE_STOP(6, ZL4_KEEP_ORDER)
  const Tiers T{r, r2, blk, deep};
  for (int i = threadIdx.x; i < o.nloc; i += kWideThreads) {
    const int p = o.s[i];
    out[p] = tier_pack(W, T, o, o.lo + i, p, blk, hc);
  }
  ZL4_WIDE_STOP(7, )

  // positional fallback: order by s0 alone, probes +1 and +2; it must beat
  // the total ml, and clears the tier.  The packs it reads were stored by
  // other CTAs before the sort's barriers (L2 reads).
  wide_sort_window<J>(o, row, n, 1);
  ZL4_WIDE_STOP(8, ZL4_KEEP_ORDER)
#undef ZL4_KEEP_ORDER
  for (int i = threadIdx.x; i < o.nloc; i += kWideThreads) {
    const int p = o.s[i];
    const Cand c = nearest(W, o, o.lo + i, 2, kMaxW);
    if (c.ml > total_ml(__ldcg(out + p), deep)) out[p] = pack(c);
  }
  cg::this_cluster().sync();
}

unsigned raised_deep[2];  // devices whose limits are raised, by J

// The kernel for Jr rows a thread: 20 at most (windows up to 327,680
// bytes), else 32; the phase-cut builds have only the first.
template <class F>
cudaError_t with_deep_kernel(int Jr, F f) {
  if (Jr <= 20) return f(enc_deep_match_wide_kernel<20>, &raised_deep[0], 20);
#ifndef ZL4_STOP
  return f(enc_deep_match_wide_kernel<32>, &raised_deep[1], 32);
#else
  return cudaErrorInvalidValue;
#endif
}

}  // namespace

extern "C" int zl4_enc_deep_match_wide(const void* data, const void* lens,
                                       void* words, void* ranks, void* pk,
                                       int B, int blk, int nwords, int C,
                                       int Jr, int hc, int deep,
                                       void* stream) {
  // words: u32[B, (blk + kPad) / 4 + 1]; ranks: int32[B, 1, blk], or
  // int32[B, 2, blk] at deep == 3; C CTAs a window holding 1024 Jr rows
  // each
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) ||
      nwords != window_words(blk) || !wide_shape_ok(blk, C, Jr) ||
      hc < 1 || deep < 1 || deep > 3)
    return (int)cudaErrorInvalidValue;
  return (int)with_deep_kernel(Jr, [&](auto kernel, unsigned* raised, int J) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        wide_launch(kernel, raised, J, B, C, Jr, stream, &cfg, &attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)data,
                             (const int32_t*)lens, (uint32_t*)words,
                             (int32_t*)ranks, (int32_t*)pk, blk, nwords, Jr,
                             hc, deep);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  });
}

// The launch shape of one window on the current device, as
// zl4_enc_match_wide_shape gives it.
extern "C" int zl4_enc_deep_match_wide_shape(int blk, int C, int Jr,
                                             int* out) {
  if (blk <= 0 || blk >= (1 << 19) || !wide_shape_ok(blk, C, Jr))
    return (int)cudaErrorInvalidValue;
  return (int)with_deep_kernel(Jr, [&](auto kernel, unsigned* raised, int J) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        wide_launch(kernel, raised, J, 1, C, Jr, nullptr, &cfg, &attr);
    if (err != cudaSuccess) return err;
    out[0] = (int)cfg.dynamicSmemBytes;
    return cudaOccupancyMaxActiveClusters(&out[1], kernel, &cfg);
  });
}
