// LZ4 block encoder, levels 0-9: match finding, parse and emission.
//
// Replaces: _encode_block of the JAX reference (ops/jax_block.py:200-1103)
// at deep=0: hc=0 (the fast finder, W = 8, 4, 2 or 1 carried windows) and
// hc >= 1 (the HC finder, W = 8).  The TPU version is gather-free: stable
// sorts, unsort sorts, packed cummax fills, a chunked scan for the greedy
// parse, and one grand sort that places every output byte.  On Hopper
// gathers and shared memory are cheap, so the same bytes come from these
// kernels:
//
// enc_match (hc >= 1; one 1024-thread block per window of up to 64 KB):
//   window build (:249-272) into shared memory, the stable 3-key sort of
//   :349-350 -- positions ordered by (s0, su[i+4], su[i+8], i) -- as 12
//   stable byte passes of the LSD radix sort of sort_radix.cuh (window
//   bytes i+8..i+11, i+4..i+7, then s0's four bytes, which are 0xFF on the
//   rows past n - 4), the +-1..+-hc probes of cand_at (:379-450) on the
//   sorted rows, the unsort as a store to the position (:455-469), then the
//   fallback order (s0, i) in 4 more passes, with probes +1 and +2
//   (:471-516).  Output per position: the reference's pack
//   ((cand + 1) << 12) | (fine ml << 6) | back, 0 when there is none.
//   Shared memory: the window words (64 KB), one u16 order over the blk rows
//   (128 KB) and the passes' histograms (32 KB), 224 KB at 64 KB, so one
//   window runs per SM; a pass keeps its rows in registers while it
//   scatters them back into the one order buffer.
//   Bound: issue of the passes' ballots and shared-memory accesses, and the
//   probes' shared-memory loads (each compares up to 36 bytes of two rows);
//   not device memory: it reads each window once and writes 4 bytes per
//   position.
//
// enc_match_fast (hc == 0; one 1024-thread block per window of up to
//   64 KB, on enc_match's shared-memory layout): window build, the stable
//   1-key sort of :348-352 -- positions ordered by (s0, i) -- as the 4 s0
//   byte passes of sort_radix.cuh that enc_match runs for its fallback (0xFF
//   on the rows past n - 4), and probes +1..+probes against the nearest
//   previous rows of the group, a later probe winning only when strictly
//   longer (:433-450), over W carried windows (fast_params, :179-197).  No
//   fallback pass.  Bound: the 4 passes' ballots and shared-memory accesses
//   and the probes' shared-memory loads, as enc_match's; not device memory.
//
// enc_parse_emit (one 256-thread block per window of up to 2^19 bytes):
//   1. same-offset chain extension (:522-552) and the n-5 clamp (:554-555),
//      position-parallel and coalesced: the chain boundaries as a bit mask
//      by warp ballots, the nearest boundary after each 32-row word by a
//      block-wide reverse scan, then every row's length from its nearest
//      boundary at or after it (a bit scan within its word);
//   2. two-step lazy deferral (:684-710; HC only) into a bit mask of the
//      final match rows, by warp ballots;
//   3. the greedy parse (:716-743): the warps stage, 2,048 rows at a time,
//      each match row's successor -- the first match row at or after its
//      end, found in the mask by a bit scan within a word and a block-wide
//      reverse scan over the words -- into shared memory, and one thread
//      follows the chain through them, one shared load a chosen row, a
//      span behind the warps; it lists the chosen rows and nothing else;
//   4. the emission (:871-1103), in parallel over the list: emit_entries
//      of encode_common.cuh, which enc_deep_emit runs too: an entry merges
//      into the one before it when it starts at that one's end at the same
//      offset; the last entry of each merged group finds its head by a
//      block max-scan, computes the group's literal run (from the previous
//      end, extended back over <= back literals) and its header bytes
//      (255-escapes, LE offset), and a block sum-scan of the groups' sizes
//      places it; a literal run under 32 bytes is copied by that thread,
//      longer ones (the tail's too) and the zeros past out_len by all
//      warps.
//   Shared memory: the mask and the next set bit after each of its words
//   (blk / 4 bytes: 16 KB at 64 KB, 80 KB at 327,680) and two staged spans
//   (16 KB).  Bound: the one parsing thread's chain through shared memory,
//   a few tens of cycles a chosen match, and the position-parallel phases'
//   loads; not the bytes it must move.
//   A launch of few windows (an insert call's one or two sub-span windows)
//   takes the spread route instead (torch_block.parse_spread_shape):
//   enc_parse_emit_spread_kernel, one thread-block cluster of C = 2..16
//   CTAs of 1024 threads a window, the same four phases split by rows
//   across the cluster (parse_cluster.cuh) and the same bytes.
//
// Built with -DZL4_STOP=k, a kernel stops after its k-th phase and stores
// what that phase left, so that chip_smoke.py can time the phases one by
// one; the library is built without it.  enc_match: 1 window words, 2 the
// 12-byte sort, 3 the +-hc probes, 4 the s0 sort; the rest is the fallback
// probes.  enc_match_fast: 1 window words, 2 the s0 sort; the rest is the
// probes.  enc_parse_emit (both routes): 1 the chain, 2 the lazy mask, 3 the
// walk; the rest is the emission.

#include "parse_cluster.cuh"
#include "sort_radix.cuh"

#ifdef ZL4_STOP
#define ZL4_STOP_AFTER(k, keep) \
  if (ZL4_STOP == (k)) {        \
    keep;                       \
    return;                     \
  }
#define ZL4_SPREAD_STOP(k, keep) \
  if (ZL4_STOP == (k)) {          \
    keep;                         \
    cg::this_cluster().sync();    \
    return;                       \
  }
#else
#define ZL4_STOP_AFTER(k, keep)
#define ZL4_SPREAD_STOP(k, keep)
#endif

namespace {

__global__ void __launch_bounds__(kRadixThreads)
enc_match_kernel(const uint8_t* __restrict__ data,
                 const int32_t* __restrict__ lens, int32_t* __restrict__ pk,
                 int blk, int nwords, int hc) {
  extern __shared__ uint32_t smem[];
  __shared__ int part[33];
  uint32_t* words = smem;
  uint32_t* hist = smem + nwords;
  uint16_t* s = reinterpret_cast<uint16_t*>(hist + kRadixHistWords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, blk);
  const Window W{words, n};
  ZL4_STOP_AFTER(1, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = words[t % nwords])

  // 12-byte lexicographic order, ties by position
  sort_words(W, s, blk, hist, part, 3);
  ZL4_STOP_AFTER(2, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = s[t])
  for (int t = threadIdx.x; t < blk; t += blockDim.x)
    out[s[t]] = pack(nearest_both(W, s, t, blk, hc));
  __syncthreads();
  ZL4_STOP_AFTER(3, )

  // positional fallback: order by s0 alone, probes +1 and +2
  identity_order(s, blk);
  sort_words(W, s, blk, hist, part, 1);
  ZL4_STOP_AFTER(4, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = s[t])
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    const Cand c = nearest(W, s, t, 2, kMaxW);
    if (c.ml > ((out[p] >> 6) & 63)) out[p] = pack(c);
  }
}

__global__ void __launch_bounds__(kRadixThreads)
enc_match_fast_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      int32_t* __restrict__ pk, int blk, int nwords,
                      int nwin, int probes) {
  extern __shared__ uint32_t smem[];
  __shared__ int part[33];
  uint32_t* words = smem;
  uint32_t* hist = smem + nwords;
  uint16_t* s = reinterpret_cast<uint16_t*>(hist + kRadixHistWords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, blk);
  const Window W{words, n};
  ZL4_STOP_AFTER(1, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = words[t % nwords])

  // order by s0 alone, ties by position: within a group of equal 4-byte
  // strings the rows before t are the nearest previous occurrences
  sort_words(W, s, blk, hist, part, 1);
  ZL4_STOP_AFTER(2, for (int t = threadIdx.x; t < blk; t += blockDim.x)
                        out[t] = s[t])
  for (int t = threadIdx.x; t < blk; t += blockDim.x)
    out[s[t]] = pack(nearest(W, s, t, probes, nwin));
}

// Row p (< blk) stays a match row after the two-step lazy deferral
// (jax_block.py:684-710; lazy = HC only); ld(q) reads M[q].
template <class Ld>
__device__ __forceinline__ bool match_keep(Ld ld, int p, int blk, int lazy) {
  int m[5];
  bool im[5];
  for (int k = 0; k < 5; ++k) {
    const int v = p + k < blk ? ld(p + k) : 0;
    m[k] = v & kMlMask;
    im[k] = (v & kImBit) != 0;
  }
  const bool g1 = im[1] && m[1] > m[0] + 1;
  const bool g2 = im[2] && m[2] > m[0] + 2;
  const bool d0_1 = (im[2] && m[2] > m[1] + 1) || (im[3] && m[3] > m[1] + 2);
  const bool d0_2 = (im[3] && m[3] > m[2] + 1) || (im[4] && m[4] > m[2] + 2);
  const bool defer =
      lazy && im[0] && ((g1 && !d0_1) || (g2 && !d0_2 && (d0_1 || !im[1])));
  return im[0] && !defer;
}

// The lazy deferral into the bit mask of the final match rows.
__device__ void match_mask(const int32_t* M, int blk, int lazy,
                           uint32_t* imask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int base = warp * 32; base < blk; base += kParseThreads) {
    const int p = base + lane;
    const bool keep =
        p < blk && match_keep([&](int q) { return M[q]; }, p, blk, lazy);
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) imask[base >> 5] = bits;
  }
  __syncthreads();
}

// The same over a slice of the spread route; the next slice's first rows
// were written by another CTA before a cluster barrier (L2 reads).
__device__ void match_mask_slice(const Slice& s, const int32_t* M, int lazy,
                                 uint32_t* imask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int w = warp; w < s.nwl; w += kSpreadWarps) {
    const int p = ((s.wlo + w) << 5) + lane;
    const bool keep = p < s.blk && match_keep([&](int q) {
                        return __ldcg(M + q);
                      }, p, s.blk, lazy);
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) imask[w] = bits;
  }
  __syncthreads();
}

// Entry i of enc_parse_emit's list: chosen row L[i] with its final length
// and its candidate's offset and back count.
struct ParseEntries {
  const int32_t* L;
  const int32_t* M;
  Fields F;
  __device__ __forceinline__ Entry operator()(int i) const {
    const int p = L[i];
    return {p, p + (M[p] & kMlMask), p - F.cand(p), F.pk[p] & 3};
  }
};

// The same on the spread route, whose list and lengths other CTAs of the
// cluster wrote (L2 reads).
struct SpreadEntries {
  const int32_t* L;
  const int32_t* M;
  Fields F;
  __device__ __forceinline__ Entry operator()(int i) const {
    const int p = __ldcg(L + i);
    return {p, p + (__ldcg(M + p) & kMlMask), p - F.cand(p), F.pk[p] & 3};
  }
};

__global__ void __launch_bounds__(kParseThreads)
enc_parse_emit_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ pk, int32_t* __restrict__ mlw,
                      int32_t* __restrict__ runs, uint8_t* __restrict__ out,
                      int32_t* __restrict__ out_len, int blk, int cap,
                      int runcap, int capped_ml, int lazy) {
  extern __shared__ uint32_t sm[];
  __shared__ int tmp[kParseThreads / 32];
  __shared__ int s_walk[4];
  const int nw = (blk + 31) >> 5;
  uint32_t* mask = sm;                         // boundaries, then match rows
  int* nxt = reinterpret_cast<int*>(sm + nw);  // the next set bit after a word
  int* buf = nxt + nw;                         // the walk's staged spans
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const uint8_t* row = data + (size_t)b * blk;
  const Fields F{pk + (size_t)b * blk, n, blk, capped_ml, 0};
  int32_t* M = mlw + (size_t)b * blk;
  int32_t* L = runs + (size_t)b * runcap;  // chosen rows, blk / 4 + 1
  int32_t* R = L + blk / 4 + 1;            // literal runs (src, dst, len)
  uint8_t* o = out + (size_t)b * cap;

  chain_lengths_par(F, start, M, mask, nxt, tmp);
  ZL4_STOP_AFTER(1, )
  match_mask(M, blk, lazy, mask);
  next_after_words(mask, nw, blk, nxt, tmp);
  ZL4_STOP_AFTER(2, for (int w = tid; w < nw; w += kParseThreads)
                        L[w] = nxt[w])
  const int cnt = n > start ? greedy_walk(M, mask, nxt, blk, buf, L, s_walk)
                            : 0;
  ZL4_STOP_AFTER(3, )

  emit_entries(ParseEntries{L, M, F}, cnt, row, n, start, o, cap, R,
               out_len + b, tmp);
}

// enc_parse_emit's spread route: one window a cluster of C CTAs of
// kSpreadThreads threads, its rows in C slices (parse_cluster.cuh).
__global__ void __launch_bounds__(kSpreadThreads, 1)
enc_parse_emit_spread_kernel(const uint8_t* __restrict__ data,
                             const int32_t* __restrict__ lens,
                             const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ pk,
                             int32_t* __restrict__ mlw,
                             int32_t* __restrict__ runs,
                             uint8_t* __restrict__ out,
                             int32_t* __restrict__ out_len, int blk, int cap,
                             int runcap, int capped_ml, int lazy) {
  extern __shared__ uint32_t sm[];
  __shared__ SpreadShared sh;
  const Slice s = make_slice(blk);
  // the slice's mask (boundaries, then match rows) and the next set bit
  // after each of its words; each row's successor; the speculative path
  // and each row's place on it
  uint32_t* mask = sm;
  int* nxt = reinterpret_cast<int*>(sm + s.wpc);
  int* succ = nxt + s.wpc;
  int* spec = succ + 32 * s.wpc;
  uint16_t* on = reinterpret_cast<uint16_t*>(spec + 8 * s.wpc + 1);
  const int b = blockIdx.x / s.C;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const uint8_t* row = data + (size_t)b * blk;
  const Fields F{pk + (size_t)b * blk, n, blk, capped_ml, 0};
  int32_t* M = mlw + (size_t)b * blk;
  int32_t* L = runs + (size_t)b * runcap;  // chosen rows, blk / 4 + 1
  int32_t* R = L + blk / 4 + 1;            // literal runs (src, dst, len)
  uint8_t* o = out + (size_t)b * cap;

  chain_cluster(s, F, start, M, mask, nxt, sh);
  cg::this_cluster().sync();  // every length, before the next slice's reads
  ZL4_SPREAD_STOP(1, )
  match_mask_slice(s, M, lazy, mask);
  next_after_cluster(s, mask, nxt, sh, &sh.first[1]);
  cg::this_cluster().sync();  // every slice's mask, before the successors
  ZL4_SPREAD_STOP(2, for (int w = threadIdx.x; w < s.nwl; w += kSpreadThreads)
                         L[s.wlo + w] = nxt[w])
  const int cnt = walk_cluster(s, M, mask, nxt, succ, spec, on, L, sh);
  ZL4_SPREAD_STOP(3, )

  emit_cluster(s, SpreadEntries{L, M, F}, cnt, row, n, start, o, cap, R,
               out_len + b, sh);
}

unsigned raised_spread;  // devices whose spread-route limits are raised

// The spread route's launch of B windows of blk rows in clusters of C CTAs.
cudaError_t spread_launch(int B, int blk, int C, void* stream,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  return cluster_launch(enc_parse_emit_spread_kernel, &raised_spread,
                        spread_smem(kSpreadMaxRows / 32), B, C,
                        kSpreadThreads, spread_smem(spread_words(blk, C)),
                        stream, cfg, attr);
}

}  // namespace

extern "C" int zl4_enc_match(const void* data, const void* lens, void* pk,
                             int B, int blk, int hc, void* stream) {
  if (B <= 0 || blk <= 0 || blk > kRadixMaxRows || hc < 1)
    return (int)cudaErrorInvalidValue;
  // the window words, the passes' histograms and the u16 order
  const int nwords = window_words(blk);
  const size_t smem = ((size_t)nwords + kRadixHistWords) * 4 +
                      (size_t)blk * 2;
  cudaError_t err = cudaFuncSetAttribute(
      enc_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_match_kernel<<<B, kRadixThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)pk, blk, nwords,
      hc);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_match_fast(const void* data, const void* lens,
                                  void* pk, int B, int blk, int nwin,
                                  int probes, void* stream) {
  if (B <= 0 || blk <= 0 || blk > kRadixMaxRows || nwin < 1 ||
      nwin > kMaxW || probes < 1)
    return (int)cudaErrorInvalidValue;
  // enc_match's layout: the window words, the passes' histograms and the
  // u16 order over the blk rows
  const int nwords = window_words(blk);
  const size_t smem = ((size_t)nwords + kRadixHistWords) * 4 +
                      (size_t)blk * 2;
  cudaError_t err = cudaFuncSetAttribute(
      enc_match_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_match_fast_kernel<<<B, kRadixThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)pk, blk, nwords,
      nwin, probes);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_parse_emit(const void* data, const void* lens,
                                  const void* starts, const void* pk, void* mlw,
                                  void* runs, void* out, void* out_len, int B,
                                  int blk, int cap, int runcap, int capped_ml,
                                  int lazy, int C, void* stream) {
  // runcap: ints per window of ``runs``: the chosen rows, then the literal
  // runs, 3 ints each.  A window has at most blk / 4 + 1 chosen rows (each
  // match covers >= 4 bytes), so at most blk / 4 + 2 runs.  Windows over
  // 64 KB (enc_match_wide's) are taken up to the candidate pack's 2^19:
  // the 20-bit length field (kMlMask) holds any ml < blk.  C: 1, one CTA
  // of kParseThreads a window, or the spread route's CTAs a window.
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) ||
      runcap < (blk / 4 + 1) + 3 * (blk / 4 + 2) ||
      (C != 1 && !spread_shape_ok(blk, C)))
    return (int)cudaErrorInvalidValue;
  if (C > 1) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = spread_launch(B, blk, C, stream, &cfg, &attr);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(
        &cfg, enc_parse_emit_spread_kernel, (const uint8_t*)data,
        (const int32_t*)lens, (const int32_t*)starts, (const int32_t*)pk,
        (int32_t*)mlw, (int32_t*)runs, (uint8_t*)out, (int32_t*)out_len, blk,
        cap, runcap, capped_ml, lazy);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  // the two masks' words: the mask, the next set bit after each word; the
  // walk's two staged spans
  const int nw = (blk + 31) / 32;
  const size_t smem = (2 * (size_t)nw + 2 * kStage) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      enc_parse_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  enc_parse_emit_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const int32_t*)starts,
      (const int32_t*)pk, (int32_t*)mlw, (int32_t*)runs, (uint8_t*)out,
      (int32_t*)out_len, blk, cap, runcap, capped_ml, lazy);
  return (int)cudaGetLastError();
}

// The spread route's shape for blk-row windows in clusters of C CTAs on the
// current device: out[0] bytes of shared memory a CTA, out[1] the clusters
// the card holds at once (cudaOccupancyMaxActiveClusters; 0 means the
// shape cannot be scheduled).
extern "C" int zl4_enc_parse_emit_shape(int blk, int C, int* out) {
  if (blk <= 0 || blk >= (1 << 19) || !spread_shape_ok(blk, C))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = spread_launch(1, blk, C, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)cfg.dynamicSmemBytes;
  return (int)cudaOccupancyMaxActiveClusters(&out[1],
                                             enc_parse_emit_spread_kernel,
                                             &cfg);
}
