// LZ4 block encoder, levels 0-9: match finding in windows over 64 KB.
//
// Replaces: _encode_block of the JAX reference (ops/jax_block.py:200-1103)
// at deep=0 and 65,536 < blk, where device_encoder_supports (:160-169)
// holds: [dictionary | block] windows of up to 131,072 bytes, 256 KB
// blocks, and the 327,680-byte sub-span windows (64 KB history + 256 KB)
// that 1 MB and 4 MB frame blocks are encoded as (parallel/sharded.py,
// _SUB and _SUBH).  The reference's wide branch keeps idx and wb16 as two
// sort operands instead of one packed word (:268-272, pack_iw); the order
// is the same, since the position is the sort's last key.
//
// enc_match_wide (one 1024-thread block per window): the same semantics as
// enc_match (hc >= 1: the 12-byte grouping order, probes +-1..+-hc, the
// unsort as a store to the position, the fallback order (s0, i) with probes
// +1 and +2, taken only when strictly longer) and enc_match_fast (hc == 0:
// the order (s0, i), probes +1..+probes over nwin carried windows) of
// encode_block.cu.  What changes is where the state lives: a window of
// 327,680 bytes and its u32 order over N = 2^19 rows (2 MB) do not fit one
// block's shared memory, so
//   * the window words are built once into device scratch (words), where
//     the L1 and L2 serve the sort's key reads;
//   * the order is u32 in device scratch (order), sorted by the bitonic
//     network of sort_global.cuh: the stages whose stride fits an 8,192-row
//     shared-memory tile run there, the rest (21 of 190 at N = 2^19) are
//     passes over device memory.
// Output per position: the pack ((cand + 1) << 12) | (fine ml << 6) | back,
// which needs cand + 1 < 2^19; the wrapper and the entry point hold
// blk < 2^19.
// Bound: the sorts.  Every compare reads 4-12 key bytes of two rows from
// the window words, 190 stages of N / 2 compares (twice at hc >= 1), so
// the kernel is bound by those dependent loads and by instruction rate,
// not by the bytes it must move (each window once, 4 bytes out per
// position).

#include "encode_common.cuh"
#include "sort_global.cuh"

namespace {

constexpr int kWideTile = 8192;  // u32 rows of the shared-memory tile

__global__ void __launch_bounds__(kMatchThreads)
enc_match_wide_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens, uint32_t* order,
                      uint32_t* words, int32_t* __restrict__ pk, int blk,
                      int N, int nwords, int hc, int nwin, int probes) {
  extern __shared__ uint32_t tile[];
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const uint8_t* row = data + (size_t)b * blk;
  uint32_t* s = order + (size_t)b * N;
  uint32_t* wd = words + (size_t)b * nwords;
  int32_t* out = pk + (size_t)b * blk;
  const int tn = min(kWideTile, N);

  // the window as zero-padded LE words, and the identity order
  for (int q = threadIdx.x; q < nwords; q += blockDim.x) {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * q + k;
      if (p < n) v |= (uint32_t)row[p] << (8 * k);
    }
    wd[q] = v;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) s[i] = i;
  __syncthreads();
  const Window W{wd, n};

  if (!hc) {
    bitonic_sort_global(s, N, tile, tn, LessS0{W, blk});
    for (int t = threadIdx.x; t < blk; t += blockDim.x)
      out[s[t]] = pack(nearest(W, s, t, probes, nwin));
    return;
  }

  bitonic_sort_global(s, N, tile, tn, Less12{W, blk});
  for (int t = threadIdx.x; t < blk; t += blockDim.x)
    out[s[t]] = pack(nearest_both(W, s, t, blk, hc));
  __syncthreads();

  // positional fallback: order by s0 alone, probes +1 and +2
  for (int i = threadIdx.x; i < N; i += blockDim.x) s[i] = i;
  __syncthreads();
  bitonic_sort_global(s, N, tile, tn, LessS0{W, blk});
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    const Cand c = nearest(W, s, t, 2, kMaxW);
    if (c.ml > ((out[p] >> 6) & 63)) out[p] = pack(c);
  }
}

}  // namespace

extern "C" int zl4_enc_match_wide(const void* data, const void* lens,
                                  void* order, void* words, void* pk, int B,
                                  int blk, int N, int nwords, int hc,
                                  int nwin, int probes, void* stream) {
  // order: u32[B, N] with N the power of two >= blk; words:
  // u32[B, (blk + kPad) / 4 + 1]; hc >= 1 takes all kMaxW windows
  const MatchShape m = match_shape(blk);
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) || N != m.N ||
      nwords != m.nwords || hc < 0 || nwin < 1 || nwin > kMaxW ||
      probes < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(N < kWideTile ? N : kWideTile) * 4;
  enc_match_wide_kernel<<<B, kMatchThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (uint32_t*)order,
      (uint32_t*)words, (int32_t*)pk, blk, N, nwords, hc, nwin, probes);
  return (int)cudaGetLastError();
}
