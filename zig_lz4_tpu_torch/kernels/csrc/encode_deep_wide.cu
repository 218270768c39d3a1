// LZ4 block encoder, levels 10-12: the deep finder in windows over 64 KB.
//
// Replaces: the deep finder of _encode_block of the JAX reference
// (ops/jax_block.py:274-516 at deep = 1, 2, 3 with hc >= 1) at 65,536 < blk,
// where device_encoder_supports (:160-169) holds: [dictionary | block]
// windows of up to 131,072 bytes, 256 KB blocks, and the 327,680-byte
// sub-span windows (64 KB history + 256 KB) that 1 MB and 4 MB frame blocks
// are encoded as (parallel/sharded.py, _SUB and _SUBH).  The reference's wide
// branch carries idx and wb16 as two sort operands instead of one packed word
// (:268-272, pack_iw); the order is the same, since its sorts are stable and
// the position is the last key here.
//
// enc_deep_match_wide (one 1024-thread block per window): the deep finder of
// encode_deep.cuh, as enc_deep_match runs it -- the 32-byte rank, at deep = 3
// the 256-byte rank, the grand grouping sort, the probes with the nested tier
// chain, the positional fallback.  What changes is where the state lives, as
// enc_match_wide (encode_wide.cu) changed it for levels 0-9: a window of
// 327,680 bytes and its u32 order over N = 2^19 rows (2 MB) do not fit one
// block's shared memory, so
//   * the window words are built once into device scratch (words);
//   * the order is u32 in device scratch (order), sorted by the bitonic
//     network of sort_global.cuh, whose short strides run in 8,192-row
//     shared-memory tiles;
//   * the ranks are int32 in device scratch as at 64 KB: [B, 1, blk], or
//     [B, 2, blk] at deep = 3.
// Output per position: the pack ((cand + 1) << 12) | (fine ml << 6) |
// (tier << 2) | back, which needs cand + 1 < 2^19; the wrapper and the entry
// point hold blk < 2^19.
// Bound: the sorts -- three at deep 1 and 2, four at deep 3, 190 stages of
// N / 2 compares each at N = 2^19.  A compare reads up to 32 window bytes
// (the 32-byte rank, the fallback) or up to eight ranks (the 256-byte rank,
// the grand order) of two rows from device memory, so the kernel is bound by
// those dependent loads, not by the bytes it must move.

#include "encode_deep.cuh"
#include "sort_global.cuh"

namespace {

constexpr int kWideTile = 8192;  // u32 rows of the shared-memory tile

// The position order of a wide window: u32 in device scratch.
struct GlobalOrder {
  uint32_t* s;
  int N;
  uint32_t* tile;
  int tn;
  template <class Less>
  __device__ void operator()(Less less) const {
    bitonic_sort_global(s, N, tile, tn, less);
  }
  __device__ void identity() const {
    for (int i = threadIdx.x; i < N; i += blockDim.x) s[i] = i;
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kMatchThreads)
enc_deep_match_wide_kernel(const uint8_t* __restrict__ data,
                           const int32_t* __restrict__ lens, uint32_t* order,
                           uint32_t* words, int32_t* ranks,
                           int32_t* __restrict__ pk, int blk, int N,
                           int nwords, int hc, int deep) {
  extern __shared__ uint32_t tile[];
  __shared__ int part[kMatchThreads];
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const uint8_t* row = data + (size_t)b * blk;
  uint32_t* wd = words + (size_t)b * nwords;
  int32_t* r = ranks + (size_t)b * (deep == 3 ? 2 : 1) * blk;
  const GlobalOrder sort{order + (size_t)b * N, N, tile, min(kWideTile, N)};

  // the window as zero-padded LE words, and the identity order
  for (int q = threadIdx.x; q < nwords; q += blockDim.x) {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * q + k;
      if (p < n) v |= (uint32_t)row[p] << (8 * k);
    }
    wd[q] = v;
  }
  sort.identity();
  deep_match(Window{wd, n}, sort, sort.s, blk, hc, deep, r, r + blk,
             pk + (size_t)b * blk, part);
}

}  // namespace

extern "C" int zl4_enc_deep_match_wide(const void* data, const void* lens,
                                       void* order, void* words, void* ranks,
                                       void* pk, int B, int blk, int N,
                                       int nwords, int hc, int deep,
                                       void* stream) {
  // order: u32[B, N] with N the power of two >= blk; words:
  // u32[B, (blk + kPad) / 4 + 1]; ranks: int32[B, 1, blk], or
  // int32[B, 2, blk] at deep == 3
  const MatchShape m = match_shape(blk);
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) || N != m.N ||
      nwords != m.nwords || hc < 1 || deep < 1 || deep > 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(N < kWideTile ? N : kWideTile) * 4;
  enc_deep_match_wide_kernel<<<B, kMatchThreads, smem,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (uint32_t*)order,
      (uint32_t*)words, (int32_t*)ranks, (int32_t*)pk, blk, N, nwords, hc,
      deep);
  return (int)cudaGetLastError();
}
