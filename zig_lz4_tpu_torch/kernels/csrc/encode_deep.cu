// LZ4 block encoder, levels 10-12: the deep finder, the price parse, and the
// extension, absorb and emission.
//
// Replaces: the deep branches of _encode_block of the JAX reference
// (ops/jax_block.py:200-1103 at deep = 1, 2, 3 with hc >= 1).  The TPU
// version builds exact ranks by sort + cumsum + unsort rounds, rides the tier
// operands through one grand sort, relaxes the price parse in 32-position
// chunks with one-hot reads, and repairs the parse with pooled gathers and
// scatter.  Here the same bytes come from three kernels:
//
// enc_deep_match (one 1024-thread block per window of up to 64 KB; in
//   shared memory the window words, the radix passes' histograms and the
//   u16 order, 224 KB at 64 KB, as in enc_match; the ranks in device
//   memory, 256 KB a window at 64 KB, which the L2 holds): the deep finder
//   of encode_deep.cuh, its sorts the stable byte passes of sort_radix.cuh
//   from the identity order, the position the last key:
//   * the 32-byte order (s0, at(p+4), ..., at(p+28), p): 32 passes over
//     window bytes, the last word first and each word from its low byte
//     up; s0's bytes are 0xFF on the rows past n - 4, every byte zero at
//     and past n;
//   * its class numbering (ranksN): each thread compares its run of up to
//     64 sorted rows with the row before, once a row, keeping the previous
//     key in registers and the class boundaries as a bit mask, then one
//     block scan of the counts; ranks count from 1;
//   * the rank orders (x[p + step k], k < nk, then p; x = -1 past the end)
//     in two passes a key over the bytes of x + 1, the last key first: 16
//     for the 256-byte rank (deep 3: r, step 32, 8 keys) and 16 for the
//     grand order at deep 2 (r, 8 keys), 8 at deep 1 (r, 4 keys) and deep
//     3 (r2, step 256, 4 keys).  Two bytes hold x + 1: the rows past n - 4
//     share one 32-byte key, and so at least the last three rows share one
//     class of either rank, which leaves at most blk - 2 <= 65,534 classes
//     (asserted where they are numbered).  A rank pass first writes its
//     digit byte for every position into the window words' space
//     (coalesced reads of the rank), so that the pass reads it from shared
//     memory; the window words are loaded again before the probes;
//   * the +-1..+-hc probes with the nested tier chain, then the positional
//     fallback: the order (s0, p) in 4 more passes, probes +1 and +2.
//   Level 12 sorts in 60 passes (10: 44, 11: 52).  Wider windows go to
//   enc_deep_match_wide (encode_deep_wide.cu), which runs the same steps
//   over a u32 order held by a thread-block cluster.
//   Bound: issue and latency of the passes (a shared-memory atomic, a
//   match and a scattered store a row a pass), the class numberings' and
//   probes' rank loads from the L2; not the bytes it must move.
//
// enc_deep_dp (one 256-thread block per window of up to 2^19 bytes):
//   1. chain extension with tier lengths and the capped-end bit
//      (:522-555), position-parallel (chain_lengths_par of
//      encode_common.cuh, as in enc_parse_emit), into the state words;
//   2. the backward price parse (run_dp, :556-683) by warp 0 alone, as the
//      reference relaxes it: chunks of 32 positions, one a lane, from the
//      last chunk down (the first one the warp takes is partial when 32
//      does not divide blk).  Within a chunk the literal chain collapses to
//      a suffix min over A[k] = price(k) + est[k + jmp] + 256 k
//      (five __shfl_down_sync), and the match edges that land inside the
//      chunk (jump >= 4, the 18-byte cut included) settle in at most 9
//      rounds: est reads at p + jmp and p + 18 come from a lane shuffle
//      inside the chunk and from a 1024-entry ring of exact costs in
//      shared memory beyond it, read once a chunk; the rounds stop when a
//      ballot shows that no lane an edge lands on (a mask made once a
//      chunk by __reduce_or_sync) changed its estimate, so a chunk whose
//      edges all leave it takes one round.  The fixpoint is the exact
//      backward DP
//        cost[i] = min(256 + cost[i+1], price(i) + cost[i + min(ml, 512)],
//                      768 + cost[i + 18] where ml > 18)
//      with cost = 0 past the window, and take (best <= lit, ties to the
//      match: the cost is best) and cut (the 18-byte cut strictly cheaper)
//      are read off the same costs.  The warp holds the next chunks' state
//      words in registers, kDpAhead chunks ahead, so no block barrier sits
//      on the chain; the other warps leave after step 1.  Costs stay below
//      256 * blk < 2^27, under the reference's INF_D = 2^28 (:582).
//   Output per position: ml (cut to 18 where the 18-byte cut won) | take
//   << 30 | cap_end << 29.  Shared memory: the chain's boundary mask and
//   next-boundary words, 2 ceil(blk / 32) words (16 KB at 64 KB, 80 KB at
//   327,680), and the ring.
//   Bound: the warp's chain of chunks, 2,048 a 64 KB window, each a few
//   dependent shuffles a round.
//
// enc_deep_emit (one 256-thread block per window of up to 2^19 bytes):
//   1. the take rows as a bit mask, by warp ballots over the state words,
//      and the next take row after each 32-row word (next_after_words);
//   2. the greedy parse (:716-743) by greedy_walk of encode_common.cuh, as
//      in enc_parse_emit: the warps stage each take row's successor (the
//      first take row at or after its end) into shared memory, 2,048 rows
//      at a time, and one thread follows the chain through them, one shared
//      load a chosen row; it lists the chosen rows in device scratch;
//   3. in tiles of 256 list entries, one a thread, with carries across
//      tiles: the pool (:774-792), a chosen row whose chain ends at a capped
//      row and whose exclusive rank among such rows (a block sum-scan) is
//      under P = 512 per 64 KB of window (min(512 * max(blk / 65536, 1),
//      blk)) -- the reference's first P by position; a pooled row's exact
//      extension, two rounds of four u32 compares at the match's own offset,
//      word indices clipped to the window, bytes zero past n (:774-819);
//      the running cover prevcov, the exclusive block max-scan of the
//      extended ends Ev = i + ml + e over EVERY chosen row, kept or dropped,
//      as the reference's code takes it (:842-844; a dropped row can raise
//      it by up to 3 bytes); keep (Ev - max(i, prevcov) >= 4) and move
//      (prevcov > i), a moved row kept only while its exclusive rank among
//      the moved rows is under P (:848-857); one sum-scan of
//      moved | keep << 16 gives both ranks, and the compaction writes each
//      kept row as an entry (p, e, off, back) -- (prevcov, Ev, off, 0) when
//      moved, (i, Ev, off, pk & 3) otherwise -- into device scratch;
//   4. the emission of enc_parse_emit over the entries (emit_entries of
//      encode_common.cuh): an entry merges into the previous kept one when
//      it starts at that one's end at the same offset; heads by a block
//      max-scan, sizes placed by a block sum-scan.
//   No loop over the chosen rows runs on one thread but the walk's, which
//   reads shared memory only.  Shared memory: the take mask and the next
//   take row after each word, 2 ceil(blk / 32) words, and the walk's two
//   staged spans (16 KB): 32 KB at 64 KB, 96 KB at 327,680.  Bound: the
//   walking thread's chain, a few tens of cycles a chosen row, and the
//   scattered loads of the state words and candidates of the chosen rows;
//   not the bytes it must move.
//
// Built with -DZL4_STOP=k (chip_smoke.py), enc_deep_match stops after phase
// k and stores what it left: 1 window words, 2 the 32-byte sort, 3 its
// class numbering, 4 the 256-byte rank's sort and 5 its numbering (deep 3;
// at deep 1 and 2 these two cuts stop where cut 3 does), 6 the grand sort,
// 7 the tier probes, 8 the s0 sort; 9 is the fallback probes.  Every cut
// also stops enc_deep_dp after its chain extension (step 1), and
// enc_deep_emit after step 1 (cut 1), after the walk (cut 2) or after the
// compaction (cuts 3-8); the emission is the rest.

#include <assert.h>

#include "encode_deep.cuh"
#include "sort_radix.cuh"

#ifdef ZL4_STOP
#define ZL4_STOP_AFTER(k, keep) \
  if (ZL4_STOP == (k)) {        \
    keep;                       \
    return;                     \
  }
#else
#define ZL4_STOP_AFTER(k, keep)
#endif

namespace {

constexpr int kDpRing = 1024;    // >= _DP_R + 32 entries, a power of two
constexpr int kDpR = 512;        // jumps are priced at min(ml, 512)
constexpr int kDpLit = 256;      // a literal's cost (the reference's LITC)
constexpr int kDpRounds = 9;     // KD / 4 + 1 relaxation rounds at most
constexpr int kDpAhead = 4;      // chunks of state words a lane holds
constexpr int kDpInf = 1 << 28;  // INF_D
constexpr int kExtPool = 512;    // pooled rows per 64 KB of window
constexpr int kExtBytes = 32;

// Extension pool rows of a blk-byte window: 512 per 64 KB (jax_block.py:774)
__host__ __device__ __forceinline__ int ext_pool(int blk) {
  const int P = kExtPool * (blk / 65536 > 1 ? blk / 65536 : 1);
  return P < blk ? P : blk;
}

// A radix digit staged in shared memory, by position.
struct ByteAt {
  const uint8_t* d;
  __device__ __forceinline__ unsigned operator()(int p) const { return d[p]; }
};

// The sorts of enc_deep_match are calls, not inlined: a pass then has the
// registers that the rest of the kernel keeps live across it (pointers,
// the window's geometry), and spills far less; inlined, the passes took
// about twice as long on the H100.

// The order of the window words (sort_words of sort_radix.cuh).
__device__ __noinline__ void sort_window(Window W, uint16_t* s, int rows,
                                         uint32_t* hist, int* part, int nw) {
  sort_words(W, s, rows, hist, part, nw);
}

// The order of the nk keys x[p + step k], k < nk, ties by position, from
// the identity order s[0, rows): two passes a key over the bytes of x + 1
// (x = -1 past the rows, so that -1 sorts first), the last key first.
// Each pass first stages its digit byte of every position in dig (rows
// bytes of shared memory), four positions a thread, the rank read
// coalesced.
__device__ __noinline__ void sort_ranks(const int32_t* x, int step, int nk,
                                        uint16_t* s, int rows, uint8_t* dig,
                                        uint32_t* hist, int* part) {
  uint32_t* dig4 = reinterpret_cast<uint32_t*>(dig);
#pragma unroll 1
  for (int i = 0; i < 2 * nk; ++i) {
    const int off = step * (nk - 1 - i / 2), sh = 8 * (i & 1);
    for (int q = threadIdx.x; 4 * q < rows; q += blockDim.x) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = 4 * q + k + off;
        const uint32_t x1 = p < rows ? (uint32_t)(x[p] + 1) : 0u;
        v |= ((x1 >> sh) & 0xFFu) << (8 * k);
      }
      dig4[q] = v;
    }
    __syncthreads();
    radix_pass(s, rows, hist, part, ByteAt{dig});
  }
}

// Number the classes of the sorted order s[0, rows) -- rows t - 1 and t
// are in one class when their eight key words are equal -- from 1 in
// sorted order, and store each row's number at its position (ranksN,
// jax_block.py:285-296).  A thread takes a run of up to 64 rows, keeps the
// previous row's key in registers and its class boundaries as a bit mask,
// so each row's key is read once; one block scan adds the runs' counts.
// part: 33 ints of shared memory.
template <class Key>
__device__ void block_ranks(const uint16_t* s, int rows, Key key,
                            int32_t* rank, int* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (rows + kRadixThreads - 1) / kRadixThreads;  // <= 64
  const int i0 = min(tid * chunk, rows), i1 = min(i0 + chunk, rows);
  uint32_t prev[8] = {};
  uint64_t bounds = 0;
  if (i0 < i1 && i0 > 0) {
    const int q = s[i0 - 1];
#pragma unroll
    for (int k = 0; k < 8; ++k) prev[k] = key(q, k);
  }
  for (int i = i0; i < i1; ++i) {
    const int p = s[i];
    bool same = i > 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t v = key(p, k);
      same &= v == prev[k];
      prev[k] = v;
    }
    bounds |= (uint64_t)!same << (i - i0);
  }
  const int cnt = __popcll(bounds);
  int x = cnt;  // inclusive scan of the run counts over the warp
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, k);
    if (lane >= k) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = part[lane];
    int y = v;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int z = __shfl_up_sync(0xFFFFFFFFu, y, k);
      if (lane >= k) y += z;
    }
    part[lane] = y - v;
    if (lane == 31) part[32] = y;  // the classes
  }
  __syncthreads();
  // the rank passes read x + 1 as two bytes: at most rows - 2 classes
  if (tid == 0) assert(rows < 3 || part[32] <= rows - 2);
  int run = part[warp] + x - cnt;
  for (int i = i0; i < i1; ++i) {
    run += (int)((bounds >> (i - i0)) & 1u);
    rank[s[i]] = run;
  }
  __syncthreads();
}

// One block an SM: with the minimum stated, ptxas takes the 64 registers a
// thread that 1024 threads allow, not 32.
__global__ void __launch_bounds__(kRadixThreads, 1)
enc_deep_match_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens, int32_t* ranks,
                      int32_t* __restrict__ pk, int blk, int nwords, int hc,
                      int deep) {
  extern __shared__ uint32_t smem[];
  __shared__ int part[33];
  uint32_t* words = smem;
  uint32_t* hist = smem + nwords;
  uint16_t* s = reinterpret_cast<uint16_t*>(hist + kRadixHistWords);
  // the rank passes' digits, in the window words' space
  uint8_t* dig = reinterpret_cast<uint8_t*>(words);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const uint8_t* row = data + (size_t)b * blk;
  int32_t* r = ranks + (size_t)b * (deep == 3 ? 2 : 1) * blk;
  int32_t* r2 = r + blk;  // deep == 3 only
  int32_t* out = pk + (size_t)b * blk;
  const Window W{words, n};
#define ZL4_KEEP(value) \
  for (int t = threadIdx.x; t < blk; t += blockDim.x) out[t] = (value)
  load_window(row, n, words, nwords, s, blk);
  ZL4_STOP_AFTER(1, ZL4_KEEP(words[t % nwords]))

  // 32-byte rank: order by (s0, at(p+4), ..., at(p+28)), then number
  sort_window(W, s, blk, hist, part, 8);
  ZL4_STOP_AFTER(2, ZL4_KEEP(s[t]))
  block_ranks(s, blk, Key32{W}, r, part);
  ZL4_STOP_AFTER(3, ZL4_KEEP(r[t]))

  if (deep == 3) {  // 256-byte rank over r[i], r[i+32], ..., r[i+224]
    identity_order(s, blk);
    sort_ranks(r, 32, 8, s, blk, dig, hist, part);
  }
  ZL4_STOP_AFTER(4, ZL4_KEEP(s[t]))
  if (deep == 3) block_ranks(s, blk, KeyRanks{r, 32, blk}, r2, part);
  ZL4_STOP_AFTER(5, ZL4_KEEP(deep == 3 ? r2[t] : r[t]))

  // grand order by the last NK tier operands, ties by position
  identity_order(s, blk);
  if (deep == 3) sort_ranks(r2, 256, 4, s, blk, dig, hist, part);
  else sort_ranks(r, 32, deep == 2 ? 8 : 4, s, blk, dig, hist, part);
  ZL4_STOP_AFTER(6, ZL4_KEEP(s[t]))
  load_words(row, n, words, nwords);  // the digits overwrote them
  __syncthreads();
  const Tiers T{r, r2, blk, deep};
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    out[p] = tier_pack(W, T, s, t, p, blk, hc);
  }
  __syncthreads();
  ZL4_STOP_AFTER(7, )

  // positional fallback: order by s0 alone, probes +1 and +2; it must beat
  // the total ml, and clears the tier
  identity_order(s, blk);
  sort_window(W, s, blk, hist, part, 1);
  ZL4_STOP_AFTER(8, ZL4_KEEP(s[t]))
#undef ZL4_KEEP
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    const Cand c = nearest(W, s, t, 2, kMaxW);
    if (c.ml > total_ml(out[p], deep)) out[p] = pack(c);
  }
}

// One chunk [lo, hi) of the price parse by the warp, a position a lane:
// v is the lane's state word after the chain extension, carry the exact
// cost at hi (0 past the window), ring the exact costs beyond the chunk.
// Stores the lane's state word and its exact cost; returns the cost at lo.
__device__ __forceinline__ int dp_chunk(int32_t* M, int* ring, int lo, int hi,
                                        int v, int carry, int R) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31, p = lo + lane, m = hi - lo;
  const bool im = lane < m && (v & kImBit);
  int ml = v & kMlMask;
  const int jmp = min(ml, R);
  const int esc = jmp - 4 >= 15 ? 1 + max(jmp - 19, 0) / 255 : 0;
  const int price = kDpLit * (3 + esc);
  const bool tr = im && R >= 18 && jmp > 18;  // the 18-byte cut is priced
  const bool inj = im && p + jmp < hi, in18 = tr && p + 18 < hi;
  const int far = im && !inj ? ring[(p + jmp) & (kDpRing - 1)] : 0;
  const int far18 = tr && !in18 ? ring[(p + 18) & (kDpRing - 1)] : 0;
  const int sj = min(lane + jmp, 31), s18 = min(lane + 18, 31);
  // the lanes an edge lands on: only their estimates feed the next round
  const unsigned targets = __reduce_or_sync(
      kAll, (inj ? 1u << sj : 0u) | (in18 ? 1u << s18 : 0u));
  const int T = m * kDpLit + carry;  // all literals to hi
  const int kl = lane * kDpLit;
  int est = T - kl, ej = 0, e18 = 0;
#pragma unroll 1
  for (int round = 0; round < kDpRounds; ++round) {
    ej = __shfl_sync(kAll, est, sj);
    e18 = __shfl_sync(kAll, est, s18);
    int a = kDpInf;
    if (im) {
      a = price + (inj ? ej : far);
      if (tr) a = min(a, 3 * kDpLit + (in18 ? e18 : far18));
      a += kl;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // suffix min over the lanes
      const int x = __shfl_down_sync(kAll, a, o);
      if (lane + o < 32) a = min(a, x);
    }
    const int nv = min(a, T) - kl;
    const unsigned moved = __ballot_sync(kAll, nv != est) & targets;
    est = nv;
    if (!moved) break;  // the next round would read the same estimates
  }
  // est is exact, and so are ej and e18 where an edge lands in the chunk
  // (no target moved in the last round); est = min(best, 256 + est[k+1]),
  // so the match is taken where it is the cost (ties to the match)
  if (lane < m) {
    int w = v;
    if (im) {
      const int a_full = price + (inj ? ej : far);
      const int a_tr = 3 * kDpLit + (in18 ? e18 : far18);
      const bool cut = tr && a_tr < a_full;  // only when strictly cheaper
      const bool take = (cut ? a_tr : a_full) == est;
      if (cut) ml = min(ml, 18);
      w = ml | (take ? kImBit : 0) |
          ((v & kCapEndBit) && !cut ? kCapEndBit : 0);
    }
    ring[p & (kDpRing - 1)] = est;
    M[p] = w;
  }
  __syncwarp();
  return __shfl_sync(kAll, est, 0);
}

__global__ void __launch_bounds__(kParseThreads)
enc_deep_dp_kernel(const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ pk, int32_t* st, int blk,
                   int capped_ml, int deep) {
  extern __shared__ uint32_t bnd[];  // then nxt: ceil(blk / 32) words each
  __shared__ int tmp[kParseThreads / 32];
  __shared__ int ring[kDpRing];
  const int b = blockIdx.x;
  const int nw = (blk + 31) >> 5;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const Fields F{pk + (size_t)b * blk, n, blk, capped_ml, deep};
  int32_t* M = st + (size_t)b * blk;

  chain_lengths_par(F, start, M, bnd, reinterpret_cast<int*>(bnd + nw), tmp);
#ifdef ZL4_STOP
  return;
#endif
  if (threadIdx.x >= 32) return;  // warp 0 runs the price parse

  const int lane = threadIdx.x;
  for (int k = lane; k < kDpRing; k += 32) ring[k] = 0;
  __syncwarp();
  const int R = min(kDpR, blk);
  const int top = (blk - 1) >> 5;  // the last chunk, maybe partial
  int ahead[kDpAhead];  // state words of chunks top - a, top - a - kDpAhead..
#pragma unroll
  for (int a = 0; a < kDpAhead; ++a) {
    const int p = ((top - a) << 5) + lane;
    ahead[a] = top - a >= 0 && p < blk ? M[p] : 0;
  }
  int carry = 0;
#pragma unroll 1
  for (int c0 = top; c0 >= 0; c0 -= kDpAhead) {
#pragma unroll
    for (int a = 0; a < kDpAhead; ++a) {
      const int c = c0 - a;
      if (c < 0) break;
      const int v = ahead[a];
      if (c - kDpAhead >= 0) ahead[a] = M[((c - kDpAhead) << 5) + lane];
      carry = dp_chunk(M, ring, c << 5, min((c << 5) + 32, blk), v, carry, R);
    }
  }
}

// Exact extension of the pooled end E of a match at offset off
// (jax_block.py:774-819): up to kExtBytes bytes, two rounds of four LE u32
// compares; word indices clip to the window, bytes read zero past n, and
// the extension stops 5 bytes before n.
__device__ __forceinline__ int extend_end(const uint8_t* row, int n, int blk,
                                          int E, int off) {
  auto word = [&](int j) {
    j = min(max(j, 0), blk - 1);
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k)
      if (j + k < n) v |= (uint32_t)row[j + k] << (8 * k);
    return v;
  };
  const int capv = min(max(n - 5 - E, 0), kExtBytes);
  int e = 0;
  bool alive = capv > 0;
  for (int round = 0; round < kExtBytes / 16; ++round) {
    const int base = E + e;
    int adv = 0;
    bool still = true;
    for (int w = 0; w < 4; ++w) {
      const uint32_t x = word(base + 4 * w) ^ word(base - off + 4 * w);
      if (still) adv += x == 0 ? 4 : (__ffs(x) - 1) >> 3;
      still = still && x == 0;
    }
    adv = alive ? min(adv, capv - e) : 0;
    e += adv;
    alive = alive && still && e < capv;
  }
  return e;
}

// Entry i of enc_deep_emit's compacted list.
struct DeepEntries {
  const int4* X;
  __device__ __forceinline__ Entry operator()(int i) const {
    const int4 v = X[i];
    return {v.x, v.y, v.z, v.w};
  }
};

__global__ void __launch_bounds__(kParseThreads)
enc_deep_emit_kernel(const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ pk,
                     const int32_t* __restrict__ st,
                     int32_t* __restrict__ chosen, int4* __restrict__ ents,
                     int32_t* __restrict__ runs, uint8_t* __restrict__ out,
                     int32_t* __restrict__ out_len, int blk, int cap,
                     int runcap, int chcap) {
  extern __shared__ uint32_t sm[];
  __shared__ int tmp[kParseThreads / 32];
  __shared__ int s_walk[4];
  const int nw = (blk + 31) >> 5;
  uint32_t* mask = sm;                         // the take rows
  int* nxt = reinterpret_cast<int*>(sm + nw);  // the next take row after a word
  int* buf = nxt + nw;                         // the walk's staged spans
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const uint8_t* row = data + (size_t)b * blk;
  const Fields F{pk + (size_t)b * blk, n, blk, 0, 0};
  const int32_t* M = st + (size_t)b * blk;
  int32_t* L = chosen + (size_t)b * chcap;  // the chosen rows
  int4* X = ents + (size_t)b * chcap;       // the kept entries
  int32_t* R = runs + (size_t)b * runcap;   // literal runs (src, dst, len)
  uint8_t* o = out + (size_t)b * cap;

  // --- 1. the take rows as a mask, the next take row after each word
#pragma unroll 4
  for (int base = warp * 32; base < blk; base += kParseThreads) {
    const int p = base + lane;
    const unsigned bits =
        __ballot_sync(0xFFFFFFFFu, p < blk && (M[p] & kImBit) != 0);
    if (lane == 0) mask[base >> 5] = bits;
  }
  __syncthreads();
  next_after_words(mask, nw, blk, nxt, tmp);
  ZL4_STOP_AFTER(1, for (int w = tid; w < nw; w += kParseThreads)
                        L[w] = nxt[w])

  // --- 2. the greedy parse: the chosen rows in L
  const int cnt = n > start ? greedy_walk(M, mask, nxt, blk, buf, L, s_walk)
                            : 0;
  ZL4_STOP_AFTER(2, )

  // --- 3. pool, extension, cover, keep and move, compaction; in tiles of
  // kParseThreads chosen rows, with the counts and the cover carried
  const int P = ext_pool(blk);
  int pooled_c = 0, cover_c = 0, moved_c = 0, keep_c = 0;
  for (int t0 = 0; t0 < cnt; t0 += kParseThreads) {
    const int k = t0 + tid;
    int i = 0, v = 0;
    if (k < cnt) {
      i = L[k];
      v = M[i];
    }
    const int ce = k < cnt && (v & kCapEndBit) ? 1 : 0;
    int tot;
    const int rank = pooled_c + block_scan(ce, tmp, SumOp{}, tot) - ce;
    pooled_c += tot;
    int Ev = 0, off = 0;
    if (k < cnt) {
      off = i - F.cand(i);
      Ev = i + (v & kMlMask);
      if (ce && rank < P) Ev += extend_end(row, n, blk, Ev, off);
    }
    int prevcov;
    block_scan(Ev, tmp, MaxOp{}, tot, &prevcov);
    prevcov = max(prevcov, cover_c);
    cover_c = max(cover_c, tot);
    const bool keep = k < cnt && Ev - max(i, prevcov) >= 4;
    const bool moved = keep && prevcov > i;
    int before;  // moved and kept rows before this one in the tile
    block_scan((int)moved | (int)keep << 16, tmp, SumOp{}, tot, &before);
    const int moved_before = moved_c + (before & 0xFFFF);
    if (keep && (!moved || moved_before < P)) {
      const int at = keep_c + (before >> 16) - max(moved_before - P, 0);
      X[at] = moved ? make_int4(prevcov, Ev, off, 0)
                    : make_int4(i, Ev, off, F.pk[i] & 3);
    }
    moved_c += tot & 0xFFFF;
    keep_c += tot >> 16;
  }
  const int kept = keep_c - max(moved_c - P, 0);
#if defined(ZL4_STOP) && ZL4_STOP >= 3
  return;
#endif
  __syncthreads();  // the entries are in X

  // --- 4. the emission over the kept entries
  emit_entries(DeepEntries{X}, kept, row, n, start, o, cap, R, out_len + b,
               tmp);
}

}  // namespace

extern "C" int zl4_enc_deep_match(const void* data, const void* lens,
                                  void* ranks, void* pk, int B, int blk,
                                  int hc, int deep, void* stream) {
  // ranks: scratch, int32[B, 1, blk] for the 32-byte rank, int32[B, 2, blk]
  // at deep == 3, which adds the 256-byte rank
  if (B <= 0 || blk <= 0 || blk > kRadixMaxRows || hc < 1 || deep < 1 ||
      deep > 3)
    return (int)cudaErrorInvalidValue;
  // the window words (at least blk bytes: the rank passes' digits go
  // there), the passes' histograms and the u16 order
  const int nwords = window_words(blk);
  const size_t smem = ((size_t)nwords + kRadixHistWords) * 4 +
                      (size_t)blk * 2;
  cudaError_t err = cudaFuncSetAttribute(
      enc_deep_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_deep_match_kernel<<<B, kRadixThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)ranks,
      (int32_t*)pk, blk, nwords, hc, deep);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_deep_dp(const void* lens, const void* starts,
                               const void* pk, void* st, int B, int blk,
                               int capped_ml, int deep, void* stream) {
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) || deep < 1 || deep > 3)
    return (int)cudaErrorInvalidValue;
  // the chain's boundary mask and next-boundary words
  const size_t smem = 2 * (size_t)((blk + 31) / 32) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      enc_deep_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_deep_dp_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)lens, (const int32_t*)starts, (const int32_t*)pk,
      (int32_t*)st, blk, capped_ml, deep);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_deep_emit(const void* data, const void* lens,
                                 const void* starts, const void* pk,
                                 const void* st, void* chosen, void* ents,
                                 void* runs, void* out, void* out_len, int B,
                                 int blk, int cap, int runcap, int chcap,
                                 void* stream) {
  // chosen: int32[B, chcap] scratch, the chosen rows (at most blk / 4 + 1:
  // each match covers >= 4 bytes); ents: int32[B, 4 chcap], the kept
  // entries (p, e, off, back), 16-byte aligned; runs: (src, dst, len) of
  // each long literal run, 3 ints a run, at most blk / 4 + 2 runs
  if (B <= 0 || blk <= 0 || blk >= (1 << 19) ||
      runcap < 3 * (blk / 4 + 2) || chcap < blk / 4 + 1 ||
      reinterpret_cast<uintptr_t>(ents) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // the take mask, the next take row after each of its words; the walk's
  // two staged spans
  const int nw = (blk + 31) / 32;
  const size_t smem = (2 * (size_t)nw + 2 * kStage) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      enc_deep_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  enc_deep_emit_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const int32_t*)starts,
      (const int32_t*)pk, (const int32_t*)st, (int32_t*)chosen, (int4*)ents,
      (int32_t*)runs, (uint8_t*)out, (int32_t*)out_len, blk, cap, runcap,
      chcap);
  return (int)cudaGetLastError();
}
