// The spread route of enc_parse_emit (encode_block.cu): one window's parse
// and emission over a thread-block cluster of C CTAs of kSpreadThreads
// threads, for a launch of few windows (torch_block.parse_spread_shape).
// Its phases are those of the one-CTA kernel and its bytes equal that
// kernel's:
//   * the window's rows are cut into C slices of whole 32-row mask words,
//     CTA r holding rows [r S, r S + S), S = 32 ceil(ceil(blk / 32) / C)
//     (the last slices may be short or empty); the chain boundaries, then
//     the match mask, of a slice and the next set bit after each of its
//     words live in that CTA's shared memory;
//   * the next set bit after a word (next_after_cluster) is
//     next_after_words' reverse min-scan over the CTA's threads, carried
//     across CTAs by a cluster reverse min-scan of each CTA's first set
//     bit; the chain extension and the lazy mask then run over the slice's
//     rows as in the one-CTA kernel;
//   * the greedy walk is split by slices.  Each CTA stages the successor
//     of each of its match rows (the first match row at or after its end,
//     read from whichever CTA's mask holds it, over distributed shared
//     memory) into its shared memory, and one thread walks the slice from
//     its first match row: a speculative path, as the true parse may enter
//     the slice at a later row.  Then one thread of CTA 0 follows the true
//     entry into each slice in order, through that slice's staged
//     successors, until it meets the slice's speculative path or leaves
//     the slice.  The successor is a function, so once the two meet they
//     stay together: the rows chosen are exactly greedy_walk's.  It lists
//     the rows before the meeting, and each CTA copies its speculative rows
//     from the meeting on after them;
//   * the emission (emit_cluster) cuts the list into C chunks, one a CTA,
//     and runs emit_entries' tiles (emit_tiles) over each; the head
//     max-scan and the size sum-scan carry across CTAs through cluster
//     scans of each CTA's last head and bytes, so a merged group that
//     straddles two chunks is written once, at the same offset.  The long
//     literal runs are counted in CTA 0's shared memory and copied by
//     every warp of the cluster.
// Data one CTA writes to device memory and another reads (the lengths, the
// list, the runs) is read after a cluster barrier through the L2 (__ldcg).

#pragma once

#include <cooperative_groups.h>

#include "encode_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kSpreadThreads = 1024;
constexpr int kSpreadWarps = kSpreadThreads / 32;
constexpr int kSpreadMaxCluster = 16;
constexpr int kSpreadMaxRows = 24576;  // rows a slice holds at most

struct MinOp {
  static constexpr int kId = 0x7FFFFFFF;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return min(a, b);
  }
};

// Mask words a slice of a blk-row window over C CTAs holds.
__host__ __device__ __forceinline__ int spread_words(int blk, int C) {
  return ((blk + 31) / 32 + C - 1) / C;
}

// Dynamic shared memory of a CTA whose slice holds wpc mask words (32 wpc
// rows): the mask and the next set bit after each of its words, each row's
// staged successor, the speculative path's rows (at most one in 4, and
// one), and each row's place on that path plus one (u16).
__host__ __device__ __forceinline__ size_t spread_smem(int wpc) {
  return 4 * ((size_t)2 * wpc + 32 * wpc + 8 * wpc + 1) + 2 * 32 * (size_t)wpc;
}

// A cluster shape the spread route takes for blk-row windows: C a power
// of two from 2 to 16 whose slices hold at most kSpreadMaxRows rows.
__host__ __device__ __forceinline__ bool spread_shape_ok(int blk, int C) {
  return C >= 2 && C <= kSpreadMaxCluster && (C & (C - 1)) == 0 &&
         32 * spread_words(blk, C) <= kSpreadMaxRows;
}

// The slice of the window's rows that this CTA holds.
struct Slice {
  int C, r;      // CTAs of the cluster, this CTA's rank
  int wpc;       // mask words a slice
  int wlo, nwl;  // the slice's first word and the words it holds
  int lo, hi;    // its rows [lo, hi)
  int blk;
};

__device__ __forceinline__ Slice make_slice(int blk) {
  cg::cluster_group cl = cg::this_cluster();
  Slice s;
  s.C = (int)cl.num_blocks();
  s.r = (int)cl.block_rank();
  s.blk = blk;
  const int nw = (blk + 31) >> 5;
  s.wpc = spread_words(blk, s.C);
  s.wlo = min(s.r * s.wpc, nw);
  s.nwl = min(s.wpc, nw - s.wlo);
  s.lo = min(s.wlo << 5, blk);
  s.hi = min((s.wlo + s.nwl) << 5, blk);
  return s;
}

// Scalars a CTA shares with the others of its cluster.
struct SpreadShared {
  int first[2];   // the slice's first set bit: boundaries, match rows
  int spec_cnt;   // rows of the slice's speculative path
  int spec_exit;  // its first row past the slice (blk: none)
  int base;       // from the fix-up: the slice's first place in the list,
  int nfix;       // the rows the fix-up listed for it,
  int sidx;       // and the first speculative row kept
  int total;      // CTA 0: rows in the list
  int head;       // the emission: the last head of the CTA's chunk,
  int size;       // the bytes of the groups that end in it,
  int olen;       // and the window's out_len
  int nlong;      // CTA 0: long literal runs listed
  int bcast;      // a value broadcast to the CTA's threads
  int tmp[kSpreadWarps];
};

// op over CTAs c0 <= c < c1 of the int at ``mine`` in each one's shared
// memory (Op::kId over none), on every thread of the CTA.
template <class Op>
__device__ int cluster_fold(int* mine, int c0, int c1, Op op, int* bcast) {
  if (threadIdx.x < 32) {
    const int c = c0 + (int)threadIdx.x;
    int v = c < c1 ? *cg::this_cluster().map_shared_rank(mine, c) : Op::kId;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = op(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    if (threadIdx.x == 0) *bcast = v;
  }
  __syncthreads();
  const int v = *bcast;
  __syncthreads();
  return v;
}

// nxt[w] = the first set bit of the cluster's mask in the words after the
// slice's word w (blk if there is none), for the slice's words: the
// reverse min-scan of next_after_words over this CTA's threads, and the
// first set bits of the CTAs after it (each CTA publishes its own in
// *first).
__device__ void next_after_cluster(const Slice& s, const uint32_t* mask,
                                   int* nxt, SpreadShared& sh, int* first) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int none = s.blk;
  const int run = (s.nwl + kSpreadThreads - 1) / kSpreadThreads;
  const int lo = min(tid * run, s.nwl), hi = min(lo + run, s.nwl);
  int v = none;  // min over this lane and the lanes after it
  for (int w = lo; w < hi; ++w)
    if (mask[w]) {
      v = ((s.wlo + w) << 5) + __ffs(mask[w]) - 1;
      break;
    }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane + o < 32) v = min(v, x);
  }
  if (lane == 0) sh.tmp[warp] = v;
  __syncthreads();
  if (tid == 0) {
    int m = none;
    for (int k = 0; k < kSpreadWarps; ++k) m = min(m, sh.tmp[k]);
    *first = m;
  }
  cg::this_cluster().sync();  // every CTA's first set bit published
  int after = __shfl_down_sync(0xFFFFFFFFu, v, 1);
  if (lane == 31) after = none;
  for (int k = warp + 1; k < kSpreadWarps; ++k) after = min(after, sh.tmp[k]);
  after = min(after, cluster_fold(first, s.r + 1, s.C, MinOp{}, &sh.bcast));
  for (int w = hi - 1; w >= lo; --w) {
    nxt[w] = after;
    if (mask[w]) after = ((s.wlo + w) << 5) + __ffs(mask[w]) - 1;
  }
  __syncthreads();
}

// The first set bit of the cluster's mask at or after row x < blk, read
// from the shared memory of the CTA whose slice holds x.
__device__ __forceinline__ int first_in_cluster(const Slice& s,
                                                const uint32_t* mask,
                                                const int* nxt, int x) {
  const int gw = x >> 5, c = gw / s.wpc, w = gw - c * s.wpc;
  uint32_t m;
  int nx;
  if (c == s.r) {
    m = mask[w];
    nx = nxt[w];
  } else {
    cg::cluster_group cl = cg::this_cluster();
    m = *cl.map_shared_rank(const_cast<uint32_t*>(mask) + w, c);
    nx = *cl.map_shared_rank(const_cast<int*>(nxt) + w, c);
  }
  const uint32_t bits = m & (0xFFFFFFFFu << (x & 31));
  return bits ? (gw << 5) + __ffs(bits) - 1 : nx;
}

// Chain extension and the n - 5 clamp (chain_lengths_par) over the slice's
// rows: M[p] = ml | is_match << 30 | cap_end << 29.  bnd and nxt: the
// slice's words.
__device__ void chain_cluster(const Slice& s, const Fields& F, int start,
                              int32_t* M, uint32_t* bnd, int* nxt,
                              SpreadShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // boundary rows (no link into the next row); row blk - 1 always is one
#pragma unroll 4
  for (int w = warp; w < s.nwl; w += kSpreadWarps) {
    const int p = ((s.wlo + w) << 5) + lane;
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, p < s.blk && !F.link(p));
    if (lane == 0) bnd[w] = bits;
  }
  __syncthreads();
  next_after_cluster(s, bnd, nxt, sh, &sh.first[0]);
  // chain_word looks a row's word up by its index in the window
  const uint32_t* gb = bnd - s.wlo;
  const int* gn = nxt - s.wlo;
  for (int p0 = s.lo + tid; p0 < s.hi; p0 += kBatch * kSpreadThreads) {
    int word[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kSpreadThreads;
      word[u] = p < s.hi ? chain_word(F, start, gb, gn, p) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kSpreadThreads;
      if (p < s.hi) M[p] = word[u];
    }
  }
}

// The greedy parse (greedy_walk's chain) over the cluster's match mask and
// the next set bits after its words: the staged successors (succ), the
// speculative path of each slice (spec, on), the fix-up by one thread of
// CTA 0, and the chosen rows listed in L in order.  Returns their count
// on every thread.  succ and on: the slice's 32 wpc rows; spec: 8 wpc + 1.
__device__ int walk_cluster(const Slice& s, const int32_t* M,
                            const uint32_t* mask, const int* nxt, int* succ,
                            int* spec, uint16_t* on, int32_t* L,
                            SpreadShared& sh) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  // each match row's successor; no row is on the path yet
#pragma unroll 4
  for (int p = s.lo + tid; p < s.hi; p += kSpreadThreads) {
    on[p - s.lo] = 0;
    if ((mask[(p >> 5) - s.wlo] >> (p & 31)) & 1u)
      succ[p - s.lo] = first_in_cluster(s, mask, nxt, p + (M[p] & kMlMask));
  }
  __syncthreads();
  // the speculative path from the slice's first match row
  if (tid == 0) {
    int p = s.nwl > 0 ? first_at_or_after(mask - s.wlo, nxt - s.wlo, s.lo)
                      : s.blk;
    int k = 0;
    while (p < s.hi) {
      on[p - s.lo] = (uint16_t)(k + 1);
      spec[k++] = p;
      p = succ[p - s.lo];
    }
    sh.spec_cnt = k;
    sh.spec_exit = p;
  }
  cl.sync();  // every slice's path, before the fix-up reads it
  // the true path into each slice in order, until it meets the slice's
  // speculative path or leaves the slice
  if (s.r == 0 && tid == 0) {
    int x = first_at_or_after(mask, nxt, 0);  // CTA 0 holds word 0
    int total = 0;
    for (int c = 0; c < s.C; ++c) {
      SpreadShared* o = cl.map_shared_rank(&sh, c);
      const int lo = min(c * s.wpc * 32, s.blk);
      const int hi = min(lo + s.wpc * 32, s.blk);
      const int cnt = o->spec_cnt;
      int nfix = 0, sidx = cnt;
      if (x < hi) {  // x >= lo: the entry, or the exit of the slice before
        const int* su = cl.map_shared_rank(succ, c);
        const uint16_t* oc = cl.map_shared_rank(on, c);
        int at;
        while ((at = oc[x - lo]) == 0) {
          L[total + nfix++] = x;
          x = su[x - lo];
          if (x >= hi) break;
        }
        if (x < hi) {  // met the path at its row at - 1
          sidx = at - 1;
          x = o->spec_exit;
        }
      }
      o->base = total;
      o->nfix = nfix;
      o->sidx = sidx;
      total += nfix + cnt - sidx;
    }
    sh.total = total;
  }
  cl.sync();  // the fix-up's rows listed and its places posted
  for (int j = sh.sidx + tid; j < sh.spec_cnt; j += kSpreadThreads)
    L[sh.base + sh.nfix + j - sh.sidx] = spec[j];
  const int total = *cl.map_shared_rank(&sh.total, 0);
  cl.sync();  // the list whole
  return total;
}

// Sequence emission of the cnt entries E(0), ..., E(cnt - 1) of one window
// over the cluster (emit_entries' bytes): chunk r of ceil(cnt / C) entries
// on CTA r, its first head and first byte carried from the chunks before;
// the tail by CTA C - 1, the long runs and the zeros past out_len by every
// warp of the cluster.  Writes *olen.
template <class Entries>
__device__ void emit_cluster(const Slice& s, const Entries& E, int cnt,
                             const uint8_t* row, int n, int start, uint8_t* o,
                             int cap, int32_t* R, int32_t* olen,
                             SpreadShared& sh) {
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int chunk = (cnt + s.C - 1) / s.C;
  const int a = min(s.r * chunk, cnt), b = min(a + chunk, cnt);
  int* nlong = cl.map_shared_rank(&sh.nlong, 0);
  if (s.r == 0 && tid == 0) sh.nlong = 0;  // read after two cluster barriers
  // the chunk's last head
  int hd = -1;
  for (int i = a + tid; i < b; i += kSpreadThreads)
    if (i == 0 || !continues(E(i - 1), E(i))) hd = i;
  int tot;
  block_scan<MaxOp, kSpreadThreads>(hd, sh.tmp, MaxOp{}, tot);
  if (tid == 0) sh.head = tot;
  cl.sync();
  const int carry_head = cluster_fold(&sh.head, 0, s.r, MaxOp{}, &sh.bcast);
  // the bytes of the groups that end in the chunk, then the groups
  const int size = emit_tiles<false, kSpreadThreads>(
      E, a, b, cnt, start, carry_head, 0, row, o, R, nlong, sh.tmp);
  if (tid == 0) sh.size = size;
  cl.sync();
  const int q0 = cluster_fold(&sh.size, 0, s.r, SumOp{}, &sh.bcast);
  emit_tiles<true, kSpreadThreads>(E, a, b, cnt, start, carry_head, q0, row,
                                   o, R, nlong, sh.tmp);
  if (s.r == s.C - 1 && tid == 0) {  // the tail after every group
    const int q = write_tail(E, cnt, row, n, start, o, q0 + size, R, nlong);
    *olen = q;
    for (int c = 0; c < s.C; ++c) *cl.map_shared_rank(&sh.olen, c) = q;
  }
  cl.sync();  // every run listed, out_len posted
  const int nl = *nlong, lane = tid & 31;
  for (int r = s.r * kSpreadWarps + (tid >> 5); r < nl;
       r += s.C * kSpreadWarps) {
    const int src = __ldcg(R + 3 * r), dst = __ldcg(R + 3 * r + 1);
    const int len = __ldcg(R + 3 * r + 2);
    for (int k = lane; k < len; k += 32) o[dst + k] = row[src + k];
  }
  for (int k = sh.olen + s.r * kSpreadThreads + tid; k < cap;
       k += s.C * kSpreadThreads)
    o[k] = 0;
  cl.sync();  // CTA 0's count is read up to here
}

}  // namespace
