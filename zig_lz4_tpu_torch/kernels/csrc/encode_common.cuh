// Device code shared by the encoder kernels (encode_block.cu: levels 0-9,
// encode_deep.cu: levels 10-12, and the wide finders): the window in shared
// memory, the probe of one sorted neighbour (cand_at of the JAX reference,
// ops/jax_block.py:379-426) over an order that the radix passes of
// sort_radix.cuh or radix_cluster.cuh made, the candidate pack, the
// per-position fields of the parse, the position-parallel chain extension
// of enc_parse_emit and enc_deep_dp, and what enc_parse_emit and
// enc_deep_emit share: the block scans, the greedy walk through successors
// staged in shared memory, and the emission placed by block scans over a
// list of entries (emit_entries), whose sequences enc_parse_emit's spread
// route (parse_cluster.cuh) writes too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 8;         // u32 windows after s0 (jax_block.py:100)
constexpr int kPad = 64;         // zero bytes past blk (reads reach 4W+7)
constexpr int kParseThreads = 256;
constexpr int kImBit = 1 << 30;  // is_match / take flag beside ml
constexpr int kCapEndBit = 1 << 29;  // the row's chain ends at a capped row
constexpr int kMlMask = (1 << 20) - 1;

struct Window {
  const uint32_t* w;  // little-endian words, zero at and past n
  int n;

  // LE u32 of bytes p..p+3
  __device__ __forceinline__ uint32_t at(int p) const {
    return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
  }
  __device__ __forceinline__ uint32_t s0(int p) const {
    return p > n - 4 ? 0xFFFFFFFFu : at(p);
  }
  __device__ __forceinline__ uint32_t byte(int p) const {
    return p < 0 ? 0u : (w[p >> 2] >> ((p & 3) * 8)) & 0xFFu;
  }
};

struct Cand {
  int cand, ml, back;
};

// cand_at for sorted row p against neighbour q over nwin carried windows
// (jax_block.py:394-426)
__device__ __forceinline__ Cand probe(const Window& W, int p, int q,
                                      int nwin) {
  const int n = W.n;
  Cand r{-1, 0, 0};
  if (p > n - 4 || q > n - 4 || q >= p || p - q > 65535) return r;
  if (W.at(p) != W.at(q)) return r;
  int ml = 4;
  for (int k = 1; k <= nwin; ++k) {
    const uint32_t x = W.at(p + 4 * k) ^ W.at(q + 4 * k);
    if (x != 0) {
      ml += (__ffs(x) - 1) >> 3;  // equal low bytes, low byte first
      break;
    }
    ml += 4;
  }
  int back;
  if (W.byte(p - 1) != W.byte(q - 1)) back = 0;
  else if (W.byte(p - 2) != W.byte(q - 2)) back = 1;
  else back = 2;
  r.cand = q;
  r.ml = ml;
  r.back = back;
  return r;
}

__device__ __forceinline__ int pack(const Cand& c) {
  return c.cand >= 0 ? ((c.cand + 1) << 12) | (c.ml << 6) | c.back : 0;
}

// The identity order over the rows.
__device__ void identity_order(uint16_t* s, int rows) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) s[i] = (uint16_t)i;
  __syncthreads();
}

// The window as zero-padded LE words in shared memory.
__device__ void load_words(const uint8_t* row, int n, uint32_t* words,
                           int nwords) {
  for (int q = threadIdx.x; q < nwords; q += blockDim.x) {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * q + k;
      if (p < n) v |= (uint32_t)row[p] << (8 * k);
    }
    words[q] = v;
  }
}

// The window words, and the identity order over the rows.
__device__ void load_window(const uint8_t* row, int n, uint32_t* words,
                            int nwords, uint16_t* s, int rows) {
  load_words(row, n, words, nwords);
  identity_order(s, rows);
}

// Probes +1..+probes of sorted row t; a later probe wins only when
// strictly longer (jax_block.py:445, :500).  ``s`` is the sorted order:
// a pointer, or an accessor with operator[] (the wide finders').
template <class Order>
__device__ __forceinline__ Cand nearest(const Window& W, const Order& s,
                                        int t, int probes, int nwin) {
  Cand best{-1, 0, 0};
  const int p = s[t];
  for (int k = 1; k <= probes && k <= t; ++k) {
    const Cand c = probe(W, p, s[t - k], nwin);
    if (c.ml > best.ml) best = c;
  }
  return best;
}

// Probes +-1..+-hc of sorted row t over all kMaxW windows; ties on the
// length go to the larger (nearer) candidate (jax_block.py:432-450).
template <class Order>
__device__ __forceinline__ Cand nearest_both(const Window& W, const Order& s,
                                             int t, int blk, int hc) {
  Cand best{-1, 0, 0};
  const int p = s[t];
  for (int k = 1; k <= hc; ++k) {
    for (int side = 0; side < 2; ++side) {
      const int u = side ? t + k : t - k;
      if (u < 0 || u >= blk) continue;
      const Cand c = probe(W, p, s[u], kMaxW);
      if (c.ml > best.ml || (c.ml == best.ml && c.cand > best.cand)) best = c;
    }
  }
  return best;
}

// Length a rank tier proves (jax_block.py:307-321): 32-byte steps over the
// 32-byte rank, then at deep == 3 256-byte steps over the 256-byte rank
// from tier 8 on.  Tier 0 = none.
__device__ __forceinline__ int tier_len(int tier, int deep) {
  return deep == 3 && tier > 7 ? 256 * (tier - 7) : 32 * tier;
}

// Per-position fields of the parse, read from the candidate pack
// ((cand + 1) << 12) | (fine ml << 6) | (tier << 2) | back.
struct Fields {
  const int32_t* pk;
  int n, blk;
  int capped_ml;  // a fine ml from here on saturated the carried windows
  int deep;       // 0, or the deep configuration whose tiers pk carries

  __device__ __forceinline__ int cand(int p) const { return (pk[p] >> 12) - 1; }
  __device__ __forceinline__ bool valid(int p) const {
    return p < blk && p <= n - 13 && cand(p) >= 0;
  }
  __device__ __forceinline__ int mlf(int p) const { return (pk[p] >> 6) & 63; }
  // ml before the chain extension: the tier's length when it is longer
  __device__ __forceinline__ int ml0(int p) const {
    if (!valid(p)) return 0;
    return max(mlf(p), tier_len((pk[p] >> 2) & 15, deep));
  }
  // possibly underestimated: the windows saturated, or a tier gave ml
  __device__ __forceinline__ bool capped(int p) const {
    return valid(p) && (mlf(p) >= capped_ml || ml0(p) > mlf(p));
  }
  // row p continues a capped chain at the same offset into p + 1
  __device__ __forceinline__ bool link(int p) const {
    return capped(p) && valid(p + 1) && (p + 1 - cand(p + 1)) == (p - cand(p));
  }
};

constexpr int kBatch = 4;  // rows a thread loads before it stores any

// nxt[w] = the first set bit of mask in the words after w (none if there
// is none), for the nw words of mask: each thread scans a run of words,
// and a reverse min-scan over the threads carries across runs.  tmp:
// kParseThreads / 32 ints of shared memory.
__device__ void next_after_words(const uint32_t* mask, int nw, int none,
                                 int* nxt, int* tmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int run = (nw + kParseThreads - 1) / kParseThreads;
  const int lo = min(tid * run, nw), hi = min(lo + run, nw);
  int first = none;
  for (int w = lo; w < hi; ++w)
    if (mask[w]) {
      first = (w << 5) + __ffs(mask[w]) - 1;
      break;
    }
  int v = first;  // min over this lane and the lanes after it
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane + o < 32) v = min(v, x);
  }
  if (lane == 0) tmp[warp] = v;
  __syncthreads();
  int after = __shfl_down_sync(0xFFFFFFFFu, v, 1);
  if (lane == 31) after = none;
  for (int k = warp + 1; k < kParseThreads / 32; ++k)
    after = min(after, tmp[k]);
  for (int w = hi - 1; w >= lo; --w) {
    nxt[w] = after;
    if (mask[w]) after = (w << 5) + __ffs(mask[w]) - 1;
  }
  __syncthreads();
}

// The first set bit of mask at or after row x, with nxt from
// next_after_words.
__device__ __forceinline__ int first_at_or_after(const uint32_t* mask,
                                                 const int* nxt, int x) {
  const int w = x >> 5;
  const uint32_t bits = mask[w] & (0xFFFFFFFFu << (x & 31));
  return bits ? (w << 5) + __ffs(bits) - 1 : nxt[w];
}

// Row p's word of the parse, ml | is_match << 30 | cap_end << 29, from the
// chain boundaries: a capped row takes its length from the nearest boundary
// at or after it.
__device__ __forceinline__ int chain_word(const Fields& F, int start,
                                          const uint32_t* bnd, const int* nxt,
                                          int p) {
  const int nb = first_at_or_after(bnd, nxt, p);
  int ml = F.ml0(p);
  if (F.capped(p)) ml = max(nb - p + min(F.ml0(nb), 2047), ml);
  ml = min(ml, max(F.n - 5 - p, 0));
  const bool v = F.valid(p);
  const bool im = v && ml >= 4 && p >= start;
  const bool ce = v && F.capped(nb);
  return ml | (im ? kImBit : 0) | (ce ? kCapEndBit : 0);
}

// Same-offset chain extension and the n - 5 clamp (jax_block.py:522-555),
// position-parallel: each capped row takes its length from the nearest
// chain boundary at or after it (a reverse cummax in the reference).
// Writes M[p] = ml | is_match << 30 | cap_end << 29 for every row, kBatch
// rows a thread at a time, so that their loads are in flight together.
// bnd and nxt: nw = ceil(blk / 32) words of shared memory each.
__device__ void chain_lengths_par(const Fields& F, int start, int32_t* M,
                                  uint32_t* bnd, int* nxt, int* tmp) {
  const int blk = F.blk, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = (blk + 31) >> 5;
  // boundary rows (no link into the next row); row blk - 1 always is one
#pragma unroll 4
  for (int base = warp * 32; base < nw * 32; base += kParseThreads) {
    const int p = base + lane;
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, p < blk && !F.link(p));
    if (lane == 0) bnd[base >> 5] = bits;
  }
  __syncthreads();
  next_after_words(bnd, nw, blk, nxt, tmp);
  for (int p0 = tid; p0 < blk; p0 += kBatch * kParseThreads) {
    int word[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kParseThreads;
      word[u] = p < blk ? chain_word(F, start, bnd, nxt, p) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kParseThreads;
      if (p < blk) M[p] = word[u];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void put_len(uint8_t* o, int& op, int v) {
  for (; v >= 255; v -= 255) o[op++] = 255;
  o[op++] = (uint8_t)v;
}

// The recorded literal runs, one warp each, and zeros past out_len.
__device__ void copy_runs(const uint8_t* row, const int32_t* R, int nr,
                          uint8_t* o, int olen, int cap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nr; r += blockDim.x / 32) {
    const int src = R[3 * r], dst = R[3 * r + 1], len = R[3 * r + 2];
    for (int k = lane; k < len; k += 32) o[dst + k] = row[src + k];
  }
  for (int k = olen + threadIdx.x; k < cap; k += blockDim.x) o[k] = 0;
}

// Words of a window as the finders hold it: blk bytes and kPad zero
// bytes past them, as LE u32.
inline int window_words(int blk) { return (blk + kPad) / 4 + 1; }

// The launch of B windows in clusters of C CTAs of nt threads, smem bytes
// of dynamic shared memory a CTA, with the kernel's shared-memory limit
// (max_smem) and non-portable cluster size (16 is past the portable 8)
// allowed once per device: bit d of *raised.
template <class... Args>
cudaError_t cluster_launch(void (*kernel)(Args...), unsigned* raised,
                           size_t max_smem, int B, int C, int nt, size_t smem,
                           void* stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(*raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *raised |= 1u << dev;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * (unsigned)C);
  cfg->blockDim = dim3(nt);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

constexpr int kStage = 2048;   // rows of successors the walk stages at a time
constexpr int kShortRun = 32;  // literal runs shorter go byte by byte

struct MaxOp {
  static constexpr int kId = -0x7FFFFFFF - 1;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return max(a, b);
  }
};
struct SumOp {
  static constexpr int kId = 0;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a + b;
  }
};

// Inclusive scan of v over the block's NT threads under op, with the
// block's total, and where ``excl`` is given the exclusive scan (the
// identity Op::kId before the first thread); tmp: NT / 32 elements of
// shared memory.
template <class Op, int NT = kParseThreads>
__device__ __forceinline__ int block_scan(int v, int* tmp, Op op, int& total,
                                          int* excl = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nw = NT / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v = op(v, x);
  }
  if (lane == 31) tmp[warp] = v;
  __syncthreads();
  int pre = tmp[0];
  for (int k = 1; k < warp; ++k) pre = op(pre, tmp[k]);
  if (excl) {  // the lane before's inclusive scan, after the warps before
    const int x = __shfl_up_sync(0xFFFFFFFFu, v, 1);
    const int ex = lane ? x : Op::kId;
    *excl = warp > 0 ? op(pre, ex) : ex;
  }
  if (warp > 0) v = op(pre, v);
  total = tmp[0];
  for (int k = 1; k < nw; ++k) total = op(total, tmp[k]);
  __syncthreads();
  return v;
}

// The literal run of lit bytes from row[src] to o[dst]: copied here when
// it is shorter than kShortRun, else listed in R (src, dst, len) for the
// warps, at the index the shared counter nlong hands out.
__device__ __forceinline__ void literal_run(const uint8_t* row, int src,
                                            uint8_t* o, int dst, int lit,
                                            int32_t* R, int* nlong) {
  if (lit < kShortRun) {
    for (int k = 0; k < lit; ++k) o[dst + k] = row[src + k];
    return;
  }
  const int r = atomicAdd(nlong, 1);
  R[3 * r] = src;
  R[3 * r + 1] = dst;
  R[3 * r + 2] = lit;
}

// Bytes of the 255-escaped continuation of a length field whose token
// nibble saturated: put_len's count for v = length - 15 >= 0.
__device__ __forceinline__ int len_bytes(int v) {
  return v >= 0 ? v / 255 + 1 : 0;
}

// Greedy parse (jax_block.py:716-743): the lowest match row not yet
// covered, again and again; from a chosen row p the next one is the first
// match row at or after p + ml(p), ml(p) = M[p] & kMlMask.  The warps stage
// that next row for every match row of a kStage-row span into shared
// memory (imask and inext from next_after_words find it); thread 0 follows
// the chain, one shared load a chosen row, while warps 1.. stage the span
// after its own into the other half of buf.  Lists each chosen row in L;
// returns the count on every thread.  walk: 4 ints of shared memory, the
// walker's (row, count) by the parity of the step, so that it can post a
// step's while the others still read the last one's.
__device__ int greedy_walk(const int32_t* M, const uint32_t* imask,
                           const int* inext, int blk, int* buf, int32_t* L,
                           int* walk) {
  const int tid = threadIdx.x;
  const int nstage = (blk + kStage - 1) / kStage;
  auto stage = [&](int c, int t0, int nt) {
    const int lo = c * kStage, hi = min(lo + kStage, blk);
    int* dst = buf + (c & 1) * kStage - lo;
#pragma unroll 4
    for (int p = lo + t0; p < hi; p += nt)
      if ((imask[p >> 5] >> (p & 31)) & 1u)
        dst[p] = first_at_or_after(imask, inext, p + (M[p] & kMlMask));
  };
  int p = first_at_or_after(imask, inext, 0);
  if (p >= blk) return 0;  // no match row
  int cur = p / kStage, cnt = 0;
  stage(cur, tid, kParseThreads);
  __syncthreads();
  for (int par = 0;; par ^= 2) {
    if (tid == 0) {
      const int hi = min((cur + 1) * kStage, blk);
      const int* nx = buf + (cur & 1) * kStage - cur * kStage;
      while (p < hi) {
        L[cnt++] = p;
        p = nx[p];
      }
      walk[par] = p;
      walk[par + 1] = cnt;
    } else if (tid >= 32 && cur + 1 < nstage) {
      stage(cur + 1, tid - 32, kParseThreads - 32);
    }
    __syncthreads();
    p = walk[par];
    if (p >= blk) {
      cnt = walk[par + 1];
      break;
    }
    const int next = p / kStage;
    if (next != cur + 1) {  // a match or a gap skipped the staged span
      stage(next, tid, kParseThreads);
      __syncthreads();
    }
    cur = next;
  }
  __syncthreads();
  return cnt;
}

// One entry of an emission list: a selection from p to e at offset off
// whose sequence may extend back over <= back literals.
struct Entry {
  int p, e, off, back;
};

// Entry y runs on into x: x starts at y's end at the same offset.
__device__ __forceinline__ bool continues(const Entry& y, const Entry& x) {
  return y.e == x.p && y.off == x.off;
}

// One sequence: its literal run of lit bytes from row[ls], its match
// length mml, and its bytes.
struct Seq {
  int ls, lit, mml, size;
};

// The sequence of the merged group of entries h..i, x = E(i): the literal
// run from the previous entry's end (or start), extended back over <= back
// literals, and the match to x's end.
template <class Entries>
__device__ __forceinline__ Seq group_seq(const Entries& E, int h,
                                         const Entry& x, int start) {
  const Entry g = E(h);
  const int prev_end = h > 0 ? max(E(h - 1).e, start) : start;
  const int bq = max(min(min(g.back, g.p - prev_end), g.p - x.off), 0);
  Seq s;
  s.ls = prev_end;
  s.lit = g.p - bq - prev_end;
  s.mml = x.e - (g.p - bq);
  s.size = 1 + len_bytes(s.lit - 15) + s.lit + 2 + len_bytes(s.mml - 19);
  return s;
}

// Sequence s at offset off written at o[q]: token, 255-escapes, the
// literal run (literal_run), LE offset, 255-escapes.
__device__ __forceinline__ void write_seq(const Seq& s, int off,
                                          const uint8_t* row, uint8_t* o,
                                          int q, int32_t* R, int* nlong) {
  o[q++] = (uint8_t)((min(s.lit, 15) << 4) | min(s.mml - 4, 15));
  if (s.lit >= 15) put_len(o, q, s.lit - 15);
  literal_run(row, s.ls, o, q, s.lit, R, nlong);
  q += s.lit;
  o[q++] = (uint8_t)(off & 0xFF);
  o[q++] = (uint8_t)(off >> 8);
  if (s.mml - 4 >= 15) put_len(o, q, s.mml - 19);
}

// The tail literal run, from the last entry's end (or start) to n, written
// at o[q] when n > start; returns out_len.
template <class Entries>
__device__ __forceinline__ int write_tail(const Entries& E, int cnt,
                                          const uint8_t* row, int n,
                                          int start, uint8_t* o, int q,
                                          int32_t* R, int* nlong) {
  if (n > start) {
    const int tail = cnt > 0 ? max(E(cnt - 1).e, start) : start;
    const int lit = n - tail;
    o[q++] = (uint8_t)(min(lit, 15) << 4);
    if (lit >= 15) put_len(o, q, lit - 15);
    literal_run(row, tail, o, q, lit, R, nlong);
    q += lit;
  }
  return q;
}

// The tiles of NT entries, one a thread, of entries [a, b) of a list of
// cnt, after the entries before a, whose last head is carry_head (-1 or
// less: none) and whose groups fill q0 bytes: an entry merges into the one
// before it when it starts at that one's end at the same offset; the last
// entry of each merged group finds its head by a block max-scan, computes
// the group's sequence (group_seq), and a block sum-scan of the groups'
// sizes places it.  Writes the groups that end in [a, b) when kWrite.
// Returns their bytes.  tmp: NT / 32 ints of shared memory.
template <bool kWrite, int NT, class Entries>
__device__ int emit_tiles(const Entries& E, int a, int b, int cnt, int start,
                          int carry_head, int q0, const uint8_t* row,
                          uint8_t* o, int32_t* R, int* nlong, int* tmp) {
  int q_run = q0;
  for (int t0 = a; t0 < b; t0 += NT) {
    const int i = t0 + threadIdx.x;
    Entry x{0, 0, 0, 0};
    bool head = false, last = false;
    if (i < b) {
      x = E(i);
      head = i == 0 || !continues(E(i - 1), x);
      last = i + 1 >= cnt || !continues(x, E(i + 1));
    }
    int tot_h, tot_o;
    const int h = max(carry_head, block_scan<MaxOp, NT>(head ? i : -1, tmp,
                                                        MaxOp{}, tot_h));
    Seq g{0, 0, 0, 0};
    if (last) g = group_seq(E, h, x, start);  // the group h..i
    const int q = q_run + block_scan<SumOp, NT>(g.size, tmp, SumOp{}, tot_o) -
                  g.size;
    if (kWrite && last) write_seq(g, x.off, row, o, q, R, nlong);
    carry_head = max(carry_head, tot_h);
    q_run += tot_o;
  }
  return q_run - q0;
}

// Sequence emission (jax_block.py:871-1103) of one window from its cnt
// entries E(0), ..., E(cnt - 1) (emit_tiles over all of them, kParseThreads
// a tile).  A literal run shorter than kShortRun is copied by the thread
// that writes its header; longer ones (the tail's too) are listed in R
// (src, dst, len; blk / 4 + 2 runs at most) and copied by all warps, with
// the zeros past out_len up to cap.  Writes *olen.  E is an accessor: E(i)
// returns entry i; tmp: kParseThreads / 32 ints of shared memory.
template <class Entries>
__device__ void emit_entries(const Entries& E, int cnt, const uint8_t* row,
                             int n, int start, uint8_t* o, int cap,
                             int32_t* R, int32_t* olen, int* tmp) {
  __shared__ int s_nlong, s_olen;
  if (threadIdx.x == 0) s_nlong = 0;  // read after the next barrier
  const int size = emit_tiles<true, kParseThreads>(
      E, 0, cnt, cnt, start, -1, 0, row, o, R, &s_nlong, tmp);

  // the tail literal run (one thread), then the long literal runs by all
  // warps and zeros past out_len
  if (threadIdx.x == 0) {
    s_olen = write_tail(E, cnt, row, n, start, o, size, R, &s_nlong);
    *olen = s_olen;
  }
  __syncthreads();
  copy_runs(row, R, s_nlong, o, s_olen, cap);
}

}  // namespace
