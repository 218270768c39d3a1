// The three fragment-ladder block decoders.
//
// Replace: _decode_block_frags (ops/jax_decode.py:342-458),
// _decode_block_frags_win (:461-781) and _decode_block_frags_chase
// (:798-965) of the JAX reference, batched at :1152-1210.  The host
// resolver hands each block a table of fragments (LIT: a run of the
// fetch buffer; PER: a periodic copy of earlier output); the TPU versions
// spread the table over the bytes with a sort and a packed cummax, and
// follow the copies with more sorts, because gathers are slow there.
// Here every output byte finds its fragment by binary search and follows
// its copy by a gather.  What each engine resolves, and when, is the
// reference's exactly (see ops/torch_frags.py), so `ok` -- which decides
// a block's route -- is the same in both.
//
//   frag_decode        rounds over the value state, one dependency level
//                      a round;
//   frag_decode_win    the same, restricted to the bytes that the
//                      reference's per-group source windows and
//                      straggler pools cover;
//   frag_decode_chase  pointer doubling over the position state, dense
//                      rounds then rounds over a frontier pool.
//
// Bound on the H100: device memory -- each fetch row, the four table
// columns below nfrag and the output row cross it once.  Design: one
// thread block of 1024 threads per LZ4 block, a block-wide barrier
// between dependency levels, double-buffered state so that a round reads
// the state of its start (known-bit masks for the value decoders, the
// position array for the chase), and an early exit from the rounds once
// nothing changes.  The value decoders keep their state in device
// scratch.  The chase keeps its position state nx, int32 a byte, in the
// shared memory of one thread-block cluster a block for blocks up to
// 256 KB (C = ceil(blk / 32768) CTAs of 1024 threads, 32,768 positions
// and 128 KB a CTA: 2 at 64 KB, 8 at 256 KB), so that a round's dependent
// load nx[nx[j]] goes to a CTA's shared memory, local or remote
// (distributed shared memory), not to device memory.  Its rounds keep
// their round-start semantics without a second buffer: each thread
// reads the new values of its 32 positions, 16 into registers and 16
// into a shared-memory staging row (64 KB a CTA; 32 registers spilled),
// the cluster synchronises, the thread writes them back, and the cluster
// synchronises again with the "unconverged" flag reduced over its CTAs.  The frontier
// takes the first qcap open positions in position order: a CTA's open
// bits are counted by a block scan, the CTAs' totals published in their
// shared memory give each its offset, and a position is in the pool when
// its rank is below qcap; the frontier rounds are the dense rounds
// restricted to the pool.  Larger blocks (the 1 MB path's) keep their
// state in device scratch (frag_decode_chase_kernel); the wrapper picks
// the route from blk.  Built with -DZL4_STOP=k the cluster kernel stops
// after its k-th phase (1 the one-hop sources, 2 the dense rounds, 3 the
// frontier; the final gather is the rest) so that chip_smoke.py can time
// the phases one by one; the library is built without it.

#include <cooperative_groups.h>

#include "frag_common.cuh"

#ifdef ZL4_STOP
#define ZL4_CHASE_STOP(k, keep) \
  if (ZL4_STOP == (k)) {        \
    keep;                       \
    cluster.sync();             \
    return;                     \
  }
#else
#define ZL4_CHASE_STOP(k, keep)
#endif

namespace {

namespace cg = cooperative_groups;
using namespace zl4frag;

// ---------------------------------------------------------------------
// byte-granular rounds
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
frag_decode_kernel(const uint8_t* comp, const int32_t* fdst,
                   const int32_t* fsrc, const int32_t* fper,
                   const int32_t* fphase, const int32_t* nfrag,
                   const int32_t* out_len, int32_t* src_all,
                   uint32_t* known_all, uint8_t* out_all, int32_t* ok,
                   int fetch, int ncol, int blk, int rounds) {
  const Block v = block_view(comp, fdst, fsrc, fper, fphase, nfrag, out_len,
                             fetch, ncol, blk);
  const size_t b = blockIdx.x;
  int32_t* src = src_all + b * blk;
  uint8_t* out = out_all + b * blk;
  uint32_t* cur = known_all + b * 2 * v.nwords;
  uint32_t* nxt = cur + v.nwords;
  const int lane = threadIdx.x & 31;

  for (int base = 0; base < v.nwords * 32; base += kThreads) {
    const int j = base + threadIdx.x, w = j >> 5;
    if (w >= v.nwords) continue;
    bool per = false;
    uint8_t val = 0;
    if (j < v.out_len) {
      const int t = source_of(v, j, &per);
      if (per) src[j] = t; else val = v.comp[t];
    }
    if (j < blk) out[j] = val;
    const uint32_t kw = __ballot_sync(kFull, !per);
    if (lane == 0) cur[w] = kw;
  }
  __syncthreads();
  cur = resolve_rounds(src, cur, nxt, out, v.nwords, rounds);
  write_ok(cur, v.nwords, ok);
}

// ---------------------------------------------------------------------
// windowed rounds
// ---------------------------------------------------------------------

// Whether this lane's byte, with source t, lies in one of the `nwins`
// aligned 2G-byte source windows of its G-byte group, computed over the
// bytes `unres` of the group (ops/jax_decode.py:571-607): the first
// window starts at the group-aligned source of the group's first such
// byte, the second ends at the source of its last, each later one
// starts at the source of the first byte the earlier ones miss.  Every
// lane of the warp calls it; a warp holds 32 / G groups.
template <int G>
__device__ __forceinline__ bool covered(int t, bool unres, int nwins) {
  constexpr int kShift = G == 8 ? 3 : 4;
  const int lane = threadIdx.x & 31;
  const uint32_t gmask = ((1u << G) - 1u) << (lane & ~(G - 1));
  const uint32_t ug = __ballot_sync(kFull, unres) & gmask;
  bool cov = false;
  {
    const int t0 = __shfl_sync(kFull, t, ug ? __ffs(ug) - 1 : lane);
    const int d = t - ((t0 >> kShift) << kShift);
    cov = ug && d >= 0 && d < 2 * G;
  }
  if (nwins >= 2) {
    const int t1 = __shfl_sync(kFull, t, ug ? 31 - __clz(ug) : lane);
    const int d = t - ((max(t1 - (G - 1), 0) >> kShift) << kShift);
    cov |= ug && d >= 0 && d < 2 * G;
  }
  for (int k = 2; k < nwins; ++k) {
    const uint32_t rem = __ballot_sync(kFull, unres && !cov) & gmask;
    const int t0 = __shfl_sync(kFull, t, rem ? __ffs(rem) - 1 : lane);
    const int d = t - ((t0 >> kShift) << kShift);
    cov |= rem && d >= 0 && d < 2 * G;
  }
  return cov;
}

// src word of the windowed decoder between its two passes: the source
// in the high bits, bit 0 = PER, bit 1 = covered by a window.
template <int G>
__global__ void __launch_bounds__(kThreads)
frag_decode_win_kernel(const uint8_t* comp, const int32_t* fdst,
                       const int32_t* fsrc, const int32_t* fper,
                       const int32_t* fphase, const int32_t* nfrag,
                       const int32_t* out_len, int32_t* src_all,
                       uint32_t* known_all, uint32_t* words_all,
                       uint8_t* out_all, int32_t* ok, int fetch, int ncol,
                       int blk, int rounds, int wins, int pool, int lit_wins,
                       int lit_pool) {
  const Block v = block_view(comp, fdst, fsrc, fper, fphase, nfrag, out_len,
                             fetch, ncol, blk);
  const size_t b = blockIdx.x;
  int32_t* src = src_all + b * blk;
  uint8_t* out = out_all + b * blk;
  uint32_t* cur = known_all + b * 2 * v.nwords;
  uint32_t* nxt = cur + v.nwords;
  // uncovered bytes of the literal and of the periodic side, and the
  // prefix counts over each
  uint32_t* unc_lit = words_all + b * 4 * v.nwords;
  uint32_t* unc_per = unc_lit + v.nwords;
  int32_t* pre_lit = reinterpret_cast<int32_t*>(unc_per + v.nwords);
  int32_t* pre_per = pre_lit + v.nwords;
  const int lane = threadIdx.x & 31;

  // pass 1: sources and window coverage
  for (int base = 0; base < v.nwords * 32; base += kThreads) {
    const int j = base + threadIdx.x, w = j >> 5;
    if (w >= v.nwords) continue;
    const bool live = j < v.out_len;
    bool per = false;
    const int t = live ? source_of(v, j, &per) : 0;
    const bool lit = live && !per;
    const bool cov_lit = lit_wins ? covered<G>(t, lit, lit_wins) : true;
    const bool cov_per = covered<G>(t, live && per, wins);
    const bool cov = per ? cov_per : cov_lit;
    if (j < blk) src[j] = (t << 2) | (cov ? 2 : 0) | (per ? 1 : 0);
    const uint32_t ul = __ballot_sync(kFull, lit && !cov_lit);
    const uint32_t up = __ballot_sync(kFull, live && per && !cov_per);
    if (lane == 0) { unc_lit[w] = ul; unc_per[w] = up; }
  }
  __syncthreads();
  if (lit_wins) prefix_popc(unc_lit, pre_lit, v.nwords);
  prefix_popc(unc_per, pre_per, v.nwords);

  // pass 2: the pools take the first uncovered bytes in position order;
  // literal bytes that are reached are copied, the others never resolve
  const uint32_t below = (1u << lane) - 1u;
  for (int base = 0; base < v.nwords * 32; base += kThreads) {
    const int j = base + threadIdx.x, w = j >> 5;
    if (w >= v.nwords) continue;
    const bool live = j < v.out_len;
    bool known = true;
    uint8_t val = 0;
    if (live) {
      const int s = src[j], t = s >> 2;
      const bool per = s & 1;
      bool reach = s & 2;
      if (!reach && (per || lit_wins)) {
        const uint32_t uw = __ldcg((per ? unc_per : unc_lit) + w);
        const int rank =
            __ldcg((per ? pre_per : pre_lit) + w) + __popc(uw & below);
        reach = rank < (per ? pool : lit_pool);
      }
      if (per) {
        src[j] = reach ? t : -1;
        known = false;
      } else if (reach) {
        val = v.comp[t];
      } else {
        src[j] = -1;
        known = false;
      }
    }
    if (j < blk) out[j] = val;
    const uint32_t kw = __ballot_sync(kFull, known);
    if (lane == 0) cur[w] = kw;
  }
  __syncthreads();
  cur = resolve_rounds(src, cur, nxt, out, v.nwords, rounds);
  write_ok(cur, v.nwords, ok);
}

// ---------------------------------------------------------------------
// pointer doubling
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
frag_decode_chase_kernel(const uint8_t* comp, const int32_t* fdst,
                         const int32_t* fsrc, const int32_t* fper,
                         const int32_t* fphase, const int32_t* nfrag,
                         const int32_t* out_len, int32_t* nx_all,
                         uint32_t* words_all, int32_t* pool_all,
                         uint8_t* out_all, int32_t* ok, int32_t* rounds,
                         int fetch, int ncol, int blk, int dense,
                         int doublings, int qcap) {
  const Block v = block_view(comp, fdst, fsrc, fper, fphase, nfrag, out_len,
                             fetch, ncol, blk);
  const size_t b = blockIdx.x;
  // tagged positions: [0, blk) an output byte still to follow,
  // [blk, blk + fetch) a fetch byte, which is a fixpoint
  int32_t* cur = nx_all + b * 2 * blk;
  int32_t* nxt = cur + blk;
  uint32_t* open = words_all + b * 2 * v.nwords;
  int32_t* pre = reinterpret_cast<int32_t*>(open + v.nwords);
  int32_t* pool = pool_all + b * qcap;
  uint8_t* out = out_all + b * blk;
  const int lane = threadIdx.x & 31;

  int unconverged = 0;
  for (int j = threadIdx.x; j < blk; j += kThreads) {
    int p = blk;
    if (j < v.out_len) {
      bool per = false;
      const int t = source_of(v, j, &per);
      p = per ? t : t + blk;
      unconverged |= per;
    }
    cur[j] = p;
  }
  unconverged = __syncthreads_or(unconverged);

  // dense rounds: nx[j] = nx[nx[j]] from the state of the round's start
  int nd = 0, nf = 0;
  for (int r = 0; r < dense && unconverged; ++r, ++nd) {
    unconverged = 0;
    for (int j = threadIdx.x; j < blk; j += kThreads) {
      int p = __ldcg(cur + j);
      if (p < blk) {
        p = __ldcg(cur + p);
        unconverged |= p < blk;
      }
      nxt[j] = p;
    }
    unconverged = __syncthreads_or(unconverged);
    int32_t* t = cur; cur = nxt; nxt = t;
  }

  // the frontier: the first qcap unconverged bytes in position order get
  // `doublings` more rounds, each written back into the dense state
  if (doublings > 0 && unconverged) {
    for (int base = 0; base < v.nwords * 32; base += kThreads) {
      const int j = base + threadIdx.x, w = j >> 5;
      if (w >= v.nwords) continue;
      const uint32_t ow =
          __ballot_sync(kFull, j < blk && __ldcg(cur + j) < blk);
      if (lane == 0) open[w] = ow;
    }
    __syncthreads();
    const int n = min(prefix_popc(open, pre, v.nwords), qcap);
    const uint32_t below = (1u << lane) - 1u;
    for (int base = 0; base < v.nwords * 32; base += kThreads) {
      const int j = base + threadIdx.x, w = j >> 5;
      if (w >= v.nwords) continue;
      const uint32_t ow = __ldcg(open + w);
      if ((ow >> lane) & 1) {
        const int rank = __ldcg(pre + w) + __popc(ow & below);
        if (rank < n) pool[rank] = j;
      }
    }
    __syncthreads();
    // nxt is free now: it holds the pool's new positions within a round
    for (int r = 0; r < doublings && unconverged; ++r, ++nf) {
      unconverged = 0;
      for (int k = threadIdx.x; k < n; k += kThreads) {
        int p = __ldcg(cur + __ldcg(pool + k));
        if (p < blk) {
          p = __ldcg(cur + p);
          unconverged |= p < blk;
        }
        nxt[k] = p;
      }
      __syncthreads();
      for (int k = threadIdx.x; k < n; k += kThreads)
        cur[__ldcg(pool + k)] = __ldcg(nxt + k);
      unconverged = __syncthreads_or(unconverged);
    }
  }

  int bad = 0;
  for (int j = threadIdx.x; j < blk; j += kThreads) {
    const int p = __ldcg(cur + j);
    const bool conv = p >= blk;
    bad |= !conv;
    out[j] = j < v.out_len && conv ? v.comp[min(p - blk, fetch - 1)] : 0;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    ok[b] = !bad;
    if (rounds) rounds[b] = nd | nf << 16;
  }
}

// ---------------------------------------------------------------------
// pointer doubling in a thread-block cluster's shared memory
// ---------------------------------------------------------------------

constexpr int kChaseRows = 1 << 15;               // positions a CTA holds
constexpr int kChaseJ = kChaseRows / kThreads;    // positions a thread
constexpr int kChaseMaxCluster = 8;               // the portable size

constexpr int kChaseRegs = kChaseJ / 2;           // staged in registers

// Dynamic shared memory of a CTA holding R positions: nx int32[R], the
// open and pool bits and the prefix counts, one word each per 32, and
// the round's staging of the positions past kChaseRegs a thread (the
// rest stay in registers, which hold no more without spilling).
__host__ __device__ constexpr size_t chase_smem(int R) {
  return 4 * (size_t)R + 12 * (size_t)((R + 31) / 32) +
         4 * (size_t)(R > kChaseRegs * kThreads ? R - kChaseRegs * kThreads
                                                : 0);
}

// CTAs of the cluster that rebuilds a blk-byte block: 0 when the state
// needs more than kChaseMaxCluster (the device-memory kernel's blocks).
__host__ __device__ constexpr int chase_cluster(int blk) {
  return blk <= kChaseMaxCluster * kChaseRows
             ? (blk + kChaseRows - 1) / kChaseRows : 0;
}

// OR of v over the cluster's threads.  Every thread of the cluster calls
// it; flags[2] lie in each CTA's shared memory and alternate between
// calls, so that a CTA writes a slot only after every CTA has read it
// (a cluster barrier lies between).
__device__ int cluster_any(int v, int* flags, int& slot) {
  cg::cluster_group cluster = cg::this_cluster();
  v = __syncthreads_or(v);
  if (threadIdx.x == 0) flags[slot] = v;
  cluster.sync();
  int any = 0;
  for (int c = 0; c < (int)cluster.num_blocks(); ++c)
    any |= cluster.map_shared_rank(flags, c)[slot];
  slot ^= 1;
  return any;
}

// One round over this CTA's positions whose bit is set in `sel` (every
// position when sel is null): nx[j] = nx[nx[j]] for an unconverged j,
// from the state of the round's start -- read into registers (the first
// kChaseRegs of a thread) and `stage`, a cluster barrier, written back.
// Returns whether some such j stays unconverged (this thread's, before
// the reduction).
__device__ __forceinline__ int chase_round(int32_t* nx, int32_t* stage,
                                           const uint32_t* sel, int nloc,
                                           int blk) {
  cg::cluster_group cluster = cg::this_cluster();
  int v[kChaseRegs];
  int u = 0;
#pragma unroll
  for (int k = 0; k < kChaseJ; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nloc && (!sel || (sel[i >> 5] >> (i & 31) & 1))) {
      int p = nx[i];
      if (p < blk) {
        p = cluster.map_shared_rank(nx, p >> 15)[p & (kChaseRows - 1)];
        u |= p < blk;
      }
      if (k < kChaseRegs) v[k] = p;
      else stage[i - kChaseRegs * kThreads] = p;
    }
  }
  cluster.sync();  // every read of the round's start done
#pragma unroll
  for (int k = 0; k < kChaseJ; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < nloc && (!sel || (sel[i >> 5] >> (i & 31) & 1)))
      nx[i] = k < kChaseRegs ? v[k] : stage[i - kChaseRegs * kThreads];
  }
  return u;
}

__global__ void __launch_bounds__(kThreads, 1)
frag_chase_cluster_kernel(const uint8_t* comp, const int32_t* fdst,
                          const int32_t* fsrc, const int32_t* fper,
                          const int32_t* fphase, const int32_t* nfrag,
                          const int32_t* out_len, uint8_t* out_all,
                          int32_t* ok, int32_t* rounds, int fetch, int ncol,
                          int blk, int dense, int doublings, int qcap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const size_t b = blockIdx.x / C;
  const Block v = block_view(comp, fdst, fsrc, fper, fphase, nfrag, out_len,
                             fetch, ncol, blk, b);
  extern __shared__ __align__(16) int32_t cs[];
  // this CTA's positions [j0, j0 + nloc), rows of the cluster's state:
  // [0, blk) an output byte still to follow, [blk, blk + fetch) a fetch
  // byte, which is a fixpoint
  const int R = min(blk, kChaseRows), nw = (R + 31) >> 5;
  const int j0 = r * kChaseRows, nloc = min(R, blk - j0);
  int32_t* nx = cs;
  uint32_t* open = reinterpret_cast<uint32_t*>(nx + R);
  uint32_t* pool = open + nw;
  int32_t* pre = reinterpret_cast<int32_t*>(pool + nw);
  int32_t* stage = pre + nw;
  __shared__ int flags[2], total_s;
  int slot = 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // one-hop sources.  On a table in increasing fdst a byte's fragment
  // is the largest index among the fragments that start at or before it:
  // each fragment that starts in this CTA's positions writes its index
  // there (atomicMax, for fragments of no bytes), a max-scan spreads
  // them, and the fragments before the CTA's first position give the
  // carry.  On any other table each byte bisects, as torch.searchsorted
  // does.
  // On a sorted table the fragments before the CTA's positions number
  // q_lo, and those before its end q_hi: both are counted in the pass
  // that checks the order.
  __shared__ int span_pre[32], q_lo, q_hi;
  if (tid == 0) q_lo = q_hi = 0;
  __syncthreads();
  int unsorted = 0, n_lo = 0, n_hi = 0;
  for (int q = tid; q < v.nfrag; q += kThreads) {
    const int d = __ldg(v.fdst + q);
    if (q + 1 < v.nfrag) unsorted |= d > __ldg(v.fdst + q + 1);
    n_lo += d < j0;
    n_hi += d < j0 + nloc;
  }
  n_lo = __reduce_add_sync(kFull, n_lo);
  n_hi = __reduce_add_sync(kFull, n_hi);
  if (lane == 0) {
    atomicAdd(&q_lo, n_lo);
    atomicAdd(&q_hi, n_hi);
  }
  unsorted = __syncthreads_or(unsorted);
  // warp w's span of positions: a power of two >= nloc / 32, >= 32
  const int span_log = 32 - __clz(max((nloc + 31) >> 5, 32) - 1);
  if (!unsorted) {
    for (int i = tid; i < nloc; i += kThreads) nx[i] = -1;
    __syncthreads();
    for (int q = q_lo + tid; q < q_hi; q += kThreads)
      atomicMax(nx + (__ldg(v.fdst + q) - j0), q);
    __syncthreads();
    // warp w scans positions [w << span_log, (w + 1) << span_log)
    int run = q_lo - 1;
    const int w_hi = min((warp + 1) << span_log, nloc);
    for (int base = warp << span_log; base < w_hi; base += 32) {
      const int i = base + lane;
      int x = i < nloc ? nx[i] : -1;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = max(x, y);
      }
      x = max(x, run);
      if (i < nloc) nx[i] = x;
      run = __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) span_pre[warp] = run;
    __syncthreads();
    if (warp == 0) {  // the carry into each warp's span: a max-scan
      int x = span_pre[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x = max(x, y);
      }
      const int before = __shfl_up_sync(kFull, x, 1);
      span_pre[lane] = lane ? before : q_lo - 1;
    }
    __syncthreads();
  }
  // the tagged position of byte i of this CTA from its source t
  int unc = 0;
  auto tag = [&](int t, bool per) {
    unc |= per;
    return per ? t : t + blk;
  };
  if (unsorted) {
    for (int i = tid; i < nloc; i += kThreads) {
      bool per = false;
      int p = blk;
      if (j0 + i < v.out_len) {
        const int t = source_of(v, j0 + i, &per);
        p = tag(t, per);
      }
      nx[i] = p;
    }
  } else {
    for (int i = tid; i < nloc; i += kThreads) {
      bool per = false;
      int p = blk;
      if (j0 + i < v.out_len) {
        const int q = max(nx[i], span_pre[i >> span_log]);
        const int t = source_in(v, j0 + i, q, &per);
        p = tag(t, per);
      }
      nx[i] = p;
    }
  }
  unc = cluster_any(unc, flags, slot);
  ZL4_CHASE_STOP(1, if (tid == 0) ok[b] = nx[0])

  // dense rounds
  int nd = 0, nf = 0;
  for (; nd < dense && unc; ++nd)
    unc = cluster_any(chase_round(nx, stage, nullptr, nloc, blk), flags,
                      slot);
  ZL4_CHASE_STOP(2, if (tid == 0) ok[b] = nx[0])

  // the frontier: the first qcap open positions of the block in position
  // order get `doublings` more rounds
  if (doublings > 0 && unc) {
    for (int w = warp; w < nw; w += kThreads / 32) {
      const int i = (w << 5) + lane;
      const uint32_t ow = __ballot_sync(kFull, i < nloc && nx[i] < blk);
      if (lane == 0) open[w] = ow;
    }
    __syncthreads();
    const int total = prefix_popc<true>(open, pre, nw);
    if (tid == 0) total_s = total;
    cluster.sync();  // every CTA's total published
    int before = 0, all = 0;
    for (int c = 0; c < C; ++c) {
      const int t = *cluster.map_shared_rank(&total_s, c);
      all += t;
      before += c < r ? t : 0;
    }
    const int n = min(all, qcap);
    const uint32_t below = (1u << lane) - 1u;
    for (int w = warp; w < nw; w += kThreads / 32) {
      const uint32_t ow = open[w];
      const bool in = (ow >> lane & 1) &&
                      before + pre[w] + __popc(ow & below) < n;
      const uint32_t pw = __ballot_sync(kFull, in);
      if (lane == 0) pool[w] = pw;
    }
    __syncthreads();
    for (; nf < doublings && unc; ++nf)
      unc = cluster_any(chase_round(nx, stage, pool, nloc, blk), flags,
                        slot);
  }
  ZL4_CHASE_STOP(3, if (tid == 0) ok[b] = nx[0])

  // the final gather, four bytes a thread and a store where blk allows
  int bad = 0;
  uint8_t* out = out_all + b * blk + j0;
  auto byte_at = [&](int i, int p) -> uint32_t {
    const bool conv = p >= blk;
    bad |= !conv;
    return j0 + i < v.out_len && conv
               ? __ldg(v.comp + min(p - blk, fetch - 1)) : 0u;
  };
  if ((blk & 3) == 0) {
    for (int i4 = tid; i4 < nloc >> 2; i4 += kThreads) {
      const int4 p4 = reinterpret_cast<const int4*>(nx)[i4];
      const int i = i4 << 2;
      reinterpret_cast<uint32_t*>(out)[i4] =
          byte_at(i, p4.x) | byte_at(i + 1, p4.y) << 8 |
          byte_at(i + 2, p4.z) << 16 | byte_at(i + 3, p4.w) << 24;
    }
  } else {
    for (int i = tid; i < nloc; i += kThreads) out[i] = byte_at(i, nx[i]);
  }
  bad = cluster_any(bad, flags, slot);
  if (r == 0 && tid == 0) {
    ok[b] = !bad;
    if (rounds) rounds[b] = nd | nf << 16;
  }
  cluster.sync();  // no CTA leaves while another reads its flags
}

// The cluster launch of B blocks of blk bytes, with the kernel's
// shared-memory limit raised once per device.
cudaError_t chase_cluster_config(int B, int blk, cudaStream_t stream,
                                 cudaLaunchConfig_t* cfg,
                                 cudaLaunchAttribute* attr) {
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(frag_chase_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)chase_smem(kChaseRows));
    if (err != cudaSuccess) return err;
    if (dev < 32) raised |= 1u << dev;
  }
  const int C = chase_cluster(blk);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * (unsigned)C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = chase_smem(blk < kChaseRows ? blk : kChaseRows);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int zl4_frag_decode(
    const uint8_t* comp, const int32_t* fdst, const int32_t* fsrc,
    const int32_t* fper, const int32_t* fphase, const int32_t* nfrag,
    const int32_t* out_len, int32_t* src, uint32_t* known, uint8_t* out,
    int32_t* ok, int B, int fetch, int ncol, int blk, int rounds,
    cudaStream_t stream) {
  frag_decode_kernel<<<B, kThreads, 0, stream>>>(
      comp, fdst, fsrc, fper, fphase, nfrag, out_len, src, known, out, ok,
      fetch, ncol, blk, rounds);
  return (int)cudaGetLastError();
}

extern "C" int zl4_frag_decode_win(
    const uint8_t* comp, const int32_t* fdst, const int32_t* fsrc,
    const int32_t* fper, const int32_t* fphase, const int32_t* nfrag,
    const int32_t* out_len, int32_t* src, uint32_t* known, uint32_t* words,
    uint8_t* out, int32_t* ok, int B, int fetch, int ncol, int blk,
    int rounds, int g, int wins, int pool, int lit_wins, int lit_pool,
    cudaStream_t stream) {
  if ((g != 8 && g != 16) || blk % 64) return (int)cudaErrorInvalidValue;
  if (g == 8)
    frag_decode_win_kernel<8><<<B, kThreads, 0, stream>>>(
        comp, fdst, fsrc, fper, fphase, nfrag, out_len, src, known, words,
        out, ok, fetch, ncol, blk, rounds, wins, pool, lit_wins, lit_pool);
  else
    frag_decode_win_kernel<16><<<B, kThreads, 0, stream>>>(
        comp, fdst, fsrc, fper, fphase, nfrag, out_len, src, known, words,
        out, ok, fetch, ncol, blk, rounds, wins, pool, lit_wins, lit_pool);
  return (int)cudaGetLastError();
}

extern "C" int zl4_frag_decode_chase(
    const uint8_t* comp, const int32_t* fdst, const int32_t* fsrc,
    const int32_t* fper, const int32_t* fphase, const int32_t* nfrag,
    const int32_t* out_len, int32_t* nx, uint32_t* words, int32_t* pool,
    uint8_t* out, int32_t* ok, int32_t* rounds, int B, int fetch, int ncol,
    int blk, int dense, int doublings, int qcap, int C,
    cudaStream_t stream) {
  // C: the cluster's CTAs (chase_cluster(blk)), the state in their shared
  // memory; 0: the state in nx int32[B, 2, blk], words and pool, which
  // the cluster route never reads.  rounds: int32[B], dense rounds | the
  // frontier's << 16, or null.
  if (B <= 0 || blk <= 0 || fetch <= 0 || C != chase_cluster(blk))
    return (int)cudaErrorInvalidValue;
  if (C == 0) {
    frag_decode_chase_kernel<<<B, kThreads, 0, stream>>>(
        comp, fdst, fsrc, fper, fphase, nfrag, out_len, nx, words, pool,
        out, ok, rounds, fetch, ncol, blk, dense, doublings, qcap);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = chase_cluster_config(B, blk, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, frag_chase_cluster_kernel, comp, fdst, fsrc,
                           fper, fphase, nfrag, out_len, out, ok, rounds,
                           fetch, ncol, blk, dense, doublings, qcap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster route's launch shape for blk-byte blocks on the current
// device: out[0] CTAs a cluster (0: the device-memory kernel), out[1]
// shared-memory bytes a CTA, out[2] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: the shape cannot be scheduled).
extern "C" int zl4_frag_decode_chase_shape(int blk, int* out) {
  if (blk <= 0) return (int)cudaErrorInvalidValue;
  out[0] = chase_cluster(blk);
  out[1] = out[2] = 0;
  if (!out[0]) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = chase_cluster_config(1, blk, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  out[1] = (int)cfg.dynamicSmemBytes;
  return (int)cudaOccupancyMaxActiveClusters(&out[2],
                                             frag_chase_cluster_kernel, &cfg);
}
