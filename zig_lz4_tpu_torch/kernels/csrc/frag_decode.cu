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
// columns below nfrag and the output row cross it once; the state lives
// in scratch that the L2 serves.  Design: one thread block of 1024
// threads per LZ4 block, a block-wide barrier between dependency levels,
// double-buffered state so that a round reads the state of its start
// (known-bit masks for the value decoders, the position array for the
// chase), and an early exit from the rounds once nothing changes.

#include "frag_common.cuh"

namespace {

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
                         uint8_t* out_all, int32_t* ok, int fetch, int ncol,
                         int blk, int dense, int doublings, int qcap) {
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
  for (int r = 0; r < dense && unconverged; ++r) {
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
    for (int r = 0; r < doublings && unconverged; ++r) {
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
  if (threadIdx.x == 0) ok[b] = !bad;
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
    uint8_t* out, int32_t* ok, int B, int fetch, int ncol, int blk, int dense,
    int doublings, int qcap, cudaStream_t stream) {
  frag_decode_chase_kernel<<<B, kThreads, 0, stream>>>(
      comp, fdst, fsrc, fper, fphase, nfrag, out_len, nx, words, pool, out,
      ok, fetch, ncol, blk, dense, doublings, qcap);
  return (int)cudaGetLastError();
}
