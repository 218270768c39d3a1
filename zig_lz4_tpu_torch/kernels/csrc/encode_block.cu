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
// enc_match (hc >= 1; one 1024-thread block per window):
//   window build (:249-272) into shared memory, a bitonic sort of the
//   positions by (s0, su[i+4], su[i+8], i) -- the stable 3-key sort of
//   :349-350, since the index breaks every tie -- the +-1..+-hc probes of
//   cand_at (:379-450) on the sorted rows, the unsort as a store to the
//   position (:455-469), then the fallback order (s0, i) with probes +1
//   and +2 (:471-516).  Output per position: the reference's pack
//   ((cand + 1) << 12) | (fine ml << 6) | back, 0 when there is none.
//   Bound: the sort.  65536 u16 indices plus the 64 KB window fill 196 KB
//   of shared memory, so one window runs per SM; each of the 136 bitonic
//   stages recomputes 12-byte keys from the window in shared memory, so
//   the kernel is bound by shared-memory loads and issue, not by device
//   memory (it reads each window once and writes 4 bytes per position).
//
// enc_match_fast (hc == 0; same block shape and shared memory):
//   window build, ONE bitonic sort by (s0, i) -- the stable 1-key sort of
//   :348-352 -- and probes +1..+probes against the nearest previous rows
//   of the group, a later probe winning only when strictly longer
//   (:433-450), over W carried windows (fast_params, :179-197).  No
//   fallback pass.  Bound: the one sort, with 4-byte keys.
//
// enc_parse_emit (one 256-thread block per window, 8 KB shared memory):
//   same-offset chain extension (:522-552) as a chunked nearest-boundary
//   scan, the n-5 clamp (:554-555), two-step lazy deferral (:684-710; HC
//   only) as a bit mask built with warp ballots, then one thread walks the
//   mask for the greedy parse (:716-743) -- it jumps from match end to the
//   next set bit, so it costs words + matches, not positions -- and writes
//   the sequence headers (:871-1103: chained selections at one offset
//   merge, heads extend back over <= 2 literals, 255-escapes, LE offsets,
//   the tail literal run).  The literal runs it records are copied by all
//   warps.  Bound: the single parsing thread's dependent loads; the small
//   footprint lets every window of a launch run at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 8;         // u32 windows after s0 (jax_block.py:100)
constexpr int kPad = 64;         // zero bytes past blk (reads reach 4W+7)
constexpr int kMatchThreads = 1024;
constexpr int kParseThreads = 256;
constexpr int kImBit = 1 << 30;  // is_match flag beside ml in mlw

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

// Sorted position order; rows >= blk are padding that sorts last.
template <class Less>
__device__ void bitonic_sort(uint16_t* s, int N, Less less) {
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (N >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int l = i + j;
        const int a = s[i], c = s[l];
        if ((i & k) == 0 ? less(c, a) : less(a, c)) {
          s[i] = (uint16_t)c;
          s[l] = (uint16_t)a;
        }
      }
      __syncthreads();
    }
  }
}

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

// The window as zero-padded LE words in shared memory, and the identity
// order over N >= blk rows.
__device__ void load_window(const uint8_t* row, int n, uint32_t* words,
                            int nwords, uint16_t* s, int N) {
  for (int q = threadIdx.x; q < nwords; q += blockDim.x) {
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * q + k;
      if (p < n) v |= (uint32_t)row[p] << (8 * k);
    }
    words[q] = v;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) s[i] = (uint16_t)i;
  __syncthreads();
}

// Order by s0 alone, ties by position: within a group of equal 4-byte
// strings the rows before t are the nearest previous occurrences.
__device__ void sort_by_s0(const Window& W, uint16_t* s, int N, int blk) {
  bitonic_sort(s, N, [&](int p, int q) {
    if (p >= blk || q >= blk) return p < q;
    const uint32_t a = W.s0(p), c = W.s0(q);
    if (a != c) return a < c;
    return p < q;
  });
}

// Probes +1..+probes of sorted row t; a later probe wins only when
// strictly longer (jax_block.py:445, :500).
__device__ __forceinline__ Cand nearest(const Window& W, const uint16_t* s,
                                        int t, int probes, int nwin) {
  Cand best{-1, 0, 0};
  const int p = s[t];
  for (int k = 1; k <= probes && k <= t; ++k) {
    const Cand c = probe(W, p, s[t - k], nwin);
    if (c.ml > best.ml) best = c;
  }
  return best;
}

__global__ void __launch_bounds__(kMatchThreads)
enc_match_kernel(const uint8_t* __restrict__ data,
                 const int32_t* __restrict__ lens, int32_t* __restrict__ pk,
                 int blk, int N, int nwords, int hc) {
  extern __shared__ uint32_t smem[];
  uint32_t* words = smem;
  uint16_t* s = reinterpret_cast<uint16_t*>(smem + nwords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, N);
  const Window W{words, n};

  // 12-byte lexicographic order, ties by position
  bitonic_sort(s, N, [&](int p, int q) {
    if (p >= blk || q >= blk) return p < q;
    uint32_t a = W.s0(p), c = W.s0(q);
    if (a != c) return a < c;
    a = W.at(p + 4), c = W.at(q + 4);
    if (a != c) return a < c;
    a = W.at(p + 8), c = W.at(q + 8);
    if (a != c) return a < c;
    return p < q;
  });
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    Cand best{-1, 0, 0};
    for (int k = 1; k <= hc; ++k) {
      for (int side = 0; side < 2; ++side) {
        const int u = side ? t + k : t - k;
        if (u < 0 || u >= blk) continue;
        const Cand c = probe(W, p, s[u], kMaxW);
        if (c.ml > best.ml || (c.ml == best.ml && c.cand > best.cand)) best = c;
      }
    }
    out[p] = pack(best);
  }
  __syncthreads();

  // positional fallback: order by s0 alone, probes +1 and +2
  for (int i = threadIdx.x; i < N; i += blockDim.x) s[i] = (uint16_t)i;
  __syncthreads();
  sort_by_s0(W, s, N, blk);
  for (int t = threadIdx.x; t < blk; t += blockDim.x) {
    const int p = s[t];
    const Cand c = nearest(W, s, t, 2, kMaxW);
    if (c.ml > ((out[p] >> 6) & 63)) out[p] = pack(c);
  }
}

__global__ void __launch_bounds__(kMatchThreads)
enc_match_fast_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      int32_t* __restrict__ pk, int blk, int N, int nwords,
                      int nwin, int probes) {
  extern __shared__ uint32_t smem[];
  uint32_t* words = smem;
  uint16_t* s = reinterpret_cast<uint16_t*>(smem + nwords);
  const int b = blockIdx.x;
  const int n = min(max(lens[b], 0), blk);
  int32_t* out = pk + (size_t)b * blk;
  load_window(data + (size_t)b * blk, n, words, nwords, s, N);
  const Window W{words, n};
  sort_by_s0(W, s, N, blk);
  for (int t = threadIdx.x; t < blk; t += blockDim.x)
    out[s[t]] = pack(nearest(W, s, t, probes, nwin));
}

struct Fields {
  const int32_t* pk;
  int n, blk;
  int capped_ml;  // a fine ml from here on saturated the carried windows

  __device__ __forceinline__ int cand(int p) const { return (pk[p] >> 12) - 1; }
  __device__ __forceinline__ bool valid(int p) const {
    return p < blk && p <= n - 13 && cand(p) >= 0;
  }
  __device__ __forceinline__ int ml0(int p) const {
    return valid(p) ? (pk[p] >> 6) & 63 : 0;
  }
  __device__ __forceinline__ bool capped(int p) const {
    return valid(p) && ((pk[p] >> 6) & 63) >= capped_ml;
  }
  // row p continues a capped chain at the same offset into p + 1
  __device__ __forceinline__ bool link(int p) const {
    return capped(p) && valid(p + 1) && (p + 1 - cand(p + 1)) == (p - cand(p));
  }
};

__device__ __forceinline__ void put_len(uint8_t* o, int& op, int v) {
  for (; v >= 255; v -= 255) o[op++] = 255;
  o[op++] = (uint8_t)v;
}

__global__ void __launch_bounds__(kParseThreads)
enc_parse_emit_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ pk, int32_t* __restrict__ mlw,
                      int32_t* __restrict__ runs, uint8_t* __restrict__ out,
                      int32_t* __restrict__ out_len, int blk, int cap,
                      int runcap, int capped_ml, int lazy) {
  extern __shared__ uint32_t imask[];
  __shared__ int first_bnd[kParseThreads];
  __shared__ int s_nruns, s_olen;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(max(lens[b], 0), blk);
  const int start = min(max(starts[b], 0), n);
  const uint8_t* row = data + (size_t)b * blk;
  const Fields F{pk + (size_t)b * blk, n, blk, capped_ml};
  int32_t* M = mlw + (size_t)b * blk;
  int32_t* R = runs + (size_t)b * runcap;
  uint8_t* o = out + (size_t)b * cap;

  // --- chain extension: each capped row takes its length from the
  // nearest chain boundary at or after it (a reverse cummax in the
  // reference); chunked: local first boundary, carry, then a rescan
  const int chunk = (blk + kParseThreads - 1) / kParseThreads;
  const int lo = min(tid * chunk, blk), hi = min(lo + chunk, blk);
  int fb = blk;  // none in this chunk
  for (int p = lo; p < hi; ++p) {
    if (!F.link(p)) {
      fb = p;
      break;
    }
  }
  first_bnd[tid] = fb;
  __syncthreads();
  if (tid == 0) {
    int running = blk;  // row blk - 1 is always a boundary
    for (int t = kParseThreads - 1; t >= 0; --t) {
      const int f = first_bnd[t];
      first_bnd[t] = running;
      if (f < blk) running = f;
    }
  }
  __syncthreads();
  int nb = first_bnd[tid];
  for (int p = hi - 1; p >= lo; --p) {
    if (!F.link(p)) nb = p;
    int ml = F.ml0(p);
    if (F.capped(p)) ml = max(nb - p + min(F.ml0(nb), 2047), ml);
    ml = min(ml, max(n - 5 - p, 0));
    const bool im = F.valid(p) && ml >= 4 && p >= start;
    M[p] = ml | (im ? kImBit : 0);
  }
  __syncthreads();

  // --- two-step lazy deferral (HC only) into a bit mask of final match
  // rows
  const int lane = tid & 31, warp = tid >> 5;
  for (int base = warp * 32; base < blk; base += kParseThreads) {
    const int p = base + lane;
    bool keep = false;
    if (p < blk) {
      int m[5];
      bool im[5];
      for (int k = 0; k < 5; ++k) {
        const int v = p + k < blk ? M[p + k] : 0;
        m[k] = v & (kImBit - 1);
        im[k] = (v & kImBit) != 0;
      }
      const bool g1 = im[1] && m[1] > m[0] + 1;
      const bool g2 = im[2] && m[2] > m[0] + 2;
      const bool d0_1 = (im[2] && m[2] > m[1] + 1) || (im[3] && m[3] > m[1] + 2);
      const bool d0_2 = (im[3] && m[3] > m[2] + 1) || (im[4] && m[4] > m[2] + 2);
      const bool defer =
          lazy && im[0] && ((g1 && !d0_1) || (g2 && !d0_2 && (d0_1 || !im[1])));
      keep = im[0] && !defer;
    }
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) imask[base >> 5] = bits;
  }
  __syncthreads();

  // --- greedy parse and sequence headers (one thread)
  if (tid == 0) {
    int op = 0, nr = 0;
    if (n > start) {
      const int nw = (blk + 31) >> 5;
      int last_e = -1, pos = 0;
      bool have = false;
      int h_ls = 0, h_ms = 0, h_off = 0, h_e = 0;
      auto emit = [&]() {
        const int lit = h_ms - h_ls, mml = h_e - h_ms;
        o[op++] = (uint8_t)((min(lit, 15) << 4) | min(mml - 4, 15));
        if (lit >= 15) put_len(o, op, lit - 15);
        if (lit > 0) {
          R[3 * nr] = h_ls;
          R[3 * nr + 1] = op;
          R[3 * nr + 2] = lit;
          ++nr;
          op += lit;
        }
        o[op++] = (uint8_t)(h_off & 0xFF);
        o[op++] = (uint8_t)(h_off >> 8);
        if (mml - 4 >= 15) put_len(o, op, mml - 19);
      };
      while (true) {
        int wi = pos >> 5;
        if (wi >= nw) break;
        uint32_t bits = imask[wi] & (0xFFFFFFFFu << (pos & 31));
        while (bits == 0 && ++wi < nw) bits = imask[wi];
        if (bits == 0) break;
        const int p = (wi << 5) + __ffs(bits) - 1;
        const int e = p + (M[p] & (kImBit - 1));
        const int off = p - F.cand(p);
        if (have && last_e == p && h_off == off) {
          h_e = e;  // continues the previous match at the same offset
        } else {
          if (have) emit();
          const int prev_end = max(last_e, start);
          const int bq = max(min(min(F.pk[p] & 3, p - prev_end), p - off), 0);
          h_ls = prev_end;
          h_ms = p - bq;
          h_off = off;
          h_e = e;
          have = true;
        }
        last_e = e;
        pos = e;
      }
      if (have) emit();
      const int tail = max(last_e, start), lit = n - tail;
      o[op++] = (uint8_t)(min(lit, 15) << 4);
      if (lit >= 15) put_len(o, op, lit - 15);
      if (lit > 0) {
        R[3 * nr] = tail;
        R[3 * nr + 1] = op;
        R[3 * nr + 2] = lit;
        ++nr;
        op += lit;
      }
    }
    s_nruns = nr;
    s_olen = op;
    out_len[b] = op;
  }
  __syncthreads();

  // --- literal runs, one warp each; zeros past out_len
  const int nr = s_nruns, olen = s_olen;
  for (int r = warp; r < nr; r += kParseThreads / 32) {
    const int src = R[3 * r], dst = R[3 * r + 1], len = R[3 * r + 2];
    for (int k = lane; k < len; k += 32) o[dst + k] = row[src + k];
  }
  for (int k = olen + tid; k < cap; k += kParseThreads) o[k] = 0;
}

// Sort width, window words and shared memory of a match kernel launch.
struct MatchShape {
  int N, nwords;
  size_t smem;
};

MatchShape match_shape(int blk) {
  int N = 1;
  while (N < blk) N <<= 1;
  const int nwords = (blk + kPad) / 4 + 1;
  return {N, nwords, (size_t)nwords * 4 + (size_t)N * 2};
}

}  // namespace

extern "C" int zl4_enc_match(const void* data, const void* lens, void* pk,
                             int B, int blk, int hc, void* stream) {
  if (B <= 0 || blk <= 0 || blk > 65536 || hc < 1)
    return (int)cudaErrorInvalidValue;
  const MatchShape m = match_shape(blk);
  cudaError_t err = cudaFuncSetAttribute(
      enc_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)m.smem);
  if (err != cudaSuccess) return (int)err;
  enc_match_kernel<<<B, kMatchThreads, m.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)pk, blk, m.N,
      m.nwords, hc);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_match_fast(const void* data, const void* lens,
                                  void* pk, int B, int blk, int nwin,
                                  int probes, void* stream) {
  if (B <= 0 || blk <= 0 || blk > 65536 || nwin < 1 || nwin > kMaxW ||
      probes < 1)
    return (int)cudaErrorInvalidValue;
  const MatchShape m = match_shape(blk);
  cudaError_t err = cudaFuncSetAttribute(
      enc_match_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)m.smem);
  if (err != cudaSuccess) return (int)err;
  enc_match_fast_kernel<<<B, kMatchThreads, m.smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int32_t*)pk, blk, m.N,
      m.nwords, nwin, probes);
  return (int)cudaGetLastError();
}

extern "C" int zl4_enc_parse_emit(const void* data, const void* lens,
                                  const void* starts, const void* pk, void* mlw,
                                  void* runs, void* out, void* out_len, int B,
                                  int blk, int cap, int runcap, int capped_ml,
                                  int lazy, void* stream) {
  // runcap: ints per window of ``runs``, 3 per literal run; a window has
  // at most blk / 4 matches, so at most blk / 4 + 1 runs
  if (B <= 0 || blk <= 0 || blk > 65536 || runcap < 3 * (blk / 4 + 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((blk + 31) / 32) * 4;
  enc_parse_emit_kernel<<<B, kParseThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const int32_t*)starts,
      (const int32_t*)pk, (int32_t*)mlw, (int32_t*)runs, (uint8_t*)out,
      (int32_t*)out_len, blk, cap, runcap, capped_ml, lazy);
  return (int)cudaGetLastError();
}
