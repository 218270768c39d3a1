// A bitonic network over int32 (key, payload) rows, each row resident in
// the shared memory of one thread-block cluster.
//
// The network is the one of the JAX package's probe
// (experiments/pallas_sort_probe.py): stages k = 2, 4, ..., N and, in each,
// j = k/2, ..., 1; the pair (i, i + j) with bit j of i clear is ascending
// when bit k of i is clear (so the last merge, k = N, is all ascending), and
// its two pairs are exchanged only when the keys are strictly out of order,
// so equal keys keep their payloads and the network is not stable.  Any
// schedule that runs every stage in order on the same index pairs gives the
// same bytes; this one places each stage at the cheapest level its stride
// allows.
//
// Layout: a CTA of T threads (T <= 256) holds S = 16 T pairs, 32 KB at
// T = 256, and a cluster of C CTAs (C <= 16, past the portable 8) holds C S
// pairs, 65,536 at most; index i of a chunk lies in CTA i / S.  Between
// stages the pairs live in registers, thread t of CTA r holding the 16
// consecutive pairs r S + 16 t + e ("natural" layout).  A stage of stride j
// runs
//   j < 16        in the thread's registers, no barrier;
//   16 <= j < T   between the lanes of a warp by __shfl_xor_sync;
//   T <= j < S    in registers again after one round trip through shared
//                 memory into the "transposed" layout, thread t holding
//                 pairs t + e T, whose indices differ in the 4 bits of j;
//                 every such stage of one k runs on one load;
//   S <= j        in registers after a round trip through the cluster's
//                 distributed shared memory: a thread gathers 16 / C columns
//                 of C pairs (one from each CTA), so all stages across CTAs
//                 of one k run on one load, between two cluster.sync().
// At N = 65,536 that is 58 stages in registers, 42 by shuffle, 26 after 8
// shared-memory round trips and 10 after 4 trips across the cluster.  Shared
// memory has a pad slot after every 16 pairs, so that both layouts are free
// of bank conflicts.  The exchange across the cluster reads remote pairs
// and writes them back; pushing them with remote stores and reading local
// ones was slower on the H100.
//
// Rows longer than a cluster holds (65,536 pairs) are sorted in chunks:
// each chunk whole in the cluster, then
// for every k past a chunk the strides j >= 65,536 as passes over the row in
// device memory, ordered by cluster.sync(), and the rest of the k chunk by
// chunk in the cluster.  Rows shorter than 16 pairs are padded with
// INT_MAX keys, which the network never moves ahead of a real key.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kPer = 16;                    // pairs a thread holds
constexpr int kMaxThreads = 256;            // threads of a full CTA
constexpr int kShare = kPer * kMaxThreads;  // 4,096 pairs, 32 KB
constexpr int kMaxCluster = 16;             // CTAs of a full cluster

// Keys travel with their run's direction folded in: inside stage k a key at
// index i is held as key ^ d(i), d(i) = -1 when bit k of i is set (a
// descending run) and 0 otherwise.  NOT reverses the int32 order without
// overflow, and both keys of a pair share bit k, so every compare-exchange
// of the network becomes an ascending one on the held keys, exchanged only
// when strictly out of order as before: a min, a max, one compare and two
// selects of the payloads, with no direction to compute.
__device__ __forceinline__ void cmp_exchange(int2& lo, int2& hi) {
  const bool swap = hi.x < lo.x;
  const int2 a = lo, b = hi;
  lo = make_int2(min(a.x, b.x), swap ? b.y : a.y);
  hi = make_int2(max(a.x, b.x), swap ? a.y : b.y);
}

// One stage on the 16 pairs a thread holds, partners D slots apart.
template <int D>
__device__ __forceinline__ void reg_stage(int2 (&x)[kPer]) {
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (!(e & D)) cmp_exchange(x[e], x[e | D]);
}

// The stages j, j / 2, ... while j >= lo, in registers, where a stride of
// ``unit`` is one slot; returns the next stride.
__device__ __forceinline__ int reg_stages(int2 (&x)[kPer], int j, int lo,
                                          int unit) {
  for (; j >= lo; j >>= 1) {
    switch (j / unit) {
      case 8: reg_stage<8>(x); break;
      case 4: reg_stage<4>(x); break;
      case 2: reg_stage<2>(x); break;
      default: reg_stage<1>(x); break;
    }
  }
  return j;
}

// one stage of stride j, 16 <= j < T, between the lanes of a warp: the
// partner of thread t holds the pairs j away at thread t ^ j / 16; the lower
// thread keeps the smaller held key, the upper the larger
__device__ __forceinline__ void shfl_stage(int2 (&x)[kPer], int j) {
  const int m = j / kPer;
  const bool upper = threadIdx.x & m;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int pk = __shfl_xor_sync(0xffffffffu, x[e].x, m);
    const int pv = __shfl_xor_sync(0xffffffffu, x[e].y, m);
    const int nk = upper ? max(x[e].x, pk) : min(x[e].x, pk);
    if (nk != x[e].x) x[e] = make_int2(nk, pv);
  }
}

// shared-memory slot of pair i: one pad slot after every 16, so that 16
// lanes reading 16 consecutive pairs, or a thread's 16 pairs apiece, hit
// distinct banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

struct ClusterRow {
  int T, S, C;  // threads of a CTA, pairs of a CTA, CTAs of the cluster
  int r;        // this CTA's rank in the cluster
  int2* sm;     // this CTA's S + S / 16 pair slots of shared memory

  // natural slot e of thread t: pair 16 t + e
  __device__ __forceinline__ void to_shared(const int2 (&x)[kPer]) const {
    int2* p = sm + threadIdx.x * (kPer + 1);
#pragma unroll
    for (int e = 0; e < kPer; ++e) p[e] = x[e];
  }
  __device__ __forceinline__ void from_shared(int2 (&x)[kPer]) const {
    const int2* p = sm + threadIdx.x * (kPer + 1);
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[e] = p[e];
  }

  // the held keys of natural slots in stage k (see cmp_exchange); XOR
  // again to undo
  __device__ __forceinline__ void fold(int2 (&x)[kPer], int nat,
                                       int k) const {
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[e].x ^= -(int)(((nat | e) & k) != 0);
  }

  // The stages (k, j) for k = kfirst .. klast and, in each, j from
  // (k == kfirst ? jtop : k / 2) down to 1, on the chunk of the row that
  // starts at network index cb; ``x`` holds the thread's pairs in the
  // natural layout before and after.
  __device__ __forceinline__ void run(int2 (&x)[kPer], int cb, int kfirst,
                                      int klast, int jtop) const {
    cg::cluster_group cluster = cg::this_cluster();
    const int t = threadIdx.x;
    const int nat = cb + r * S + t * kPer;  // index of natural slot 0
    const int tlo = T > kPer ? T : kPer;    // least stride of the transposed
    for (int k = kfirst; k <= klast; k <<= 1) {
      int j = k == kfirst ? jtop : k >> 1;
      bool shared = false;
      fold(x, nat, k);
      if (j >= S) {  // across the cluster's CTAs
        // slot e holds the pair of column col0 + (e % per) C T of CTA
        // e / per, read and written back through distributed shared memory
        to_shared(x);
        cluster.sync();
        const int per = kPer / C, lp = __ffs(per) - 1;
        const int col0 = r * T + t;
        auto at = [&](int e) {
          return cluster.map_shared_rank(sm, e >> lp) +
                 padded(col0 + (e & (per - 1)) * C * T);
        };
#pragma unroll
        for (int e = 0; e < kPer; ++e) x[e] = *at(e);
        j = reg_stages(x, j, S, S / per);
#pragma unroll
        for (int e = 0; e < kPer; ++e) *at(e) = x[e];
        cluster.sync();
        shared = true;
      }
      if (j >= tlo) {  // inside the CTA, transposed: pairs t + e T
        if (!shared) {
          to_shared(x);
          __syncthreads();
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) x[e] = sm[padded(t + e * T)];
        j = reg_stages(x, j, tlo, T);
#pragma unroll
        for (int e = 0; e < kPer; ++e) sm[padded(t + e * T)] = x[e];
        __syncthreads();
        shared = true;
      }
      if (shared) from_shared(x);
      for (; j >= kPer; j >>= 1) shfl_stage(x, j);
      reg_stages(x, j, 1, 1);
      fold(x, nat, k);
    }
  }
};

// the thread's natural pairs [l0, l0 + 16) of a row of n, read through L2
// (other CTAs of the cluster write the row between passes); INT_MAX keys
// past n
__device__ __forceinline__ void load_pairs(int2 (&x)[kPer],
                                           const int32_t* keys,
                                           const int32_t* vals, int l0,
                                           int n) {
  if (l0 + kPer <= n &&
      ((reinterpret_cast<uintptr_t>(keys + l0) |
        reinterpret_cast<uintptr_t>(vals + l0)) & 15) == 0) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      const int4 k4 = __ldcg(reinterpret_cast<const int4*>(keys + l0) + v);
      const int4 v4 = __ldcg(reinterpret_cast<const int4*>(vals + l0) + v);
      x[4 * v] = make_int2(k4.x, v4.x);
      x[4 * v + 1] = make_int2(k4.y, v4.y);
      x[4 * v + 2] = make_int2(k4.z, v4.z);
      x[4 * v + 3] = make_int2(k4.w, v4.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      x[e] = l0 + e < n ? make_int2(__ldcg(keys + l0 + e),
                                    __ldcg(vals + l0 + e))
                        : make_int2(INT_MAX, 0);
  }
}

__device__ __forceinline__ void store_pairs(const int2 (&x)[kPer],
                                            int32_t* keys, int32_t* vals,
                                            int l0, int n) {
  if (l0 + kPer <= n &&
      ((reinterpret_cast<uintptr_t>(keys + l0) |
        reinterpret_cast<uintptr_t>(vals + l0)) & 15) == 0) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      reinterpret_cast<int4*>(keys + l0)[v] =
          make_int4(x[4 * v].x, x[4 * v + 1].x, x[4 * v + 2].x,
                    x[4 * v + 3].x);
      reinterpret_cast<int4*>(vals + l0)[v] =
          make_int4(x[4 * v].y, x[4 * v + 1].y, x[4 * v + 2].y,
                    x[4 * v + 3].y);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (l0 + e < n) {
        keys[l0 + e] = x[e].x;
        vals[l0 + e] = x[e].y;
      }
  }
}

// Sorts the row (keys, vals)[0, n) into (kout, vout): n a power of two; the
// calling cluster is laid out as ``row`` says, and every thread of it calls.
__device__ __forceinline__ void cluster_sort_row(
    const ClusterRow& row, const int32_t* keys, const int32_t* vals,
    int32_t* kout, int32_t* vout, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  const int chunk = row.C * row.S;
  const int own = row.r * row.S + threadIdx.x * kPer;
  int2 x[kPer];
  for (int cb = 0; cb < n; cb += chunk) {  // every chunk sorted whole
    load_pairs(x, keys, vals, cb + own, n);
    row.run(x, cb, 2, chunk, 1);
    store_pairs(x, kout, vout, cb + own, n);
  }
  const int nt = row.C * row.T, gid = row.r * row.T + threadIdx.x;
  for (int k = chunk << 1; k <= n; k <<= 1) {
    cluster.sync();
    for (int j = k >> 1; j >= chunk; j >>= 1) {  // strides past the cluster
      for (int q = gid; q < (n >> 1); q += nt) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int l = i + j;
        const int a = __ldcg(kout + i), b = __ldcg(kout + l);
        if ((i & k) == 0 ? b < a : b > a) {
          const int va = __ldcg(vout + i), vb = __ldcg(vout + l);
          kout[i] = b;
          kout[l] = a;
          vout[i] = vb;
          vout[l] = va;
        }
      }
      cluster.sync();
    }
    for (int cb = 0; cb < n; cb += chunk) {
      load_pairs(x, kout, vout, cb + own, n);
      row.run(x, cb, k, k, chunk >> 1);
      store_pairs(x, kout, vout, cb + own, n);
    }
  }
}

}  // namespace
