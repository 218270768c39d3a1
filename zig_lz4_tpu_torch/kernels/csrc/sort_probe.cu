// Batched key+payload bitonic sort of int32 rows.
//
// Replaces: pallas_sort2 of the JAX package's retired probe
// experiments/pallas_sort_probe.py (:80; pl.pallas_call :81, _kernel
// :54-76, _partner :39-51), a bitonic network over 65,536 int32 keys with an
// int32 payload held in VMEM: 136 compare-exchange stages, the last merge
// all ascending, and a row takes its partner's pair only when the partner's
// key is strictly smaller (or larger), so equal keys keep their pairs and
// the network is not stable.  The probe sorted one row per call; its note
// (:16-21) says the kernel needed to batch rows to be of use.
//
// bitonic_sort2: one thread-block cluster per row, the network of
// sort_cluster.cuh.  At N = 65,536 a row is 16 CTAs of 256 threads, each
// holding 4,096 pairs (32 KB) in registers and shared memory, so the row is
// read once and written once and its 136 stages run in registers, by warp
// shuffles, in shared memory and across the cluster's distributed shared
// memory; rows up to 4,096 pairs run in one CTA of N / 16 threads, longer
// rows in clusters of up to 16, with passes over device memory for the
// strides past 65,536.  The same pairs come out as from the probe, ties
// included.
// Bound: 16 bytes a pair in and out over the device memory.  The stages are
// N / 2 log2 N (log2 N + 1) / 2 compare-exchanges a row, each a compare, a
// min, a max and two selects on the integer pipes (half the float32 rate),
// and the 42 shuffle stages move 32 words a thread each, so at 64 rows the
// integer and shuffle throughput set the time, not the bytes.

#include "sort_cluster.cuh"

namespace {

// three CTAs a SM: more of a batch's clusters resident at once beat the
// fewer spills of two
__global__ void __launch_bounds__(kMaxThreads, 3)
bitonic_sort2_kernel(const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ vals,
                     int32_t* __restrict__ kout, int32_t* __restrict__ vout,
                     int N, int C) {
  extern __shared__ int2 sort_smem[];
  ClusterRow row;
  row.T = blockDim.x;
  row.S = row.T * kPer;
  row.C = C;
  row.r = (int)cg::this_cluster().block_rank();
  row.sm = sort_smem;
  const size_t base = (size_t)(blockIdx.x / C) * N;
  cluster_sort_row(row, keys + base, vals + base, kout + base, vout + base, N);
}

// threads a CTA, CTAs a cluster, and dynamic shared memory of a row of N
void shape(int N, int* T, int* C, int* smem) {
  *T = N >= kShare ? kMaxThreads : (N >= kPer ? N / kPer : 1);
  *C = N >= kShare ? (N / kShare < kMaxCluster ? N / kShare : kMaxCluster) : 1;
  *smem = (*T * kPer + *T) * (int)sizeof(int2);  // S pairs and S / 16 pads
}

// the launch of B rows of N, with the shared-memory limit raised once per
// device
cudaError_t configure(int B, int N, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  static unsigned raised = 0;  // devices whose limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(bitonic_sort2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (kShare + kMaxThreads) * (int)sizeof(int2));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bitonic_sort2_kernel,  // 16 CTAs: past 8
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    raised |= 1u << dev;
  }
  int T, C, smem;
  shape(N, &T, &C, &smem);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * (unsigned)C);
  cfg->blockDim = dim3((unsigned)T);
  cfg->dynamicSmemBytes = (size_t)smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool valid(int B, int N) {
  return B > 0 && N >= 2 && N <= (1 << 24) && (N & (N - 1)) == 0;
}

}  // namespace

extern "C" int zl4_bitonic_sort2(const void* keys, const void* vals,
                                 void* kout, void* vout, int B, int N,
                                 void* stream) {
  if (!valid(B, N)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(B, N, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, bitonic_sort2_kernel, (const int32_t*)keys,
                           (const int32_t*)vals, (int32_t*)kout,
                           (int32_t*)vout, N, (int)attr.val.clusterDim.x);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch shape of B rows of N on the current device: out[0] CTAs a
// cluster, out[1] threads a CTA, out[2] bytes of shared memory a CTA,
// out[3] the clusters the card holds at once (cudaOccupancyMaxActiveClusters;
// 0 means the shape cannot be scheduled).
extern "C" int zl4_bitonic_sort2_shape(int B, int N, int* out) {
  if (!valid(B, N)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(B, N, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  shape(N, &out[1], &out[0], &out[2]);
  return (int)cudaOccupancyMaxActiveClusters(&out[3], bitonic_sort2_kernel,
                                             &cfg);
}
