// The cost of synchronising the blocks of a thread-block cluster (sm_90a),
// for the design of the H = 256 kernels (spatial_decoder_fwd_tc.cu,
// spatial_decoder_bwd_tc.cu): every block of every cluster repeats one step
// `iters` times and reports its cycles a step (clock64). The steps:
//  * mode 0: the cluster barrier (barrier.cluster arrive, then wait);
//  * mode 1: `n` 4-byte stores a thread into every other block's shared
//    memory (st.shared::cluster), then the barrier;
//  * mode 2: mode 1 with fence.proxy.async.shared::cluster before the
//    barrier, which a wgmma reading the stored values needs;
//  * mode 3: the exchange the kernels use: n KB of each block's shared
//    memory copied into every other block by one thread (cp.async.bulk),
//    each block waiting on a transaction barrier of its own.
// pyroved_tpu_torch/tools/cluster_sync.py runs it. A measurement tool's
// kernel: nothing on the port's paths launches it.

#include "sm90_common.cuh"

namespace {

constexpr int kThreadsProbe = 256;
constexpr int kBarOffset = 160 * 1024;  // the barrier, after the data
constexpr int kSmem = kBarOffset + 16;

__global__ void __launch_bounds__(kThreadsProbe)
sync_probe(long long* __restrict__ out, int iters, int mode, int n) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t ncta;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ncta));
  const int cs = (int)ncta, rank = cluster_rank(), tid = threadIdx.x;
  const uint32_t base = smem_addr(smem), bar = base + kBarOffset;
  const int bytes = n * 1024;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect(bar, (cs - 1) * bytes);
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  int parity = 0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (mode == 3) {
      fence_async_smem();
      if (tid == 0) bulk_wait_read();
      __syncthreads();
      if (tid == 0) {
        for (int k = 1; k < cs; ++k) {
          const int r = (rank + k) % cs;
          bulk_to_rank(map_rank(base + rank * bytes, r), base + rank * bytes,
                       bytes, map_rank(bar, r));
        }
        bulk_commit();
      }
      mbar_wait(bar, parity);
      parity ^= 1;
      if (tid == 0) mbar_expect(bar, (cs - 1) * bytes);
      continue;
    }
    if (mode >= 1)
      for (int s = 0; s < n; ++s)
        for (int k = 1; k < cs; ++k) {
          const uint32_t dst = map_rank(base + 4 * tid + 1024 * s, (rank + k) % cs);
          asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(dst), "r"(i)
                       : "memory");
        }
    if (mode == 2)
      asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
    cluster_arrive();
    cluster_wait();
  }
  const long long t1 = clock64();
  // no block leaves while another may still copy into it
  if (tid == 0) bulk_wait_read();
  cluster_arrive();
  cluster_wait();
  if (tid == 0) out[blockIdx.x] = (t1 - t0) / iters;
}

}  // namespace

// Runs the probe on `blocks` blocks (a multiple of cs) in clusters of cs,
// writing each block's cycles a step to out[blocks] on `stream`. mode and n
// as above (n at most 16: stores in modes 1 and 2, KB in mode 3, the
// kernels' largest copy). Returns the launch's cudaError_t.
extern "C" int pvt_cluster_sync_probe(long long* out, int blocks, int cs,
                                      int iters, int mode, int n,
                                      void* stream) {
  if (cs < 2 || cs > 8 || blocks < cs || blocks % cs || iters < 1 ||
      mode < 0 || mode > 3 || n < 0 || n > 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sync_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreadsProbe);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sync_probe, out, iters, mode, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
