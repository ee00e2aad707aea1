// How the tensor cores add (sm_90a): one warpgroup computes D = A B^T,
// A [64, 16 S] and B [16, 16 S] bf16 (row-major, K contiguous), D [64, 16]
// f32, as S wgmma m64n16k16 steps, either chained in one accumulator or
// each in a fresh accumulator added into D in f32 on the CUDA cores. The
// products of bf16 values are exact in f32, so D's distance from the exact
// sums is the MMA's own addition: pyroved_tpu_torch/tools/x3_accuracy.py
// reads it against f64. A measurement tool's kernel: nothing on the port's
// paths launches it.

#include "sm90_common.cuh"

namespace {

constexpr int kMaxSteps = 64;

__global__ void __launch_bounds__(128)
mma_probe(const __nv_bfloat16* __restrict__ a,
          const __nv_bfloat16* __restrict__ b, float* __restrict__ d,
          int steps, int fresh) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int K = 16 * steps, rs = 16 * K;  // row-of-cores stride, bytes
  uint8_t* as = smem;
  uint8_t* bs = smem + 64 * K * 2;
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * K; i += 128)
    *reinterpret_cast<__nv_bfloat16*>(as + tiled(i / K, i % K, rs)) = a[i];
  for (int i = tid; i < 16 * K; i += 128)
    *reinterpret_cast<__nv_bfloat16*>(bs + tiled(i / K, i % K, rs)) = b[i];
  fence_async_smem();
  __syncthreads();
  const uint32_t aa = smem_addr(as), ba = smem_addr(bs);
  float acc[8], part[8];
  for (int v = 0; v < 8; ++v) acc[v] = 0.0f;
  for (int s = 0; s < steps; ++s) {
    wgmma_fence();
    if (fresh) {
      wgmma<16, 0, 0>(part, desc(aa + s * 256, 128, rs),
                      desc(ba + s * 256, 128, rs), 0);
      wgmma_commit_wait();
      fence_regs(part);
      for (int v = 0; v < 8; ++v) acc[v] += part[v];
    } else {
      wgmma<16, 0, 0>(acc, desc(aa + s * 256, 128, rs),
                      desc(ba + s * 256, 128, rs), s);
      wgmma_commit_wait();
      fence_regs(acc);
    }
  }
  // accumulator entry v of this thread: row 16 warp + lane / 4 + 8 (v / 2
  // % 2), column 8 (v / 4) + 2 (lane % 4) + v % 2
  const int w = tid >> 5, lane = tid & 31;
  for (int v = 0; v < 8; ++v) {
    const int row = 16 * w + (lane >> 2) + 8 * ((v >> 1) & 1);
    const int col = 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
    d[row * 16 + col] = acc[v];
  }
}

}  // namespace

// D [64, 16] from A [64, 16 steps] and B [16, 16 steps] (bf16 bits,
// row-major), steps 1 .. 64; fresh != 0 gives each step its own
// accumulator. Returns a cudaError_t.
extern "C" int pvt_mma_probe(const void* a, const void* b, float* d,
                             int steps, int fresh, void* stream) {
  if (steps < 1 || steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  const int bytes = 80 * 16 * steps * 2;
  cudaError_t err = cudaFuncSetAttribute(
      mma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  mma_probe<<<1, 128, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(a),
      reinterpret_cast<const __nv_bfloat16*>(b), d, steps, fresh);
  return (int)cudaGetLastError();
}
