// Fused coordinate-transform + spatial-decoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel pyroved_tpu/ops/spatial_decoder.py::_fwd_kernel.
// For each sample b and pixel n it computes
//
//   u_b = sc_b * (cos phi_b * Wc0 + sin phi_b * Wc1)      (D = 2; D = 1: u = Wc0)
//   v_b = sc_b * (-sin phi_b * Wc0 + cos phi_b * Wc1)     (D = 2; D = 1: v = 0)
//   w_b = dx_b @ Wc + bc + z_b @ Wz
//   h0  = tanh(gx_n * u_b + gy_n * v_b + w_b)             (Pade tanh for tanh_approx)
//   h_{l+1} = act(h_l @ W_l + b_l)                        l = 0 .. n_layers-1
//   out[b, n, c] = (sigmoid)(h_L . wout[:, c] + bout[c])
//
// which is the spatial decoder on the rotated, scaled and shifted grid with
// the transform folded into three per-sample H-vectors. With bf16 set (the
// port's BF16_MATMUL, as the JAX kernel's :448) both operands of each
// hidden product h_l @ W_l are rounded to bf16 first: the weights as they
// are staged, h_l as it is stored; the head reads h_L in f32. A product of
// two bf16 values is exact in f32, so this is the tensor cores' arithmetic.
//
// What bounds it: about 2 * n_layers * H^2 flops per pixel against 4 bytes
// of output per pixel and channel, so the work is arithmetic, not traffic.
// This first version computes in f32 on the CUDA cores (bound: the f32
// non-tensor peak); bf16 wgmma with TMA-staged weights is later work.
//
// Design:
//  * One block = one sample b and a tile of R = 64 pixels, 256 threads.
//    The per-sample vectors u, v, w are computed once per block into shared
//    memory, not once per pixel.
//  * The tile's activations [R, H] live in shared memory (one buffer: each
//    layer's outputs are held in registers until every thread has read the
//    layer's inputs, then written back in place).
//  * A layer's weights [H, H] do not fit in shared memory beside the
//    activations for H = 256, so they stream through shared memory in
//    chunks of KC = 32 input rows.
//  * Each thread owns 8 rows x H/32 columns of the layer output in
//    registers: a warp reads one activation row as a broadcast and 32
//    consecutive weight columns without bank conflicts.
//  * The head is one warp-reduced dot per (row, channel).
//  * The ragged last tile is masked in the kernel: rows past N are computed
//    on a zero coordinate and never stored. The output is written straight
//    in [B, N, C] layout ([B, N] when C = 1).
//  * Nothing is allocated here and nothing synchronises with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                 // pixels per block
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kRows / kWarps;
constexpr int kChunk = 32;                // weight rows staged per step
constexpr int kMaxDevices = 64;

enum Act { ACT_TANH = 0, ACT_RELU = 1, ACT_LRELU = 2, ACT_SOFTPLUS = 3,
           ACT_GELU = 4, ACT_TANH_APPROX = 5 };

__device__ __forceinline__ float pade_tanh(float x) {
  // 7/6 Pade approximant with the input clamp (a different function from
  // tanh, kept exactly as the reference defines it)
  x = fminf(fmaxf(x, -4.97f), 4.97f);
  const float x2 = x * x;
  const float num = x * (135135.0f + x2 * (17325.0f + x2 * (378.0f + x2)));
  const float den = 135135.0f + x2 * (62370.0f + x2 * (3150.0f + 28.0f * x2));
  return num / den;
}

template <int ACT>
__device__ __forceinline__ float h0_act(float x) {
  return ACT == ACT_TANH_APPROX ? pade_tanh(x) : tanhf(x);
}

template <int ACT>
__device__ __forceinline__ float act_fn(float x) {
  if (ACT == ACT_TANH) return tanhf(x);
  if (ACT == ACT_RELU) return x > 0.0f ? x : 0.0f;
  if (ACT == ACT_LRELU) return x >= 0.0f ? x : 0.01f * x;
  if (ACT == ACT_SOFTPLUS) return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  if (ACT == ACT_GELU) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  return pade_tanh(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  // never exponentiates a positive number, so no overflow for any logit
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__host__ __device__ constexpr size_t smem_floats(int H) {
  return (size_t)kRows * H + (size_t)kChunk * H + 3 * (size_t)H + 2 * kRows;
}

template <int H, int ACT>
__global__ void __launch_bounds__(kThreads)
sdec_fwd_kernel(const float* __restrict__ grid, const float* __restrict__ phi,
                const float* __restrict__ dx, const float* __restrict__ sc,
                const float* __restrict__ z, const float* __restrict__ wc,
                const float* __restrict__ bc, const float* __restrict__ wz,
                const float* __restrict__ hw, const float* __restrict__ hb,
                const float* __restrict__ wout, const float* __restrict__ bout,
                float* __restrict__ out, int N, int D, int L, int n_layers,
                int C, int sigmoid_out, int bf16, int n_tiles) {
  constexpr int TN = H / 32;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kRows][H] activations
  float* ws = hs + kRows * H;                   // [kChunk][H] weight chunk
  float* us = ws + kChunk * H;                  // [H]
  float* vs = us + H;                           // [H]
  float* wv = vs + H;                           // [H]
  float* gs = wv + H;                           // [kRows][2] coordinates

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x % n_tiles;
  const int b = blockIdx.x / n_tiles;
  const int n0 = tile * kRows;
  const int rows = min(kRows, N - n0);

  // per-sample folded transform
  float cph = 1.0f, sph = 0.0f, scale = 1.0f;
  if (D == 2) {
    sincosf(phi[b], &sph, &cph);
    scale = sc[b];
  }
  for (int h = tid; h < H; h += kThreads) {
    float w = 0.0f;
    for (int d = 0; d < D; ++d) w += dx[b * D + d] * wc[d * H + h];
    w += bc[h];
    float wzl = 0.0f;
    for (int l = 0; l < L; ++l) wzl += z[(size_t)b * L + l] * wz[l * H + h];
    wv[h] = w + wzl;
    const float a0 = wc[h];
    if (D == 2) {
      const float a1 = wc[H + h];
      us[h] = scale * (cph * a0 + sph * a1);
      vs[h] = scale * (-sph * a0 + cph * a1);
    } else {
      us[h] = a0;
      vs[h] = 0.0f;
    }
  }
  for (int r = tid; r < kRows; r += kThreads) {
    float gx = 0.0f, gy = 0.0f;
    if (r < rows) {
      gx = grid[(size_t)(n0 + r) * D];
      if (D == 2) gy = grid[(size_t)(n0 + r) * D + 1];
    }
    gs[2 * r] = gx;
    gs[2 * r + 1] = gy;
  }
  __syncthreads();

  // h0: coordinate/latent fusion (rounded when it feeds a bf16 product)
  const bool round_h0 = bf16 && n_layers > 0;
  for (int i = tid; i < kRows * H; i += kThreads) {
    const int r = i / H, h = i - r * H;
    const float v = h0_act<ACT>(gs[2 * r] * us[h] + gs[2 * r + 1] * vs[h] + wv[h]);
    hs[i] = round_h0 ? bf16_round(v) : v;
  }
  __syncthreads();

  // hidden layers
  const int row0 = warp * kRowsPerThread;
  for (int layer = 0; layer < n_layers; ++layer) {
    const float* W = hw + (size_t)layer * H * H;
    float acc[kRowsPerThread][TN];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;

    for (int k0 = 0; k0 < H; k0 += kChunk) {
      const float4* src = reinterpret_cast<const float4*>(W + (size_t)k0 * H);
      float4* dst = reinterpret_cast<float4*>(ws);
      for (int i = tid; i < kChunk * H / 4; i += kThreads) {
        float4 v = src[i];
        if (bf16) {
          v.x = bf16_round(v.x);
          v.y = bf16_round(v.y);
          v.z = bf16_round(v.z);
          v.w = bf16_round(v.w);
        }
        dst[i] = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kChunk; kk += 4) {
        float4 a[kRowsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          a[r] = *reinterpret_cast<const float4*>(hs + (row0 + r) * H + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float wq[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j) wq[j] = ws[(kk + q) * H + lane + 32 * j];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            const float av = q == 0 ? a[r].x : q == 1 ? a[r].y
                           : q == 2 ? a[r].z : a[r].w;
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(av, wq[j], acc[r][j]);
          }
        }
      }
      // every read of hs and ws for this chunk is done before the next
      // chunk (or the layer's outputs) overwrite them
      __syncthreads();
    }
    const float* bias = hb + (size_t)layer * H;
    const bool round_out = bf16 && layer + 1 < n_layers;  // feeds a product
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = lane + 32 * j;
      const float bj = bias[col];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float v = act_fn<ACT>(acc[r][j] + bj);
        hs[(row0 + r) * H + col] = round_out ? bf16_round(v) : v;
      }
    }
    __syncthreads();
  }

  // head: one warp-reduced dot per (row, channel)
  for (int r = warp; r < rows; r += kWarps) {
    for (int c = 0; c < C; ++c) {
      float p = 0.0f;
      for (int k = lane; k < H; k += 32) p += hs[r * H + k] * wout[k * C + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) {
        const float logit = p + bout[c];
        out[((size_t)b * N + n0 + r) * C + c] = sigmoid_out ? sigmoid(logit) : logit;
      }
    }
  }
}

// Opt the kernel into more than 48 KB of dynamic shared memory. The
// attribute belongs to the device's context and stays set, so it is set
// once per template instance and device, not on every launch.
template <int H, int ACT>
cudaError_t allow_smem(int smem) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(sdec_fwd_kernel<H, ACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int H, int ACT>
cudaError_t launch(const float* grid, const float* phi, const float* dx,
                   const float* sc, const float* z, const float* wc,
                   const float* bc, const float* wz, const float* hw,
                   const float* hb, const float* wout, const float* bout,
                   float* out, int B, int N, int D, int L, int n_layers, int C,
                   int sigmoid_out, int bf16, cudaStream_t stream) {
  const int smem = (int)(smem_floats(H) * sizeof(float));
  cudaError_t err = allow_smem<H, ACT>(smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + kRows - 1) / kRows;
  const long long blocks = (long long)n_tiles * B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  sdec_fwd_kernel<H, ACT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, out, N, D, L,
      n_layers, C, sigmoid_out, bf16, n_tiles);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_act(int act, const float* grid, const float* phi,
                       const float* dx, const float* sc, const float* z,
                       const float* wc, const float* bc, const float* wz,
                       const float* hw, const float* hb, const float* wout,
                       const float* bout, float* out, int B, int N, int D,
                       int L, int n_layers, int C, int sigmoid_out, int bf16,
                       cudaStream_t stream) {
#define PVT_LAUNCH(A)                                                        \
  return launch<H, A>(grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, \
                      out, B, N, D, L, n_layers, C, sigmoid_out, bf16, stream)
  switch (act) {
    case ACT_TANH: PVT_LAUNCH(ACT_TANH);
    case ACT_RELU: PVT_LAUNCH(ACT_RELU);
    case ACT_LRELU: PVT_LAUNCH(ACT_LRELU);
    case ACT_SOFTPLUS: PVT_LAUNCH(ACT_SOFTPLUS);
    case ACT_GELU: PVT_LAUNCH(ACT_GELU);
    case ACT_TANH_APPROX: PVT_LAUNCH(ACT_TANH_APPROX);
    default: return cudaErrorInvalidValue;
  }
#undef PVT_LAUNCH
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: grid [N, D], phi/sc [B],
// dx [B, D], z [B, L], wc [D, H], bc [H], wz [L, H], hw [n_layers, H, H]
// (input-major), hb [n_layers, H], wout [H, C], bout [C], out [B, N, C];
// all float32, contiguous, on the device of `stream`. H is 128 or 256;
// bf16 != 0 rounds the hidden products' operands to bf16. Returns the
// launch's cudaError_t (0 on success).
extern "C" int pvt_sdec_fwd(const float* grid, const float* phi,
                            const float* dx, const float* sc, const float* z,
                            const float* wc, const float* bc, const float* wz,
                            const float* hw, const float* hb,
                            const float* wout, const float* bout, float* out,
                            int B, int N, int D, int L, int H, int n_layers,
                            int C, int act, int sigmoid_out, int bf16,
                            void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 2 || C < 1 || n_layers < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (H) {
    case 128:
      return (int)launch_act<128>(act, grid, phi, dx, sc, z, wc, bc, wz, hw,
                                  hb, wout, bout, out, B, N, D, L, n_layers,
                                  C, sigmoid_out, bf16, s);
    case 256:
      return (int)launch_act<256>(act, grid, phi, dx, sc, z, wc, bc, wz, hw,
                                  hb, wout, bout, out, B, N, D, L, n_layers,
                                  C, sigmoid_out, bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
