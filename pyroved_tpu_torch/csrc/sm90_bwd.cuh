// What the two tensor-core K2/K3 sources share (sm_90a):
// spatial_decoder_bwd_tc.cu (bf16 products) and spatial_decoder_bwd_x3.cu
// (f32 products as three-limb bf16 splits). Both run one block of two
// warpgroups per SM that keeps 64 x 128 units of the weight grads in wgmma
// accumulators and writes them, with the block's other sums, to a slot of
// the workspace; the two kernels here reduce the slots and the per-tile
// du/dv/dw sums in a fixed order. Also the derivatives and the argument
// checks the two share.

#pragma once

#include <climits>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 2;                   // dW units a warpgroup keeps
constexpr int kPassUnits = 2 * kUnits;      // dW units a block keeps
constexpr int kUnitFloats = 64 * 128;       // one m64 x n128 accumulator
constexpr int kMaxC = 4;
constexpr int kMaxDevices = 64;

// d act / d pre from the f32 post-activation h, as the plain version
// takes it: relu's subgradient at 0 is 0, lrelu's 1, the Pade tanh takes
// 1 - h^2. Not for gelu, whose derivative needs the pre-activation.
template <int A>
__device__ __forceinline__ float grad_from_post(float h) {
  if constexpr (A == ACT_RELU) return h > 0.0f ? 1.0f : 0.0f;
  else if constexpr (A == ACT_LRELU) return h >= 0.0f ? 1.0f : 0.01f;
  else if constexpr (A == ACT_SOFTPLUS) return 1.0f - expf(-h);
  else return 1.0f - h * h;
}

// gelu's derivative Phi(x) + x phi(x)
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * expf(-0.5f * x * x);
}

// h = act(pre) and g = d act / d pre (gelu sharing its erff)
template <int A>
__device__ __forceinline__ void act_and_grad(float pre, float& h, float& g) {
  if constexpr (A == ACT_GELU) {
    const float e = erff(pre * 0.70710678118654752f);
    h = 0.5f * pre * (1.0f + e);
    g = 0.5f * (1.0f + e) + pre * 0.39894228040143268f * expf(-0.5f * pre * pre);
  } else {
    h = act_fn<A>(pre);
    g = grad_from_post<A>(h);
  }
}

// s += x with Kahan's compensation c (c starts at 0): the low bits each
// addition drops are carried into the next, so a long or cancelling sum
// keeps f32's precision
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// floats of the small per-tile buffers and block sums in shared memory
inline int small_floats(int H, int R, int nl, int C) {
  return 3 * H + 2 * R + kMaxC * R + R + kWarps * R * C + nl * H + H * C + C +
         1;
}

// Sum over the block in a fixed order; every thread gets the result.
template <int H, typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // earlier reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int w = 0; w < H / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// Per-sample epilogue: one block per sample, one thread per hidden unit.
// Sums the sample's tile partials in tile order into duvw [B][3][H], then
// dphi, dsc, ddx and dz by the folded-transform formulas, in T (float for
// the bf16 kernel, double for the f32 one: these sums over the tiles and
// the units may cancel to far below their terms).
template <int H, typename T>
__device__ __forceinline__ void samples_body(
    const float* __restrict__ tile_ws, float* __restrict__ duvw,
    const float* __restrict__ phi, const float* __restrict__ sc,
    const float* __restrict__ wc, const float* __restrict__ wz,
    float* __restrict__ dphi, float* __restrict__ ddx, float* __restrict__ dsc,
    float* __restrict__ dz, int n_tiles, int D, int L) {
  __shared__ T red[H / 32];
  const int b = blockIdx.x, h = threadIdx.x;
  const float* tw = tile_ws + (size_t)b * n_tiles * 3 * H;
  T su = 0, sv = 0, sw = 0;
  for (int t = 0; t < n_tiles; ++t) {
    su += tw[(size_t)t * 3 * H + h];
    sv += tw[(size_t)t * 3 * H + H + h];
    sw += tw[(size_t)t * 3 * H + 2 * H + h];
  }
  float* o = duvw + (size_t)b * 3 * H;
  o[h] = su;
  o[H + h] = sv;
  o[2 * H + h] = sw;
  if (D == 2) {
    T sn, cs;
    sin_cos((T)phi[b], &sn, &cs);
    const T scale = sc[b];
    const T a0 = cs * wc[h] + sn * wc[H + h];
    const T a1 = -sn * wc[h] + cs * wc[H + h];
    const T v_sc = block_sum<H>(su * a0 + sv * a1, red);
    const T v_phi = block_sum<H>(su * (scale * a1) - sv * (scale * a0), red);
    if (h == 0) {
      dsc[b] = v_sc;
      dphi[b] = v_phi;
    }
  } else if (h == 0) {
    dsc[b] = 0.0f;
    dphi[b] = 0.0f;
  }
  for (int d = 0; d < D; ++d) {
    const T v = block_sum<H>(sw * wc[d * H + h], red);
    if (h == 0) ddx[b * D + d] = v;
  }
  for (int l = 0; l < L; ++l) {
    const T v = block_sum<H>(sw * wz[l * H + h], red);
    if (h == 0) dz[(size_t)b * L + l] = v;
  }
}

#define PVT_SAMPLES_KERNEL(name, T)                                       \
  template <int H>                                                            \
  __global__ void __launch_bounds__(H) name(                                  \
      const float* __restrict__ tile_ws, float* __restrict__ duvw,            \
      const float* __restrict__ phi, const float* __restrict__ sc,            \
      const float* __restrict__ wc, const float* __restrict__ wz,             \
      float* __restrict__ dphi, float* __restrict__ ddx,                      \
      float* __restrict__ dsc, float* __restrict__ dz, int n_tiles, int D,    \
      int L) {                                                                \
    samples_body<H, T>(tile_ws, duvw, phi, sc, wc, wz, dphi, ddx, dsc,        \
                           dz, n_tiles, D, L);                                \
  }
PVT_SAMPLES_KERNEL(sdec_tc_samples, float)
PVT_SAMPLES_KERNEL(sdec_x3_samples, double)

// Weight epilogue from dWc on: dWc, dbc and dWz sum the per-sample
// vectors over the samples; dhw sums its unit in the slots of its pass,
// dhb, dwout, dbout and the loss the slots of pass 0. Each block takes 32
// outputs (one a lane); its 8 warps sum every 8th sample or slot, then
// warp 0 adds the 8 partials in warp order: a fixed order, and 8 loads in
// flight for each output. In T, as samples_body.
template <typename T>
__device__ __forceinline__ void weights_body(
    const float* __restrict__ blk_ws, int per_pass, int slot,
    const float* __restrict__ duvw, const float* __restrict__ phi,
    const float* __restrict__ dx, const float* __restrict__ sc,
    const float* __restrict__ z, float* __restrict__ out, int B, int D, int L,
    int H, int nl, int C, int loss) {
  __shared__ T part[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const int n_samp = (D + 1 + L) * H, n_dw = nl * H * H;
  const int n_sums = nl * H + H * C + C + loss;
  T s = 0;
  if (i < n_samp) {
    const int row = i / H, h = i - row * H;
    for (int b = w; b < B; b += kWarps) {
      const float* v = duvw + (size_t)b * 3 * H;
      const T du = v[h], dv = v[H + h], dw = v[2 * H + h];
      if (row < D) {
        if (D == 2) {
          T sn, cs;
          sin_cos((T)phi[b], &sn, &cs);
          const T scale = sc[b];
          s += row == 0
                   ? (scale * cs) * du - (scale * sn) * dv + dx[b * 2] * dw
                   : (scale * sn) * du + (scale * cs) * dv + dx[b * 2 + 1] * dw;
        } else {
          s += du + dx[b] * dw;
        }
      } else if (row == D) {
        s += dw;
      } else {
        s += z[(size_t)b * L + (row - D - 1)] * dw;
      }
    }
  } else if (i < n_samp + n_dw + n_sums) {
    const int j = i - n_samp;
    const float* src;
    if (j < n_dw) {
      const int l = j / (H * H), r = (j / H) % H, c = j % H;
      const int q = (l * (H / 64) + (r >> 6)) * (H / 128) + (c >> 7);
      src = blk_ws + (size_t)(q / kPassUnits) * per_pass * slot +
            (q % kPassUnits) * kUnitFloats + (r & 63) * 128 + (c & 127);
    } else {
      src = blk_ws + kPassUnits * kUnitFloats + (j - n_dw);
    }
    for (int k = w; k < per_pass; k += kWarps) s += src[(size_t)k * slot];
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < n_samp + n_dw + n_sums) {
    T t = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += part[k][lane];
    out[i] = t;
  }
}

#define PVT_WEIGHTS_PARAMS                                                  \
  const float* __restrict__ blk_ws, int per_pass, int slot,                 \
      const float* __restrict__ duvw, const float* __restrict__ phi,        \
      const float* __restrict__ dx, const float* __restrict__ sc,           \
      const float* __restrict__ z, float* __restrict__ out, int B, int D,   \
      int L, int H, int nl, int C, int loss
__global__ void __launch_bounds__(kThreads) sdec_tc_weights(PVT_WEIGHTS_PARAMS) {
  weights_body<float>(blk_ws, per_pass, slot, duvw, phi, dx, sc, z, out, B, D,
                      L, H, nl, C, loss);
}
// a template, so that only the source that launches it compiles it
template <int kUnused = 0>
__global__ void __launch_bounds__(kThreads) sdec_x3_weights(PVT_WEIGHTS_PARAMS) {
  weights_body<double>(blk_ws, per_pass, slot, duvw, phi, dx, sc, z, out, B, D,
                     L, H, nl, C, loss);
}

inline size_t slot_floats(int H, int nl, int C) {
  const size_t q = (size_t)kPassUnits * kUnitFloats + (size_t)nl * H +
                   (size_t)H * C + C + 1;
  return (q + 3) / 4 * 4;
}

// After the main kernel: the per-sample grads (dphi [B] | ddx [B, D] | dsc
// [B] | dz [B, L] at the head of `out`), then the weight grads (dWc [D, H]
// | dbc [H] | dWz [L, H] | dhw [nl, H, H] | dhb [nl, H] | dwout [H, C] |
// dbout [C] | loss (K3)) from the block slots `blk_ws` and the tile sums
// `tile_ws`, through the sample sums `duvw`; in double with kF64.
template <bool kF64>
inline cudaError_t launch_sums(const float* blk_ws, const float* tile_ws,
                               float* duvw, int per_pass, int slot,
                               int n_tiles, const float* phi, const float* dx,
                               const float* sc, const float* z,
                               const float* wc, const float* wz, float* out,
                               int B, int D, int L, int H, int nl, int C,
                               int loss, cudaStream_t stream) {
  float* dphi = out;
  float* ddx = dphi + B;
  float* dsc = ddx + (size_t)B * D;
  float* dz = dsc + B;
  float* out_w = dz + (size_t)B * L;
  // the per-sample sums (one block a sample, one thread a unit), then the
  // weight sums (32 outputs a block)
  const int n_vals = (D + 1 + L) * H + nl * H * H + nl * H + H * C + C + loss;
  const int blocks = (n_vals + 31) / 32;
  if constexpr (kF64) {
    if (H == 128)
      sdec_x3_samples<128><<<B, 128, 0, stream>>>(
          tile_ws, duvw, phi, sc, wc, wz, dphi, ddx, dsc, dz, n_tiles, D, L);
    else
      sdec_x3_samples<256><<<B, 256, 0, stream>>>(
          tile_ws, duvw, phi, sc, wc, wz, dphi, ddx, dsc, dz, n_tiles, D, L);
  } else {
    if (H == 128)
      sdec_tc_samples<128><<<B, 128, 0, stream>>>(
          tile_ws, duvw, phi, sc, wc, wz, dphi, ddx, dsc, dz, n_tiles, D, L);
    else
      sdec_tc_samples<256><<<B, 256, 0, stream>>>(
          tile_ws, duvw, phi, sc, wc, wz, dphi, ddx, dsc, dz, n_tiles, D, L);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kF64)
    sdec_x3_weights<0><<<blocks, kThreads, 0, stream>>>(
        blk_ws, per_pass, slot, duvw, phi, dx, sc, z, out_w, B, D, L, H, nl, C,
        loss);
  else
    sdec_tc_weights<<<blocks, kThreads, 0, stream>>>(
        blk_ws, per_pass, slot, duvw, phi, dx, sc, z, out_w, B, D, L, H, nl, C,
        loss);
  return cudaGetLastError();
}

bool bad_dims(int B, int N, int D, int L, int H, int n_layers, int C, int act,
              int loss_mode) {
  if (B <= 0 || N <= 0 || D < 1 || D > 2 || L < 0 || n_layers < 1) return true;
  if (C < 1 || C > kMaxC || (loss_mode && C != 1)) return true;
  if ((H != 128 && H != 256) || act < ACT_TANH || act > ACT_TANH_APPROX)
    return true;
  return (long long)B * N > INT_MAX;
}

}  // namespace
