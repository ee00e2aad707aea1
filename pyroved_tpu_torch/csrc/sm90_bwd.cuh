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

// The ablation builds of the two sources (-DPVT_ABLATE=<mode>, K4: the
// counterpart of benchmarks/bwd_ablation.py's _variant_kernel, modes in
// pyroved_tpu_torch/ops/bwd_ablation.py's MODES order; the end of this file).
// -1 is the production kernel: every ablation branch below folds away, and
// the production libraries keep their machine code.
enum Ablate { ABL_DMA_FLOOR = 0, ABL_FWD_NOACT = 1, ABL_FWD_REMAT = 2,
              ABL_NO_BREDUCE = 3, ABL_FULL = 4, ABL_FULL_DG = 5,
              ABL_MXU_DWOUT = 6, ABL_MXU_DHB = 7 };
#ifdef PVT_ABLATE
constexpr int kAblate = PVT_ABLATE;
static_assert(kAblate >= ABL_DMA_FLOOR && kAblate <= ABL_MXU_DHB,
              "PVT_ABLATE names a mode of ops/bwd_ablation.py");
#else
constexpr int kAblate = -1;
#endif
// the tile loop stops after the forward recompute
constexpr bool kFwdOnly = kAblate == ABL_FWD_REMAT || kAblate == ABL_FWD_NOACT;
// bytes of shared memory after the levels for the mxu modes' second
// operands: dl's three limb planes (mxu_dwout) or a ones block (mxu_dhb),
// each [8][R] bf16
__host__ __device__ constexpr int abl_bytes(int R) {
  return kAblate == ABL_MXU_DWOUT || kAblate == ABL_MXU_DHB ? 48 * R : 0;
}

// The identity, the hidden activation of the fwd_noact build (never a
// kernel argument: bad_dims refuses it).
constexpr int ACT_IDENT = ACT_TANH_APPROX + 1;

template <int A>
__device__ __forceinline__ float act_fn_k(float x) {
  if constexpr (A == ACT_IDENT) return x;
  else return act_fn<A>(x);
}

// with_act, bound to the identity in the fwd_noact build
template <typename F>
__device__ __forceinline__ void with_act_k(int act, F&& f) {
  if constexpr (kAblate == ABL_FWD_NOACT) f(ActTag<ACT_IDENT>{});
  else with_act(act, f);
}

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
  } else if constexpr (A == ACT_IDENT) {
    h = pre;
    g = 1.0f;
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

#ifdef PVT_ABLATE
// What the ablation builds of the two sources share (K4, the counterpart
// of benchmarks/bwd_ablation.py's _variant_kernel), compiled only when
// PVT_ABLATE is defined; the mode is kAblate (above).
//
// Every mode runs K2's grid of blocks over K2's tiles of R pixels of one
// sample, at one channel, 2-D coordinates, tanh and a sigmoid head. The
// logical tiles of the TPU kernel are (b_t samples, n_t pixels); n_t is a
// multiple of R (the entry points refuse it otherwise), so each kernel tile
// lies in one logical tile. What depends on the logical tiles folds here:
//  * dma_floor: each kernel tile's scalar (dma_floor_tile) adds its
//    cotangents, its grid rows once per batch tile, and once per logical
//    tile the per-sample values and the weights' sum; dz[b, :] is the sum
//    of the scalars of b's batch tile.
//  * fwd_remat, fwd_noact, mxu_dwout: one scalar a kernel tile (h_L's sum,
//    or h_L^T dl's), likewise summed over b's batch tile into dz[b, :].
//    A tile's scalar stays as its warps' partials (tile_s [tile][warp]),
//    so that no mode adds a block barrier to the tile loop.
//  * no_breduce: dw[b] sums the per-sample dw of b's batch tile, du[b] and
//    dv[b] are those of its first sample (the only tiles that compute
//    them): the samples' own sums first, as K2's, then the batch tile's.


// D (+)= A B for one warpgroup, m64 n8 k16: a 64-row slab against a block
// of 8 columns (the mxu modes' products against dl or ones).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// K-major descriptor of an [8][R] bf16 block (one row of cores), k-th
// k16 step
template <int R>
__device__ __forceinline__ uint64_t block8_desc(uint32_t addr, int k) {
  return desc(addr + k * 256, 128, 16 * R);
}

// The warp's sum of each lane's v, written by lane 0 as its warp's part
// of tile t's scalar (pass 0 only: later passes recompute the same tiles).
__device__ __forceinline__ void warp_partial(float v, float* tile_s, int t,
                                             int pass) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && pass == 0)
    tile_s[(size_t)t * kWarps + (threadIdx.x >> 5)] = v;
}

// dma_floor: the sum of every weight but bout, the same in every block
template <typename K>
__device__ __forceinline__ float weights_sum(const K& a, int H, float* red) {
  const int tid = threadIdx.x, nl = a.nl;
  float v = 0.0f;
  for (int i = tid; i < nl * H * H; i += kThreads) v += a.hw[i];
  for (int i = tid; i < 2 * H; i += kThreads) v += a.wc[i];
  for (int i = tid; i < a.L * H; i += kThreads) v += a.wz[i];
  for (int i = tid; i < H; i += kThreads) v += a.bc[i] + a.wout[i];
  for (int i = tid; i < nl * H; i += kThreads) v += a.hb[i];
  return block_sum<kThreads>(v, red);
}

// dma_floor's tile: reads the tile's cotangents and grid rows and the
// sample's values, one add, the tile's scalar
template <int R, typename K>
__device__ __forceinline__ void dma_floor_tile(const K& a, int t, int b,
                                               int n0, int rows, int pass,
                                               float wsum) {
  const int tid = threadIdx.x;
  float v = 0.0f;
  if (tid < rows) {
    const size_t n = (size_t)n0 + tid;
    v = a.g[(size_t)b * a.N + n];
    if (b % a.b_t == 0) v += a.grid[2 * n] + a.grid[2 * n + 1];
  } else if (tid == R && n0 % a.n_t == 0) {
    float s = a.phi[b] + a.sc[b] + a.dx[2 * b] + a.dx[2 * b + 1];
    for (int l = 0; l < a.L; ++l) s += a.z[(size_t)b * a.L + l];
    v = s + (b % a.b_t == 0 ? wsum : 0.0f);
  }
  warp_partial(v, a.tile_s, t, pass);
}

// The per-sample sums of the modes whose reduction is not K2's: one block
// a sample, one thread a unit, as samples_body (sm90_bwd.cuh). dma_floor
// and the forward modes have no per-sample vectors (duvw zero); dz adds
// the scalars of the sample's batch tile. no_breduce runs it twice: stage
// 0 sums each sample's own tiles into `raw` (du and dv only for a batch
// tile's first sample), stage 1 takes the batch tile's from there.
template <int H, typename T, int kStage>
__global__ void __launch_bounds__(H) abl_samples(
    const float* __restrict__ tile_ws, const float* __restrict__ tile_s,
    float* __restrict__ raw, float* __restrict__ duvw,
    const float* __restrict__ phi, const float* __restrict__ sc,
    const float* __restrict__ wc, const float* __restrict__ wz,
    float* __restrict__ dphi, float* __restrict__ ddx,
    float* __restrict__ dsc, float* __restrict__ dz, int n_tiles, int L,
    int b_t) {
  constexpr bool kBwd = kAblate == ABL_NO_BREDUCE || kAblate == ABL_MXU_DWOUT;
  __shared__ T red[H / 32];
  const int b = blockIdx.x, h = threadIdx.x, b0 = b - b % b_t;
  T su = 0, sv = 0, sw = 0;
  if (kAblate == ABL_MXU_DWOUT || kStage == 0) {  // the sample's own tiles
    const float* tw = tile_ws + (size_t)b * n_tiles * 3 * H;
    const bool uv = kAblate == ABL_MXU_DWOUT || b == b0;
    for (int t = 0; t < n_tiles; ++t) {
      if (uv) {
        su += tw[(size_t)t * 3 * H + h];
        sv += tw[(size_t)t * 3 * H + H + h];
      }
      sw += tw[(size_t)t * 3 * H + 2 * H + h];
    }
  }
  if constexpr (kAblate == ABL_NO_BREDUCE) {
    if constexpr (kStage == 0) {
      float* o = raw + (size_t)b * 3 * H;
      o[h] = su;
      o[H + h] = sv;
      o[2 * H + h] = sw;
      return;
    } else {  // the batch tile's first sample's du, dv and its dw sum
      su = raw[(size_t)b0 * 3 * H + h];
      sv = raw[(size_t)b0 * 3 * H + H + h];
      for (int k = 0; k < b_t; ++k) sw += raw[(size_t)(b0 + k) * 3 * H + 2 * H + h];
    }
  }
  float* o = duvw + (size_t)b * 3 * H;
  o[h] = su;
  o[H + h] = sv;
  o[2 * H + h] = sw;
  T v_sc = 0, v_phi = 0;
  if constexpr (kBwd) {
    T sn, cs;
    sin_cos((T)phi[b], &sn, &cs);
    const T scale = sc[b];
    const T a0 = cs * wc[h] + sn * wc[H + h];
    const T a1 = -sn * wc[h] + cs * wc[H + h];
    v_sc = block_sum<H>(su * a0 + sv * a1, red);
    v_phi = block_sum<H>(su * (scale * a1) - sv * (scale * a0), red);
  }
  if (h == 0) {
    dsc[b] = v_sc;
    dphi[b] = v_phi;
  }
  for (int d = 0; d < 2; ++d) {
    const T v = kBwd ? block_sum<H>(sw * wc[d * H + h], red) : T(0);
    if (h == 0) ddx[b * 2 + d] = v;
  }
  T fold = 0;  // the scalars of b's batch tile, as their warps' partials
  if constexpr (kAblate != ABL_NO_BREDUCE) {
    const float* ts = tile_s + (size_t)b0 * n_tiles * kWarps;
    T part = 0;
    for (int i = h; i < b_t * n_tiles * kWarps; i += H) part += ts[i];
    fold = block_sum<H>(part, red);
  }
  for (int l = 0; l < L; ++l) {
    const T v = kBwd ? block_sum<H>(sw * wz[l * H + h], red) : T(0);
    if (h == 0) dz[(size_t)b * L + l] = v + fold;
  }
}

// Floats of an ablation call's workspace after K2's: the tiles' scalars
// (a partial a warp) and no_breduce's own per-sample sums.
inline size_t abl_workspace_floats(int B, int n_tiles, int H) {
  return (size_t)B * n_tiles * kWarps + (size_t)B * 3 * H;
}

// After the main kernel of an ablation build: K2's reductions (full,
// full_dg, mxu_dhb) or abl_samples and K2's weight epilogue, which reads the
// block slots (zero where the mode adds nothing) and the sample sums.
template <bool kF64>
inline cudaError_t launch_abl_sums(const float* blk_ws, const float* tile_ws,
                                   const float* tile_s, float* raw,
                                   float* duvw, int per_pass, int slot,
                                   int n_tiles, const float* phi,
                                   const float* dx, const float* sc,
                                   const float* z, const float* wc,
                                   const float* wz, float* out, int B, int L,
                                   int H, int nl, int b_t,
                                   cudaStream_t stream) {
  if constexpr (kAblate == ABL_FULL || kAblate == ABL_FULL_DG ||
                kAblate == ABL_MXU_DHB) {
    return launch_sums<kF64>(blk_ws, tile_ws, duvw, per_pass, slot, n_tiles,
                             phi, dx, sc, z, wc, wz, out, B, 2, L, H, nl, 1,
                             0, stream);
  } else {
    using T = typename std::conditional<kF64, double, float>::type;
    float* dphi = out;
    float* ddx = dphi + B;
    float* dsc = ddx + (size_t)B * 2;
    float* dz = dsc + B;
    float* out_w = dz + (size_t)B * L;
    auto samples = [&](auto stage) {
      constexpr int S = decltype(stage)::value;
      if (H == 128)
        abl_samples<128, T, S><<<B, 128, 0, stream>>>(
            tile_ws, tile_s, raw, duvw, phi, sc, wc, wz, dphi, ddx, dsc, dz,
            n_tiles, L, b_t);
      else
        abl_samples<256, T, S><<<B, 256, 0, stream>>>(
            tile_ws, tile_s, raw, duvw, phi, sc, wc, wz, dphi, ddx, dsc, dz,
            n_tiles, L, b_t);
      return cudaGetLastError();
    };
    cudaError_t err = cudaSuccess;
    if constexpr (kAblate == ABL_NO_BREDUCE) {
      err = samples(std::integral_constant<int, 0>{});
      if (err != cudaSuccess) return err;
    }
    err = samples(std::integral_constant<int, 1>{});
    if (err != cudaSuccess) return err;
    const int n_vals = 3 * H + L * H + nl * H * H + nl * H + H + 1;
    const int blocks = (n_vals + 31) / 32;
    if constexpr (kF64)
      sdec_x3_weights<0><<<blocks, kThreads, 0, stream>>>(
          blk_ws, per_pass, slot, duvw, phi, dx, sc, z, out_w, B, 2, L, H, nl,
          1, 0);
    else
      sdec_tc_weights<<<blocks, kThreads, 0, stream>>>(
          blk_ws, per_pass, slot, duvw, phi, dx, sc, z, out_w, B, 2, L, H, nl,
          1, 0);
    return cudaGetLastError();
  }
}

// The checks of an ablation call beyond bad_dims: padded inputs, and the
// kernel tile of R pixels inside one logical pixel tile.
inline bool bad_tiles(int B, int N, int b_t, int n_t, int R) {
  return b_t < 1 || n_t < 1 || B % b_t || N % n_t || (R > 0 && n_t % R);
}
#endif  // PVT_ABLATE

}  // namespace
