// Fused spatial-decoder backward (K2) and one-pass Bernoulli train kernel
// (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel pyroved_tpu/ops/spatial_decoder.py::_bwd_kernel in
// both of its modes: loss_mode=False (K2, the backward of the decoder's
// custom VJP, via _bwd) and loss_mode=True (K3, via _train_call). One kernel
// body with a compile-time LOSS flag serves both.
//
// For each pixel tile the kernel recomputes the forward of K1
// (spatial_decoder_fwd.cu) and keeps every layer's output in shared memory,
// then backpropagates:
//
//   head   dl = g * s (1 - s), s = sigmoid(logit)       (K2, sigmoid head)
//          dl = g                                       (K2, linear head)
//          dl = w_b (sigmoid(logit) - x),                (K3; loss adds
//               -w_b [x logit - softplus(logit)])
//   layer  d_pre_l = dh_{l+1} * act'(h_{l+1}),  dW_l += h_l^T d_pre_l,
//          db_l += sum_rows d_pre_l,  dh_l = d_pre_l W_l^T
//   h0     d0 = dh_0 * (1 - h0^2)                        (coordinate layer)
//
// and the folded transform (module docstring of the JAX kernel):
//   du_b = sum_n gx d0, dv_b = sum_n gy d0, dw_b = sum_n d0
//   dsc_b = <du, a0> + <dv, a1>, dphi_b = <du, v> - <dv, u>
//   ddx_b = dw_b Wc^T, dz_b = dw_b Wz^T, dbc = sum_b dw_b, dWz = z^T dw
//   dWc0 = sum_b (sc cos) du - (sc sin) dv + dx0 dw
//   dWc1 = sum_b (sc sin) du + (sc cos) dv + dx1 dw      (D = 1: du + dx dw)
//
// What bounds it: about 6 * n_layers * H^2 flops per pixel (the forward
// recompute, dW and dh) against a few bytes per pixel, so arithmetic. This
// version computes in f32 on the CUDA cores (BF16_MATMUL = False); the bf16
// tensor-core version is spatial_decoder_bwd_tc.cu.
//
// Design:
//  * Blocks run at once, in no order, so the TPU's serial accumulation in
//    VMEM does not carry over. A grid of S blocks (S = blocks that fit at
//    once, at most the tile count) walks the flat (sample, pixel tile) list:
//    block s takes tiles s, s + S, ... Each block owns one slot of weight-
//    grad partials (dW, db, dwout, dbout, loss) in a global workspace, which
//    it writes on its first tile and adds to on the others; each tile writes
//    its own du/dv/dw sums. Two small kernels then reduce in a fixed order:
//    one block per sample sums its tiles and computes dphi, dsc, ddx, dz;
//    one thread per weight-grad element sums the slots (or the samples, for
//    dWc, dbc, dWz). No atomics: the same inputs on the same card give
//    bitwise-equal grads.
//  * A tile is R = 8192 / H rows (64 at H = 128, 32 at H = 256), so each
//    activation buffer is 32 KB. Shared memory holds h_0 .. h_L (and, for
//    gelu, act'(pre) of each layer, which the post-activation cannot give).
//    The backward overwrites them in place: d_pre of layer l replaces h_{l+1}
//    once dW_l is taken. At most 6 buffers fit in 227 KB beside a 16-row
//    weight chunk: up to 5 hidden layers, 2 with gelu. The Python gate
//    routes deeper decoders to the module path by their configuration.
//  * Layer products reuse K1's register blocking: each thread holds
//    R/8 rows x H/32 columns; weights stream through shared memory in
//    chunks of 16 rows (transposed on the way in for dh = d_pre W^T).
//    dW = h^T d_pre is an outer-product sum over the tile's rows, 8 x 8 per
//    thread in 128 x 128 passes.
//  * Ragged tiles are masked in the kernel: rows past N get dl = 0, so they
//    add nothing to any sum. g ([B, N, C]) and x ([B, N]) are read in place.
//  * Nothing is allocated here and nothing synchronises with the host; the
//    wrapper allocates the workspace through PyTorch's caching allocator.

#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileElems = 8192;  // rows x H of one activation buffer
constexpr int kChunk = 16;        // weight rows staged per step
constexpr int kMaxC = 4;
constexpr int kMaxDevices = 64;

enum Act { ACT_TANH = 0, ACT_RELU = 1, ACT_LRELU = 2, ACT_SOFTPLUS = 3,
           ACT_GELU = 4, ACT_TANH_APPROX = 5 };

__device__ __forceinline__ float pade_tanh(float x) {
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

// d act / d pre from the post-activation h, as _act_grad_from_post: the
// subgradient at 0 is 1 for lrelu (h >= 0) and 0 for relu (h > 0); the Pade
// tanh takes tanh's 1 - h^2.
template <int ACT>
__device__ __forceinline__ float act_grad_post(float h) {
  if (ACT == ACT_LRELU) return h >= 0.0f ? 1.0f : 0.01f;
  if (ACT == ACT_SOFTPLUS) return 1.0f - expf(-h);
  if (ACT == ACT_RELU) return h > 0.0f ? 1.0f : 0.0f;
  return 1.0f - h * h;
}

// exact gelu and its derivative Phi(x) + x phi(x), sharing erff
__device__ __forceinline__ void gelu_and_grad(float x, float& h, float& g) {
  const float e = erff(x * 0.70710678118654752f);
  h = 0.5f * x * (1.0f + e);
  g = 0.5f * (1.0f + e) + x * 0.39894228040143268f * expf(-0.5f * x * x);
}

__device__ __forceinline__ float sigmoid(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__host__ __device__ constexpr int tile_rows(int H) { return kTileElems / H; }

// activation buffers: h_0 .. h_L, then (gelu) act'(pre_0) .. act'(pre_{L-1})
__host__ __device__ inline int n_buffers(int n_layers, bool gelu) {
  return n_layers + 1 + (gelu ? n_layers : 0);
}

__host__ __device__ inline size_t smem_floats(int H, int n_layers, bool gelu) {
  return (size_t)n_buffers(n_layers, gelu) * kTileElems + (size_t)kChunk * H +
         3 * (size_t)H + (2 + kMaxC) * (size_t)tile_rows(H) + kWarps;
}

// floats of one block's weight-grad slot: dW, db, dwout, dbout, loss
inline size_t slot_floats(int H, int n_layers, int C) {
  const size_t q = (size_t)n_layers * H * H + (size_t)n_layers * H +
                   (size_t)H * C + C + 1;
  return (q + 3) / 4 * 4;  // keeps every slot 16-byte aligned
}

// acc[r][j] = sum_k a[row0 + r][k] * M[k][lane + 32 j] over one tile, with
// M = w (TRANS = false) or w^T (TRANS = true); w is [H, H] in global memory,
// a is [R, H] in shared memory. Ends with every read of a and ws done.
template <int H, bool TRANS>
__device__ __forceinline__ void tile_matmul(
    const float* __restrict__ a, const float* __restrict__ w, float* ws,
    float (&acc)[tile_rows(H) / kWarps][H / 32]) {
  constexpr int RPT = tile_rows(H) / kWarps;
  constexpr int TN = H / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * RPT;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += kChunk) {
    if (!TRANS) {
      const float4* src = reinterpret_cast<const float4*>(w + (size_t)k0 * H);
      float4* dst = reinterpret_cast<float4*>(ws);
      for (int i = tid; i < kChunk * H / 4; i += kThreads) dst[i] = src[i];
    } else {
      // ws[kk][col] = w[col][k0 + kk]: float4 along kk, four scalar stores
      for (int i = tid; i < kChunk * H / 4; i += kThreads) {
        const int col = i % H, q = i / H;
        const float4 v = *reinterpret_cast<const float4*>(
            w + (size_t)col * H + k0 + 4 * q);
        ws[(4 * q + 0) * H + col] = v.x;
        ws[(4 * q + 1) * H + col] = v.y;
        ws[(4 * q + 2) * H + col] = v.z;
        ws[(4 * q + 3) * H + col] = v.w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 av[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        av[r] = *reinterpret_cast<const float4*>(a + (row0 + r) * H + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wq[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) wq[j] = ws[(kk + q) * H + lane + 32 * j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float x = q == 0 ? av[r].x : q == 1 ? av[r].y
                        : q == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(x, wq[j], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }
}

// dst[i][j] (+)= sum_{r < rows} a[r][i] * b[r][j] for i, j < H; each thread
// owns 8 x 8 entries of each 128 x 128 pass, always the same ones.
template <int H>
__device__ __forceinline__ void accumulate_outer(
    const float* __restrict__ a, const float* __restrict__ b, int rows,
    float* __restrict__ dst, bool first) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  for (int ib = 0; ib < H; ib += 128) {
    for (int jb = 0; jb < H; jb += 128) {
      const int i0 = ib + ti * 8, j0 = jb + tj * 8;
      float acc[8][8];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[ii][jj] = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + r * H + i0);
        const float4 a1 = *reinterpret_cast<const float4*>(a + r * H + i0 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(b + r * H + j0);
        const float4 b1 = *reinterpret_cast<const float4*>(b + r * H + j0 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int ii = 0; ii < 8; ++ii)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        float4* o = reinterpret_cast<float4*>(dst + (size_t)(i0 + ii) * H + j0);
        float4 lo = make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
        float4 hi = make_float4(acc[ii][4], acc[ii][5], acc[ii][6], acc[ii][7]);
        if (!first) {
          const float4 p = o[0], q = o[1];
          lo.x += p.x; lo.y += p.y; lo.z += p.z; lo.w += p.w;
          hi.x += q.x; hi.y += q.y; hi.z += q.z; hi.w += q.w;
        }
        o[0] = lo;
        o[1] = hi;
      }
    }
  }
}

template <int ACT>
__device__ __forceinline__ float deriv(const float* buf, int slot,
                                       int n_layers, int i) {
  // d h_slot / d pre of the layer that produced it
  if (slot == 0) {
    const float h = buf[i];
    return 1.0f - h * h;  // coordinate layer: tanh
  }
  if (ACT == ACT_GELU) return buf[(size_t)(n_layers + slot) * kTileElems + i];
  return act_grad_post<ACT>(buf[(size_t)slot * kTileElems + i]);
}

template <int H, int ACT, bool LOSS>
__global__ void __launch_bounds__(kThreads)
sdec_bwd_kernel(const float* __restrict__ grid, const float* __restrict__ phi,
                const float* __restrict__ dx, const float* __restrict__ sc,
                const float* __restrict__ z, const float* __restrict__ wc,
                const float* __restrict__ bc, const float* __restrict__ wz,
                const float* __restrict__ hw, const float* __restrict__ hb,
                const float* __restrict__ wout, const float* __restrict__ bout,
                const float* __restrict__ g, const float* __restrict__ x,
                const float* __restrict__ wgt, float* __restrict__ blk_ws,
                float* __restrict__ tile_ws, int B, int N, int D, int L,
                int n_layers, int C, int sigmoid_out, int n_tiles,
                int slot_size) {
  constexpr int R = tile_rows(H);
  constexpr int RPT = R / kWarps;
  constexpr int TN = H / 32;
  constexpr bool kGelu = ACT == ACT_GELU;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* ws = buf + (size_t)n_buffers(n_layers, kGelu) * kTileElems;
  float* us = ws + kChunk * H;
  float* vs = us + H;
  float* wv = vs + H;
  float* gs = wv + H;     // [R][2] coordinates
  float* dl = gs + 2 * R;  // [R][kMaxC] head cotangents
  float* red = dl + kMaxC * R;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * RPT;
  float* s_dhw = blk_ws + (size_t)blockIdx.x * slot_size;
  float* s_dhb = s_dhw + (size_t)n_layers * H * H;
  float* s_dwout = s_dhb + (size_t)n_layers * H;
  float* s_dbout = s_dwout + H * C;
  float* s_loss = s_dbout + C;

  const int total = B * n_tiles;
  bool first = true;
  for (int t = blockIdx.x; t < total; t += gridDim.x, first = false) {
    const int b = t / n_tiles;
    const int n0 = (t - b * n_tiles) * R;
    const int rows = min(R, N - n0);

    // -- per-sample folded transform, tile coordinates (as K1)
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
    for (int r = tid; r < R; r += kThreads) {
      float gx = 0.0f, gy = 0.0f;
      if (r < rows) {
        gx = grid[(size_t)(n0 + r) * D];
        if (D == 2) gy = grid[(size_t)(n0 + r) * D + 1];
      }
      gs[2 * r] = gx;
      gs[2 * r + 1] = gy;
    }
    __syncthreads();

    // -- forward recompute: h_0 .. h_L stay in shared memory
    for (int i = tid; i < kTileElems; i += kThreads) {
      const int r = i / H, h = i - r * H;
      buf[i] = h0_act<ACT>(gs[2 * r] * us[h] + gs[2 * r + 1] * vs[h] + wv[h]);
    }
    __syncthreads();
    for (int l = 0; l < n_layers; ++l) {
      float acc[RPT][TN];
      tile_matmul<H, false>(buf + (size_t)l * kTileElems,
                            hw + (size_t)l * H * H, ws, acc);
      const float* bias = hb + (size_t)l * H;
      float* out = buf + (size_t)(l + 1) * kTileElems;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = lane + 32 * j;
        const float bj = bias[col];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = (row0 + r) * H + col;
          const float pre = acc[r][j] + bj;
          if (kGelu) {
            float hv, gv;
            gelu_and_grad(pre, hv, gv);
            out[i] = hv;
            buf[(size_t)(n_layers + 1 + l) * kTileElems + i] = gv;
          } else {
            out[i] = act_fn<ACT>(pre);
          }
        }
      }
      __syncthreads();
    }

    // -- head: one warp-reduced dot per (row, channel), then its cotangent
    const float* hL = buf + (size_t)n_layers * kTileElems;
    float loss_part = 0.0f;
    for (int r = warp; r < R; r += kWarps) {
      for (int c = 0; c < C; ++c) {
        float p = 0.0f;
        for (int k = lane; k < H; k += 32) p += hL[r * H + k] * wout[k * C + c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        float d = 0.0f;
        if (r < rows) {
          const float logit = p + bout[c];
          const size_t n = (size_t)b * N + n0 + r;
          if (LOSS) {
            const float xv = x[n], wm = wgt[b];
            loss_part -= wm * (xv * logit - softplus(logit));
            d = wm * (sigmoid(logit) - xv);
          } else {
            const float gv = g[n * C + c];
            if (sigmoid_out) {
              const float s = sigmoid(logit);
              d = gv * s * (1.0f - s);
            } else {
              d = gv;
            }
          }
        }
        if (lane == 0) dl[r * kMaxC + c] = d;
      }
    }
    if (LOSS && lane == 0) red[warp] = loss_part;
    __syncthreads();

    // -- head grads: dwout, dbout, loss
    for (int i = tid; i < H * C; i += kThreads) {
      const int k = i / C, c = i - k * C;
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s += hL[r * H + k] * dl[r * kMaxC + c];
      s_dwout[i] = first ? s : s_dwout[i] + s;
    }
    if (tid < C) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s += dl[r * kMaxC + tid];
      s_dbout[tid] = first ? s : s_dbout[tid] + s;
    }
    if (LOSS && tid == 0) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red[w];
      s_loss[0] = first ? s : s_loss[0] + s;
    }
    __syncthreads();

    // -- d pre of the last layer, in place over h_L
    for (int i = tid; i < kTileElems; i += kThreads) {
      const int r = i / H, k = i - r * H;
      float dh = 0.0f;
      for (int c = 0; c < C; ++c) dh += dl[r * kMaxC + c] * wout[k * C + c];
      const float dv = dh * deriv<ACT>(buf, n_layers, n_layers, i);
      buf[(size_t)n_layers * kTileElems + i] = dv;
    }
    __syncthreads();

    // -- hidden layers, last to first: slot l + 1 holds d_pre_l
    for (int l = n_layers - 1; l >= 0; --l) {
      const float* hl = buf + (size_t)l * kTileElems;
      const float* dp = buf + (size_t)(l + 1) * kTileElems;
      accumulate_outer<H>(hl, dp, rows, s_dhw + (size_t)l * H * H, first);
      for (int j = tid; j < H; j += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < rows; ++r) s += dp[r * H + j];
        float* o = s_dhb + (size_t)l * H + j;
        *o = first ? s : *o + s;
      }
      float acc[RPT][TN];
      tile_matmul<H, true>(dp, hw + (size_t)l * H * H, ws, acc);
      // every read of h_l is done (the matmul's barriers): replace it with
      // d_pre_{l-1} (or d0 for l = 0)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = (row0 + r) * H + lane + 32 * j;
          const float dv = acc[r][j] * deriv<ACT>(buf, l, n_layers, i);
          buf[(size_t)l * kTileElems + i] = dv;
        }
      }
      __syncthreads();
    }

    // -- this tile's sums of d0: du = sum gx d0, dv = sum gy d0, dw = sum d0
    float* tw = tile_ws + (size_t)t * 3 * H;
    for (int h = tid; h < H; h += kThreads) {
      float su = 0.0f, sv = 0.0f, sw = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float d = buf[r * H + h];
        su += gs[2 * r] * d;
        sv += gs[2 * r + 1] * d;
        sw += d;
      }
      tw[h] = su;
      tw[H + h] = sv;
      tw[2 * H + h] = sw;
    }
    __syncthreads();
  }
}

// Sum over the block in a fixed order; every thread gets the result.
template <int H>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // earlier reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < H / 32; ++w) s += red[w];
  return s;
}

// Per-sample epilogue: one block per sample, one thread per hidden unit.
// Sums the sample's tile partials in tile order into duvw [B][3][H], then
// dphi, dsc, ddx and dz by the folded-transform formulas.
template <int H>
__global__ void __launch_bounds__(H)
sdec_bwd_samples(const float* __restrict__ tile_ws, float* __restrict__ duvw,
                 const float* __restrict__ phi, const float* __restrict__ sc,
                 const float* __restrict__ wc, const float* __restrict__ wz,
                 float* __restrict__ dphi, float* __restrict__ ddx,
                 float* __restrict__ dsc, float* __restrict__ dz, int n_tiles,
                 int D, int L) {
  __shared__ float red[H / 32];
  const int b = blockIdx.x, h = threadIdx.x;
  const float* tw = tile_ws + (size_t)b * n_tiles * 3 * H;
  float su = 0.0f, sv = 0.0f, sw = 0.0f;
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
    float sn, cs;
    sincosf(phi[b], &sn, &cs);
    const float scale = sc[b];
    const float a0 = cs * wc[h] + sn * wc[H + h];
    const float a1 = -sn * wc[h] + cs * wc[H + h];
    const float v_sc = block_sum<H>(su * a0 + sv * a1, red);
    const float v_phi = block_sum<H>(su * (scale * a1) - sv * (scale * a0), red);
    if (h == 0) {
      dsc[b] = v_sc;
      dphi[b] = v_phi;
    }
  } else if (h == 0) {
    dsc[b] = 0.0f;
    dphi[b] = 0.0f;
  }
  for (int d = 0; d < D; ++d) {
    const float v = block_sum<H>(sw * wc[d * H + h], red);
    if (h == 0) ddx[b * D + d] = v;
  }
  for (int l = 0; l < L; ++l) {
    const float v = block_sum<H>(sw * wz[l * H + h], red);
    if (h == 0) dz[(size_t)b * L + l] = v;
  }
}

// Weight epilogue: one thread per output element. The first n_slot_vals
// (dW, db, dwout, dbout, loss) sum the block slots in slot order; the rest
// (dWc, dbc, dWz) sum the per-sample vectors in sample order.
__global__ void __launch_bounds__(kThreads)
sdec_bwd_weights(const float* __restrict__ blk_ws, int n_blocks,
                 int slot_size, int n_slot_vals,
                 const float* __restrict__ duvw, const float* __restrict__ phi,
                 const float* __restrict__ dx, const float* __restrict__ sc,
                 const float* __restrict__ z, float* __restrict__ out_slot,
                 float* __restrict__ out_samp, int B, int D, int L, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_slot_vals) {
    float s = 0.0f;
    for (int k = 0; k < n_blocks; ++k) s += blk_ws[(size_t)k * slot_size + i];
    out_slot[i] = s;
    return;
  }
  const int j = i - n_slot_vals;
  if (j >= (D + 1 + L) * H) return;
  const int row = j / H, h = j - row * H;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* v = duvw + (size_t)b * 3 * H;
    const float du = v[h], dv = v[H + h], dw = v[2 * H + h];
    if (row < D) {
      if (D == 2) {
        float sn, cs;
        sincosf(phi[b], &sn, &cs);
        const float scale = sc[b];
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
  out_samp[j] = s;
}

// Opt the kernel into the device's largest dynamic shared memory, once per
// template instance and device (the attribute stays set on the context).
template <int H, int ACT, bool LOSS>
cudaError_t allow_smem(int dev, int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sdec_bwd_kernel<H, ACT, LOSS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

// Blocks of the main kernel: as many as fit on the card at once, at most
// one per tile (so every block owns at least one tile and writes its slot).
template <int H, int ACT, bool LOSS>
cudaError_t plan(int n_layers, int total_tiles, int* n_blocks, int* smem) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *smem = (int)(smem_floats(H, n_layers, ACT == ACT_GELU) * sizeof(float));
  if (*smem > optin) return cudaErrorInvalidValue;
  err = allow_smem<H, ACT, LOSS>(dev, optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sdec_bwd_kernel<H, ACT, LOSS>, kThreads, *smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  *n_blocks = (int)(fit < total_tiles ? fit : total_tiles);
  return cudaSuccess;
}

struct Args {
  const float *grid, *phi, *dx, *sc, *z, *wc, *bc, *wz, *hw, *hb, *wout,
      *bout, *g, *x, *wgt;
  float *out, *ws;
  int B, N, D, L, H, n_layers, C, sigmoid_out, n_blocks;
  cudaStream_t stream;
};

template <int H, int ACT, bool LOSS>
cudaError_t launch(const Args& a) {
  const int R = tile_rows(H);
  const int n_tiles = (a.N + R - 1) / R;
  const int total = a.B * n_tiles;
  int fit = 0, smem = 0;
  cudaError_t err = plan<H, ACT, LOSS>(a.n_layers, total, &fit, &smem);
  if (err != cudaSuccess) return err;
  if (a.n_blocks < 1 || a.n_blocks > fit) return cudaErrorInvalidValue;
  const size_t slot = slot_floats(H, a.n_layers, a.C);
  float* blk_ws = a.ws;
  float* tile_ws = blk_ws + (size_t)a.n_blocks * slot;
  float* duvw = tile_ws + (size_t)total * 3 * H;
  // out: dphi [B] | ddx [B, D] | dsc [B] | dz [B, L] | dWc [D, H] | dbc [H]
  //      | dWz [L, H] | dhw [nl, H, H] | dhb [nl, H] | dwout [H, C]
  //      | dbout [C] | loss (K3)
  float* dphi = a.out;
  float* ddx = dphi + a.B;
  float* dsc = ddx + (size_t)a.B * a.D;
  float* dz = dsc + a.B;
  float* out_samp = dz + (size_t)a.B * a.L;
  float* out_slot = out_samp + (size_t)(a.D + 1 + a.L) * H;
  const int n_slot_vals = a.n_layers * H * H + a.n_layers * H + H * a.C +
                          a.C + (LOSS ? 1 : 0);

  sdec_bwd_kernel<H, ACT, LOSS><<<a.n_blocks, kThreads, smem, a.stream>>>(
      a.grid, a.phi, a.dx, a.sc, a.z, a.wc, a.bc, a.wz, a.hw, a.hb, a.wout,
      a.bout, a.g, a.x, a.wgt, blk_ws, tile_ws, a.B, a.N, a.D, a.L,
      a.n_layers, a.C, a.sigmoid_out, n_tiles, (int)slot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sdec_bwd_samples<H><<<a.B, H, 0, a.stream>>>(
      tile_ws, duvw, a.phi, a.sc, a.wc, a.wz, dphi, ddx, dsc, dz, n_tiles,
      a.D, a.L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_vals = n_slot_vals + (a.D + 1 + a.L) * H;
  sdec_bwd_weights<<<(n_vals + kThreads - 1) / kThreads, kThreads, 0,
                     a.stream>>>(
      blk_ws, a.n_blocks, (int)slot, n_slot_vals, duvw, a.phi, a.dx, a.sc,
      a.z, out_slot, out_samp, a.B, a.D, a.L, H);
  return cudaGetLastError();
}

// One switch over (H, act, mode) for both entry points.
template <typename F>
cudaError_t dispatch(int H, int act, int loss_mode, F&& f) {
#define PVT_MODE(HH, A)                                                   \
  return loss_mode ? f.template operator()<HH, A, true>()                 \
                   : f.template operator()<HH, A, false>()
#define PVT_ACTS(HH)                                                      \
  switch (act) {                                                          \
    case ACT_TANH: PVT_MODE(HH, ACT_TANH);                                \
    case ACT_RELU: PVT_MODE(HH, ACT_RELU);                                \
    case ACT_LRELU: PVT_MODE(HH, ACT_LRELU);                              \
    case ACT_SOFTPLUS: PVT_MODE(HH, ACT_SOFTPLUS);                        \
    case ACT_GELU: PVT_MODE(HH, ACT_GELU);                                \
    case ACT_TANH_APPROX: PVT_MODE(HH, ACT_TANH_APPROX);                  \
    default: return cudaErrorInvalidValue;                                \
  }
  switch (H) {
    case 128: PVT_ACTS(128)
    case 256: PVT_ACTS(256)
    default: return cudaErrorInvalidValue;
  }
#undef PVT_ACTS
#undef PVT_MODE
}

struct PlanFn {
  int n_layers, total;
  int* n_blocks;
  template <int HH, int A, bool M>
  cudaError_t operator()() const {
    int smem = 0;
    return plan<HH, A, M>(n_layers, total, n_blocks, &smem);
  }
};

struct LaunchFn {
  const Args* a;
  template <int HH, int A, bool M>
  cudaError_t operator()() const { return launch<HH, A, M>(*a); }
};

bool bad_dims(int B, int N, int D, int L, int H, int n_layers, int C,
              int loss_mode) {
  if (B <= 0 || N <= 0 || D < 1 || D > 2 || L < 0 || n_layers < 0) return true;
  if (C < 1 || C > kMaxC || (loss_mode && C != 1)) return true;
  if (H != 128 && H != 256) return true;
  const long long tiles = (long long)B * ((N + tile_rows(H) - 1) / tile_rows(H));
  return tiles > INT_MAX;
}

}  // namespace

// Workspace and grid of one backward call: *n_blocks blocks of the main
// kernel and *ws_floats floats of workspace (block slots, tile partials,
// per-sample sums). The same inputs on the same card give the same plan.
extern "C" int pvt_sdec_bwd_plan(int B, int N, int D, int L, int H,
                                 int n_layers, int C, int act, int loss_mode,
                                 long long* ws_floats, int* n_blocks) {
  if (bad_dims(B, N, D, L, H, n_layers, C, loss_mode))
    return (int)cudaErrorInvalidValue;
  const int R = tile_rows(H);
  const int total = B * ((N + R - 1) / R);
  const cudaError_t err =
      dispatch(H, act, loss_mode, PlanFn{n_layers, total, n_blocks});
  if (err != cudaSuccess) return (int)err;
  *ws_floats = (long long)(*n_blocks * slot_floats(H, n_layers, C) +
                           (size_t)total * 3 * H + (size_t)B * 3 * H);
  return (int)cudaSuccess;
}

// Plain C entry point (bound with ctypes). Shapes as pvt_sdec_fwd, plus
// g [B, N, C] (K2) or x [B, N] and wgt [B] (K3, C = 1, loss_mode = 1), the
// flat output `out` laid out as in launch() above, and a workspace of the
// size and block count that pvt_sdec_bwd_plan gives. All float32,
// contiguous, on the device of `stream`. Returns a cudaError_t.
extern "C" int pvt_sdec_bwd(const float* grid, const float* phi,
                            const float* dx, const float* sc, const float* z,
                            const float* wc, const float* bc, const float* wz,
                            const float* hw, const float* hb,
                            const float* wout, const float* bout,
                            const float* g, const float* x, const float* wgt,
                            float* out, float* ws, int B, int N, int D, int L,
                            int H, int n_layers, int C, int act,
                            int sigmoid_out, int loss_mode, int n_blocks,
                            void* stream) {
  if (bad_dims(B, N, D, L, H, n_layers, C, loss_mode))
    return (int)cudaErrorInvalidValue;
  const Args a{grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, g, x,
               wgt, out, ws, B, N, D, L, H, n_layers, C, sigmoid_out,
               n_blocks, reinterpret_cast<cudaStream_t>(stream)};
  return (int)dispatch(H, act, loss_mode, LaunchFn{&a});
}
