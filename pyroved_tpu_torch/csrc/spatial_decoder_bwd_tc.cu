// Fused spatial-decoder backward (K2) and one-pass Bernoulli train kernel
// (K3) on Hopper's tensor cores (sm_90a): bf16 operands, f32 accumulation.
//
// Replaces pyroved_tpu/ops/spatial_decoder.py::_bwd_kernel in both of its
// modes (K2 via _bwd, K3 via _train_call) under the JAX package's default
// BF16_MATMUL = True: the operands of the forward recompute h_l W_l (:601),
// of dwout = h_L^T dl (:647), of dW_l = h_l^T d_pre (:651) and of
// dh = d_pre W_l^T (:653) are rounded to bf16 and the products summed in f32.
// Heads, biases, activations, their derivatives and the coordinate layer
// stay in f32. spatial_decoder_bwd.cu is the BF16_MATMUL = False version;
// the math is the same (see its note), one body serves K2 and K3.
//
// What bounds it: 6 n_layers H^2 flops per pixel on the tensor cores. At
// the flagship training step (B = 200, N = 784, H = 128, two layers) that
// is 0.032 ms at the bf16 peak, at the large grid (B = 64, N = 16384)
// 0.211 ms (f32 bounds 0.466 and 3.113 ms). The elementwise work (exact
// tanhf or erff per hidden value, the derivatives, the bf16 casts) runs on
// the CUDA cores beside it and is of the same order.
//
// Design, against each cost of the f32 kernel:
//  * Tensor cores. The R pixels of a tile (64, 32 or 16) are the N side of
//    every product and the hidden units fill wgmma's M = 64, so a tile needs
//    no 64-row minimum of pixels. Per layer:
//      forward  pre^T [H, R]  = W_l^T h_l^T      (A MN-major, B MN-major)
//      dW_l     [H, H]       += h_l^T d_pre_l    (A K-major,  B K-major)
//      dh^T     [H, R]        = W_l d_pre_l^T    (A K-major,  B MN-major)
//    with both operands in shared memory. wgmma reads 16-bit operands in
//    either major order, so W_l^T, h_l^T and d_pre^T need no transposing
//    copy. Each layer's activations are an [H, R] bf16 matrix of 8x8 core
//    matrices (no swizzle), written by the epilogues straight from the
//    accumulator layout as bf16 pairs, without bank conflicts.
//  * Weights once per block. A prep kernel rounds hw to bf16 once per call
//    into two tiled copies. Where every layer fits beside the tile (H = 128,
//    up to three layers) a block copies all of them into shared memory once,
//    with cp.async, and the forward and dh read them there. Otherwise (H =
//    256, or more layers) each warpgroup copies the contiguous 64-unit panel
//    of W_l that its product needs (16 or 32 KB) from L2 per product.
//  * Weight grads on the SM. Each dW_l is cut into 64 x 128 units. A
//    warpgroup keeps two units in wgmma accumulator registers (128 floats a
//    thread) over all of its block's tiles and writes them to the block's
//    slot once, at the end. The flagship's four units fit one pass; a larger
//    decoder runs ceil(units / 4) passes, the blocks of pass p keeping units
//    4p .. 4p + 3 and recomputing the rest of the tile. db, dwout, dbout and
//    the loss add into shared memory (each entry owned by one thread) and
//    reach the slot at the end too. Nothing is read back from global memory.
//  * Determinism. No atomics: two small kernels reduce the block slots in
//    block order and the per-tile du/dv/dw sums in tile, then sample order.
//    The same inputs on the same card give bitwise-equal grads.
//  * Row loops. The head dot, db, dwout and the tile's du/dv/dw sums are
//    per-thread partials over the thread's accumulator entries, finished by
//    warp shuffles (over the 8 lanes sharing a pixel or the 4 sharing a unit).
//  * Epilogues without branches. With one block of 8 warps per SM (the unit
//    accumulators take half the registers) an epilogue is bound by the
//    latency of each entry's chain (tanhf, derivative, stores), so the
//    entries must interleave: the loops over a thread's entries are fully
//    unrolled and hold no branch. The activation is a compile-time tag
//    (with_act), the head is a pass of its own, l = 0 and l > 0 are separate
//    loops. Keeping a branch inside (the head under `if (last)`) cost a third
//    of the kernel's time.
//  * Activations: exact tanhf and erff. Each derivative is taken in f32,
//    from the f32 post-activation (gelu: from the pre-activation), in the
//    forward epilogue (the last layer's in the backward's first pass, from
//    the value the head kept), and kept in f32 in the accumulator layout, so
//    each thread reads back only its own entries.
//  * Budget, one block of 256 threads (two warpgroups) per SM: a tile keeps
//    (n_layers + 1) x 6 R H bytes of activations and derivatives. H = 128
//    runs R = 64 with resident weights up to two layers (215 KB of shared
//    memory at two), R = 32 beyond; H = 256 runs R = 32 up to two layers and
//    R = 16 beyond, with streamed weights (64 KB of panels). Registers: 128
//    unit accumulators and R H / 256 product accumulators a thread.
//  * Ragged tiles: pixels past N get zero coordinates and a zero cotangent,
//    so they add nothing. g and x are read in place. Nothing is allocated
//    here and nothing synchronises with the host.

#include <atomic>
#include <climits>

// sm90_common.cuh also holds the phase marks of the tile loop
// (PVT_PROFILE_PHASES, pyroved_tpu_torch/tools/profile_bwd_tc.py).
#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 2;                   // dW units a warpgroup keeps
constexpr int kPassUnits = 2 * kUnits;      // dW units a block keeps
constexpr int kUnitFloats = 64 * 128;       // one m64 x n128 accumulator
constexpr int kMaxC = 4;
constexpr int kMaxDevices = 64;

// d act / d pre from the f32 post-activation h, as spatial_decoder_bwd.cu
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

// hw [nl, H, H] f32 -> two bf16 copies, tiled: wb[l] the whole matrix
// (rows = inputs, 16 H bytes per row of cores; its 64-row panels are
// contiguous) and wf[l][p] its 64-column panels (1 KB per row of cores),
// each contiguous.
__global__ void sdec_tc_prep(const float* __restrict__ hw,
                             uint8_t* __restrict__ wb, uint8_t* __restrict__ wf,
                             int H, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int hh = H * H;
  const int l = i / hh, r = (i - l * hh) / H, c = i % H;
  const __nv_bfloat16 v = __float2bfloat16_rn(hw[i]);
  const size_t base = (size_t)l * hh * 2;
  *reinterpret_cast<__nv_bfloat16*>(wb + base + tiled(r, c, 16 * H)) = v;
  *reinterpret_cast<__nv_bfloat16*>(wf + base + (size_t)(c >> 6) * 128 * H +
                                    tiled(r, c & 63, 1024)) = v;
}

struct KArgs {
  const float *grid, *phi, *dx, *sc, *z, *wc, *bc, *wz, *hb, *wout, *bout,
      *g, *x, *wgt;
  const uint8_t *wb, *wf;
  float *blk_ws, *tile_ws;
  int B, N, D, L, nl, C, act, sigmoid_out, loss, resident, n_tiles, per_pass,
      slot;
};

// floats of the small per-tile buffers and block sums in shared memory
inline int small_floats(int H, int R, int nl, int C) {
  return 3 * H + 2 * R + kMaxC * R + R + kWarps * R * C + nl * H + H * C + C +
         1;
}

__host__ __device__ inline size_t weight_bytes(int H, int nl, bool resident) {
  return resident ? (size_t)nl * 2 * H * H : (size_t)2 * 128 * H;
}

template <int H, int R>
__global__ void __launch_bounds__(kThreads, 1)
sdec_bwd_tc_kernel(const KArgs a) {
  constexpr int SPW = H / 128;    // 64-unit slabs per warpgroup
  constexpr int NV = R / 2;       // accumulator floats of one slab
  constexpr int RSH = 16 * R;     // row-of-cores stride of an [H, R] level
  constexpr int LVL = 2 * H * R;  // bytes of one bf16 level
  constexpr int RSW = 16 * H;     // row-of-cores stride of a whole W_l
  constexpr int WL = 2 * H * H;   // bytes of one bf16 W_l
  constexpr int PANEL = 128 * H;  // bytes of a 64-unit panel of W_l
  constexpr int UPL = (H / 64) * (H / 128);  // dW units per layer
  const int nl = a.nl, C = a.C, act = a.act;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* wsm = smem;
  uint8_t* lv = wsm + weight_bytes(H, nl, a.resident);  // levels 0 .. nl
  float* gv = reinterpret_cast<float*>(lv + (nl + 1) * LVL);  // derivatives
  float* us = gv + (nl + 1) * H * R;
  float* vs = us + H;
  float* wv = vs + H;
  float* gs = wv + H;              // [R][2] coordinates
  float* dl = gs + 2 * R;          // [R][kMaxC] head cotangents
  float* lossp = dl + kMaxC * R;   // [R]
  float* headp = lossp + R;        // [kWarps][R][C] head partial dots
  float* db_s = headp + kWarps * R * C;  // [nl][H]   block sums from here
  float* dwout_s = db_s + nl * H;        // [H][C]
  float* dbout_s = dwout_s + H * C;      // [C]
  float* loss_s = dbout_s + C;           // [1]
  const int n_sums = nl * H + H * C + C + 1;

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int wi = wtid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int pass = blockIdx.x / a.per_pass;
  const int stream = blockIdx.x - pass * a.per_pass;
  const uint32_t w_addr = smem_addr(wsm), lv_addr = smem_addr(lv);
  uint8_t* panel = wsm + wg * PANEL;
  const uint32_t panel_addr = smem_addr(panel);
  // accumulator entry (slab s, value v) of this thread: unit row m, pixel n
  auto row_of = [&](int s, int hh) {
    return 64 * (wg * SPW + s) + 16 * wi + gq + 8 * hh;
  };
  auto dv = [&](int lvl, int s, int v) -> float& {
    return gv[((lvl * SPW + s) * NV + v) * kThreads + tid];
  };

  // this warpgroup's dW units in this pass: layer, 64-row and 128-col block
  int u_l[kUnits], u_r[kUnits], u_c[kUnits];
  float dw[kUnits][64];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int q = pass * kPassUnits + wg * kUnits + u;
    const int r = q % UPL;
    u_l[u] = q < nl * UPL ? q / UPL : -1;
    u_r[u] = r / (H / 128);
    u_c[u] = r % (H / 128);
#pragma unroll
    for (int i = 0; i < 64; ++i) dw[u][i] = 0.0f;
  }
  for (int i = tid; i < n_sums; i += kThreads) db_s[i] = 0.0f;
  if (a.resident) {
    const int bytes = nl * WL;
    for (int i = tid * 16; i < bytes; i += kThreads * 16)
      cp_async16(wsm + i, a.wb + i);
    cp_async_wait_all();
    fence_async_smem();
  }
  __syncthreads();

  PHASE_CLOCK;
  const int total = a.B * a.n_tiles;
  for (int t = stream; t < total; t += a.per_pass) {
    const int b = t / a.n_tiles;
    const int n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);

    PHASE_MARK(0);
    // -- per-sample folded transform, tile coordinates
    if (tid < H) {
      const int h = tid;
      float cph = 1.0f, sph = 0.0f, scale = 1.0f;
      if (a.D == 2) {
        sincosf(a.phi[b], &sph, &cph);
        scale = a.sc[b];
      }
      float w = 0.0f;
      for (int d = 0; d < a.D; ++d) w += a.dx[b * a.D + d] * a.wc[d * H + h];
      w += a.bc[h];
      float wzl = 0.0f;
      for (int l = 0; l < a.L; ++l)
        wzl += a.z[(size_t)b * a.L + l] * a.wz[l * H + h];
      wv[h] = w + wzl;
      const float a0 = a.wc[h];
      if (a.D == 2) {
        const float a1 = a.wc[H + h];
        us[h] = scale * (cph * a0 + sph * a1);
        vs[h] = scale * (-sph * a0 + cph * a1);
      } else {
        us[h] = a0;
        vs[h] = 0.0f;
      }
    }
    if (tid < R) {
      float gx = 0.0f, gy = 0.0f;
      if (tid < rows) {
        gx = a.grid[(size_t)(n0 + tid) * a.D];
        if (a.D == 2) gy = a.grid[(size_t)(n0 + tid) * a.D + 1];
      }
      gs[2 * tid] = gx;
      gs[2 * tid + 1] = gy;
    }
    __syncthreads();

    PHASE_MARK(1);
    // -- h0 = tanh(gx u + gy v + w): level 0, and 1 - h0^2
    auto h0_pass = [&](auto pade) {
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        float u2[2], v2[2], w2[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = row_of(s, hh);
          u2[hh] = us[m];
          v2[hh] = vs[m];
          w2[hh] = wv[m];
        }
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          const int n = 8 * j + 2 * tq;
          const float4 c2 = *reinterpret_cast<const float4*>(gs + 2 * n);
          const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float h[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pre = gx[e] * u2[hh] + gy[e] * v2[hh] + w2[hh];
              if constexpr (decltype(pade)::value) h[e] = pade_tanh(pre);
              else h[e] = tanhf(pre);
              dv(0, s, 4 * j + 2 * hh + e) = 1.0f - h[e] * h[e];
            }
            store_pair(lv + tiled(row_of(s, hh), n, RSH), h[0], h[1]);
          }
        }
      }
    };
    if (act == ACT_TANH_APPROX) h0_pass(std::true_type{});
    else h0_pass(std::false_type{});
    fence_async_smem();
    __syncthreads();

    PHASE_MARK(2);
    // -- forward recompute: level l + 1 = act(W_l^T level l + b_l)
    for (int l = 0; l < nl; ++l) {
      float acc[SPW][NV];
      const uint32_t hl = lv_addr + l * LVL;
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        const int slab = wg * SPW + s;
        uint32_t wa = w_addr + l * WL + slab * 8 * 128, wlbo = RSW;
        if (!a.resident) {
          load_panel(panel, a.wf + (size_t)l * WL + (size_t)slab * PANEL,
                     PANEL, wtid, wg);
          wa = panel_addr;
          wlbo = 1024;
        }
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < H / 16; ++k)
          wgmma<R, 1, 1>(acc[s], desc(wa + k * 2 * wlbo, wlbo, 128),
                         desc(hl + k * 2 * RSH, RSH, 128), k);
        wgmma_commit_wait();
        fence_regs(acc[s]);
      }
      uint8_t* out = lv + (l + 1) * LVL;
      float bias[SPW][2];  // of this thread's rows
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) bias[s][hh] = a.hb[l * H + row_of(s, hh)];
      // level l + 1 in bf16; in f32 act'(pre), or for the last layer what
      // the head pass and the backward read: h (gelu: pre)
      auto epilogue = [&](auto tag, auto last) {
        constexpr int A = decltype(tag)::value;
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int j = 0; j < R / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float h[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int v = 4 * j + 2 * hh + e;
                const float pre = acc[s][v] + bias[s][hh];
                float g;
                act_and_grad<A>(pre, h[e], g);
                if constexpr (decltype(last)::value)
                  dv(l + 1, s, v) = A == ACT_GELU ? pre : h[e];
                else
                  dv(l + 1, s, v) = g;
              }
              store_pair(out + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH),
                         h[0], h[1]);
            }
      };
      with_act(act, [&](auto tag) {
        if (l == nl - 1) epilogue(tag, std::true_type{});
        else epilogue(tag, std::false_type{});
      });
      fence_async_smem();
      __syncthreads();
    }

    PHASE_MARK(3);
    // -- head dots sum_m h_L[m][n] wout[m][c]: each thread over its rows,
    //    then the 8 lanes that share a pixel; the warps are summed below
    with_act(act, [&](auto tag) {
      constexpr int A = decltype(tag)::value;
      for (int c = 0; c < C; ++c) {
        float wo[SPW][2];
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) wo[s][hh] = a.wout[row_of(s, hh) * C + c];
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          float part[2] = {0.0f, 0.0f};
#pragma unroll
          for (int s = 0; s < SPW; ++s)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float h = dv(nl, s, 4 * j + 2 * hh + e);
                if constexpr (A == ACT_GELU) h = act_fn<A>(h);
                part[e] += h * wo[s][hh];
              }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = part[e];
            p += __shfl_xor_sync(0xffffffffu, p, 4);
            p += __shfl_xor_sync(0xffffffffu, p, 8);
            p += __shfl_xor_sync(0xffffffffu, p, 16);
            if (gq == 0)
              headp[((wg * 4 + wi) * R + 8 * j + 2 * tq + e) * C + c] = p;
          }
        }
      }
    });
    __syncthreads();

    PHASE_MARK(4);
    // -- head: logits, cotangents, loss; dbout and the loss in one warp
    for (int i = tid; i < R * kMaxC; i += kThreads) {
      const int n = i / kMaxC, c = i - n * kMaxC;
      float d = 0.0f, lp = 0.0f;  // channels past C stay 0
      if (c < C && n < rows) {
        float p = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) p += headp[(w * R + n) * C + c];
        const float logit = p + a.bout[c];
        const size_t q = (size_t)b * a.N + n0 + n;
        if (a.loss) {
          const float xv = a.x[q], wm = a.wgt[b];
          lp = -wm * (xv * logit - softplus(logit));
          d = wm * (sigmoid(logit) - xv);
        } else {
          const float gv_ = a.g[q * C + c];
          if (a.sigmoid_out) {
            const float sg = sigmoid(logit);
            d = gv_ * sg * (1.0f - sg);
          } else {
            d = gv_;
          }
        }
      }
      dl[i] = d;
      if (c == 0) lossp[n] = lp;
    }
    __syncthreads();
    if (tid < 32) {
      for (int c = 0; c <= C; ++c) {  // c == C: the loss
        float s = 0.0f;
        for (int n = tid; n < R; n += 32)
          s += c < C ? dl[n * kMaxC + c] : lossp[n];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (tid == 0) {
          if (c < C) dbout_s[c] += s;
          else loss_s[0] += s;
        }
      }
    }

    PHASE_MARK(5);
    // -- last layer: dh = dl wout^T (f32), dwout += bf16(h_L)^T bf16(dl),
    //    d_pre = dh act'(pre) in place of h_L, db
    with_act(act, [&](auto tag) {
      constexpr int A = decltype(tag)::value;
      uint8_t* top = lv + nl * LVL;
      float dbp[SPW][2] = {}, dwp[SPW][2][kMaxC] = {}, wo[SPW][2][kMaxC];
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int c = 0; c < kMaxC; ++c)
            wo[s][hh][c] = c < C ? a.wout[row_of(s, hh) * C + c] : 0.0f;
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int j = 0; j < R / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = row_of(s, hh), n = 8 * j + 2 * tq;
            const float2 hv = load_pair(top + tiled(m, n, RSH));
            const float hf[2] = {hv.x, hv.y};
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float dh = 0.0f;  // channels past C add exact zeros
#pragma unroll
              for (int c = 0; c < kMaxC; ++c) {
                const float dlv = dl[(n + e) * kMaxC + c];
                dh += dlv * wo[s][hh][c];
                dwp[s][hh][c] += hf[e] * bf16_round(dlv);
              }
              const float kept = dv(nl, s, 4 * j + 2 * hh + e);
              d[e] = dh * (A == ACT_GELU ? gelu_grad(kept)
                                         : grad_from_post<A>(kept));
              dbp[s][hh] += d[e];
            }
            store_pair(top + tiled(m, n, RSH), d[0], d[1]);
          }
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = row_of(s, hh);
          float v = dbp[s][hh];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tq == 0) db_s[(nl - 1) * H + m] += v;
#pragma unroll
          for (int c = 0; c < kMaxC; ++c) {
            float w = dwp[s][hh][c];
            w += __shfl_xor_sync(0xffffffffu, w, 1);
            w += __shfl_xor_sync(0xffffffffu, w, 2);
            if (tq == 0 && c < C) dwout_s[m * C + c] += w;
          }
        }
    });
    fence_async_smem();
    __syncthreads();

    PHASE_MARK(6);
    // -- hidden layers, last to first: level l + 1 holds d_pre_l
    for (int l = nl - 1; l >= 0; --l) {
      const uint32_t hl = lv_addr + l * LVL, dp = lv_addr + (l + 1) * LVL;
      float acc[SPW][NV];
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kUnits; ++u)  // dW units of layer l
        if (u_l[u] == l) {
#pragma unroll
          for (int k = 0; k < R / 16; ++k)
            wgmma<128, 0, 0>(dw[u],
                             desc(hl + u_r[u] * 8 * RSH + k * 256, 128, RSH),
                             desc(dp + u_c[u] * 16 * RSH + k * 256, 128, RSH),
                             1);
        }
#pragma unroll
      for (int s = 0; s < SPW; ++s) {  // dh^T = W_l d_pre^T
        const int slab = wg * SPW + s;
        uint32_t wa = w_addr + l * WL + slab * 8 * RSW;
        if (!a.resident) {
          wgmma_commit_wait();
          load_panel(panel, a.wb + (size_t)l * WL + (size_t)slab * PANEL,
                     PANEL, wtid, wg);
          wa = panel_addr;
          wgmma_fence();
        }
#pragma unroll
        for (int k = 0; k < H / 16; ++k)
          wgmma<R, 0, 1>(acc[s], desc(wa + k * 256, 128, RSW),
                         desc(dp + k * 2 * RSH, RSH, 128), k);
      }
      wgmma_commit_wait();
#pragma unroll
      for (int s = 0; s < SPW; ++s) fence_regs(acc[s]);
#pragma unroll
      for (int u = 0; u < kUnits; ++u) fence_regs(dw[u]);
      __syncthreads();  // both warpgroups are done reading level l

      // d = dh act'(pre_l): d_pre_{l-1} into level l (and db), or for l = 0
      // d0, summed into this tile's du, dv, dw
      if (l > 0) {
        float sp[SPW][2] = {};
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int j = 0; j < R / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float d[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int v = 4 * j + 2 * hh + e;
                d[e] = acc[s][v] * dv(l, s, v);
                sp[s][hh] += d[e];
              }
              store_pair(lv + l * LVL + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH),
                         d[0], d[1]);
            }
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float v = sp[s][hh];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (tq == 0) db_s[(l - 1) * H + row_of(s, hh)] += v;
          }
      } else {
        float sp[SPW][2][3] = {};
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          const float4 c2 = *reinterpret_cast<const float4*>(gs + 16 * j + 4 * tq);
          const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
          for (int s = 0; s < SPW; ++s)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int v = 4 * j + 2 * hh + e;
                const float d = acc[s][v] * dv(0, s, v);
                sp[s][hh][0] += gx[e] * d;
                sp[s][hh][1] += gy[e] * d;
                sp[s][hh][2] += d;
              }
        }
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              float v = sp[s][hh][q];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              sp[s][hh][q] = v;
            }
            const int m = row_of(s, hh);
            if (tq == 0 && pass == 0) {
              float* tw = a.tile_ws + (size_t)t * 3 * H;
              tw[m] = sp[s][hh][0];
              tw[H + m] = sp[s][hh][1];
              tw[2 * H + m] = sp[s][hh][2];
            }
          }
      }
      fence_async_smem();
      __syncthreads();
    }
    PHASE_MARK(7);
  }

  // -- the block's slot: its dW units, then db, dwout, dbout, loss
  float* slot = a.blk_ws + (size_t)blockIdx.x * a.slot;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    if (u_l[u] < 0) continue;
    float* o = slot + (wg * kUnits + u) * kUnitFloats;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * wi + gq + 8 * hh, col = 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(o + row * 128 + col) =
            make_float2(dw[u][4 * j + 2 * hh], dw[u][4 * j + 2 * hh + 1]);
      }
  }
  __syncthreads();
  float* sums = slot + kPassUnits * kUnitFloats;
  for (int i = tid; i < n_sums; i += kThreads) sums[i] = db_s[i];
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
sdec_tc_samples(const float* __restrict__ tile_ws, float* __restrict__ duvw,
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

// Weight epilogue from dWc on: dWc, dbc and dWz sum the per-sample
// vectors over the samples; dhw sums its unit in the slots of its pass,
// dhb, dwout, dbout and the loss the slots of pass 0. Each block takes 32
// outputs (one a lane); its 8 warps sum every 8th sample or slot, then
// warp 0 adds the 8 partials in warp order: a fixed order, and 8 loads in
// flight for each output.
__global__ void __launch_bounds__(kThreads)
sdec_tc_weights(const float* __restrict__ blk_ws, int per_pass, int slot,
                const float* __restrict__ duvw, const float* __restrict__ phi,
                const float* __restrict__ dx, const float* __restrict__ sc,
                const float* __restrict__ z, float* __restrict__ out, int B,
                int D, int L, int H, int nl, int C, int loss) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const int n_samp = (D + 1 + L) * H, n_dw = nl * H * H;
  const int n_sums = nl * H + H * C + C + loss;
  float s = 0.0f;
  if (i < n_samp) {
    const int row = i / H, h = i - row * H;
    for (int b = w; b < B; b += kWarps) {
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
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += part[k][lane];
    out[i] = t;
  }
}

// What a call runs: tile rows R, whether the weights stay resident, the
// shared memory, passes over the tiles and blocks per pass.
struct Plan {
  int R, resident, smem, passes, per_pass, n_tiles;
};

inline size_t smem_bytes(int H, int R, int nl, int C, bool resident) {
  return weight_bytes(H, nl, resident) + (size_t)(nl + 1) * 6 * H * R +
         4 * (size_t)small_floats(H, R, nl, C);
}

template <int H, int R>
cudaError_t allow_smem(int dev, int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sdec_bwd_tc_kernel<H, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int H, int R>
cudaError_t occupancy(int dev, int optin, int smem, int* per_sm) {
  cudaError_t err = allow_smem<H, R>(dev, optin);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, sdec_bwd_tc_kernel<H, R>, kThreads, smem);
}

// The largest tile (R = 64, 32 at H = 128; 32, 16 at H = 256) whose
// activations fit, with the weights resident where they fit beside it.
cudaError_t make_plan(int B, int N, int H, int nl, int C, Plan* p) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->R = 0;
  for (int R = H == 128 ? 64 : 32; R >= (H == 128 ? 32 : 16) && !p->R; R /= 2)
    for (int res = 1; res >= 0; --res)
      if (smem_bytes(H, R, nl, C, res) <= (size_t)optin) {
        p->R = R;
        p->resident = res;
        p->smem = (int)smem_bytes(H, R, nl, C, res);
        break;
      }
  if (!p->R) return cudaErrorInvalidValue;
  if (H == 128)
    err = p->R == 64 ? occupancy<128, 64>(dev, optin, p->smem, &per_sm)
                     : occupancy<128, 32>(dev, optin, p->smem, &per_sm);
  else
    err = p->R == 32 ? occupancy<256, 32>(dev, optin, p->smem, &per_sm)
                     : occupancy<256, 16>(dev, optin, p->smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int units = nl * (H / 64) * (H / 128);
  p->passes = (units + kPassUnits - 1) / kPassUnits;
  p->n_tiles = (N + p->R - 1) / p->R;
  const long long total = (long long)B * p->n_tiles;
  const long long fit = (long long)per_sm * sms / p->passes;
  p->per_pass = (int)(fit < 1 ? 1 : fit < total ? fit : total);
  return cudaSuccess;
}

inline size_t slot_floats(int H, int nl, int C) {
  const size_t q = (size_t)kPassUnits * kUnitFloats + (size_t)nl * H +
                   (size_t)H * C + C + 1;
  return (q + 3) / 4 * 4;
}

// workspace: wb | wf (bf16 weights) | block slots | tile sums | sample sums
inline size_t workspace_floats(const Plan& p, int B, int H, int nl, int C) {
  return (size_t)nl * H * H + (size_t)p.passes * p.per_pass * slot_floats(H, nl, C) +
         (size_t)B * p.n_tiles * 3 * H + (size_t)B * 3 * H;
}

struct Args {
  const float *grid, *phi, *dx, *sc, *z, *wc, *bc, *wz, *hw, *hb, *wout,
      *bout, *g, *x, *wgt;
  float *out, *ws;
  int B, N, D, L, H, n_layers, C, act, sigmoid_out, loss, n_blocks;
  cudaStream_t stream;
};

cudaError_t launch(const Args& a) {
  Plan p;
  cudaError_t err = make_plan(a.B, a.N, a.H, a.n_layers, a.C, &p);
  if (err != cudaSuccess) return err;
  if (a.n_blocks != p.passes * p.per_pass) return cudaErrorInvalidValue;
  const int H = a.H, nl = a.n_layers;
  const size_t slot = slot_floats(H, nl, a.C);
  uint8_t* wb = reinterpret_cast<uint8_t*>(a.ws);
  uint8_t* wf = wb + (size_t)nl * H * H * 2;
  float* blk_ws = a.ws + (size_t)nl * H * H;
  float* tile_ws = blk_ws + (size_t)a.n_blocks * slot;
  float* duvw = tile_ws + (size_t)a.B * p.n_tiles * 3 * H;
  // out: dphi [B] | ddx [B, D] | dsc [B] | dz [B, L] | dWc [D, H] | dbc [H]
  //      | dWz [L, H] | dhw [nl, H, H] | dhb [nl, H] | dwout [H, C]
  //      | dbout [C] | loss (K3)
  float* dphi = a.out;
  float* ddx = dphi + a.B;
  float* dsc = ddx + (size_t)a.B * a.D;
  float* dz = dsc + a.B;
  float* out_w = dz + (size_t)a.B * a.L;

  const int n_w = nl * H * H;
  sdec_tc_prep<<<(n_w + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.hw, wb, wf, H, n_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const KArgs k{a.grid, a.phi, a.dx, a.sc, a.z, a.wc, a.bc, a.wz, a.hb,
                a.wout, a.bout, a.g, a.x, a.wgt, wb, wf, blk_ws, tile_ws,
                a.B, a.N, a.D, a.L, nl, a.C, a.act, a.sigmoid_out, a.loss,
                p.resident, p.n_tiles, p.per_pass, (int)slot};
  if (H == 128) {
    if (p.R == 64)
      sdec_bwd_tc_kernel<128, 64><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
    else
      sdec_bwd_tc_kernel<128, 32><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
  } else {
    if (p.R == 32)
      sdec_bwd_tc_kernel<256, 32><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
    else
      sdec_bwd_tc_kernel<256, 16><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (H == 128)
    sdec_tc_samples<128><<<a.B, 128, 0, a.stream>>>(
        tile_ws, duvw, a.phi, a.sc, a.wc, a.wz, dphi, ddx, dsc, dz, p.n_tiles,
        a.D, a.L);
  else
    sdec_tc_samples<256><<<a.B, 256, 0, a.stream>>>(
        tile_ws, duvw, a.phi, a.sc, a.wc, a.wz, dphi, ddx, dsc, dz, p.n_tiles,
        a.D, a.L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_vals = (a.D + 1 + a.L) * H + n_w + nl * H + H * a.C + a.C + a.loss;
  sdec_tc_weights<<<(n_vals + 31) / 32, kThreads, 0, a.stream>>>(
      blk_ws, p.per_pass, (int)slot, duvw, a.phi, a.dx, a.sc, a.z, out_w,
      a.B, a.D, a.L, H, nl, a.C, a.loss);
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

// Workspace and grid of one call: *n_blocks blocks of the main kernel and
// *ws_floats floats of workspace. The same inputs on the same card give the
// same plan.
extern "C" int pvt_sdec_bwd_tc_plan(int B, int N, int D, int L, int H,
                                    int n_layers, int C, int act,
                                    int loss_mode, long long* ws_floats,
                                    int* n_blocks) {
  if (bad_dims(B, N, D, L, H, n_layers, C, act, loss_mode))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(B, N, H, n_layers, C, &p);
  if (err != cudaSuccess) return (int)err;
  *n_blocks = p.passes * p.per_pass;
  *ws_floats = (long long)workspace_floats(p, B, H, n_layers, C);
  return (int)cudaSuccess;
}

// Plain C entry point (bound with ctypes), arguments as pvt_sdec_bwd in
// spatial_decoder_bwd.cu: the forward's inputs, g [B, N, C] (K2) or x
// [B, N] and wgt [B] (K3, C = 1, loss_mode = 1), the flat output `out`, and
// a workspace of the size and block count that pvt_sdec_bwd_tc_plan gives.
// All float32, contiguous, on the device of `stream`. Returns a cudaError_t.
extern "C" int pvt_sdec_bwd_tc(const float* grid, const float* phi,
                               const float* dx, const float* sc,
                               const float* z, const float* wc,
                               const float* bc, const float* wz,
                               const float* hw, const float* hb,
                               const float* wout, const float* bout,
                               const float* g, const float* x,
                               const float* wgt, float* out, float* ws, int B,
                               int N, int D, int L, int H, int n_layers, int C,
                               int act, int sigmoid_out, int loss_mode,
                               int n_blocks, void* stream) {
  if (bad_dims(B, N, D, L, H, n_layers, C, act, loss_mode))
    return (int)cudaErrorInvalidValue;
  const Args a{grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, g, x,
               wgt, out, ws, B, N, D, L, H, n_layers, C, act, sigmoid_out,
               loss_mode, n_blocks, reinterpret_cast<cudaStream_t>(stream)};
  return (int)launch(a);
}

PVT_PHASE_READER(pvt_sdec_bwd_tc_phase_cycles)
