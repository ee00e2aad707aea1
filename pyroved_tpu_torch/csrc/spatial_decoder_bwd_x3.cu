// Fused spatial-decoder backward (K2) and one-pass Bernoulli train kernel
// (K3) in f32 on Hopper's tensor cores (sm_90a): each f32 operand of a
// hidden-layer product is split into three bf16 limbs and six limb
// products sum into one f32 accumulator.
//
// Replaces pyroved_tpu/ops/spatial_decoder.py::_bwd_kernel in both of its
// modes (K2 via _bwd, K3 via _train_call) under BF16_MATMUL = False: the
// forward recompute h_l W_l (:601), dwout = h_L^T dl (:647), dW_l =
// h_l^T d_pre (:651) and dh = d_pre W_l^T (:653) in f32. The TPU kernel
// makes its f32 products as bf16 passes on the MXU (:222-225); here
//
//   x = hi + mid + lo,  hi = bf16(x), mid = bf16(x - hi),
//                       lo = bf16(x - hi - mid)
//   a b ~ lo_a hi_b + hi_a lo_b + mid_a mid_b + mid_a hi_b + hi_a mid_b
//         + hi_a hi_b
//
// on wgmma (bf16 operands, f32 accumulation). Each limb carries 8 bits
// and the rounding its sign, so the three rebuild an f32 value to its last
// bit, and the dropped terms (mid lo, lo mid, lo lo) are of order 2^-24
// relative: the function computed is the f32 kernel's to about f32's own
// rounding. The MMA aligns a step's products to the largest, keeps 25
// bits below it and truncates the sum toward zero, so its chains of
// additions lose more than f32's (tools/x3_accuracy.py measures both).
// The products issue smallest first and hi hi last, each of hi hi's K / 16
// steps into an accumulator of its own, added in f32 on the CUDA cores;
// the dW accumulators restart every kFlushTiles tiles (each layer's right
// after its products, before the dh products need the registers) and are
// added into the block's slot in f32, so no chain inside the MMA grows
// with the block's share of the batch. Heads, biases, activations, their
// derivatives, dwout and the coordinate layer are f32 on the CUDA cores,
// as in spatial_decoder_bwd_tc.cu, whose structure this is (see its note).
//
// What bounds it: 6 n_layers H^2 flops per pixel, six times over on the
// tensor cores: at the flagship training step (B = 200, N = 784, H = 128,
// two layers) 0.192 ms at the bf16 dense peak (the f32 CUDA cores' bound:
// 0.466 ms). Beside them the epilogues (exact tanhf, derivatives, the
// limbs) run on the CUDA cores.
//
// Design, against spatial_decoder_bwd_tc.cu's:
//  * Levels. A level is the three limb planes of an [H, R] matrix of 8x8
//    core matrices, 6 R H bytes, written by the epilogues straight from the
//    accumulator layout. The f32 derivative buffer of the bf16 kernel is
//    not kept: the limbs rebuild each f32 activation exactly, and its
//    derivative is taken from it where it is needed. Gelu, whose
//    derivative needs the pre-activation, keeps an f32 buffer per hidden
//    level.
//  * Weights. A prep kernel writes the three limbs of each W_l once per
//    call, in the bf16 kernel's two tiled layouts. Three limbs of every
//    layer do not fit beside a tile (192 KB at H = 128, two layers), so
//    each warpgroup streams the 64-unit panels its products need, one limb
//    at a time (W_lo, then W_mid, then W_hi, each with the activation
//    limbs it pairs with), through two buffers: the next panel of the
//    fixed sequence (forward layers, then dh layers, then the next tile)
//    is in flight while the current one is used. Where two buffers do not
//    fit, one.
//  * Budget, one block of 256 threads per SM: (n_layers + 1) 6 R H bytes
//    of levels (gelu: n_layers 4 R H more), 2 x 2 x 128 H bytes of panels,
//    and the block sums with their compensations.
//    H = 128 runs R = 64 up to two layers with two buffers (220-228 KB),
//    R = 32 beyond; H = 256 runs R = 32 with one buffer up to two layers,
//    R = 16 beyond. make_plan picks the largest R, then the most buffers.
//  * Sums. The block's running sums (db, dwout, dbout, the loss) are
//    compensated (Kahan) and the two reduction kernels of sm90_bwd.cuh
//    sum in double: such sums can cancel far below their terms (dbout in
//    chip_smoke's gelu case at H = 256 is 1/5,800 of its terms' sum of
//    magnitudes), and f32's own order of summation then shows.
//  * Determinism. No atomics; the dW flushes, the slots and the tile sums
//    are reduced in fixed orders: repeats are bitwise equal.

#include <atomic>

// sm90_common.cuh (through sm90_bwd.cuh) also holds the phase marks of the
// tile loop (PVT_PROFILE_PHASES, pyroved_tpu_torch/tools/profile_f32.py).
#include "sm90_bwd.cuh"

// Tiles between two flushes of the dW accumulators into the block's slot
// (a build with another value measures what a longer chain costs).
#ifndef PVT_X3_FLUSH_TILES
#define PVT_X3_FLUSH_TILES 1
#endif
// k16 steps of a hi hi chunk of the forward and dh products (0: hi hi
// chained into the same accumulator as the other five)
#ifndef PVT_X3_HI_CHUNK
#define PVT_X3_HI_CHUNK 1
#endif

namespace {

constexpr int kFlushTiles = PVT_X3_FLUSH_TILES;
constexpr int kHiChunk = PVT_X3_HI_CHUNK;

// The limbs of (a, b) into three planes `plane` bytes apart, as bf16 pairs.
__device__ __forceinline__ void store_limbs(uint8_t* p, int plane, float a,
                                            float b) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  const float2 h = __bfloat1622float2(hi);
  const float ra = a - h.x, rb = b - h.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
  const float2 m = __bfloat1622float2(mid);
  *reinterpret_cast<__nv_bfloat162*>(p) = hi;
  *reinterpret_cast<__nv_bfloat162*>(p + plane) = mid;
  *reinterpret_cast<__nv_bfloat162*>(p + 2 * plane) =
      __floats2bfloat162_rn(ra - m.x, rb - m.y);
}

// The f32 pair that store_limbs split (exactly).
__device__ __forceinline__ float2 load_limbs(const uint8_t* p, int plane) {
  const float2 h = load_pair(p), m = load_pair(p + plane),
               l = load_pair(p + 2 * plane);
  return make_float2((h.x + m.x) + l.x, (h.y + m.y) + l.y);
}

// hw [nl, H, H] f32 -> its three limbs, each in the bf16 kernel's two
// tiled layouts: wb[limb][l] the whole matrix (rows = inputs, 16 H bytes a
// row of cores, 64-row panels contiguous) and wf[limb][l][p] its 64-column
// panels (1 KB a row of cores). Limb 0 is hi, 1 mid, 2 lo.
__global__ void sdec_x3_prep(const float* __restrict__ hw,
                             uint8_t* __restrict__ wb, uint8_t* __restrict__ wf,
                             int H, int nl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int hh = H * H;
  if (i >= nl * hh) return;
  const int l = i / hh, r = (i - l * hh) / H, c = i % H;
  const float x = hw[i];
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const float rest = x - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(rest);
  const __nv_bfloat16 limbs[3] = {
      hi, mid, __float2bfloat16_rn(rest - __bfloat162float(mid))};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t base = ((size_t)k * nl + l) * hh * 2;
    *reinterpret_cast<__nv_bfloat16*>(wb + base + tiled(r, c, 16 * H)) =
        limbs[k];
    *reinterpret_cast<__nv_bfloat16*>(wf + base + (size_t)(c >> 6) * 128 * H +
                                      tiled(r, c & 63, 1024)) = limbs[k];
  }
}

// acc = W x (one 64-unit slab, R pixels) as the six limb products, from
// the warpgroup's panel stream: W's limbs lo, mid and hi in turn
// (acquire()), each against the limbs of x it pairs with (da(w, k) and
// db(plane, k) the k-th k16 step's descriptors). hi hi comes last, in
// chunks of kHiChunk k-steps, each in an accumulator of its own added into
// acc in f32 on the CUDA cores: the MMA aligns a step's products to the
// largest, keeps 25 bits below it and truncates its sum toward zero
// (tools/x3_accuracy.py's probe), so the chunks bound how many such sums
// chain.
template <int R, int K16, int TA, int TB, typename Acquire, typename DescA,
          typename DescB>
__device__ __forceinline__ void six_products(float (&acc)[R / 2],
                                             Acquire& acquire, DescA da,
                                             DescB db) {
  static_assert(kHiChunk == 0 || K16 % kHiChunk == 0, "whole chunks");
  auto run = [&](float (&d)[R / 2], uint32_t w, int plane, int k0, int k1,
                 bool first) {
#pragma unroll
    for (int k = k0; k < k1; ++k)
      wgmma<R, TA, TB>(d, da(w, k), db(plane, k), first && k == k0 ? 0 : 1);
  };
  uint32_t w = acquire();  // W_lo: lo hi
  wgmma_fence();
  run(acc, w, 0, 0, K16, true);
  wgmma_commit_wait();
  w = acquire();  // W_mid: mid mid, mid hi
  wgmma_fence();
  run(acc, w, 1, 0, K16, false);
  run(acc, w, 0, 0, K16, false);
  wgmma_commit_wait();
  w = acquire();  // W_hi: hi lo, hi mid, hi hi
  wgmma_fence();
  run(acc, w, 2, 0, K16, false);
  run(acc, w, 1, 0, K16, false);
  if constexpr (kHiChunk == 0) {
    run(acc, w, 0, 0, K16, false);
    wgmma_commit_wait();
  } else {
    float part[R / 2];
#pragma unroll
    for (int k0 = 0; k0 < K16; k0 += kHiChunk) {
      run(part, w, 0, k0, k0 + kHiChunk, true);
      wgmma_commit_wait();
      fence_regs(part);
      fence_regs(acc);
#pragma unroll
      for (int v = 0; v < R / 2; ++v) acc[v] += part[v];
      wgmma_fence();
    }
  }
  fence_regs(acc);
}

struct KArgs {
  const float *grid, *phi, *dx, *sc, *z, *wc, *bc, *wz, *hb, *wout, *bout,
      *g, *x, *wgt;
  const uint8_t *wb, *wf;
  float *blk_ws, *tile_ws;
  int B, N, D, L, nl, C, act, sigmoid_out, loss, nbuf, n_tiles, per_pass,
      slot;
};

template <int H, int R>
__global__ void __launch_bounds__(kThreads, 1)
sdec_bwd_x3_kernel(const KArgs a) {
  constexpr int SPW = H / 128;    // 64-unit slabs per warpgroup
  constexpr int NV = R / 2;       // accumulator floats of one slab
  constexpr int RSH = 16 * R;     // row-of-cores stride of an [H, R] plane
  constexpr int LVL = 2 * H * R;  // bytes of one limb plane of a level
  constexpr int LV3 = 3 * LVL;    // bytes of a level
  constexpr int RSW = 16 * H;     // row-of-cores stride of a whole W_l
  constexpr int WL = 2 * H * H;   // bytes of one limb of one W_l
  constexpr int PANEL = 128 * H;  // bytes of a 64-unit panel of W_l
  constexpr int UPL = (H / 64) * (H / 128);  // dW units per layer
  const int nl = a.nl, C = a.C, act = a.act, nbuf = a.nbuf;
  const bool gelu = act == ACT_GELU;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* lv = smem + 2 * nbuf * PANEL;  // levels 0 .. nl
  float* gv = reinterpret_cast<float*>(lv + (nl + 1) * LV3);  // gelu
  float* us = gv + (gelu ? nl * H * R : 0);
  float* vs = us + H;
  float* wv = vs + H;
  float* gs = wv + H;              // [R][2] coordinates
  float* dl = gs + 2 * R;          // [R][kMaxC] head cotangents
  float* lossp = dl + kMaxC * R;   // [R]
  float* headp = lossp + R;        // [kWarps][R][C] head partial dots
  // the block sums: db [nl][H], dwout [H][C], dbout [C], the loss [1];
  // then their compensations
  float* db_s = headp + kWarps * R * C;
  const int n_sums = nl * H + H * C + C + 1;
  float* sums_c = db_s + n_sums;
  auto add_sum = [&](int k, float v) { kahan_add(db_s[k], sums_c[k], v); };

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int wi = wtid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int pass = blockIdx.x / a.per_pass;
  const int stream = blockIdx.x - pass * a.per_pass;
  const uint32_t lv_addr = smem_addr(lv);
  uint8_t* my_panels = smem + wg * nbuf * PANEL;
  const uint32_t panels_addr = smem_addr(my_panels);
  // accumulator entry (slab s, value v) of this thread: unit row m, pixel n
  auto row_of = [&](int s, int hh) {
    return 64 * (wg * SPW + s) + 16 * wi + gq + 8 * hh;
  };
  // gelu's f32 buffer of hidden level lvl (1 .. nl), in the accumulator
  // layout: act'(pre), or the last layer's pre
  auto dv = [&](int lvl, int s, int v) -> float& {
    return gv[(((lvl - 1) * SPW + s) * NV + v) * kThreads + tid];
  };

  // The warpgroup's panel stream: per tile, for each forward layer, slab
  // and limb (lo, mid, hi) a panel of wf, then the same for each dh layer,
  // last to first, from wb. acquire() returns the next one in shared
  // memory, having started the copy of the one after it (two buffers).
  const int per_tile = 6 * nl * SPW;
  auto panel_src = [&](int q) {
    const int third = 3 * nl * SPW;
    const bool fwd = q < third;
    const int r = fwd ? q : q - third;
    const int li = r / (3 * SPW), s = (r / 3) % SPW, limb = 2 - r % 3;
    const int l = fwd ? li : nl - 1 - li;
    return (fwd ? a.wf : a.wb) + ((size_t)limb * nl + l) * WL +
           (size_t)(wg * SPW + s) * PANEL;
  };
  auto issue = [&](int q, int buf) {
    const uint8_t* src = panel_src(q);
    uint8_t* dst = my_panels + buf * PANEL;
    for (int i = wtid * 16; i < PANEL; i += 128 * 16)
      cp_async16(dst + i, src + i);
    cp_async_commit();
  };
  int q_next = 0, buf_next = 0;  // the panel acquire() returns next
  auto acquire = [&]() -> uint32_t {
    wg_barrier(wg);  // no warp of the group still reads the buffer refilled
    const int q = q_next, buf = buf_next;
    q_next = q + 1 == per_tile ? 0 : q + 1;
    if (nbuf == 2) {
      buf_next = buf ^ 1;
      issue(q_next, buf_next);
      cp_async_wait_group<1>();
    } else {
      issue(q, 0);
      cp_async_wait_group<0>();
    }
    fence_async_smem();
    wg_barrier(wg);
    return panels_addr + buf * PANEL;
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
  float* slot = a.blk_ws + (size_t)blockIdx.x * a.slot;
  // layer l's dW accumulators added into (first: written to) the block's
  // slot, then restarted; 16 of the thread's pairs a batch, their loads in
  // flight together
  auto flush = [&](int l, bool first) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      if (u_l[u] != l) continue;
      float* o = slot + (wg * kUnits + u) * kUnitFloats +
                 (16 * wi + gq) * 128 + 2 * tq;
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += 8) {
        float2 old[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            old[j][hh] = first ? make_float2(0.0f, 0.0f)
                               : *reinterpret_cast<const float2*>(
                                     o + 8 * hh * 128 + 8 * (j0 + j));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int v = 4 * (j0 + j) + 2 * hh;
            *reinterpret_cast<float2*>(o + 8 * hh * 128 + 8 * (j0 + j)) =
                make_float2(old[j][hh].x + dw[u][v], old[j][hh].y + dw[u][v + 1]);
          }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) dw[u][i] = 0.0f;
    }
  };
  for (int i = tid; i < 2 * n_sums; i += kThreads) db_s[i] = 0.0f;
  if (nbuf == 2) issue(0, 0);
  __syncthreads();

  PHASE_CLOCK;
  bool first = true;
  int since = 0;  // tiles since the last flush
  const int total = a.B * a.n_tiles;
  for (int t = stream; t < total; t += a.per_pass) {
    const int b = t / a.n_tiles;
    const int n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);
    const bool flush_now = since + 1 == kFlushTiles;

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
    // -- h0 = tanh(gx u + gy v + w): level 0
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
            }
            store_limbs(lv + tiled(row_of(s, hh), n, RSH), LVL, h[0], h[1]);
          }
        }
      }
    };
    if (act == ACT_TANH_APPROX) h0_pass(std::true_type{});
    else h0_pass(std::false_type{});
    fence_async_smem();
    __syncthreads();

    PHASE_MARK(2);
    // -- forward recompute: level l + 1 = act(W_l^T level l + b_l), the
    //    panels of W_l^T (A, MN-major) against the limbs of level l
    for (int l = 0; l < nl; ++l) {
      float acc[SPW][NV];
      const uint32_t hl = lv_addr + l * LV3;
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        six_products<R, H / 16, 1, 1>(
            acc[s], acquire,
            [&](uint32_t w, int k) { return desc(w + k * 2 * 1024, 1024, 128); },
            [&](int plane, int k) {
              return desc(hl + plane * LVL + k * 2 * RSH, RSH, 128);
            });
      }
      uint8_t* out = lv + (l + 1) * LV3;
      float bias[SPW][2];  // of this thread's rows
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) bias[s][hh] = a.hb[l * H + row_of(s, hh)];
      // level l + 1 as limbs; for gelu in f32 act'(pre), or for the last
      // layer pre, which the head's backward reads
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
                if constexpr (A == ACT_GELU) {
                  float g;
                  act_and_grad<A>(pre, h[e], g);
                  dv(l + 1, s, v) = decltype(last)::value ? pre : g;
                } else {
                  h[e] = act_fn<A>(pre);
                }
              }
              store_limbs(out + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH), LVL,
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
    {
      const uint8_t* top = lv + nl * LV3;
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
            for (int hh = 0; hh < 2; ++hh) {
              const float2 h =
                  load_limbs(top + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH), LVL);
              part[0] += h.x * wo[s][hh];
              part[1] += h.y * wo[s][hh];
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
    }
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
        if (tid == 0) add_sum(nl * H + H * C + c, s);  // c == C: the loss
      }
    }

    PHASE_MARK(5);
    // -- last layer: dh = dl wout^T, dwout += h_L^T dl, d_pre = dh act'(pre)
    //    in place of h_L, db; all f32
    with_act(act, [&](auto tag) {
      constexpr int A = decltype(tag)::value;
      uint8_t* top = lv + nl * LV3;
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
            uint8_t* p = top + tiled(m, n, RSH);
            const float2 hv = load_limbs(p, LVL);
            const float hf[2] = {hv.x, hv.y};
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float dh = 0.0f;  // channels past C add exact zeros
#pragma unroll
              for (int c = 0; c < kMaxC; ++c) {
                const float dlv = dl[(n + e) * kMaxC + c];
                dh += dlv * wo[s][hh][c];
                dwp[s][hh][c] += hf[e] * dlv;
              }
              float g;
              if constexpr (A == ACT_GELU)
                g = gelu_grad(dv(nl, s, 4 * j + 2 * hh + e));
              else
                g = grad_from_post<A>(hf[e]);
              d[e] = dh * g;
              dbp[s][hh] += d[e];
            }
            store_limbs(p, LVL, d[0], d[1]);
          }
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = row_of(s, hh);
          float v = dbp[s][hh];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tq == 0) add_sum((nl - 1) * H + m, v);
#pragma unroll
          for (int c = 0; c < kMaxC; ++c) {
            float w = dwp[s][hh][c];
            w += __shfl_xor_sync(0xffffffffu, w, 1);
            w += __shfl_xor_sync(0xffffffffu, w, 2);
            if (tq == 0 && c < C) add_sum(nl * H + m * C + c, w);
          }
        }
    });
    fence_async_smem();
    __syncthreads();

    PHASE_MARK(6);
    // -- hidden layers, last to first: level l + 1 holds d_pre_l
    for (int l = nl - 1; l >= 0; --l) {
      const uint32_t hl = lv_addr + l * LV3, dp = lv_addr + (l + 1) * LV3;
      float acc[SPW][NV];
      wgmma_fence();
      // dW units of layer l += h_l^T d_pre_l: (h, d) limb pairs lo hi,
      // hi lo, mid mid, mid hi, hi mid, hi hi
      constexpr int kPairs[6][2] = {{2, 0}, {0, 2}, {1, 1}, {1, 0}, {0, 1}, {0, 0}};
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
        if (u_l[u] == l) {
#pragma unroll
          for (int pr = 0; pr < 6; ++pr)
#pragma unroll
            for (int k = 0; k < R / 16; ++k)
              wgmma<128, 0, 0>(
                  dw[u],
                  desc(hl + kPairs[pr][0] * LVL + u_r[u] * 8 * RSH + k * 256,
                       128, RSH),
                  desc(dp + kPairs[pr][1] * LVL + u_c[u] * 16 * RSH + k * 256,
                       128, RSH),
                  1);
        }
      if (flush_now) {  // before the dh products, which need the registers
        wgmma_commit_wait();
#pragma unroll
        for (int u = 0; u < kUnits; ++u) fence_regs(dw[u]);
        flush(l, first);
      }
#pragma unroll
      for (int s = 0; s < SPW; ++s)  // dh^T = W_l d_pre^T, W_l's panels K-major
        six_products<R, H / 16, 0, 1>(
            acc[s], acquire,
            [&](uint32_t w, int k) { return desc(w + k * 256, 128, RSW); },
            [&](int plane, int k) {
              return desc(dp + plane * LVL + k * 2 * RSH, RSH, 128);
            });
#pragma unroll
      for (int s = 0; s < SPW; ++s) fence_regs(acc[s]);
#pragma unroll
      for (int u = 0; u < kUnits; ++u) fence_regs(dw[u]);
      __syncthreads();  // both warpgroups are done reading levels l, l + 1

      // d = dh act'(pre_l): d_pre_{l-1} into level l (and db), or for l = 0
      // d0, summed into this tile's du, dv, dw
      if (l > 0) {
        with_act(act, [&](auto tag) {
          constexpr int A = decltype(tag)::value;
          float sp[SPW][2] = {};
#pragma unroll
          for (int s = 0; s < SPW; ++s)
#pragma unroll
            for (int j = 0; j < R / 8; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                uint8_t* p =
                    lv + l * LV3 + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH);
                float g[2];
                if constexpr (A == ACT_GELU) {
                  g[0] = dv(l, s, 4 * j + 2 * hh);
                  g[1] = dv(l, s, 4 * j + 2 * hh + 1);
                } else {
                  const float2 h = load_limbs(p, LVL);
                  g[0] = grad_from_post<A>(h.x);
                  g[1] = grad_from_post<A>(h.y);
                }
                float d[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  d[e] = acc[s][4 * j + 2 * hh + e] * g[e];
                  sp[s][hh] += d[e];
                }
                store_limbs(p, LVL, d[0], d[1]);
              }
#pragma unroll
          for (int s = 0; s < SPW; ++s)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float v = sp[s][hh];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              if (tq == 0) add_sum((l - 1) * H + row_of(s, hh), v);
            }
        });
      } else {
        float sp[SPW][2][3] = {};
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          const float4 c2 = *reinterpret_cast<const float4*>(gs + 16 * j + 4 * tq);
          const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
          for (int s = 0; s < SPW; ++s)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              // the coordinate layer is tanh: 1 - h0^2
              const float2 h = load_limbs(
                  lv + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH), LVL);
              const float g[2] = {1.0f - h.x * h.x, 1.0f - h.y * h.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float d = acc[s][4 * j + 2 * hh + e] * g[e];
                sp[s][hh][0] += gx[e] * d;
                sp[s][hh][1] += gy[e] * d;
                sp[s][hh][2] += d;
              }
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
    since = flush_now ? 0 : since + 1;
    first = first && !flush_now;
  }

  // -- the block's slot: what is left of its dW units, then db, dwout,
  //    dbout, loss
  if (since > 0 || first)
    for (int l = 0; l < nl; ++l) flush(l, first);
  cp_async_wait_all();  // the stream's last copy, issued for no panel
  __syncthreads();
  float* sums = slot + kPassUnits * kUnitFloats;
  for (int i = tid; i < n_sums; i += kThreads) sums[i] = db_s[i];
}

// What a call runs: tile rows R, panel buffers a warpgroup, the shared
// memory, passes over the tiles and blocks per pass.
struct Plan {
  int R, nbuf, smem, passes, per_pass, n_tiles;
};

inline size_t smem_bytes(int H, int R, int nl, int C, bool gelu, int nbuf) {
  return (size_t)2 * nbuf * 128 * H + (size_t)(nl + 1) * 6 * H * R +
         (gelu ? (size_t)nl * 4 * H * R : 0) +
         4 * ((size_t)small_floats(H, R, nl, C) + nl * H + H * C + C + 1);
}

template <int H, int R>
cudaError_t allow_smem(int dev, int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sdec_bwd_x3_kernel<H, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int H, int R>
cudaError_t occupancy(int dev, int optin, int smem, int* per_sm) {
  cudaError_t err = allow_smem<H, R>(dev, optin);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, sdec_bwd_x3_kernel<H, R>, kThreads, smem);
}

// The largest tile (R = 64, 32 at H = 128; 32, 16 at H = 256) whose levels
// fit, with two panel buffers a warpgroup where they fit beside it.
cudaError_t make_plan(int B, int N, int H, int nl, int C, int act, Plan* p) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool gelu = act == ACT_GELU;
  p->R = 0;
  for (int R = H == 128 ? 64 : 32; R >= (H == 128 ? 32 : 16) && !p->R; R /= 2)
    for (int nbuf = 2; nbuf >= 1; --nbuf)
      if (smem_bytes(H, R, nl, C, gelu, nbuf) <= (size_t)optin) {
        p->R = R;
        p->nbuf = nbuf;
        p->smem = (int)smem_bytes(H, R, nl, C, gelu, nbuf);
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

// workspace: wb | wf (three bf16 limbs of each W_l, two layouts) | block
// slots | tile sums | sample sums
inline size_t workspace_floats(const Plan& p, int B, int H, int nl, int C) {
  return (size_t)3 * nl * H * H +
         (size_t)p.passes * p.per_pass * slot_floats(H, nl, C) +
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
  cudaError_t err = make_plan(a.B, a.N, a.H, a.n_layers, a.C, a.act, &p);
  if (err != cudaSuccess) return err;
  if (a.n_blocks != p.passes * p.per_pass) return cudaErrorInvalidValue;
  const int H = a.H, nl = a.n_layers;
  const size_t slot = slot_floats(H, nl, a.C);
  uint8_t* wb = reinterpret_cast<uint8_t*>(a.ws);
  uint8_t* wf = wb + (size_t)3 * nl * H * H * 2;
  float* blk_ws = a.ws + (size_t)3 * nl * H * H;
  float* tile_ws = blk_ws + (size_t)a.n_blocks * slot;
  float* duvw = tile_ws + (size_t)a.B * p.n_tiles * 3 * H;

  const int n_w = nl * H * H;
  sdec_x3_prep<<<(n_w + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.hw, wb, wf, H, nl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const KArgs k{a.grid, a.phi, a.dx, a.sc, a.z, a.wc, a.bc, a.wz, a.hb,
                a.wout, a.bout, a.g, a.x, a.wgt, wb, wf, blk_ws, tile_ws,
                a.B, a.N, a.D, a.L, nl, a.C, a.act, a.sigmoid_out, a.loss,
                p.nbuf, p.n_tiles, p.per_pass, (int)slot};
  if (H == 128) {
    if (p.R == 64)
      sdec_bwd_x3_kernel<128, 64><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
    else
      sdec_bwd_x3_kernel<128, 32><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
  } else {
    if (p.R == 32)
      sdec_bwd_x3_kernel<256, 32><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
    else
      sdec_bwd_x3_kernel<256, 16><<<a.n_blocks, kThreads, p.smem, a.stream>>>(k);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sums<true>(blk_ws, tile_ws, duvw, p.per_pass, (int)slot, p.n_tiles,
                     a.phi, a.dx, a.sc, a.z, a.wc, a.wz, a.out, a.B, a.D, a.L,
                     H, nl, a.C, a.loss, a.stream);
}

}  // namespace

// Workspace and grid of one call: *n_blocks blocks of the main kernel and
// *ws_floats floats of workspace. The same inputs on the same card give the
// same plan.
extern "C" int pvt_sdec_bwd_x3_plan(int B, int N, int D, int L, int H,
                                    int n_layers, int C, int act,
                                    int loss_mode, long long* ws_floats,
                                    int* n_blocks) {
  if (bad_dims(B, N, D, L, H, n_layers, C, act, loss_mode))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(B, N, H, n_layers, C, act, &p);
  if (err != cudaSuccess) return (int)err;
  *n_blocks = p.passes * p.per_pass;
  *ws_floats = (long long)workspace_floats(p, B, H, n_layers, C);
  return (int)cudaSuccess;
}

// Plain C entry point (bound with ctypes), arguments as pvt_sdec_bwd_tc in
// spatial_decoder_bwd_tc.cu: the forward's inputs, g [B, N, C] (K2) or x
// [B, N] and wgt [B] (K3, C = 1, loss_mode = 1), the flat output `out`, and
// a workspace of the size and block count that pvt_sdec_bwd_x3_plan gives.
// All float32, contiguous, on the device of `stream`. Returns a cudaError_t.
extern "C" int pvt_sdec_bwd_x3(const float* grid, const float* phi,
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

PVT_PHASE_READER(pvt_sdec_bwd_x3_phase_cycles)
