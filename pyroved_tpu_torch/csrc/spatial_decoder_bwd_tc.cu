// Fused spatial-decoder backward (K2) and one-pass Bernoulli train kernel
// (K3) on Hopper's tensor cores (sm_90a): bf16 operands, f32 accumulation.
//
// Replaces pyroved_tpu/ops/spatial_decoder.py::_bwd_kernel in both of its
// modes (K2 via _bwd, K3 via _train_call) under the JAX package's default
// BF16_MATMUL = True: the operands of the forward recompute h_l W_l (:601),
// of dwout = h_L^T dl (:647), of dW_l = h_l^T d_pre (:651) and of
// dh = d_pre W_l^T (:653) are rounded to bf16 and the products summed in f32.
// Heads, biases, activations, their derivatives and the coordinate layer
// stay in f32. spatial_decoder_bwd_x3.cu is the BF16_MATMUL = False
// version on this structure; one body serves K2 and K3.
//
// What bounds it: 6 n_layers H^2 flops per pixel on the tensor cores. At
// the flagship training step (B = 200, N = 784, H = 128, two layers) that
// is 0.032 ms at the bf16 peak, at the large grid (B = 64, N = 16384)
// 0.211 ms. The elementwise work (exact tanhf or erff per hidden value, the
// derivatives, the bf16 casts) runs on the CUDA cores beside it and is of
// the same order. On an H100 the kernel is bound by the latency of its
// epilogues and of the products' issue (PERF.md section 6).
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
//    At one channel (not gelu) the head dots are taken in the last forward
//    layer's epilogue from the h in registers, and the last layer's channel
//    loops run over that channel alone; the sums of dbout and the loss run
//    in the shadow of the first backward products, one warp each.
//  * The tile loop's serial parts off its critical path. The prep kernel
//    also folds each sample's transform (us, vs, wv), once a call; each tile's
//    inputs (that transform, its coordinates, its cotangents) are copied
//    into a double-buffered slot with cp.async a tile ahead, issued in the
//    shadow of the tile's first products, so no tile waits on a global
//    load. The two warpgroups hold the units of every layer alike (the
//    pass's units dealt in turn), so both issue each layer's dW products.
//  * One tile in flight. On the H100 a warp issuing a product stalls until
//    its wgmma instructions are taken, about the product's time, so a
//    second tile in flight (the tile's halves, one half's epilogue beside
//    the other's product) overlapped little and paid twice the handoffs:
//    measured slower (PERF.md section 6).
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
//    unit accumulators and R H / 256 product accumulators a thread, each
//    product's first k16 step writing its accumulator without reading it
//    (wgmma_init), so an idle accumulator holds no register.
//  * Ragged tiles: pixels past N get zero coordinates and a zero cotangent,
//    so they add nothing. Nothing is allocated here and nothing
//    synchronises with the host.

#include <atomic>
#include <map>
#include <mutex>
#include <utility>

#include "sm90_bwd.cuh"

namespace {

// Before the main kernel, in one launch: blocks [0, w_blocks) round hw
// [nl, H, H] f32 to two bf16 copies, tiled: wb[l] the whole matrix (rows =
// inputs, 16 H bytes per row of cores; its 64-row panels are contiguous)
// and wf[l][p] its 64-column panels (1 KB per row of cores), each
// contiguous; the blocks after them fold every sample's transform, once a
// call: tf [B][3][H] = us, vs, wv (the grid's rotation and scale folded
// into the first layer's weights, and its shift, latents and bias into one
// offset), kThreads / H samples a block, one thread a unit.
struct Prep {
  const float *hw, *phi, *sc, *dx, *z, *wc, *bc, *wz;
  uint8_t *wb, *wf;
  float* tf;
  int H, n_w, w_blocks, B, D, L;
};

__global__ void __launch_bounds__(kThreads) sdec_tc_prep(const Prep p) {
  const int H = p.H;
  if ((int)blockIdx.x < p.w_blocks) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= p.n_w) return;
    const int hh = H * H;
    const int l = i / hh, r = (i - l * hh) / H, c = i % H;
    const __nv_bfloat16 v = __float2bfloat16_rn(p.hw[i]);
    const size_t base = (size_t)l * hh * 2;
    *reinterpret_cast<__nv_bfloat16*>(p.wb + base + tiled(r, c, 16 * H)) = v;
    *reinterpret_cast<__nv_bfloat16*>(p.wf + base + (size_t)(c >> 6) * 128 * H +
                                      tiled(r, c & 63, 1024)) = v;
    return;
  }
  const int b = (blockIdx.x - p.w_blocks) * (kThreads / H) + threadIdx.x / H;
  const int h = threadIdx.x % H, D = p.D;
  if (b >= p.B) return;
  float cph = 1.0f, sph = 0.0f, scale = 1.0f;
  if (D == 2) {
    sincosf(p.phi[b], &sph, &cph);
    scale = p.sc[b];
  }
  float w = 0.0f;
  for (int d = 0; d < D; ++d) w += p.dx[b * D + d] * p.wc[d * H + h];
  w += p.bc[h];
  float wzl = 0.0f;
  for (int l = 0; l < p.L; ++l) wzl += p.z[(size_t)b * p.L + l] * p.wz[l * H + h];
  float* o = p.tf + (size_t)b * 3 * H;
  o[2 * H + h] = w + wzl;
  const float a0 = p.wc[h];
  if (D == 2) {
    const float a1 = p.wc[H + h];
    o[h] = scale * (cph * a0 + sph * a1);
    o[H + h] = scale * (-sph * a0 + cph * a1);
  } else {
    o[h] = a0;
    o[H + h] = 0.0f;
  }
}

struct KArgs {
  const float *grid, *phi, *dx, *sc, *z, *wc, *bc, *wz, *hb, *wout, *bout,
      *g, *x, *wgt;
  const uint8_t *wb, *wf;
  const float* tf;  // [B][3][H] us | vs | wv of each sample
  float *blk_ws, *tile_ws;
  int B, N, D, L, nl, C, act, sigmoid_out, loss, resident, n_tiles, per_pass,
      slot;
#ifdef PVT_ABLATE
  const float* hw;  // f32, for dma_floor's sum
  float* tile_s;    // a scalar a tile
  int b_t, n_t;     // the logical tiles
#endif
};

__host__ __device__ inline size_t weight_bytes(int H, int nl, bool resident) {
  return resident ? (size_t)nl * 2 * H * H : (size_t)2 * 128 * H;
}

// The profiled build's counters (-DPVT_PROFILE_PHASES,
// pyroved_tpu_torch/tools/profile_bwd_tc.py; sm90_common.cuh's phase marks):
// each warpgroup's in shared memory after the small buffers, flushed at the
// end.
#ifdef PVT_PROFILE_PHASES
constexpr int kProfFloats = 2 * 2 * kPhaseSlots + 2;  // and 8-byte alignment
#else
constexpr int kProfFloats = 0;
#endif

// Floats of one slot of a tile's staged cotangents: g [R][C], or x [R]
// and wgt.
__host__ __device__ constexpr int stage_floats(int R) {
  return (kMaxC * R + 1 + 3) / 4 * 4;
}

// floats of the small buffers after the derivatives: the transform,
// coordinates and cotangents (two slots each, staged), the head's
// buffers and the block sums (then the profiled build's counters)
inline int tc_small_floats(int H, int R, int nl, int C) {
  return 6 * H + 4 * R + 2 * stage_floats(R) + kMaxC * R + R +
         kWarps * R * C + nl * H + H * C + C + 1 + kProfFloats;
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
  // derivatives (after the mxu modes' operands in an ablation build)
  float* gv = reinterpret_cast<float*>(lv + (nl + 1) * LVL + abl_bytes(R));
  float* tr = gv + (nl + 1) * H * R;  // [2][3][H] us | vs | wv, by parity
  float* gs = tr + 6 * H;             // [2][R][2] coordinates, by parity
  float* stg = gs + 4 * R;            // [2][SS] cotangents, by parity
  constexpr int SS = stage_floats(R);
  float* dl = stg + 2 * SS;        // [R][kMaxC] head cotangents
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
#ifdef PVT_PROFILE_PHASES
  long long* prof = reinterpret_cast<long long*>(
      (reinterpret_cast<uintptr_t>(loss_s + 1) + 7) & ~uintptr_t(7));
  if (tid < 2 * kPhaseSlots) prof[tid] = 0;
#endif
  PHASE_CLOCK_AT(prof + wg * kPhaseSlots);
  // accumulator entry (slab s, value v) of this thread: unit row m, pixel n
  auto row_of = [&](int s, int hh) {
    return 64 * (wg * SPW + s) + 16 * wi + gq + 8 * hh;
  };
  auto dv = [&](int lvl, int s, int v) -> float& {
    return gv[((lvl * SPW + s) * NV + v) * kThreads + tid];
  };

  // this warpgroup's dW units in this pass: layer, 64-row and 128-col
  // block; the pass's units dealt to the warpgroups in turn, so that both
  // hold units of each layer and share its dW products
  int u_l[kUnits], u_r[kUnits], u_c[kUnits];
  float dw[kUnits][64];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int q = pass * kPassUnits + u * 2 + wg;
    const int r = q % UPL;
    u_l[u] = q < nl * UPL ? q / UPL : -1;
    u_r[u] = r / (H / 128);
    u_c[u] = r % (H / 128);
#pragma unroll
    for (int i = 0; i < 64; ++i) dw[u][i] = 0.0f;
  }
  for (int i = tid; i < n_sums; i += kThreads) db_s[i] = 0.0f;
  if (kAblate != ABL_DMA_FLOOR && a.resident) {
    const int bytes = nl * WL;
    for (int i = tid * 16; i < bytes; i += kThreads * 16)
      cp_async16(wsm + i, a.wb + i);
    cp_async_wait_all();
    fence_async_smem();
  }
#ifdef PVT_ABLATE
  // the mxu modes' second operand: dl (written a tile) or ones
  uint8_t* abl = lv + (nl + 1) * LVL;
  const uint32_t abl_addr = smem_addr(abl);
  if constexpr (kAblate == ABL_MXU_DHB || kAblate == ABL_MXU_DWOUT) {
    // ones; or zeros, whose first row (column 0 of the product) takes dl
    const float fill = kAblate == ABL_MXU_DHB ? 1.0f : 0.0f;
    for (int i = tid; i < abl_bytes(R) / 4; i += kThreads)
      *reinterpret_cast<__nv_bfloat162*>(abl + 4 * i) =
          __floats2bfloat162_rn(fill, fill);
    fence_async_smem();
  }
  float wsum = 0.0f;
  if constexpr (kAblate == ABL_DMA_FLOOR) wsum = weights_sum(a, H, gv);
  float hb_acc[SPW][4];  // mxu_dhb: db_l = d_pre_l^T ones on wgmma
#endif

  // -- a tile's inputs into slot `slot` with cp.async, issued a tile ahead:
  //    the sample's transform, the tile's coordinates (zero past N), its
  //    cotangent rows (zero past N) and the sample's weight
  auto stage = [&](int t, int slot) {
    const int b = t / a.n_tiles, n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);
    for (int i = tid; i < 3 * H / 4; i += kThreads)
      cp_async16(tr + slot * 3 * H + 4 * i, a.tf + (size_t)b * 3 * H + 4 * i);
    float* g2 = gs + slot * 2 * R;
    float* st = stg + slot * SS;
    for (int i = tid; i < 2 * R; i += kThreads) {
      const int n = i >> 1, d = i & 1;
      if (n < rows && d < a.D) cp_async4(g2 + i, a.grid + (size_t)(n0 + n) * a.D + d);
      else g2[i] = 0.0f;
    }
    const size_t q0 = (size_t)b * a.N + n0;
    if (a.loss) {
      for (int i = tid; i <= R; i += kThreads) {
        if (i == R) cp_async4(st + kMaxC * R, a.wgt + b);
        else if (i < rows) cp_async4(st + i, a.x + q0 + i);
        else st[i] = 0.0f;
      }
    } else {
      for (int i = tid; i < R * C; i += kThreads) {
        if (i < rows * C) cp_async4(st + i, a.g + q0 * C + i);
        else st[i] = 0.0f;
      }
    }
    cp_async_commit();
  };

  const int total = a.B * a.n_tiles;
  if constexpr (kAblate != ABL_DMA_FLOOR) {  // the block's first tile
    stage(stream, 0);
    cp_async_wait_all();
  }
  __syncthreads();

  float acc[SPW][NV];
  // -- forward product of layer l: pre^T = W_l^T level l
  auto fwd_issue = [&](int l) {
    const uint32_t hl = lv_addr + l * LVL;
#pragma unroll
    for (int s = 0; s < SPW; ++s) {
      const int slab = wg * SPW + s;
      uint32_t wa = w_addr + l * WL + slab * 8 * 128, wlbo = RSW;
      if (!a.resident) {
        load_panel(panel, a.wf + (size_t)l * WL + (size_t)slab * PANEL, PANEL,
                   wtid, wg);
        wa = panel_addr;
        wlbo = 1024;
      }
      wgmma_fence();
      wgmma_init<R, 1, 1>(acc[s], desc(wa, wlbo, 128), desc(hl, RSH, 128));
#pragma unroll
      for (int k = 1; k < H / 16; ++k)
        wgmma<R, 1, 1>(acc[s], desc(wa + k * 2 * wlbo, wlbo, 128),
                       desc(hl + k * 2 * RSH, RSH, 128), 1);
      if (!a.resident) {  // the panel is refilled for the next slab
        PHASE_TIMED(kMmaSlot, wgmma_commit_wait());
        fence_regs(acc[s]);
      }
    }
    if (a.resident) wgmma_commit();
  };
  // -- backward products of layer l: dW_l += h_l^T d_pre_l, dh^T = W_l
  //    d_pre_l^T
  auto bwd_issue = [&](int l) {
    const uint32_t hl = lv_addr + l * LVL, dp = lv_addr + (l + 1) * LVL;
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kUnits; ++u)  // dW units of layer l
      if (u_l[u] == l) {
#pragma unroll
        for (int k = 0; k < R / 16; ++k)
          wgmma<128, 0, 0>(dw[u], desc(hl + u_r[u] * 8 * RSH + k * 256, 128, RSH),
                           desc(dp + u_c[u] * 16 * RSH + k * 256, 128, RSH), 1);
      }
#ifdef PVT_ABLATE
    if (kAblate == ABL_MXU_DHB) {  // db_l = d_pre_l^T ones
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int k = 0; k < R / 16; ++k)
          wgmma_n8<0, 0>(hb_acc[s],
                         desc(dp + (wg * SPW + s) * 8 * RSH + k * 256, 128, RSH),
                         block8_desc<R>(abl_addr, k), k);
    }
#endif
#pragma unroll
    for (int s = 0; s < SPW; ++s) {
      const int slab = wg * SPW + s;
      uint32_t wa = w_addr + l * WL + slab * 8 * RSW;
      if (!a.resident) {
        PHASE_TIMED(kMmaSlot, wgmma_commit_wait());
        load_panel(panel, a.wb + (size_t)l * WL + (size_t)slab * PANEL, PANEL,
                   wtid, wg);
        wa = panel_addr;
        wgmma_fence();
      }
      wgmma_init<R, 0, 1>(acc[s], desc(wa, 128, RSW), desc(dp, RSH, 128));
#pragma unroll
      for (int k = 1; k < H / 16; ++k)
        wgmma<R, 0, 1>(acc[s], desc(wa + k * 256, 128, RSW),
                       desc(dp + k * 2 * RSH, RSH, 128), 1);
    }
    wgmma_commit();
  };
  auto wait_products = [&]() {
    PHASE_TIMED(kMmaSlot, wgmma_wait());
#pragma unroll
    for (int s = 0; s < SPW; ++s) fence_regs(acc[s]);
  };
  // a level written by the threads, complete and visible to wgmma
  auto handoff = [&]() {
    fence_async_smem();
    PHASE_TIMED(kBarSlot, __syncthreads());
  };

  int par = 0;  // the slot of this tile's transform and staged inputs
  for (int t = stream; t < total; t += a.per_pass, par ^= 1) {
    const int b = t / a.n_tiles;
    const int n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);
    const int tn = t + a.per_pass;  // the block's next tile

    PHASE_MARK(0);
#ifdef PVT_ABLATE
    if constexpr (kAblate == ABL_DMA_FLOOR) {
      dma_floor_tile<R>(a, t, b, n0, rows, pass, wsum);
      continue;
    }
#endif
    const float* trp = tr + par * 3 * H;   // us | vs | wv
    const float* gsp = gs + par * 2 * R;
    const float* stp = stg + par * SS;

    // -- h0 = tanh(gx u + gy v + w): level 0 and 1 - h0^2
    auto h0_pass = [&](auto pade) {
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        float u2[2], v2[2], w2[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = row_of(s, hh);
          u2[hh] = trp[m];
          v2[hh] = trp[H + m];
          w2[hh] = trp[2 * H + m];
        }
#pragma unroll
        for (int j = 0; j < R / 8; ++j) {
          const int n = 8 * j + 2 * tq;
          const float4 c2 = *reinterpret_cast<const float4*>(gsp + 2 * n);
          const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float h[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pre = gx[e] * u2[hh] + gy[e] * v2[hh] + w2[hh];
              if constexpr (kAblate == ABL_FWD_NOACT) h[e] = pre;
              else if constexpr (decltype(pade)::value) h[e] = pade_tanh(pre);
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
    PHASE_MARK(1);
    handoff();
    PHASE_TIMED(kIssueSlot, fwd_issue(0));
    // the next tile's inputs, in the shadow of the first products
    if (tn < total) stage(tn, par ^ 1);
    PHASE_MARK(2);

    // -- forward recompute: level l + 1 = act(W_l^T level l + b_l), and
    //    after the last layer the head dots sum_m h_L[m][n] wout[m][c]
    //    (each thread over its rows, then the 8 lanes that share a pixel;
    //    the warps are summed below), in the last layer's epilogue at one
    //    channel, not gelu
    const bool fused = !kFwdOnly && C == 1 && act != ACT_GELU;
    auto fwd_epilogue = [&](int l) {
      uint8_t* out = lv + (l + 1) * LVL;
      float bias[SPW][2];  // of this thread's rows
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) bias[s][hh] = a.hb[l * H + row_of(s, hh)];
      // level l + 1 in bf16; in f32 act'(pre), or for the last layer what
      // the head pass and the backward read: h (gelu: pre). `dots`: the
      // head dots of the last layer from the h in registers, in the order
      // of head_dots (one channel, not gelu)
      auto epilogue = [&](auto tag, auto last, auto dots) {
        constexpr int A = decltype(tag)::value;
        constexpr bool DOTS = decltype(dots)::value && A != ACT_GELU;
        float wo[SPW][2], part[R / 8][2] = {};
        if (DOTS) {
          for (int s = 0; s < SPW; ++s)
            for (int hh = 0; hh < 2; ++hh) wo[s][hh] = a.wout[row_of(s, hh)];
        }
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
                if (DOTS) part[j][e] += h[e] * wo[s][hh];
              }
              store_pair(out + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH), h[0],
                         h[1]);
            }
        if (DOTS) {
#pragma unroll
          for (int j = 0; j < R / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float p = part[j][e];
              p += __shfl_xor_sync(0xffffffffu, p, 4);
              p += __shfl_xor_sync(0xffffffffu, p, 8);
              p += __shfl_xor_sync(0xffffffffu, p, 16);
              if (gq == 0)
                headp[(wg * 4 + wi) * R + 8 * j + 2 * tq + e] = p;
            }
        }
      };
      with_act_k(act, [&](auto tag) {
        if (l < nl - 1) epilogue(tag, std::false_type{}, std::false_type{});
        else if (fused) epilogue(tag, std::true_type{}, std::true_type{});
        else epilogue(tag, std::true_type{}, std::false_type{});
      });
    };
    auto head_dots = [&]() {
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
    };
    for (int l = 0; l < nl; ++l) {
      wait_products();
      fwd_epilogue(l);
      if (l + 1 < nl) {
        handoff();
        PHASE_TIMED(kIssueSlot, fwd_issue(l + 1));
      }
    }
    if (!kFwdOnly && !fused) head_dots();
#ifdef PVT_ABLATE
    if constexpr (kFwdOnly) {  // h_L's sums: dwout's terms, the tile's scalar
      float tot = 0.0f;
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v = 0.0f;
#pragma unroll
          for (int j = 0; j < R / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) v += dv(nl, s, 4 * j + 2 * hh + e);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tq == 0) dwout_s[row_of(s, hh)] += v;
          tot += v;
        }
      warp_partial(tq == 0 ? tot : 0.0f, a.tile_s, t, pass);
      // the next tile's inputs landed, every product of this one done
      cp_async_wait_all();
      __syncthreads();
      continue;
    }
#endif

    PHASE_MARK(3);
    PHASE_TIMED(kBarSlot, __syncthreads());
    // -- head: logits, cotangents (staged), loss
    for (int i = tid; i < R * kMaxC; i += kThreads) {
      const int n = i / kMaxC, c = i - n * kMaxC;
      float d = 0.0f, lp = 0.0f;  // channels past C stay 0
      if (c < C && n < rows) {
        float p = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) p += headp[(w * R + n) * C + c];
        const float logit = p + a.bout[c];
        if (a.loss) {
          const float xv = stp[n], wm = stp[kMaxC * R];
          lp = -wm * (xv * logit - softplus(logit));
          d = wm * (sigmoid(logit) - xv);
        } else {
          const float gv_ = stp[n * C + c];
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
#ifdef PVT_ABLATE
      if constexpr (kAblate == ABL_MXU_DWOUT)  // column 0 of h_L^T dl's B
        if (c == 0)
          *reinterpret_cast<__nv_bfloat16*>(abl + tiled(0, n, 16 * R)) =
              __float2bfloat16_rn(d);
#endif
    }
    if constexpr (kAblate == ABL_MXU_DWOUT) fence_async_smem();
    PHASE_TIMED(kBarSlot, __syncthreads());
    // dbout and the loss, each sum (c == C: the loss) by one warp, the
    // warpgroups' first warps first; run once the first backward products
    // are issued, in their shadow
    auto head_sums = [&]() {
      for (int c = 0; c <= C; ++c) {
        if ((tid >> 5) != (c & 1) * 4 + (c >> 1)) continue;
        float s = 0.0f;
        for (int n = lane; n < R; n += 32)
          s += c < C ? dl[n * kMaxC + c] : lossp[n];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) {
          if (c < C) dbout_s[c] += s;
          else loss_s[0] += s;
        }
      }
    };

    PHASE_MARK(4);
#ifdef PVT_ABLATE
    if constexpr (kAblate == ABL_MXU_DWOUT) {
      // h_L^T dl on wgmma, dl in column 0 of an [8][R] operand (written
      // with dl); the tile's scalar is the sum over the units, its warps'
      // partials (dwout stays zero)
      float hd[SPW][4];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int k = 0; k < R / 16; ++k)
          wgmma_n8<0, 0>(hd[s],
                         desc(lv_addr + nl * LVL + (wg * SPW + s) * 8 * RSH +
                                  k * 256, 128, RSH),
                         block8_desc<R>(abl_addr, k), k);
      wgmma_commit_wait();
      float tot = 0.0f;
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        fence_regs(hd[s]);
        tot += hd[s][0] + hd[s][2];  // column 0 of rows gq and gq + 8
      }
      warp_partial(tq == 0 ? tot : 0.0f, a.tile_s, t, pass);
    }
#endif
    // the next tile's staged inputs: every thread's copies are visible
    // after the next barrier
    cp_async_wait_all();
    // -- last layer: dh = dl wout^T (f32), dwout += bf16(h_L)^T bf16(dl),
    //    d_pre = dh act'(pre) in place of h_L, db (the channels' loops over
    //    kMaxC, or over one at C = 1); then the first backward products
    auto last_layer = [&](auto tag, auto kc) {
      constexpr int A = decltype(tag)::value;
      constexpr int KC = decltype(kc)::value;
      uint8_t* top = lv + nl * LVL;
      float dbp[SPW][2] = {}, dwp[SPW][2][KC] = {}, wo[SPW][2][KC];
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int c = 0; c < KC; ++c)
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
              for (int c = 0; c < KC; ++c) {
                const float dlv = dl[(n + e) * kMaxC + c];
                dh += dlv * wo[s][hh][c];
                if constexpr (kAblate < 0)
                  dwp[s][hh][c] += hf[e] * bf16_round(dlv);
                else if constexpr (kAblate != ABL_MXU_DWOUT)
                  // f32 h_L and dl, as JAX's ablation kernel
                  dwp[s][hh][c] += dv(nl, s, 4 * j + 2 * hh + e) * dlv;
              }
              const float kept = dv(nl, s, 4 * j + 2 * hh + e);
              d[e] = dh * (A == ACT_GELU ? gelu_grad(kept)
                                         : grad_from_post<A>(kept));
              if constexpr (kAblate != ABL_MXU_DHB) dbp[s][hh] += d[e];
            }
            store_pair(top + tiled(m, n, RSH), d[0], d[1]);
          }
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = row_of(s, hh);
          if constexpr (kAblate != ABL_MXU_DHB) {
            float v = dbp[s][hh];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (tq == 0) db_s[(nl - 1) * H + m] += v;
          }
          if constexpr (kAblate == ABL_MXU_DWOUT) continue;
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            float w = dwp[s][hh][c];
            w += __shfl_xor_sync(0xffffffffu, w, 1);
            w += __shfl_xor_sync(0xffffffffu, w, 2);
            if (tq == 0 && c < C) dwout_s[m * C + c] += w;
          }
        }
    };
    with_act(act, [&](auto tag) {
      if (C == 1) last_layer(tag, std::integral_constant<int, 1>{});
      else last_layer(tag, std::integral_constant<int, kMaxC>{});
    });
    handoff();
    PHASE_TIMED(kIssueSlot, bwd_issue(nl - 1));
    head_sums();

    PHASE_MARK(5);
    // -- hidden layers, last to first: level l + 1 holds d_pre_l; d =
    //    dh act'(pre_l) is d_pre_{l-1} into level l (and db)
    for (int l = nl - 1; l > 0; --l) {
      wait_products();
#ifdef PVT_ABLATE
      if constexpr (kAblate == ABL_MXU_DHB)
#pragma unroll
        for (int s = 0; s < SPW; ++s) {
          fence_regs(hb_acc[s]);
          if (tq == 0) {
            db_s[l * H + row_of(s, 0)] += hb_acc[s][0];
            db_s[l * H + row_of(s, 1)] += hb_acc[s][2];
          }
        }
#endif
      PHASE_TIMED(kBarSlot, __syncthreads());  // both warpgroups are done
                                            // reading level l
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
              if constexpr (kAblate != ABL_MXU_DHB) sp[s][hh] += d[e];
            }
            store_pair(lv + l * LVL + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH),
                       d[0], d[1]);
          }
#pragma unroll
      for (int s = 0; s < SPW; ++s)  // db, before the products
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if constexpr (kAblate == ABL_MXU_DHB) continue;
          float v = sp[s][hh];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tq == 0) db_s[(l - 1) * H + row_of(s, hh)] += v;
        }
      handoff();
      PHASE_TIMED(kIssueSlot, bwd_issue(l - 1));
    }

    PHASE_MARK(6);
    // -- layer 0: d0 = dh act'(pre_0), summed into this tile's du, dv, dw
    //    (no_breduce: du and dv only on the tiles of a batch tile's first
    //    sample, the choice once a tile, outside the unrolled loops)
    wait_products();
#ifdef PVT_ABLATE
    if constexpr (kAblate == ABL_MXU_DHB)
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        fence_regs(hb_acc[s]);
        if (tq == 0) {
          db_s[row_of(s, 0)] += hb_acc[s][0];
          db_s[row_of(s, 1)] += hb_acc[s][2];
        }
      }
#endif
    auto l0 = [&](auto uv) {
      constexpr bool UV = decltype(uv)::value;
      float sp[SPW][2][3] = {};
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        const float4 c2 = *reinterpret_cast<const float4*>(gsp + 16 * j + 4 * tq);
        const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v = 4 * j + 2 * hh + e;
              const float d = acc[s][v] * dv(0, s, v);
              if constexpr (UV) {
                sp[s][hh][0] += gx[e] * d;
                sp[s][hh][1] += gy[e] * d;
              }
              sp[s][hh][2] += d;
            }
      }
      float* tw = a.tile_ws + (size_t)t * 3 * H;
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int k = UV ? 0 : 2; k < 3; ++k) {
            float v = sp[s][hh][k];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (tq == 0 && pass == 0) tw[k * H + row_of(s, hh)] = v;
          }
    };
#ifdef PVT_ABLATE
    if (kAblate == ABL_NO_BREDUCE && b % a.b_t != 0) l0(std::false_type{});
    else l0(std::true_type{});
#else
    l0(std::true_type{});
#endif
    PHASE_MARK(7);
    // every product of this tile done
    PHASE_TIMED(kBarSlot, __syncthreads());
  }

  // -- the block's slot: its dW units, then db, dwout, dbout, loss
  float* slot = a.blk_ws + (size_t)blockIdx.x * a.slot;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    if (u_l[u] < 0) continue;
    fence_regs(dw[u]);
    float* o = slot + (u * 2 + wg) * kUnitFloats;  // unit q's place
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
  PHASE_FLUSH;
}

#ifndef PVT_ABLATE
// -- H = 256: one tile, one cluster of kClusterBlocks blocks. Block k of a
//    cluster owns the units [64 k, 64 k + 64) of every level: it holds
//    W_l[:, its units] (the forward's panel of wf) and W_l[its units, :]
//    (dh's panel of wb) for every layer in shared memory (64 KB a layer,
//    up to two layers; deeper decoders copy each product's panel from L2),
//    computes its units' pre-activations, derivatives and dh^T rows over
//    the whole level, and writes its rows of each level and of each d_pre
//    into its own copy, where they are contiguous; one thread copies them
//    into every other block's copy (cp.async.bulk into distributed shared
//    memory), and each block waits on a transaction barrier of its own for
//    the other blocks' rows. Where a copy overwrites rows that another
//    block's products still read (d_pre_{l-1} over h_l; the next tile's
//    levels), the sender first waits for that block's arrival on one of
//    its barriers; only the sending thread waits. No cluster barrier and no
//    proxy fence a tile, where remote stores would need both, seven times
//    (what each costs: pyroved_tpu_torch/tools/cluster_sync.py). The two
//    warpgroups take half the tile's pixels each. The cluster's 16 dW units (kPassUnits a block, dealt so that
//    each warpgroup holds one unit of each of two layers) are a pass: one
//    pass at two layers, so each tile's forward and dh run once. The head's
//    dots are each block's partials over its units, exchanged and summed in
//    block order by every block; the loss and dbout are block 0's. Each
//    block's warpgroups keep their own db and dwout sums, and the tile's
//    du/dv/dw sums over their pixels, added in warpgroup order.
constexpr int kClusterBlocks = 4;
constexpr int kClusterR = 32;  // pixels a tile

// The cluster kernel's transaction barriers (8 bytes each): F + l, level
// l's rows from every block; kHead + parity, the head's partials; kTile,
// every block done with the last tile's products; kTile + l (l >= 1),
// every block's backward products of layer l done (level l free for
// d_pre_{l-1}).
constexpr int kHead = 6, kTile = 8, kBars = 16;

// floats after the derivatives: the transform of the block's units (two
// slots), coordinates, cotangents, the head's buffers, the blocks' head
// partials (two slots), the tile's du/dv/dw sums by warpgroup, the block
// sums and warpgroup 1's db and dwout, the barriers (8-byte aligned), then
// the profiled build's counters
inline int cl_small_floats(int nl, int C) {
  constexpr int H = 256, R = kClusterR, U = H / kClusterBlocks;
  return 6 * U + 4 * R + 2 * stage_floats(R) + kMaxC * R + R +
         kWarps * R * C + 2 * kClusterBlocks * R * C + 6 * U + nl * H +
         H * C + C + 1 + nl * H + H * C + 2 * kBars + 2 + kProfFloats;
}

inline size_t cl_smem_bytes(int nl, int C, bool resident) {
  constexpr int H = 256, R = kClusterR, U = H / kClusterBlocks;
  return (resident ? (size_t)nl * 2 * 128 * H : (size_t)128 * H) +
         (size_t)(nl + 1) * 2 * H * R + (size_t)(nl + 1) * 4 * U * R +
         4 * (size_t)cl_small_floats(nl, C);
}

__global__ void __launch_bounds__(kThreads, 1)
sdec_bwd_tc_cluster_kernel(const KArgs a) {
  constexpr int H = 256, CS = kClusterBlocks, U = H / CS, R = kClusterR;
  constexpr int NW = R / 2;       // pixels of a warpgroup
  constexpr int NV = NW / 2;      // accumulator floats a thread
  constexpr int RSH = 16 * R;     // row-of-cores stride of an [H, R] level
  constexpr int LVL = 2 * H * R;  // bytes of one bf16 level
  constexpr int RSW = 16 * H;     // row-of-cores stride of a dh panel
  constexpr int WL = 2 * H * H;   // bytes of one bf16 W_l
  constexpr int PANEL = 128 * H;  // bytes of a 64-unit panel of W_l
  constexpr int UPL = (H / 64) * (H / 128);  // dW units per layer
  const int nl = a.nl, C = a.C, act = a.act;
  const bool res = a.resident;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* wsm = smem;
  uint8_t* lv = wsm + (res ? (size_t)nl * 2 * PANEL : (size_t)PANEL);
  float* gv = reinterpret_cast<float*>(lv + (nl + 1) * LVL);  // derivatives
  float* tr = gv + (nl + 1) * NV * kThreads;  // [2][3][U] us | vs | wv
  float* gs = tr + 6 * U;             // [2][R][2] coordinates, by parity
  float* stg = gs + 4 * R;            // [2][SS] cotangents, by parity
  constexpr int SS = stage_floats(R);
  float* dl = stg + 2 * SS;          // [R][kMaxC] head cotangents
  float* lossp = dl + kMaxC * R;     // [R]
  float* headp = lossp + R;          // [kWarps][R][C] warps' partial dots
  float* hx = headp + kWarps * R * C;  // [2][CS][R][C] blocks' partials
  float* tsum = hx + 2 * CS * R * C;   // [2][3][U] the tile's sums by warpgroup
  float* db_s = tsum + 6 * U;          // [nl][H] db, [H][C] dwout, dbout, loss
  const int n_sums = nl * H + H * C + C + 1;
  float* db_s1 = db_s + n_sums;        // warpgroup 1's db and dwout
  const int n_wsums = nl * H + H * C;
  uint8_t* bar_p = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(db_s1 + n_wsums) + 7) & ~uintptr_t(7));
  const uint32_t bar = smem_addr(bar_p);

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int wi = wtid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int rank = cluster_rank();
  const int pass = blockIdx.x / a.per_pass;
  const int n_cl = a.per_pass / CS;
  const int cl = (blockIdx.x - pass * a.per_pass) / CS;
  const uint32_t w_addr = smem_addr(wsm), lv_addr = smem_addr(lv);
  const int n_base = NW * wg;  // this warpgroup's first pixel
  float* dbw = wg ? db_s1 : db_s;
#ifdef PVT_PROFILE_PHASES
  long long* prof = reinterpret_cast<long long*>(bar_p + 8 * kBars);
  if (tid < 2 * kPhaseSlots) prof[tid] = 0;
#endif
  PHASE_CLOCK_AT(prof + wg * kPhaseSlots);
  // accumulator entry v = 4 j + 2 hh + e of this thread: the block's unit
  // row m (of 64), pixel n_base + 8 j + 2 tq + e; its unit of the level
  auto row_of = [&](int hh) { return 16 * wi + gq + 8 * hh; };
  auto grow = [&](int hh) { return rank * U + row_of(hh); };
  auto dv = [&](int lvl, int v) -> float& {
    return gv[(lvl * NV + v) * kThreads + tid];
  };
  // a bf16 pair at (row of the level, pixel) of this block's level `lvl`
  auto store_lv = [&](int lvl, int row, int n, float x, float y) {
    store_pair(lv + lvl * LVL + tiled(row, n, RSH), x, y);
  };
  // Sends `bytes` at byte `off` of this block's shared memory (its part of
  // a buffer, written by its threads) to the same place in every other
  // block, completing on their barrier `b`, then waits here for the other
  // blocks' parts and arms `b` for its next use. The sending thread first
  // arrives on barrier `signal` of every other block and waits on its own
  // barrier `empty` (every other block done reading what the copies
  // overwrite); -1 for none. Before the block barrier, the sender's
  // earlier copies have read their sources.
  int phases = 0;  // parity of each barrier's current phase
  auto exchange = [&](uint32_t off, int bytes, int b, int signal,
                      int empty) {
    fence_async_smem();
    if (tid == 0) bulk_wait_read();
    PHASE_TIMED(kBarSlot, __syncthreads());
    if (tid == 0) {
      if (signal >= 0)
#pragma unroll
        for (int k = 1; k < CS; ++k)
          mbar_arrive_remote(map_rank(bar + 8 * signal, (rank + k) % CS));
      if (empty >= 0)
        PHASE_TIMED(kClusterSlot,
                    mbar_wait(bar + 8 * empty, (phases >> empty) & 1));
#pragma unroll
      for (int k = 1; k < CS; ++k) {
        const int r = (rank + k) % CS;
        bulk_to_rank(map_rank(smem_addr(smem) + off, r), smem_addr(smem) + off,
                     bytes, map_rank(bar + 8 * b, r));
      }
      bulk_commit();
    }
    if (empty >= 0) phases ^= 1 << empty;
    PHASE_TIMED(kClusterSlot, mbar_wait(bar + 8 * b, (phases >> b) & 1));
    phases ^= 1 << b;
    if (tid == 0) mbar_expect(bar + 8 * b, (CS - 1) * bytes);
  };
  // level l's rows from every block (kRows bytes a block, contiguous)
  constexpr int kRows = U / 8 * RSH;
  const uint32_t lv_off = (uint32_t)(lv - smem) + rank * kRows;
  auto level_full = [&](int l, int signal, int empty) {
    exchange(lv_off + l * LVL, kRows, l, signal, empty);
  };
  const int head_bytes = 4 * R * C;

  // this warpgroup's dW units in this pass (layer, 64-row and 128-col
  // block): unit j of the pass is slot position j / CS of block j % CS
  int u_l[kUnits], u_r[kUnits], u_c[kUnits];
  float dw[kUnits][64];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int q = pass * kPassUnits * CS + (u * 2 + wg) * CS + rank;
    const int r = q % UPL;
    u_l[u] = q < nl * UPL ? q / UPL : -1;
    u_r[u] = r / (H / 128);
    u_c[u] = r % (H / 128);
#pragma unroll
    for (int i = 0; i < 64; ++i) dw[u][i] = 0.0f;
  }
  for (int i = tid; i < n_sums + n_wsums; i += kThreads) db_s[i] = 0.0f;
  if (res) {  // the block's two panels of every layer
    for (int l = 0; l < nl; ++l)
      for (int i = tid * 16; i < PANEL; i += kThreads * 16) {
        cp_async16(wsm + 2 * l * PANEL + i,
                   a.wf + (size_t)l * WL + (size_t)rank * PANEL + i);
        cp_async16(wsm + (2 * l + 1) * PANEL + i,
                   a.wb + (size_t)l * WL + (size_t)rank * PANEL + i);
      }
    cp_async_wait_all();
    fence_async_smem();
  }

  // -- a tile's inputs into slot `slot` with cp.async, issued a tile ahead:
  //    the sample's transform of the block's units, the tile's coordinates
  //    (zero past N), its cotangent rows (zero past N) and the sample's
  //    weight
  auto stage = [&](int t, int slot) {
    const int b = t / a.n_tiles, n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);
    for (int i = tid; i < 3 * U / 4; i += kThreads) {
      const int k = i / (U / 4), q = i - k * (U / 4);
      cp_async16(tr + slot * 3 * U + 4 * i,
                 a.tf + (size_t)b * 3 * H + k * H + rank * U + 4 * q);
    }
    float* g2 = gs + slot * 2 * R;
    float* st = stg + slot * SS;
    for (int i = tid; i < 2 * R; i += kThreads) {
      const int n = i >> 1, d = i & 1;
      if (n < rows && d < a.D) cp_async4(g2 + i, a.grid + (size_t)(n0 + n) * a.D + d);
      else g2[i] = 0.0f;
    }
    const size_t q0 = (size_t)b * a.N + n0;
    if (a.loss) {
      for (int i = tid; i <= R; i += kThreads) {
        if (i == R) cp_async4(st + kMaxC * R, a.wgt + b);
        else if (i < rows) cp_async4(st + i, a.x + q0 + i);
        else st[i] = 0.0f;
      }
    } else {
      for (int i = tid; i < R * C; i += kThreads) {
        if (i < rows * C) cp_async4(st + i, a.g + q0 * C + i);
        else st[i] = 0.0f;
      }
    }
    cp_async_commit();
  };
  // one panel of the block's weights from L2 for both warpgroups (weights
  // not resident): no warp reads the slot while it is refilled
  auto load_slot = [&](const uint8_t* src) {
    PHASE_TIMED(kBarSlot, __syncthreads());
    for (int i = tid * 16; i < PANEL; i += kThreads * 16) cp_async16(wsm + i, src + i);
    cp_async_wait_all();
    fence_async_smem();
    PHASE_TIMED(kBarSlot, __syncthreads());
  };

  const int total = a.B * a.n_tiles;
  stage(cl, 0);
  cp_async_wait_all();
  if (tid == 0) {  // the barriers; the exchanges' armed for their first use
    for (int b = 0; b < kBars; ++b) mbar_init(bar + 8 * b, b < kTile ? 1 : CS - 1);
    fence_mbar_init();
    for (int l = 0; l <= nl; ++l) mbar_expect(bar + 8 * l, (CS - 1) * kRows);
    for (int p = 0; p < 2; ++p) mbar_expect(bar + 8 * (kHead + p), (CS - 1) * head_bytes);
  }
  __syncthreads();
  // every block of the cluster runs, its barriers armed, before any copy
  // or arrival reaches it
  cluster_arrive();
  cluster_wait();

  float acc[NV];
  // -- forward product of layer l: pre^T = W_l^T level l, the block's
  //    units, this warpgroup's pixels
  auto fwd_issue = [&](int l) {
    uint32_t wa = w_addr + 2 * l * PANEL;
    if (!res) {
      load_slot(a.wf + (size_t)l * WL + (size_t)rank * PANEL);
      wa = w_addr;
    }
    const uint32_t hl = lv_addr + l * LVL + n_base * 16;
    wgmma_fence();
    wgmma_init<NW, 1, 1>(acc, desc(wa, 1024, 128), desc(hl, RSH, 128));
#pragma unroll
    for (int k = 1; k < H / 16; ++k)
      wgmma<NW, 1, 1>(acc, desc(wa + k * 2048, 1024, 128),
                      desc(hl + k * 2 * RSH, RSH, 128), 1);
    wgmma_commit();
  };
  // -- backward products of layer l: dW_l += h_l^T d_pre_l (the units
  //    this warpgroup holds), dh^T = W_l d_pre_l^T (the block's rows)
  auto bwd_issue = [&](int l) {
    const uint32_t hl = lv_addr + l * LVL, dp = lv_addr + (l + 1) * LVL;
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
      if (u_l[u] == l) {
#pragma unroll
        for (int k = 0; k < R / 16; ++k)
          wgmma<128, 0, 0>(dw[u], desc(hl + u_r[u] * 8 * RSH + k * 256, 128, RSH),
                           desc(dp + u_c[u] * 16 * RSH + k * 256, 128, RSH), 1);
      }
    uint32_t wa = w_addr + (2 * l + 1) * PANEL;
    if (!res) {
      load_slot(a.wb + (size_t)l * WL + (size_t)rank * PANEL);
      wa = w_addr;
      wgmma_fence();
    }
    const uint32_t dpw = dp + n_base * 16;
    wgmma_init<NW, 0, 1>(acc, desc(wa, 128, RSW), desc(dpw, RSH, 128));
#pragma unroll
    for (int k = 1; k < H / 16; ++k)
      wgmma<NW, 0, 1>(acc, desc(wa + k * 256, 128, RSW),
                      desc(dpw + k * 2 * RSH, RSH, 128), 1);
    wgmma_commit();
  };
  auto wait_products = [&]() {
    PHASE_TIMED(kMmaSlot, wgmma_wait());
    fence_regs(acc);
  };

  int par = 0;  // the slot of this tile's transform, inputs and partials
  for (int t = cl; t < total; t += n_cl, par ^= 1) {
    const int b = t / a.n_tiles;
    const int n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);
    const int tn = t + n_cl;  // the cluster's next tile

    PHASE_MARK(0);
    const float* trp = tr + par * 3 * U;   // us | vs | wv
    const float* gsp = gs + par * 2 * R;
    const float* stp = stg + par * SS;

    // -- h0 = tanh(gx u + gy v + w): level 0 (in every block) and 1 - h0^2
    auto h0_pass = [&](auto pade) {
      float u2[2], v2[2], w2[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = row_of(hh);
        u2[hh] = trp[m];
        v2[hh] = trp[U + m];
        w2[hh] = trp[2 * U + m];
      }
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int n = n_base + 8 * j + 2 * tq;
        const float4 c2 = *reinterpret_cast<const float4*>(gsp + 2 * n);
        const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = 4 * j + 2 * hh + e;
            const float pre = gx[e] * u2[hh] + gy[e] * v2[hh] + w2[hh];
            float h;
            if constexpr (decltype(pade)::value) h = pade_tanh(pre);
            else h = tanhf(pre);
            dv(0, v) = 1.0f - h * h;
            acc[v] = h;
          }
      }
    };
    if (act == ACT_TANH_APPROX) h0_pass(std::true_type{});
    else h0_pass(std::false_type{});
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        store_lv(0, grow(hh), n_base + 8 * j + 2 * tq, acc[4 * j + 2 * hh],
                 acc[4 * j + 2 * hh + 1]);
    PHASE_MARK(1);
    // sent once every block is done with the last tile's products
    level_full(0, -1, t == cl ? -1 : kTile);
    PHASE_TIMED(kIssueSlot, fwd_issue(0));
    // the next tile's inputs, in the shadow of the first products
    if (tn < total) stage(tn, par ^ 1);
    PHASE_MARK(2);

    // -- forward recompute: level l + 1 = act(W_l^T level l + b_l) (the
    //    last level in this block only), and the head dots over the
    //    block's units in the last layer's epilogue at one channel, not gelu
    const bool fused = C == 1 && act != ACT_GELU;
    auto fwd_epilogue = [&](int l) {
      float bias[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) bias[hh] = a.hb[l * H + grow(hh)];
      auto epilogue = [&](auto tag, auto last, auto dots) {
        constexpr int A = decltype(tag)::value;
        constexpr bool LAST = decltype(last)::value;
        constexpr bool DOTS = decltype(dots)::value && A != ACT_GELU;
        float wo[2], part[NW / 8][2] = {};
        if (DOTS) {
          for (int hh = 0; hh < 2; ++hh) wo[hh] = a.wout[grow(hh)];
        }
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float h[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v = 4 * j + 2 * hh + e;
              const float pre = acc[v] + bias[hh];
              float g;
              act_and_grad<A>(pre, h[e], g);
              if constexpr (LAST) dv(l + 1, v) = A == ACT_GELU ? pre : h[e];
              else dv(l + 1, v) = g;
              if (DOTS) part[j][e] += h[e] * wo[hh];
            }
            store_lv(l + 1, grow(hh), n_base + 8 * j + 2 * tq, h[0], h[1]);
          }
        if (DOTS) {
#pragma unroll
          for (int j = 0; j < NW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float p = part[j][e];
              p += __shfl_xor_sync(0xffffffffu, p, 4);
              p += __shfl_xor_sync(0xffffffffu, p, 8);
              p += __shfl_xor_sync(0xffffffffu, p, 16);
              if (gq == 0)
                headp[(wg * 4 + wi) * R + n_base + 8 * j + 2 * tq + e] = p;
            }
        }
      };
      with_act(act, [&](auto tag) {
        if (l < nl - 1) epilogue(tag, std::false_type{}, std::false_type{});
        else if (fused) epilogue(tag, std::true_type{}, std::true_type{});
        else epilogue(tag, std::true_type{}, std::false_type{});
      });
    };
    auto head_dots = [&]() {
      with_act(act, [&](auto tag) {
        constexpr int A = decltype(tag)::value;
        for (int c = 0; c < C; ++c) {
          float wo[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) wo[hh] = a.wout[grow(hh) * C + c];
#pragma unroll
          for (int j = 0; j < NW / 8; ++j) {
            float part[2] = {0.0f, 0.0f};
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float h = dv(nl, 4 * j + 2 * hh + e);
                if constexpr (A == ACT_GELU) h = act_fn<A>(h);
                part[e] += h * wo[hh];
              }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float p = part[e];
              p += __shfl_xor_sync(0xffffffffu, p, 4);
              p += __shfl_xor_sync(0xffffffffu, p, 8);
              p += __shfl_xor_sync(0xffffffffu, p, 16);
              if (gq == 0)
                headp[((wg * 4 + wi) * R + n_base + 8 * j + 2 * tq + e) * C + c] = p;
            }
          }
        }
      });
    };
    for (int l = 0; l < nl; ++l) {
      wait_products();
      fwd_epilogue(l);
      if (l + 1 < nl) {
        level_full(l + 1, -1, -1);
        PHASE_TIMED(kIssueSlot, fwd_issue(l + 1));
      }
    }
    if (!fused) head_dots();

    PHASE_MARK(3);
    PHASE_TIMED(kBarSlot, __syncthreads());
    // -- head: the block's partial of each pixel (the 4 warps holding it,
    //    in order) into every block; then the logits from the blocks'
    //    partials in block order, cotangents (staged), loss
    float* mine = hx + (size_t)(par * CS + rank) * R * C;
    for (int i = tid; i < R * C; i += kThreads) {
      const int w0 = 4 * ((i / C) / NW);
      float p = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) p += headp[(w0 + w) * R * C + i];
      mine[i] = p;
    }
    exchange((uint32_t)(reinterpret_cast<uint8_t*>(mine) - smem), head_bytes,
             kHead + par, -1, -1);
    const float* px = hx + par * CS * R * C;
    for (int i = tid; i < R * kMaxC; i += kThreads) {
      const int n = i / kMaxC, c = i - n * kMaxC;
      float d = 0.0f, lp = 0.0f;  // channels past C stay 0
      if (c < C && n < rows) {
        float p = 0.0f;
#pragma unroll
        for (int k = 0; k < CS; ++k) p += px[(k * R + n) * C + c];
        const float logit = p + a.bout[c];
        if (a.loss) {
          const float xv = stp[n], wm = stp[kMaxC * R];
          lp = -wm * (xv * logit - softplus(logit));
          d = wm * (sigmoid(logit) - xv);
        } else {
          const float gv_ = stp[n * C + c];
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
    PHASE_TIMED(kBarSlot, __syncthreads());
    // dbout and the loss (block 0), each sum (c == C: the loss) by one
    // warp; run once the first backward products are issued
    auto head_sums = [&]() {
      if (rank != 0) return;
      for (int c = 0; c <= C; ++c) {
        if ((tid >> 5) != (c & 1) * 4 + (c >> 1)) continue;
        float s = 0.0f;
        for (int n = lane; n < R; n += 32)
          s += c < C ? dl[n * kMaxC + c] : lossp[n];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) db_s[nl * H + H * C + c] += s;
      }
    };

    PHASE_MARK(4);
    // the next tile's staged inputs: every thread's copies are visible
    // after the next barrier
    cp_async_wait_all();
    // -- last layer: dh = dl wout^T (f32), dwout += bf16(h_L)^T bf16(dl),
    //    d_pre = dh act'(pre) in place of h_L in every block, db (the
    //    channels' loops over kMaxC, or over one at C = 1); then the first
    //    backward products
    auto last_layer = [&](auto tag, auto kc) {
      constexpr int A = decltype(tag)::value;
      constexpr int KC = decltype(kc)::value;
      uint8_t* top = lv + nl * LVL;
      float dbp[2] = {}, dwp[2][KC] = {}, wo[2][KC];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          wo[hh][c] = c < C ? a.wout[grow(hh) * C + c] : 0.0f;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = grow(hh), n = n_base + 8 * j + 2 * tq;
          const float2 hv = load_pair(top + tiled(m, n, RSH));
          const float hf[2] = {hv.x, hv.y};
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float dh = 0.0f;  // channels past C add exact zeros
#pragma unroll
            for (int c = 0; c < KC; ++c) {
              const float dlv = dl[(n + e) * kMaxC + c];
              dh += dlv * wo[hh][c];
              dwp[hh][c] += hf[e] * bf16_round(dlv);
            }
            const float kept = dv(nl, 4 * j + 2 * hh + e);
            d[e] = dh * (A == ACT_GELU ? gelu_grad(kept)
                                       : grad_from_post<A>(kept));
            dbp[hh] += d[e];
          }
          store_lv(nl, m, n, d[0], d[1]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = grow(hh);
        float v = dbp[hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tq == 0) dbw[(nl - 1) * H + m] += v;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          float w = dwp[hh][c];
          w += __shfl_xor_sync(0xffffffffu, w, 1);
          w += __shfl_xor_sync(0xffffffffu, w, 2);
          if (tq == 0 && c < C) dbw[nl * H + m * C + c] += w;
        }
      }
    };
    with_act(act, [&](auto tag) {
      if (C == 1) last_layer(tag, std::integral_constant<int, 1>{});
      else last_layer(tag, std::integral_constant<int, kMaxC>{});
    });
    level_full(nl, -1, -1);
    PHASE_TIMED(kIssueSlot, bwd_issue(nl - 1));
    head_sums();

    PHASE_MARK(5);
    // -- hidden layers, last to first: level l + 1 holds d_pre_l; d =
    //    dh act'(pre_l) is d_pre_{l-1} into level l of every block (and db)
    for (int l = nl - 1; l > 0; --l) {
      wait_products();
      // both warpgroups are done reading level l (dW_l reads all its
      // pixels)
      PHASE_TIMED(kBarSlot, __syncthreads());
      float d[NV], sp[2] = {};
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        d[v] = acc[v] * dv(l, v);
        sp[(v >> 1) & 1] += d[v];
      }
      // this block's rows of level l take d_pre_{l-1}; its copies into the
      // other blocks wait for their arrivals (level_full's `empty`)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store_lv(l, grow(hh), n_base + 8 * j + 2 * tq, d[4 * j + 2 * hh],
                   d[4 * j + 2 * hh + 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // db, before the products
        float v = sp[hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tq == 0) dbw[(l - 1) * H + grow(hh)] += v;
      }
      level_full(l, kTile + l, kTile + l);
      PHASE_TIMED(kIssueSlot, bwd_issue(l - 1));
    }

    PHASE_MARK(6);
    // -- layer 0: d0 = dh act'(pre_0), summed into this tile's du, dv, dw
    //    (the warpgroups' sums over their pixels, added in order)
    wait_products();
    {
      float sp[2][3] = {};
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const float4 c2 = *reinterpret_cast<const float4*>(
            gsp + 2 * (n_base + 8 * j + 2 * tq));
        const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = 4 * j + 2 * hh + e;
            const float d = acc[v] * dv(0, v);
            sp[hh][0] += gx[e] * d;
            sp[hh][1] += gy[e] * d;
            sp[hh][2] += d;
          }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float v = sp[hh][k];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tq == 0) tsum[(wg * 3 + k) * U + row_of(hh)] = v;
        }
    }
    PHASE_TIMED(kBarSlot, __syncthreads());
    if (tid == 0)  // every product of this tile done in this block
#pragma unroll
      for (int k = 1; k < CS; ++k)
        mbar_arrive_remote(map_rank(bar + 8 * kTile, (rank + k) % CS));
    if (pass == 0)
      for (int i = tid; i < 3 * U; i += kThreads) {
        const int k = i / U, m = i - k * U;
        a.tile_ws[(size_t)t * 3 * H + k * H + rank * U + m] =
            tsum[i] + tsum[3 * U + i];
      }
    PHASE_MARK(7);
  }
  // no block leaves while another may still copy or arrive into it
  if (tid == 0) bulk_wait_read();
  cluster_arrive();
  cluster_wait();

  // -- the block's slot: its dW units, then db, dwout (the warpgroups'
  //    sums in order), dbout, loss
  float* slot = a.blk_ws + (size_t)blockIdx.x * a.slot;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    if (u_l[u] < 0) continue;
    fence_regs(dw[u]);
    float* o = slot + (u * 2 + wg) * kUnitFloats;
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
  for (int i = tid; i < n_sums; i += kThreads)
    sums[i] = i < n_wsums ? db_s[i] + db_s1[i] : db_s[i];
  PHASE_FLUSH;
}
#endif  // PVT_ABLATE

// What a call runs: tile rows R, whether the weights stay resident, the
// shared memory, passes over the tiles, blocks per pass and blocks a
// cluster (1: no cluster).
struct Plan {
  int R, resident, smem, passes, per_pass, n_tiles, cluster;
};

inline size_t smem_bytes(int H, int R, int nl, int C, bool resident) {
  return weight_bytes(H, nl, resident) + (size_t)(nl + 1) * 6 * H * R +
         abl_bytes(R) + 4 * (size_t)tc_small_floats(H, R, nl, C);
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

#ifndef PVT_ABLATE
// A cluster launch's configuration: kClusterBlocks blocks a cluster.
struct ClusterConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterConfig(int blocks, int smem, cudaStream_t stream) : cfg{}, attr{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kClusterBlocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The clusters of the H = 256 kernel that fit on device dev at once with
// `smem` bytes a block, queried once per device and size.
cudaError_t cluster_fit(int dev, int optin, int smem, int* clusters) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> fits;
  const auto key = std::make_pair(dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = fits.find(key);
  if (it != fits.end()) {
    *clusters = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      sdec_bwd_tc_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin);
  if (err != cudaSuccess) return err;
  ClusterConfig c(kClusterBlocks, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, sdec_bwd_tc_cluster_kernel,
                                       &c.cfg);
  if (err != cudaSuccess) return err;
  fits.emplace(key, *clusters);
  return cudaSuccess;
}

// The H = 256 plan: R = 32, the weights resident where they fit, 16 dW
// units a pass, as many clusters as fit on the card split over the passes.
cudaError_t make_cluster_plan(int B, int N, int nl, int C, int dev, int optin,
                              Plan* p) {
  p->R = kClusterR;
  p->cluster = kClusterBlocks;
  p->resident = cl_smem_bytes(nl, C, true) <= (size_t)optin;
  p->smem = (int)cl_smem_bytes(nl, C, p->resident);
  if ((size_t)p->smem > (size_t)optin) return cudaErrorInvalidValue;
  int clusters = 0;
  const cudaError_t err = cluster_fit(dev, optin, p->smem, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const int units = nl * 8;
  const int per = kPassUnits * kClusterBlocks;
  p->passes = (units + per - 1) / per;
  p->n_tiles = (N + p->R - 1) / p->R;
  const long long total = (long long)B * p->n_tiles;
  const long long fit = clusters / p->passes;
  p->per_pass = kClusterBlocks * (int)(fit < 1 ? 1 : fit < total ? fit : total);
  return cudaSuccess;
}
#endif

// The largest tile (R = 64, 32 at H = 128; 32, 16 at H = 256 in the
// ablation builds) whose activations fit, with the weights resident where
// they fit beside it; H = 256 runs in clusters (make_cluster_plan).
cudaError_t make_plan(int B, int N, int H, int nl, int C, Plan* p) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
#ifndef PVT_ABLATE
  if (H == 256) return make_cluster_plan(B, N, nl, C, dev, optin, p);
#endif
  p->cluster = 1;
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

// workspace: wb | wf (bf16 weights) | block slots | tile sums | sample sums
// | the samples' transforms
inline size_t workspace_floats(const Plan& p, int B, int H, int nl, int C) {
  return (size_t)nl * H * H + (size_t)p.passes * p.per_pass * slot_floats(H, nl, C) +
         (size_t)B * p.n_tiles * 3 * H + (size_t)B * 3 * H * 2;
}

struct Args {
  const float *grid, *phi, *dx, *sc, *z, *wc, *bc, *wz, *hw, *hb, *wout,
      *bout, *g, *x, *wgt;
  float *out, *ws;
  int B, N, D, L, H, n_layers, C, act, sigmoid_out, loss, n_blocks;
  cudaStream_t stream;
};

// the main kernel of the plan's tile
cudaError_t launch_main(const KArgs& k, const Plan& p, int H, int n_blocks,
                        cudaStream_t stream) {
#ifndef PVT_ABLATE
  if (p.cluster > 1) {
    ClusterConfig c(n_blocks, p.smem, stream);
    const cudaError_t err =
        cudaLaunchKernelEx(&c.cfg, sdec_bwd_tc_cluster_kernel, k);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
#endif
  if (H == 128) {
    if (p.R == 64)
      sdec_bwd_tc_kernel<128, 64><<<n_blocks, kThreads, p.smem, stream>>>(k);
    else
      sdec_bwd_tc_kernel<128, 32><<<n_blocks, kThreads, p.smem, stream>>>(k);
  } else {
    if (p.R == 32)
      sdec_bwd_tc_kernel<256, 32><<<n_blocks, kThreads, p.smem, stream>>>(k);
    else
      sdec_bwd_tc_kernel<256, 16><<<n_blocks, kThreads, p.smem, stream>>>(k);
  }
  return cudaGetLastError();
}

// before the main kernel (one launch): the bf16 weights and the samples'
// transforms
cudaError_t prep(const Args& a, uint8_t* wb, uint8_t* wf, float* tf) {
  const int n_w = a.n_layers * a.H * a.H;
  const int w_blocks = (n_w + kThreads - 1) / kThreads;
  const int spb = kThreads / a.H;  // samples a block
  const Prep p{a.hw, a.phi, a.sc, a.dx, a.z, a.wc, a.bc, a.wz, wb, wf, tf,
               a.H, n_w, w_blocks, a.B, a.D, a.L};
  sdec_tc_prep<<<w_blocks + (a.B + spb - 1) / spb, kThreads, 0, a.stream>>>(p);
  return cudaGetLastError();
}

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
  float* tf = duvw + (size_t)a.B * 3 * H;

  err = prep(a, wb, wf, tf);
  if (err != cudaSuccess) return err;
  const KArgs k{a.grid, a.phi, a.dx, a.sc, a.z, a.wc, a.bc, a.wz, a.hb,
                a.wout, a.bout, a.g, a.x, a.wgt, wb, wf, tf, blk_ws, tile_ws,
                a.B, a.N, a.D, a.L, nl, a.C, a.act, a.sigmoid_out, a.loss,
                p.resident, p.n_tiles, p.per_pass, (int)slot};
  err = launch_main(k, p, H, a.n_blocks, a.stream);
  if (err != cudaSuccess) return err;
#ifndef PVT_ABLATE
  if (p.cluster > 1)
    return launch_sums<false, kClusterBlocks>(
        blk_ws, tile_ws, duvw, p.per_pass, (int)slot, p.n_tiles, a.phi, a.dx,
        a.sc, a.z, a.wc, a.wz, a.out, a.B, a.D, a.L, H, nl, a.C, a.loss,
        a.stream);
#endif
  return launch_sums<false>(blk_ws, tile_ws, duvw, p.per_pass, (int)slot, p.n_tiles,
                     a.phi, a.dx, a.sc, a.z, a.wc, a.wz, a.out, a.B, a.D, a.L,
                     H, nl, a.C, a.loss, a.stream);
}

#ifdef PVT_ABLATE
// An ablation call: K2's plan and workspace, a scalar a tile after it;
// the prep kernel (not for dma_floor, which reads hw in f32 and no
// transform), the mode's main kernel and its reductions (sm90_bwd.cuh).
cudaError_t launch_ablate(const Args& a, int b_t, int n_t) {
  Plan p;
  cudaError_t err = make_plan(a.B, a.N, a.H, a.n_layers, 1, &p);
  if (err != cudaSuccess) return err;
  if (a.n_blocks != p.passes * p.per_pass || bad_tiles(a.B, a.N, b_t, n_t, p.R))
    return cudaErrorInvalidValue;
  const int H = a.H, nl = a.n_layers;
  const size_t slot = slot_floats(H, nl, 1);
  uint8_t* wb = reinterpret_cast<uint8_t*>(a.ws);
  uint8_t* wf = wb + (size_t)nl * H * H * 2;
  float* blk_ws = a.ws + (size_t)nl * H * H;
  float* tile_ws = blk_ws + (size_t)a.n_blocks * slot;
  float* duvw = tile_ws + (size_t)a.B * p.n_tiles * 3 * H;
  float* tf = duvw + (size_t)a.B * 3 * H;
  float* tile_s = tf + (size_t)a.B * 3 * H;
  float* raw = tile_s + (size_t)a.B * p.n_tiles * kWarps;
  if constexpr (kAblate != ABL_DMA_FLOOR) {
    err = prep(a, wb, wf, tf);
    if (err != cudaSuccess) return err;
  }
  const KArgs k{a.grid, a.phi, a.dx, a.sc, a.z, a.wc, a.bc, a.wz, a.hb,
                a.wout, a.bout, a.g, nullptr, nullptr, wb, wf, tf, blk_ws,
                tile_ws, a.B, a.N, 2, a.L, nl, 1, ACT_TANH, 1, 0, p.resident,
                p.n_tiles, p.per_pass, (int)slot, a.hw, tile_s, b_t, n_t};
  err = launch_main(k, p, H, a.n_blocks, a.stream);
  if (err != cudaSuccess) return err;
  return launch_abl_sums<false>(blk_ws, tile_ws, tile_s, raw, duvw, p.per_pass,
                                (int)slot, p.n_tiles, a.phi, a.dx, a.sc, a.z,
                                a.wc, a.wz, a.out, a.B, a.L, H, nl, b_t,
                                a.stream);
}
#endif

}  // namespace

// Workspace and grid of one call: *n_blocks blocks of the main kernel and
// *ws_floats floats of workspace. The same inputs on the same card give the
// same plan. With ws_floats null, n_blocks points to seven ints and
// receives the plan itself (for checks and tools): R, weights resident,
// shared memory bytes, passes, blocks per pass, tiles a sample, blocks a
// cluster.
extern "C" int pvt_sdec_bwd_tc_plan(int B, int N, int D, int L, int H,
                                    int n_layers, int C, int act,
                                    int loss_mode, long long* ws_floats,
                                    int* n_blocks) {
  if (bad_dims(B, N, D, L, H, n_layers, C, act, loss_mode))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(B, N, H, n_layers, C, &p);
  if (err != cudaSuccess) return (int)err;
  if (!ws_floats) {
    const int v[7] = {p.R, p.resident, p.smem, p.passes, p.per_pass,
                      p.n_tiles, p.cluster};
    for (int i = 0; i < 7; ++i) n_blocks[i] = v[i];
    return (int)cudaSuccess;
  }
  *n_blocks = p.passes * p.per_pass;
  *ws_floats = (long long)workspace_floats(p, B, H, n_layers, C);
  return (int)cudaSuccess;
}

// Plain C entry point (bound with ctypes): the forward's inputs, g [B, N, C] (K2) or x
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

#ifdef PVT_ABLATE
// The ablation build's plan (K4): as pvt_sdec_bwd_tc_plan at one channel,
// 2-D, tanh, and the kernel tile's pixels *rows, which must divide n_t.
extern "C" int pvt_sdec_abl_tc_plan(int B, int N, int L, int H, int n_layers,
                                    int b_t, int n_t, long long* ws_floats,
                                    int* n_blocks, int* rows) {
  if (bad_dims(B, N, 2, L, H, n_layers, 1, ACT_TANH, 0) ||
      bad_tiles(B, N, b_t, n_t, 0))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(B, N, H, n_layers, 1, &p);
  if (err != cudaSuccess) return (int)err;
  *n_blocks = p.passes * p.per_pass;
  *ws_floats = (long long)(workspace_floats(p, B, H, n_layers, 1) +
                           abl_workspace_floats(B, p.n_tiles, H));
  *rows = p.R;
  return (int)cudaSuccess;
}

// The ablation build's launch (K4 in the mode PVT_ABLATE names): K2's
// inputs at one channel (wout [H], bout [1], g [B, N]), the eleven outputs
// flat in `out` (as pvt_sdec_bwd_tc's), a workspace of the plan's size,
// b_t and n_t the logical tiles. Returns a cudaError_t.
extern "C" int pvt_sdec_abl_tc(const float* grid, const float* phi,
                               const float* dx, const float* sc,
                               const float* z, const float* wc,
                               const float* bc, const float* wz,
                               const float* hw, const float* hb,
                               const float* wout, const float* bout,
                               const float* g, float* out, float* ws, int B,
                               int N, int L, int H, int n_layers, int b_t,
                               int n_t, int n_blocks, void* stream) {
  if (bad_dims(B, N, 2, L, H, n_layers, 1, ACT_TANH, 0))
    return (int)cudaErrorInvalidValue;
  const Args a{grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, g,
               nullptr, nullptr, out, ws, B, N, 2, L, H, n_layers, 1,
               ACT_TANH, 1, 0, n_blocks, reinterpret_cast<cudaStream_t>(stream)};
  return (int)launch_ablate(a, b_t, n_t);
}
#endif

PVT_PHASE_READER(pvt_sdec_bwd_tc_phase_cycles)
