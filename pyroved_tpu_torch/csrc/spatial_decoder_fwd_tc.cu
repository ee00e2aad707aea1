// Fused coordinate-transform + spatial-decoder forward (K1) on Hopper's
// tensor cores (sm_90a): bf16 operands, f32 accumulation.
//
// Replaces pyroved_tpu/ops/spatial_decoder.py::_fwd_kernel under the JAX
// package's default BF16_MATMUL = True: the operands of every hidden product
// h_l W_l (:448, _mxu_dot) are rounded to bf16 and the products summed in
// f32. The folded transform, h0 = tanh (the Pade tanh for tanh_approx),
// biases, activations and the head stay in f32; h_l is rounded to bf16 only
// where it feeds a product, and the head reads the last layer's f32 values.
// spatial_decoder_fwd.cu is the BF16_MATMUL = False version and holds the
// formulas.
//
// What bounds it: not the tensor cores (2 n_layers H^2 flops a pixel, 0.054
// ms at the bf16 peak for the posed decode of 1024 latents) and not the
// bytes (4 C a pixel out), but the activations' f32 work: (n_layers + 1) H
// tanh values a pixel, each of which tanhf issues as MUFU.EX2 and MUFU.RCP
// on the special-function units (16 a clock an SM) among about a dozen
// other instructions. At two MUFU operations an activation the SFU alone
// takes 0.147 ms at that shape, and the first version of this kernel
// (tanhf, bias adds, a separate head pass) took 0.33 ms back to back.
//
// Design, around that bound:
//  * The tanh (sm90_common.cuh, tanh_exp2): tanh(x) = 1 - 2 / (2^a + 1)
//    with a = 2 log2(e) x, five instructions with its two MUFU operations,
//    within 2.4e-7 of f64 tanh over every f32 input. The scale 2 log2(e)
//    is folded into what makes a: into the per-sample vectors u, v, w (so
//    h0's argument is still two FMAs) and into the biases (a hidden
//    layer's argument is one FMA of its accumulator, which replaces the
//    bias add). Other activations keep act_fn after the bias add; h0 is
//    the new tanh for every activation but tanh_approx.
//  * Tensor cores. A tile is R pixels of one sample (64 at H = 128).
//    Pixels are the N side of each product and the hidden units
//    fill wgmma's M = 64: pre^T [H, R] = W_l^T h_l^T, both operands from
//    shared memory, W_l^T and h_l^T read MN-major, so nothing is
//    transposed. h_l^T is an [H, R] bf16 matrix of 8x8 core matrices (no
//    swizzle), written by the epilogue straight from the accumulator layout
//    as bf16 pairs, without bank conflicts, in place of h_{l-1}.
//  * One warpgroup, one tile. A block holds up to four warpgroups that
//    share the weights and nothing else: each runs its own tiles with its
//    own named barrier, so one warpgroup's epilogue overlaps another's
//    wgmma, and the four keep the SFU and the issue slots of every SM
//    quadrant busy. Every epilogue is unrolled over the thread's
//    accumulator entries with the activation a template argument, so it
//    holds no branch. Each layer's wgmma run from one fence to one wait
//    with no other instruction touching the accumulators in between, so
//    ptxas keeps them pipelined.
//  * The head at C = 1 (every main path): each activated f32 value of the
//    last layer is multiplied into the thread's head partials as it is
//    made, inside the SFU-bound epilogue; C > 1 takes a pass of its own.
//    Then over the 8 lanes that share a pixel by three halving exchanges
//    (each lane keeps half of the sums it holds and trades the other half),
//    then over the 4 warps in shared memory, all in f32 and in a fixed
//    order.
//  * One persistent launch. The grid is as many blocks as fit on the card
//    at once (at most one per warpgroups' worth of tiles); warpgroup g of W
//    takes the contiguous run [g T / W, (g + 1) T / W) of the flat (sample,
//    tile) list, so it computes the per-sample vectors u, v, w only when
//    the sample changes, and it loads the next tile's coordinates into
//    shared memory during the head. No prep kernel, no workspace, no
//    atomics: each output is one thread's fixed-order sum, and a second
//    launch on the same inputs is bitwise equal. The launch plan
//    (warpgroups, shared memory, blocks an SM) is worked out once per
//    device, width, activation, depth and channel count, so a call makes
//    no occupancy query.
//  * Weights rounded to bf16 once per block. At H = 128 each block rounds
//    every layer's weights into shared memory once, as 64-unit panels
//    (64 x H, MN-major): up to six layers fit beside a warpgroup, five
//    beside two.
//  * Ragged tiles: pixels past N get zero coordinates and are never stored.
//    The output is written as [B, N, C] ([B, N] when C = 1), coalesced.
//
// Budget, one block per SM, 128 registers a thread at most (512 threads):
//  * registers: the f32 accumulators of all H units for the tile, H R / 128
//    = 64 a thread;
//  * shared memory: every layer's weights, n_layers 2 H^2 bytes (64 KB at
//    the flagship), then per warpgroup a bf16 level 2 H R (16 KB), u, v, w
//    (3 H floats), the tile's coordinates (2 R) and head partials (4 R C),
//    plus the biases and head weights once per block: 142 KB with four
//    warpgroups at the flagship.
// Nothing is allocated here and nothing synchronises with the host.
//
// H = 256 (sdec_fwd_tc_cluster_kernel, below): a layer's weights are 128 KB
// in bf16, more than one block holds beside its tiles, so a cluster of CS
// blocks on neighbouring SMs runs each tile together. Block k of the
// cluster owns the units [k U, (k + 1) U), U = 256 / CS, of every layer and
// holds W_l[:, its units] for every layer in shared memory, rounded to bf16
// once per block (64 KB a layer at CS = 2, 32 at CS = 4). It computes
// pre^T for its units over the whole level and writes its rows of the next
// level into its own copy of the level, where they are contiguous; one
// thread copies them into every other block's copy (cp.async.bulk into
// distributed shared memory, the async proxy end to end), and each block
// waits on a transaction barrier of its own for the other blocks' rows: no
// cluster barrier and no proxy fence a layer (what each costs on the card:
// pyroved_tpu_torch/tools/cluster_sync.py). Two level buffers alternate, so a block's rows
// of level l + 1 reach another block only after that block sent its rows
// of level l, after its product read level l - 1. The head's dots are each
// block's partials over its units, exchanged the same way and summed in
// block order. Two warpgroups a block run one tile in step: at CS = 2 (up to two
// layers, R = 64) each takes a 64-unit slab of the block's 128 units, at
// CS = 4 (three to five layers, R = 32) both take the block's 64 units and
// half the pixels each. The grid is as many clusters as fit on the card
// (cudaOccupancyMaxActiveClusters, once per plan), each walking a
// contiguous run of the tile list, all of a cluster's blocks the same one.
//
// pvt_sdec_fwd_tc_tanh applies the kernel's tanh to a buffer: chip_smoke.py
// holds it to f64 tanh over every f32 input.

#include <atomic>
#include <climits>
#include <map>
#include <mutex>
#include <tuple>

// sm90_common.cuh also holds the phase marks of the tile loop
// (PVT_PROFILE_PHASES, pyroved_tpu_torch/tools/profile_fwd_tc.py).
#include "sm90_common.cuh"

namespace {

// Warpgroups a block holds at most; more share the weights and hide more
// latency, fewer leave each thread more registers (128 at four).
constexpr int kMaxWG = 4;
constexpr int kMaxThreads = 128 * kMaxWG;
constexpr int kMaxC = 4;
constexpr int kMaxDevices = 64;

// pixels a tile
__host__ __device__ constexpr int tile_rows(int H) { return 64; }

// Tile rows and the sizes that follow from them (H = 128).
template <int H>
struct Dims {
  static constexpr int R = tile_rows(H);
  static constexpr int SPW = H / 64;     // 64-unit slabs
  static constexpr int NV = R / 2;       // accumulator floats a slab
  static constexpr int NP = R / 4;       // head partials a channel
  static constexpr int RSH = 16 * R;     // row-of-cores stride, level
  static constexpr int PANEL = 128 * H;  // bytes of a 64-unit panel
};

// shared memory: [resident panels] [per warpgroup: level] [biases, head
// weights, bout] [per warpgroup: u, v, w, coordinates, head partials]
__host__ __device__ constexpr size_t weight_bytes(int H, int nl) {
  return (size_t)nl * 2 * H * H;
}

__host__ __device__ constexpr size_t wg_bf16_bytes(int H) {
  return (size_t)2 * H * tile_rows(H);
}

__host__ __device__ constexpr size_t block_floats(int H, int nl, int C) {
  return (size_t)nl * H + (size_t)H * C + kMaxC;
}

__host__ __device__ constexpr size_t wg_floats(int H, int C) {
  return (size_t)3 * H + 2 * tile_rows(H) + (size_t)4 * tile_rows(H) * C;
}

constexpr size_t smem_bytes(int H, int nl, int C, int wgs) {
  return weight_bytes(H, nl) + wgs * wg_bf16_bytes(H) +
         4 * (block_floats(H, nl, C) + wgs * wg_floats(H, C));
}

struct KArgs {
  const float *grid, *phi, *dx, *sc, *z, *wc, *bc, *wz, *hw, *hb, *wout,
      *bout;
  float* out;
  int B, N, D, L, nl, C, sigmoid_out, n_tiles;
};

// h0 from the coordinates and the sample's u, v, w, which hold
// 2 log2(e) times the folded vectors for the new tanh (A != tanh_approx).
template <int A>
__device__ __forceinline__ float h0_act(float gx, float gy, float u, float v,
                                        float w) {
  if constexpr (A == ACT_TANH_APPROX) return pade_tanh(gx * u + gy * v + w);
  else return tanh_exp2(fmaf(gx, u, fmaf(gy, v, w)));
}

// A hidden layer's activation from its accumulator and its bias
// bk: under tanh bk holds 2 log2(e) b, and one FMA makes the tanh's
// argument; other activations add the bias.
template <int A>
__device__ __forceinline__ float hidden_act(float acc, float bk) {
  if constexpr (A == ACT_TANH) return tanh_exp2(fmaf(acc, kTwoLog2e, bk));
  else return act_fn<A>(acc + bk);
}

// The scale of the biases and of u, v, w in shared memory: 2 log2(e)
// where the new tanh reads them.
template <int A>
__device__ constexpr float bias_scale() {
  return A == ACT_TANH ? kTwoLog2e : 1.0f;
}

template <int A>
__device__ constexpr float h0_scale() {
  return A == ACT_TANH_APPROX ? 1.0f : kTwoLog2e;
}

// Rounds n_panels 64-unit panels of hw [nl, H, H] (input-major) to bf16,
// panel p = l (H / 64) + slab holding W_l[:, 64 slab .. 64 slab + 63] as an
// [H inputs, 64 units] tiled matrix (1 KB a row of cores), panel
// first + k at dst + k PANEL. Warp w of nw takes chunks w, w + nw, ...: a
// chunk is 8 inputs x 16 units, one float4 a lane, and its two core-matrix
// rows of stores cover the 32 banks twice.
template <int H>
__device__ __forceinline__ void round_panels(uint8_t* dst,
                                             const float* __restrict__ hw,
                                             int first, int n_panels, int w,
                                             int nw, int lane) {
  constexpr int SPW = Dims<H>::SPW, PANEL = Dims<H>::PANEL;
  constexpr int CPP = H / 2;  // chunks a panel
  const int n = n_panels * CPP;
  const int r7 = lane & 7, c4 = 4 * (lane >> 3);
  constexpr int kBatch = 4;  // loads in flight a lane
  for (int q0 = w * kBatch; q0 < n; q0 += nw * kBatch) {
    float4 v[kBatch];
    uint32_t off[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int q = q0 + i;  // chunks of one warp's batch are contiguous
      if (q < n) {
        const int k = q / CPP, in = q - k * CPP;
        const int p = first + k;
        const int r = 8 * (in >> 2) + r7, c = 16 * (in & 3) + c4;
        v[i] = *reinterpret_cast<const float4*>(
            hw + ((size_t)(p / SPW) * H + r) * H + (p % SPW) * 64 + c);
        off[i] = k * PANEL + tiled(r, c, 1024);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (q0 + i < n) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v[i].x, v[i].y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v[i].z, v[i].w);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst + off[i]) = u;
      }
  }
}

// One halving exchange of the head's partial sums between the lanes that
// differ in lane bit `mask`: each keeps one half of p[0 .. K), adds the
// partner's copy of it, and holds the sums in p[0 .. K / 2).
template <int K>
__device__ __forceinline__ void fold_half(float* p, int mask, int lane) {
  const bool upper = lane & mask;
#pragma unroll
  for (int k = 0; k < K / 2; ++k) {
    const float send = upper ? p[k] : p[k + K / 2];
    const float keep = upper ? p[k + K / 2] : p[k];
    p[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Coordinates of a tile's R pixels into gs [R][2] (zero past N): one pixel
// a thread of the warpgroup.
template <int R>
__device__ __forceinline__ void load_coords(float* gs, const KArgs& a, int t,
                                            int wtid) {
  if (wtid < R) {
    const int b = t / a.n_tiles;
    const int n = (t - b * a.n_tiles) * R + wtid;
    float gx = 0.0f, gy = 0.0f;
    if (n < a.N) {
      gx = a.grid[(size_t)n * a.D];
      if (a.D == 2) gy = a.grid[(size_t)n * a.D + 1];
    }
    gs[2 * wtid] = gx;
    gs[2 * wtid + 1] = gy;
  }
}

template <int H, int A>
__global__ void __launch_bounds__(kMaxThreads, 1)
sdec_fwd_tc_kernel(const KArgs a) {
  static_assert(H == 128, "H = 256 runs sdec_fwd_tc_cluster_kernel");
  using S = Dims<H>;
  constexpr int R = S::R, SPW = S::SPW, NV = S::NV, NP = S::NP, RSH = S::RSH;
  constexpr int PANEL = S::PANEL;
  const int nl = a.nl, C = a.C;
  const int wgs = blockDim.x >> 7;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int wi = wtid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;

  uint8_t* wsm = smem;  // resident panels
  uint8_t* lv = smem + weight_bytes(H, nl) + wg * wg_bf16_bytes(H);  // [H, R] bf16 level
  float* hb_s = reinterpret_cast<float*>(smem + weight_bytes(H, nl) +
                                         wgs * wg_bf16_bytes(H));
  float* wout_s = hb_s + nl * H;
  float* bout_s = wout_s + H * C;
  float* us = bout_s + kMaxC + wg * wg_floats(H, C);
  float* vs = us + H;
  float* wv = vs + H;
  float* gs = wv + H;         // [R][2] the tile's coordinates
  float* headp = gs + 2 * R;  // [4 warps][R][C] head partial dots
  const uint32_t lv_addr = smem_addr(lv);
  // accumulator entry (slab s, value v) of this thread: unit m, pixel n
  auto row_of = [&](int s, int hh) { return 64 * s + 16 * wi + gq + 8 * hh; };
  // the head's partial dots p[2 j + e] of this thread's units for pixel
  // 8 j + 2 tq + e, channel c, summed over the 8 lanes that share a pixel
  // by three halving exchanges and stored for the sum over the 4 warps
  const int gr = ((gq & 1) << 2) | (gq & 2) | (gq >> 2);  // gq reversed
  auto fold_store = [&](float(&p)[NP], int c) {
    fold_half<NP>(p, 4, lane);
    fold_half<NP / 2>(p, 8, lane);
    fold_half<NP / 4>(p, 16, lane);
#pragma unroll
    for (int k = 0; k < NP / 8; ++k) {  // entry k + NP / 8 gr of p
      const int i = k + NP / 8 * gr;
      headp[(wi * R + 8 * (i >> 1) + 2 * tq + (i & 1)) * C + c] = p[k];
    }
  };

  // -- once per block: biases (scaled for tanh), head, resident weights in
  //    bf16
  for (int i = tid; i < nl * H; i += blockDim.x)
    hb_s[i] = bias_scale<A>() * a.hb[i];
  for (int i = tid; i < H * C; i += blockDim.x) wout_s[i] = a.wout[i];
  if (tid < kMaxC) bout_s[tid] = tid < C ? a.bout[tid] : 0.0f;
  round_panels<H>(wsm, a.hw, 0, nl * SPW, tid >> 5, blockDim.x >> 5, lane);
  fence_async_smem();
  __syncthreads();

  // this warpgroup's contiguous run of the flat (sample, tile) list
  const long long total = (long long)a.B * a.n_tiles;
  const long long W = (long long)gridDim.x * wgs;
  const long long g = (long long)blockIdx.x * wgs + wg;
  const int t_begin = (int)(g * total / W), t_end = (int)((g + 1) * total / W);
  if (t_begin >= t_end) return;
  load_coords<R>(gs, a, t_begin, wtid);
  wg_barrier(wg);

  int cur_b = -1;
  PHASE_CLOCK;
  for (int t = t_begin; t < t_end; ++t) {
    const int b = t / a.n_tiles;
    const int n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);

    PHASE_MARK(0);
    // -- per-sample folded transform, once per sample this warpgroup meets
    if (b != cur_b) {
      cur_b = b;
      float cph = 1.0f, sph = 0.0f, scale = 1.0f;
      if (a.D == 2) {
        sincosf(a.phi[b], &sph, &cph);
        scale = a.sc[b];
      }
      for (int h = wtid; h < H; h += 128) {
        float w = 0.0f;
        for (int d = 0; d < a.D; ++d) w += a.dx[b * a.D + d] * a.wc[d * H + h];
        w += a.bc[h];
        float wzl = 0.0f;
        for (int l = 0; l < a.L; ++l)
          wzl += a.z[(size_t)b * a.L + l] * a.wz[l * H + h];
        constexpr float k = h0_scale<A>();
        wv[h] = k * (w + wzl);
        const float a0 = a.wc[h];
        if (a.D == 2) {
          const float a1 = a.wc[H + h];
          us[h] = k * (scale * (cph * a0 + sph * a1));
          vs[h] = k * (scale * (-sph * a0 + cph * a1));
        } else {
          us[h] = k * a0;
          vs[h] = 0.0f;
        }
      }
      wg_barrier(wg);
    }

    PHASE_MARK(1);
    // -- h0 = tanh(gx u + gy v + w) in f32 registers; level 0 in bf16
    float acc[SPW][NV];
    {
      float u2[SPW][2], v2[SPW][2], w2[SPW][2];
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = row_of(s, hh);
          u2[s][hh] = us[m];
          v2[s][hh] = vs[m];
          w2[s][hh] = wv[m];
        }
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
              acc[s][v] = h0_act<A>(gx[e], gy[e], u2[s][hh], v2[s][hh],
                                    w2[s][hh]);
            }
      }
    }
    if (nl > 0) {
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int j = 0; j < R / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            store_pair(lv + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH),
                       acc[s][4 * j + 2 * hh], acc[s][4 * j + 2 * hh + 1]);
      fence_async_smem();
    }
    // the level is full; the coordinates and head partials are read
    wg_barrier(wg);

    PHASE_MARK(2);
    // -- hidden layers: pre^T = W_l^T h_l^T on the tensor cores (phase 3),
    //    then bias and activation (phase 4), at C = 1 with the head's dots
    //    in the last layer's
    for (int l = 0; l < nl; ++l) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < SPW; ++s) {
        const uint32_t wa = smem_addr(wsm + (l * SPW + s) * PANEL);
#pragma unroll
        for (int k = 0; k < H / 16; ++k)
          wgmma<R, 1, 1>(acc[s], desc(wa + k * 2048, 1024, 128),
                         desc(lv_addr + k * 2 * RSH, RSH, 128), k);
      }
      wgmma_commit_wait();
#pragma unroll
      for (int s = 0; s < SPW; ++s) fence_regs(acc[s]);
      if (l + 1 < nl) wg_barrier(wg);  // every warp is done reading the level
      PHASE_MARK(3);
      float bias[SPW][2];
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) bias[s][hh] = hb_s[l * H + row_of(s, hh)];
      if (l + 1 < nl) {  // h_{l+1} = act(pre) into the level, in bf16
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int j = 0; j < R / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int v = 4 * j + 2 * hh;
              store_pair(lv + tiled(row_of(s, hh), 8 * j + 2 * tq, RSH),
                         hidden_act<A>(acc[s][v], bias[s][hh]),
                         hidden_act<A>(acc[s][v + 1], bias[s][hh]));
            }
        fence_async_smem();
        wg_barrier(wg);
      } else if (C == 1) {  // h_L = act(pre) into the head's dots, in f32
        float wo[SPW][2], p[NP];
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) wo[s][hh] = wout_s[row_of(s, hh)];
#pragma unroll
        for (int i = 0; i < NP; ++i) p[i] = 0.0f;
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int j = 0; j < R / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int v = 4 * j + 2 * hh + e;
                p[2 * j + e] += hidden_act<A>(acc[s][v], bias[s][hh]) *
                                wo[s][hh];
              }
        fold_store(p, 0);
      } else {  // h_L = act(pre) stays in f32 for the head
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int v = 0; v < NV; ++v)
            acc[s][v] = hidden_act<A>(acc[s][v], bias[s][(v >> 1) & 1]);
      }
      PHASE_MARK(4);
    }

    // -- head dots sum_m h_L[m][n] wout[m][c] in f32 where the last
    //    epilogue did not make them (C > 1, or no hidden layer): each
    //    thread over its units, then fold_store; the next tile's
    //    coordinates meanwhile
    if (t + 1 < t_end) load_coords<R>(gs, a, t + 1, wtid);
    if (C > 1 || nl == 0) {
      for (int c = 0; c < C; ++c) {
        float wo[SPW][2], p[NP];
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            wo[s][hh] = wout_s[row_of(s, hh) * C + c];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          p[i] = 0.0f;
#pragma unroll
          for (int s = 0; s < SPW; ++s)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              p[i] += acc[s][4 * (i >> 1) + 2 * hh + (i & 1)] * wo[s][hh];
        }
        fold_store(p, c);
      }
    }
    wg_barrier(wg);

    PHASE_MARK(5);
    // -- logits (sigmoid), written out
    float* o = a.out + ((size_t)b * a.N + n0) * C;
    for (int i = wtid; i < rows * C; i += 128) {
      const int n = i / C, c = i - n * C;
      float p = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) p += headp[(w * R + n) * C + c];
      const float logit = p + bout_s[c];
      o[i] = a.sigmoid_out ? sigmoid(logit) : logit;
    }
    PHASE_MARK(6);
  }
}

// -- H = 256: one tile, one cluster of CS blocks (the note at the top)
template <int CS>
struct CDims {
  static constexpr int H = 256;
  static constexpr int U = H / CS;           // units a block
  static constexpr int R = CS == 2 ? 64 : 32;  // pixels a tile
  static constexpr int SLABS = U / 64;       // 64-unit slabs a block
  static constexpr int NW = R * SLABS / 2;   // pixels a warpgroup's product
  static constexpr int NV = NW / 2;          // accumulator floats a thread
  static constexpr int NP = NW / 4;          // head partials a channel
  static constexpr int RSH = 16 * R;         // row-of-cores stride, level
  static constexpr int LVL = 2 * H * R;      // bytes of a bf16 level
  static constexpr int PANEL = 128 * H;      // bytes of a 64-unit panel
};
constexpr int kClusterThreads = 256;  // two warpgroups a block

// shared memory of a cluster block: [panels: nl x SLABS] [two levels]
// [biases, head weights, bout] [u, v, w] [coordinates] [head partials:
// per warp, then per block and parity, from every block] [the four
// transaction barriers: the levels', the head's by parity]
constexpr size_t cluster_floats(int CS, int nl, int C) {
  const int U = 256 / CS, R = CS == 2 ? 64 : 32;
  return (size_t)nl * U + (size_t)U * C + kMaxC + 3 * U + 2 * R +
         (size_t)8 * R * C + (size_t)2 * CS * R * C + 8;
}

constexpr size_t cluster_smem_bytes(int CS, int nl, int C) {
  const int U = 256 / CS, R = CS == 2 ? 64 : 32;
  return (size_t)nl * 512 * U + (size_t)2 * 512 * R +
         4 * cluster_floats(CS, nl, C);
}

// Rounds W_l[:, col0 .. col0 + U) of hw [nl, 256, 256] for every layer to
// bf16, as round_panels does: panel p = l SLABS + slab at dst + p PANEL.
template <int CS>
__device__ __forceinline__ void round_slices(uint8_t* dst,
                                             const float* __restrict__ hw,
                                             int col0, int nl, int w, int nw,
                                             int lane) {
  using S = CDims<CS>;
  constexpr int H = S::H, SLABS = S::SLABS, PANEL = S::PANEL;
  constexpr int CPP = H / 2;  // chunks a panel
  const int n = nl * SLABS * CPP;
  const int r7 = lane & 7, c4 = 4 * (lane >> 3);
  constexpr int kBatch = 4;
  for (int q0 = w * kBatch; q0 < n; q0 += nw * kBatch) {
    float4 v[kBatch];
    uint32_t off[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int q = q0 + i;
      if (q < n) {
        const int k = q / CPP, in = q - k * CPP;
        const int r = 8 * (in >> 2) + r7, c = 16 * (in & 3) + c4;
        v[i] = *reinterpret_cast<const float4*>(
            hw + ((size_t)(k / SLABS) * H + r) * H + col0 + (k % SLABS) * 64 + c);
        off[i] = k * PANEL + tiled(r, c, 1024);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (q0 + i < n) {
        uint2 u;
        u.x = pack_pair(v[i].x, v[i].y);
        u.y = pack_pair(v[i].z, v[i].w);
        *reinterpret_cast<uint2*>(dst + off[i]) = u;
      }
  }
}

template <int CS, int A>
__global__ void __launch_bounds__(kClusterThreads, 1)
sdec_fwd_tc_cluster_kernel(const KArgs a) {
  using S = CDims<CS>;
  constexpr int H = S::H, U = S::U, R = S::R, SLABS = S::SLABS, NW = S::NW;
  constexpr int NV = S::NV, NP = S::NP, RSH = S::RSH, LVL = S::LVL;
  constexpr int PANEL = S::PANEL;
  const int nl = a.nl, C = a.C;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int wi = wtid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int rank = cluster_rank();
  PHASE_CLOCK;
  // this warpgroup's slab of the block's units and part of the pixels
  const int slab = SLABS == 2 ? wg : 0, n_base = SLABS == 2 ? 0 : NW * wg;

  uint8_t* wsm = smem;                                  // panels
  uint8_t* lv = smem + (size_t)nl * SLABS * PANEL;      // two [H, R] levels
  float* hb_s = reinterpret_cast<float*>(lv + 2 * LVL);  // [nl][U]
  float* wout_s = hb_s + nl * U;                        // [U][C]
  float* bout_s = wout_s + U * C;                       // [kMaxC]
  float* us = bout_s + kMaxC;                           // [U] each
  float* vs = us + U;
  float* wv = vs + U;
  float* gs = wv + U;            // [R][2] the tile's coordinates
  float* headp = gs + 2 * R;     // [8 warps][R][C] partial dots
  float* hx = headp + 8 * R * C;  // [2][CS][R][C] the blocks' partials
  // barriers: 0, 1 the level buffers', 2, 3 the head's slots'
  const uint32_t bar = smem_addr(hx + 2 * CS * R * C);
  const uint32_t lv_addr = smem_addr(lv);
  // bytes each block sends of a level (its rows) and of the head
  constexpr int kRows = U / 8 * RSH;
  const int head_bytes = 4 * R * C;
  // accumulator entry (v) of this thread: unit row m (of the block's),
  // pixel n_base + 8 j + 2 tq + e
  auto row_of = [&](int hh) { return 64 * slab + 16 * wi + gq + 8 * hh; };
  const int gr = ((gq & 1) << 2) | (gq & 2) | (gq >> 2);  // gq reversed
  // the warp's dots p[2 j + e] over its 16 units, summed over the 8 lanes
  // that share a pixel, into headp
  auto fold_store = [&](float(&p)[NP], int c) {
    float* hp = headp + (size_t)(wg * 4 + wi) * R * C;
    if constexpr (NP >= 8) {
      fold_half<NP>(p, 4, lane);
      fold_half<NP / 2>(p, 8, lane);
      fold_half<NP / 4>(p, 16, lane);
#pragma unroll
      for (int k = 0; k < NP / 8; ++k) {
        const int i = k + NP / 8 * gr;
        hp[(n_base + 8 * (i >> 1) + 2 * tq + (i & 1)) * C + c] = p[k];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        float v = p[i];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) hp[(n_base + 8 * (i >> 1) + 2 * tq + (i & 1)) * C + c] = v;
      }
    }
  };
  // a bf16 pair of level rows m (the block's) at pixels n, n + 1 into this
  // block's level buffer `buf`
  auto store_level = [&](int buf, int m, int n, float x, float y) {
    store_pair(lv + buf * LVL + tiled(rank * U + m, n, RSH), x, y);
  };
  // Sends `bytes` at byte `off` of this block's shared memory (its part of
  // a buffer, written by its threads) to the same place in every other
  // block, completing on their barrier `b`; then waits for the other
  // blocks' parts here and arms the barrier for its next use. Before the
  // block barrier, the sender's earlier copies have read their sources.
  int phases = 0;  // parity of each barrier's current phase
  auto exchange = [&](uint32_t off, int bytes, int b) {
    fence_async_smem();
    if (tid == 0) bulk_wait_read();
    PHASE_TIMED(kBarSlot, __syncthreads());
    if (tid == 0) {
#pragma unroll
      for (int k = 1; k < CS; ++k) {
        const int r = (rank + k) % CS;
        bulk_to_rank(map_rank(smem_addr(smem) + off, r), smem_addr(smem) + off,
                     bytes, map_rank(bar + 8 * b, r));
      }
      bulk_commit();
    }
    PHASE_TIMED(kClusterSlot, mbar_wait(bar + 8 * b, (phases >> b) & 1));
    phases ^= 1 << b;
    if (tid == 0) mbar_expect(bar + 8 * b, (CS - 1) * (b < 2 ? kRows : head_bytes));
  };
  // the level in buffer `buf` from every block's rows
  const uint32_t lv_off = (uint32_t)(lv - smem) + rank * kRows;
  auto level_full = [&](int buf) { exchange(lv_off + buf * LVL, kRows, buf); };

  // -- once per block: biases (scaled for tanh), head, this block's
  //    columns of every W_l in bf16
  for (int i = tid; i < nl * U; i += kClusterThreads) {
    const int l = i / U;
    hb_s[i] = bias_scale<A>() * a.hb[l * H + rank * U + (i - l * U)];
  }
  for (int i = tid; i < U * C; i += kClusterThreads)
    wout_s[i] = a.wout[rank * U * C + i];
  if (tid < kMaxC) bout_s[tid] = tid < C ? a.bout[tid] : 0.0f;
  round_slices<CS>(wsm, a.hw, rank * U, nl, tid >> 5, kClusterThreads >> 5,
                   lane);
  if (tid == 0) {  // the barriers, armed for their first use
    for (int b = 0; b < 4; ++b) mbar_init(bar + 8 * b, 1);
    fence_mbar_init();
    for (int b = 0; b < 4; ++b)
      mbar_expect(bar + 8 * b, (CS - 1) * (b < 2 ? kRows : head_bytes));
  }
  fence_async_smem();
  __syncthreads();
  // every block of the cluster runs, its barriers armed, before any copy
  // into it
  cluster_arrive();
  cluster_wait();

  // this cluster's contiguous run of the flat (sample, tile) list, so that
  // it folds a sample's transform once
  const long long total = (long long)a.B * a.n_tiles;
  const long long n_cl = gridDim.x / CS, cl = blockIdx.x / CS;
  const int t_begin = (int)(cl * total / n_cl);
  const int t_end = (int)((cl + 1) * total / n_cl);
  // this thread's coordinates of its cluster's next tile (thread n < R)
  float cx = 0.0f, cy = 0.0f;
  auto fetch = [&](int t) {
    cx = cy = 0.0f;
    if (tid < R && t < t_end) {
      const int b = t / a.n_tiles, n = (t - b * a.n_tiles) * R + tid;
      if (n < a.N) {
        cx = a.grid[(size_t)n * a.D];
        if (a.D == 2) cy = a.grid[(size_t)n * a.D + 1];
      }
    }
  };
  fetch(t_begin);
  int cur_b = -1, par = 0;
  for (int t = t_begin; t < t_end; ++t, par ^= 1) {
    const int b = t / a.n_tiles;
    const int n0 = (t - b * a.n_tiles) * R;
    const int rows = min(R, a.N - n0);

    PHASE_MARK(0);
    // -- per-sample folded transform of the block's units, the tile's
    //    coordinates (fetched a tile ahead)
    if (b != cur_b) {
      cur_b = b;
      float cph = 1.0f, sph = 0.0f, scale = 1.0f;
      if (a.D == 2) {
        sincosf(a.phi[b], &sph, &cph);
        scale = a.sc[b];
      }
      for (int m = tid; m < U; m += kClusterThreads) {
        const int h = rank * U + m;
        float w = 0.0f;
        for (int d = 0; d < a.D; ++d) w += a.dx[b * a.D + d] * a.wc[d * H + h];
        w += a.bc[h];
        float wzl = 0.0f;
        for (int l = 0; l < a.L; ++l)
          wzl += a.z[(size_t)b * a.L + l] * a.wz[l * H + h];
        constexpr float k = h0_scale<A>();
        wv[m] = k * (w + wzl);
        const float a0 = a.wc[h];
        if (a.D == 2) {
          const float a1 = a.wc[H + h];
          us[m] = k * (scale * (cph * a0 + sph * a1));
          vs[m] = k * (scale * (-sph * a0 + cph * a1));
        } else {
          us[m] = k * a0;
          vs[m] = 0.0f;
        }
      }
    }
    if (tid < R) {
      gs[2 * tid] = cx;
      gs[2 * tid + 1] = cy;
    }
    fetch(t + 1);
    __syncthreads();

    PHASE_MARK(1);
    // -- h0 = tanh(gx u + gy v + w) in f32 registers; level 0 in bf16, in
    //    every block
    float acc[NV];
    {
      float u2[2], v2[2], w2[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = row_of(hh);
        u2[hh] = us[m];
        v2[hh] = vs[m];
        w2[hh] = wv[m];
      }
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const float4 c2 = *reinterpret_cast<const float4*>(
            gs + 2 * (n_base + 8 * j + 2 * tq));
        const float gx[2] = {c2.x, c2.z}, gy[2] = {c2.y, c2.w};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[4 * j + 2 * hh + e] =
                h0_act<A>(gx[e], gy[e], u2[hh], v2[hh], w2[hh]);
      }
    }
    if (nl > 0) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store_level(0, row_of(hh), n_base + 8 * j + 2 * tq,
                      acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      level_full(0);
    }

    PHASE_MARK(2);
    // -- hidden layers: pre^T = W_l^T h_l^T for the block's units on the
    //    tensor cores (phase 3), then bias and activation (phase 4), the
    //    next level into every block, at C = 1 the head's dots in the last
    for (int l = 0; l < nl; ++l) {
      const uint32_t wa = smem_addr(wsm + (l * SLABS + slab) * PANEL);
      const uint32_t hl = lv_addr + (l & 1) * LVL + n_base * 16;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < H / 16; ++k)
        wgmma<NW, 1, 1>(acc, desc(wa + k * 2048, 1024, 128),
                        desc(hl + k * 2 * RSH, RSH, 128), k);
      wgmma_commit_wait();
      fence_regs(acc);
      PHASE_MARK(3);
      float bias[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) bias[hh] = hb_s[l * U + row_of(hh)];
      if (l + 1 < nl) {  // h_{l+1} = act(pre) into the other level, in bf16
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int v = 4 * j + 2 * hh;
            store_level((l + 1) & 1, row_of(hh), n_base + 8 * j + 2 * tq,
                        hidden_act<A>(acc[v], bias[hh]),
                        hidden_act<A>(acc[v + 1], bias[hh]));
          }
        level_full((l + 1) & 1);
      } else if (C == 1) {  // h_L = act(pre) into the head's dots, in f32
        float wo[2], p[NP];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) wo[hh] = wout_s[row_of(hh)];
#pragma unroll
        for (int i = 0; i < NP; ++i) p[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              p[2 * j + e] += hidden_act<A>(acc[4 * j + 2 * hh + e], bias[hh]) *
                              wo[hh];
        fold_store(p, 0);
      } else {  // h_L = act(pre) stays in f32 for the head
#pragma unroll
        for (int v = 0; v < NV; ++v)
          acc[v] = hidden_act<A>(acc[v], bias[(v >> 1) & 1]);
      }
      PHASE_MARK(4);
    }

    // -- head: the warps' dots where the last epilogue did not make them
    //    (C > 1, or no hidden layer); the block's partial of each pixel
    //    (its warps in order) into every block; after the barrier each
    //    block sums the blocks' partials in block order
    if (C > 1 || nl == 0) {
      for (int c = 0; c < C; ++c) {
        float wo[2], p[NP];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) wo[hh] = wout_s[row_of(hh) * C + c];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          p[i] = 0.0f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            p[i] += acc[4 * (i >> 1) + 2 * hh + (i & 1)] * wo[hh];
        }
        fold_store(p, c);
      }
    }
    __syncthreads();
    float* mine = hx + (size_t)(par * CS + rank) * R * C;
    for (int i = tid; i < R * C; i += kClusterThreads) {
      const int n = i / C;
      const int w0 = SLABS == 2 ? 0 : 4 * (n / NW);  // warps holding n
      float p = 0.0f;
#pragma unroll
      for (int w = 0; w < (SLABS == 2 ? 8 : 4); ++w) p += headp[(w0 + w) * R * C + i];
      mine[i] = p;
    }
    exchange((uint32_t)(reinterpret_cast<uint8_t*>(mine) - smem), head_bytes,
             2 + par);

    PHASE_MARK(5);
    // -- logits (sigmoid) of the block's share of the pixels, written out
    {
      const int share = R / CS, first = rank * share;
      const int cnt = max(0, min(share, rows - first));
      float* o = a.out + ((size_t)b * a.N + n0 + first) * C;
      const float* px = hx + (size_t)par * CS * R * C;
      for (int i = tid; i < cnt * C; i += kClusterThreads) {
        const int n = first + i / C, c = i % C;
        float p = 0.0f;
#pragma unroll
        for (int k = 0; k < CS; ++k) p += px[(k * R + n) * C + c];
        const float logit = p + bout_s[c];
        o[i] = a.sigmoid_out ? sigmoid(logit) : logit;
      }
    }
    PHASE_MARK(6);
  }
  // no block leaves while another may still copy into it
  if (tid == 0) bulk_wait_read();
  cluster_arrive();
  cluster_wait();
}

// The kernel's tanh applied to x[0 .. n): a = 2 log2(e) x, then tanh_exp2.
__global__ void tanh_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = tanh_exp2(x[i] * kTwoLog2e);
}

// Opt every instance into the device's largest dynamic shared memory once
// per device: the attribute stays set, and each launch asks for less.
template <int H, int A>
cudaError_t allow_smem(int dev, int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sdec_fwd_tc_kernel<H, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

// The card's shared memory a block can opt into and its SM count, read
// once per device (the current one where *dev < 0).
cudaError_t device_limits(int* dev, int* optin, int* sms) {
  static std::atomic<int> cached[kMaxDevices][2];
  cudaError_t err = *dev < 0 ? cudaGetDevice(dev) : cudaSuccess;
  if (err != cudaSuccess) return err;
  const bool known = *dev >= 0 && *dev < kMaxDevices;
  if (known && cached[*dev][1].load(std::memory_order_acquire) > 0) {
    *optin = cached[*dev][0].load(std::memory_order_relaxed);
    *sms = cached[*dev][1].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err != cudaSuccess) return err;
  if (known) {
    cached[*dev][0].store(*optin, std::memory_order_relaxed);
    cached[*dev][1].store(*sms, std::memory_order_release);
  }
  return cudaSuccess;
}

// A launch's plan: warpgroups a block (the cluster kernel: blocks a
// cluster), its shared memory, and how many blocks (clusters) fit on the
// card at once.
struct Plan {
  int wgs, smem, resident;
};

// The plan of instance <H, A> for nl layers and C channels on device dev,
// worked out on the first call with them (the occupancy query) and kept.
template <int H, int A>
cudaError_t launch_plan(int dev, int nl, int C, Plan* plan) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Plan> plans;
  const auto key = std::make_tuple(dev, nl, C);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = plans.find(key);
    if (it != plans.end()) {
      *plan = it->second;
      return cudaSuccess;
    }
  }
  int optin = 0, sms = 0;
  cudaError_t err = device_limits(&dev, &optin, &sms);
  if (err != cudaSuccess) return err;
  // as many warpgroups as fit, up to kMaxWG
  int wgs = 0;
  while (wgs < kMaxWG && smem_bytes(H, nl, C, wgs + 1) <= (size_t)optin) ++wgs;
  if (!wgs) return cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(H, nl, C, wgs);
  err = allow_smem<H, A>(dev, optin);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sdec_fwd_tc_kernel<H, A>, 128 * wgs, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *plan = Plan{wgs, smem, per_sm * sms};
  std::lock_guard<std::mutex> lock(mu);
  plans.emplace(key, *plan);
  return cudaSuccess;
}

// -- H = 256: the cluster kernel's plan and launch

// A cluster launch's configuration: CS blocks a cluster along x.
struct ClusterConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterConfig(int cs, int blocks, int smem, cudaStream_t stream) : cfg{}, attr{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The cluster size that holds nl layers' weights with C channels (2, else
// 4), or 0.
int cluster_blocks(int nl, int C, int optin) {
  for (int cs = 2; cs <= 4; cs *= 2)
    if (cluster_smem_bytes(cs, nl, C) <= (size_t)optin) return cs;
  return 0;
}

template <int CS, int A>
cudaError_t cluster_occupancy(int dev, int optin, int smem, int* clusters) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (!(known && done[dev].load(std::memory_order_acquire))) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdec_fwd_tc_cluster_kernel<CS, A>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    if (known) done[dev].store(true, std::memory_order_release);
  }
  ClusterConfig c(CS, CS, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters,
                                        sdec_fwd_tc_cluster_kernel<CS, A>,
                                        &c.cfg);
}

// The plan of the cluster kernel <CS, A> for nl layers and C channels on
// device dev (wgs holds CS, resident the clusters that fit at once), worked
// out on the first call with them and kept.
template <int A>
cudaError_t cluster_plan(int dev, int nl, int C, Plan* plan) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Plan> plans;
  const auto key = std::make_tuple(dev, nl, C);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = plans.find(key);
    if (it != plans.end()) {
      *plan = it->second;
      return cudaSuccess;
    }
  }
  int optin = 0, sms = 0;
  cudaError_t err = device_limits(&dev, &optin, &sms);
  if (err != cudaSuccess) return err;
  const int cs = cluster_blocks(nl, C, optin);
  if (!cs) return cudaErrorInvalidValue;
  const int smem = (int)cluster_smem_bytes(cs, nl, C);
  int clusters = 0;
  err = cs == 2 ? cluster_occupancy<2, A>(dev, optin, smem, &clusters)
                : cluster_occupancy<4, A>(dev, optin, smem, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  *plan = Plan{cs, smem, clusters};
  std::lock_guard<std::mutex> lock(mu);
  plans.emplace(key, *plan);
  return cudaSuccess;
}

template <int A>
cudaError_t launch_cluster(const KArgs& k0, int nl, int C,
                           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Plan plan;
  err = cluster_plan<A>(dev, nl, C, &plan);
  if (err != cudaSuccess) return err;
  const int cs = plan.wgs, R = cs == 2 ? 64 : 32;
  KArgs k = k0;
  k.n_tiles = (k.N + R - 1) / R;
  const long long total = (long long)k.B * k.n_tiles;
  const int clusters = (int)(total < plan.resident ? total : plan.resident);
  ClusterConfig c(cs, clusters * cs, plan.smem, stream);
  err = cs == 2 ? cudaLaunchKernelEx(&c.cfg, sdec_fwd_tc_cluster_kernel<2, A>, k)
                : cudaLaunchKernelEx(&c.cfg, sdec_fwd_tc_cluster_kernel<4, A>, k);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int H, int A>
cudaError_t launch(const float* grid, const float* phi, const float* dx,
                   const float* sc, const float* z, const float* wc,
                   const float* bc, const float* wz, const float* hw,
                   const float* hb, const float* wout, const float* bout,
                   float* out, int B, int N, int D, int L, int nl, int C,
                   int sigmoid_out, cudaStream_t stream) {
  if constexpr (H == 256) {
    const KArgs k{grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, out,
                  B, N, D, L, nl, C, sigmoid_out, 0};
    return launch_cluster<A>(k, nl, C, stream);
  } else {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    Plan plan;
    err = launch_plan<H, A>(dev, nl, C, &plan);
    if (err != cudaSuccess) return err;
    const int wgs = plan.wgs, smem = plan.smem;
    const int R = tile_rows(H);
    const int n_tiles = (N + R - 1) / R;
    const long long total = (long long)B * n_tiles;
    const long long want = (total + wgs - 1) / wgs;
    const int blocks = (int)(want < plan.resident ? want : plan.resident);
    const KArgs k{grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, out,
                  B, N, D, L, nl, C, sigmoid_out, n_tiles};
    sdec_fwd_tc_kernel<H, A><<<blocks, 128 * wgs, smem, stream>>>(k);
    return cudaGetLastError();
  }
}

template <int H>
cudaError_t launch_act(int act, const float* grid, const float* phi,
                       const float* dx, const float* sc, const float* z,
                       const float* wc, const float* bc, const float* wz,
                       const float* hw, const float* hb, const float* wout,
                       const float* bout, float* out, int B, int N, int D,
                       int L, int nl, int C, int sigmoid_out,
                       cudaStream_t stream) {
#define PVT_LAUNCH(A)                                                        \
  return launch<H, A>(grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, \
                      out, B, N, D, L, nl, C, sigmoid_out, stream)
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

// Plain C entry point (bound with ctypes), with pvt_sdec_fwd's arguments
// (spatial_decoder_fwd.cu): grid [N, D], phi/sc [B], dx [B, D], z [B, L],
// wc [D, H], bc [H], wz [L, H], hw [n_layers, H, H] (input-major, 16-byte
// aligned), hb [n_layers, H], wout [H, C], bout [C], out [B, N, C]; all
// float32, contiguous, on the device of `stream`. H is 128 or 256, C 1..4,
// D 1 or 2. This source computes the bf16 products only: bf16 must be set
// (f32 arithmetic is spatial_decoder_fwd.cu's). Returns the launch's
// cudaError_t (0 on success).
extern "C" int pvt_sdec_fwd_tc(const float* grid, const float* phi,
                               const float* dx, const float* sc,
                               const float* z, const float* wc,
                               const float* bc, const float* wz,
                               const float* hw, const float* hb,
                               const float* wout, const float* bout,
                               float* out, int B, int N, int D, int L, int H,
                               int n_layers, int C, int act, int sigmoid_out,
                               int bf16, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (!bf16 || D < 1 || D > 2 || C < 1 || C > kMaxC || n_layers < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * N > INT_MAX || reinterpret_cast<uintptr_t>(hw) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (H) {
    case 128:
      return (int)launch_act<128>(act, grid, phi, dx, sc, z, wc, bc, wz, hw,
                                  hb, wout, bout, out, B, N, D, L, n_layers,
                                  C, sigmoid_out, s);
    case 256:
      return (int)launch_act<256>(act, grid, phi, dx, sc, z, wc, bc, wz, hw,
                                  hb, wout, bout, out, B, N, D, L, n_layers,
                                  C, sigmoid_out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most hidden layers pvt_sdec_fwd_tc takes at width H with C channels
// on the current device: those whose bf16 weights fit in a block's shared
// memory beside one warpgroup (H = 128), or in a cluster of four blocks
// beside their tile (H = 256). -1 for a width or channel count it does not
// take, or when the device cannot be read.
extern "C" int pvt_sdec_fwd_tc_max_layers(int H, int C) {
  if ((H != 128 && H != 256) || C < 1 || C > kMaxC) return -1;
  int dev = -1, optin = 0, sms = 0;
  if (device_limits(&dev, &optin, &sms) != cudaSuccess) return -1;
  int nl = -1;
  if (H == 128)
    while (smem_bytes(H, nl + 1, C, 1) <= (size_t)optin) ++nl;
  else
    while (cluster_blocks(nl + 1, C, optin)) ++nl;
  return nl;
}

// The H = 256 plan of one call on the current device: out[0] the blocks a
// cluster, out[1] the tile's pixels, out[2] the shared memory a block,
// out[3] the clusters that fit on the card at once. Returns a cudaError_t.
extern "C" int pvt_sdec_fwd_tc_cluster_plan(int n_layers, int C, int act,
                                            int* out) {
  if (C < 1 || C > kMaxC || n_layers < 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  Plan p{};
  switch (act) {
    case ACT_TANH: err = cluster_plan<ACT_TANH>(dev, n_layers, C, &p); break;
    case ACT_RELU: err = cluster_plan<ACT_RELU>(dev, n_layers, C, &p); break;
    case ACT_LRELU: err = cluster_plan<ACT_LRELU>(dev, n_layers, C, &p); break;
    case ACT_SOFTPLUS:
      err = cluster_plan<ACT_SOFTPLUS>(dev, n_layers, C, &p);
      break;
    case ACT_GELU: err = cluster_plan<ACT_GELU>(dev, n_layers, C, &p); break;
    case ACT_TANH_APPROX:
      err = cluster_plan<ACT_TANH_APPROX>(dev, n_layers, C, &p);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = p.wgs;
  out[1] = p.wgs == 2 ? 64 : 32;
  out[2] = p.smem;
  out[3] = p.resident;
  return (int)cudaSuccess;
}

// The kernel's tanh of n floats x into y on `stream`. Returns the launch's
// cudaError_t.
extern "C" int pvt_sdec_fwd_tc_tanh(const float* x, float* y, long long n,
                                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  tanh_probe_kernel<<<blocks, 256, 0, s>>>(x, y, n);
  return (int)cudaGetLastError();
}

PVT_PHASE_READER(pvt_sdec_fwd_tc_phase_cycles)
