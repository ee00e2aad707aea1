// Fused coordinate-transform + spatial-decoder forward (K1) on Hopper's
// tensor cores (sm_90a): bf16 operands, f32 accumulation.
//
// Replaces pyroved_tpu/ops/spatial_decoder.py::_fwd_kernel under the JAX
// package's default BF16_MATMUL = True: the operands of every hidden product
// h_l W_l (:448, _mxu_dot) are rounded to bf16 and the products summed in
// f32. The folded transform, h0 = tanh (the Pade tanh for tanh_approx),
// biases, activations (exact tanhf and erff) and the head stay in f32; h_l
// is rounded to bf16 only where it feeds a product, and the head reads the
// last layer's f32 values. spatial_decoder_fwd.cu is the BF16_MATMUL = False
// version and holds the formulas.
//
// What bounds it: 2 n_layers H^2 flops per pixel on the tensor cores
// against 4 C bytes of output per pixel. At the flagship training step
// (B = 200, N = 784, H = 128, two layers) that is 0.010 ms at the bf16 peak,
// at the posed decode of 1024 latents 0.054 ms, at the large grid (B = 64,
// N = 16384) 0.069 ms. The f32 work beside it (an exact tanhf or erff per
// hidden value, the bf16 packing, the head) is several times the
// tensor-core time, so the design is about overlapping it.
//
// Design:
//  * Tensor cores. A tile is R pixels of one sample (64 at H = 128, 32 at
//    H = 256). Pixels are the N side of each product and the hidden units
//    fill wgmma's M = 64: pre^T [H, R] = W_l^T h_l^T, both operands from
//    shared memory, W_l^T and h_l^T read MN-major, so nothing is
//    transposed. h_l^T is an [H, R] bf16 matrix of 8x8 core matrices (no
//    swizzle), written by the epilogue straight from the accumulator layout
//    as bf16 pairs, without bank conflicts, in place of h_{l-1}.
//  * One warpgroup, one tile. A block holds up to four warpgroups that
//    share the weights and nothing else: each runs its own tiles with its
//    own named barrier, so one warpgroup's epilogue (bias, tanhf, bf16
//    packing, head) overlaps another's wgmma. Every epilogue is unrolled
//    over the thread's accumulator entries with the activation a template
//    argument, so it holds no branch; the head is a pass of its own. Each
//    layer's wgmma run from one fence to one wait with no other
//    instruction touching the accumulators in between, so ptxas keeps them
//    pipelined.
//  * One persistent launch. The grid is as many blocks as fit on the card
//    at once (at most one per warpgroups' worth of tiles); warpgroup g of W
//    takes the contiguous run [g T / W, (g + 1) T / W) of the flat (sample,
//    tile) list, so it computes the per-sample vectors u, v, w only when
//    the sample changes, and it loads the next tile's coordinates into
//    shared memory during the head. No prep kernel, no workspace, no
//    atomics: each output is one thread's fixed-order sum, and a second
//    launch on the same inputs is bitwise equal.
//  * Weights rounded to bf16 once per block. At H = 128 each block rounds
//    every layer's weights into shared memory once, as 64-unit panels
//    (64 x H, MN-major): up to six layers fit beside a warpgroup, five
//    beside two. At H = 256 (128 KB a layer) each warpgroup streams one
//    panel per product through two slots: it rounds the next product's
//    panel into the free slot while the tensor cores run the current one.
//  * Head: per thread over its units, then over the 8 lanes that share a
//    pixel by three halving exchanges (each lane keeps half of the sums it
//    holds and trades the other half), then over the 4 warps in shared
//    memory, all in f32.
//  * Ragged tiles: pixels past N get zero coordinates and are never stored.
//    The output is written as [B, N, C] ([B, N] when C = 1), coalesced.
//
// Budget, one block per SM, 128 registers a thread at most (512 threads):
//  * registers: the f32 accumulators of all H units for the tile, H R / 128
//    = 64 a thread at either width;
//  * shared memory at H = 128: every layer's weights, n_layers 2 H^2 bytes
//    (64 KB at the flagship), then per warpgroup a bf16 level 2 H R (16 KB),
//    u, v, w (3 H floats), the tile's coordinates (2 R) and head partials
//    (4 R C), plus the biases and head weights once per block: 142 KB with
//    four warpgroups at the flagship. At H = 256: two 32 KB panel slots and
//    a 16 KB level a warpgroup, two warpgroups.
// Nothing is allocated here and nothing synchronises with the host.

#include <atomic>
#include <climits>

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
__host__ __device__ constexpr int tile_rows(int H) { return H == 128 ? 64 : 32; }

// Tile rows and the sizes that follow from them, per hidden width. H = 128
// keeps every layer's weights in shared memory; H = 256 streams them.
template <int H>
struct Dims {
  static constexpr int R = tile_rows(H);
  static constexpr int SPW = H / 64;     // 64-unit slabs
  static constexpr int NV = R / 2;       // accumulator floats a slab
  static constexpr int NP = R / 4;       // head partials a channel
  static constexpr int RSH = 16 * R;     // row-of-cores stride, level
  static constexpr int PANEL = 128 * H;  // bytes of a 64-unit panel
  static constexpr bool STREAM = H == 256;
};

// shared memory: [resident panels (H = 128)] [per warpgroup: panel slots
// (H = 256), level] [biases, head weights, bout] [per warpgroup: u, v, w,
// coordinates, head partials]
__host__ __device__ constexpr size_t weight_bytes(int H, int nl) {
  return H == 128 ? (size_t)nl * 2 * H * H : 0;
}

__host__ __device__ constexpr size_t wg_bf16_bytes(int H) {
  return (H == 128 ? 0 : (size_t)2 * 128 * H) + (size_t)2 * H * tile_rows(H);
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

template <int A>
__device__ __forceinline__ float h0_act(float x) {
  if constexpr (A == ACT_TANH_APPROX) return pade_tanh(x);
  else return tanhf(x);
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
  using S = Dims<H>;
  constexpr int R = S::R, SPW = S::SPW, NV = S::NV, NP = S::NP, RSH = S::RSH;
  constexpr int PANEL = S::PANEL;
  constexpr bool STREAM = S::STREAM;
  const int nl = a.nl, C = a.C;
  const int wgs = blockDim.x >> 7;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int wi = wtid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;

  uint8_t* wsm = smem;  // resident panels
  uint8_t* slots = smem + weight_bytes(H, nl) + wg * wg_bf16_bytes(H);
  uint8_t* lv = slots + (STREAM ? 2 * PANEL : 0);  // [H, R] bf16 level
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

  // -- once per block: biases, head, resident weights in bf16
  for (int i = tid; i < nl * H; i += blockDim.x) hb_s[i] = a.hb[i];
  for (int i = tid; i < H * C; i += blockDim.x) wout_s[i] = a.wout[i];
  if (tid < kMaxC) bout_s[tid] = tid < C ? a.bout[tid] : 0.0f;
  if constexpr (!STREAM)
    round_panels<H>(wsm, a.hw, 0, nl * SPW, tid >> 5, blockDim.x >> 5, lane);
  fence_async_smem();
  __syncthreads();

  // this warpgroup's contiguous run of the flat (sample, tile) list
  const long long total = (long long)a.B * a.n_tiles;
  const long long W = (long long)gridDim.x * wgs;
  const long long g = (long long)blockIdx.x * wgs + wg;
  const int t_begin = (int)(g * total / W), t_end = (int)((g + 1) * total / W);
  if (t_begin >= t_end) return;
  int q = 0;  // streamed products so far: slot q & 1 holds the next one
  if (STREAM && nl > 0) {  // the first product's panel
    round_panels<H>(slots, a.hw, 0, 1, wi, 4, lane);
    fence_async_smem();
  }
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
            for (int e = 0; e < 2; ++e)
              acc[s][4 * j + 2 * hh + e] = h0_act<A>(
                  gx[e] * u2[s][hh] + gy[e] * v2[s][hh] + w2[s][hh]);
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
    //    then bias and activation (phase 4)
    for (int l = 0; l < nl; ++l) {
      if constexpr (!STREAM) {
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
      } else {
#pragma unroll
        for (int s = 0; s < SPW; ++s) {
          const uint32_t wa = smem_addr(slots + (q & 1) * PANEL);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < H / 16; ++k)
            wgmma<R, 1, 1>(acc[s], desc(wa + k * 2048, 1024, 128),
                           desc(lv_addr + k * 2 * RSH, RSH, 128), k);
          wgmma_commit();
          // round the next product's panel into the free slot meanwhile
          const int next = l * SPW + s + 1;
          round_panels<H>(slots + ((q + 1) & 1) * PANEL, a.hw,
                          next == nl * SPW ? 0 : next, 1, wi, 4, lane);
          wgmma_wait();
          fence_regs(acc[s]);
          fence_async_smem();
          wg_barrier(wg);  // the slot is full, the product is done
          ++q;
        }
      }
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
                         act_fn<A>(acc[s][v] + bias[s][hh]),
                         act_fn<A>(acc[s][v + 1] + bias[s][hh]));
            }
        fence_async_smem();
        wg_barrier(wg);
      } else {  // h_L = act(pre) stays in f32 for the head
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int v = 0; v < NV; ++v)
            acc[s][v] = act_fn<A>(acc[s][v] + bias[s][(v >> 1) & 1]);
      }
      PHASE_MARK(4);
    }

    // -- head dots sum_m h_L[m][n] wout[m][c] in f32: each thread over its
    //    units, then the 8 lanes that share a pixel by three halving
    //    exchanges, then the 4 warps; the next tile's coordinates meanwhile
    if (t + 1 < t_end) load_coords<R>(gs, a, t + 1, wtid);
    const int gr = ((gq & 1) << 2) | (gq & 2) | (gq >> 2);  // gq reversed
    for (int c = 0; c < C; ++c) {
      float wo[SPW][2];
#pragma unroll
      for (int s = 0; s < SPW; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) wo[s][hh] = wout_s[row_of(s, hh) * C + c];
      float p[NP];  // p[2 j + e]: pixel 8 j + 2 tq + e
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        p[i] = 0.0f;
#pragma unroll
        for (int s = 0; s < SPW; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            p[i] += acc[s][4 * (i >> 1) + 2 * hh + (i & 1)] * wo[s][hh];
      }
      fold_half<NP>(p, 4, lane);
      fold_half<NP / 2>(p, 8, lane);
      fold_half<NP / 4>(p, 16, lane);
#pragma unroll
      for (int k = 0; k < NP / 8; ++k) {  // entry k + NP / 8 gr of p
        const int i = k + NP / 8 * gr;
        headp[(wi * R + 8 * (i >> 1) + 2 * tq + (i & 1)) * C + c] = p[k];
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
// once per device.
cudaError_t device_limits(int* dev, int* optin, int* sms) {
  static std::atomic<int> cached[kMaxDevices][2];
  cudaError_t err = cudaGetDevice(dev);
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

template <int H, int A>
cudaError_t launch(const float* grid, const float* phi, const float* dx,
                   const float* sc, const float* z, const float* wc,
                   const float* bc, const float* wz, const float* hw,
                   const float* hb, const float* wout, const float* bout,
                   float* out, int B, int N, int D, int L, int nl, int C,
                   int sigmoid_out, cudaStream_t stream) {
  int dev = 0, optin = 0, sms = 0;
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
  const int R = tile_rows(H);
  const int n_tiles = (N + R - 1) / R;
  const long long total = (long long)B * n_tiles;
  const long long want = (total + wgs - 1) / wgs;
  const long long fit = (long long)per_sm * sms;
  const int blocks = (int)(want < fit ? want : fit);
  const KArgs k{grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, out,
                B, N, D, L, nl, C, sigmoid_out, n_tiles};
  sdec_fwd_tc_kernel<H, A><<<blocks, 128 * wgs, smem, stream>>>(k);
  return cudaGetLastError();
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
// on the current device: those whose biases (and at H = 128 bf16 weights)
// fit in a block's shared memory beside one warpgroup. -1 for a width or
// channel count it does not take, or when the device cannot be read.
extern "C" int pvt_sdec_fwd_tc_max_layers(int H, int C) {
  if ((H != 128 && H != 256) || C < 1 || C > kMaxC) return -1;
  int dev = 0, optin = 0, sms = 0;
  if (device_limits(&dev, &optin, &sms) != cudaSuccess) return -1;
  int nl = -1;
  while (smem_bytes(H, nl + 1, C, 1) <= (size_t)optin) ++nl;
  return nl;
}

PVT_PHASE_READER(pvt_sdec_fwd_tc_phase_cycles)
