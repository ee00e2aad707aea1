// Fused coordinate-transform + spatial-decoder forward (K1) in f32 on the
// CUDA cores, for Hopper (sm_90a); the port runs it with BF16_MATMUL clear
// (the tensor-core version is spatial_decoder_fwd_tc.cu).
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
// the transform folded into three per-sample H-vectors.
//
// What bounds it: 2 * n_layers * H^2 flops per pixel against 4 bytes of
// output per pixel and channel, so the f32 FFMA rate (67 TFLOP/s), then the
// exact tanhf of every unit (H per layer and pixel).
//
// Design (the product core is f32_core.cuh):
//  * Persistent blocks, one an SM, of two groups of 256 threads; each group
//    walks a contiguous run of the flat (sample, pixel tile) list, so it
//    computes a sample's u, v, w once for every run of its tiles, and the
//    two groups drift apart (one's tanhf and head overlap the other's
//    FFMAs).
//  * The weights are staged once per block: every layer resident in shared
//    memory for the whole walk, shared by both groups, where they fit (H =
//    128, up to two layers), else streamed by each group for itself by
//    bulk copies (ChunkQueue, f32_core.cuh) ahead across layers and
//    tiles.
//  * A tile's activations [H][R] live in one buffer of its group: a
//    layer's outputs stay in registers until every thread of the group has
//    read its inputs.
//  * Exact f32 FFMA and tanhf (Pade tanh only when the caller chose
//    tanh_approx). The ragged last tile is computed on zero coordinates and
//    never stored; the output is written in [B, N, C] layout. Every block
//    runs the same fixed sequence, so repeats are bitwise equal.
//  * Nothing is allocated here and nothing synchronises with the host.

#include <atomic>
#include <climits>
#include <cstdint>

#include "f32_core.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kGroups = 2;                        // groups of a block
constexpr int kThreads = kGroups * kGroup;

// floats of one group's own shared memory: activations, u v w,
// coordinates, and (streamed weights) its stages
template <int H>
__host__ __device__ constexpr size_t group_floats(int stages) {
  using G = F32Geo<H>;
  return (size_t)G::kTile + 3 * (size_t)H + 2 * (size_t)G::R +
         (size_t)stages * G::kStage;
}

// the block's shared memory: the resident layers, both groups' own, the
// streams' barriers
template <int H>
size_t smem_bytes(int n_layers, bool resident, int stages) {
  return 4 * ((resident ? (size_t)n_layers * H * H : 0) +
              kGroups * group_floats<H>(stages)) +
         16 * (size_t)kGroups * stages + 8;
}

template <int H, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
sdec_fwd_kernel(const float* __restrict__ grid, const float* __restrict__ phi,
                const float* __restrict__ dx, const float* __restrict__ sc,
                const float* __restrict__ z, const float* __restrict__ wc,
                const float* __restrict__ bc, const float* __restrict__ wz,
                const float* __restrict__ hw, const float* __restrict__ hb,
                const float* __restrict__ wout, const float* __restrict__ bout,
                float* __restrict__ out, int N, int D, int L, int n_layers,
                int C, int sigmoid_out, int n_tiles, long long total,
                int resident, int stages) {
  using G = F32Geo<H>;
  constexpr int R = G::R;
  extern __shared__ float4 smem4[];
  float* wts = reinterpret_cast<float*>(smem4);  // the resident layers
  float* groups = wts + (resident ? (size_t)n_layers * H * H : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(groups + kGroups * group_floats<H>(stages)) +
       7) & ~(uintptr_t)7);

  // this group's run of tiles
  const long long runs = (long long)gridDim.x * kGroups;
  const long long run = (long long)blockIdx.x * kGroups + gid();
  const long long t0 = total * run / runs;
  const long long t1 = total * (run + 1) / runs;
  float* hs = groups + (size_t)gid() * group_floats<H>(stages);  // [H][R]
  float* us = hs + G::kTile;
  float* vs = us + H;
  float* wv = vs + H;
  float* gs = wv + H;  // [R][2] coordinates
  uint64_t* my_bars = bars + 2 * stages * gid();
  ChunkQueue<H, SelfIssue<H>> ring{
      gs + 2 * R, my_bars, my_bars + stages, stages, 0u,
      SelfIssue<H>{chunk_source<H>(gs + 2 * R, my_bars, stages, hw, n_layers,
                                   t1 - t0),
                   gtid() == 0}};
  if (resident) {
    const size_t n = (size_t)n_layers * H * H;
    for (size_t i = threadIdx.x * 4; i < n; i += kThreads * 4)
      cp_async16(wts + i, hw + i);
    cp_async_commit();
    cp_async_wait_all();
  } else if (gtid() == 0) {
    ring.iss.src.init(kGroup / 32);
    ring.iss.src.issue_ready();
  }
  __syncthreads();  // the resident weights, or the streams' barriers

  PhaseClock pc;
  const ProdPos<H> pos;
  int cur_b = -1;

  for (long long t = t0; t < t1; ++t) {
    pc.mark(0);
    pc.count(7);
    const int b = (int)(t / n_tiles);
    const int n0 = (int)(t - (long long)b * n_tiles) * R;
    const int rows = min(R, N - n0);

    // -- per-sample vectors when the sample changes, tile coordinates, h0
    if (b != cur_b) {
      sample_vectors<H>(b, D, L, phi, dx, sc, z, wc, bc, wz, us, vs, wv);
      cur_b = b;
    }
    tile_coords<H>(grid, n0, rows, D, gs);
    gsync();
    coord_layer<H, ACT>(us, vs, wv, gs, hs);
    gsync();
    pc.mark(2);

    // -- hidden layers
    for (int l = 0; l < n_layers; ++l) {
      float acc[4][8];
      layer_product<H>(hs, resident ? wts + (size_t)l * H * H : nullptr,
                       ring, pos, acc, pc, 1, 3);
      gsync();  // every read of h_l is done
      const float* bias = hb + (size_t)l * H;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = pos.col(j);
        const float bj = bias[n];
        st4(hs + slot4<R>(n, pos.q),
            make_float4(act_fn<ACT>(acc[0][j] + bj), act_fn<ACT>(acc[1][j] + bj),
                        act_fn<ACT>(acc[2][j] + bj),
                        act_fn<ACT>(acc[3][j] + bj)));
      }
      gsync();
      pc.mark(4);
    }

    // -- head: the row's dots, then one lane of the row writes it
    float p[kF32MaxC];
    head_dots<H>(hs, wout, C, p);
    const int r = gtid() / G::HEAD;
    if (gtid() % G::HEAD == 0 && r < rows) {
#pragma unroll
      for (int c = 0; c < kF32MaxC; ++c) {
        if (c < C) {
          const float logit = p[c] + bout[c];
          out[((size_t)b * N + n0 + r) * C + c] =
              sigmoid_out ? sigmoid(logit) : logit;
        }
      }
    }
    pc.mark(5);
  }
}

// Opt an instance into the device's largest dynamic shared memory, once per
// instance and device (the attribute stays set on the context).
template <int H, int ACT>
cudaError_t allow_smem(int dev, int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      sdec_fwd_kernel<H, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int H, int ACT>
cudaError_t launch(const float* grid, const float* phi, const float* dx,
                   const float* sc, const float* z, const float* wc,
                   const float* bc, const float* wz, const float* hw,
                   const float* hb, const float* wout, const float* bout,
                   float* out, int B, int N, int D, int L, int n_layers, int C,
                   int sigmoid_out, cudaStream_t stream) {
  using G = F32Geo<H>;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = allow_smem<H, ACT>(dev, optin);
  if (err != cudaSuccess) return err;

  // every layer resident where the layers fit beside both groups'
  // buffers, else a stream of up to 4 stages for each group
  const bool resident = n_layers > 0 &&
                        smem_bytes<H>(n_layers, true, 0) <= (size_t)optin;
  int stages = 0;
  if (!resident) {
    stages = kF32MaxStages;
    while (stages > 2 &&
           smem_bytes<H>(n_layers, false, stages) > (size_t)optin)
      --stages;
  }
  const int smem = (int)smem_bytes<H>(n_layers, resident, stages);
  if (smem > optin) return cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sdec_fwd_kernel<H, ACT>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = (N + G::R - 1) / G::R;
  const long long total = (long long)n_tiles * B;
  const long long fit = (long long)per_sm * sms;
  const long long groups = (total + kGroups - 1) / kGroups;
  const int blocks = (int)(fit < groups ? fit : groups);
  sdec_fwd_kernel<H, ACT><<<blocks, kThreads, smem, stream>>>(
      grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, out, N, D, L,
      n_layers, C, sigmoid_out, n_tiles, total, (int)resident, stages);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_act(int act, const float* grid, const float* phi,
                       const float* dx, const float* sc, const float* z,
                       const float* wc, const float* bc, const float* wz,
                       const float* hw, const float* hb, const float* wout,
                       const float* bout, float* out, int B, int N, int D,
                       int L, int n_layers, int C, int sigmoid_out,
                       cudaStream_t stream) {
#define PVT_LAUNCH(A)                                                        \
  return launch<H, A>(grid, phi, dx, sc, z, wc, bc, wz, hw, hb, wout, bout, \
                      out, B, N, D, L, n_layers, C, sigmoid_out, stream)
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

PVT_PHASE_READER(pvt_sdec_fwd_phase_cycles)

// Plain C entry point (bound with ctypes). Shapes: grid [N, D], phi/sc [B],
// dx [B, D], z [B, L], wc [D, H], bc [H], wz [L, H], hw [n_layers, H, H]
// (input-major), hb [n_layers, H], wout [H, C], bout [C], out [B, N, C];
// all float32, contiguous, on the device of `stream`. H is 128 or 256, C at
// most 4. bf16 must be 0: bf16 products are the tensor-core source's.
// Returns the launch's cudaError_t (0 on success).
extern "C" int pvt_sdec_fwd(const float* grid, const float* phi,
                            const float* dx, const float* sc, const float* z,
                            const float* wc, const float* bc, const float* wz,
                            const float* hw, const float* hb,
                            const float* wout, const float* bout, float* out,
                            int B, int N, int D, int L, int H, int n_layers,
                            int C, int act, int sigmoid_out, int bf16,
                            void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  if (D < 1 || D > 2 || C < 1 || C > kF32MaxC || n_layers < 0 || L < 0 ||
      bf16 != 0)
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
