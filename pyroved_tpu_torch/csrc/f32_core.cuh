// The f32 core of K1 on the CUDA cores (sm_90a), which runs with the
// port's BF16_MATMUL clear (spatial_decoder_fwd.cu): its products, phase
// clock, activations and per-sample transform. Every product is exact f32
// FFMA.
//
// Work goes to groups of 256 threads (8 warps), each walking its own run of
// (sample, pixel tile) pairs and synchronising on its own named barrier;
// a block holds two groups where the shared memory allows, and they drift
// apart: one group's tanhf, head and barriers overlap the other's FFMAs,
// and 16 warps hide the latency of the shared-memory loads.
//
// A pixel tile is R = 8192 / H rows (64 at H = 128, 32 at H = 256).
// Activations live in shared memory transposed, [H][R] ("hidden unit
// major"), so that a thread reads its 4 rows of one unit as one float4.
// Each row of R floats is XOR-swizzled in float4 slots by the unit index
// (slot q of unit k sits at q ^ (k & 7)): a warp that reads 8 consecutive
// units at the same rows (the weight-grad products) hits 8 distinct bank
// groups, and one that reads one unit at 8 row slots (the layer products)
// too.
//
// Layer products out[r][n] = sum_k A[r][k] M[k][n] (M = W_l for the
// forward, W_l^T for dh = d_pre W_l^T) are outer-product sums over k: a
// thread holds 4 rows x 8 columns (rows 4q .. +3, columns cg*4 .. +3 and
// H/2 + cg*4 .. +3) and per k reads one float4 of A and two of M, 32 FFMA
// for 3 loads, with the next k's operands loaded before this k's FFMAs. A
// warp is 4 row groups x 8 column groups, so no load conflicts. M comes
// from shared memory: either every layer resident for the block's whole
// walk, or streamed in 8 KB chunks of KC rows through S stages
// (ChunkQueue): bulk copies (the copy engine) run ahead of the
// consumers, each completing on its stage's mbarrier, and the warps wait
// only for their chunk's data, never for one another, so they keep their
// natural skew inside a product.
//
// PVT_PROFILE_PHASES compiles in PhaseClock marks: thread 0 of block 0 adds
// the cycles since its previous mark to the phase the mark closes
// (sm90_common.cuh's g_phase_cycles, the first warpgroup's row, read by
// PVT_PHASE_READER).

#pragma once

#include "sm90_common.cuh"

namespace {

constexpr int kGroup = 256;  // threads of a group
constexpr int kF32MaxC = 4;
constexpr int kF32MaxStages = 4;

template <int H>
struct F32Geo {
  static constexpr int R = 8192 / H;       // tile rows
  static constexpr int kTile = H * R;      // floats of one activation buffer
  static constexpr int CG = H / 8;         // column groups of a product
  static constexpr int WC = CG / 8;        // warps along the columns
  static constexpr int kStage = 2048;      // floats of one stream stage
  static constexpr int KC = kStage / H;    // weight rows a stage
  static constexpr int HEAD = kGroup / R;  // threads that share a head dot
  static_assert((kGroup / 32 / WC) * 4 * 4 == R, "4 rows a thread");
};

// this thread's index in its group, and the group's index in the block
__device__ __forceinline__ int gtid() { return threadIdx.x & (kGroup - 1); }
__device__ __forceinline__ int gid() { return threadIdx.x / kGroup; }

// the group's barrier (named barrier 1 + group; 0 is __syncthreads)
__device__ __forceinline__ void gsync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gid()), "n"(kGroup)
               : "memory");
}

#ifdef PVT_PROFILE_PHASES
struct PhaseClock {
  long long last = -1;
  __device__ __forceinline__ void mark(int k) {
    if (threadIdx.x == 0 && blockIdx.x == 0) {
      const long long now = clock64();
      if (last >= 0) g_phase_cycles[0][k] += now - last;
      last = now;
    }
  }
  // adds one to counter k (a tile count) instead of cycles
  __device__ __forceinline__ void count(int k) {
    if (threadIdx.x == 0 && blockIdx.x == 0) g_phase_cycles[0][k] += 1;
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(int) {}
};
#endif

// mbarriers (shared memory, one 64-bit word each) and the bulk copy that
// completes on one
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// whether the phase of `parity` (0 or 1) has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// waits until the phase of `parity` (0 or 1) has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory by the copy engine; completes its bytes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src),
      "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// offset of float4 slot q (rows 4q .. 4q+3) of unit k in a [H][R] buffer
template <int R>
__device__ __forceinline__ int slot4(int k, int q) {
  return k * R + ((q ^ (k & 7)) << 2);
}

template <int R>
__device__ __forceinline__ int tix(int k, int r) {
  return slot4<R>(k, r >> 2) + (r & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int A>
__device__ __forceinline__ float h0_act(float x) {
  if constexpr (A == ACT_TANH_APPROX) return pade_tanh(x);
  else return tanhf(x);
}

// A thread's place in a [R x H] layer product: row slot q (rows 4q .. 4q+3)
// and column group cg.
template <int H>
struct ProdPos {
  int q, cg;
  __device__ __forceinline__ ProdPos() {
    using G = F32Geo<H>;
    const int lane = gtid() & 31, warp = gtid() >> 5;
    q = (warp / G::WC) * 4 + (lane >> 3);
    cg = (warp % G::WC) * 8 + (lane & 7);
  }
  // column of accumulator column j (0..7)
  __device__ __forceinline__ int col(int j) const {
    return (j < 4 ? 0 : H / 2) + cg * 4 + (j & 3);
  }
};

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += sum_{kk < KC} A[k0 + kk][4q + i] * M[kk][col(j)], A a [H][R]
// buffer and M a [KC][H] chunk of rows k0 .. k0 + KC of the product's
// matrix; each k's operands are loaded while the previous k's FFMAs run.
template <int H>
__device__ __forceinline__ void prod_chunk(const float* __restrict__ A,
                                           const float* __restrict__ M,
                                           int k0, const ProdPos<H>& p,
                                           float (&acc)[4][8]) {
  using G = F32Geo<H>;
  float4 a = ld4(A + slot4<G::R>(k0, p.q));
  float4 b0 = ld4(M + p.cg * 4), b1 = ld4(M + H / 2 + p.cg * 4);
#pragma unroll
  for (int kk = 0; kk < G::KC; ++kk) {
    float4 an = a, b0n = b0, b1n = b1;
    if (kk + 1 < G::KC) {
      const int k1 = kk + 1;
      an = ld4(A + slot4<G::R>(k0 + k1, p.q));
      b0n = ld4(M + k1 * H + p.cg * 4);
      b1n = ld4(M + k1 * H + H / 2 + p.cg * 4);
    }
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    a = an;
    b0 = b0n;
    b1 = b1n;
  }
}

// A stream of weight chunks: for each tile, the chunks of the `n_fwd`
// layer products (the matrices fw[0 .. n_fwd)), H / KC chunks each, 8 KB a
// chunk. Stage s of its S stages fills by one bulk copy that completes on
// full[s]; each consuming warp arrives on empty[s] when it is done with
// the chunk. Its consumers (one group) wait only for the data they need,
// never for one another. One consuming thread issues the copies
// (SelfIssue): it never waits for a stage, and whenever it releases a
// chunk, or finds the one it needs still in flight, it issues every next
// chunk whose stage is free. ChunkQueue is the consumers' side; every
// consuming thread calls acquire() and release() for every chunk, in
// order.
template <int H>
struct ChunkSource {
  using G = F32Geo<H>;
  float* stages;
  uint64_t* full;
  uint64_t* empty;
  const float* fw;
  int S, n_fwd;
  unsigned total, issued;

  // the barriers of `warps` consuming warps; one thread, and a barrier of
  // every consumer after it
  __device__ __forceinline__ void init(int warps) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, warps);
    }
    mbar_fence_init();
  }

  __device__ __forceinline__ bool stage_free() const {
    return issued < (unsigned)S ||
           mbar_test(empty + issued % S, (issued / S - 1) & 1);
  }

  __device__ __forceinline__ void issue() {
    constexpr int nc = H / G::KC;
    const unsigned per_tile = (unsigned)n_fwd * nc;
    const int p = (int)(issued % per_tile);
    const int prod = p / nc, c = p - prod * nc;
    const float* src = fw + (size_t)prod * H * H + (size_t)c * G::kStage;
    const int s = (int)(issued % S);
    mbar_expect_tx(full + s, G::kStage * 4);
    bulk_copy(stages + (size_t)s * G::kStage, src, G::kStage * 4, full + s);
    ++issued;
  }

  // every next chunk whose stage is free, without waiting
  __device__ __forceinline__ void issue_ready() {
    while (issued < total && stage_free()) issue();
  }
};

template <int H>
__device__ __forceinline__ ChunkSource<H> chunk_source(
    float* stages, uint64_t* bars, int S, const float* fw, int n_fwd,
    long long tiles) {
  return ChunkSource<H>{stages, bars, bars + S, fw, S, n_fwd,
                        (unsigned)(tiles * n_fwd * (H / F32Geo<H>::KC)), 0u};
}

// the issuer of a queue whose copies one of its consuming threads makes
// (`mine`: this thread is that one)
template <int H>
struct SelfIssue {
  ChunkSource<H> src;
  bool mine;
  __device__ __forceinline__ bool waiting() {
    if (!mine) return false;
    src.issue_ready();
    return true;
  }
  __device__ __forceinline__ void released() {
    if (mine) src.issue_ready();
  }
};

template <int H, typename Issuer>
struct ChunkQueue {
  using G = F32Geo<H>;
  float* stages;
  uint64_t* full;
  uint64_t* empty;
  int S;
  unsigned consumed;
  Issuer iss;

  __device__ __forceinline__ void wait_full() {
    const int s = (int)(consumed % S);
    const uint32_t parity = (consumed / S) & 1;
    if (iss.waiting()) {  // the issuing thread keeps issuing meanwhile
      while (!mbar_test(full + s, parity)) iss.waiting();
    } else {
      mbar_wait(full + s, parity);
    }
  }

  // the next chunk, once its copy has landed
  __device__ __forceinline__ const float* acquire(PhaseClock& pc, int mark) {
    wait_full();
    pc.mark(mark);
    return stages + (size_t)(consumed % S) * G::kStage;
  }

  // this warp is done with the chunk acquire() gave
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + (int)(consumed % S));
    ++consumed;
    iss.released();
  }
};

// acc = A M over the full depth H, M either resident ([H][H] in shared
// memory) or the next H / KC chunks of the ring.
template <int H, typename Queue>
__device__ __forceinline__ void layer_product(const float* __restrict__ A,
                                              const float* resident,
                                              Queue& ring,
                                              const ProdPos<H>& p,
                                              float (&acc)[4][8],
                                              PhaseClock& pc, int stage_mark,
                                              int prod_mark) {
  using G = F32Geo<H>;
  zero(acc);
  if (resident) {
#pragma unroll 1
    for (int k0 = 0; k0 < H; k0 += G::KC)
      prod_chunk<H>(A, resident + (size_t)k0 * H, k0, p, acc);
    pc.mark(prod_mark);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < H; k0 += G::KC) {
      const float* m = ring.acquire(pc, stage_mark);
      prod_chunk<H>(A, m, k0, p, acc);
      ring.release();
      pc.mark(prod_mark);
    }
  }
}

// The per-sample folded transform into us, vs, wv [H] (D = 1: u = Wc0,
// v = 0).
template <int H>
__device__ __forceinline__ void sample_vectors(
    int b, int D, int L, const float* __restrict__ phi,
    const float* __restrict__ dx, const float* __restrict__ sc,
    const float* __restrict__ z, const float* __restrict__ wc,
    const float* __restrict__ bc, const float* __restrict__ wz, float* us,
    float* vs, float* wv) {
  float cph = 1.0f, sph = 0.0f, scale = 1.0f;
  if (D == 2) {
    sincosf(phi[b], &sph, &cph);
    scale = sc[b];
  }
  for (int h = gtid(); h < H; h += kGroup) {
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
}

// The tile's coordinates gs [R][2] (rows past N get 0).
template <int H>
__device__ __forceinline__ void tile_coords(const float* __restrict__ grid,
                                            int n0, int rows, int D,
                                            float* gs) {
  for (int r = gtid(); r < F32Geo<H>::R; r += kGroup) {
    float gx = 0.0f, gy = 0.0f;
    if (r < rows) {
      gx = grid[(size_t)(n0 + r) * D];
      if (D == 2) gy = grid[(size_t)(n0 + r) * D + 1];
    }
    gs[2 * r] = gx;
    gs[2 * r + 1] = gy;
  }
}

// h0[k][r] = tanh(gx u_k + gy v_k + w_k) into the [H][R] buffer hs.
template <int H, int ACT>
__device__ __forceinline__ void coord_layer(const float* us, const float* vs,
                                            const float* wv, const float* gs,
                                            float* hs) {
  using G = F32Geo<H>;
  constexpr int Q = G::R / 4;
  for (int e = gtid(); e < H * Q; e += kGroup) {
    const int k = e / Q, q = e - k * Q;
    const float u = us[k], v = vs[k], w = wv[k];
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * q + i;
      o[i] = h0_act<ACT>(gs[2 * r] * u + gs[2 * r + 1] * v + w);
    }
    st4(hs + slot4<G::R>(k, q), make_float4(o[0], o[1], o[2], o[3]));
  }
}

// The head's dot products: thread t takes row r = t / HEAD and the units
// k = t % HEAD + HEAD m, in four independent partial sums; the HEAD threads
// of a row are neighbouring lanes and sum in a fixed butterfly. Every one
// of them returns the row's (pre-bias) dots p[c], c < C.
template <int H>
__device__ __forceinline__ void head_dots(const float* hL,
                                          const float* __restrict__ wout,
                                          int C, float (&p)[kF32MaxC]) {
  using G = F32Geo<H>;
  const int r = gtid() / G::HEAD, part = gtid() % G::HEAD;
  float s[4][kF32MaxC];
  zero(s);
#pragma unroll 2
  for (int k = part; k < H; k += 4 * G::HEAD) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ku = k + u * G::HEAD;
      const float h = hL[tix<G::R>(ku, r)];
#pragma unroll
      for (int c = 0; c < kF32MaxC; ++c)
        if (c < C) s[u][c] = fmaf(h, wout[ku * C + c], s[u][c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kF32MaxC; ++c)
    p[c] = (s[0][c] + s[1][c]) + (s[2][c] + s[3][c]);
#pragma unroll
  for (int off = G::HEAD / 2; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < kF32MaxC; ++c)
      p[c] += __shfl_xor_sync(0xffffffffu, p[c], off);
}

}  // namespace
