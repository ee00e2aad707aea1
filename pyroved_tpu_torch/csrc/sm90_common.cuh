// Helpers shared by the port's tensor-core kernels (sm_90a):
// spatial_decoder_fwd_tc.cu (K1) and spatial_decoder_bwd_tc.cu (K2/K3).
//
// The activations as the kernels evaluate them, the tiled bf16 layout of
// 8x8 core matrices that every wgmma operand uses here, wgmma descriptors
// and wrappers, and the cp.async / barrier primitives around them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

// Per-phase cycles of a kernel's tile loop, compiled in only with
// -DPVT_PROFILE_PHASES: the first thread of each warpgroup of block 0 adds
// the cycles since its previous mark to the phase that a mark closes (mark
// 0 closes the loop's own overhead, mark k > 0 the k-th "// --" phase of
// the loop body), and the cycles of a statement that PHASE_TIMED wraps to
// a counter of its own: kBarSlot barriers, kMmaSlot wgmma waits, kIssueSlot
// issuing products, kClusterSlot waits on the other blocks of a cluster
// (their rows, their arrivals) (parts of the phases' cycles). The
// counters live in
// g_phase_cycles [warpgroup][kPhaseSlots]; PHASE_CLOCK_AT(acc) keeps a
// warpgroup's in `acc` instead (shared memory, cheaper than global adds),
// and PHASE_FLUSH then adds them to g_phase_cycles. PVT_PHASE_READER(name)
// defines the C entry point that reads them.
constexpr int kPhaseMarks = 8;
constexpr int kBarSlot = kPhaseMarks, kMmaSlot = kPhaseMarks + 1,
              kIssueSlot = kPhaseMarks + 2, kClusterSlot = kPhaseMarks + 3;
constexpr int kPhaseSlots = kPhaseMarks + 4;
constexpr int kPhaseGroups = 4;  // warpgroups of a block of up to 512
#ifdef PVT_PROFILE_PHASES
__device__ long long g_phase_cycles[kPhaseGroups][kPhaseSlots];
#define PHASE_CLOCK_AT(acc)                                                \
  long long* const phase_acc_ = (acc);                                     \
  const bool phase_lead_ = blockIdx.x == 0 && (threadIdx.x & 127) == 0;    \
  long long phase_last_ = -1
#define PHASE_CLOCK PHASE_CLOCK_AT(g_phase_cycles[threadIdx.x >> 7])
#define PHASE_MARK(k)                                             \
  do {                                                            \
    if (phase_lead_) {                                            \
      const long long now_ = clock64();                           \
      if (phase_last_ >= 0) phase_acc_[k] += now_ - phase_last_;  \
      phase_last_ = now_;                                         \
    }                                                             \
  } while (0)
#define PHASE_TIMED(k, stmt)                                  \
  do {                                                        \
    const long long t0_ = phase_lead_ ? clock64() : 0;        \
    stmt;                                                     \
    if (phase_lead_) phase_acc_[k] += clock64() - t0_;        \
  } while (0)
#define PHASE_FLUSH                                                       \
  do {                                                                    \
    if (phase_lead_)                                                      \
      for (int k_ = 0; k_ < kPhaseSlots; ++k_)                            \
        g_phase_cycles[threadIdx.x >> 7][k_] += phase_acc_[k_];           \
  } while (0)
// The counters since the last reset (reset != 0 zeroes them instead):
// out[kPhaseGroups][kPhaseSlots]. Returns a cudaError_t.
#define PVT_PHASE_READER(name)                                            \
  extern "C" int name(long long* out, int reset) {                        \
    if (reset) {                                                          \
      const long long zero[kPhaseGroups][kPhaseSlots] = {};               \
      return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)); \
    }                                                                     \
    return (int)cudaMemcpyFromSymbol(out, g_phase_cycles,                 \
                                     sizeof(g_phase_cycles));             \
  }
#else
#define PHASE_CLOCK_AT(acc) do {} while (0)
#define PHASE_CLOCK do {} while (0)
#define PHASE_MARK(k) do {} while (0)
#define PHASE_TIMED(k, stmt) do { stmt; } while (0)
#define PHASE_FLUSH do {} while (0)
#define PVT_PHASE_READER(name)
#endif

namespace {

enum Act { ACT_TANH = 0, ACT_RELU = 1, ACT_LRELU = 2, ACT_SOFTPLUS = 3,
           ACT_GELU = 4, ACT_TANH_APPROX = 5 };

__device__ __forceinline__ float pade_tanh(float x) {
  x = fminf(fmaxf(x, -4.97f), 4.97f);
  const float x2 = x * x;
  const float num = x * (135135.0f + x2 * (17325.0f + x2 * (378.0f + x2)));
  const float den = 135135.0f + x2 * (62370.0f + x2 * (3150.0f + 28.0f * x2));
  return num / den;
}

__device__ __forceinline__ float sigmoid(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// An activation as a compile-time tag: the epilogues are unrolled over a
// thread's accumulator entries, and a branch on the activation (or any
// other) inside them would split the unrolled code into blocks and expose
// each entry's whole latency.
template <int A>
using ActTag = std::integral_constant<int, A>;

template <typename F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case ACT_TANH: f(ActTag<ACT_TANH>{}); break;
    case ACT_RELU: f(ActTag<ACT_RELU>{}); break;
    case ACT_LRELU: f(ActTag<ACT_LRELU>{}); break;
    case ACT_SOFTPLUS: f(ActTag<ACT_SOFTPLUS>{}); break;
    case ACT_GELU: f(ActTag<ACT_GELU>{}); break;
    default: f(ActTag<ACT_TANH_APPROX>{});
  }
}

template <int A>
__device__ __forceinline__ float act_fn(float x) {
  if constexpr (A == ACT_TANH) return tanhf(x);
  else if constexpr (A == ACT_RELU) return x > 0.0f ? x : 0.0f;
  else if constexpr (A == ACT_LRELU) return x >= 0.0f ? x : 0.01f * x;
  else if constexpr (A == ACT_SOFTPLUS) return softplus(x);
  else if constexpr (A == ACT_GELU)
    return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  else return pade_tanh(x);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An exact tanh in fewer instructions than tanhf, from its argument scaled
// by 2 log2(e): tanh(x) = 1 - 2 / (2^a + 1) with a = kTwoLog2e x, where a
// caller folds the scale into the products that make x (and a bias b into
// an FMA: a = fma(acc, kTwoLog2e, kTwoLog2e b)). 2^a comes from MUFU.EX2,
// the reciprocal from MUFU.RCP. Over every f32 input it is within 2.4e-7 of
// f64 tanh (2.367e-7 at most on an H100); NaN gives NaN, +-inf +-1 (2^a
// overflows to inf or flushes to 0, and the form saturates).
constexpr float kTwoLog2e = 2.88539008f;  // 2 log2(e), 0x4038aa3b

// ex2.approx / rcp.approx with flush to zero: one MUFU instruction each
__device__ __forceinline__ float ex2_approx(float a) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}

__device__ __forceinline__ float rcp_approx(float a) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
  return y;
}

__device__ __forceinline__ float tanh_exp2(float a) {
  return fmaf(-2.0f, rcp_approx(ex2_approx(a) + 1.0f), 1.0f);
}

// Byte offset of (row, col) in a tiled bf16 matrix: 8x8 core matrices of
// 128 contiguous bytes (row-major inside), `rs` bytes from one row of cores
// to the next and 128 from one column of cores to the next.
__host__ __device__ __forceinline__ uint32_t tiled(int row, int col, int rs) {
  return (row >> 3) * rs + (col >> 3) * 128 + (row & 7) * 16 + (col & 7) * 2;
}

__device__ __forceinline__ void store_pair(uint8_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 load_pair(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor without swizzle: start address, the byte
// distance between core matrices along K (leading) and along M or N
// (stride), each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// shared-memory writes by threads become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the two halves of wgmma_commit_wait, for work between them
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// one float (4 bytes, through L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed cp.async groups are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier of one warpgroup (ids 1 and up; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// D (+)= A B for one warpgroup: m64 x nN x k16, bf16 operands from shared
// memory (TA, TB: 0 K-major, 1 MN-major), f32 accumulators in registers.
// Generated: one asm statement per N with its N / 2 accumulator registers.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int accumulate) {
  if constexpr (N == 16) wgmma_n16<TA, TB>(d, da, db, accumulate);
  else if constexpr (N == 32) wgmma_n32<TA, TB>(d, da, db, accumulate);
  else if constexpr (N == 64) wgmma_n64<TA, TB>(d, da, db, accumulate);
  else wgmma_n128<TA, TB>(d, da, db, accumulate);
}

// D = A B for one warpgroup, m64 x nN x k16, as wgmma with accumulate 0
// but with d written only: its old values are not an input, so they need
// no register while the accumulator is idle between products.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16_init(float (&d)[8], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32_init(float (&d)[16], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64_init(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_init(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (N == 16) wgmma_n16_init<TA, TB>(d, da, db);
  else if constexpr (N == 32) wgmma_n32_init<TA, TB>(d, da, db);
  else wgmma_n64_init<TA, TB>(d, da, db);
}

// -- thread-block clusters (the H = 256 kernels): a block's rank, a
//    location of this block's shared memory in another block of the
//    cluster, and the cluster's barrier in two halves
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// the shared::cluster address of shared::cta address `addr` in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// two floats as a bf16 pair, the bits of store_pair's value
__device__ __forceinline__ uint32_t pack_pair(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Every thread of every block of the cluster arrives (release: its earlier
// writes, remote ones too, are ordered before) and waits (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -- transaction barriers (mbarrier) and bulk copies between the blocks of
//    a cluster: a block writes its rows into its own shared memory, one
//    thread copies them into every other block (async proxy), and each
//    receiver waits on its own barrier for the bytes it expects
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the barriers' initialisation visible to the cluster's bulk copies
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this block's arrival on `bar`, expecting `bytes` more from the copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one arrival on the barrier at shared::cluster address `bar` (another
// block's)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// `bytes` (a multiple of 16) of this block's shared memory at `src` to the
// shared::cluster address `dst`, completing on the barrier `bar` there
__device__ __forceinline__ void bulk_to_rank(uint32_t dst, uint32_t src,
                                             int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk copies have read their sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// One warpgroup copies `bytes` (a multiple of 2 KB) into shared memory and
// makes them visible to its wgmma. Starts with a barrier, so no warp of the
// group still reads the buffer when it is overwritten.
__device__ __forceinline__ void load_panel(uint8_t* dst, const uint8_t* src,
                                           int bytes, int wtid, int wg) {
  wg_barrier(wg);
  for (int i = wtid * 16; i < bytes; i += 128 * 16) cp_async16(dst + i, src + i);
  cp_async_wait_all();
  fence_async_smem();
  wg_barrier(wg);
}

}  // namespace
