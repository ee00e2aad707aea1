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
// -DPVT_PROFILE_PHASES: thread 0 of block 0 adds the cycles since its
// previous mark to the phase that a mark closes. Mark 0 closes the loop's
// own overhead, mark k > 0 the k-th "// --" phase of the loop body.
// PVT_PHASE_READER(name) defines the C entry point that reads them.
#ifdef PVT_PROFILE_PHASES
constexpr int kPhaseMarks = 8;
__device__ long long g_phase_cycles[kPhaseMarks];
#define PHASE_CLOCK long long phase_last_ = -1
#define PHASE_MARK(k)                                                 \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                        \
      const long long now_ = clock64();                               \
      if (phase_last_ >= 0) g_phase_cycles[k] += now_ - phase_last_;  \
      phase_last_ = now_;                                             \
    }                                                                 \
  } while (0)
// The phase cycles since the last reset (reset != 0 zeroes them instead):
// out[kPhaseMarks]. Returns a cudaError_t.
#define PVT_PHASE_READER(name)                                            \
  extern "C" int name(long long* out, int reset) {                        \
    if (reset) {                                                          \
      const long long zero[kPhaseMarks] = {};                             \
      return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)); \
    }                                                                     \
    return (int)cudaMemcpyFromSymbol(out, g_phase_cycles,                 \
                                     sizeof(g_phase_cycles));             \
  }
#else
#define PHASE_CLOCK do {} while (0)
#define PHASE_MARK(k) do {} while (0)
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
