// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA and bulk copies into shared memory, named barriers, the wgmma fences,
// shared-memory descriptors and instruction wrappers (bf16 and s8), and the
// runtime lookup of cuTensorMapEncodeTiled.
//
// Included by attention.cu (K1, K4, K5, K6), conv_int8.cu (K3) and
// groupnorm.cu (K2). Everything here sits in an unnamed namespace, so each
// translation unit keeps its own copy and the library links without duplicate
// symbols.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes initialised mbarriers visible to the async proxy (TMA, bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates d, h, n, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int n, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(n), "r"(b)
      : "memory");
}

// One box of a 3-D tensor map (coordinates x, y, z) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// One box of a 2-D tensor map (coordinates x, y) into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned)
// from global into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor; offsets in bytes. layout: 1 = 128-byte
// swizzle, 2 = 64-byte swizzle (the tensor maps' CU_TENSOR_MAP_SWIZZLE_*).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = 1) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Operand lists of the wgmma instructions: WG_Sx names accumulator registers
// 8x .. 8x + 7; WG_Rn the first n.
#define WG_S0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_S1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_S2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define WG_S3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_S4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define WG_S5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_S6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define WG_S7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_S8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define WG_S9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define WG_S10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define WG_S11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define WG_S12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define WG_S13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define WG_S14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define WG_S15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define WG_R4 "%0, %1, %2, %3"
#define WG_R16 WG_S0 ", " WG_S1
#define WG_R32 WG_R16 ", " WG_S2 ", " WG_S3
#define WG_R64 WG_R32 ", " WG_S4 ", " WG_S5 ", " WG_S6 ", " WG_S7
#define WG_R96 WG_R64 ", " WG_S8 ", " WG_S9 ", " WG_S10 ", " WG_S11
#define WG_R128 WG_R96 ", " WG_S12 ", " WG_S13 ", " WG_S14 ", " WG_S15

// WG_F8 / WG_I8 bind eight accumulator registers as fp32 / s32 operands.
#define WG_F8(d, i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),              \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_C4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define WG_C16(d) WG_F8(d, 0), WG_F8(d, 8)
#define WG_C32(d) WG_C16(d), WG_F8(d, 16), WG_F8(d, 24)
#define WG_C64(d) WG_C32(d), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)
#define WG_C96(d) WG_C64(d), WG_F8(d, 64), WG_F8(d, 72), WG_F8(d, 80), WG_F8(d, 88)
#define WG_C128(d) WG_C96(d), WG_F8(d, 96), WG_F8(d, 104), WG_F8(d, 112), WG_F8(d, 120)
#define WG_I8(d, i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),              \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define WG_CI32(d) WG_I8(d, 0), WG_I8(d, 8), WG_I8(d, 16), WG_I8(d, 24)
#define WG_CI64(d) WG_CI32(d), WG_I8(d, 32), WG_I8(d, 40), WG_I8(d, 48), WG_I8(d, 56)
#define WG_CI80(d) WG_CI64(d), WG_I8(d, 64), WG_I8(d, 72)
#define WG_O8(d, i)                                                                       \
  "=r"(d[i]), "=r"(d[i + 1]), "=r"(d[i + 2]), "=r"(d[i + 3]), "=r"(d[i + 4]),              \
      "=r"(d[i + 5]), "=r"(d[i + 6]), "=r"(d[i + 7])
#define WG_CO32(d) WG_O8(d, 0), WG_O8(d, 8), WG_O8(d, 16), WG_O8(d, 24)
#define WG_CO64(d) WG_CO32(d), WG_O8(d, 32), WG_O8(d, 40), WG_O8(d, 48), WG_O8(d, 56)

// d (+)= A.B, m64nNk16, bf16 in, fp32 accumulate; A and B K-major in shared
// memory. acc = 0 overwrites d.
#define IRET_WGMMA_SS(N, REGS, CONS, A, B, C)                                            \
  __device__ __forceinline__ void wgmma_ss(float(&d)[N / 2], uint64_t da, uint64_t db,   \
                                           int acc) {                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #C ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS        \
                 "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"                               \
                 : CONS(d)                                                                \
                 : "l"(da), "l"(db), "r"(acc));                                           \
  }
IRET_WGMMA_SS(32, WG_R16, WG_C16, 16, 17, 18)
IRET_WGMMA_SS(64, WG_R32, WG_C32, 32, 33, 34)
IRET_WGMMA_SS(128, WG_R64, WG_C64, 64, 65, 66)

// d (+)= A.B, m64nNk16, bf16 in, fp32 accumulate; A from registers, B
// MN-major (transposed) in shared memory.
#define IRET_WGMMA_RS(N, REGS, CONS, A0, A1, A2, A3, B, C)                                \
  __device__ __forceinline__ void wgmma_rs(float(&d)[N / 2], const uint32_t(&a)[4],      \
                                           uint64_t db, int acc) {                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #C ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS        \
                 "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 1;\n}\n"    \
                 : CONS(d)                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));        \
  }
IRET_WGMMA_RS(8, WG_R4, WG_C4, 4, 5, 6, 7, 8, 9)
IRET_WGMMA_RS(64, WG_R32, WG_C32, 32, 33, 34, 35, 36, 37)
IRET_WGMMA_RS(128, WG_R64, WG_C64, 64, 65, 66, 67, 68, 69)
IRET_WGMMA_RS(192, WG_R96, WG_C96, 96, 97, 98, 99, 100, 101)
IRET_WGMMA_RS(256, WG_R128, WG_C128, 128, 129, 130, 131, 132, 133)

// d (+)= A.B, m64nNk32, s8 in, s32 accumulate (exact); A and B K-major in
// shared memory, the only layout s8 wgmma takes. acc = 0 overwrites d.
// wgmma_s8_first is the first k-step of a product: it overwrites d and does
// not read it, so d's registers hold nothing live before it.
#define IRET_WGMMA_S8(NAME, N, REGS, CONS, A, B, C)                                      \
  __device__ __forceinline__ void NAME(int(&d)[N / 2], uint64_t da, uint64_t db,         \
                                       int acc) {                                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #C ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" REGS            \
                 "}, %" #A ", %" #B ", p;\n}\n"                                           \
                 : CONS(d)                                                                \
                 : "l"(da), "l"(db), "r"(acc));                                           \
  }
IRET_WGMMA_S8(wgmma_s8, 64, WG_R32, WG_CI32, 32, 33, 34)
IRET_WGMMA_S8(wgmma_s8, 128, WG_R64, WG_CI64, 64, 65, 66)
IRET_WGMMA_S8(wgmma_s8, 160, WG_R64 ", " WG_S8 ", " WG_S9, WG_CI80, 80, 81, 82)
IRET_WGMMA_S8(wgmma_s8_overwrite, 64, WG_R32, WG_CO32, 32, 33, 34)
IRET_WGMMA_S8(wgmma_s8_overwrite, 128, WG_R64, WG_CO64, 64, 65, 66)

template <int N>
__device__ __forceinline__ void wgmma_s8_first(int (&d)[N], uint64_t da, uint64_t db) {
  wgmma_s8_overwrite(d, da, db, 0);
}

// Keep the compiler from moving reads and writes of registers that an
// asynchronous wgmma owns across the instruction.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda).
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

}  // namespace
