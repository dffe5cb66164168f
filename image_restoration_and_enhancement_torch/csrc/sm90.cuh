// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA and bulk copies into shared memory, named barriers, the wgmma fences
// and shared-memory descriptors, the wgmma operand-list macros, and the
// runtime lookup of cuTensorMapEncodeTiled.
//
// Included by attention.cu (K1, K5, K6), conv_int8.cu (K3) and groupnorm.cu
// (K2). Everything here sits in an unnamed namespace, so each translation
// unit keeps its own copy and the library links without duplicate symbols.
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
#define WG_R16 WG_S0 ", " WG_S1
#define WG_R32 WG_R16 ", " WG_S2 ", " WG_S3
#define WG_R64 WG_R32 ", " WG_S4 ", " WG_S5 ", " WG_S6 ", " WG_S7
#define WG_R96 WG_R64 ", " WG_S8 ", " WG_S9 ", " WG_S10 ", " WG_S11
#define WG_R128 WG_R96 ", " WG_S12 ", " WG_S13 ", " WG_S14 ", " WG_S15

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
