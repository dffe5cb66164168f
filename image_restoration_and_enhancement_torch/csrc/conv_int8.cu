// K3 — implicit-GEMM int8 3x3 stride-1 SAME convolution for the PyTorch port.
//
// Replaces: image_restoration_and_enhancement_tpu/ops/conv_int8.py _kernel
//   (called from conv3x3_same_int8).
// Computes, for a pre-padded s8 input x [B, H+2, W+2, C], an s8 weight
// w [N, 3, 3, C] and an fp32 scale [N]:
//   out[b, y, x, n] = float(sum_{dy, dx, c} x[b, y+dy, x+dx, c] * w[n, dy, dx, c]) * scale[n]
// with the sum in int32 (exact) and out in fp32 or bf16, [B, H, W, N].
//
// As a GEMM: M = B*H*W output pixels, N output channels, K = 9*C taps. What
// bounds it on the H100: at the UNet's widths (C, N = 320..2560) it does
// 2*M*N*9*C operations against about M*C + 9*C*N + 2*M*N bytes, hundreds of
// operations per byte, so the bound is the s8 tensor-core rate. So the kernel
// runs on the tensor cores with mma.sync m16n8k32 (s8 in, s32 accumulate) and
// keeps every tile in shared memory through a 3-stage cp.async pipeline.
//
// The TPU kernel flattens the padded image so that each tap of an output row
// block is one contiguous input row range (computing two garbage columns per
// image row), and DMAs a [tile_m + halo, C] window per tile. Here each output
// pixel keeps its own input address instead: a thread computes the padded
// address of its pixel once per block, and tap (dy, dx) adds (dy*(W+2)+dx)*C.
// So no output is computed twice and the input needs no extra padding; the
// 1-pixel border of x makes the edges need no mask.
//
// Tiling: a block of 8 warps computes a 128 x 128 output tile; warp (wm, wn)
// owns 64 x 32 of it (4 x 4 m16n8 accumulators). K advances 64 bytes a stage:
// two 32-channel chunks, each (tap, c0) with c0 a multiple of 32; channels
// past C are zero-filled by cp.async, so C need only be a multiple of 8 (the
// copy width: 16 bytes when C % 16 == 0, else 8). Fragments are read from
// shared memory with 32-bit loads; rows are padded to 80 bytes so the eight
// rows a load touches fall in eight different bank groups. The epilogue
// converts each int32 sum to fp32 (round to nearest, as XLA's convert does),
// multiplies by scale[n] and writes the output dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;           // bytes of K per stage: two 32-channel chunks
constexpr int kChunk = 32;
constexpr int kRow = kBK + 16;    // shared-memory row stride in bytes
constexpr int kStages = 3;
constexpr int kSmemBytes = kStages * (kBM + kBN) * kRow;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// VEC bytes global -> shared, zero-filled when !valid (src then unread).
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(addr),
                 "l"(src), "r"(valid ? 8 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b, bool second);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b, bool second) {
  p[0] = a;
  if (second) p[1] = b;
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b,
                                                      bool second) {
  p[0] = __float2bfloat16(a);
  if (second) p[1] = __float2bfloat16(b);
}

template <typename OutT, int VEC>
__global__ void __launch_bounds__(kThreads)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, OutT* __restrict__ out,
                    int H, int W, int C, int N, int M) {
  constexpr int PPR = kBK / VEC;                 // copies per tile row and stage
  constexpr int PER = kBM * PPR / kThreads;      // copies per thread per tile
  static_assert(kBM == kBN, "A and B tiles share the copy layout");
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                             // kStages x [kBM][kRow]
  int8_t* Bs = smem + kStages * kBM * kRow;      // kStages x [kBN][kRow]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;   // 0..1: 64-row half of the tile
  const int wn = warp & 3;    // 0..3: 32-column quarter
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int Wp = W + 2;
  const int cpt = (C + kChunk - 1) / kChunk;     // chunks per tap
  const int nchunks = 9 * cpt;
  const int niters = (nchunks + 1) / 2;
  const int64_t K = 9LL * C;

  // This thread's copies: the same (row, byte) slots in every stage.
  int64_t a_base[PER];   // padded-input offset of the row's output pixel, -1 past M
  int64_t b_base[PER];   // weight offset of the row's output channel, -1 past N
  int slot[PER];         // byte offset in the stage's 64-byte row
  int row[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * kThreads;
    row[j] = i / PPR;
    slot[j] = (i - row[j] * PPR) * VEC;
    const int m = m0 + row[j];
    if (m < M) {
      const int hw = H * W;
      const int b = m / hw;
      const int r = m - b * hw;
      const int y = r / W;
      const int xx = r - y * W;
      a_base[j] = (((int64_t)b * (H + 2) + y) * Wp + xx) * C;
    } else {
      a_base[j] = -1;
    }
    const int n = n0 + row[j];
    b_base[j] = n < N ? (int64_t)n * K : -1;
  }

  auto load_stage = [&](int buf, int it) {
    int8_t* as = As + buf * kBM * kRow;
    int8_t* bs = Bs + buf * kBN * kRow;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int q = it * 2 + slot[j] / kChunk;   // global chunk index
      const int cc = slot[j] % kChunk;
      const int tap = q / cpt;
      const int c = (q - tap * cpt) * kChunk + cc;
      const bool kvalid = q < nchunks && c < C;
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      const int64_t xoff = (int64_t)(dy * Wp + dx) * C + c;
      const int64_t woff = (int64_t)tap * C + c;
      const bool av = kvalid && a_base[j] >= 0;
      const bool bv = kvalid && b_base[j] >= 0;
      cp_async<VEC>(as + row[j] * kRow + slot[j], av ? x + a_base[j] + xoff : x, av);
      cp_async<VEC>(bs + row[j] * kRow + slot[j], bv ? w + b_base[j] + woff : w, bv);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < niters) load_stage(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < niters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage `it` has landed; every warp is done with it - 1
    const int nxt = it + kStages - 1;
    if (nxt < niters) load_stage(nxt % kStages, nxt);
    cp_async_commit();

    const int8_t* as = As + (it % kStages) * kBM * kRow + (wm * 64) * kRow;
    const int8_t* bs = Bs + (it % kStages) * kBN * kRow + (wn * 32) * kRow;
#pragma unroll
    for (int ks = 0; ks < kBK / kChunk; ++ks) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = as + (mi * 16 + g) * kRow + ks * kChunk + t * 4;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * kRow);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = bs + (ni * 8 + g) * kRow + ks * kChunk + t * 4;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + t * 2;
    if (n >= N) continue;
    const bool second = n + 1 < N;
    const float s0 = scale[n];
    const float s1 = second ? scale[n + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = m0 + wm * 64 + mi * 16 + g;
      if (m < M)
        store2<OutT>(out + (int64_t)m * N + n, (float)acc[mi][ni][0] * s0,
                     (float)acc[mi][ni][1] * s1, second);
      if (m + 8 < M)
        store2<OutT>(out + (int64_t)(m + 8) * N + n, (float)acc[mi][ni][2] * s0,
                     (float)acc[mi][ni][3] * s1, second);
    }
  }
}

template <typename OutT, int VEC>
cudaError_t launch(const void* x, const void* w, const float* scale, void* out, int B,
                   int H, int W, int C, int N, cudaStream_t stream) {
  auto kernel = conv3x3_int8_kernel<OutT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<OutT*>(out), H, W, C, N, M);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const void* x, const void* w, const float* scale, void* out, int B,
                     int H, int W, int C, int N, cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  if (C % 16 == 0 && align % 16 == 0)
    return launch<OutT, 16>(x, w, scale, out, B, H, W, C, N, stream);
  if (C % 8 == 0 && align % 8 == 0)
    return launch<OutT, 8>(x, w, scale, out, B, H, W, C, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = bfloat16. x is a contiguous [B, H+2, W+2, C] s8,
// w a contiguous [N, 3, 3, C] s8, scale a contiguous [N] fp32, out a
// contiguous [B, H, W, N]. C must be a multiple of 8.
int iret_conv3x3_int8(int out_dtype, const void* x, const void* w, const void* scale,
                      void* out, int B, int H, int W, int C, int N, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0) return cudaErrorInvalidValue;
  if ((int64_t)B * H * W >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (out_dtype == 0) return dispatch<float>(x, w, sc, out, B, H, W, C, N, s);
  if (out_dtype == 1) return dispatch<__nv_bfloat16>(x, w, sc, out, B, H, W, C, N, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
