// K2 — GroupNorm over NHWC with an optional fused SiLU, for the PyTorch port.
//
// Replaces: image_restoration_and_enhancement_tpu/ops/groupnorm.py _kernel
//   (called from _pallas_group_norm / group_norm).
// Computes the function of _reference_group_norm there: per-channel fp32 sum
// and sum of squares, combined per group; var = E[x^2] - E[x]^2 clamped at 0;
// rstd = rsqrt(var + eps); the affine folded into y = x * w + b per channel;
// optional SiLU; y written in the input dtype.
//
// What bounds it on the H100: a handful of operations per element against
// reading x once and writing y once, so the bound is memory bytes. The TPU
// kernel holds one sample's whole (H*W, C) tensor in VMEM; the VAE's
// [1, 512, 512, 128] and [1, 256, 256, 512] activations exceed that budget, and
// one block per (batch, group) would leave most of the card's 132 SMs idle. So
// the reduction is split over a grid of row chunks:
//   pass 1 (stats):    one block per (chunk of rows, batch) writes fp32
//                      per-channel partial sums and sums of squares;
//   pass 2 (finalize): one block per (group, batch) combines the partials and
//                      writes the folded per-channel (w, b);
//   pass 3 (apply):    an elementwise grid-stride pass y = x * w + b (+ SiLU).
// x is read twice (pass 1 and 3); at these sizes the second read often comes
// from the 50 MB L2. Partial sums go through device memory in a fixed order, so
// the result does not depend on scheduling (no atomics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStatThreads = 128;
constexpr int kFinalizeThreads = 256;  // a power of two (tree reduction)
constexpr int kApplyThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// partial: [B, chunks, C, 2] (sum, sum of squares) over the chunk's rows. A
// thread owns one channel at a time and walks the chunk's rows, so a warp reads
// 32 neighbouring channels of a row and no block-level reduction is needed.
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int HW,
                int C, int chunks, int rows_per_chunk) {
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  const T* xb = x + (int64_t)b * HW * C;
  float* pb = partial + ((int64_t)b * chunks + chunk) * C * 2;
  for (int c = threadIdx.x; c < C; c += kStatThreads) {
    float s = 0.f, ss = 0.f;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float val = to_f(xb[(int64_t)r * C + c]);
      s += val;
      ss = fmaf(val, val, ss);
    }
    pb[c * 2] = s;
    pb[c * 2 + 1] = ss;
  }
}

// One block per (group, batch): a fixed-order tree reduction of the group's
// partials, then the folded per-channel (w, b) of y = x * w + b into
// wb: [B, C, 2]. W is the type of scale and bias (float or bf16).
template <typename W>
__global__ void __launch_bounds__(kFinalizeThreads)
gn_finalize_kernel(const float* __restrict__ partial, const W* __restrict__ scale,
                   const W* __restrict__ bias, float* __restrict__ wb,
                   int HW, int C, int G, int chunks, float eps) {
  __shared__ float red_s[kFinalizeThreads];
  __shared__ float red_ss[kFinalizeThreads];
  __shared__ float stat[2];  // mean, rstd
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int gc = C / G;
  const float* pb = partial + (int64_t)b * chunks * C * 2 + (int64_t)g * gc * 2;
  float s = 0.f, ss = 0.f;
  for (int i = tid; i < chunks * gc; i += kFinalizeThreads) {
    const int ch = i / gc;
    const float* p = pb + ((int64_t)ch * C + (i - ch * gc)) * 2;
    s += p[0];
    ss += p[1];
  }
  red_s[tid] = s;
  red_ss[tid] = ss;
  __syncthreads();
  for (int off = kFinalizeThreads / 2; off > 0; off >>= 1) {
    if (tid < off) {
      red_s[tid] += red_s[tid + off];
      red_ss[tid] += red_ss[tid + off];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float count = (float)HW * (float)gc;
    const float mean = red_s[0] / count;
    // E[x^2] - E[x]^2 can cancel below zero in fp32 at a large mean/std ratio.
    const float var = fmaxf(red_ss[0] / count - mean * mean, 0.f);
    stat[0] = mean;
    stat[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int j = tid; j < gc; j += kFinalizeThreads) {
    const int c = g * gc + j;
    const float w = stat[1] * to_f(scale[c]);
    wb[((int64_t)b * C + c) * 2] = w;
    wb[((int64_t)b * C + c) * 2 + 1] = to_f(bias[c]) - stat[0] * w;
  }
}

// Index is uint32_t whenever the tensor has fewer than 2^31 elements (every SD
// shape), which keeps the per-element division and modulo cheap.
template <typename T, bool kSilu, typename Index>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ wb,
                T* __restrict__ y, Index total, Index per_batch, Index C) {
  const Index stride = (Index)gridDim.x * blockDim.x;
  for (Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const Index b = i / per_batch;
    const Index c = i % C;
    const float* p = wb + (b * C + c) * 2;
    float val = fmaf(to_f(x[i]), p[0], p[1]);
    if (kSilu) val = val / (1.f + expf(-val));
    y[i] = from_f<T>(val);
  }
}

template <typename T, bool kSilu>
void apply(const T* x, const float* wb, T* y, int64_t total, int64_t per_batch,
           int C, cudaStream_t stream) {
  int64_t blocks = (total + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (total < ((int64_t)1 << 31))
    gn_apply_kernel<T, kSilu, uint32_t><<<(int)blocks, kApplyThreads, 0, stream>>>(
        x, wb, y, (uint32_t)total, (uint32_t)per_batch, (uint32_t)C);
  else
    gn_apply_kernel<T, kSilu, int64_t><<<(int)blocks, kApplyThreads, 0, stream>>>(
        x, wb, y, total, per_batch, (int64_t)C);
}

template <typename T>
cudaError_t run(const void* xv, int wdtype, const void* scale, const void* bias,
                void* yv, float* partial, float* wb, int B, int HW, int C, int G,
                int chunks, int rows_per_chunk, float eps, int silu,
                cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  gn_stats_kernel<T><<<dim3(chunks, B), kStatThreads, 0, stream>>>(
      x, partial, HW, C, chunks, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (wdtype == 0)
    gn_finalize_kernel<float><<<dim3(G, B), kFinalizeThreads, 0, stream>>>(
        partial, static_cast<const float*>(scale), static_cast<const float*>(bias), wb,
        HW, C, G, chunks, eps);
  else
    gn_finalize_kernel<__nv_bfloat16><<<dim3(G, B), kFinalizeThreads, 0, stream>>>(
        partial, static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(bias), wb, HW, C, G, chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t per_batch = (int64_t)HW * C;
  if (silu)
    apply<T, true>(x, wb, y, per_batch * B, per_batch, C, stream);
  else
    apply<T, false>(x, wb, y, per_batch * B, per_batch, C, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x and y) and wdtype (of scale and bias): 0 = float32, 1 = bfloat16.
// x and y are contiguous [B, HW, C]; scale and bias are [C]; partial is fp32
// scratch [B, chunks, C, 2] and wb fp32 scratch [B, C, 2], both allocated by
// the caller. Rows [k * rows_per_chunk, (k + 1) * rows_per_chunk) form chunk k.
int iret_group_norm(int dtype, int wdtype, const void* x, const void* scale,
                    const void* bias, void* y, void* partial, void* wb, int B,
                    int HW, int C, int G, int chunks, int rows_per_chunk,
                    float eps, int silu, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || chunks <= 0 ||
      rows_per_chunk <= 0 || (int64_t)chunks * rows_per_chunk < HW ||
      (wdtype != 0 && wdtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partial);
  float* w = static_cast<float*>(wb);
  if (dtype == 0)
    return run<float>(x, wdtype, scale, bias, y, pa, w, B, HW, C, G, chunks,
                      rows_per_chunk, eps, silu, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wdtype, scale, bias, y, pa, w, B, HW, C, G, chunks,
                              rows_per_chunk, eps, silu, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
