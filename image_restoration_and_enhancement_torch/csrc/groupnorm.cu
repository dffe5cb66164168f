// K2 — GroupNorm over NHWC with an optional fused SiLU, for the PyTorch port.
//
// Replaces: image_restoration_and_enhancement_tpu/ops/groupnorm.py _kernel
//   (called from _pallas_group_norm / group_norm).
// Computes the function of _reference_group_norm there: per-channel fp32 sum
// and sum of squares, combined per group; var = E[x^2] - E[x]^2 clamped at 0;
// rstd = 1 / sqrt(var + eps); the affine folded into y = x * w + b per channel
// (w = rstd * scale, b = bias - mean * w, each product and sum rounded as the
// plain version rounds it); optional SiLU y / (1 + exp(-y)) (fast exponential
// and divide, see fast_silu()); y written in the input dtype.
//
// What bounds it on the H100: a handful of operations per element against
// reading x once and writing y once, so the bound is memory bytes. The TPU
// kernel holds one sample's whole (H*W, C) tensor in VMEM and reads it once.
// The card's 132 SMs hold 132 x 227 KB of shared memory, about 30 MB, and every
// UNet GroupNorm at batch 2 fits in that (the largest, 2x64x64x960 bf16, is
// 15.7 MB), so the same one-read design is had here by spreading a sample over
// many blocks, each holding its slab of rows on chip. Two paths, chosen by
// ops/groupnorm.py's plan() and passed in; the entry refuses a path its
// arguments cannot take and never picks another itself:
//
// - kOnchip (one launch): a block per (slab of rows_per_block rows, sample).
//   One thread pulls the slab (contiguous rows x C) into shared memory with
//   bulk copies on one mbarrier. The block takes per-channel fp32 sums and
//   sums of squares of its rows, combines them per group in channel order, and
//   writes one (sum, sum of squares) pair per group to a partials buffer. One
//   grid-wide barrier; then every block reduces its sample's partials over the
//   blocks in a fixed order, folds the affine per channel and writes y from the
//   slab it kept, with 16-byte stores. x is read from HBM once, y written once.
//   The exchange is a cooperative launch (cudaLaunchCooperativeKernel) with one
//   grid barrier, not a thread-block cluster: a cluster holds at most 16 CTAs,
//   about 3.6 MB, less than one sample of the largest UNet norm, so a cluster
//   would have to split the channels into group-aligned slabs (a 240-byte slab
//   of each 1920-byte row at C = 960) and read x with strided rows; whole rows
//   keep every copy and store contiguous, and the blocks of a sample need no
//   scheduling on neighbouring SMs. The cooperative launch guarantees that all
//   blocks are resident, which the barrier needs (at most one block per SM).
// - kTwoPhase (two launches), for shapes whose slabs exceed shared memory (the
//   VAE's 1x512x512x{128,256} and 1x256x256x{256,512}): a stats kernel over
//   about two blocks an SM writes the same per-group partials from 16-byte
//   loads; then an apply kernel over the same slabs reduces its sample's
//   partials in the same fixed order (the finalize is folded into it) and
//   writes y from a second read of x.
//
// Height-sharded GroupNorm (parallel/spatial.py in the port) runs the twophase
// kernels as two entries of their own, with the partials in a tensor the
// caller owns: iret_group_norm_stats writes a shard's [B][blocks][G] pairs;
// the caller all-gathers the shards' partials into [B][P][G] in (rank, block)
// order; iret_group_norm_apply reduces those P partials in the same fixed order
// as the unsharded apply reduces its blocks, with the global element count
// H_global * W * C / G, and writes y from the shard's x.
//
// A thread owns one 16-byte vector of channels (8 bf16 or 4 fp32) and walks
// every rsplit-th row of the slab, so no index is divided per element and a
// warp reads or writes contiguous bytes. A vector may straddle two groups
// (gc = C/32 is 10, 30 or 60 in the UNet), so sums stay per channel until the
// block has reduced its rows, as the TPU kernel keeps them (its one-hot cmap).
// Every reduction runs in a fixed order (no atomics), so the result does not
// depend on scheduling.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChannels = 4096;
constexpr int kMaxGroups = 128;
// Per-channel (sum, sum of squares) of each row slice: rsplit x C float2, at
// most kThreads vectors of 8 channels (or C <= kMaxChannels at one slice).
constexpr int kRedBytes = kThreads * 8 * 8;
static_assert(kRedBytes >= kMaxChannels * 8, "reduction buffer");
// A slab's bytes on the onchip path (ops/groupnorm.py ONCHIP_SLAB_BYTES).
constexpr int kMaxSlabBytes = 192 * 1024;
constexpr int kCopyChunk = 32 * 1024;
// (sum, sum of squares) per (block, group) of one launch, in one buffer per
// device: launches that use it must be ordered, as on one stream (the port
// issues every kernel on PyTorch's current stream).
constexpr int kMaxPartials = 1 << 16;
__device__ float2 g_partials[kMaxPartials];

enum Path { kOnchip = 0, kTwoPhase = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of T as floats, and back.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// The thread's place in a slab walk: vector column v0 (then v0 + kThreads, ...
// when a row has more vectors than the block has threads) and row slice rs of
// rsplit; rs >= rsplit leaves the thread idle.
struct Walk {
  int nvec, rsplit, rs, v0;
  __device__ __forceinline__ Walk(int C, int vec) {
    nvec = C / vec;
    rsplit = max(1, kThreads / nvec);
    rs = threadIdx.x / nvec;
    v0 = threadIdx.x - rs * nvec;
  }
};

// Per-channel (sum, sum of squares) of the slab's `rows` rows into red[0 .. C),
// each a fixed-order sum over the row slices. load(r, v) gives vector v of row r.
template <typename T, typename Load>
__device__ __forceinline__ void channel_sums(Load load, int rows, int C, float2* red) {
  constexpr int VE = Vec<T>::N;
  const Walk wk(C, VE);
  if (wk.rs < wk.rsplit) {
    for (int v = wk.v0; v < wk.nvec; v += kThreads) {
      float s[VE], ss[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) s[e] = ss[e] = 0.f;
#pragma unroll 4
      for (int r = wk.rs; r < rows; r += wk.rsplit) {
        float f[VE];
        Vec<T>::unpack(load(r, v), f);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          s[e] += f[e];
          ss[e] = fmaf(f[e], f[e], ss[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) red[wk.rs * C + v * VE + e] = make_float2(s[e], ss[e]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float2 a = red[c];
    for (int i = 1; i < wk.rsplit; ++i) {
      const float2 p = red[i * C + c];
      a.x += p.x;
      a.y += p.y;
    }
    red[c] = a;
  }
  __syncthreads();
}

// The block's per-group pair: a warp per group, lane l summing the group's
// channels l, l + 32, ... in order, then a butterfly over the 32 lanes.
__device__ __forceinline__ void group_partials(const float2* red, int C, int G,
                                               float2* __restrict__ out) {
  const int gc = C / G;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < G; g += kThreads / 32) {
    float2 a = make_float2(0.f, 0.f);
    for (int j = lane; j < gc; j += 32) {
      const float2 p = red[g * gc + j];
      a.x += p.x;
      a.y += p.y;
    }
    for (int off = 16; off > 0; off >>= 1) {
      a.x += __shfl_xor_sync(0xFFFFFFFFu, a.x, off);
      a.y += __shfl_xor_sync(0xFFFFFFFFu, a.y, off);
    }
    if (lane == 0) out[g] = a;
  }
}

// The thread's channels c = threadIdx.x + k * kThreads of scale and bias,
// loaded ahead of the partials (onchip: before the grid barrier), so their
// latency is not paid after it. W is the type of scale and bias.
constexpr int kAffinePerThread = kMaxChannels / kThreads;
struct Affine {
  float scale[kAffinePerThread], bias[kAffinePerThread];
};

template <typename W>
__device__ __forceinline__ Affine load_affine(const W* __restrict__ scale,
                                              const W* __restrict__ bias, int C) {
  Affine a;
#pragma unroll
  for (int k = 0; k < kAffinePerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    a.scale[k] = c < C ? to_f(scale[c]) : 0.f;
    a.bias[k] = c < C ? to_f(bias[c]) : 0.f;
  }
  return a;
}

// Reduces one sample's partials [nblocks][G] over its blocks in a fixed order
// (lane l of a group's L lanes sums blocks l, l + L, ... in order, its loads
// issued kBatch at a time; then a butterfly over the L lanes), and writes the
// per-channel (w, b) of y = x * w + b into wb[C].
__device__ __forceinline__ void fold_affine(const float2* __restrict__ part, int nblocks, int C,
                                            int G, float count, float eps, const Affine& af,
                                            float2* wb, float2* stat) {
  constexpr int kBatch = 8;
  int L = 1;
  while (L < 32 && 2 * L * G <= kThreads) L *= 2;
  const int g = threadIdx.x / L;
  const int l = threadIdx.x - g * L;
  float2 a = make_float2(0.f, 0.f);
  if (g < G) {
    for (int i0 = l; i0 < nblocks; i0 += kBatch * L) {
      float2 p[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + k * L;
        p[k] = i < nblocks ? __ldcg(&part[i * G + g]) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        a.x += p[k].x;
        a.y += p[k].y;
      }
    }
  }
  for (int off = L / 2; off > 0; off >>= 1) {
    a.x += __shfl_xor_sync(0xFFFFFFFFu, a.x, off);
    a.y += __shfl_xor_sync(0xFFFFFFFFu, a.y, off);
  }
  if (g < G && l == 0) {
    const float mean = __fdiv_rn(a.x, count);
    // E[x^2] - E[x]^2 can cancel below zero in fp32 at a large mean/std ratio.
    const float var = fmaxf(__fsub_rn(__fdiv_rn(a.y, count), __fmul_rn(mean, mean)), 0.f);
    stat[g] = make_float2(mean, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps))));
  }
  __syncthreads();
  const int gc = C / G;
#pragma unroll
  for (int k = 0; k < kAffinePerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < C) {
      const float2 st = stat[c / gc];
      const float w = __fmul_rn(st.y, af.scale[k]);
      wb[c] = make_float2(w, __fsub_rn(af.bias[k], __fmul_rn(st.x, w)));
    }
  }
  __syncthreads();
}

// y / (1 + exp(-y)) with the MUFU exponential and reciprocal (a few fp32 ulps
// from the correctly rounded value, far inside the "group_norm" limit and
// below one bf16 step). With expf and an IEEE division the SiLU took most of
// the kernel's time: ~40 instructions an element against the slab's ~10 of
// loads, sums and stores. y below -88 gives exp(-y) = inf and -0, as silu's
// true value rounds to in either output dtype.
__device__ __forceinline__ float fast_silu(float y) { return __fdividef(y, 1.f + __expf(-y)); }

// y rows of the slab from its x rows (load(r, v) as in channel_sums).
template <typename T, bool kSilu, typename Load>
__device__ __forceinline__ void apply_rows(Load load, T* __restrict__ y, int rows, int C,
                                           const float2* wb) {
  constexpr int VE = Vec<T>::N;
  const Walk wk(C, VE);
  if (wk.rs >= wk.rsplit) return;
  for (int v = wk.v0; v < wk.nvec; v += kThreads) {
    float w[VE], b[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float2 p = wb[v * VE + e];
      w[e] = p.x;
      b[e] = p.y;
    }
#pragma unroll 4
    for (int r = wk.rs; r < rows; r += wk.rsplit) {
      float f[VE];
      Vec<T>::unpack(load(r, v), f);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float val = __fadd_rn(__fmul_rn(f[e], w[e]), b[e]);
        f[e] = kSilu ? fast_silu(val) : val;
      }
      *reinterpret_cast<uint4*>(y + (int64_t)r * C + v * VE) = Vec<T>::pack(f);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 load_global(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Dynamic shared memory: the reduction buffer (kRedBytes, reused for the
// per-channel (w, b)), then the slab.
template <typename T, typename W, bool kSilu>
__global__ void __launch_bounds__(kThreads, 1)
gn_onchip_kernel(const T* __restrict__ x, const W* __restrict__ scale,
                 const W* __restrict__ bias, T* __restrict__ y, int HW, int C, int G,
                 int rows_per_block, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float2 stat[kMaxGroups];
  float2* red = reinterpret_cast<float2*>(smem);
  const T* xs = reinterpret_cast<const T*>(smem + kRedBytes);
  const int nblocks = gridDim.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, HW - r0);
  const int64_t off = ((int64_t)b * HW + r0) * C;
  const uint32_t barp = smem_u32(&bar);
  if (threadIdx.x == 0) {
    mbar_init(barp, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)rows * C * sizeof(T);
    const uint32_t dst = smem_u32(xs);
    const char* src = reinterpret_cast<const char*>(x + off);
    mbar_expect_tx(barp, bytes);
    for (uint32_t o = 0; o < bytes; o += kCopyChunk)
      bulk_load(dst + o, src + o, min((uint32_t)kCopyChunk, bytes - o), barp);
  }
  mbar_wait(barp, 0);
  constexpr int VE = Vec<T>::N;
  auto from_smem = [&](int r, int v) {
    return *reinterpret_cast<const uint4*>(xs + r * C + v * VE);
  };
  channel_sums<T>(from_smem, rows, C, red);
  group_partials(red, C, G, g_partials + ((int64_t)b * nblocks + blockIdx.x) * G);
  const Affine af = load_affine(scale, bias, C);
  cg::this_grid().sync();
  fold_affine(g_partials + (int64_t)b * nblocks * G, nblocks, C, G, (float)HW * (C / G), eps,
              af, red, stat);
  apply_rows<T, kSilu>(from_smem, y + off, rows, C, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float2* part, int HW, int C, int G,
                int rows_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  float2* red = reinterpret_cast<float2*>(smem);
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, HW - r0);
  const T* xb = x + ((int64_t)b * HW + r0) * C;
  constexpr int VE = Vec<T>::N;
  channel_sums<T>([&](int r, int v) { return load_global(xb + (int64_t)r * C + v * VE); },
                  rows, C, red);
  group_partials(red, C, G,
                 (part ? part : g_partials) + ((int64_t)b * gridDim.x + blockIdx.x) * G);
}

template <typename T, typename W, bool kSilu>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const W* __restrict__ scale,
                const W* __restrict__ bias, const float2* part, int nparts,
                T* __restrict__ y, int HW, int C, int G, int rows_per_block, float count,
                float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 stat[kMaxGroups];
  float2* wb = reinterpret_cast<float2*>(smem);
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, HW - r0);
  const int64_t off = ((int64_t)b * HW + r0) * C;
  fold_affine((part ? part : g_partials) + (int64_t)b * nparts * G, nparts, C, G, count, eps,
              load_affine(scale, bias, C), wb, stat);
  const T* xb = x + off;
  constexpr int VE = Vec<T>::N;
  apply_rows<T, kSilu>([&](int r, int v) { return load_global(xb + (int64_t)r * C + v * VE); },
                       y + off, rows, C, wb);
}

template <typename T, typename W, bool kSilu>
cudaError_t launch(int path, const void* xv, const void* sv, const void* bv, void* yv, int B,
                   int HW, int C, int G, int rows_per_block, float eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const W* scale = static_cast<const W*>(sv);
  const W* bias = static_cast<const W*>(bv);
  T* y = static_cast<T*>(yv);
  const dim3 grid((HW + rows_per_block - 1) / rows_per_block, B);
  if (path == kOnchip) {
    auto kernel = gn_onchip_kernel<T, W, kSilu>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRedBytes + kMaxSlabBytes);
    if (attr != cudaSuccess) return attr;
    const size_t smem = kRedBytes + (size_t)rows_per_block * C * sizeof(T);
    void* args[] = {&x, &scale, &bias, &y, &HW, &C, &G, &rows_per_block, &eps};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                       dim3(kThreads), args, smem, stream);
  }
  // nullptr: the kernels use the file-scope g_partials
  gn_stats_kernel<T><<<grid, kThreads, kRedBytes, stream>>>(x, nullptr, HW, C, G,
                                                            rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T, W, kSilu><<<grid, kThreads, C * sizeof(float2), stream>>>(
      x, scale, bias, nullptr, grid.x, y, HW, C, G, rows_per_block, (float)HW * (C / G), eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t dispatch_silu(int path, const void* x, const void* s, const void* b, void* y, int B,
                          int HW, int C, int G, int rows, float eps, int silu,
                          cudaStream_t stream) {
  if (silu) return launch<T, W, true>(path, x, s, b, y, B, HW, C, G, rows, eps, stream);
  return launch<T, W, false>(path, x, s, b, y, B, HW, C, G, rows, eps, stream);
}

template <typename T>
cudaError_t dispatch(int wdtype, int path, const void* x, const void* s, const void* b, void* y,
                     int B, int HW, int C, int G, int rows, float eps, int silu,
                     cudaStream_t stream) {
  if (wdtype == 0)
    return dispatch_silu<T, float>(path, x, s, b, y, B, HW, C, G, rows, eps, silu, stream);
  return dispatch_silu<T, __nv_bfloat16>(path, x, s, b, y, B, HW, C, G, rows, eps, silu,
                                         stream);
}

// Arguments both sharded entries check (x as in iret_group_norm).
bool sharded_args_ok(int dtype, const void* x, int B, int HW, int C, int G, int rows) {
  const int elt = dtype == 0 ? 4 : 2;
  return B > 0 && HW > 0 && C > 0 && G > 0 && G <= kMaxGroups && C <= kMaxChannels &&
         C % G == 0 && (C * elt) % 16 == 0 && rows > 0 && (dtype == 0 || dtype == 1) &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         (int64_t)B * ((HW + rows - 1) / rows) <= 65535LL * 65535LL;
}

template <typename T, typename W>
cudaError_t launch_apply(const void* x, const void* s, const void* b, const float2* part,
                         int nparts, void* y, int B, int HW, int C, int G, int rows,
                         float count, float eps, int silu, cudaStream_t stream) {
  const dim3 grid((HW + rows - 1) / rows, B);
  const size_t smem = C * sizeof(float2);
  const T* xt = static_cast<const T*>(x);
  const W* st = static_cast<const W*>(s);
  const W* bt = static_cast<const W*>(b);
  T* yt = static_cast<T*>(y);
  if (silu)
    gn_apply_kernel<T, W, true><<<grid, kThreads, smem, stream>>>(
        xt, st, bt, part, nparts, yt, HW, C, G, rows, count, eps);
  else
    gn_apply_kernel<T, W, false><<<grid, kThreads, smem, stream>>>(
        xt, st, bt, part, nparts, yt, HW, C, G, rows, count, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_apply(int wdtype, const void* x, const void* s, const void* b,
                           const float2* part, int nparts, void* y, int B, int HW, int C,
                           int G, int rows, float count, float eps, int silu,
                           cudaStream_t stream) {
  if (wdtype == 0)
    return launch_apply<T, float>(x, s, b, part, nparts, y, B, HW, C, G, rows, count, eps,
                                  silu, stream);
  return launch_apply<T, __nv_bfloat16>(x, s, b, part, nparts, y, B, HW, C, G, rows, count,
                                        eps, silu, stream);
}

}  // namespace

extern "C" {

// path: ops/groupnorm.py's plan() (enum Path). dtype (of x and y) and wdtype
// (of scale and bias): 0 = float32, 1 = bfloat16. x and y are contiguous
// [B, HW, C] with 16-byte aligned bases; scale and bias are [C]. Rows
// [k * rows_per_block, (k + 1) * rows_per_block) of a sample form slab k. A
// path the arguments cannot take is cudaErrorInvalidValue; no other is tried.
int iret_group_norm(int path, int dtype, int wdtype, const void* x, const void* scale,
                    const void* bias, void* y, int B, int HW, int C, int G,
                    int rows_per_block, float eps, int silu, void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || G > kMaxGroups || C > kMaxChannels ||
      C % G != 0 || (C * elt) % 16 != 0 || rows_per_block <= 0 ||
      (dtype != 0 && dtype != 1) || (wdtype != 0 && wdtype != 1) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return cudaErrorInvalidValue;
  const int64_t slabs = (int64_t)B * ((HW + rows_per_block - 1) / rows_per_block);
  if (slabs * G > kMaxPartials || slabs > 65535LL * 65535LL) return cudaErrorInvalidValue;
  if (path == kOnchip) {
    if ((int64_t)rows_per_block * C * elt > kMaxSlabBytes) return cudaErrorInvalidValue;
  } else if (path != kTwoPhase) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(wdtype, path, x, scale, bias, y, B, HW, C, G, rows_per_block, eps,
                           silu, s);
  return dispatch<__nv_bfloat16>(wdtype, path, x, scale, bias, y, B, HW, C, G, rows_per_block,
                                 eps, silu, s);
}

// The sharded stats entry: the twophase stats kernel over slabs of
// rows_per_block rows, writing partials[b][block][g] = (sum, sum of squares),
// a contiguous fp32 [B][ceil(HW / rows_per_block)][G][2] tensor.
int iret_group_norm_stats(int dtype, const void* x, void* partials, int B, int HW, int C,
                          int G, int rows_per_block, void* stream) {
  if (!sharded_args_ok(dtype, x, B, HW, C, G, rows_per_block) ||
      reinterpret_cast<uintptr_t>(partials) % 8 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((HW + rows_per_block - 1) / rows_per_block, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part = static_cast<float2*>(partials);
  if (dtype == 0)
    gn_stats_kernel<float><<<grid, kThreads, kRedBytes, s>>>(
        static_cast<const float*>(x), part, HW, C, G, rows_per_block);
  else
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, kRedBytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), part, HW, C, G, rows_per_block);
  return cudaGetLastError();
}

// The sharded apply entry: partials is a contiguous fp32 [B][nparts][G][2]
// tensor (the shards' partials in (rank, block) order), reduced in that order;
// count is the global number of elements of a group. x, y, scale and bias as
// in iret_group_norm; y's slabs are rows_per_block rows.
int iret_group_norm_apply(int dtype, int wdtype, const void* x, const void* scale,
                          const void* bias, const void* partials, int nparts, void* y, int B,
                          int HW, int C, int G, int rows_per_block, float count, float eps,
                          int silu, void* stream) {
  if (!sharded_args_ok(dtype, x, B, HW, C, G, rows_per_block) || nparts <= 0 ||
      !(count > 0.f) || (wdtype != 0 && wdtype != 1) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(partials) % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* part = static_cast<const float2*>(partials);
  if (dtype == 0)
    return dispatch_apply<float>(wdtype, x, scale, bias, part, nparts, y, B, HW, C, G,
                                 rows_per_block, count, eps, silu, s);
  return dispatch_apply<__nv_bfloat16>(wdtype, x, scale, bias, part, nparts, y, B, HW, C, G,
                                       rows_per_block, count, eps, silu, s);
}

}  // extern "C"
