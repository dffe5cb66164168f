// K1, K5, K6a and K6b — exact softmax attention for the PyTorch port, one
// device code behind four entries — and the "sm90" path of K4 (int8 Q.K^T
// attention, the JAX package's _int8_attention_kernel; its entry and other
// path are in int8_attention.cu): the sm90 kernel below with an s8 score
// product, iret_int8_attention_sm90.
//
// Replaces, in image_restoration_and_enhancement_tpu/ops/attention.py:
//   K1  _fused_attention_kernel (from _pallas_attention_bhnd / pallas_attention)
//       -> iret_attention
//   K5  _flash_attention_kernel (from _pallas_flash_bhnd / pallas_flash_attention)
//       -> iret_flash_attention
//   K6a _packed_attention_kernel (from pallas_attention_packed)
//       -> iret_packed_attention
//   K6b the inner kernel of pallas_attention_packed_grid -> iret_packed_attention_grid
//
// The function is the Pallas kernels', with their roundings where they put
// them (the plain versions are in ops/attention.py):
//   q' = q * (1/sqrt(D)) rounded to the input dtype, before the dot;
//   s  = q'.k in fp32; keys past Nk score -inf;
//   p  = exp(s - m) in fp32, rounded to the input dtype for P.V;
//   l  = the row sum of the rounded P (K1, K6), or of the fp32 P (K5);
//   out = (P.V in fp32) * (1 / l), in the input dtype.
// K1 also takes the TPU kernel's two opt-in branches as runtime flags:
//   kScoresBf16 (IRET_ATTN_SCORES_BF16): s rounded to bf16 before the mask,
//     max and exp; s - m is then a bf16 difference, rounded to bf16, so the
//     shift must be the exact row max: a first pass over K takes it (npass 2);
//   kNormBound (IRET_ATTN_NORM_BOUND): the shift is ||q'|| * max_j ||k_j||,
//     computed in fp32 at the start of each block, and l is clamped at 1e-30.
// Both make the shift fixed for the whole KV walk, so nothing is rescaled.
//
// What bounds it on the H100: at the UNet's N = 4096 self-attention sites the
// work is 4*N*N*D operations per (batch, head) against 4*N*D elements moved, far
// above the card's ~295 operations per byte, so the bound is arithmetic (bf16
// tensor cores, 989 TFLOP/s): 0.0434 ms at 2 x 4096 x 4096 x 8 x 40. At d = 40
// the exponentials are a floor of their own: 2*8*4096^2 ~ 268 M exp2 on the
// MUFU units (16 a clock per SM, ~4.2e12 a second over 132 SMs at 1.98 GHz)
// take ~0.064 ms, above the tensor cores' bound; only a softmax that runs
// while another warpgroup's products run can approach it. The TPU kernels keep
// K and V resident per (batch*head) (K1, K6) or chunk KV by 1024 keys over a
// sequential grid axis so that Mosaic overlaps one chunk's VPU softmax with the
// next chunk's MXU work (K5). On Hopper blocks run in parallel and in no order,
// so that sequential axis becomes a loop inside each block, and a block's 227 KB
// of shared memory holds far less than K and V at N = 4096 and D = 512 (8 MB).
// So one block takes one Q tile, walks the KV sequence in tiles of BK keys with
// an online softmax (running max m, sum l and the output accumulator in
// registers), and never writes the score matrix to device memory: K5's chunked
// walk is exactly what K1 already does here, and K5 differs from K1 only in the
// row sum. K6a (in-kernel lane slices of one [block, H*D] block) and K6b (grid
// BlockSpecs that cut D-wide lane blocks) are two ways of reading the
// projection layout [B, N, H*D] on the TPU; here a block addresses its tiles
// from strides, so both are the [B, N, H, D] code with head stride D and row
// stride H*D.
//
// Four paths, one function. ops/attention.py's kernel_path() picks the path
// from the layout, the dtype, D and the flags, and passes it in; an entry
// returns cudaErrorInvalidValue for a path its arguments cannot take, and
// never picks another one itself.
// - kSm90 (bf16, head_dim <= 160, no opt-in branch, rows TMA can address:
//   16-byte aligned base and strides; every UNet site): warp-specialised
//   wgmma + TMA, see attention_sm90_kernel. A block of 128 query rows: one
//   producer warp keeps a ring of 3-4 K/V tiles in flight through TMA on
//   full/empty mbarriers; two consumer warpgroups own 64 rows each and take
//   turns on the tensor cores (named barriers), so one's exp2 and row sums
//   run while the other's wgmma runs. KV tiles of 128 keys (64 at d 160).
// - kSm90Split (bf16, 160 < head_dim <= 512, no opt-in branch, TMA rows: the
//   VAE mid-block, d = 512): the same kernel with one consumer warpgroup of
//   64 rows, KV tiles of 32 keys, and the output's D split in two slices of
//   256 over a grid axis (a 64 x 512 fp32 accumulator would need 256
//   registers a thread). Each slice recomputes S over all 512 dims: 1.5x the
//   bound's work, 128 blocks for 132 SMs at N = 4096.
// - kMma (bf16, head_dim <= 160, an opt-in branch or rows TMA cannot
//   address): mma.sync m16n8k16 (see attention_mma_kernel).
// - kSimt (fp32 at head_dim <= 512, and bf16 above 160 with an opt-in branch
//   or rows TMA cannot address; on no served path): CUDA cores in fp32.
//   256 threads form a 16 x 16 grid; each thread owns RT = BQ/16 query rows,
//   BK/16 score columns and DMAX/16 output dims. Q and K sit in shared memory
//   transposed ([d][row], odd row stride so the transposing stores do not hit
//   one bank), V row-major; a row's 16 owners are 16 adjacent lanes of one
//   warp, so the row max and row sum reduce with __shfl_xor_sync.
// The KV tiles here are 32-128 keys (the TPU's are 1024 or all of Nk), so P is
// rounded against other running maxima than the plain versions': the two
// agree to the bf16 rounding of P. Ragged edges (Nq, Nk not a multiple of the
// tile, Nk = 77 for text cross-attention, D = 40/80/160/512) come in as zeros
// (TMA's out-of-bounds fill on the sm90 paths, masked loads on the others);
// keys past Nk then score 0, so they are masked to -inf; dims past D are
// never stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Function flags, uniform over the grid (runtime, so no template instance is added).
constexpr int kRowSumF32 = 1;   // l sums the fp32 P, not the P rounded for P.V
constexpr int kScoresBf16 = 2;  // s rounded to bf16 before the mask, max and exp
constexpr int kNormBound = 4;   // shift by ||q'|| * max ||k||, clamp l at 1e-30

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

// x rounded to T and back (a no-op for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float round_bf16(float x) { return round_to<__nv_bfloat16>(x); }

// sqrt(max_j sum_d k[j][d]^2) over the Nk keys of one (batch, head), in fp32,
// for every thread of the block; red holds one float per warp.
template <typename T>
__device__ float max_key_norm(const T* kb, int Nk, int D, int64_t ksn, float* red) {
  float mx = 0.f;
  for (int j = threadIdx.x; j < Nk; j += blockDim.x) {
    const T* row = kb + (int64_t)j * ksn;
    float ss = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = to_f(row[d]);
      ss += x * x;
    }
    mx = fmaxf(mx, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return sqrtf(r);
}

template <int BQ, int BK>
__host__ __device__ constexpr int smem_floats(int d) {
  return d * (BQ + 1) + d * (BK + 1) + BK * d + BQ * BK;
}

template <typename T, int BQ, int BK, int DMAX>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Nq,
                 int Nk, int D, int64_t qsb, int64_t qsn, int64_t qsh,
                 int64_t ksb, int64_t ksn, int64_t ksh, int64_t vsb,
                 int64_t vsn, int64_t vsh, float scale, int flags) {
  constexpr int RT = BQ / 16;
  constexpr int CT = BK / 16;
  constexpr int DT = DMAX / 16;
  constexpr int QS = BQ + 1;  // row stride of the transposed Q tile
  constexpr int KS = BK + 1;  // row stride of the transposed K tile

  extern __shared__ float smem[];
  float* qs_t = smem;            // [D][QS]
  float* ks_t = qs_t + D * QS;   // [D][KS]
  float* vs = ks_t + D * KS;     // [BK][D]
  float* ps = vs + BK * D;       // [BQ][BK]
  __shared__ float red[kThreads / 32];

  const bool scores_bf16 = flags & kScoresBf16;
  const bool norm_bound = flags & kNormBound;
  const bool rowsum_f32 = flags & kRowSumF32;
  const bool fixed = scores_bf16 || norm_bound;  // one shift for the whole walk
  const bool round_d = scores_bf16 && !norm_bound;
  const int npass = round_d ? 2 : 1;  // pass 0 only takes the exact row max

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int n = q0 + r;
    float val = 0.f;
    if (n < Nq) val = round_to<T>(to_f(qb[(int64_t)n * qsn + d]) * scale);
    qs_t[d * QS + r] = val;
  }

  float acc[RT][DT];
  float m[RT];
  float l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }
  if (norm_bound) {
    const float kn = max_key_norm(kb, Nk, D, ksn, red);  // syncs: qs_t is complete
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float ss = 0.f;
      for (int d = 0; d < D; ++d) {
        const float x = qs_t[d * QS + ty * RT + i];
        ss += x * x;
      }
      m[i] = sqrtf(ss) * kn;
    }
  }

  for (int pass = 0; pass < npass; ++pass) {
    const bool stats = pass + 1 < npass;
    for (int k0 = 0; k0 < Nk; k0 += BK) {
      __syncthreads();  // the previous tile's readers are done with ks_t, vs, ps
      for (int i = tid; i < BK * D; i += kThreads) {
        const int c = i / D;
        const int d = i - c * D;
        const int n = k0 + c;
        float kv = 0.f, vv = 0.f;
        if (n < Nk) {
          kv = to_f(kb[(int64_t)n * ksn + d]);
          vv = to_f(vb[(int64_t)n * vsn + d]);
        }
        ks_t[d * KS + c] = kv;
        vs[c * D + d] = vv;
      }
      __syncthreads();

      float s[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qr[RT], kc[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i) qr[i] = qs_t[d * QS + ty * RT + i];
#pragma unroll
        for (int j = 0; j < CT; ++j) kc[j] = ks_t[d * KS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (scores_bf16) s[i][j] = round_bf16(s[i][j]);
          if (k0 + tx + 16 * j >= Nk) s[i][j] = -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        if (stats || !fixed) {  // a fixed shift needs no row max
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        if (stats) {
          m[i] = fmaxf(m[i], mx);
          continue;
        }
        // Every tile holds at least one key < Nk, so an online m_new is finite.
        const float m_new = fixed ? m[i] : fmaxf(m[i], mx);
        const float alpha = fixed ? 1.f : expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const float dlt = round_d ? round_bf16(s[i][j] - m_new) : s[i][j] - m_new;
          const float pf = expf(dlt);
          const float pr = round_to<T>(pf);
          s[i][j] = pr;
          rs += rowsum_f32 ? pf : pr;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
        if (!fixed) {
#pragma unroll
          for (int j = 0; j < DT; ++j) acc[i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) ps[(ty * RT + i) * BK + tx + 16 * j] = s[i][j];
      }
      if (stats) continue;
      __syncthreads();

      const int kmax = min(BK, Nk - k0);
      for (int c = 0; c < kmax; ++c) {
        float pr[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) pr[i] = ps[(ty * RT + i) * BK + c];
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int d = tx + 16 * j;
          const float vv = d < D ? vs[c * D + d] : 0.f;
#pragma unroll
          for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int n = q0 + ty * RT + i;
    if (n >= Nq) continue;
    const float inv = 1.f / (norm_bound ? fmaxf(l[i], 1e-30f) : l[i]);
    T* orow = o + (((int64_t)b * Nq + n) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int BQ, int BK, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Nq, int Nk, int D, const int64_t* qs,
                   const int64_t* ks, const int64_t* vs, float scale, int flags,
                   cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats<BQ, BK>(D);
  auto kernel = attention_kernel<T, BQ, BK, DMAX>;
  // Once per instance: the largest size it takes (D = DMAX).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * (size_t)smem_floats<BQ, BK>(DMAX)));
  if (attr != cudaSuccess) return attr;
  dim3 grid((Nq + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Nq, Nk, D, qs[0], qs[1],
      qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, flags);
  return cudaGetLastError();
}

// fp32 at any head_dim <= 512 (the fp32 tests and parity runs use the small
// widths). bf16 takes the simt path only above kMmaMaxHeadDim with an opt-in
// branch or rows TMA cannot address, at DMAX 512 (run, below).
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Nq, int Nk, int D, const int64_t* qs,
                         const int64_t* ks, const int64_t* vs, float scale, int flags,
                         cudaStream_t stream) {
  if (D <= 64)
    return launch<float, 64, 64, 64>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags,
                                     stream);
  if (D <= 128)
    return launch<float, 64, 64, 128>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags,
                                      stream);
  if (D <= 160)
    return launch<float, 64, 64, 160>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags,
                                      stream);
  if (D <= 512)
    return launch<float, 32, 32, 512>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags,
                                      stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// kMma path (bf16, head_dim <= 160, K1's opt-in branches or rows TMA cannot
// address): mma.sync m16n8k16, fp32 accumulate.
//
// A block of 4 warps takes 64 query rows; each warp owns 16 of them for the
// whole KV walk. Its Q fragments are loaded once, each pair multiplied by
// bf16(1/sqrt(D)) and rounded to bf16 on the way into registers (the Pallas
// kernels' q'). Per KV tile of 64 keys a warp computes its 16 x 64 score tile
// S = q' K^T with mma.sync, masks it in fp32, updates the running row max, and
// multiplies P = exp(S - m) by V with the score accumulators reused as the A
// operand in bf16 (the accumulator layout of m16n8 equals the A layout of
// m16n8k16), so P never leaves registers; the row sum adds the same bf16
// values that are packed for P.V (K1, K6), or the fp32 ones (K5). V's B
// fragments come from row-major shared memory through ldmatrix.trans. K and V
// tiles are double-buffered: with 16-byte aligned rows (VEC) the next tile
// streams in by cp.async while the current one is multiplied. head_dim is
// zero-padded to DP, a multiple of 16.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared, zero-filled when !valid (src pointer then unused).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// a bf16 pair times scale, each product rounded to bf16 (exact in fp32 first)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f = unpack_bf16(x);
  return pack_bf16(f.x * scale, f.y * scale);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

constexpr int kMmaThreads = 128;
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;

template <int DP>
constexpr int mma_smem_bytes() {
  return 2 * (kMmaBQ + 4 * kMmaBK) * (DP + 8);  // Q, 2 x K, 2 x V
}

// rows x DP tile of rows [n0, n0 + rows) of a [N, D] slice with row stride sn,
// into shared memory with row stride DPS; zero outside N and D.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int n0,
                                          int N, int D, int64_t sn) {
  constexpr int DPS = DP + 8;
  if constexpr (VEC) {
    constexpr int VPR = DP / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < ROWS * VPR; i += kMmaThreads) {
      const int r = i / VPR;
      const int d = (i - r * VPR) * 8;
      const int n = n0 + r;
      const bool valid = n < N && d < D;
      cp_async16(dst + r * DPS + d, valid ? src + (int64_t)n * sn + d : src, valid);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < ROWS * DP; i += kMmaThreads) {
      const int r = i / DP;
      const int d = i - r * DP;
      const int n = n0 + r;
      dst[r * DPS + d] = (n < N && d < D) ? src[(int64_t)n * sn + d] : zero;
    }
  }
}

template <int DP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int H, int Nq, int Nk, int D,
                     int64_t qsb, int64_t qsn, int64_t qsh, int64_t ksb,
                     int64_t ksn, int64_t ksh, int64_t vsb, int64_t vsn,
                     int64_t vsh, float scale, int flags) {
  constexpr int DPS = DP + 8;    // row stride of every tile (16-byte multiple)
  constexpr int KSL = DP / 16;   // k-slices of Q K^T
  constexpr int NB = kMmaBK / 8; // n-blocks of S
  constexpr int DB = DP / 8;     // n-blocks of O
  constexpr int TILE = kMmaBK * DPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][DPS]
  __nv_bfloat16* ks = qs + kMmaBQ * DPS;                            // 2 x [BK][DPS]
  __nv_bfloat16* vs = ks + 2 * TILE;                                // 2 x [BK][DPS]
  __shared__ float red[kMmaThreads / 32];

  const bool scores_bf16 = flags & kScoresBf16;
  const bool norm_bound = flags & kNormBound;
  const bool rowsum_f32 = flags & kRowSumF32;
  const bool fixed = scores_bf16 || norm_bound;  // one shift for the whole walk
  const bool round_d = scores_bf16 && !norm_bound;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kMmaBQ;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  const int ntiles = (Nk + kMmaBK - 1) / kMmaBK;
  // With round_d the walk goes over K twice: the first ntiles steps only take
  // the exact row max.
  const int steps = round_d ? 2 * ntiles : ntiles;

  load_tile<DP, kMmaBQ, VEC>(qs, qb, q0, Nq, D, qsn);
  load_tile<DP, kMmaBK, VEC>(ks, kb, 0, Nk, D, ksn);
  load_tile<DP, kMmaBK, VEC>(vs, vb, 0, Nk, D, vsn);
  cp_async_commit();
  const float kn = norm_bound ? max_key_norm(kb, Nk, D, ksn, red) : 0.f;

  uint32_t qf[KSL][4];
  float oacc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // shift of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums

  for (int it = 0; it < steps; ++it) {
    const int tile = it < ntiles ? it : it - ntiles;
    const bool stats = it + ntiles < steps;
    const int k0 = tile * kMmaBK;
    if (it + 1 < steps) {  // prefetch the next tile into the other buffer
      const int nxt = (it + 1) & 1;
      const int n0 = (tile + 1 < ntiles ? tile + 1 : 0) * kMmaBK;
      load_tile<DP, kMmaBK, VEC>(ks + nxt * TILE, kb, n0, Nk, D, ksn);
      load_tile<DP, kMmaBK, VEC>(vs + nxt * TILE, vb, n0, Nk, D, vsn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      const __nv_bfloat16* qw = qs + warp * 16 * DPS;
      float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
      for (int j = 0; j < KSL; ++j) {
        qf[j][0] = scale_bf16x2(ld32(qw + g * DPS + j * 16 + t * 2), scale);
        qf[j][1] = scale_bf16x2(ld32(qw + (g + 8) * DPS + j * 16 + t * 2), scale);
        qf[j][2] = scale_bf16x2(ld32(qw + g * DPS + j * 16 + t * 2 + 8), scale);
        qf[j][3] = scale_bf16x2(ld32(qw + (g + 8) * DPS + j * 16 + t * 2 + 8), scale);
        if (norm_bound) {
          const float2 a = unpack_bf16(qf[j][0]), c = unpack_bf16(qf[j][2]);
          const float2 bb = unpack_bf16(qf[j][1]), e = unpack_bf16(qf[j][3]);
          ss0 += a.x * a.x + a.y * a.y + c.x * c.x + c.y * c.y;
          ss1 += bb.x * bb.x + bb.y * bb.y + e.x * e.x + e.y * e.y;
        }
      }
      if (norm_bound) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          ss0 += __shfl_xor_sync(0xffffffffu, ss0, off);
          ss1 += __shfl_xor_sync(0xffffffffu, ss1, off);
        }
        m0 = sqrtf(ss0) * kn;
        m1 = sqrtf(ss1) * kn;
      }
    }
    const __nv_bfloat16* kt = ks + (it & 1) * TILE;
    const __nv_bfloat16* vt = vs + (it & 1) * TILE;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* kr = kt + (nb * 8 + g) * DPS + t * 2;
#pragma unroll
      for (int j = 0; j < KSL; ++j) mma_bf16(s[nb], qf[j], ld32(kr + j * 16), ld32(kr + j * 16 + 8));
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nb * 8 + t * 2 + (i & 1);
        const float x = scores_bf16 ? round_bf16(s[nb][i]) : s[nb][i];
        s[nb][i] = col < Nk ? x : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    if (stats || !fixed) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
    }
    if (stats) {
      m0 = fmaxf(m0, mx0);
      m1 = fmaxf(m1, mx1);
      __syncthreads();  // every warp is done with this buffer before it is refilled
      continue;
    }
    float a0 = 1.f, a1 = 1.f;
    if (!fixed) {
      // Every tile holds at least one key < Nk, so the new maxima are finite.
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      a0 = exp2f((m0 - n0) * kLog2e);
      a1 = exp2f((m1 - n1) * kLog2e);
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        oacc[j][0] *= a0;
        oacc[j][1] *= a0;
        oacc[j][2] *= a1;
        oacc[j][3] *= a1;
      }
    }
    const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (round_d) {
        s[nb][0] = exp2f(round_bf16(s[nb][0] - m0) * kLog2e);
        s[nb][1] = exp2f(round_bf16(s[nb][1] - m0) * kLog2e);
        s[nb][2] = exp2f(round_bf16(s[nb][2] - m1) * kLog2e);
        s[nb][3] = exp2f(round_bf16(s[nb][3] - m1) * kLog2e);
      } else {
        s[nb][0] = exp2f(fmaf(s[nb][0], kLog2e, -ml0));
        s[nb][1] = exp2f(fmaf(s[nb][1], kLog2e, -ml0));
        s[nb][2] = exp2f(fmaf(s[nb][2], kLog2e, -ml1));
        s[nb][3] = exp2f(fmaf(s[nb][3], kLog2e, -ml1));
      }
    }
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      if (rowsum_f32) {
        l0 += (s[2 * j][0] + s[2 * j][1]) + (s[2 * j + 1][0] + s[2 * j + 1][1]);
        l1 += (s[2 * j][2] + s[2 * j][3]) + (s[2 * j + 1][2] + s[2 * j + 1][3]);
      } else {
        const float2 r0 = unpack_bf16(pa[0]), r2 = unpack_bf16(pa[2]);
        const float2 r1 = unpack_bf16(pa[1]), r3 = unpack_bf16(pa[3]);
        l0 += (r0.x + r0.y) + (r2.x + r2.y);
        l1 += (r1.x + r1.y) + (r3.x + r3.y);
      }
      // lane l addresses key row j*16 + (l & 15) at d-block db + (l >> 4)
      const __nv_bfloat16* vrow = vt + (j * 16 + (lane & 15)) * DPS + (lane >> 4) * 8;
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + db * 8);
        mma_bf16(oacc[db], pa, bf[0], bf[1]);
        mma_bf16(oacc[db + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (norm_bound) {
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  __nv_bfloat16* o0 = o + (((int64_t)b * Nq + row0) * H + h) * D;
  __nv_bfloat16* o1 = o + (((int64_t)b * Nq + row1) * H + h) * D;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = db * 8 + t * 2 + i;
      if (d < D) {
        if (row0 < Nq) o0[d] = __float2bfloat16(oacc[db][i] * inv0);
        if (row1 < Nq) o1[d] = __float2bfloat16(oacc[db][2 + i] * inv1);
      }
    }
  }
}

template <int DP, bool VEC>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B,
                       int H, int Nq, int Nk, int D, const int64_t* qs,
                       const int64_t* ks, const int64_t* vs, float scale, int flags,
                       cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DP>();
  auto kernel = attention_mma_kernel<DP, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Nq + kMmaBQ - 1) / kMmaBQ, B * H);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Nq,
      Nk, D, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, flags);
  return cudaGetLastError();
}

// 16-byte vector loads need every row start 16-byte aligned and D a multiple of 8.
bool rows_aligned(const void* p, const int64_t* strides, int D) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || D % 8 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

// Padded widths instantiated: 48, 80 and 160 for SD-1.5's head dims 40, 80 and
// 160, 64 for SDXL's, 32 for the tiny test widths. Any other head_dim <= 160
// runs zero-padded at the next of these.
template <bool VEC>
cudaError_t dispatch_mma_dp(const void* q, const void* k, const void* v, void* o,
                            int B, int H, int Nq, int Nk, int D, const int64_t* qs,
                            const int64_t* ks, const int64_t* vs, float scale, int flags,
                            cudaStream_t stream) {
  if (D <= 32)
    return launch_mma<32, VEC>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, stream);
  if (D <= 48)
    return launch_mma<48, VEC>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, stream);
  if (D <= 64)
    return launch_mma<64, VEC>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, stream);
  if (D <= 80)
    return launch_mma<80, VEC>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, stream);
  return launch_mma<160, VEC>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, stream);
}

// ---------------------------------------------------------------------------
// sm90 paths: warp-specialised wgmma + TMA, one kernel for two score products
// (the QK parameter): bf16 S = q'K^T for K1, K5 and K6 (Bf16QK), and s8
// S = q8 k8^T for K4 (S8QK). Everything after S (mask, online softmax, the
// bf16 P.V, the epilogue) is the same code.
//
// Shared memory holds every tile in boxes of BOXB bytes of a row, the layout
// TMA writes with the BOXB-byte swizzle: box x of a tile of R rows is
// R x BOXB bytes at x * R * BOXB, each 8-row group an 8 * BOXB-byte swizzle
// atom. The wgmma descriptors name the same swizzle (layout type 1 for 128
// bytes, 2 for 64):
// - Q (A of S) and K (its B) are K-major, the only layout s8 wgmma takes:
//   rows BOXB bytes apart, 8-row groups 8 * BOXB apart (SBO). A k-step is 32
//   bytes of a row in both products (16 bf16 dims, k16; 32 s8 dims, k32):
//   step kk starts kk * 32 bytes into the row, in box kk * 32 / BOXB. bf16
//   rows come in 64-dim boxes (BOXB 128). s8 rows are DQ = D + lead (below)
//   rounded up to 32, 64, 96 or 160 bytes and come in one 64-byte box (DQ 32,
//   64), one 128-byte box (96) or three 64-byte boxes (160), the swizzle
//   chosen by the row width as K3 chooses it.
// - V (B of O += P.V, N = the output dims) is bf16 and MN-major (transposed):
//   64 dims contiguous in a row, the next 64 dims in the next box
//   (LBO = BK * 128), 8-key groups 1024 apart (SBO), a k-step of 16 keys 2048
//   bytes, 128-byte swizzle. N is a multiple of 64 (whole boxes), so D = 40
//   and 80 compute 64 and 128 output columns of which the zero-filled ones are
//   never stored.
// - P is the register A operand of P.V: the wgmma accumulator layout of S
//   (per warp 16 rows, per 8 columns c0..c3 as mma.sync's m16n8; the s32 and
//   fp32 accumulators share it) is the register A layout of m64nNk16 once two
//   column blocks are packed to bf16.
// Bf16QK: q' is made in place: each consumer warpgroup scales and rounds its
// 64 rows of the Q tile in shared memory (an elementwise pass, so the swizzle
// does not matter), then fence.proxy.async makes the stores visible to wgmma.
// Scores are natural-log units: p = exp2(s * log2(e) - m * log2(e)).
// S8QK: q8 and k8 are read unpadded, through a 3-D map over the rows of
// [B, N, H * D] (each row holds every head: head h starts at column h * D), so
// an s8 head stride of 40 bytes, which no 4-D map can take, needs no copy.
// TMA starts a box only at a 16-byte boundary (another start is an illegal
// instruction), so head h's boxes start at column (h * D) & ~15 and its D
// columns begin `lead` = h * D mod 16 bytes in (8 for odd heads at d = 40);
// the boxes reach into the neighbouring heads (or past the row, zero-filled).
// Each consumer warpgroup zeroes every column of its Q rows outside
// lead .. lead + D - 1 in shared memory once, before its first product, so the
// neighbours' K columns add exact zeros to the s32 sums; DQ covers D + lead.
// There is no Q scaling. The softmax reads the s32 sums: the row max is
// taken in s32 and scaled once (c = sq*sk*log2(e): the max of the scores
// float(x) * c, bit for bit), and p = exp2(fma(float(x), c, -m)) rounds once
// where the plain version rounds float(x) * c and then the difference (an
// ulp of the argument at most). The row sums over the bf16 P come from the
// tensor cores, as the TPU kernel takes them with its ones column of V: with
// each P.V, P times a 2 KB shared tile of bf16 ones (m64n8k16 into 4 fp32
// registers a thread, rescaled with the output), so the softmax spends no
// instruction on them.
// ---------------------------------------------------------------------------

// 2^x on the MUFU unit alone (exp2f adds range fixups for subnormal results).
// Results below 2^-126 flush to 0: such a P or rescale factor changes no fp32
// row sum of at least 1 (the row max contributes 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x (an s32 product sum, |x| < 2^22) as fp32, exactly, on the full-rate
// pipes: 1.5 * 2^23 + x is an fp32 whose low mantissa bits are x.
__device__ __forceinline__ float s32_to_f32(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.f;
}

// Below every s8 score sum (|sum| <= 127 * 127 * 160 < 2^22), and exact in
// s32_to_f32: the s32 stand-in for a masked key.
constexpr int kS8Masked = -(1 << 22);

// The score product of an sm90 instance (see above). kBytes: bytes of a Q/K
// element; kExp: the factor that takes a score to log2 units.
struct Bf16QK {
  static constexpr bool kS8 = false;
  static constexpr int kBytes = 2;
  static constexpr float kExp = kLog2e;
};
struct S8QK {
  static constexpr bool kS8 = true;
  static constexpr int kBytes = 1;
  static constexpr float kExp = 1.f;
};

// One instance of the sm90 kernel: DQ the padded Q/K depth in elements (its
// row, DQ * kBytes, a multiple of 32 bytes), DV the output columns a block
// computes (a multiple of 64; the slice of D at d = 512), BK keys per KV
// tile, NCONS consumer warpgroups of 64 query rows, STAGES K/V tiles in the
// ring, QK the score product.
template <int DQ, int DV, int BK, int NCONS, int STAGES, class QK>
struct Sm90 {
  static constexpr int BQ = 64 * NCONS;
  static constexpr int ROW = DQ * QK::kBytes;  // bytes of a Q or K row multiplied
  static constexpr int BOXB = QK::kS8 && ROW != 96 && ROW % 128 != 0 ? 64 : 128;
  static constexpr int QBOX = (ROW + BOXB - 1) / BOXB;  // boxes of a Q or K row
  static constexpr int KSTEPS = ROW / 32;
  static constexpr int SBO = 8 * BOXB;
  static constexpr uint64_t LAYOUT = BOXB == 128 ? 1 : 2;
  static constexpr int VBOX = DV / 64;
  static constexpr int Q_BYTES = BQ * BOXB * QBOX;
  static constexpr int K_BYTES = BK * BOXB * QBOX;
  static constexpr int V_BYTES = BK * 128 * VBOX;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // S8QK: a 2 KB tile of bf16 ones, the B operand of the row-sum product.
  static constexpr int ONES_BYTES = QK::kS8 ? 2048 : 0;
  static constexpr int THREADS = 128 * (NCONS + 1);  // consumers, then the producer
  // 1024 for aligning the swizzle atoms, then the barriers.
  static constexpr int SMEM_BYTES =
      1024 + Q_BYTES + ONES_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
  static_assert(ROW % 32 == 0 && DV % 64 == 0 && BK % 16 == 0, "tile shapes");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
  // With two consumers one block must hold its SM alone, so that setmaxnreg
  // always finds the registers the producer gave back.
  static_assert(NCONS == 1 || 2 * SMEM_BYTES > 232448, "one block per SM");
};

// A mask that keeps bytes lo .. hi - 1 of a 32-bit word (little-endian).
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 4);
  if (hi <= lo) return 0u;
  const uint32_t below_hi = hi == 4 ? 0xffffffffu : (1u << (8 * hi)) - 1u;
  return below_hi & ~((1u << (8 * lo)) - 1u);
}

// tq and tk: 4-D maps (d, h, n, b) of bf16 q and k (Bf16QK), or 3-D maps
// (column, n, b) of s8 q8 and k8 (S8QK); tv a 4-D map of bf16 v. scale:
// 1/sqrt(D) in bf16 (Bf16QK); sq_sk: sq*sk on the device (S8QK).
template <int DQ, int DV, int BK, int NCONS, int STAGES, class QK>
__global__ void __launch_bounds__(Sm90<DQ, DV, BK, NCONS, STAGES, QK>::THREADS, 1)
attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                      int H, int Nq, int Nk, int D, float scale,
                      const float* __restrict__ sq_sk, int flags) {
  using C = Sm90<DQ, DV, BK, NCONS, STAGES, QK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;  // the Q tile; then the K/V stages
  unsigned char* qs_ptr = smem_raw + (qs - raw);
  const uint32_t ones = qs + C::Q_BYTES;      // S8QK's ones tile
  const uint32_t kv0 = ones + C::ONES_BYTES;  // stage s: K at kv0 + s * STAGE_BYTES, then V
  const uint32_t bars = kv0 + STAGES * C::STAGE_BYTES;
  const uint32_t qbar = bars + 16 * STAGES;   // full[s] at bars + 8s, empty[s] after them

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * C::BQ;
  const int dv0 = blockIdx.z * DV;
  const int ntiles = (Nk + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
  // S8QK: a Q or K row's boxes start at the 16-byte boundary at or below
  // column h * D (TMA takes no other start), and head h's D columns begin
  // `lead` bytes into them.
  const int col0 = QK::kS8 ? (h * D) & ~15 : 0;
  const int lead = h * D - col0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 4 * NCONS);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NCONS) {
    // Producer: one thread keeps the ring full.
    if constexpr (NCONS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NCONS * 128) {
      // box x of the rows from n of a Q or K tile
      auto load_qk = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int x, int n) {
        if constexpr (QK::kS8)
          tma_load_3d(dst, map, bar, col0 + x * C::BOXB, n, b);
        else
          tma_load(dst, map, bar, 64 * x, h, n, b);
      };
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int x = 0; x < C::QBOX; ++x) load_qk(qs + x * C::BQ * C::BOXB, &tq, qbar, x, q0);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        const uint32_t kst = kv0 + s * C::STAGE_BYTES;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (STAGES + s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, C::STAGE_BYTES);
        for (int x = 0; x < C::QBOX; ++x) load_qk(kst + x * BK * C::BOXB, &tk, full, x, j * BK);
        for (int x = 0; x < C::VBOX; ++x)
          tma_load(kst + C::K_BYTES + x * BK * 128, &tv, full, dv0 + 64 * x, h, j * BK, b);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63.
    if constexpr (NCONS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool rowsum_f32 = flags & kRowSumF32;
    const float qk_scale = QK::kS8 ? sq_sk[0] * kLog2e : 0.f;
    // Turns on the tensor cores: warpgroup wg waits on barrier 1 + wg, and
    // after issuing its products lets the other one go (barrier 2 - wg).
    // Warpgroup 1 opens barrier 1 once, so warpgroup 0 goes first, and skips
    // its arrival after its last turn, so every arrival is waited for.
    auto turn_begin = [&]() {
      if constexpr (NCONS > 1) named_sync(1 + wg, 256);
    };
    auto turn_end = [&](bool last) {
      if constexpr (NCONS > 1) {
        if (!(last && wg == 1)) named_arrive(2 - wg, 256);
      }
    };
    if (NCONS > 1 && wg == 1) named_arrive(1, 256);

    mbar_wait(qbar, 0);
    for (int x = 0; x < C::QBOX; ++x) {
      uint4* rows = reinterpret_cast<uint4*>(qs_ptr + x * C::BQ * C::BOXB + wg * 64 * C::BOXB);
      if constexpr (QK::kS8) {
        // Keep head h's columns, bytes lead .. lead + D - 1 of the row, and
        // zero the rest. 16-byte chunk c of row r is stored at chunk
        // c ^ (r & 7) (128-byte swizzle) or c ^ ((r >> 1) & 3) (64-byte);
        // 64 rows keep the phase of the 8-row atoms.
        constexpr int CPR = C::BOXB / 16;
        for (int i = tid; i < 64 * CPR; i += 128) {
          const int r = i / CPR;
          const int c = (i % CPR) ^ (CPR == 8 ? (r & 7) : ((r >> 1) & 3));
          const int lo = lead - (x * C::BOXB + 16 * c);  // kept bytes of the chunk: lo .. hi - 1
          const int hi = lo + D;
          if (lo <= 0 && hi >= 16) continue;
          uint4 w = rows[i];
          w.x &= byte_mask(lo, hi);
          w.y &= byte_mask(lo - 4, hi - 4);
          w.z &= byte_mask(lo - 8, hi - 8);
          w.w &= byte_mask(lo - 12, hi - 12);
          rows[i] = w;
        }
      } else {
        for (int i = tid; i < 64 * 8; i += 128) {
          uint4 w = rows[i];
          w.x = scale_bf16x2(w.x, scale);
          w.y = scale_bf16x2(w.y, scale);
          w.z = scale_bf16x2(w.z, scale);
          w.w = scale_bf16x2(w.w, scale);
          rows[i] = w;
        }
      }
    }
    if constexpr (QK::kS8) {
      // Each warpgroup writes the whole ones tile (the same values), so its
      // own products never wait for the other's stores.
      reinterpret_cast<uint4*>(qs_ptr + C::Q_BYTES)[tid] =
          make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(3 + wg, 128);

    const uint32_t qa = qs + wg * 64 * C::BOXB;
    float oacc[DV / 2];
    float lacc[4] = {0.f, 0.f, 0.f, 0.f};  // S8QK: the row sums, P times ones
    float s[BK / 2];
    int si[QK::kS8 ? BK / 2 : 1];  // the s32 scores (S8QK)
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // shift of rows g and g + 8 of this warp
    float l0 = 0.f, l1 = 0.f;              // this thread's part of their row sums
    float a0 = 0.f, a1 = 0.f;              // the rescale of the latest tile

    // Before the S product: its fp32 accumulators (Bf16QK). The s32 ones are
    // written, not read, by its first k-step, so they hold nothing live
    // between the conversion to s and the next product (S8QK).
    auto fence_s = [&]() {
      if constexpr (!QK::kS8) fence_regs(s);
    };
    // The row-sum accumulators (S8QK).
    auto fence_l = [&]() {
      if constexpr (QK::kS8) fence_regs(lacc);
    };
    // After the S product has completed.
    auto fence_s_done = [&]() {
      if constexpr (QK::kS8)
        fence_regs(si);
      else
        fence_regs(s);
    };
    auto mma_s = [&](int st) {
      const uint32_t kst = kv0 + st * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const int box = kk * 32 / C::BOXB;
        const int off = kk * 32 % C::BOXB;
        const uint64_t da = gmma_desc(qa + box * C::BQ * C::BOXB + off, 16, C::SBO, C::LAYOUT);
        const uint64_t db = gmma_desc(kst + box * BK * C::BOXB + off, 16, C::SBO, C::LAYOUT);
        if constexpr (QK::kS8) {
          if (kk == 0)
            wgmma_s8_first(si, da, db);
          else
            wgmma_s8(si, da, db, 1);
        } else
          wgmma_ss(s, da, db, kk > 0);
      }
    };
    auto mma_pv = [&](int st) {
      const uint32_t vst = kv0 + st * C::STAGE_BYTES + C::K_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(oacc, p[kk], gmma_desc(vst + kk * 16 * 128, BK * 128, 1024), 1);
      if constexpr (QK::kS8) {
        // The row sums over the bf16 P, as the TPU kernel takes them: P times a
        // column of ones (m64n8k16; every column of lacc is the sum).
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(lacc, p[kk], gmma_desc(ones, BK * 128, 1024), 1);
      }
    };
    auto release = [&](int st) {
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + st));
    };
    // Key column of accumulator i of this thread in the score tile at k0.
    auto key = [&](int k0, int i) { return k0 + (i >> 2) * 8 + 2 * t + (i & 1); };
    // Mask, row max, new shift and rescale (a0, a1) of the score tile at k0.
    // S8QK takes the row max of the s32 sums and converts it once: the score
    // float(x) * c (c = sq*sk*log2(e)) grows with x, so that is the max of
    // the scores, bit for bit; masked keys get a sum below every s8 sum.
    auto shift = [&](int k0) {
      const bool partial = k0 + BK > Nk;
      float mx0, mx1;
      if constexpr (QK::kS8) {
        int x0 = kS8Masked, x1 = kS8Masked;
        if (partial) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (key(k0, i) >= Nk) si[i] = kS8Masked;
        }
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          x0 = max(x0, max(si[4 * i], si[4 * i + 1]));
          x1 = max(x1, max(si[4 * i + 2], si[4 * i + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          x0 = max(x0, __shfl_xor_sync(0xffffffffu, x0, off));
          x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, off));
        }
        mx0 = __int2float_rn(x0) * qk_scale;
        mx1 = __int2float_rn(x1) * qk_scale;
      } else {
        if (partial) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (key(k0, i) >= Nk) s[i] = -INFINITY;
        }
        mx0 = mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
      }
      // Every tile holds at least one key < Nk, so the new maxima are finite.
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      a0 = exp2_ftz((m0 - n0) * QK::kExp);
      a1 = exp2_ftz((m1 - n1) * QK::kExp);
      m0 = n0;
      m1 = n1;
    };
    // s = exp(s - m) in fp32 and the row sums over P rounded to bf16 (or over
    // the fp32 P); runs while the previous tile's P.V may still read p.
    // S8QK: exp2(float(x) * c - m) straight from the s32 sums (the conversion
    // is two full-rate instructions, s32_to_f32, not the quarter-rate I2F),
    // and no row sums here: the tensor cores take them with P.V (mma_pv).
    auto exponentiate = [&](int k0) {
      const float ml0 = m0 * QK::kExp, ml1 = m1 * QK::kExp;
      const bool partial = QK::kS8 && k0 + BK > Nk;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const float ml = (i & 2) ? ml1 : ml0;
        if constexpr (QK::kS8) {
          float x0 = fmaf(s32_to_f32(si[i]), qk_scale, -ml);
          float x1 = fmaf(s32_to_f32(si[i + 1]), qk_scale, -ml);
          if (partial && key(k0, i) >= Nk) x0 = -INFINITY;
          if (partial && key(k0, i + 1) >= Nk) x1 = -INFINITY;
          s[i] = exp2_ftz(x0);
          s[i + 1] = exp2_ftz(x1);
        } else {
          s[i] = exp2_ftz(fmaf(s[i], kLog2e, -ml));
          s[i + 1] = exp2_ftz(fmaf(s[i + 1], kLog2e, -ml));
          float x;
          if (rowsum_f32) {
            x = s[i] + s[i + 1];
          } else {
            const float2 f = unpack_bf16(pack_bf16(s[i], s[i + 1]));
            x = f.x + f.y;
          }
          if (i & 2)
            r1 += x;
          else
            r0 += x;
        }
      }
      if constexpr (!QK::kS8) {
        l0 = l0 * a0 + r0;
        l1 = l1 * a1 + r1;
      }
    };
    // P packed to bf16 as the A operand of P.V (once the previous P.V is done).
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    // Tile 0: S only. Then per tile j: S_j and P_{j-1}.V_{j-1} in one turn;
    // the softmax of S_j runs while the other warpgroup's turn runs.
    mbar_wait(bars, 0);
    turn_begin();
    fence_s();
    wgmma_fence();
    mma_s(0);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    fence_s_done();
    shift(0);
    exponentiate(0);
    pack_p();
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % STAGES;
      const int pst = (j - 1) % STAGES;
      mbar_wait(bars + 8 * st, (j / STAGES) & 1);
      turn_begin();
      fence_s();
      fence_regs(oacc);
      fence_l();
      fence_regs(p);
      wgmma_fence();
      mma_s(st);
      wgmma_commit();
      mma_pv(pst);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<1>();
      fence_s_done();
      shift(j * BK);
      exponentiate(j * BK);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_l();
      fence_regs(p);
      release(pst);
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        oacc[4 * i] *= a0;
        oacc[4 * i + 1] *= a0;
        oacc[4 * i + 2] *= a1;
        oacc[4 * i + 3] *= a1;
      }
      if constexpr (QK::kS8) {
        lacc[0] *= a0;
        lacc[1] *= a0;
        lacc[2] *= a1;
        lacc[3] *= a1;
      }
      pack_p();
    }
    const int last = (ntiles - 1) % STAGES;
    turn_begin();
    fence_regs(oacc);
    fence_l();
    fence_regs(p);
    wgmma_fence();
    mma_pv(last);
    wgmma_commit();
    turn_end(true);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_l();
    release(last);

    if constexpr (QK::kS8) {
      l0 = lacc[0];
      l1 = lacc[2];
    } else {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int row0 = q0 + wg * 64 + warp * 16 + g;
    const int row1 = row0 + 8;
    __nv_bfloat16* o0 = o + (((int64_t)b * Nq + row0) * H + h) * D;
    __nv_bfloat16* o1 = o + (((int64_t)b * Nq + row1) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = dv0 + i * 8 + t * 2 + c;
        if (d < D) {
          if (row0 < Nq) o0[d] = __float2bfloat16(oacc[4 * i + c] * inv0);
          if (row1 < Nq) o1[d] = __float2bfloat16(oacc[4 * i + 2 + c] * inv1);
        }
      }
    }
  }
}

// The 4-D map (d, h, n, b) of a [B, N, H, D] bf16 view with element strides
// st = (b, n, h), boxes of 64 dims x `rows` rows, 128-byte swizzle; reads past
// an edge are zero-filled.
bool make_map(CUtensorMap* map, const void* ptr, int B, int N, int H, int D,
              const int64_t* st, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The 3-D map (column, n, b) of an s8 [B, N, H, D] view with heads packed in
// its rows (st = (b, n) byte strides): H * D columns, boxes of `boxb` bytes x
// `rows` rows with the `boxb`-byte swizzle; reads past an edge are zero-filled.
bool make_map_s8(CUtensorMap* map, const void* ptr, int B, int N, int H, int D,
                 const int64_t* st, int rows, int boxb) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)st[1], (cuuint64_t)st[0]};
  const cuuint32_t box[3] = {(cuuint32_t)boxb, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            boxb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DQ, int DV, int BK, int NCONS, int STAGES, class QK>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Nq, int Nk, int D, const int64_t* qs, const int64_t* ks,
                        const int64_t* vs, float scale, const float* sq_sk, int flags,
                        cudaStream_t stream) {
  using C = Sm90<DQ, DV, BK, NCONS, STAGES, QK>;
  auto kernel = attention_sm90_kernel<DQ, DV, BK, NCONS, STAGES, QK>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  bool maps;
  if constexpr (QK::kS8)
    maps = make_map_s8(&tq, q, B, Nq, H, D, qs, C::BQ, C::BOXB) &&
           make_map_s8(&tk, k, B, Nk, H, D, ks, BK, C::BOXB);
  else
    maps = make_map(&tq, q, B, Nq, H, D, qs, C::BQ) && make_map(&tk, k, B, Nk, H, D, ks, BK);
  if (!maps || !make_map(&tv, v, B, Nk, H, D, vs, BK)) return cudaErrorInvalidValue;
  dim3 grid((Nq + C::BQ - 1) / C::BQ, B * H, (D + DV - 1) / DV);
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Nq, Nk, D, scale, sq_sk, flags);
  return cudaGetLastError();
}

// Instances: padded widths 32 (test widths), 48, 64 (SDXL), 80 and 160 (SD-1.5's
// 40, 80, 160); any other head_dim <= 160 runs zero-padded at the next of them.
// The ring holds as many K/V stages as shared memory allows (4, 3 and 3 of
// 32, 64 and 48 KB): the P.V of a tile is issued with the next tile's S, so a
// stage is freed one tile late, and two stages would leave a load's latency
// in the open.
cudaError_t dispatch_sm90(const void* q, const void* k, const void* v, void* o, int B, int H,
                          int Nq, int Nk, int D, const int64_t* qs, const int64_t* ks,
                          const int64_t* vs, float scale, int flags, cudaStream_t stream) {
#define IRET_LAUNCH_SM90(DQ_, DV_, BK_, STAGES_)                                           \
  return launch_sm90<DQ_, DV_, BK_, 2, STAGES_, Bf16QK>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, \
                                                        vs, scale, nullptr, flags, stream)
  if (D <= 32) IRET_LAUNCH_SM90(32, 64, 128, 4);
  if (D <= 48) IRET_LAUNCH_SM90(48, 64, 128, 4);
  if (D <= 64) IRET_LAUNCH_SM90(64, 64, 128, 4);
  if (D <= 80) IRET_LAUNCH_SM90(80, 128, 128, 3);
  IRET_LAUNCH_SM90(160, 192, 64, 3);
#undef IRET_LAUNCH_SM90
}

// The bytes of an s8 row the S product must cover for every head: D past the
// largest lead (h * D mod 16) of the H heads.
int s8_row_bytes(int H, int D) {
  int lead = 0;
  for (int h = 1; h < H && h < 16; ++h) {
    const int l = (h * D) & 15;
    lead = l > lead ? l : lead;
  }
  return D + lead;
}

// K4's instances: s8 rows of 32, 64, 96 and 160 bytes (test widths; SD-1.5's
// d = 40 with leads of 0 and 8 bytes, 80 and 160 with none), the V widths and
// KV tiles of K1's at the same head_dim, and one stage more than K1's where
// the smaller s8 tiles leave room (5 at 24 KB a stage; with 4 a block would
// take under half the SM's shared memory, and two blocks an SM would break
// setmaxnreg's budget).
cudaError_t dispatch_sm90_s8(const void* q, const void* k, const void* v, void* o, int B,
                             int H, int Nq, int Nk, int D, const int64_t* qs,
                             const int64_t* ks, const int64_t* vs, const float* sq_sk,
                             cudaStream_t stream) {
#define IRET_LAUNCH_S8(DQ_, DV_, BK_, STAGES_)                                             \
  return launch_sm90<DQ_, DV_, BK_, 2, STAGES_, S8QK>(q, k, v, o, B, H, Nq, Nk, D, qs, ks,   \
                                                      vs, 0.f, sq_sk, 0, stream)
  const int row = s8_row_bytes(H, D);
  if (row <= 32) IRET_LAUNCH_S8(32, 64, 128, 5);
  if (row <= 64) IRET_LAUNCH_S8(64, 64, 128, 5);
  if (row <= 96) IRET_LAUNCH_S8(96, 128, 128, 4);
  if (row <= 160) IRET_LAUNCH_S8(160, 192, 64, 4);
#undef IRET_LAUNCH_S8
  return cudaErrorInvalidValue;
}

// TMA needs a 16-byte aligned base and 16-byte multiple strides (positive).
bool tma_rows(const void* p, const int64_t* strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] <= 0 || strides[i] % 8 != 0) return false;
  return true;
}

// An s8 [B, N, H, D] view as make_map_s8 reads it: heads packed in the rows
// (head stride D, or one head), a 16-byte aligned base, and positive 16-byte
// multiple row and batch strides (st = (b, n, h), in bytes).
bool s8_rows(const void* p, const int64_t* st, int H, int D) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] > 0 && st[0] % 16 == 0 &&
         st[1] > 0 && st[1] % 16 == 0 && (H == 1 || st[2] == D);
}

// Paths, as ops/attention.py's kernel_path() names them.
enum Path { kSimt = 0, kMma = 1, kSm90 = 2, kSm90Split = 3 };
constexpr int kMmaMaxHeadDim = 160;
constexpr int kMaxHeadDim = 512;

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the b, n and h
// axes of q, k and v; the d axis has stride 1. o is a contiguous [B, Nq, H, D].
// scale is 1/sqrt(D) as the input dtype holds it. A path the arguments cannot
// take is cudaErrorInvalidValue; no other path is tried.
int run(int dtype, int path, const void* q, const void* k, const void* v, void* o, int B,
        int H, int Nq, int Nk, int D, const int64_t* qs, const int64_t* ks, const int64_t* vs,
        float scale, int flags, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D > kMaxHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool plain_flags = (flags & ~kRowSumF32) == 0;
  const bool tma = tma_rows(q, qs) && tma_rows(k, ks) && tma_rows(v, vs);
  switch (path) {
    case kSimt:
      if (dtype == 0)
        return dispatch_f32(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, s);
      if (dtype == 1 && D > kMmaMaxHeadDim && !(plain_flags && tma))
        return launch<__nv_bfloat16, 32, 32, 512>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs,
                                                  scale, flags, s);
      break;
    case kMma:
      if (dtype == 1 && D <= kMmaMaxHeadDim) {
        if (rows_aligned(q, qs, D) && rows_aligned(k, ks, D) && rows_aligned(v, vs, D))
          return dispatch_mma_dp<true>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, s);
        return dispatch_mma_dp<false>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, s);
      }
      break;
    case kSm90:
      if (dtype == 1 && D <= kMmaMaxHeadDim && plain_flags && tma)
        return dispatch_sm90(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, s);
      break;
    case kSm90Split:
      if (dtype == 1 && D > kMmaMaxHeadDim && plain_flags && tma)
        return launch_sm90<512, 256, 32, 1, 3, Bf16QK>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs,
                                                       scale, nullptr, flags, s);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1 on [B, N, H, D] views. flags: kScoresBf16 | kNormBound | kRowSumF32, as
// ops/attention.py sets them from IRET_ATTN_SCORES_BF16 and IRET_ATTN_NORM_BOUND.
// path: ops/attention.py's kernel_path() (enum Path).
int iret_attention(int dtype, int path, const void* q, const void* k, const void* v,
                   void* o, int B, int H, int Nq, int Nk, int D, int64_t qsb,
                   int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn,
                   int64_t ksh, int64_t vsb, int64_t vsn, int64_t vsh,
                   float scale, int flags, void* stream) {
  const int64_t qs[3] = {qsb, qsn, qsh};
  const int64_t ks[3] = {ksb, ksn, ksh};
  const int64_t vs[3] = {vsb, vsn, vsh};
  return run(dtype, path, q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, stream);
}

// K5 on [B, N, H, D] views: K1's walk with the row sum over the fp32 P.
int iret_flash_attention(int dtype, int path, const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Nq, int Nk, int D, int64_t qsb,
                         int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn,
                         int64_t ksh, int64_t vsb, int64_t vsn, int64_t vsh,
                         float scale, void* stream) {
  const int64_t qs[3] = {qsb, qsn, qsh};
  const int64_t ks[3] = {ksb, ksn, ksh};
  const int64_t vs[3] = {vsb, vsn, vsh};
  return run(dtype, path, q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, kRowSumF32, stream);
}

// K6a and K6b on the projection layout [B, N, H*D]: strides of the b and n
// axes; head h starts at column h*D. o is a contiguous [B, Nq, H*D].
int iret_packed_attention(int dtype, int path, const void* q, const void* k, const void* v,
                          void* o, int B, int H, int Nq, int Nk, int D, int64_t qsb,
                          int64_t qsn, int64_t ksb, int64_t ksn, int64_t vsb,
                          int64_t vsn, float scale, void* stream) {
  const int64_t qs[3] = {qsb, qsn, D};
  const int64_t ks[3] = {ksb, ksn, D};
  const int64_t vs[3] = {vsb, vsn, D};
  return run(dtype, path, q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, 0, stream);
}

int iret_packed_attention_grid(int dtype, int path, const void* q, const void* k,
                               const void* v, void* o, int B, int H, int Nq, int Nk, int D,
                               int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn,
                               int64_t vsb, int64_t vsn, float scale, void* stream) {
  return iret_packed_attention(dtype, path, q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, ksb, ksn,
                               vsb, vsn, scale, stream);
}

// K4's sm90 path (called by iret_int8_attention in int8_attention.cu, which
// owns the entry and its path argument): s8 q8 and k8 [B, N, H, D] views with
// heads packed in their rows, bf16 v [B, Nk, H, D], strides (b, n, h) in
// elements; sq_sk one fp32 on the device; o a contiguous bf16 [B, Nq, H, D].
// Arguments the path cannot take are cudaErrorInvalidValue.
int iret_int8_attention_sm90(const void* q, const void* k, const void* v, const void* sq_sk,
                             void* o, int B, int H, int Nq, int Nk, int D, const int64_t* qs,
                             const int64_t* ks, const int64_t* vs, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0 || D > kMmaMaxHeadDim ||
      !s8_rows(q, qs, H, D) || !s8_rows(k, ks, H, D) || !tma_rows(v, vs))
    return cudaErrorInvalidValue;
  return dispatch_sm90_s8(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs,
                          static_cast<const float*>(sq_sk), static_cast<cudaStream_t>(stream));
}

const char* iret_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
