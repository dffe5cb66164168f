// K1, K5, K6a and K6b — exact softmax attention for the PyTorch port, one
// device code behind four entries.
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
// tensor cores, 989 TFLOP/s). The TPU kernels keep K and V resident per
// (batch*head) (K1, K6) or chunk KV by 1024 keys over a sequential grid axis so
// that Mosaic overlaps one chunk's VPU softmax with the next chunk's MXU work
// (K5). On Hopper blocks run in parallel and in no order, so that sequential
// axis becomes a loop inside each block, and a block's 227 KB of shared memory
// holds far less than K and V at N = 4096 and D = 512 (8 MB). So one block
// takes one Q tile of BQ rows, walks the KV sequence in tiles of BK keys with
// an online softmax (running max m, sum l and the output accumulator in
// registers), and never writes the score matrix to device memory: K5's chunked
// walk is exactly what K1 already does here, and K5 differs from K1 only in
// the row sum. K6a (in-kernel lane slices of one [block, H*D] block) and K6b
// (grid BlockSpecs that cut D-wide lane blocks) are two ways of reading the
// projection layout [B, N, H*D] on the TPU; here a block computes its own
// addresses from strides, so both are the [B, N, H, D] code with head stride
// D and row stride H*D.
//
// Two paths, one function:
// - bf16 with head_dim <= 160 (every UNet site): tensor cores through
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate), one warp per 16 query rows,
//   the score tile and P kept in registers (see attention_mma_kernel below).
// - fp32, and bf16 with head_dim up to 512 (the VAE mid block): CUDA cores in
//   fp32. 256 threads form a 16 x 16 grid; each thread owns RT = BQ/16 query
//   rows, BK/16 score columns and DMAX/16 output dims. Q and K sit in shared
//   memory transposed ([d][row], odd row stride so the transposing stores do
//   not hit one bank), V row-major; a row's 16 owners are 16 adjacent lanes of
//   one warp, so the row max and row sum reduce with __shfl_xor_sync.
//   At d = 512 this path is slower than the plain PyTorch version, which runs
//   on cuBLAS's tensor cores (PERF.md); a tensor-core d = 512 path is queued.
// The tiles here are 64 keys (the TPU's are 1024 or all of Nk), so P is rounded
// against other running maxima than the plain versions': the two agree to the
// bf16 rounding of P. Ragged edges (Nq, Nk not a multiple of the tile, Nk = 77
// for text cross-attention, D = 40/80/160/512) are masked: keys past Nk score
// -inf, padded dims are zero, dims past D are never stored. A wgmma/TMA
// version with pipelined tile loads is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Nq, Nk, D, qs[0], qs[1],
      qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, flags);
  return cudaGetLastError();
}

// fp32 at any head_dim <= 512 (the fp32 tests and parity runs use the small
// widths). bf16 takes this path only above kMmaMaxHeadDim, at DMAX 512.
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
// bf16 tensor-core path (head_dim <= 160): mma.sync m16n8k16, fp32 accumulate.
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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
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

constexpr int kMmaMaxHeadDim = 160;

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the b, n and h
// axes of q, k and v; the d axis has stride 1. o is a contiguous [B, Nq, H, D].
// scale is 1/sqrt(D) as the input dtype holds it.
int run(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H,
        int Nq, int Nk, int D, const int64_t* qs, const int64_t* ks, const int64_t* vs,
        float scale, int flags, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, s);
  if (dtype == 1 && D <= kMmaMaxHeadDim) {
    if (rows_aligned(q, qs, D) && rows_aligned(k, ks, D) && rows_aligned(v, vs, D))
      return dispatch_mma_dp<true>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, s);
    return dispatch_mma_dp<false>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, s);
  }
  if (dtype == 1 && D <= 512)
    return launch<__nv_bfloat16, 32, 32, 512>(q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs,
                                              scale, flags, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1 on [B, N, H, D] views. flags: kScoresBf16 | kNormBound | kRowSumF32, as
// ops/attention.py sets them from IRET_ATTN_SCORES_BF16 and IRET_ATTN_NORM_BOUND.
int iret_attention(int dtype, const void* q, const void* k, const void* v,
                   void* o, int B, int H, int Nq, int Nk, int D, int64_t qsb,
                   int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn,
                   int64_t ksh, int64_t vsb, int64_t vsn, int64_t vsh,
                   float scale, int flags, void* stream) {
  const int64_t qs[3] = {qsb, qsn, qsh};
  const int64_t ks[3] = {ksb, ksn, ksh};
  const int64_t vs[3] = {vsb, vsn, vsh};
  return run(dtype, q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, flags, stream);
}

// K5 on [B, N, H, D] views: K1's walk with the row sum over the fp32 P.
int iret_flash_attention(int dtype, const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Nq, int Nk, int D, int64_t qsb,
                         int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn,
                         int64_t ksh, int64_t vsb, int64_t vsn, int64_t vsh,
                         float scale, void* stream) {
  const int64_t qs[3] = {qsb, qsn, qsh};
  const int64_t ks[3] = {ksb, ksn, ksh};
  const int64_t vs[3] = {vsb, vsn, vsh};
  return run(dtype, q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, kRowSumF32, stream);
}

// K6a and K6b on the projection layout [B, N, H*D]: strides of the b and n
// axes; head h starts at column h*D. o is a contiguous [B, Nq, H*D].
int iret_packed_attention(int dtype, const void* q, const void* k, const void* v,
                          void* o, int B, int H, int Nq, int Nk, int D, int64_t qsb,
                          int64_t qsn, int64_t ksb, int64_t ksn, int64_t vsb,
                          int64_t vsn, float scale, void* stream) {
  const int64_t qs[3] = {qsb, qsn, D};
  const int64_t ks[3] = {ksb, ksn, D};
  const int64_t vs[3] = {vsb, vsn, D};
  return run(dtype, q, k, v, o, B, H, Nq, Nk, D, qs, ks, vs, scale, 0, stream);
}

int iret_packed_attention_grid(int dtype, const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Nq, int Nk, int D, int64_t qsb,
                               int64_t qsn, int64_t ksb, int64_t ksn, int64_t vsb,
                               int64_t vsn, float scale, void* stream) {
  return iret_packed_attention(dtype, q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, ksb, ksn,
                               vsb, vsn, scale, stream);
}

const char* iret_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
