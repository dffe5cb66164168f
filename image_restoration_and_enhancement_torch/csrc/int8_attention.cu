// K4 — attention with an s8 Q.K^T for the PyTorch port: the entry, and the
// "mma" device code.
//
// Replaces: image_restoration_and_enhancement_tpu/ops/attention.py
//   _int8_attention_kernel (called from _pallas_int8_bhnd / pallas_int8_attention).
// Inputs, made by the wrapper (ops/attention.py) exactly as the JAX package
// makes them: q and k in s8 (q pre-scaled by 1/sqrt(d) in its own dtype, k
// smoothed by its token mean, both with one per-tensor scale over all B*H),
// their dequantization scale sq*sk as one fp32 on the device, and v. Per row:
//   s = float(q8 . k8) * (sq*sk*log2(e));  p = exp2(s - max)  (online over KV tiles)
//   P.V with P cast to v's dtype; the row sum l is taken over that cast P
//   (the TPU kernel's ones column of V); out = acc * (1 / l) in v's dtype.
// Keys past Nk score -inf.
//
// What bounds it on the H100: at the UNet's N = 4096 self-attention it does
// 2*N*N*d s8 operations and 2*N*N*d bf16 ones per (batch, head) against
// about 4*N*d bytes, far above the card's operations per byte: the bound is
// the tensor cores' (0.0326 ms at 2 x 4096 x 4096 x 8 x 40). At d = 40 the
// 268 M exponentials of that shape are a floor of their own on the MUFU units
// (~0.064 ms, csrc/attention.cu), as they are for K1: only a softmax that runs
// while another warpgroup's products run approaches it.
//
// Two paths, named by ops/attention.py's int8_kernel_path() from the arguments
// and passed in; the entry refuses a path its arguments cannot take and never
// picks another:
// - kSm90 (bf16 v, head_dim <= 160, rows TMA can address: every UNet site):
//   the sm90 attention kernel of csrc/attention.cu with the s8 score product
//   (S8QK): a producer warp keeps a ring of K8/V tiles in flight through TMA,
//   two consumer warpgroups of 64 query rows take turns on the tensor cores,
//   S = q8 k8^T by wgmma m64nBKk32 s32.s8.s8 from shared memory, P.V by bf16
//   wgmma with P in registers; KV tiles of 128 keys (64 at d = 160). q8 and k8
//   are read unpadded through a 3-D map over their [B, N, H*d] rows (an s8
//   head stride of 40 bytes is no legal TMA stride; a row of 320 is), v through
//   K1's 4-D map; the wrapper copies nothing.
// - kMma (fp32 v, for tests and parity runs; and rows TMA cannot address):
//   the first design, below, on contiguous zero-padded copies the wrapper makes.
//   One block of 4 warps takes 64 query rows, each warp 16 of them; per KV
//   tile of 64 keys a warp computes its 16 x 64 s32 score tile with mma.sync
//   m16n8k32 (head_dim zero-padded to DP, a multiple of 32), scales it in
//   fp32, updates the running max and sum, and multiplies P by V with mma.sync
//   m16n8k16 reusing the score accumulators as the A operand, as K1's mma code
//   does. K and V tiles are double-buffered with cp.async. For fp32 inputs,
//   P.V runs on CUDA cores from a per-warp P tile in shared memory, unrounded,
//   as the TPU kernel casts P to fp32 there.
//
// The TPU kernel holds all of K and V per (batch, head) and walks it in
// chunks of 1024 keys; the tiles here are 64 or 128 keys, so P is rounded to
// bf16 against other running maxima: the two agree to the bf16 rounding of P.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <typename VT>
struct VRow {
  static constexpr int pad = 16 / sizeof(VT);  // keeps rows 16-byte multiples
};

template <typename VT, int DP, int DV>
constexpr int smem_bytes() {
  return (kBQ + 2 * kBK) * (DP + 16) + 2 * kBK * (DV + VRow<VT>::pad) * (int)sizeof(VT) +
         (sizeof(VT) == 4 ? 4 * 16 * (kBK + 4) * 4 : 0);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sum of the two bf16 values packed in u.
__device__ __forceinline__ float sum_bf16x2(uint32_t u) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return f.x + f.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ROWS rows of WIDTH elements from rows [n0, n0 + ROWS) of a slice with row
// stride sn (elements), into shared memory with row stride SROW; rows past N
// are zero-filled. WIDTH * sizeof(T) is a multiple of 16.
template <typename T, int WIDTH, int ROWS, int SROW>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int n0, int N, int64_t sn) {
  constexpr int EPP = 16 / sizeof(T);
  constexpr int PPR = WIDTH / EPP;
  for (int i = threadIdx.x; i < ROWS * PPR; i += kThreads) {
    const int r = i / PPR;
    const int e = (i - r * PPR) * EPP;
    const int n = n0 + r;
    const bool valid = n < N;
    cp_async16(dst + r * SROW + e, valid ? src + (int64_t)n * sn + e : src, valid);
  }
}

template <typename VT, int DP, int DV>
__global__ void __launch_bounds__(kThreads)
int8_attention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                      const VT* __restrict__ v, const float* __restrict__ scale,
                      VT* __restrict__ o, int H, int Nq, int Nk, int D) {
  constexpr bool kBf16 = sizeof(VT) == 2;
  constexpr int QS = DP + 16;                   // s8 row stride (bytes)
  constexpr int VS = DV + VRow<VT>::pad;        // V row stride (elements)
  constexpr int KSL = DP / 32;                  // k-slices of Q K^T
  constexpr int NB = kBK / 8;                   // n-blocks of S
  constexpr int DB = DV / 8;                    // n-blocks of O
  constexpr int PS = kBK + 4;                   // fp32 P tile row stride
  static_assert(DP % 32 == 0 && DV % 16 == 0, "padded widths");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem_raw);           // [BQ][QS]
  int8_t* ks = qs + kBQ * QS;                                  // 2 x [BK][QS]
  VT* vs = reinterpret_cast<VT*>(ks + 2 * kBK * QS);           // 2 x [BK][VS]
  float* ps = reinterpret_cast<float*>(vs + 2 * kBK * VS);     // fp32: 4 x [16][PS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int8_t* qb = q + ((int64_t)b * Nq * H + h) * DP;
  const int8_t* kb = k + ((int64_t)b * Nk * H + h) * DP;
  const VT* vb = v + ((int64_t)b * Nk * H + h) * DV;
  const int64_t qkn = (int64_t)H * DP;
  const int64_t vn = (int64_t)H * DV;
  const int ntiles = (Nk + kBK - 1) / kBK;
  const float scale_log2 = scale[0] * 1.4426950408889634f;

  load_rows<int8_t, DP, kBQ, QS>(qs, qb, q0, Nq, qkn);
  load_rows<int8_t, DP, kBK, QS>(ks, kb, 0, Nk, qkn);
  load_rows<VT, DV, kBK, VS>(vs, vb, 0, Nk, vn);
  cp_async_commit();

  uint32_t qf[KSL][4];
  float oacc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    if (it + 1 < ntiles) {  // prefetch the next tile into the other buffer
      const int nxt = (it + 1) & 1;
      load_rows<int8_t, DP, kBK, QS>(ks + nxt * kBK * QS, kb, k0 + kBK, Nk, qkn);
      load_rows<VT, DV, kBK, VS>(vs + nxt * kBK * VS, vb, k0 + kBK, Nk, vn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      const int8_t* qw = qs + warp * 16 * QS + t * 4;
#pragma unroll
      for (int j = 0; j < KSL; ++j) {
        qf[j][0] = lds32(qw + g * QS + j * 32);
        qf[j][1] = lds32(qw + (g + 8) * QS + j * 32);
        qf[j][2] = lds32(qw + g * QS + j * 32 + 16);
        qf[j][3] = lds32(qw + (g + 8) * QS + j * 32 + 16);
      }
    }
    const int8_t* kt = ks + (it & 1) * kBK * QS;
    const VT* vt = vs + (it & 1) * kBK * VS;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* kr = kt + (nb * 8 + g) * QS + t * 4;
#pragma unroll
      for (int j = 0; j < KSL; ++j) mma_s8(acc, qf[j], lds32(kr + j * 32), lds32(kr + j * 32 + 16));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nb * 8 + t * 2 + (i & 1);
        s[nb][i] = col < Nk ? (float)acc[i] * scale_log2 : -INFINITY;
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Every tile holds at least one key < Nk, so the new maxima are finite.
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - n0);
      s[nb][1] = exp2f(s[nb][1] - n0);
      s[nb][2] = exp2f(s[nb][2] - n1);
      s[nb][3] = exp2f(s[nb][3] - n1);
    }
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      oacc[j][0] *= a0;
      oacc[j][1] *= a0;
      oacc[j][2] *= a1;
      oacc[j][3] *= a1;
    }
    float r0 = 0.f, r1 = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        r0 += sum_bf16x2(pa[0]) + sum_bf16x2(pa[2]);
        r1 += sum_bf16x2(pa[1]) + sum_bf16x2(pa[3]);
        // lane l addresses key row j*16 + (l & 15) at d-block db + (l >> 4)
        const VT* vrow = vt + (j * 16 + (lane & 15)) * VS + (lane >> 4) * 8;
#pragma unroll
        for (int db = 0; db < DB; db += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vrow + db * 8);
          mma_bf16(oacc[db], pa, bf[0], bf[1]);
          mma_bf16(oacc[db + 1], pa, bf[2], bf[3]);
        }
      }
    } else {
      float* pw = ps + warp * 16 * PS;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + t * 2;
        pw[g * PS + c] = s[nb][0];
        pw[g * PS + c + 1] = s[nb][1];
        pw[(g + 8) * PS + c] = s[nb][2];
        pw[(g + 8) * PS + c + 1] = s[nb][3];
        r0 += s[nb][0] + s[nb][1];
        r1 += s[nb][2] + s[nb][3];
      }
      __syncwarp();
      for (int c = 0; c < kBK; ++c) {
        const float p0 = pw[g * PS + c];
        const float p1 = pw[(g + 8) * PS + c];
        const VT* vr = vt + c * VS + t * 2;
#pragma unroll
        for (int db = 0; db < DB; ++db) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float vv = static_cast<float>(vr[db * 8 + i]);
            oacc[db][i] = fmaf(p0, vv, oacc[db][i]);
            oacc[db][2 + i] = fmaf(p1, vv, oacc[db][2 + i]);
          }
        }
      }
      __syncwarp();
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  VT* o0 = o + (((int64_t)b * Nq + row0) * H + h) * D;
  VT* o1 = o + (((int64_t)b * Nq + row1) * H + h) * D;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = db * 8 + t * 2 + i;
      if (d < D) {
        if (row0 < Nq) store(o0 + d, oacc[db][i] * inv0);
        if (row1 < Nq) store(o1 + d, oacc[db][2 + i] * inv1);
      }
    }
  }
}

template <typename VT, int DP, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const float* scale, void* o,
                   int B, int H, int Nq, int Nk, int D, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<VT, DP, DV>();
  auto kernel = int8_attention_kernel<VT, DP, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const VT*>(v), scale, static_cast<VT*>(o), H, Nq, Nk, D);
  return cudaGetLastError();
}

// Padded widths (DP for s8 Q/K, DV for V) instantiated: SD-1.5's head dims 40,
// 80 and 160 and the tiny test widths (<= 16). ops/attention.py pads to the
// same table (_INT8_WIDTHS).
bool mma_widths(int D, int* DP, int* DV) {
  const int table[4][3] = {{16, 32, 16}, {48, 64, 48}, {80, 96, 80}, {160, 160, 160}};
  for (const auto& row : table) {
    if (D <= row[0]) {
      *DP = row[1];
      *DV = row[2];
      return true;
    }
  }
  return false;
}

template <typename VT>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* scale,
                     void* o, int B, int H, int Nq, int Nk, int D, int DP, int DV,
                     cudaStream_t s) {
  if (DP == 32) return launch<VT, 32, 16>(q, k, v, scale, o, B, H, Nq, Nk, D, s);
  if (DP == 64) return launch<VT, 64, 48>(q, k, v, scale, o, B, H, Nq, Nk, D, s);
  if (DP == 96) return launch<VT, 96, 80>(q, k, v, scale, o, B, H, Nq, Nk, D, s);
  return launch<VT, 160, 160>(q, k, v, scale, o, B, H, Nq, Nk, D, s);
}

// Whether strides (b, n, h) are those of a contiguous [B, N, H, W].
bool contiguous(const int64_t* st, int N, int H, int W) {
  return st[0] == (int64_t)N * H * W && st[1] == (int64_t)H * W && st[2] == W;
}

// Paths, as ops/attention.py's int8_kernel_path() names them (the codes of
// csrc/attention.cu's enum Path).
enum Path { kMma = 1, kSm90 = 2 };

}  // namespace

extern "C" int iret_int8_attention_sm90(const void* q, const void* k, const void* v,
                                        const void* sq_sk, void* o, int B, int H, int Nq,
                                        int Nk, int D, const int64_t* qs, const int64_t* ks,
                                        const int64_t* vs, void* stream);

extern "C" {

// K4. path: ops/attention.py's int8_kernel_path() (enum Path); vdtype: 0 =
// float32, 1 = bfloat16 (v's and o's dtype). q8 and k8 are s8 [B, N, H, D]
// views and v a [B, Nk, H, D] view, with element strides (b, n, h) and unit
// stride on the last axis; scale one fp32 (sq * sk) on the device; o a
// contiguous [B, Nq, H, D] in v's dtype.
// - kSm90 (bf16 v, D <= 160): q8 and k8 with heads packed in their rows and
//   16-byte aligned row and batch strides, v with rows TMA can address
//   (csrc/attention.cu, iret_int8_attention_sm90).
// - kMma (float32 or bfloat16 v): contiguous q8 and k8 zero-padded to DP and
//   v to DV (mma_widths).
// A path the arguments cannot take is cudaErrorInvalidValue; no other path is
// tried.
int iret_int8_attention(int path, int vdtype, const void* q, const void* k, const void* v,
                        const void* scale, void* o, int B, int H, int Nq, int Nk, int D,
                        int64_t qsb, int64_t qsn, int64_t qsh, int64_t ksb, int64_t ksn,
                        int64_t ksh, int64_t vsb, int64_t vsn, int64_t vsh, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0 || D <= 0) return cudaErrorInvalidValue;
  const int64_t qs[3] = {qsb, qsn, qsh};
  const int64_t ks[3] = {ksb, ksn, ksh};
  const int64_t vs[3] = {vsb, vsn, vsh};
  if (path == kSm90) {
    if (vdtype != 1) return cudaErrorInvalidValue;
    return iret_int8_attention_sm90(q, k, v, scale, o, B, H, Nq, Nk, D, qs, ks, vs, stream);
  }
  int DP, DV;
  if (path != kMma || !mma_widths(D, &DP, &DV) || !contiguous(qs, Nq, H, DP) ||
      !contiguous(ks, Nk, H, DP) || !contiguous(vs, Nk, H, DV))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (vdtype == 0)
    return dispatch<float>(q, k, v, sc, o, B, H, Nq, Nk, D, DP, DV, s);
  if (vdtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, sc, o, B, H, Nq, Nk, D, DP, DV, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
