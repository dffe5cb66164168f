// K3 — implicit-GEMM int8 3x3 stride-1 SAME convolution for the PyTorch port.
//
// Replaces: image_restoration_and_enhancement_tpu/ops/conv_int8.py _kernel
//   (called from conv3x3_same_int8).
// Computes, for a pre-padded s8 input x [B, H+2, W+2, C], an s8 weight
// w [N, 3, 3, C] and an fp32 scale [N]:
//   out[b, y, x, n] = float(sum_{dy, dx, c} x[b, y+dy, x+dx, c] * w[n, dy, dx, c]) * scale[n]
// with the sum in int32 (exact) and out in fp32 or bf16, [B, H, W, N]. The
// epilogue converts each int32 sum to fp32 (round to nearest, as XLA's convert
// does), multiplies by scale[n] and rounds once to the output dtype, so every
// path is bitwise equal to the plain version.
//
// As a GEMM: M = B*H*W output pixels, N output channels, K = 9*C taps. What
// bounds it on the H100: at the UNet's widths (C, N = 320..2560) it does
// 2*M*N*9*C operations against about M*C + 9*C*N + 2*M*N bytes, hundreds of
// operations per byte, so the bound is the s8 tensor-core rate (1,979 TOP/s),
// except at the 8x8 level, where reading the weight once (up to 29 MB) takes
// longer than the products.
//
// The TPU kernel flattens the padded image so that each tap of an output row
// block is one contiguous input row range (computing two garbage columns per
// image row), and DMAs a [tile_m + halo, C] window per tile. Here no output is
// computed twice and the input needs no extra padding. Two paths, named by
// ops/conv_int8.py's conv_path() from the shape and passed in; the entry
// refuses a path its arguments cannot take and never picks another:
//
// - kSm90 (C a multiple of 64, N of 8, and 128-pixel output tiles that are
//   one rectangle of the image: W a multiple of 128, or W dividing 128 with
//   whole rows or whole images in a tile; every 3x3 conv of SD-1.5's UNet and
//   VAE): warp-specialised s8 wgmma + TMA, see conv3x3_int8_sm90_kernel. A
//   block computes a 128 x BN output tile. One producer thread walks the
//   K blocks (tap, 64- or 128-channel slice) and keeps a ring of stages full
//   with two TMA loads each: A is one box of a 4-D tensor map over the padded
//   x [B, H+2, W+2, C] at coordinates (c0, x0+dx, y0+dy, b0), so tap (dy, dx)
//   of the tile's pixels lands as a [128 pixels][KB] K-major tile with no
//   im2col; B is one box of a 2-D map over w viewed as [N, 9C]. Both use the
//   128-byte swizzle at KB = 128 (C % 128 == 0) and the 64-byte one at KB = 64
//   (C % 128 == 64: 320 and 960), so no box is padded with zeros. Two consumer
//   warpgroups of 64 rows each issue wgmma m64nBNk32 s32.s8.s8 from shared
//   memory and free a stage when the next stage's products are issued.
//   Split-K: where the M x N tiles give fewer blocks than the card has SMs (the
//   UNet's 8x8 and 16x16 levels: 10-40 tiles), conv_path's split factor S
//   divides the K blocks over S blocks of a third grid axis. Each writes its
//   int32 partial tile to a workspace; the last to arrive (a per-tile counter,
//   reset by that block) adds the others' partials, which is exact in any
//   order, and runs the epilogue, all in the one launch.
// - kMma (any C that is a multiple of 8; the shapes sm90's boxes cannot
//   address, such as TINY_SD's 8- and 16-channel convs): mma.sync m16n8k32 with
//   a 3-stage cp.async ring, see conv3x3_int8_mma_kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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

// The mma path. Each output pixel keeps its own input address: a thread
// computes the padded address of its pixel once per block, and tap (dy, dx)
// adds (dy*(W+2)+dx)*C, so the 1-pixel border of x makes the edges need no
// mask. Tiling: a block of 8 warps computes a 128 x 128 output tile; warp
// (wm, wn) owns 64 x 32 of it (4 x 4 m16n8 accumulators). K advances 64
// bytes a stage: two 32-channel chunks, each (tap, c0) with c0 a multiple of
// 32; channels
// past C are zero-filled by cp.async, so C need only be a multiple of 8 (the
// copy width: 16 bytes when C % 16 == 0, else 8). Fragments are read from
// shared memory with 32-bit loads; rows are padded to 80 bytes so the eight
// rows a load touches fall in eight different bank groups. The epilogue
// converts each int32 sum to fp32 (round to nearest, as XLA's convert does),
// multiplies by scale[n] and writes the output dtype.
template <typename OutT, int VEC>
__global__ void __launch_bounds__(kThreads)
conv3x3_int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
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
cudaError_t launch_mma(const void* x, const void* w, const float* scale, void* out, int B,
                       int H, int W, int C, int N, cudaStream_t stream) {
  auto kernel = conv3x3_int8_mma_kernel<OutT, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int M = B * H * W;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<OutT*>(out), H, W, C, N, M);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch_mma(const void* x, const void* w, const float* scale, void* out, int B,
                         int H, int W, int C, int N, cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  if (C % 16 == 0 && align % 16 == 0)
    return launch_mma<OutT, 16>(x, w, scale, out, B, H, W, C, N, stream);
  if (C % 8 == 0 && align % 8 == 0)
    return launch_mma<OutT, 8>(x, w, scale, out, B, H, W, C, N, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// sm90 path: warp-specialised s8 wgmma + TMA (see the top of the file).
//
// Shared memory holds STAGES stages, each an A tile [128 pixels][KB bytes]
// then a B tile [BN output channels][KB bytes], as TMA writes them with the
// KB-byte swizzle: rows KB bytes apart, 8-row swizzle atoms 8*KB bytes apart
// (the descriptors' SBO). Both operands are K-major, as s8 wgmma requires; a
// k-step of 32 channels is 32 bytes inside the atom. Consumer warpgroup wg
// takes A rows 64*wg .. 64*wg + 63. Its m64nBN s32 accumulator is BN/2
// registers a thread, laid out as mma.sync's m16n8 per warp: warp w, lane
// (g = lane/4, t = lane%4) holds rows 16w + g and 16w + g + 8, columns
// 8j + 2t and 8j + 2t + 1 of column block j in registers 4j .. 4j + 3.
// BN is 160 where N is a multiple of 160 (the UNet's 320, 640 and 1280: no
// column of a tile is wasted, and 2x64x64 -> 320 and 2x32x32 -> 1280 fill
// the card in one wave of 128 blocks), else 128 (the VAE's 128, 256, 512).
// ---------------------------------------------------------------------------

constexpr int kSmThreads = 384;      // two consumer warpgroups, then the producer's
constexpr int kSmConsumers = 256;

template <int KB, int BN>
struct Sm90 {
  static constexpr int STAGES = KB == 128 ? 4 : 8;
  static constexpr int ACC = BN / 2;  // s32 accumulators a consumer thread holds
  static constexpr int A_BYTES = kBM * KB;
  static constexpr int B_BYTES = BN * KB;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // 1024 for aligning the swizzle atoms, then the full and empty barriers.
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static constexpr uint64_t LAYOUT = KB == 128 ? 1 : 2;  // 128- or 64-byte swizzle
  static constexpr int SBO = 8 * KB;
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Grid: (M tiles, N tiles, splits). ws: int32 partial tiles [tiles][splits]
// [ACC][kSmConsumers]; counters: one int per tile, 0 between launches.
template <int KB, int BN, typename OutT>
__global__ void __launch_bounds__(kSmThreads, 1)
conv3x3_int8_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tw,
                         const float* __restrict__ scale, OutT* __restrict__ out,
                         int* __restrict__ ws, int* __restrict__ counters, int H, int W,
                         int C, int N, int M, int splits) {
  using Cf = Sm90<KB, BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + Cf::STAGES * Cf::STAGE_BYTES;  // full[s], then empty[s]
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int cpt = C / KB;  // K blocks per tap
  const int nkb = 9 * cpt;
  const int kb0 = (int)((int64_t)split * nkb / splits);
  const int kb1 = (int)((int64_t)(split + 1) * nkb / splits);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (Cf::STAGES + s), kSmConsumers / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == kSmConsumers) {
      const int hw = H * W;
      const int b0 = m0 / hw;
      const int y0 = (m0 - b0 * hw) / W;
      const int x0 = m0 - b0 * hw - y0 * W;
      for (int kb = kb0; kb < kb1; ++kb) {
        const int i = kb - kb0;
        const int s = i % Cf::STAGES;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (Cf::STAGES + s), ((i / Cf::STAGES) & 1) ^ 1);
        mbar_expect_tx(full, Cf::STAGE_BYTES);
        const int tap = kb / cpt;
        const int dy = tap / 3;
        const int dx = tap - 3 * dy;
        const uint32_t st = base + s * Cf::STAGE_BYTES;
        tma_load(st, &tx, full, (kb - tap * cpt) * KB, x0 + dx, y0 + dy, b0);
        tma_load_2d(st + Cf::A_BYTES, &tw, full, kb * KB, n0);
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows m0 + 64 wg .. + 63.
  const int ctid = threadIdx.x;
  const int lane = ctid & 31;
  int acc[Cf::ACC];
#pragma unroll
  for (int i = 0; i < Cf::ACC; ++i) acc[i] = 0;
  const int nk = kb1 - kb0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % Cf::STAGES;
    mbar_wait(bars + 8 * s, (i / Cf::STAGES) & 1);
    const uint32_t a = base + s * Cf::STAGE_BYTES + wg * 64 * KB;
    const uint32_t b = base + s * Cf::STAGE_BYTES + Cf::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks)
      wgmma_s8(acc, gmma_desc(a + ks * 32, 16, Cf::SBO, Cf::LAYOUT),
               gmma_desc(b + ks * 32, 16, Cf::SBO, Cf::LAYOUT), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    fence_regs(acc);
    if (i > 0 && lane == 0) mbar_arrive(bars + 8 * (Cf::STAGES + (i - 1) % Cf::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  if (splits > 1) {
    // Every split stores its partial tile; the last to arrive adds the others'.
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int64_t per = (int64_t)Cf::ACC * kSmConsumers;
    int* mine = ws + ((int64_t)tile * splits + split) * per;
#pragma unroll
    for (int j = 0; j < Cf::ACC; ++j) __stcg(mine + j * kSmConsumers + ctid, acc[j]);
    __threadfence();
    named_sync(1, kSmConsumers);
    if (ctid == 0) last = atomicAdd(counters + tile, 1) == splits - 1;
    named_sync(1, kSmConsumers);
    if (!last) return;
    __threadfence();
    for (int sp = 0; sp < splits; ++sp) {
      if (sp == split) continue;
      const int* p = ws + ((int64_t)tile * splits + sp) * per;
#pragma unroll
      for (int j = 0; j < Cf::ACC; ++j) acc[j] += __ldcg(p + j * kSmConsumers + ctid);
    }
    if (ctid == 0) counters[tile] = 0;
  }

  const int warp = (ctid & 127) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + t * 2;  // N is a multiple of 8: n < N means n + 1 < N
    if (n >= N) continue;
    const float s0 = scale[n];
    const float s1 = scale[n + 1];
    if (row0 < M)
      store_pair(out + (int64_t)row0 * N + n, (float)acc[4 * j] * s0, (float)acc[4 * j + 1] * s1);
    if (row1 < M)
      store_pair(out + (int64_t)row1 * N + n, (float)acc[4 * j + 2] * s0,
                 (float)acc[4 * j + 3] * s1);
  }
}

// The box of 128 output pixels a tile covers, (bw, bh, bb) pixels x rows x
// images, or false where no box is one rectangle of the image
// (ops/conv_int8.py sm90_box).
bool sm90_box(int H, int W, int* box) {
  if (W % kBM == 0) {
    box[0] = kBM, box[1] = 1, box[2] = 1;
    return true;
  }
  if (kBM % W != 0) return false;
  const int rows = kBM / W;
  if (rows <= H && H % rows == 0) {
    box[0] = W, box[1] = rows, box[2] = 1;
    return true;
  }
  if (kBM % (H * W) != 0) return false;
  box[0] = W, box[1] = H, box[2] = kBM / (H * W);
  return true;
}

CUtensorMapSwizzle swizzle(int KB) {
  return KB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// x as the 4-D map (c, x, y, b) of [B, H+2, W+2, C] s8, boxes (KB, bw, bh, bb);
// w as the 2-D map (k, n) of [N, 9C] s8, boxes (KB, BN).
bool make_maps(CUtensorMap* tx, CUtensorMap* tw, const void* x, const void* w, int B, int H,
               int W, int C, int N, int KB, int BN, const int* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W + 2, (cuuint64_t)H + 2,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C, (cuuint64_t)C * (W + 2),
                                  (cuuint64_t)C * (W + 2) * (H + 2)};
  const cuuint32_t xbox[4] = {(cuuint32_t)KB, (cuuint32_t)box[0], (cuuint32_t)box[1],
                              (cuuint32_t)box[2]};
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * C, (cuuint64_t)N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * C};
  const cuuint32_t wbox[2] = {(cuuint32_t)KB, (cuuint32_t)BN};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), xdims, xstrides, xbox,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(KB), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wdims, wstrides, wbox,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle(KB), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KB, int BN, typename OutT>
cudaError_t launch_sm90(const void* x, const void* w, const float* scale, void* out, int* ws,
                        int* counters, int B, int H, int W, int C, int N, int splits,
                        const int* box, cudaStream_t stream) {
  using Cf = Sm90<KB, BN>;
  auto kernel = conv3x3_int8_sm90_kernel<KB, BN, OutT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tx, tw;
  if (!make_maps(&tx, &tw, x, w, B, H, W, C, N, KB, BN, box)) return cudaErrorInvalidValue;
  const int M = B * H * W;
  dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN, splits);
  kernel<<<grid, kSmThreads, Cf::SMEM_BYTES, stream>>>(
      tx, tw, scale, static_cast<OutT*>(out), ws, counters, H, W, C, N, M, splits);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch_sm90(const void* x, const void* w, const float* scale, void* out, int* ws,
                          int* counters, int B, int H, int W, int C, int N, int splits,
                          cudaStream_t stream) {
  int box[3];
  const int KB = C % 128 == 0 ? 128 : 64;
  if (C % 64 != 0 || N % 8 != 0 || !sm90_box(H, W, box) || splits < 1 ||
      splits > 9 * C / KB || (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
    return cudaErrorInvalidValue;
#define IRET_LAUNCH_SM90(KB_, BN_)                                                        \
  return launch_sm90<KB_, BN_, OutT>(x, w, scale, out, ws, counters, B, H, W, C, N, splits, \
                                     box, stream)
  if (N % 160 == 0) {
    if (KB == 128) IRET_LAUNCH_SM90(128, 160);
    IRET_LAUNCH_SM90(64, 160);
  }
  if (KB == 128) IRET_LAUNCH_SM90(128, 128);
  IRET_LAUNCH_SM90(64, 128);
#undef IRET_LAUNCH_SM90
}

// Paths, as ops/conv_int8.py's conv_path() names them.
enum Path { kMma = 0, kSm90 = 1 };

template <typename OutT>
cudaError_t dispatch(int path, const void* x, const void* w, const float* scale, void* out,
                     int* ws, int* counters, int B, int H, int W, int C, int N, int splits,
                     cudaStream_t stream) {
  if (path == kSm90)
    return dispatch_sm90<OutT>(x, w, scale, out, ws, counters, B, H, W, C, N, splits, stream);
  if (path == kMma && splits == 1)
    return dispatch_mma<OutT>(x, w, scale, out, B, H, W, C, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// path: ops/conv_int8.py's conv_path() (enum Path); out_dtype: 0 = float32,
// 1 = bfloat16. x is a contiguous [B, H+2, W+2, C] s8, w a contiguous
// [N, 3, 3, C] s8, scale a contiguous [N] fp32, out a contiguous [B, H, W, N].
// splits: the K split of the sm90 path (1 on the mma path); with splits > 1,
// ws is int32 scratch of (M tiles x N tiles x splits x 128 x BN) and counters
// (M tiles x N tiles) int32 zeros, which the launch leaves zero; BN is 160
// where N % 160 == 0, else 128 (ops/conv_int8.py tile_n). A path the
// arguments cannot take is cudaErrorInvalidValue; no other path is tried.
int iret_conv3x3_int8(int path, int out_dtype, const void* x, const void* w, const void* scale,
                      void* out, void* ws, void* counters, int B, int H, int W, int C, int N,
                      int splits, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0) return cudaErrorInvalidValue;
  if ((int64_t)B * H * W >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  int* wsp = static_cast<int*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (out_dtype == 0)
    return dispatch<float>(path, x, w, sc, out, wsp, cnt, B, H, W, C, N, splits, s);
  if (out_dtype == 1)
    return dispatch<__nv_bfloat16>(path, x, w, sc, out, wsp, cnt, B, H, W, C, N, splits, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
