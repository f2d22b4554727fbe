// Shared pieces of the fused-block kernels (fused_inv_residual.cu,
// fused_bottleneck.cu): element conversion, the output tile a block owns,
// one block-wide matrix product on CUDA cores (block_gemm, the float32
// kernels) and the tensor-core pieces of the bf16 kernels (namespace tc).
//
// block_gemm computes C[M][N] = sum_k A(m, k) B(k, n) with all 256 threads
// of the block: 64 x 64 output tiles, a 16 x 16 grid of threads each
// holding a 4 x 4 micro tile of float32 sums in registers, and K walked in
// chunks of 32 that are staged through shared memory as float32. A and B
// are read through loaders, so one routine serves every contraction of both
// blocks: a 1x1 conv over pixels of a device-memory tensor, a 3x3 conv as
// nine taps gathered from a hidden tile in shared memory, the project and
// downsample 1x1 convs. The epilogue sees each finished sum once, from the
// thread that owns it. Products of bf16 values are exact in float32, so a
// bf16 product differs from the plain version only by summation order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kSA = kBM + 4;  // row stride of the staged A chunk (keeps float4 reads aligned)
constexpr int kStageFloats = kBK * kSA + kBK * kBN;
constexpr int kStageBytes = kStageFloats * 4;  // ops/fused_blocks.py STAGE_BYTES
constexpr int kARows = kBM * kBK / kThreads;   // A rows each thread stages per chunk
constexpr int kBRows = kBK * kBN / kThreads;   // B rows each thread stages per chunk
constexpr int kSmemMax = 232448;               // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// The output tile of this block and the input region it reads. Blocks run
// over (groups of g samples) x (output tiles of th x tw); the region is the
// tile's 3x3 receptive field clipped to the image, so a halo pixel outside
// the image is never stored and reads as 0.
struct Tile {
  long long n0;    // first sample
  int ge;          // samples in this group (the last group may be short)
  int oy0, ox0;    // first output pixel
  int oth, otw;    // output tile size (edge tiles may be smaller)
  int iy0, ix0;    // first input pixel of the region
  int rh, rw;      // region size
};

__device__ __forceinline__ Tile tile_of(long long n, int g, int th, int tw, int h, int w,
                                        int h_out, int w_out, int s) {
  Tile t;
  t.n0 = (long long)blockIdx.x * g;
  t.ge = (int)min((long long)g, n - t.n0);
  const int tiles_x = (w_out + tw - 1) / tw;
  const int ty = blockIdx.y / tiles_x, tx = blockIdx.y - ty * tiles_x;
  t.oy0 = ty * th;
  t.ox0 = tx * tw;
  t.oth = min(th, h_out - t.oy0);
  t.otw = min(tw, w_out - t.ox0);
  t.iy0 = max(t.oy0 * s - 1, 0);
  t.ix0 = max(t.ox0 * s - 1, 0);
  t.rh = min((t.oy0 + t.oth - 1) * s + 1, h - 1) - t.iy0 + 1;
  t.rw = min((t.ox0 + t.otw - 1) * s + 1, w - 1) - t.ix0 + 1;
  return t;
}

// Host side: the largest region a tile of t outputs reads (the smem layout).
inline int region_max(int t, int s, int size) {
  const int r = (t - 1) * s + 3;
  return r < size ? r : size;
}

// A(m, k) = x[pixel m][k] over the region's pixels, m = (g * rh + ry) * rw + rx.
template <typename T>
struct RegionA {
  const T* x;
  long long n0;
  int h, w, c, rh, rw, iy0, ix0;
  using Row = long long;  // element offset of the pixel in x
  using Col = int;
  __device__ Row row(int m) const {
    const int rpx = rh * rw;
    const int g = m / rpx, r = m - g * rpx;
    const int ry = r / rw, rx = r - ry * rw;
    return (((n0 + g) * h + iy0 + ry) * (long long)w + ix0 + rx) * c;
  }
  __device__ Col col(int k) const { return k; }
  __device__ float at(Row r, Col k) const { return to_f(x[r + k]); }
};

// A(m, k) = p[m * ld + k], a row-major tile in shared memory.
template <typename T>
struct SmemA {
  const T* p;
  int ld;
  using Row = int;
  using Col = int;
  __device__ Row row(int m) const { return m * ld; }
  __device__ Col col(int k) const { return k; }
  __device__ float at(Row r, Col k) const { return to_f(p[r + k]); }
};

template <typename A, typename B, typename Epi>
__device__ void block_gemm(int M, int N, int K, const A& a, const B& b, const Epi& epi,
                           float* stage) {
  float* sA = stage;              // [kBK][kSA], k-major
  float* sB = stage + kBK * kSA;  // [kBK][kBN]
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int a_kk = tid % kBK, a_mm = tid / kBK;
  const int b_nn = tid % kBN, b_kk = tid / kBN;
  for (int m0 = 0; m0 < M; m0 += kBM) {
    typename A::Row rows[kARows];
#pragma unroll
    for (int r = 0; r < kARows; ++r)
      rows[r] = a.row(min(m0 + a_mm + r * (kThreads / kBK), M - 1));
    for (int n0 = 0; n0 < N; n0 += kBN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kBK) {
        const int k = k0 + a_kk;
        const typename A::Col col = a.col(min(k, K - 1));
#pragma unroll
        for (int r = 0; r < kARows; ++r) {
          const int mm = a_mm + r * (kThreads / kBK);
          sA[a_kk * kSA + mm] = (k < K && m0 + mm < M) ? a.at(rows[r], col) : 0.f;
        }
        const int n = n0 + b_nn;
#pragma unroll
        for (int r = 0; r < kBRows; ++r) {
          const int kk = b_kk + r * (kThreads / kBN);
          sB[kk * kBN + b_nn] = (n < N && k0 + kk < K) ? b(k0 + kk, n) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          const float4 av = *reinterpret_cast<const float4*>(sA + kk * kSA + tr * 4);
          const float4 bv = *reinterpret_cast<const float4*>(sB + kk * kBN + tc * 4);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tc * 4 + j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Tensor-core products for bf16 operands with float32 sums (sm_90a only).
//
// The float32 kernels keep block_gemm on CUDA cores: TF32 tensor cores keep
// about three decimal digits, and float32 is the yardstick the port is held
// to (1e-4 against the plain version, 1e-3 against the unfused forward).
//
// One warpgroup (4 warps) issues wgmma.mma_async m64nNk16, bf16 -> f32:
//  - A (64 rows x 16) comes from registers, loaded by ldmatrix from one row
//    pointer per lane into shared memory. A gathered operand (the nine taps
//    of a 3x3 conv, a region's pixels) needs no staging copy; a tap outside
//    the image points at a zero row. Rows are padded by 16 bytes (kPad) so
//    the eight rows of one ldmatrix fall on different banks;
//  - B (16 x N) comes from shared memory in the no-swizzle "MN-major"
//    layout: core matrices of 8 k-rows x 8 n (128 contiguous bytes), n-groups
//    128 bytes apart, k-groups nb * 16 bytes apart for a tile nb wide. A
//    row-major (K, N) weight is copied into it in 16-byte pieces as it lies
//    in device memory;
//  - D (64 x N) stays in registers: thread (warp w of the group, lane l)
//    holds rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1), register
//    4j + 2h + e for row half h and column e.
// N is any multiple of 8 up to 256, issued as power-of-two pieces.
// Operands reach shared memory by cp.async (16 bytes a thread, zero-filled
// past an edge; element by element where a row is not 16-byte aligned): the
// gathered rows (copy8) and row-major weights (load_b). In the bottleneck
// they stream through a ring of stages, 32 or 64 deep, stages - 1 steps ahead
// of the product (pipeline), with weight tiles that the host packed in this
// layout arriving by one bulk copy each (cp.async.bulk on an mbarrier). Each
// step's products are waited for before the next step: an in-flight wgmma
// reads its A registers, which the next step's ldmatrix would overwrite.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRingK = 64;     // depth of one ring stage at most (the plan picks 32 or 64)
constexpr int kMaxStages = 8;  // ring stages at most (the plan picks 3 to 8)
constexpr int kPad = 8;        // padding of a shared-memory A row, elements (16 bytes)

// bytes of one 64-row A tile of the ring, depth deep
__host__ __device__ inline int a_tile_bytes(int depth) { return 64 * (depth + kPad) * 2; }

__host__ __device__ inline int align128(int v) { return (v + 127) / 128 * 128; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp_wait<n> for a run-time n < kMaxStages
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    default: cp_wait<6>(); break;
  }
}
// this thread's shared-memory writes become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p))
               : "memory");
}

// mbarriers that count the bytes of bulk copies (one arrival, by the thread
// that issues the copy)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Waits until bar completes the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// This lane's A fragment for k16 columns [k, k + 16) of the rows it points at:
// lane l gives row l % 16 of its warp's 16 rows, columns k + (l / 16) * 8.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* row, int k) {
  ldsm_x4(a, row + k + (threadIdx.x % 32) / 16 * 8);
}

// Descriptor of a B tile nb columns wide, at its k16 step s.
__device__ __forceinline__ uint64_t b_desc(const bf16* tile, int nb, int s) {
  const int kgroup = nb * 16;
  const uint32_t addr = smem_u32(tile) + s * 2 * kgroup;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(kgroup >> 4) << 16 |
         (uint64_t)(128 >> 4) << 32;
}

// D (+)= A B for one m64nNk16: scale_d 0 starts the sums afresh, 1 adds
template <int N>
__device__ __forceinline__ void wgmma_n(float* d, const uint32_t (&a)[4], uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_n<8>(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_n<16>(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_n<32>(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_n<64>(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_n<128>(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_n<256>(float* d, const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] over one warpgroup, N a multiple of 8,
// issued as power-of-two pieces; piece n-groups are 128 bytes apart in B.
template <int N, int Off = 0>
__device__ __forceinline__ void mma_k16(float* d, const uint32_t (&a)[4], uint64_t b, int scale_d) {
  constexpr int P = N >= 256 ? 256 : N >= 128 ? 128 : N >= 64 ? 64 : N >= 32 ? 32 : N >= 16 ? 16 : 8;
  wgmma_n<P>(d + Off / 2, a, b + (uint64_t)(Off / 8 * 128 >> 4), scale_d);
  if constexpr (N > P) mma_k16<N - P, Off + P>(d, a, b, scale_d);
}

// A 64 x N float32 accumulator of one warpgroup.
template <int N>
struct Acc {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma N");
  float d[N / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  }
  // keeps the compiler from moving register reads or writes across an
  // asynchronous product
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
  // f(row, col, v0, v1) for the two sums (row, col) and (row, col + 1) of each
  // pair this thread holds; rows within the 64-row tile
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        f(row, 8 * j + 2 * (lane % 4), d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
};

// The products of k16 steps [0, s1) (s1 <= kRingK / 16) into acc, waited
// for: A from this lane's row pointer at column k0 + 16 s, B from a tile nb
// wide. fresh: the first step starts the sums afresh (zeroing the registers
// instead would make ptxas serialize the products).
template <int N>
__device__ __forceinline__ void mma_steps(Acc<N>& acc, const bf16* arow, int k0, const bf16* b,
                                          int nb, int s1, bool fresh) {
  uint32_t a[kRingK / 16][4];
#pragma unroll
  for (int s = 0; s < kRingK / 16; ++s)
    if (s < s1) load_a(a[s], arow, k0 + 16 * s);
  wg_fence();
  acc.fence();
#pragma unroll
  for (int s = 0; s < kRingK / 16; ++s)
    if (s < s1) mma_k16<N>(acc.d, a[s], b_desc(b, nb, s), fresh && s == 0 ? 0 : 1);
  wg_commit();
  wg_wait<0>();
  acc.fence();
}

// dst[0, 8) = src[0, valid), zeros past it: one 16-byte asynchronous copy
// when src is 16-byte aligned, else element by element.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int valid, bool aligned) {
  if (aligned && valid > 0) {
    cp_async16(dst, src, valid >= 8 ? 16 : 2 * valid);
    return;
  }
  alignas(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? src[e] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// Rows [k0, k0 + bk) x columns [n0, n0 + nb) of a row-major (K, N) matrix
// into a B tile (nb a multiple of 8); rows past K and columns past N read 0.
// The tile's 16-byte piece lin * 8 + kr is k-row kr of piece group lin =
// kq * (nb / 8) + n-group: thread t copies k-row t % 8 of groups t / 8,
// t / 8 + 32, ..., so a warp writes whole core matrices. Shifts stand in for
// the divisions when nb / 8 is a power of two (every width but the inverted
// residual's 24-, 96- and 160-wide projects).
__device__ __forceinline__ void load_b(bf16* tile, int bk, int nb, const bf16* w, int K, int N,
                                       int k0, int n0) {
  const bool aligned = N % 8 == 0;
  const int groups = nb / 8, total = bk / 8 * groups, kr = threadIdx.x % 8;
  const bool pow2 = (groups & (groups - 1)) == 0;
  const int lg = __ffs(groups) - 1;
  for (int lin = threadIdx.x / 8; lin < total; lin += kThreads / 8) {
    const int g = pow2 ? lin & (groups - 1) : lin % groups;
    const int kq = pow2 ? lin >> lg : lin / groups;
    const int k = k0 + kq * 8 + kr, n = n0 + g * 8;
    copy8(tile + (lin * 8 + kr) * 8, w + (size_t)k * N + n, k < K ? N - n : 0, aligned);
  }
}

// Runs steps [0, n) through a ring of `stages` stages (3 to kMaxStages):
// load(i, stage, bar) issues the copies of step i, stages - 1 steps ahead:
// this block's threads' cp.async, waited for by each thread and a barrier,
// and exactly one bulk copy that completes on the stage's mbarrier `bar`,
// waited for before compute; compute(i, stage) multiplies step i and has
// finished reading its stage when it returns. `step` counts the steps of
// every pipeline of the block, so slots and mbarrier phases carry on from
// one pipeline to the next.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int n, int stages, unsigned char* ring, int stage_bytes,
                                         uint64_t* bars, int& step, Load load, Compute compute) {
  const int base = step;
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = (base + i) % stages;
    if (i < n) load(i, ring + slot * stage_bytes, bars + slot);
    cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_wait_n(stages - 2);
    fence_async();
    __syncthreads();
    const int j = i + stages - 1;
    if (j < n) {
      const int slot = (base + j) % stages;
      load(j, ring + slot * stage_bytes, bars + slot);
    }
    cp_commit();
    const int slot = (base + i) % stages;
    mbar_wait(bars + slot, ((base + i) / stages) & 1);
    compute(i, ring + slot * stage_bytes);
  }
  cp_wait<0>();
  __syncthreads();
  step = base + n;
}

}  // namespace tc

}  // namespace fused
