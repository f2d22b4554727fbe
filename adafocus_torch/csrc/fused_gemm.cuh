// Shared pieces of the fused-block kernels (fused_inv_residual.cu,
// fused_bottleneck.cu): element conversion, the output tile a block owns,
// and one block-wide matrix product on CUDA cores.
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

}  // namespace fused
