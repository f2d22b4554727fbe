// int8 convolutions of the int8 serving forward, for Hopper (sm_90a).
//
// No Pallas kernel is replaced: the JAX package runs these products as XLA
// ops (adafocus_tpu/ops/quant.py:61-87, lax.conv_general_dilated and jnp.dot
// with preferred_element_type=int32). PyTorch has no CUDA int8 convolution
// with per-output-channel scales, and torch._int_mm refuses M <= 16, which
// a batch-1 GRU step needs, so both are written here.
//
// int8_conv: a dense convolution as an implicit GEMM. Rows are the N*Ho*Wo
// output pixels of an NHWC int8 input, columns the output channels, the
// depth the kh*kw*Cin taps in (ky, kx, ci) order; kh = kw in {1, 3}, stride
// 1 or 2, padding (kh - 1) / 2. The weight comes packed once by the host
// (ops/quant.py pack_conv_weight): (Cout_pad, K_pad) int8, each row one
// output channel's depth, zero-padded to the tile. The same kernel serves
// every 1x1 conv, the 3x3 convs and the heads' int8_dense (a 1x1 conv over
// (M, 1, 1, K)). Bound: operations at the large shapes (int8 tensor cores,
// 1979 TOP/s dense on an H100 SXM), bytes at the small-depth 1x1 units and
// the heads. Design, simple and right first: a 64 x 64 output tile a block
// of 4 warps (2 x 2, 32 x 32 each), the depth in steps of 64 staged through
// shared memory by plain 16-byte loads into registers (the next step's
// loads in flight while the current step multiplies), products by
// mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores. The shared rows are
// 80 bytes apart, so each fragment load of a warp hits 32 distinct banks.
// A depth tail (Cin = 24 in two expand units; K not a multiple of 64) reads
// as zeros; an input row that is not 16-byte aligned (Cin % 16 != 0) is
// gathered byte by byte. wgmma and TMA are later work.
//
// int8_dwconv: a depthwise 3x3 convolution, stride 1 or 2, padding 1, on
// the CUDA cores: one thread 16 channels (one 16-byte load of input and of
// taps per tap) of one output pixel, or one channel where C % 16 != 0.
// Bound: bytes (9 products a value read).
//
// The epilogue of both, as JAX computes it and XLA:CPU contracts it:
// y = fma(float(acc), rescale[c], bias[c]) with rescale = x_scale * w_scale
// (float32, made by the host), then none / ReLU / ReLU6, then a store in
// float32 or bf16 (round to nearest even); out_kind 2 stores the int32
// accumulator itself, for the tests. The FMA is spelled out (__fmaf_rn):
// nvcc would contract on its own, but the contract should not rest on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 16;  // bytes between two rows of a shared tile
constexpr int THREADS = 128;

enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2 };
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

__device__ __forceinline__ float epilogue(int acc, float rescale, float bias, int act) {
  float y = __fmaf_rn(__int2float_rn(acc), rescale, bias);
  if (act != ACT_NONE) y = fmaxf(y, 0.0f);
  if (act == ACT_RELU6) y = fminf(y, 6.0f);
  return y;
}

template <int KIND>
__device__ __forceinline__ void store(void* out, long long i, int acc, const float* rescale,
                                      const float* bias, int c, int act) {
  if (KIND == OUT_I32) {
    static_cast<int*>(out)[i] = acc;
  } else {
    const float y = epilogue(acc, rescale[c], bias[c], act);
    if (KIND == OUT_F32)
      static_cast<float*>(out)[i] = y;
    else
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct ConvGeom {
  long long m;           // GEMM rows: N * Ho * Wo
  int h, w, cin, ho, wo, cout;
  int k, kpad;           // depth kh*kw*Cin, and the packed weight's row length
  int kw, stride, pad, act;
};

// one GEMM row's input pixel: its image and the top-left tap's position
struct RowSrc {
  const int8_t* image;   // nullptr: the row is past M
  int iy0, ix0;
};

__device__ __forceinline__ RowSrc row_source(const int8_t* x, const ConvGeom& g, long long m) {
  RowSrc r{nullptr, 0, 0};
  if (m < g.m) {
    const int ox = (int)(m % g.wo);
    const long long q = m / g.wo;
    const int oy = (int)(q % g.ho);
    const long long n = q / g.ho;
    r.image = x + n * g.h * g.w * (long long)g.cin;
    r.iy0 = oy * g.stride - g.pad;
    r.ix0 = ox * g.stride - g.pad;
  }
  return r;
}

// the input byte at depth k of a row, zero outside the image and past K
__device__ __forceinline__ int8_t a_byte(const RowSrc& r, const ConvGeom& g, int k) {
  if (r.image == nullptr || k >= g.k) return 0;
  const int tap = k / g.cin, ci = k - tap * g.cin;
  const int ky = tap / g.kw, kx = tap - ky * g.kw;
  const int iy = r.iy0 + ky, ix = r.ix0 + kx;
  if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return 0;
  return r.image[((long long)iy * g.w + ix) * g.cin + ci];
}

// 16 input bytes at depths k0..k0+15 of a row
template <bool VEC>
__device__ __forceinline__ int4 a_chunk(const RowSrc& r, const ConvGeom& g, int k0) {
  int4 v = make_int4(0, 0, 0, 0);
  if (VEC) {  // Cin % 16 == 0: the chunk lies in one tap, 16-byte aligned
    if (r.image == nullptr || k0 >= g.k) return v;
    const int tap = k0 / g.cin, ci = k0 - tap * g.cin;
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
    const int iy = r.iy0 + ky, ix = r.ix0 + kx;
    if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return v;
    return *reinterpret_cast<const int4*>(r.image + ((long long)iy * g.w + ix) * g.cin + ci);
  }
  uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    word[b >> 2] |= (uint32_t)(uint8_t)a_byte(r, g, k0 + b) << (8 * (b & 3));
  return make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]);
}

template <bool VEC, int KIND>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
            const float* __restrict__ rescale, const float* __restrict__ bias, void* out,
            ConvGeom g) {
  __shared__ __align__(16) int8_t as[2][BM * LDS];
  __shared__ __align__(16) int8_t bs[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int grp = lane >> 2, tig = lane & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's two rows of each tile (r and r + 32) and its 16-byte chunk j
  const int r = tid >> 2, j = tid & 3;
  const RowSrc src[2] = {row_source(x, g, m0 + r), row_source(x, g, m0 + r + 32)};
  const int8_t* wrow[2] = {wq + (long long)(n0 + r) * g.kpad + j * 16,
                           wq + (long long)(n0 + r + 32) * g.kpad + j * 16};

  int acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  int4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int k0 = kt * BK + j * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ra[i] = a_chunk<VEC>(src[i], g, k0);
      rb[i] = *reinterpret_cast<const int4*>(wrow[i] + kt * BK);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<int4*>(&as[buf][(r + 32 * i) * LDS + j * 16]) = ra[i];
      *reinterpret_cast<int4*>(&bs[buf][(r + 32 * i) * LDS + j * 16]) = rb[i];
    }
  };

  const int nk = g.kpad / BK;
  load(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = &as[buf][(wm * 32 + mt * 16 + grp) * LDS + ks * 32 + tig * 4];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = &bs[buf][(wn * 32 + nt * 8 + grp) * LDS + ks * 32 + tig * 4];
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    if (kt + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm * 32 + mt * 16 + grp + 8 * half;
      if (row >= g.m) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + nt * 8 + tig * 2 + e;
          if (col < g.cout)
            store<KIND>(out, row * g.cout + col, acc[mt][nt][2 * half + e], rescale, bias, col,
                        g.act);
        }
      }
    }
  }
}

// signed byte b (0..3) of a word
__device__ __forceinline__ int sbyte(int word, int b) { return (word << (24 - 8 * b)) >> 24; }

template <int VEC, int KIND>
__global__ void __launch_bounds__(256)
dwconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w9,
              const float* __restrict__ rescale, const float* __restrict__ bias, void* out,
              long long total, int h, int w, int c, int ho, int wo, int stride, int act) {
  const int groups = c / VEC;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(i % groups) * VEC;
    const long long p = i / groups;  // output pixel
    const int ox = (int)(p % wo);
    const long long q = p / wo;
    const int oy = (int)(q % ho);
    const long long n = q / ho;
    int acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int iy = oy * stride - 1 + ky;
      if (iy < 0 || iy >= h) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int ix = ox * stride - 1 + kx;
        if (ix < 0 || ix >= w) continue;
        const int8_t* xs = x + ((n * h + iy) * w + ix) * (long long)c + c0;
        const int8_t* ws = w9 + (ky * 3 + kx) * c + c0;
        if (VEC == 16) {
          const int4 xv = *reinterpret_cast<const int4*>(xs);
          const int4 wv = __ldg(reinterpret_cast<const int4*>(ws));
          const int xw[4] = {xv.x, xv.y, xv.z, xv.w}, ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] += sbyte(xw[v >> 2], v & 3) * sbyte(ww[v >> 2], v & 3);
        } else {
          acc[0] += (int)xs[0] * (int)ws[0];
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      store<KIND>(out, p * c + c0 + v, acc[v], rescale, bias, c0 + v, act);
  }
}

template <bool VEC>
cudaError_t launch_conv(const int8_t* x, const int8_t* wq, const float* rescale, const float* bias,
                        void* out, const ConvGeom& g, int cout_pad, int out_kind,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)((g.m + BM - 1) / BM), (unsigned)(cout_pad / BN));
  if (out_kind == OUT_F32)
    conv_kernel<VEC, OUT_F32><<<grid, THREADS, 0, stream>>>(x, wq, rescale, bias, out, g);
  else if (out_kind == OUT_BF16)
    conv_kernel<VEC, OUT_BF16><<<grid, THREADS, 0, stream>>>(x, wq, rescale, bias, out, g);
  else
    conv_kernel<VEC, OUT_I32><<<grid, THREADS, 0, stream>>>(x, wq, rescale, bias, out, g);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_dw(const int8_t* x, const int8_t* w9, const float* rescale, const float* bias,
                      void* out, int n, int h, int w, int c, int ho, int wo, int stride, int act,
                      int out_kind, cudaStream_t stream) {
  const long long total = (long long)n * ho * wo * (c / VEC);
  const long long blocks = (total + 255) / 256;
  const unsigned grid = (unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30));
  if (out_kind == OUT_F32)
    dwconv_kernel<VEC, OUT_F32><<<grid, 256, 0, stream>>>(x, w9, rescale, bias, out, total, h, w,
                                                          c, ho, wo, stride, act);
  else if (out_kind == OUT_BF16)
    dwconv_kernel<VEC, OUT_BF16><<<grid, 256, 0, stream>>>(x, w9, rescale, bias, out, total, h, w,
                                                           c, ho, wo, stride, act);
  else
    dwconv_kernel<VEC, OUT_I32><<<grid, 256, 0, stream>>>(x, w9, rescale, bias, out, total, h, w,
                                                          c, ho, wo, stride, act);
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) int8; wq (Cout_pad, K_pad) int8 packed; rescale, bias
// (Cout,) float32; out (N, Ho, Wo, Cout) of out_kind (0 float32, 1 bf16,
// 2 int32 accumulators); m = N * Ho * Wo; act 0 none, 1 ReLU, 2 ReLU6; vec:
// Cin % 16 == 0 and x 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int int8_conv(const void* x, const void* wq, const void* rescale, const void* bias,
                         void* out, long long m, int h, int w, int cin, int ho, int wo, int cout,
                         int k, int kpad, int cout_pad, int kh, int stride, int pad, int act,
                         int vec, int out_kind, void* stream) {
  if (kpad % BK || cout_pad % BN || cout > cout_pad || k > kpad || m <= 0)
    return (int)cudaErrorInvalidValue;
  const ConvGeom g{m, h, w, cin, ho, wo, cout, k, kpad, kh, stride, pad, act};
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(wq);
  const auto* rp = static_cast<const float*>(rescale);
  const auto* bp = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_conv<true>(xp, wp, rp, bp, out, g, cout_pad, out_kind, s)
                   : launch_conv<false>(xp, wp, rp, bp, out, g, cout_pad, out_kind, s));
}

// x (N, H, W, C) int8; w9 (9, C) int8 taps; out (N, Ho, Wo, C); vec: C % 16
// == 0 with x and w9 16-byte aligned.
extern "C" int int8_dwconv(const void* x, const void* w9, const void* rescale, const void* bias,
                           void* out, int n, int h, int w, int c, int ho, int wo, int stride,
                           int act, int vec, int out_kind, void* stream) {
  if (n <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w9);
  const auto* rp = static_cast<const float*>(rescale);
  const auto* bp = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_dw<16>(xp, wp, rp, bp, out, n, h, w, c, ho, wo, stride, act,
                                   out_kind, s)
                   : launch_dw<1>(xp, wp, rp, bp, out, n, h, w, c, ho, wo, stride, act,
                                  out_kind, s));
}
