// One MobileNetV2 inverted residual (inference, BatchNorm folded) in one
// launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_inverted_residual
// (adafocus_tpu/ops/fused_blocks.py, _inv_residual_kernel):
//   hidden = relu6(x . w_expand + b_expand), rounded to the compute dtype
//            (or x itself when there is no expand)
//   dw     = relu6(3x3 depthwise(hidden, stride 1 or 2, zero pad 1) + b_dw),
//            float32 taps and weights, rounded to the compute dtype
//   out    = dw . w_project + b_project (+ x when use_res), cast once
// over channels-last (N, H, W, C) tensors, bf16 or float32. The compute
// dtype is the input's; every sum is float32.
//
// Bound: bytes for most of the glancer's blocks. Fusing keeps the 6x wider
// hidden tensor out of device memory, so the least the block must move is x
// read once and out written once (plus weights). At the flagship (N=1024,
// bf16) the 17 blocks move 3.1 GB and do 0.55 TFLOP.
//
// Design: one block of 256 threads per (group of g samples, output tile of
// th x tw pixels); the host picks the plan (ops/fused_blocks.py
// plan_inv_residual). The hidden channels are walked in chunks of ch: the
// depthwise conv is per channel, so each chunk's expand -> depthwise runs on
// its own, and its share of the project accumulates in a float32 tile in
// shared memory. Per chunk:
//   1. expand (block_gemm) over the tile's input region, the 3x3 receptive
//      field clipped to the image, into `hid` in shared memory;
//   2. depthwise: one thread per (output pixel, channel); a tap outside the
//      image reads 0, which is the zero padding of the activated hidden
//      (not the expand of a zero input: relu6(bias) is not 0);
//   3. project (block_gemm) of the chunk into the accumulator.
// Only the strided outputs are computed, H' = (H - 1) // s + 1, so odd sizes
// (9 -> 5) need nothing special. x is read through L1/L2 from device
// memory; products run on CUDA cores in float32 (block_gemm). Tensor cores,
// TMA and pipelining are left for later.

#include "fused_gemm.cuh"

namespace {

using namespace fused;

struct InvResArgs {
  const void* x;
  const void* w_exp;    // (cin, chid), compute dtype; unused without expand
  const float* b_exp;   // (chid,)
  const float* w_dw;    // (9, chid), float32, tap dy * 3 + dx
  const float* b_dw;    // (chid,)
  const void* w_prj;    // (chid, cout), compute dtype
  const float* b_prj;   // (cout,)
  void* out;
  long long n;
  int h, w, cin, chid, cout, stride, h_out, w_out;
  int expand, use_res;
  int th, tw, g, ch;    // plan: output tile, samples per block, hidden chunk
  int rh_max, rw_max;   // largest region (shared-memory layout)
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) inv_residual_kernel(const InvResArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float* acc = stage + kStageFloats;                                  // [g*th*tw][cout]
  T* hid = reinterpret_cast<T*>(acc + (size_t)p.g * p.th * p.tw * p.cout);  // [g*rh*rw][ch]
  T* dwt = hid + (size_t)p.g * p.rh_max * p.rw_max * p.ch;            // [g*th*tw][ch]

  const T* x = static_cast<const T*>(p.x);
  const T* w_exp = static_cast<const T*>(p.w_exp);
  const T* w_prj = static_cast<const T*>(p.w_prj);
  T* out = static_cast<T*>(p.out);
  const Tile t = tile_of(p.n, p.g, p.th, p.tw, p.h, p.w, p.h_out, p.w_out, p.stride);
  const int rpx = t.rh * t.rw, opx = t.oth * t.otw;
  const int mr = t.ge * rpx, mo = t.ge * opx;
  const RegionA<T> xa{x, t.n0, p.h, p.w, p.cin, t.rh, t.rw, t.iy0, t.ix0};
  const SmemA<T> da{dwt, p.ch};

  for (int c0 = 0; c0 < p.chid; c0 += p.ch) {
    const int cw = min(p.ch, p.chid - c0);
    // 1. hidden over the region
    if (p.expand) {
      block_gemm(
          mr, cw, p.cin, xa,
          [&](int k, int n) { return to_f(w_exp[(size_t)k * p.chid + c0 + n]); },
          [&](int m, int n, float v) {
            hid[(size_t)m * p.ch + n] = from_f<T>(relu6(v + p.b_exp[c0 + n]));
          },
          stage);
    } else {
      for (int i = threadIdx.x; i < mr * cw; i += kThreads) {
        const int m = i / cw, c = i - m * cw;
        hid[(size_t)m * p.ch + c] = x[xa.row(m) + c0 + c];
      }
      __syncthreads();
    }
    // 2. depthwise 3x3 over the output tile
    for (int i = threadIdx.x; i < mo * cw; i += kThreads) {
      const int m = i / cw, c = i - m * cw;
      const int g = m / opx, q = m - g * opx;
      const int oy = t.oy0 + q / t.otw, ox = t.ox0 + q % t.otw;
      const T* hg = hid + (size_t)g * rpx * p.ch + c;
      float s = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int iy = oy * p.stride - 1 + dy;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int ix = ox * p.stride - 1 + dx;
          if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
            s += to_f(hg[(size_t)((iy - t.iy0) * t.rw + ix - t.ix0) * p.ch]) *
                 p.w_dw[(dy * 3 + dx) * p.chid + c0 + c];
        }
      }
      dwt[(size_t)m * p.ch + c] = from_f<T>(relu6(s + p.b_dw[c0 + c]));
    }
    __syncthreads();
    // 3. this chunk's share of the project
    const bool first = c0 == 0;
    block_gemm(
        mo, p.cout, cw, da,
        [&](int k, int n) { return to_f(w_prj[(size_t)(c0 + k) * p.cout + n]); },
        [&](int m, int n, float v) {
          float* a = acc + (size_t)m * p.cout + n;
          *a = first ? v : *a + v;
        },
        stage);
  }

  // bias, residual, one cast
  for (int i = threadIdx.x; i < mo * p.cout; i += kThreads) {
    const int m = i / p.cout, n = i - m * p.cout;
    const int g = m / opx, q = m - g * opx;
    const int oy = t.oy0 + q / t.otw, ox = t.ox0 + q % t.otw;
    float v = acc[i] + p.b_prj[n];
    if (p.use_res)
      v += to_f(x[(((t.n0 + g) * p.h + oy) * (long long)p.w + ox) * p.cin + n]);
    out[(((t.n0 + g) * p.h_out + oy) * (long long)p.w_out + ox) * p.cout + n] = from_f<T>(v);
  }
}

size_t smem_bytes(const InvResArgs& p, int elem) {
  return (size_t)kStageBytes + (size_t)p.g * p.th * p.tw * p.cout * 4 +
         (size_t)p.g * p.rh_max * p.rw_max * p.ch * elem + (size_t)p.g * p.th * p.tw * p.ch * elem;
}

template <typename T>
cudaError_t launch(const InvResArgs& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(inv_residual_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long groups = (p.n + p.g - 1) / p.g;
  const int tiles = ((p.h_out + p.th - 1) / p.th) * ((p.w_out + p.tw - 1) / p.tw);
  inv_residual_kernel<T><<<dim3((unsigned int)groups, (unsigned int)tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for arguments the kernel does not take. elem_size: 4 (float32) or 2 (bf16).
extern "C" int fused_inv_residual(const void* x, const void* w_exp, const void* b_exp,
                                  const void* w_dw, const void* b_dw, const void* w_prj,
                                  const void* b_prj, void* out, long long n, int h, int w,
                                  int cin, int chid, int cout, int stride, int expand,
                                  int use_res, int th, int tw, int g, int ch, int elem_size,
                                  void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || h < 1 || w < 1 || cin < 1 || chid < 1 || cout < 1 || th < 1 || tw < 1 ||
      g < 1 || ch < 1 || (stride != 1 && stride != 2) || (use_res && (stride != 1 || cin != cout)) ||
      (!expand && chid != cin) || (n + g - 1) / g > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  InvResArgs p;
  p.x = x;
  p.w_exp = w_exp;
  p.b_exp = static_cast<const float*>(b_exp);
  p.w_dw = static_cast<const float*>(w_dw);
  p.b_dw = static_cast<const float*>(b_dw);
  p.w_prj = w_prj;
  p.b_prj = static_cast<const float*>(b_prj);
  p.out = out;
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.chid = chid;
  p.cout = cout;
  p.stride = stride;
  p.h_out = (h - 1) / stride + 1;
  p.w_out = (w - 1) / stride + 1;
  p.expand = expand;
  p.use_res = use_res;
  p.th = th;
  p.tw = tw;
  p.g = g;
  p.ch = ch;
  p.rh_max = region_max(th, stride, h);
  p.rw_max = region_max(tw, stride, w);
  if (((p.h_out + th - 1) / th) * ((p.w_out + tw - 1) / tw) > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, elem_size);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 4: return (int)launch<float>(p, smem, s);
    case 2: return (int)launch<__nv_bfloat16>(p, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
