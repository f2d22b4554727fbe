// One ResNet bottleneck (inference, BatchNorm folded) in one launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_bottleneck
// (adafocus_tpu/ops/fused_blocks.py, _bottleneck_kernel):
//   h1  = relu(x . w1 + b1), rounded to the compute dtype
//   h2  = relu(3x3 conv(h1, stride 1 or 2, zero pad 1) . w2 + b2), rounded
//   h3  = h2 . w3 + b3, float32
//   out = relu(h3 + x[::s, ::s] . wd + bd)   (mode 1, downsample)
//       = relu(h3 + x)                       (mode 0, identity)
//       = h3                                 (mode 2, use_res=False: the
//                                             temporal-shift variant adds
//                                             the residual outside)
// over channels-last (N, H, W, C) tensors, bf16 or float32, every sum in
// float32, one cast at the end.
//
// Bound: operations for the stride-2 and late blocks, bytes for the early
// ones. At the flagship (N=1024, 96^2 patches, bf16) the 16 blocks do
// 1.5 TFLOP and move 4.2 GB (x in, out back, weights).
//
// Design: one block of 256 threads per (group of g samples, output tile of
// th x tw pixels); the host picks the plan (ops/fused_blocks.py
// plan_bottleneck). The 3x3 conv mixes all channels, so h1 for every hidden
// channel of the tile's input region (its receptive field clipped to the
// image) is resident in shared memory, and h2 for the output tile beside
// it; x and the weights stream from device memory and L2. Three products,
// all block_gemm on CUDA cores:
//   1. conv1 over the region's pixels into h1;
//   2. conv2 as one product of depth 9 * chid whose A gathers the nine taps
//      from h1; a tap outside the image reads 0, the zero padding of the
//      activated h1;
//   3. conv3 and the downsample as one product of depth chid (+ cin): the
//      float32 sums of h2 . w3 and x[::s, ::s] . wd share one accumulator,
//      then biases, residual and relu in the epilogue, which writes out.
// Only the strided outputs are computed, H' = (H - 1) // s + 1.

#include "fused_gemm.cuh"

namespace {

using namespace fused;

struct BottleneckArgs {
  const void* x;
  const void* w1;  // (cin, chid), compute dtype
  const float* b1;
  const void* w2;  // (9, chid, chid): tap dy * 3 + dx, [in, out]
  const float* b2;
  const void* w3;  // (chid, cout)
  const float* b3;
  const void* wd;  // (cin, cout), mode 1 only
  const float* bd;
  void* out;
  long long n;
  int h, w, cin, chid, cout, stride, h_out, w_out;
  int mode;            // 0 identity residual, 1 downsample, 2 branch only
  int th, tw, g;       // plan: output tile, samples per block
  int rh_max, rw_max;  // largest region (shared-memory layout)
};

// conv2's A: m an output pixel of the tile, k = tap * chid + ci.
template <typename T>
struct TapA {
  const T* h1;
  int chid, h, w, s, iy0, ix0, rh, rw, opx, otw, oy0, ox0;
  struct Row {
    int base;    // first region pixel of the sample
    int cy, cx;  // image coordinates of tap (0, 0)
  };
  struct Col {
    int dy, dx, ci;
  };
  __device__ Row row(int m) const {
    const int g = m / opx, q = m - g * opx;
    const int oy = oy0 + q / otw, ox = ox0 + q % otw;
    return Row{g * rh * rw, oy * s - 1, ox * s - 1};
  }
  __device__ Col col(int k) const {
    const int tap = k / chid;
    return Col{tap / 3, tap % 3, k - tap * chid};
  }
  __device__ float at(const Row& r, const Col& c) const {
    const int iy = r.cy + c.dy, ix = r.cx + c.dx;
    if (iy < 0 || iy >= h || ix < 0 || ix >= w) return 0.f;
    return to_f(h1[(size_t)(r.base + (iy - iy0) * rw + ix - ix0) * chid + c.ci]);
  }
};

// conv3's A: h2[m][k] for k < chid, then x at the strided pixel (downsample).
template <typename T>
struct ProjA {
  const T* h2;
  const T* x;
  long long n0;
  int chid, h, w, cin, s, opx, otw, oy0, ox0;
  struct Row {
    int m;
    long long xoff;
  };
  using Col = int;
  __device__ Row row(int m) const {
    const int g = m / opx, q = m - g * opx;
    const int oy = oy0 + q / otw, ox = ox0 + q % otw;
    return Row{m, (((n0 + g) * h + oy * s) * (long long)w + ox * s) * cin};
  }
  __device__ Col col(int k) const { return k; }
  __device__ float at(const Row& r, Col k) const {
    return k < chid ? to_f(h2[(size_t)r.m * chid + k]) : to_f(x[r.xoff + k - chid]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bottleneck_kernel(const BottleneckArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  T* h1 = reinterpret_cast<T*>(stage + kStageFloats);        // [g*rh*rw][chid]
  T* h2 = h1 + (size_t)p.g * p.rh_max * p.rw_max * p.chid;   // [g*th*tw][chid]

  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* w3 = static_cast<const T*>(p.w3);
  const T* wd = static_cast<const T*>(p.wd);
  T* out = static_cast<T*>(p.out);
  const Tile t = tile_of(p.n, p.g, p.th, p.tw, p.h, p.w, p.h_out, p.w_out, p.stride);
  const int rpx = t.rh * t.rw, opx = t.oth * t.otw;
  const int mo = t.ge * opx;
  const int chid = p.chid, cout = p.cout;

  // 1. h1 over the region
  const RegionA<T> xa{x, t.n0, p.h, p.w, p.cin, t.rh, t.rw, t.iy0, t.ix0};
  block_gemm(
      t.ge * rpx, chid, p.cin, xa,
      [&](int k, int n) { return to_f(w1[(size_t)k * chid + n]); },
      [&](int m, int n, float v) { h1[(size_t)m * chid + n] = from_f<T>(fmaxf(v + p.b1[n], 0.f)); },
      stage);

  // 2. h2 over the output tile: nine taps of h1
  const TapA<T> ta{h1, chid, p.h, p.w, p.stride, t.iy0, t.ix0, t.rh, t.rw, opx, t.otw, t.oy0, t.ox0};
  block_gemm(
      mo, chid, 9 * chid, ta,
      [&](int k, int n) { return to_f(w2[(size_t)k * chid + n]); },
      [&](int m, int n, float v) { h2[(size_t)m * chid + n] = from_f<T>(fmaxf(v + p.b2[n], 0.f)); },
      stage);

  // 3. conv3 (+ downsample), residual, relu
  const ProjA<T> pa{h2, x, t.n0, chid, p.h, p.w, p.cin, p.stride, opx, t.otw, t.oy0, t.ox0};
  const int depth = chid + (p.mode == 1 ? p.cin : 0);
  block_gemm(
      mo, cout, depth, pa,
      [&](int k, int n) {
        return k < chid ? to_f(w3[(size_t)k * cout + n]) : to_f(wd[(size_t)(k - chid) * cout + n]);
      },
      [&](int m, int n, float v) {
        const int g = m / opx, q = m - g * opx;
        const int oy = t.oy0 + q / t.otw, ox = t.ox0 + q % t.otw;
        v += p.b3[n];
        if (p.mode == 1) {
          v = fmaxf(v + p.bd[n], 0.f);
        } else if (p.mode == 0) {
          v += to_f(x[(((t.n0 + g) * p.h + oy) * (long long)p.w + ox) * p.cin + n]);
          v = fmaxf(v, 0.f);
        }
        out[(((t.n0 + g) * p.h_out + oy) * (long long)p.w_out + ox) * cout + n] = from_f<T>(v);
      },
      stage);
}

size_t smem_bytes(const BottleneckArgs& p, int elem) {
  return (size_t)kStageBytes + (size_t)p.g * p.rh_max * p.rw_max * p.chid * elem +
         (size_t)p.g * p.th * p.tw * p.chid * elem;
}

template <typename T>
cudaError_t launch(const BottleneckArgs& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long groups = (p.n + p.g - 1) / p.g;
  const int tiles = ((p.h_out + p.th - 1) / p.th) * ((p.w_out + p.tw - 1) / p.tw);
  bottleneck_kernel<T><<<dim3((unsigned int)groups, (unsigned int)tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for arguments the kernel does not take. elem_size: 4 (float32) or 2 (bf16).
extern "C" int fused_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* w3, const void* b3, const void* wd,
                                const void* bd, void* out, long long n, int h, int w, int cin,
                                int chid, int cout, int stride, int mode, int th, int tw, int g,
                                int elem_size, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || h < 1 || w < 1 || cin < 1 || chid < 1 || cout < 1 || th < 1 || tw < 1 ||
      g < 1 || (stride != 1 && stride != 2) || mode < 0 || mode > 2 ||
      (mode == 0 && (stride != 1 || cin != cout)) || (mode == 1 && (wd == nullptr || bd == nullptr)) ||
      (n + g - 1) / g > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  BottleneckArgs p;
  p.x = x;
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w2 = w2;
  p.b2 = static_cast<const float*>(b2);
  p.w3 = w3;
  p.b3 = static_cast<const float*>(b3);
  p.wd = wd;
  p.bd = static_cast<const float*>(bd);
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
  p.mode = mode;
  p.th = th;
  p.tw = tw;
  p.g = g;
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
