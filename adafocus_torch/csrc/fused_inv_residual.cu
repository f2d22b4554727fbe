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
// Each block of 256 threads owns (a group of g samples) x (an output tile
// of th x tw pixels); the host picks the plan (ops/fused_blocks.py
// plan_inv_residual). The hidden channels are walked in chunks: the
// depthwise conv is per channel, so each chunk's expand -> depthwise runs
// on its own, and its share of the project is added into the project's
// float32 sums. Only the strided outputs are computed, H' = (H - 1) // s + 1,
// so odd sizes (9 -> 5) need nothing special. A tap outside the image reads
// 0, the zero padding of the activated hidden (not the expand of a zero
// input: relu6(bias) is not 0).
//
// bf16 (inv_residual_tc_kernel, tensor cores, fused_gemm.cuh namespace tc):
// the tile's input region of x (its 3x3 receptive field clipped to the
// image) is copied once into shared memory by 16-byte asynchronous copies.
// Per chunk of kCH hidden channels, with the chunk's expand and project
// weights copied in beside it:
//   1. expand on tensor cores over the region's rows (A read from the x
//      region by ldmatrix), relu6, rounded into `hid`;
//   2. depthwise on CUDA cores, each thread two channels (their nine taps
//      in registers) over the tile's rows, each row's tap offsets and
//      valid taps computed once per block: 9 MACs a channel have no
//      tensor-core shape; rounded into `dwt`;
//   3. project on tensor cores: the sums of up to 64 x 256 outputs per
//      warpgroup stay in registers across all chunks, the project's width
//      in steps of 8 (the warpgroups split its width, ns = 2, or its rows,
//      ns = 1, up to 128 output pixels).
// The epilogue adds the bias and the residual and writes out from registers.
// What bounds it now, on the 112^2 and 56^2 blocks: each block waits for its
// own x region and each chunk's weights with nothing else to do (two or
// three blocks an SM), and the depthwise on CUDA cores; the products are a
// small share. Prefetching the next tile's region (persistent blocks) is the
// next step.
//
// float32 (inv_residual_kernel, CUDA cores, block_gemm): per chunk, expand
// into `hid`, depthwise into `dwt`, and the chunk's project added into a
// float32 tile in shared memory.

#include <type_traits>

#include "fused_gemm.cuh"

// The build compiles this file as ten units at once,
// FUSED_INV_RESIDUAL_PART = 0 to 9 (ops/_kernels.py PARTS), and links them
// into one library: unit p < 8 holds the bf16 instance
// inv_residual_tc_kernel<kUnitBnp[p]>, unit 8 the float32 kernel, unit 9
// the entry points at the end, which call the instances' launchers across
// the units.
#if FUSED_INV_RESIDUAL_PART == 9
#define FUSED_INV_RESIDUAL_KERNELS 0   // this unit defines no launcher
#define FUSED_INV_RESIDUAL_ENTRY 1     // this unit defines the entry points
#else
#define FUSED_INV_RESIDUAL_KERNELS 1
#define FUSED_INV_RESIDUAL_ENTRY 0
#endif

namespace invres {

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
  int ns;               // bf16 plan: warpgroups splitting the project's width (2) or rows (1)
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

// ---------------------------------------------------------------------------
// bf16 on tensor cores.
// ---------------------------------------------------------------------------

constexpr int kCH = 64;  // hidden channels per chunk (the expand's N, the project's depth)

// the project's width per warpgroup: the smallest kernel instance that
// holds ceil(cout / ns), in steps of 8 up to 256 (ops/fused_blocks.py _bnp)
__host__ __device__ inline int bnp_of(int cout, int ns) {
  const int need = (cout + ns - 1) / ns;
  const int sizes[] = {16, 24, 32, 64, 96, 128, 160, 256};
  for (int v : sizes)
    if (need <= v) return v;
  return 0;
}

// Shared memory of the bf16 kernel (ops/fused_blocks.py inv_residual_smem),
// byte offsets: the x region, the chunk's expand weights, the hidden over
// the region, the depthwise output, the chunk's project weights, a zero
// row, and per output row its first tap's region row and valid taps.
struct TcLayout {
  int xs, we, hid, dwt, wp, zero, taps, total;
};

__host__ __device__ inline TcLayout tc_layout(int g, int rh_max, int rw_max, int cin, int cout,
                                              int expand, int ns) {
  using namespace tc;
  const int mr = g * rh_max * rw_max, ldx = (cin + 15) / 16 * 16 + kPad, rows = 64 * (2 / ns);
  TcLayout L;
  L.xs = 0;
  L.we = L.xs + align128(mr * ldx * 2);
  L.hid = L.we + (expand ? align128((ldx - kPad) * kCH * 2) : 0);
  L.dwt = L.hid + (expand ? align128(mr * (kCH + kPad) * 2) : 0);
  L.wp = L.dwt + align128(rows * (kCH + kPad) * 2);
  L.zero = L.wp + align128(kCH * ns * bnp_of(cout, ns) * 2);
  L.taps = L.zero + align128(ldx * 2);
  L.total = L.taps + align128(rows * 2 * 4);
  return L;
}

// Instances up to 32 wide leave room for three blocks on an SM (at most 85
// registers a thread), up to 96 wide for two (at most 128).
template <int BNP>
__global__ void __launch_bounds__(kThreads, BNP <= 32 ? 3 : BNP <= 96 ? 2 : 1)
    inv_residual_tc_kernel(const InvResArgs p) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = p.ns, mt = 2 / ns, nbp = ns * BNP;
  const TcLayout L = tc_layout(p.g, p.rh_max, p.rw_max, p.cin, p.cout, p.expand, ns);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* we = reinterpret_cast<bf16*>(smem + L.we);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* dwt = reinterpret_cast<bf16*>(smem + L.dwt);
  bf16* wp = reinterpret_cast<bf16*>(smem + L.wp);
  bf16* zero = reinterpret_cast<bf16*>(smem + L.zero);
  int* tap0 = reinterpret_cast<int*>(smem + L.taps);  // [64 * mt]: region row of tap (0, 0)
  int* tapm = tap0 + 64 * mt;                          // [64 * mt]: bit dy * 3 + dx: tap inside
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w_exp = static_cast<const bf16*>(p.w_exp);
  const bf16* w_prj = static_cast<const bf16*>(p.w_prj);
  bf16* out = static_cast<bf16*>(p.out);

  const Tile t = tile_of(p.n, p.g, p.th, p.tw, p.h, p.w, p.h_out, p.w_out, p.stride);
  const int rpx = t.rh * t.rw, opx = t.oth * t.otw;
  const int mr = t.ge * rpx, mo = t.ge * opx;
  const int cin = p.cin, chid = p.chid, cout = p.cout;
  const int cin_p = (cin + 15) / 16 * 16, ldx = cin_p + kPad;
  constexpr int ldh = kCH + kPad;
  const int wg = threadIdx.x / 128, wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int my_mt = ns == 2 ? 0 : wg, my_slab = ns == 2 ? wg : 0;

  for (int i = threadIdx.x; i < ldx; i += kThreads) zero[i] = __float2bfloat16_rn(0.f);
  // the depthwise taps of each output row, once: rows past mo have none
  for (int m = threadIdx.x; m < 64 * mt; m += kThreads) {
    int base = 0, mask = 0;
    if (m < mo) {
      const int gi = m / opx, q = m - gi * opx;
      const int iy = (t.oy0 + q / t.otw) * p.stride - 1, ix = (t.ox0 + q % t.otw) * p.stride - 1;
      base = gi * rpx + (iy - t.iy0) * t.rw + ix - t.ix0;
      for (int k = 0; k < 9; ++k) {
        const int y = iy + k / 3, xx = ix + k % 3;
        if (y >= 0 && y < p.h && xx >= 0 && xx < p.w) mask |= 1 << k;
      }
    }
    tap0[m] = base;
    tapm[m] = mask;
  }
  // the x region, once
  {
    const bool aligned = cin % 8 == 0;
    const int q8 = cin_p / 8;
    for (int i = threadIdx.x; i < mr * q8; i += kThreads) {
      const int m = i / q8, q = i - m * q8;
      const int gi = m / rpx, r = m - gi * rpx, ry = r / t.rw, rx = r - ry * t.rw;
      const long long off = (((t.n0 + gi) * p.h + t.iy0 + ry) * (long long)p.w + t.ix0 + rx) * cin;
      copy8(xs + m * ldx + q * 8, x + off + q * 8, cin - q * 8, aligned);
    }
  }

  Acc<BNP> acc;
  Acc<kCH> acc1;
  for (int c0 = 0; c0 < chid; c0 += kCH) {
    const int cw = min(kCH, chid - c0);
    if (p.expand) load_b(we, cin_p, kCH, w_exp, cin, chid, 0, c0);
    load_b(wp, kCH, nbp, w_prj, chid, cout, c0, 0);
    cp_commit();
    cp_wait<0>();
    fence_async();
    __syncthreads();

    // 1. hidden over the region (or x's channels [c0, c0 + kCH))
    const bf16* hsrc = xs + c0;
    int ldhs = ldx;
    if (p.expand) {
      const int nm = (mr + 63) / 64;
      for (int tile = wg; tile < nm; tile += 2) {
        const int m = tile * 64 + 16 * wq + lane % 16;
        const bf16* row = m < mr ? xs + m * ldx : zero;
        for (int k0 = 0; k0 < cin_p; k0 += kRingK)
          mma_steps(acc1, row, k0, we + k0 * kCH, kCH, min(kRingK, cin_p - k0) / 16, k0 == 0);
        acc1.each([&](int r, int col, float v0, float v1) {
          const int mm = tile * 64 + r;
          if (mm >= mr) return;
          __nv_bfloat162 v;
          v.x = col < cw ? __float2bfloat16_rn(relu6(v0 + p.b_exp[c0 + col])) : __float2bfloat16_rn(0.f);
          v.y = col + 1 < cw ? __float2bfloat16_rn(relu6(v1 + p.b_exp[c0 + col + 1]))
                             : __float2bfloat16_rn(0.f);
          *reinterpret_cast<__nv_bfloat162*>(hid + mm * ldh + col) = v;
        });
      }
      __syncthreads();
      hsrc = hid;
      ldhs = ldh;
    }

    // 2. depthwise 3x3 over the output tile's rows, the chunk's channels
    // rounded up to the project's k16 steps (zeros past mo and cw): each
    // thread keeps two channels' nine taps and biases in registers and walks
    // rows, reading bf16 pairs; a warp reads consecutive channels of a row
    {
      const int cwp = (cw + 15) / 16 * 16, pairs = cwp / 2, rows_at_once = kThreads / pairs;
      const int c = 2 * (threadIdx.x % pairs), m_first = threadIdx.x / pairs;
      float w0[9], w1[9], bias0 = 0.f, bias1 = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        w0[k] = c < cw ? p.w_dw[k * chid + c0 + c] : 0.f;
        w1[k] = c + 1 < cw ? p.w_dw[k * chid + c0 + c + 1] : 0.f;
      }
      if (c < cw) bias0 = p.b_dw[c0 + c];
      if (c + 1 < cw) bias1 = p.b_dw[c0 + c + 1];
      const int rw = t.rw;
      if (m_first < rows_at_once) {
        for (int m = m_first; m < 64 * mt; m += rows_at_once) {
          const int mask = tapm[m];
          float s0 = 0.f, s1 = 0.f;
          if (mask) {
            const bf16* hg = hsrc + (size_t)tap0[m] * ldhs + c;
#pragma unroll
            for (int k = 0; k < 9; ++k) {
              if (mask >> k & 1) {
                const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    hg + (k / 3 * rw + k % 3) * ldhs));
                s0 += v.x * w0[k];
                s1 += v.y * w1[k];
              }
            }
            s0 = relu6(s0 + bias0);
            s1 = relu6(s1 + bias1);
          }
          *reinterpret_cast<__nv_bfloat162*>(dwt + m * ldh + c) = __floats2bfloat162_rn(s0, s1);
        }
      }
    }
    __syncthreads();

    // 3. this chunk's share of the project, into the registers' sums
    const bf16* row = dwt + (my_mt * 64 + 16 * wq + lane % 16) * ldh;
    const bf16* b = wp + my_slab * BNP * 8;
    for (int k0 = 0; k0 < cw; k0 += kRingK)
      mma_steps(acc, row, k0, b + k0 * nbp, nbp, (min(kRingK, cw - k0) + 15) / 16,
                c0 == 0 && k0 == 0);
    __syncthreads();
  }

  // bias, residual, one cast
  acc.each([&](int r, int col, float v0, float v1) {
    const int m = my_mt * 64 + r, n = my_slab * BNP + col;
    if (m >= mo || n >= cout) return;
    const int gi = m / opx, q = m - gi * opx;
    const int oy = t.oy0 + q / t.otw, ox = t.ox0 + q % t.otw;
    const float v[2] = {v0, v1};
    const long long o = (((t.n0 + gi) * p.h_out + oy) * (long long)p.w_out + ox) * cout + n;
    const long long xo = (((t.n0 + gi) * p.h + oy) * (long long)p.w + ox) * cin + n;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (n + e >= cout) break;
      float u = v[e] + p.b_prj[n + e];
      if (p.use_res) u += __bfloat162float(x[xo + e]);
      out[o + e] = __float2bfloat16_rn(u);
    }
  });
}

inline size_t smem_bytes(const InvResArgs& p, int elem) {
  if (elem == 2)
    return (size_t)tc_layout(p.g, p.rh_max, p.rw_max, p.cin, p.cout, p.expand, p.ns).total;
  return (size_t)kStageBytes + (size_t)p.g * p.th * p.tw * p.cout * 4 +
         (size_t)p.g * p.rh_max * p.rw_max * p.ch * elem + (size_t)p.g * p.th * p.tw * p.ch * elem;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const InvResArgs& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long groups = (p.n + p.g - 1) / p.g;
  const int tiles = ((p.h_out + p.th - 1) / p.th) * ((p.w_out + p.tw - 1) / p.tw);
  kernel<<<dim3((unsigned int)groups, (unsigned int)tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
}

// Each kernel instance's launch and occupancy, the units' interface.
template <int BNP>
cudaError_t tc_launch(const InvResArgs& p, size_t smem, cudaStream_t stream);
template <int BNP>
cudaError_t tc_occupancy(int smem, int* blocks);
cudaError_t f32_launch(const InvResArgs& p, size_t smem, cudaStream_t stream);
cudaError_t f32_occupancy(int smem, int* blocks);

#if FUSED_INV_RESIDUAL_KERNELS
template <int BNP>
cudaError_t tc_launch(const InvResArgs& p, size_t smem, cudaStream_t stream) {
  return launch(inv_residual_tc_kernel<BNP>, p, smem, stream);
}

template <int BNP>
cudaError_t tc_occupancy(int smem, int* blocks) {
  return occupancy(inv_residual_tc_kernel<BNP>, smem, blocks);
}
#endif  // FUSED_INV_RESIDUAL_KERNELS

// the bf16 instances, unit by unit: project width bnp per warpgroup
constexpr int kUnitBnp[8] = {16, 24, 32, 64, 96, 128, 160, 256};

#if FUSED_INV_RESIDUAL_PART < 8
template cudaError_t tc_launch<kUnitBnp[FUSED_INV_RESIDUAL_PART]>(const InvResArgs& p,
                                                                  size_t smem,
                                                                  cudaStream_t stream);
template cudaError_t tc_occupancy<kUnitBnp[FUSED_INV_RESIDUAL_PART]>(int smem, int* blocks);
#endif

#if FUSED_INV_RESIDUAL_PART == 8
cudaError_t f32_launch(const InvResArgs& p, size_t smem, cudaStream_t stream) {
  return launch(inv_residual_kernel<float>, p, smem, stream);
}

cudaError_t f32_occupancy(int smem, int* blocks) {
  return occupancy(inv_residual_kernel<float>, smem, blocks);
}
#endif

#if FUSED_INV_RESIDUAL_ENTRY
// f(bnp) with the bf16 instance's template argument as a type
// (std::integral_constant), for project width bnp per warpgroup
template <typename F>
cudaError_t with_tc(int bnp, F f) {
  using std::integral_constant;
  switch (bnp) {
    case 16: return f(integral_constant<int, 16>{});
    case 24: return f(integral_constant<int, 24>{});
    case 32: return f(integral_constant<int, 32>{});
    case 64: return f(integral_constant<int, 64>{});
    case 96: return f(integral_constant<int, 96>{});
    case 128: return f(integral_constant<int, 128>{});
    case 160: return f(integral_constant<int, 160>{});
    default: return f(integral_constant<int, 256>{});
  }
}
#endif  // FUSED_INV_RESIDUAL_ENTRY

}  // namespace invres

#if FUSED_INV_RESIDUAL_ENTRY
using namespace invres;

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for arguments the kernel does not take. elem_size: 4 (float32) or 2 (bf16);
// ch: the float32 kernel's hidden chunk (bf16 walks chunks of kCH); ns (bf16
// only): 2 when the two warpgroups split the project's width, 1 its rows.
extern "C" int fused_inv_residual(const void* x, const void* w_exp, const void* b_exp,
                                  const void* w_dw, const void* b_dw, const void* w_prj,
                                  const void* b_prj, void* out, long long n, int h, int w,
                                  int cin, int chid, int cout, int stride, int expand,
                                  int use_res, int th, int tw, int g, int ch, int ns,
                                  int elem_size, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || h < 1 || w < 1 || cin < 1 || chid < 1 || cout < 1 || th < 1 || tw < 1 ||
      g < 1 || ch < 1 || (stride != 1 && stride != 2) || (use_res && (stride != 1 || cin != cout)) ||
      (!expand && chid != cin) || (n + g - 1) / g > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (elem_size == 2 && ((ns != 1 && ns != 2) || g * th * tw > 64 * (2 / ns) || bnp_of(cout, ns) == 0))
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
  p.ns = ns;
  p.rh_max = region_max(th, stride, h);
  p.rw_max = region_max(tw, stride, w);
  if (((p.h_out + th - 1) / th) * ((p.w_out + tw - 1) / tw) > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, elem_size);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 4: return (int)f32_launch(p, smem, s);
    case 2:
      return (int)with_tc(bnp_of(cout, ns), [&](auto bnp) {
        return tc_launch<decltype(bnp)::value>(p, smem, s);
      });
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the kernel that one SM holds at smem bytes of shared memory
// (registers included); 0 on error.
extern "C" int fused_inv_residual_blocks_per_sm(int cout, int ns, int elem_size, int smem) {
  int blocks = 0;
  cudaError_t err =
      elem_size == 4 ? f32_occupancy(smem, &blocks)
                     : with_tc(bnp_of(cout, ns), [&](auto bnp) {
                         return tc_occupancy<decltype(bnp)::value>(smem, &blocks);
                       });
  return err == cudaSuccess ? blocks : 0;
}
#endif  // FUSED_INV_RESIDUAL_ENTRY
