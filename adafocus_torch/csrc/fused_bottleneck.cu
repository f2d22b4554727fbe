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
// float32, one cast at the end. Only the strided outputs are computed,
// H' = (H - 1) // s + 1.
//
// Bound: operations for the stride-2 and late blocks, bytes for the early
// ones. At the flagship (N=1024, 96^2 patches, bf16) the 16 blocks do
// 1.5 TFLOP and move 4.2 GB (x in, out back, weights).
//
// Each block of 256 threads owns (a group of g samples) x (an output tile
// of th x tw pixels); the host picks the plan (ops/fused_blocks.py
// plan_bottleneck) and the tile's input region is its 3x3 receptive field
// clipped to the image.
//
// bf16 (bottleneck_tc_kernel, tensor cores, fused_gemm.cuh namespace tc):
// the two warpgroups walk the hidden channels in chunks, of kCH or (WIDE,
// when the region's h1 fits) of all of them. Chunk j of conv1's output is
// chunk j of conv2's depth, so per chunk
//   1. conv1 over the region's pixels into a bf16 h1 chunk in shared memory
//      (x rows through the ring by cp.async, w1 tiles by bulk copies);
//   2. the chunk's nine taps of conv2 are added into conv2's float32 sums,
//      which stay in registers across chunks: A is gathered from the h1
//      chunk by row pointers (a tap outside the image points at a zero row,
//      the zero padding of the activated h1), w2 tiles come by bulk copies.
// Only one chunk of h1 is resident, which leaves room for enough samples
// per block to fill 64-row warpgroup tiles. The warpgroups either split
// conv2's width (ns = 2, up to 64 output rows, chid up to 512) or its rows
// (ns = 1, up to 128 rows). Then h2 = relu(sums + b2), rounded to bf16,
// goes to shared memory over the dead h1 chunk, and
//   3. conv3 and the downsample share one float32 accumulator per output
//      tile of kBN3 channels (h2 from shared memory, x's strided pixels and
//      w3 / wd tiles through the ring), with biases, residual and relu in
//      the epilogue, which writes out from registers.
// The weights reach the kernel packed by the host into the ring's tiles,
// one contiguous bulk copy each (cp.async.bulk on the stage's mbarrier),
// with their zero padding, so ragged depths and widths need no masking.
// What bounds it now: a fixed cost per ring step (a barrier, waits for the
// copies and the products, about 1000 cycles), and the weights streamed from
// L2 once per block of at most 128 output pixels.
//
// float32 (bottleneck_kernel, CUDA cores, block_gemm): h1 for every hidden
// channel of the region is resident in shared memory, h2 beside it; three
// block_gemm products (conv1; conv2 as one product 9 * chid deep whose A
// gathers the taps; conv3 + downsample in one accumulator).

#include <type_traits>

#include "fused_gemm.cuh"

// The build compiles this file as ten units at once, FUSED_BOTTLENECK_PART
// = 0 to 9 (ops/_kernels.py PARTS), and links them into one library: unit
// p < 8 holds the bf16 instance bottleneck_tc_kernel<kUnitBn2[p],
// kUnitWide[p]>, unit 8 the float32 kernel, unit 9 the entry points at the
// end, which call the instances' launchers across the units.
#if FUSED_BOTTLENECK_PART == 9
#define FUSED_BOTTLENECK_KERNELS 0   // this unit defines no launcher
#define FUSED_BOTTLENECK_ENTRY 1     // this unit defines the entry points
#else
#define FUSED_BOTTLENECK_KERNELS 1
#define FUSED_BOTTLENECK_ENTRY 0
#endif

namespace bneck {

using namespace fused;

// The weights: float32 as folded, (in, out) row-major; bf16 packed by the
// host into the ring's B tiles (ops/fused_blocks.py pack_bottleneck), each
// tile depth x width contiguous in the wgmma layout, zero-padded.
struct BottleneckArgs {
  const void* x;
  const void* w1;  // (cin, chid); bf16: [chid / kCH][cin / depth] tiles kCH wide
  const float* b1;
  const void* w2;  // (9, chid, chid): tap dy * 3 + dx, [in, out]; bf16: [9][chid / depth] tiles
                   // ns * bn2 wide (chid padded to a multiple of kCH)
  const float* b2;
  const void* w3;  // (chid, cout); bf16: [cout / nb3][ns * bn2 / depth] tiles nb3 wide
  const float* b3;
  const void* wd;  // (cin, cout), mode 1 only; bf16: [cout / nb3][cin / depth] tiles nb3 wide
  const float* bd;
  void* out;
  long long n;
  int h, w, cin, chid, cout, stride, h_out, w_out;
  int mode;            // 0 identity residual, 1 downsample, 2 branch only
  int th, tw, g;       // plan: output tile, samples per block
  int ns;              // bf16 plan: warpgroups splitting conv2's width (2) or rows (1)
  int stages, depth;   // bf16 plan: ring stages and their depth (32 or 64)
  int wide;            // bf16 plan: one hidden chunk of every channel
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

// ---------------------------------------------------------------------------
// bf16 on tensor cores.
// ---------------------------------------------------------------------------

constexpr int kCH = 64;    // hidden channels per chunk (conv1's N, conv2's depth)
constexpr int kBN3 = 128;  // conv3 output channels per warpgroup and tile

// conv2's width per warpgroup: the smallest kernel instance that holds
// ceil(chid / ns) (ops/fused_blocks.py _bn2)
__host__ __device__ inline int bn2_of(int chid, int ns) {
  const int need = (chid + ns - 1) / ns;
  return need <= 16 ? 16 : need <= 32 ? 32 : need <= 64 ? 64 : need <= 128 ? 128 : 256;
}

// Shared memory of the bf16 kernel (ops/fused_blocks.py bottleneck_smem):
// the ring at 0, then one buffer for the h1 chunk (conv1 -> conv2) or h2
// (conv3), a zero row, and the ring's mbarriers.
struct TcLayout {
  int stage, buf, zero, bars, total;
};

// The hidden chunk: kCH channels, or (wide) all of them, chid_p = ns * bn2.
__host__ __device__ inline int chunk_of(int chid_p, int wide) { return wide ? chid_p : kCH; }

__host__ __device__ inline TcLayout tc_layout(int g, int rh_max, int rw_max, int chid, int ns,
                                              int stages, int depth, int wide) {
  using namespace tc;
  const int mt = 2 / ns, chid_p = ns * bn2_of(chid, ns), at = a_tile_bytes(depth);
  const int cw = chunk_of(chid_p, wide), mt1 = wide ? mt : 2;
  int stage = mt1 * at + depth * cw * 2;                    // conv1: x tiles, w1
  stage = imax(stage, depth * chid_p * 2);                  // conv2: w2
  stage = imax(stage, mt * at + depth * ns * kBN3 * 2);     // conv3: strided x, w3 / wd
  const int h1 = g * rh_max * rw_max * (cw + kPad) * 2;
  const int h2 = 64 * mt * (chid_p + kPad) * 2;
  TcLayout L;
  L.stage = stage;
  L.buf = stages * stage;
  L.zero = L.buf + align128(imax(h1, h2));
  L.bars = L.zero + align128((imax(cw, chid_p) + kPad) * 2);
  L.total = L.bars + align128(kMaxStages * 8);
  return L;
}

// Narrow instances leave room for two blocks on an SM (at most 128 registers
// a thread); conv2's sums of a 256- or 128-wide instance take the SM's
// registers alone. WIDE: one hidden chunk of every channel (the plan picks it
// when the region's h1 fits), so conv1 runs once over x instead of once per
// chunk; conv1's output is then shared between the warpgroups as conv2's is.
template <int BN2, bool WIDE>
__global__ void __launch_bounds__(kThreads, BN2 <= 64 ? 2 : 1)
    bottleneck_tc_kernel(const BottleneckArgs p) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = p.ns, mt = 2 / ns, chid_p = ns * BN2, depth = p.depth;
  const TcLayout L = tc_layout(p.g, p.rh_max, p.rw_max, p.chid, ns, p.stages, depth, WIDE);
  const int at = a_tile_bytes(depth), ate = at / 2, lda = depth + kPad;
  unsigned char* ring = smem;
  bf16* buf = reinterpret_cast<bf16*>(smem + L.buf);  // h1 chunk, then h2
  bf16* zero = reinterpret_cast<bf16*>(smem + L.zero);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w1 = static_cast<const bf16*>(p.w1);
  const bf16* w2 = static_cast<const bf16*>(p.w2);
  const bf16* w3 = static_cast<const bf16*>(p.w3);
  const bf16* wd = static_cast<const bf16*>(p.wd);
  bf16* out = static_cast<bf16*>(p.out);

  const Tile t = tile_of(p.n, p.g, p.th, p.tw, p.h, p.w, p.h_out, p.w_out, p.stride);
  const int rpx = t.rh * t.rw, opx = t.oth * t.otw;
  const int mr = t.ge * rpx, mo = t.ge * opx;
  const int chid = p.chid, cin = p.cin, cout = p.cout;
  const int wg = threadIdx.x / 128, wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int my_mt = ns == 2 ? 0 : wg, my_slab = ns == 2 ? wg : 0;
  const bool x_aligned = cin % 8 == 0;
  // the chunk (conv1's width, conv2's depth per pass) and how conv1's
  // m-tiles (mt1 at a time) and columns (n1 per warpgroup) are shared
  const int cwid = chunk_of(chid_p, WIDE), ld1 = cwid + kPad, ld2 = chid_p + kPad;
  const int mt1 = WIDE ? mt : 2;
  constexpr int n1 = WIDE ? BN2 : kCH;

  for (int i = threadIdx.x; i < max(ld1, ld2); i += kThreads) zero[i] = __float2bfloat16_rn(0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  int step = 0;  // ring steps so far (slots and mbarrier phases)

  // x offset of region row m (m < mr)
  auto region_x = [&](int m) -> long long {
    const int gi = m / rpx, r = m - gi * rpx, ry = r / t.rw, rx = r - ry * t.rw;
    return (((t.n0 + gi) * p.h + t.iy0 + ry) * (long long)p.w + t.ix0 + rx) * cin;
  };
  // output row m (m < mo): sample and output pixel
  auto out_pixel = [&](int m, int& gi, int& oy, int& ox) {
    gi = m / opx;
    const int q = m - gi * opx;
    oy = t.oy0 + q / t.otw;
    ox = t.ox0 + q % t.otw;
  };
  // A 64-row A tile of the ring holds channels [k0, k0 + depth) of 64 x
  // pixels: thread t copies 16-byte piece t % q8 of rows t / q8 + j * (256 /
  // q8), j < q8 / 4 (q8 = depth / 8 pieces a row). row_offsets finds the x
  // offsets of this thread's rows (-1: past rows_valid, reads 0) once per
  // tile; load_rows copies them at depth k0 for each ring step.
  const int q8 = depth / 8, xq = threadIdx.x % q8;
  auto row_offsets = [&](long long (&off)[2], int rows_base, int rows_valid, auto row_x) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = rows_base + threadIdx.x / q8 + j * (kThreads / q8);
      off[j] = j < q8 / 4 && m < rows_valid ? row_x(m) : -1;
    }
  };
  auto load_rows = [&](bf16* tile, const long long (&off)[2], int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= q8 / 4) break;
      const int r = threadIdx.x / q8 + j * (kThreads / q8), k = k0 + xq * 8;
      copy8(tile + r * lda + xq * 8, off[j] < 0 ? x : x + off[j] + k, off[j] < 0 ? 0 : cin - k,
            x_aligned);
    }
  };

  // this lane's conv2 row: region coordinates of its output pixel
  const int m2 = my_mt * 64 + 16 * wq + lane % 16;
  int base2 = -1, cy = 0, cx = 0;
  if (m2 < mo) {
    int gi, oy, ox;
    out_pixel(m2, gi, oy, ox);
    base2 = gi * rpx;
    cy = oy * p.stride - 1;
    cx = ox * p.stride - 1;
  }

  Acc<BN2> acc2;
  Acc<n1> acc1;
  long long xoff[2][2];  // this thread's x rows of conv1's current m-tiles
  int xoff_grp = -1;
  const int nm1 = (mr + 63) / 64, groups1 = (nm1 + mt1 - 1) / mt1;
  const int ks1 = (cin + depth - 1) / depth, ks2 = cwid / depth;  // ring steps per m-tile group, tap
  const int kb2 = (chid + cwid - 1) / cwid * ks2;                 // w2's k-tiles per tap
  const int b1_bytes = depth * cwid * 2, b2_bytes = depth * chid_p * 2;
  auto chunk = [&](int c0) {
    const int cw = min(cwid, chid - c0);
    // 1. conv1 over the region into the h1 chunk, mt1 m-tiles a step: one per
    // warpgroup, or (mt1 = 1) one shared with the columns split
    pipeline(
        groups1 * ks1, p.stages, ring, L.stage, bars, step,
        [&](int i, unsigned char* st, uint64_t* bar) {
          const int grp = i / ks1, ks = i % ks1;
          bf16* a = reinterpret_cast<bf16*>(st);
          if (grp != xoff_grp) {
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if (u < mt1) row_offsets(xoff[u], (grp * mt1 + u) * 64, mr, region_x);
            xoff_grp = grp;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (u < mt1) load_rows(a + u * ate, xoff[u], ks * depth);
          if (threadIdx.x == 0)
            bulk_load(st + mt1 * at, w1 + ((size_t)(c0 / cwid) * ks1 + ks) * depth * cwid, b1_bytes,
                      bar);
        },
        [&](int i, unsigned char* st) {
          const int grp = i / ks1, ks = i % ks1;
          const int u = mt1 == 2 ? wg : 0, tile = grp * mt1 + u, n_off = mt1 == 2 ? 0 : wg * n1;
          if (tile >= nm1) return;
          const bf16* a = reinterpret_cast<const bf16*>(st + u * at);
          mma_steps(acc1, a + (16 * wq + lane % 16) * lda, 0,
                    reinterpret_cast<const bf16*>(st + mt1 * at) + n_off * 8, cwid, depth / 16,
                    ks == 0);
          if (ks != ks1 - 1) return;
          acc1.each([&](int row, int col, float v0, float v1) {
            const int m = tile * 64 + row, n = n_off + col;
            if (m >= mr) return;
            __nv_bfloat162 v;
            v.x = n < cw ? __float2bfloat16_rn(fmaxf(v0 + p.b1[c0 + n], 0.f))
                         : __float2bfloat16_rn(0.f);
            v.y = n + 1 < cw ? __float2bfloat16_rn(fmaxf(v1 + p.b1[c0 + n + 1], 0.f))
                             : __float2bfloat16_rn(0.f);
            *reinterpret_cast<__nv_bfloat162*>(buf + m * ld1 + n) = v;
          });
        });

    // 2. the chunk's nine taps of conv2, added into acc2
    pipeline(
        9 * ks2, p.stages, ring, L.stage, bars, step,
        [&](int i, unsigned char* st, uint64_t* bar) {
          const int tap = i / ks2, kb = c0 / depth + i % ks2;
          if (threadIdx.x == 0)
            bulk_load(st, w2 + ((size_t)tap * kb2 + kb) * depth * chid_p, b2_bytes, bar);
        },
        [&](int i, unsigned char* st) {
          const int tap = i / ks2, k0 = (i % ks2) * depth;
          const int iy = cy + tap / 3, ix = cx + tap % 3;
          const bf16* row = zero;
          if (base2 >= 0 && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
            row = buf + (base2 + (iy - t.iy0) * t.rw + ix - t.ix0) * ld1;
          mma_steps(acc2, row, k0, reinterpret_cast<const bf16*>(st) + my_slab * BN2 * 8, chid_p,
                    depth / 16, c0 == 0 && i == 0);
        });
  };
  if constexpr (WIDE) {
    chunk(0);
  } else {
    for (int c0 = 0; c0 < chid; c0 += kCH) chunk(c0);
  }

  // h2 = relu(acc2 + b2), rounded, over the dead h1 chunk
  acc2.each([&](int row, int col, float v0, float v1) {
    const int m = my_mt * 64 + row, n = my_slab * BN2 + col;
    __nv_bfloat162 v;
    v.x = n < chid ? __float2bfloat16_rn(fmaxf(v0 + p.b2[n], 0.f)) : __float2bfloat16_rn(0.f);
    v.y = n + 1 < chid ? __float2bfloat16_rn(fmaxf(v1 + p.b2[n + 1], 0.f)) : __float2bfloat16_rn(0.f);
    *reinterpret_cast<__nv_bfloat162*>(buf + m * ld2 + n) = v;
  });
  __syncthreads();

  // 3. conv3 (+ downsample), residual, relu, per tile of ns * kBN3 channels
  const int kh = (chid_p + depth - 1) / depth, kd = p.mode == 1 ? (cin + depth - 1) / depth : 0;
  const int ks3 = kh + kd, nb3 = ns * kBN3, tiles3 = (cout + nb3 - 1) / nb3;
  auto strided_x = [&](int m) -> long long {
    int gi, oy, ox;
    out_pixel(m, gi, oy, ox);
    return (((t.n0 + gi) * p.h + oy * p.stride) * (long long)p.w + ox * p.stride) * cin;
  };
  long long soff[2][2];  // this thread's strided x rows of conv3's tiles
#pragma unroll
  for (int u = 0; u < 2; ++u) row_offsets(soff[u], u * 64, u < mt ? mo : 0, strided_x);
  Acc<kBN3> acc3;
  const int b3_bytes = depth * nb3 * 2;
  pipeline(
      tiles3 * ks3, p.stages, ring, L.stage, bars, step,
      [&](int i, unsigned char* st, uint64_t* bar) {
        const int tile = i / ks3, ks = i % ks3;
        const bf16* src;
        if (ks < kh) {
          src = w3 + ((size_t)tile * kh + ks) * depth * nb3;
        } else {
          const int kb = ks - kh;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (u < mt) load_rows(reinterpret_cast<bf16*>(st) + u * ate, soff[u], kb * depth);
          src = wd + ((size_t)tile * kd + kb) * depth * nb3;
        }
        if (threadIdx.x == 0) bulk_load(st + mt * at, src, b3_bytes, bar);
      },
      [&](int i, unsigned char* st) {
        const int n0 = (i / ks3) * nb3 + my_slab * kBN3, ks = i % ks3;
        const bf16* b = reinterpret_cast<const bf16*>(st + mt * at) + my_slab * kBN3 * 8;
        const int r = 16 * wq + lane % 16;
        if (ks < kh) {
          // h2's last stage may be shallower (chid_p is a multiple of 16)
          mma_steps(acc3, buf + (my_mt * 64 + r) * ld2, ks * depth, b, nb3,
                    min(depth, chid_p - ks * depth) / 16, ks == 0);
        } else {
          mma_steps(acc3, reinterpret_cast<const bf16*>(st) + my_mt * ate + r * lda, 0, b, nb3,
                    depth / 16, false);
        }
        if (ks != ks3 - 1) return;
        acc3.each([&](int row, int col, float v0, float v1) {
          const int m = my_mt * 64 + row, n = n0 + col;
          if (m >= mo || n >= cout) return;
          int gi, oy, ox;
          out_pixel(m, gi, oy, ox);
          const float v[2] = {v0, v1};
          const long long o = (((t.n0 + gi) * p.h_out + oy) * (long long)p.w_out + ox) * cout + n;
          const long long xo = (((t.n0 + gi) * p.h + oy) * (long long)p.w + ox) * cin + n;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= cout) break;
            float u = v[e] + p.b3[n + e];
            if (p.mode == 1) {
              u = fmaxf(u + p.bd[n + e], 0.f);
            } else if (p.mode == 0) {
              u = fmaxf(u + __bfloat162float(x[xo + e]), 0.f);
            }
            out[o + e] = __float2bfloat16_rn(u);
          }
        });
      });
}

inline size_t smem_bytes(const BottleneckArgs& p, int elem) {
  if (elem == 2)
    return (size_t)tc_layout(p.g, p.rh_max, p.rw_max, p.chid, p.ns, p.stages, p.depth, p.wide)
        .total;
  return (size_t)kStageBytes + (size_t)p.g * p.rh_max * p.rw_max * p.chid * elem +
         (size_t)p.g * p.th * p.tw * p.chid * elem;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const BottleneckArgs& p, size_t smem, cudaStream_t stream) {
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
template <int BN2, bool WIDE>
cudaError_t tc_launch(const BottleneckArgs& p, size_t smem, cudaStream_t stream);
template <int BN2, bool WIDE>
cudaError_t tc_occupancy(int smem, int* blocks);
cudaError_t f32_launch(const BottleneckArgs& p, size_t smem, cudaStream_t stream);
cudaError_t f32_occupancy(int smem, int* blocks);

#if FUSED_BOTTLENECK_KERNELS
template <int BN2, bool WIDE>
cudaError_t tc_launch(const BottleneckArgs& p, size_t smem, cudaStream_t stream) {
  return launch(bottleneck_tc_kernel<BN2, WIDE>, p, smem, stream);
}

template <int BN2, bool WIDE>
cudaError_t tc_occupancy(int smem, int* blocks) {
  return occupancy(bottleneck_tc_kernel<BN2, WIDE>, smem, blocks);
}
#endif  // FUSED_BOTTLENECK_KERNELS

// the bf16 instances, unit by unit: conv2 width bn2 per warpgroup, wide or
// not (wide only from 64)
constexpr int kUnitBn2[8] = {16, 32, 64, 64, 128, 128, 256, 256};
constexpr bool kUnitWide[8] = {false, false, false, true, false, true, false, true};

#if FUSED_BOTTLENECK_PART < 8
template cudaError_t tc_launch<kUnitBn2[FUSED_BOTTLENECK_PART], kUnitWide[FUSED_BOTTLENECK_PART]>(
    const BottleneckArgs& p, size_t smem, cudaStream_t stream);
template cudaError_t tc_occupancy<kUnitBn2[FUSED_BOTTLENECK_PART],
                                  kUnitWide[FUSED_BOTTLENECK_PART]>(int smem, int* blocks);
#endif

#if FUSED_BOTTLENECK_PART == 8
cudaError_t f32_launch(const BottleneckArgs& p, size_t smem, cudaStream_t stream) {
  return launch(bottleneck_kernel<float>, p, smem, stream);
}

cudaError_t f32_occupancy(int smem, int* blocks) {
  return occupancy(bottleneck_kernel<float>, smem, blocks);
}
#endif

#if FUSED_BOTTLENECK_ENTRY
// f(bn2, wide) with the bf16 instance's template arguments as types
// (std::integral_constant), for conv2 width bn2 per warpgroup, wide or not
template <typename F>
cudaError_t with_tc(int bn2, int wide, F f) {
  using std::false_type;
  using std::integral_constant;
  using std::true_type;
  switch (bn2) {
    case 16: return f(integral_constant<int, 16>{}, false_type{});
    case 32: return f(integral_constant<int, 32>{}, false_type{});
    case 64: return wide ? f(integral_constant<int, 64>{}, true_type{})
                         : f(integral_constant<int, 64>{}, false_type{});
    case 128: return wide ? f(integral_constant<int, 128>{}, true_type{})
                          : f(integral_constant<int, 128>{}, false_type{});
    default: return wide ? f(integral_constant<int, 256>{}, true_type{})
                         : f(integral_constant<int, 256>{}, false_type{});
  }
}
#endif  // FUSED_BOTTLENECK_ENTRY

}  // namespace bneck

#if FUSED_BOTTLENECK_ENTRY
using namespace bneck;

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for arguments the kernel does not take. elem_size: 4 (float32) or 2 (bf16);
// ns, stages, depth and wide (bf16 only): 2 when the two warpgroups split
// conv2's width, 1 when they split its rows; the ring's stages and their
// depth; one hidden chunk of every channel.
extern "C" int fused_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* w3, const void* b3, const void* wd,
                                const void* bd, void* out, long long n, int h, int w, int cin,
                                int chid, int cout, int stride, int mode, int th, int tw, int g,
                                int ns, int stages, int depth, int wide, int elem_size,
                                void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || h < 1 || w < 1 || cin < 1 || chid < 1 || cout < 1 || th < 1 || tw < 1 ||
      g < 1 || (stride != 1 && stride != 2) || mode < 0 || mode > 2 ||
      (mode == 0 && (stride != 1 || cin != cout)) || (mode == 1 && (wd == nullptr || bd == nullptr)) ||
      (n + g - 1) / g > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (elem_size == 2 &&
      ((ns != 1 && ns != 2) || g * th * tw > 64 * (2 / ns) || (chid + ns - 1) / ns > 256 ||
       stages < 3 || stages > tc::kMaxStages || (depth != 32 && depth != 64) ||
       (wide && bn2_of(chid, ns) < 64)))
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
  p.ns = ns;
  p.stages = stages;
  p.depth = depth;
  p.wide = wide;
  p.rh_max = region_max(th, stride, h);
  p.rw_max = region_max(tw, stride, w);
  if (((p.h_out + th - 1) / th) * ((p.w_out + tw - 1) / tw) > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, elem_size);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 4: return (int)f32_launch(p, smem, s);
    case 2:
      return (int)with_tc(bn2_of(chid, ns), wide, [&](auto bn, auto wd) {
        return tc_launch<decltype(bn)::value, decltype(wd)::value>(p, smem, s);
      });
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the kernel that one SM holds at smem bytes of shared memory
// (registers included); 0 on error.
extern "C" int fused_bottleneck_blocks_per_sm(int chid, int ns, int wide, int elem_size,
                                              int smem) {
  int blocks = 0;
  cudaError_t err = elem_size == 4 ? f32_occupancy(smem, &blocks)
                                   : with_tc(bn2_of(chid, ns), wide, [&](auto bn, auto wd) {
                                       return tc_occupancy<decltype(bn)::value,
                                                           decltype(wd)::value>(smem, &blocks);
                                     });
  return err == cudaSuccess ? blocks : 0;
}
#endif  // FUSED_BOTTLENECK_ENTRY
