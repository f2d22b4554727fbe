// int8 convolutions of the int8 serving forward, for Hopper (sm_90a).
//
// No Pallas kernel is replaced: the JAX package runs these products as XLA
// ops (adafocus_tpu/ops/quant.py:61-87, lax.conv_general_dilated and jnp.dot
// with preferred_element_type=int32), and XLA fuses each unit's requantize
// into the conv's output (adafocus_tpu/models/quant_inference.py:6-8).
// PyTorch has no CUDA int8 convolution with per-output-channel scales, and
// torch._int_mm refuses M <= 16, which a batch-1 GRU step needs, so both
// kernels are written here, the requantize inside them.
//
// The epilogue of both is JAX's unit (_UnitRunner with its backbones), in
// its order: y = fma(float(acc), rescale[c], bias[c]) with rescale = x_scale
// * w_scale (float32, made by the host), the activation (none, ReLU,
// ReLU6), a round to the compute dtype (float32 or bf16, nearest even);
// with a residual r (compute dtype) y = round(float(y) + float(r)), ReLU
// after the add where asked (ResNet's relu(b + res); MobileNetV2's h + b
// has none); then any of: y stored in the compute dtype, y's int8 code at
// the consumer's scale s, clamp(rint(y / s), -127, 127) rounded as the IEEE
// quotient rounds (quantize_act's division; quantize() below says how it
// gets there without a division per value), the int32 accumulator itself
// (out_kind 2, for the tests). An input may come in the compute dtype
// instead of int8 codes: it is quantized on load at the unit's own x_scale
// (the stems' outputs, ResNet's max-pool output and the block inputs its
// down units read). The epilogue's common path runs on the FP32 and integer
// pipes (the conversion pipe issues at a quarter rate), and each launch
// runs an instance specialised to the outputs it asks for (epi_mode).
//
// int8_conv: a dense convolution as an implicit GEMM on the tensor cores.
// Rows are the N*Ho*Wo output pixels of an NHWC input, columns the output
// channels, the depth the kh*kw*Cin taps in (ky, kx, ci) order; kh = kw in
// {1, 3}, stride 1 or 2, padding (kh - 1) / 2; the heads' int8_dense is a
// 1x1 conv over (M, 1, 1, K). Bound: operations at the deep 3x3 units
// (1979 TOP/s int8 dense on an H100 SXM), bytes at the 1x1 units of small
// depth and at the heads. Design:
//  - wgmma.mma_async m64nBNk32 s8 x s8 -> s32, both operands K-major in
//    shared memory in the no-swizzle core-matrix layout (8 rows x 16 bytes
//    contiguous; a tile stored depth-chunk major, so a depth step only moves
//    the descriptor's start);
//  - persistent blocks, as many as fit on the card, each walking output
//    tiles: a producer warpgroup fills a ring of shared-memory stages, a
//    full and an empty mbarrier a stage, counting its steps across tiles,
//    so the next tiles load while one or two consumer warpgroups (a 64- or
//    128-row tile) multiply and finish this one. The weight tile of a stage
//    is one bulk copy (cp.async.bulk on the full barrier): the host packs
//    the weight tile by tile in the layout the tensor cores read
//    (ops/quant.py pack_conv_weight). The implicit-GEMM rows come by
//    cp.async copies of 16 bytes (or of 8 where Cin % 8 == 0: the K = 24
//    expand units), zero-filled for padding taps and rows past M, each
//    producer thread's copies arriving on the full barrier
//    (cp.async.mbarrier.arrive.noinc); a row that is not 8-byte aligned or
//    an input quantized on load is gathered by an out-of-line routine, which
//    keeps the copy loops short;
//  - tiles sized to the units: BN in {32, 64, 96, 128} and the depth step
//    BK in {32, 64, 128} come with the packed weight, picked by its shape
//    (the K = 16 and 24 expand units step 32 deep); one or two consumers by
//    the row count;
//  - split K for small M (the heads at M = 1 and 64, 1x1 units on tiny
//    maps): the tiles' third coordinate slices the depth so that every SM
//    streams weight; each slice writes its exact int32 partial sums, and a
//    second pass adds them in slice order and applies the one epilogue, so
//    no result depends on the order the blocks ran in;
//  - the epilogue stages the accumulators through shared memory (laid out
//    so that a thread's four 16-byte reads hit distinct banks) beside the
//    tile's rescale and bias, and each thread finishes 16 consecutive
//    channels of one row: 16-byte stores of the int8 codes and of the
//    compute-dtype values, consecutive threads on consecutive chunks.
//
// int8_dwconv: a depthwise 3x3 convolution, stride 1 or 2, padding 1, on
// the CUDA cores. Bound: bytes (9 products a value read). A persistent
// block walks tiles of th output rows of one image and a slab of CS
// channels (16, 32 or 64): the next tile's input rows with their 1-pixel
// halo load into shared memory (cp.async, zero-filled outside the image;
// two buffers) while this one's outputs are computed, so each input byte
// leaves HBM once; each thread keeps the 9 taps of its 4 channels in
// registers as byte-masked words and computes one output pixel after
// another with __dp4a (one instruction a product). The int8 codes go
// through a shared-memory tile and leave in 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "fused_gemm.cuh"

// The build compiles this file as twelve units at once, INT8_CONV_PART = 0
// to 11 (ops/_kernels.py PARTS), and links them into one library: unit
// p < 8 holds the GEMM instance conv_kernel<32 (p % 4 + 1), p / 4 + 1>,
// units 8 to 10 the depthwise instances of the slab 16 << (p - 8), unit 11
// the entry points at the end, which call the instances' launchers across
// the units.
#if INT8_CONV_PART == 11
#define INT8_CONV_KERNELS 0   // this unit defines no launcher
#define INT8_CONV_ENTRY 1     // this unit defines the entry points
#else
#define INT8_CONV_KERNELS 1
#define INT8_CONV_ENTRY 0
#endif

namespace int8k {

namespace tc = fused::tc;
using bf16 = __nv_bfloat16;

enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2 };
enum { IN_I8 = 0, IN_F32 = 1, IN_BF16 = 2 };
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2 };

constexpr int kMaxStages = 8;
constexpr int kHeader = 256;              // bytes before the ring: the mbarriers
constexpr int kRingBudget = 48 * 1024;    // shared memory the ring may take
constexpr int kDwSmem = 72 * 1024;        // the depthwise block's tiles at most
constexpr int kSmemLimit = 200 * 1024;    // dynamic shared memory a launch may ask

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// The epilogue.
// ---------------------------------------------------------------------------

struct Epi {
  const float* rescale;   // (Cout,) x_scale * w_scale
  const float* bias;      // (Cout,)
  const void* res;        // (rows, Cout) compute dtype, or null
  void* out;              // (rows, Cout) of out_kind, or null
  int8_t* outq;           // (rows, Cout) int8 codes at *qscale, or null
  const float* qscale;    // () the consumer's scale
  int out_kind, act, res_relu, cout;
  bool small_acc;         // |acc| < 2^22: depth * 127 * 127 below it
};

// The epilogue's arithmetic on the FP32 and integer pipes: the conversion
// instructions (I2F, F2F, FRND, F2I) issue at a quarter of their rate, and
// an epilogue of a small-depth unit did little else. Each below is exact.
constexpr float kMagic = 12582912.f;   // 1.5 * 2^23: x + kMagic rounds x to an integer
constexpr int kMagicBits = 0x4B400000;

// float(acc), exact: |acc| < 2^22 through the magic number (small: the
// unit's depth bounds it), else I2F
__device__ __forceinline__ float acc_to_float(int acc, bool small) {
  return small ? __int_as_float(acc + kMagicBits) - kMagic : __int2float_rn(acc);
}

// y rounded to the nearest bf16, ties to even, kept as a float (finite y)
__device__ __forceinline__ float bf16_round(float y) {
  uint32_t u = __float_as_uint(y);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ float round_to(float y, int kind) {
  return kind == OUT_BF16 ? bf16_round(y) : y;
}

// clamp(rint(y / scale), -127, 127) with the IEEE quotient's rounding, as
// quantize_act divides, as the code's byte. inv = 1 / scale rounded to
// nearest makes q = y * inv within 3 ulp of the correctly rounded quotient,
// so rint(q) is rint of the quotient unless q lies that close to a
// half-integer: those few take __fdiv_rn (|q| <= 128, where 1e-4 is over 4
// such distances; beyond, both clamp). rint is q + 1.5 * 2^23 - 1.5 * 2^23
// in round-to-nearest-even, exact for |q| <= 128; the code is the low byte
// of the sum's bits.
__device__ __forceinline__ uint32_t quantize(float y, float scale, float inv) {
  const float q = fminf(fmaxf(y * inv, -128.f), 128.f);
  float t = q + kMagic;
  if (fabsf(q - (t - kMagic)) > 0.5f - 1e-4f)
    t = fminf(fmaxf(__fdiv_rn(y, scale), -128.f), 128.f) + kMagic;
  return __float_as_uint(fminf(fmaxf(t - kMagic, -127.f), 127.f) + kMagic) & 0xFFu;
}

// p[0, n) = v[0, n): 16-byte stores when all NV go to an aligned address
template <typename T, int NV>
__device__ __forceinline__ void store_n(T* p, const T (&v)[NV], int n) {
  constexpr int kBytes = NV * (int)sizeof(T);
  if (n == NV && kBytes % 16 == 0 && aligned16(p)) {
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u)
      reinterpret_cast<uint4*>(p)[u] = reinterpret_cast<const uint4*>(v)[u];
  } else if (n == NV && kBytes == 8 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < n) p[j] = v[j];
  }
}

// v[0, n) = p[0, n) as float
template <typename T, int NV>
__device__ __forceinline__ void load_n(float (&v)[NV], const T* p, int n) {
  alignas(16) T raw[NV];
  constexpr int kBytes = NV * (int)sizeof(T);
  if (n == NV && kBytes % 16 == 0 && aligned16(p)) {
#pragma unroll
    for (int u = 0; u < kBytes / 16; ++u)
      reinterpret_cast<uint4*>(raw)[u] = __ldg(reinterpret_cast<const uint4*>(p) + u);
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) raw[j] = j < n ? p[j] : T();
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if constexpr (sizeof(T) == 2)
      v[j] = __bfloat162float(raw[j]);
    else
      v[j] = raw[j];
  }
}

// v[0, 4) = p[0, 4) (the first n of them; the rest 0), p in shared or
// global memory
__device__ __forceinline__ void load4(float (&v)[4], const float* p, int n) {
  if (n >= 4 && aligned16(p)) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? p[j] : 0.f;
  }
}

// The fused outputs a launch asks for, as flags of a specialised epilogue
// (bf16 compute dtype); 0 is the general one, which reads them at run time
// (float32, the int32 accumulators). A tile's loop is instantiated for
// each, so the one a launch runs holds no code of the others.
enum { E_BF16 = 1, E_RES = 2, E_OUT = 4, E_Q = 8 };

__host__ __device__ inline int epi_mode(int out_kind, bool res, bool out, bool q) {
  return out_kind != OUT_BF16 ? 0 : E_BF16 | (res ? E_RES : 0) | (out ? E_OUT : 0) | (q ? E_Q : 0);
}

// The epilogue of NV consecutive channels [c0, c0 + NV) of output row
// `row`, the first n of them inside Cout, four at a time (few registers
// live: the outputs leave packed). rs, bs: the rescale and bias of those
// channels (a block stages them in shared memory). lo, hi: the activation
// as a clamp; rlo the ReLU after the residual add (0, or -inf). The codes
// go to qdst (the int8 output's element, or a shared-memory tile) when the
// unit has them, at scale s (inv = 1 / s, rounded: the caller's, once).
template <int NV, int MODE>
__device__ __forceinline__ void epilogue_n(const Epi& e, long long row, int c0, int n,
                                           const int (&acc)[NV], const float* rs,
                                           const float* bs, int8_t* qdst, float s, float inv,
                                           float lo, float hi, float rlo) {
  static_assert(NV % 4 == 0, "four channels at a time");
  constexpr bool kSpec = MODE != 0;
  const int kind = kSpec ? OUT_BF16 : e.out_kind;
  const bool has_res = kSpec ? (MODE & E_RES) != 0 : e.res != nullptr;
  const bool has_out = kSpec ? (MODE & E_OUT) != 0 : e.out != nullptr;
  const bool has_q = kSpec ? (MODE & E_Q) != 0 : qdst != nullptr;
  const long long i = row * e.cout + c0;
  if (!kSpec && kind == OUT_I32) {
    alignas(16) int v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = acc[j];
    store_n(static_cast<int*>(e.out) + i, v, n);
    return;
  }
  const bool bf = kind == OUT_BF16;
  alignas(16) uint32_t qw[NV / 4];   // the codes, 4 a word
  alignas(16) uint32_t hw[NV / 2];   // bf16 outputs, 2 a word
#pragma unroll
  for (int g = 0; g < NV / 4; ++g) {
    const int m = n - 4 * g;   // channels of this group inside Cout (may be <= 0)
    const int mv = m < 4 ? (m > 0 ? m : 0) : 4;
    float r[4], b[4], res[4], y[4];
    load4(r, rs + 4 * g, mv);
    load4(b, bs + 4 * g, mv);
    if (has_res) {
      if (bf)
        load_n(res, static_cast<const bf16*>(e.res) + i + 4 * g, mv);
      else
        load_n(res, static_cast<const float*>(e.res) + i + 4 * g, mv);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = __fmaf_rn(acc_to_float(acc[4 * g + j], e.small_acc), r[j], b[j]);
      v = round_to(fminf(fmaxf(v, lo), hi), kind);
      if (has_res) v = round_to(fmaxf(__fadd_rn(v, res[j]), rlo), kind);
      y[j] = v;
    }
    if (has_out && !bf) {
      alignas(16) float v[4] = {y[0], y[1], y[2], y[3]};
      if (mv > 0) store_n(static_cast<float*>(e.out) + i + 4 * g, v, mv);
    }
    if (has_out && bf) {   // y is a bf16 already: its high half
      hw[2 * g] = __float_as_uint(y[0]) >> 16 | (__float_as_uint(y[1]) & 0xFFFF0000u);
      hw[2 * g + 1] = __float_as_uint(y[2]) >> 16 | (__float_as_uint(y[3]) & 0xFFFF0000u);
    }
    if (has_q)
      qw[g] = quantize(y[0], s, inv) | quantize(y[1], s, inv) << 8 |
              quantize(y[2], s, inv) << 16 | quantize(y[3], s, inv) << 24;
  }
  if (has_out && bf)
    store_n(static_cast<bf16*>(e.out) + i, reinterpret_cast<const bf16(&)[NV]>(hw), n);
  if (has_q) store_n(qdst, reinterpret_cast<const int8_t(&)[NV]>(qw), n);
}

// the activation as a clamp [lo, hi], and the floor after the residual add
__device__ __forceinline__ void act_bounds(const Epi& e, float& lo, float& hi, float& rlo) {
  lo = e.act == ACT_NONE ? -__int_as_float(0x7f800000) : 0.f;
  hi = e.act == ACT_RELU6 ? 6.f : __int_as_float(0x7f800000);
  rlo = e.res_relu ? 0.f : -__int_as_float(0x7f800000);
}

// one input element as its int8 code: an int8 input as it is, a float32 or
// bf16 one quantized at the unit's scale
__device__ __forceinline__ int8_t in_code(const void* x, int kind, long long i, float xs) {
  if (kind == IN_I8) return static_cast<const int8_t*>(x)[i];
  const float v = kind == IN_F32 ? static_cast<const float*>(x)[i]
                                 : __bfloat162float(static_cast<const bf16*>(x)[i]);
  return (int8_t)quantize(v, xs, __frcp_rn(xs));
}

// 16 consecutive input elements from x[i] as int8 codes, the first n real
// (the rest 0); 16-byte loads where the elements are aligned
__device__ __forceinline__ int4 codes16(const void* x, int kind, long long i, int n, float xs) {
  alignas(16) int8_t q[16];
  if (kind == IN_I8) {
    const int8_t* p = static_cast<const int8_t*>(x) + i;
    if (n == 16 && aligned16(p)) return *reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int b = 0; b < 16; ++b) q[b] = b < n ? p[b] : 0;
  } else {
    float v[16];
    if (kind == IN_F32)
      load_n(v, static_cast<const float*>(x) + i, n);
    else
      load_n(v, static_cast<const bf16*>(x) + i, n);
#pragma unroll
    const float inv = __frcp_rn(xs);
#pragma unroll
    for (int b = 0; b < 16; ++b) q[b] = b < n ? (int8_t)quantize(v[b], xs, inv) : 0;
  }
  return *reinterpret_cast<const int4*>(q);
}

// Blocks of `kernel` resident on the whole card at `smem` bytes of dynamic
// shared memory (a persistent grid), its shared-memory limit raised first
// (to kSmemLimit, so that no later launch finds it lower than it needs).
// Both are asked once for each kernel, device and size: a launch of a
// batch-1 forward pays no CUDA attribute query.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* out) {
  struct Entry {
    const void* fn;
    int dev, smem, blocks;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;   // launches may come from several host threads
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].dev == dev && cache[i].smem == smem) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  // the limit only permits: raised to the largest size any launch asks
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemLimit)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (used < 64) cache[used++] = Entry{fn, dev, smem, *out};
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// int8_conv: the tensor-core implicit GEMM.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init_n(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_u32(bar)) : "memory");
}
// an arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(tc::smem_u32(bar))
               : "memory");
}
// one 8-byte asynchronous copy (cached in L1: .cg takes 16 bytes only),
// zero-filled past `bytes`
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(tc::smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Descriptor of a K-major no-swizzle operand at p: core matrices (8 rows x
// 16 bytes) `lbo` bytes apart along the depth, 128 bytes apart along rows.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, int lbo) {
  return (uint64_t)((tc::smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(128 >> 4) << 32;
}

// D[64 x N] (+)= A[64 x 32] B[32 x N], s8 x s8 -> s32; scale_d 0 starts afresh
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

struct ConvArgs {
  const void* x;          // (N, H, W, Cin) int8, float32 or bf16 (in_kind)
  const float* x_scale;   // () the unit's input scale (an input quantized on load)
  const int8_t* w;        // the packed weight: (Cout_pad / BN, ksteps) tiles of BN x BK
  int* ws;                // split K: (splits, M, Cout_pad) int32 partial sums, else null
  int m;                  // N * Ho * Wo
  int in_kind, h, w_, cin, ho, wo, k, ksteps, bk, cout_pad, kw, stride, pad;
  int steps_per_split, stages, vec;   // vec: the input rows' copy width, 16, 8 or 0
  int m_tiles, n_tiles, tiles;   // output tiles: m x n x K slices
  Epi epi;
};

// output tile t of a persistent block's walk: column tiles fastest (the
// blocks at work share their input rows in L2), then rows, then K slices
struct TileId {
  int m0, n_tile, slice, s0, nsteps;
};

__device__ __forceinline__ TileId tile_id(const ConvArgs& a, int t, int bm) {
  TileId id;
  id.n_tile = t % a.n_tiles;
  const int rest = t / a.n_tiles;
  id.m0 = rest % a.m_tiles * bm;
  id.slice = rest / a.m_tiles;
  id.s0 = id.slice * a.steps_per_split;
  id.nsteps = min(a.ksteps - id.s0, a.steps_per_split);
  return id;
}

// the input pixel of one GEMM row: its image's element offset and the
// top-left tap's position (valid: the row is inside M)
struct Row {
  long long base;
  int iy0, ix0;
  bool valid;
};

__device__ __forceinline__ Row row_of(const ConvArgs& a, int m) {
  Row r{0, 0, 0, m < a.m};
  if (r.valid) {
    const int ox = m % a.wo;
    const int q = m / a.wo;
    const int oy = q % a.ho;
    r.base = (long long)(q / a.ho) * a.h * a.w_ * a.cin;
    r.iy0 = oy * a.stride - a.pad;
    r.ix0 = ox * a.stride - a.pad;
  }
  return r;
}

// element offset of depth k of a row, or -1 for a padding tap or k >= K
__device__ __forceinline__ long long tap_offset(const ConvArgs& a, const Row& r, int k) {
  if (!r.valid || k >= a.k) return -1;
  const int tap = k / a.cin, ci = k - tap * a.cin;
  const int ky = tap / a.kw, kx = tap - ky * a.kw;
  const int iy = r.iy0 + ky, ix = r.ix0 + kx;
  if (iy < 0 || iy >= a.h || ix < 0 || ix >= a.w_) return -1;
  return r.base + ((long long)iy * a.w_ + ix) * a.cin + ci;
}

// 16 codes at depths k..k+15 of a row, gathered
static __device__ __noinline__ int4 gather16(const ConvArgs& a, const Row& r, int k,
                                              float xs) {
  if (a.cin % 16 == 0) {  // the 16 depths lie in one tap
    const long long i = tap_offset(a, r, k);
    return i < 0 ? make_int4(0, 0, 0, 0) : codes16(a.x, a.in_kind, i, 16, xs);
  }
  alignas(16) int8_t q[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const long long i = tap_offset(a, r, k + b);
    q[b] = i < 0 ? 0 : in_code(a.x, a.in_kind, i, xs);
  }
  return *reinterpret_cast<const int4*>(q);
}

// The producer warpgroup: for each output tile of the block's walk and each
// of its depth steps, the weight tile by one bulk copy and the BM x BK
// input tile, chunk q = t + 128 j of it being row rg * 8 + q % 8, depth
// chunk kc, at ((kc * BM / 8 + rg) * 8 + q % 8) * 16: eight consecutive
// threads fill one core matrix (no bank conflict) from eight rows. Steps
// are counted across tiles (g), so the ring runs on from one tile into
// the next while the consumers finish the last one's epilogue.
template <int BN, int NC>
__device__ __forceinline__ void produce(const ConvArgs& a, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int BM = 64 * NC;
  const int t = threadIdx.x;
  const int cpr = a.bk / 16, chunks = BM * cpr / 128;
  const int a_bytes = BM * a.bk, stage_bytes = (BM + BN) * a.bk;
  int kc[8], off[8], rsel[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = t + 128 * j, r8 = q & 7, c = (q >> 3) % cpr, rg = (q >> 3) / cpr;
    kc[j] = c;
    off[j] = ((c * (BM / 8) + rg) * 8 + r8) * 16;
    rsel[j] = rg * 8 + r8;
  }
  const float xs = a.in_kind == IN_I8 ? 1.f : __ldg(a.x_scale);
  const int8_t* x8 = static_cast<const int8_t*>(a.x);
  int g = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const TileId id = tile_id(a, tile, BM);
    Row rows[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < chunks) rows[j] = row_of(a, id.m0 + rsel[j]);
    for (int i = 0; i < id.nsteps; ++i, ++g) {
      const int stage = g % a.stages;
      if (g >= a.stages) tc::mbar_wait(empty + stage, (g / a.stages - 1) & 1);
      unsigned char* at = ring + stage * stage_bytes;
      if (t == 0)
        tc::bulk_load(at + a_bytes,
                      a.w + ((long long)id.n_tile * a.ksteps + id.s0 + i) * BN * a.bk,
                      BN * a.bk, full + stage);
      const int kbase = (id.s0 + i) * a.bk;
      if (a.vec == 16) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= chunks) break;
          const long long e = tap_offset(a, rows[j], kbase + kc[j] * 16);
          tc::cp_async16(at + off[j], e < 0 ? x8 : x8 + e, e < 0 ? 0 : 16);
        }
      } else if (a.vec == 8) {  // each 8-byte half lies in one tap
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= chunks) break;
          const int k = kbase + kc[j] * 16;
          const long long e0 = tap_offset(a, rows[j], k), e1 = tap_offset(a, rows[j], k + 8);
          cp_async8(at + off[j], e0 < 0 ? x8 : x8 + e0, e0 < 0 ? 0 : 8);
          cp_async8(at + off[j] + 8, e1 < 0 ? x8 : x8 + e1, e1 < 0 ? 0 : 8);
        }
      } else {  // out of line: the copy loops above stay a few instructions long
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= chunks) break;
          *reinterpret_cast<int4*>(at + off[j]) = gather16(a, rows[j], kbase + kc[j] * 16, xs);
        }
      }
      if (a.vec) {
        cp_async_arrive(full + stage);
      } else {
        tc::fence_async();
        mbar_arrive(full + stage);
      }
    }
  }
  tc::cp_wait<0>();
}

// what a tile's finish reads besides the launch's arguments
struct FinishArgs {
  const int* staging;   // the accumulators, chunk-interleaved (conv_kernel)
  const float* coef;    // the tile's rescale (BN) and bias (BN)
  int m0, n0, slice;
  float qs, qinv, lo, hi, rlo;
};

// The consumers finish a staged tile: each thread 16 consecutive channels
// of a row, consecutive threads on consecutive chunks; the raw sums to the
// split-K workspace, or the epilogue of mode MODE.
template <int BN, int NC, int MODE>
__device__ __forceinline__ void finish_tile(const ConvArgs& a, const FinishArgs& f) {
  constexpr int BM = 64 * NC, CH = BM * BN / 16;
  const Epi& e = a.epi;
  for (int x = threadIdx.x - 128; x < CH; x += NC * 128) {
    const int row = x / (BN / 16), c0 = f.n0 + x % (BN / 16) * 16;
    const int m = f.m0 + row;
    if (m >= a.m) continue;
    alignas(16) int v[16];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      reinterpret_cast<int4*>(v)[u] = reinterpret_cast<const int4*>(f.staging)[u * CH + x];
    if (a.ws != nullptr) {
      int4* p = reinterpret_cast<int4*>(a.ws + ((long long)f.slice * a.m + m) * a.cout_pad + c0);
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = reinterpret_cast<const int4*>(v)[u];
    } else if (c0 < e.cout) {
      epilogue_n<16, MODE>(e, m, c0, min(16, e.cout - c0), v, f.coef + (c0 - f.n0),
                           f.coef + BN + (c0 - f.n0),
                           e.outq == nullptr ? nullptr : e.outq + (long long)m * e.cout + c0,
                           f.qs, f.qinv, f.lo, f.hi, f.rlo);
    }
  }
}

// A persistent block: a producer warpgroup and NC consumer warpgroups walk
// the output tiles blockIdx.x, blockIdx.x + gridDim.x, ...; consumer c
// multiplies rows [64 c, 64 c + 64) of each tile, then the consumers
// finish the tile together through the staging tile while the producer
// fills the ring for the next.
template <int BN, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), BN == 128 ? 1 : 2)
conv_kernel(const __grid_constant__ ConvArgs a) {
  constexpr int BM = 64 * NC;
  constexpr int CH = BM * BN / 16;   // 16-column chunks of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* staging = reinterpret_cast<int*>(smem + kHeader);
  float* coef = reinterpret_cast<float*>(smem + kHeader + BM * BN * 4);   // rescale, bias
  unsigned char* ring = smem + kHeader + BM * BN * 4 + 2 * BN * 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init_n(full + s, 128 + 1);    // the producer's threads and the bulk copy's arrival
      mbar_init_n(empty + s, NC * 128);  // the consumers' threads
    }
    tc::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    produce<BN, NC>(a, ring, full, empty);
    return;
  }

  const int c = threadIdx.x / 128 - 1;
  const int a_bytes = BM * a.bk, stage_bytes = (BM + BN) * a.bk, ksub = a.bk / 32;
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  int acc[BN / 2];
  const float qs = a.epi.outq != nullptr ? __ldg(a.epi.qscale) : 1.f, qinv = __frcp_rn(qs);
  float lo, hi, rlo;
  act_bounds(a.epi, lo, hi, rlo);
  const int mode = a.ws != nullptr ? 0 : epi_mode(a.epi.out_kind, a.epi.res != nullptr,
                                                  a.epi.out != nullptr, a.epi.outq != nullptr);
  int g = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const TileId id = tile_id(a, tile, BM);
    for (int i = 0; i < id.nsteps; ++i, ++g) {
      const int stage = g % a.stages;
      tc::mbar_wait(full + stage, (g / a.stages) & 1);
      tc::fence_async();
      const unsigned char* at = ring + stage * stage_bytes;
      tc::wg_fence();
      for (int s = 0; s < ksub; ++s)
        wgmma_s8<BN>(acc, kmajor_desc(at + c * 1024 + s * 32 * BM, BM * 16),
                     kmajor_desc(at + a_bytes + s * 32 * BN, BN * 16), (i | s) != 0);
      tc::wg_commit();
      tc::wg_wait<1>();   // the previous step's products are done: release its stage
      if (i > 0) mbar_arrive(empty + (g - 1) % a.stages);
    }
    tc::wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + (g - 1) % a.stages);

    // the accumulators through shared memory: element (row, col) of chunk
    // X = row * BN / 16 + col / 16 at int4 (col % 16 / 4) * CH + X
    consumers_sync(NC * 128);   // the last tile's chunks are read
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * c + 16 * w + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const int x = row * (BN / 16) + col / 16;
        *reinterpret_cast<int2*>(staging + ((col % 16 / 4) * CH + x) * 4 + col % 4) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    const int n0 = id.n_tile * BN;
    for (int j = threadIdx.x - 128; j < BN; j += NC * 128) {
      coef[j] = n0 + j < a.epi.cout ? __ldg(a.epi.rescale + n0 + j) : 0.f;
      coef[BN + j] = n0 + j < a.epi.cout ? __ldg(a.epi.bias + n0 + j) : 0.f;
    }
    consumers_sync(NC * 128);
    const FinishArgs f{staging, coef, id.m0, n0, id.slice, qs, qinv, lo, hi, rlo};
    switch (mode) {
      case E_BF16 | E_Q: finish_tile<BN, NC, E_BF16 | E_Q>(a, f); break;
      case E_BF16 | E_Q | E_OUT: finish_tile<BN, NC, E_BF16 | E_Q | E_OUT>(a, f); break;
      case E_BF16 | E_Q | E_RES: finish_tile<BN, NC, E_BF16 | E_Q | E_RES>(a, f); break;
      case E_BF16 | E_Q | E_OUT | E_RES:
        finish_tile<BN, NC, E_BF16 | E_Q | E_OUT | E_RES>(a, f);
        break;
      case E_BF16 | E_OUT: finish_tile<BN, NC, E_BF16 | E_OUT>(a, f); break;
      case E_BF16 | E_OUT | E_RES: finish_tile<BN, NC, E_BF16 | E_OUT | E_RES>(a, f); break;
      default: finish_tile<BN, NC, 0>(a, f);
    }
  }
}

#if INT8_CONV_ENTRY
// split K's second pass: each thread one row's 16 channels, the slices'
// partial sums added in slice order, then the epilogue
__global__ void __launch_bounds__(256)
splitk_finish(const int* __restrict__ ws, int splits, long long m, int cout_pad, Epi e) {
  const int chunks = (e.cout + 15) / 16;
  const float qs = e.outq != nullptr ? __ldg(e.qscale) : 1.f, qinv = __frcp_rn(qs);
  float lo, hi, rlo;
  act_bounds(e, lo, hi, rlo);
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x; x < m * chunks;
       x += (long long)gridDim.x * blockDim.x) {
    const long long row = x / chunks;
    const int c0 = (int)(x % chunks) * 16;
    int acc[16] = {};
    for (int s = 0; s < splits; ++s) {
      const int4* p = reinterpret_cast<const int4*>(ws + ((long long)s * m + row) * cout_pad + c0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int4 v = p[u];
        acc[4 * u] += v.x;
        acc[4 * u + 1] += v.y;
        acc[4 * u + 2] += v.z;
        acc[4 * u + 3] += v.w;
      }
    }
    epilogue_n<16, 0>(e, row, c0, min(16, e.cout - c0), acc, e.rescale + c0, e.bias + c0,
                      e.outq == nullptr ? nullptr : e.outq + row * e.cout + c0, qs, qinv, lo, hi,
                      rlo);
  }
}
#endif  // INT8_CONV_ENTRY

template <int BN, int NC>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream);

#if INT8_CONV_KERNELS
template <int BN, int NC>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  constexpr int BM = 64 * NC;
  const int smem = kHeader + BM * BN * 4 + 2 * BN * 4 + a.stages * (BM + BN) * a.bk;
  int resident = 0;
  cudaError_t err = resident_blocks(conv_kernel<BN, NC>, 128 * (NC + 1), smem, &resident);
  if (err != cudaSuccess) return err;
  const int grid = a.tiles < resident ? a.tiles : resident;
  conv_kernel<BN, NC><<<grid, 128 * (NC + 1), smem, stream>>>(a);
  return cudaGetLastError();
}
#endif  // INT8_CONV_KERNELS

#if INT8_CONV_PART < 8
template cudaError_t launch_conv<32 * (INT8_CONV_PART % 4 + 1), INT8_CONV_PART / 4 + 1>(
    const ConvArgs& a, cudaStream_t stream);
#endif

#if INT8_CONV_ENTRY
template <int NC>
cudaError_t launch_conv_bn(int bn, const ConvArgs& a, cudaStream_t stream) {
  switch (bn) {
    case 32: return launch_conv<32, NC>(a, stream);
    case 64: return launch_conv<64, NC>(a, stream);
    case 96: return launch_conv<96, NC>(a, stream);
    case 128: return launch_conv<128, NC>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}
#endif  // INT8_CONV_ENTRY

// ---------------------------------------------------------------------------
// int8_dwconv: shared-memory tiles on the CUDA cores.
// ---------------------------------------------------------------------------

struct DwArgs {
  const void* x;          // (N, H, W, C) int8, float32 or bf16 (in_kind)
  const float* x_scale;
  const int8_t* w9;       // (9, C) taps, ky * 3 + kx
  int in_kind, n, h, w, c, ho, wo, stride, th, row_tiles, tiles;
  Epi epi;
};

__host__ __device__ inline int dw_region_bytes(int th, int stride, int w, int cs) {
  return ((th - 1) * stride + 3) * (w + 2) * cs;
}

// tile t: (slab of CS channels, image, band of th output rows), the slab
// slowest so that a block's next tile keeps its taps
struct DwTile {
  int n, c0, oy0, oth;
};

template <int CS>
__device__ __forceinline__ DwTile dw_tile(const DwArgs& a, int t) {
  const int per_slab = a.n * a.row_tiles, rest = t % per_slab;
  DwTile d;
  d.c0 = t / per_slab * CS;
  d.n = rest / a.row_tiles;
  d.oy0 = rest % a.row_tiles * a.th;
  d.oth = min(a.th, a.ho - d.oy0);
  return d;
}

// A tile's input rows with their halo into buf, zeros outside the image:
// cp.async 16-byte copies of int8 codes, else codes made on load
template <int CS>
__device__ __forceinline__ void dw_load(const DwArgs& a, const DwTile& d, unsigned char* buf,
                                        bool vec, float xs) {
  const int rw = a.w + 2, iy_base = d.oy0 * a.stride - 1;
  const int chunks = dw_region_bytes(d.oth, a.stride, a.w, CS) / 16;
  const int8_t* x8 = static_cast<const int8_t*>(a.x);
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const int cc = q % (CS / 16), px = q / (CS / 16);
    const int iy = iy_base + px / rw, ix = px % rw - 1, ch = d.c0 + cc * 16;
    const bool inside = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w && ch < a.c;
    const long long e = inside ? (((long long)d.n * a.h + iy) * a.w + ix) * a.c + ch : 0;
    if (vec)
      tc::cp_async16(buf + q * 16, x8 + e, inside ? 16 : 0);
    else
      *reinterpret_cast<int4*>(buf + q * 16) =
          inside ? codes16(a.x, a.in_kind, e, min(16, a.c - ch), xs) : make_int4(0, 0, 0, 0);
  }
}

// A persistent block walks the tiles blockIdx.x, blockIdx.x + gridDim.x,
// ...: the next tile's input rows load (cp.async) into the other of two
// buffers while this one's outputs are computed, each thread 4 channels of
// one pixel after another, the 9 taps of its channels in registers.
template <int CS, int MODE>
__global__ void __launch_bounds__(256, 4) dw_kernel(const __grid_constant__ DwArgs a) {
  constexpr int WPP = CS / 4;            // 32-bit words of a pixel's slab
  constexpr int kStep = 256 / WPP;       // pixels in flight
  extern __shared__ __align__(128) unsigned char smem[];
  const int region = (dw_region_bytes(a.th, a.stride, a.w, CS) + 15) / 16 * 16;
  unsigned char* bufs[2] = {smem, smem + region};
  int8_t* qtile = reinterpret_cast<int8_t*>(smem + 2 * region);
  float* coef = reinterpret_cast<float*>(smem + 2 * region + a.th * a.wo * CS);  // rescale, bias
  const bool vec = a.in_kind == IN_I8 && a.c % 16 == 0 && aligned16(a.x);
  const float xs = a.in_kind == IN_I8 ? 1.f : __ldg(a.x_scale);
  const float qs = a.epi.outq != nullptr ? __ldg(a.epi.qscale) : 1.f, qinv = __frcp_rn(qs);
  float lo, hi, rlo;
  act_bounds(a.epi, lo, hi, rlo);
  const int rw = a.w + 2, cw = threadIdx.x % WPP;
  int t = blockIdx.x;
  if (t >= a.tiles) return;
  dw_load<CS>(a, dw_tile<CS>(a, t), bufs[0], vec, xs);
  tc::cp_commit();
  int slab = -1, taps[9][4];
  for (int k = 0; t < a.tiles; t += gridDim.x, ++k) {
    if (t + (int)gridDim.x < a.tiles)
      dw_load<CS>(a, dw_tile<CS>(a, t + gridDim.x), bufs[(k + 1) & 1], vec, xs);
    tc::cp_commit();
    const DwTile d = dw_tile<CS>(a, t);
    const int ch = d.c0 + cw * 4, nv = min(4, a.c - ch);
    if (d.c0 != slab) {  // this thread's 4 channels' taps, byte v of a word channel v's
      slab = d.c0;
      for (int j = threadIdx.x; j < CS; j += blockDim.x) {
        coef[j] = slab + j < a.c ? __ldg(a.epi.rescale + slab + j) : 0.f;
        coef[CS + j] = slab + j < a.c ? __ldg(a.epi.bias + slab + j) : 0.f;
      }
#pragma unroll
      for (int tp = 0; tp < 9; ++tp)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          taps[tp][v] = ch + v < a.c
              ? (int)((uint32_t)(uint8_t)__ldg(a.w9 + tp * a.c + ch + v) << (8 * v)) : 0;
    }
    tc::cp_wait<1>();
    __syncthreads();
    const uint32_t* words = reinterpret_cast<const uint32_t*>(bufs[k & 1]);
    const int pixels = d.oth * a.wo;
    for (int p = threadIdx.x / WPP; p < pixels; p += kStep) {
      const int ly = p / a.wo, ox = p - ly * a.wo;
      const int ry0 = ly * a.stride, rx0 = ox * a.stride;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int xv = (int)words[((ry0 + ky) * rw + rx0 + kx) * WPP + cw];
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] = __dp4a(xv, taps[ky * 3 + kx][v], acc[v]);
        }
      if (nv > 0) {
        const long long row = ((long long)d.n * a.ho + d.oy0 + ly) * a.wo + ox;
        epilogue_n<4, MODE>(a.epi, row, ch, nv, acc, coef + cw * 4, coef + CS + cw * 4,
                            a.epi.outq == nullptr ? nullptr : qtile + p * CS + cw * 4, qs, qinv,
                            lo, hi, rlo);
      }
    }
    if (a.epi.outq != nullptr) {
      // the codes leave in 16-byte chunks, consecutive threads on
      // consecutive chunks of a row
      __syncthreads();
      for (int q = threadIdx.x; q < pixels * (CS / 16); q += 256) {
        const int p = q / (CS / 16), c = d.c0 + (q % (CS / 16)) * 16;
        if (c >= a.c) continue;
        const int ly = p / a.wo, ox = p - ly * a.wo;
        const long long row = ((long long)d.n * a.ho + d.oy0 + ly) * a.wo + ox;
        alignas(16) int8_t v[16];
        *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(qtile + q * 16);
        store_n(a.epi.outq + row * a.c + c, v, min(16, a.c - c));
      }
    }
    __syncthreads();   // this buffer and the code tile are free for the tile after next
  }
}

template <int CS>
int dw_smem(const DwArgs& a) {
  return 2 * ((dw_region_bytes(a.th, a.stride, a.w, CS) + 15) / 16 * 16) + a.th * a.wo * CS +
         2 * CS * 4;
}

template <int CS>
cudaError_t launch_dw(DwArgs a, cudaStream_t stream);

#if INT8_CONV_KERNELS
template <int CS>
cudaError_t launch_dw(DwArgs a, cudaStream_t stream) {
  // rows a tile: about 16 pixel-words a thread, within the shared-memory budget
  int th = 4096 / (a.wo * (CS / 4));
  a.th = th < 1 ? 1 : th > a.ho ? a.ho : th;
  while (a.th > 1 && dw_smem<CS>(a) > kDwSmem) --a.th;
  const int smem = dw_smem<CS>(a);
  if (smem > kDwSmem) return cudaErrorInvalidValue;  // a row wider than the budget
  a.row_tiles = (a.ho + a.th - 1) / a.th;
  const long long tiles = (long long)a.n * a.row_tiles * ((a.c + CS - 1) / CS);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  // the forward's depthwise units write bf16 codes alone: their own instance
  const bool codes = epi_mode(a.epi.out_kind, false, a.epi.out != nullptr,
                              a.epi.outq != nullptr) == (E_BF16 | E_Q);
  auto kernel = codes ? dw_kernel<CS, E_BF16 | E_Q> : dw_kernel<CS, 0>;
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, 256, smem, &resident);
  if (err != cudaSuccess) return err;
  const int grid = a.tiles < resident ? a.tiles : resident;
  kernel<<<grid, 256, smem, stream>>>(a);
  return cudaGetLastError();
}
#endif  // INT8_CONV_KERNELS

#if INT8_CONV_PART >= 8 && INT8_CONV_PART < 11
template cudaError_t launch_dw<(16 << (INT8_CONV_PART - 8))>(DwArgs a, cudaStream_t stream);
#endif

}  // namespace int8k

#if INT8_CONV_ENTRY
using namespace int8k;

// int8_conv. x (N, H, W, Cin): int8 codes (in_kind 0) or float32 / bf16 (1 /
// 2) quantized on load at *x_scale; w the packed weight (Cout_pad / bn, ksteps)
// tiles of bn x bk; rescale, bias (Cout,) float32; res (M, Cout) in out_kind's
// dtype or null; out (M, Cout) of out_kind (0 float32, 1 bf16, 2 int32
// accumulators) or null; outq (M, Cout) int8 at *q_scale or null; ws (splits,
// M, Cout_pad) int32 when splits > 1; m = N * Ho * Wo; act 0 none, 1 ReLU, 2
// ReLU6; nc consumer warpgroups (64 * nc rows a tile). Returns the launches'
// cudaError_t.
extern "C" int int8_conv(const void* x, const void* x_scale, const void* w, const void* rescale,
                         const void* bias, const void* res, void* out, void* outq,
                         const void* q_scale, void* ws, long long m, int in_kind, int out_kind,
                         int res_relu, int act, int h, int wd, int cin, int ho, int wo, int cout,
                         int k, int ksteps, int bk, int bn, int cout_pad, int kh, int stride,
                         int pad, int nc, int splits, void* stream) {
  const int bm = 64 * nc;
  if (m <= 0 || m >= (1LL << 31) || (nc != 1 && nc != 2) ||
      (bk != 32 && bk != 64 && bk != 128) || cout_pad % bn || cout > cout_pad ||
      (long long)ksteps * bk < k || splits < 1 || splits > ksteps ||
      (splits > 1 && ws == nullptr) ||
      (out_kind == OUT_I32 && (res != nullptr || outq != nullptr)) ||
      (outq != nullptr && q_scale == nullptr) || (in_kind != IN_I8 && x_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.x = x;
  a.x_scale = static_cast<const float*>(x_scale);
  a.w = static_cast<const int8_t*>(w);
  a.m = (int)m;
  a.in_kind = in_kind;
  a.h = h;
  a.w_ = wd;
  a.cin = cin;
  a.ho = ho;
  a.wo = wo;
  a.k = k;
  a.ksteps = ksteps;
  a.bk = bk;
  a.cout_pad = cout_pad;
  a.kw = kh;
  a.stride = stride;
  a.pad = pad;
  a.steps_per_split = (ksteps + splits - 1) / splits;
  const int stage_bytes = (bm + bn) * bk;
  a.stages = kRingBudget / stage_bytes;
  a.stages = a.stages < 2 ? 2 : a.stages > kMaxStages ? kMaxStages : a.stages;
  // the copy width of the input rows: 16 bytes where Cin % 16 == 0 and the
  // input is 16-byte aligned, 8 where Cin % 8 == 0 and it is 8-byte aligned
  // (the K = 24 expand units), else gathered (0)
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  a.vec = in_kind != IN_I8 ? 0 : cin % 16 == 0 && xa % 16 == 0 ? 16
                                : cin % 8 == 0 && xa % 8 == 0 ? 8 : 0;
  a.epi = Epi{static_cast<const float*>(rescale), static_cast<const float*>(bias), res, out,
              static_cast<int8_t*>(outq), static_cast<const float*>(q_scale), out_kind, act,
              res_relu, cout, (long long)k * 127 * 127 < (1LL << 22)};
  const int nsplit = (ksteps + a.steps_per_split - 1) / a.steps_per_split;
  a.ws = nsplit > 1 ? static_cast<int*>(ws) : nullptr;
  a.m_tiles = (int)((m + bm - 1) / bm);
  a.n_tiles = cout_pad / bn;
  if ((long long)a.m_tiles * a.n_tiles * nsplit >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  a.tiles = a.m_tiles * a.n_tiles * nsplit;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = nc == 1 ? launch_conv_bn<1>(bn, a, s) : launch_conv_bn<2>(bn, a, s);
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long work = m * ((cout + 15) / 16);
  const long long blocks = (work + 255) / 256;
  splitk_finish<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      a.ws, nsplit, m, cout_pad, a.epi);
  return (int)cudaGetLastError();
}

// int8_dwconv. x (N, H, W, C) int8 codes or float32 / bf16 quantized on load
// at *x_scale (in_kind as int8_conv's); w9 (9, C) int8 taps; rescale, bias
// (C,); out (N, Ho, Wo, C) of out_kind or null; outq int8 at *q_scale or null.
extern "C" int int8_dwconv(const void* x, const void* x_scale, const void* w9,
                           const void* rescale, const void* bias, void* out, void* outq,
                           const void* q_scale, int in_kind, int out_kind, int act, int n, int h,
                           int w, int c, int ho, int wo, int stride, void* stream) {
  if (n <= 0 || c <= 0 || ho <= 0 || wo <= 0 || (out_kind == OUT_I32 && outq != nullptr) ||
      (outq != nullptr && q_scale == nullptr) || (in_kind != IN_I8 && x_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  DwArgs a{};
  a.x = x;
  a.x_scale = static_cast<const float*>(x_scale);
  a.w9 = static_cast<const int8_t*>(w9);
  a.in_kind = in_kind;
  a.n = n;
  a.h = h;
  a.w = w;
  a.c = c;
  a.ho = ho;
  a.wo = wo;
  a.stride = stride;
  a.epi = Epi{static_cast<const float*>(rescale), static_cast<const float*>(bias), nullptr, out,
              static_cast<int8_t*>(outq), static_cast<const float*>(q_scale), out_kind, act, 0,
              c, true};
  auto s = static_cast<cudaStream_t>(stream);
  // the slab: 64 channels where C is a multiple of 64, else 32, else 16
  const int cs = c % 64 == 0 ? 64 : c % 32 == 0 ? 32 : 16;
  return (int)(cs == 64 ? launch_dw<64>(a, s) : cs == 32 ? launch_dw<32>(a, s)
                                                         : launch_dw<16>(a, s));
}
#endif  // INT8_CONV_ENTRY
