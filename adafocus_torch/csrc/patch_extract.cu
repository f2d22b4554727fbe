// Batched per-sample patch extraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel extract_patches_flat
// (adafocus_tpu/ops/patch.py:164, its pallas_call at :203): out[n] =
// frames[n, y:y+P, x:x+P, :] over unpadded (N, H, W, C) frames. Each
// sample's (y, x) start comes from an (N, 2) int32 tensor, or from (B, T, 2)
// float32 actions in [0, 1] as floor(a * span) clamped to [0, span] (the
// computation of ops/patch.py patch_offsets, fused here). The start is then
// handled as lax.dynamic_slice handles it: a negative start counts from the
// end (start + dim), then it is clamped to [0, H-P] x [0, W-P].
//
// Bound: bytes. The kernel does no arithmetic; the least it can take is the
// patch bytes read once plus the output written once over the card's memory
// rate (N=1024, P=96, C=3, bf16: 2 x 56.6 MB, about 34 us on an H100 SXM at
// 3.35 TB/s).
//
// The work is cut into items, one band of R rows of one patch each,
// N * ceil(P / R) in all; R is small enough that a batch of 16 patches still
// gives every block of the grid an item, and large enough that a big batch
// moves about 14 KB an item. The host plan (ops/patch.py plan_patch_extract)
// picks R and the grid. 256 threads a block, each block striding over the
// items. Each thread stores one aligned 16-byte word of an output row, built
// by a funnel shift from the two aligned 16-byte source words that span it
// (the second is mostly an L1 hit, being the next thread's first); the bytes
// before the first and after the last aligned output word of a row go
// element by element. Any shape and any base address takes this path.
//
// A TMA variant (a producer warp keeping band loads in flight into a
// shared-memory ring) was slower at every shape timed on an H100 (PERF.md):
// a TMA load must start 16-byte aligned, so it too realigns each row, and
// adds a shared-memory round trip to it.
//
// The copy is bitwise, for 1-, 2- and 4-byte elements (bf16, f16, f32, int8,
// uint8, int32, ...): it is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The frames, the output and the work split, as the host plan gave them.
struct Geom {
  long long items;  // N * bands
  int h, w, c, p;
  int rows, bands;  // R rows a band, ceil(P / R) bands a patch
  // starts from (B, T, 2) actions with element strides sb, st, sk (patch n
  // is (n / t, n % t)): floor(a * span) clamped to [0, span]
  int span, t;
  long long sb, st, sk;
};

__device__ __forceinline__ int wrap_clamp(int v, int dim, int p) {
  if (v < 0) v += dim;
  return min(max(v, 0), dim - p);
}

__device__ __forceinline__ int from_action(float a, int span) {
  const int v = (int)floorf(__fmul_rn(a, (float)span));
  return min(max(v, 0), span);
}

// (y, x) start of patch q
__device__ __forceinline__ void start_of(const int* offsets, const float* actions,
                                         const Geom& g, long long q, int& y, int& x) {
  if (actions != nullptr) {
    const long long b = q / g.t;
    const float* a = actions + b * g.sb + (q - b * g.t) * g.st;
    y = from_action(a[0], g.span);
    x = from_action(a[g.sk], g.span);
  } else {
    y = offsets[2 * q];
    x = offsets[2 * q + 1];
  }
  y = wrap_clamp(y, g.h, g.p);
  x = wrap_clamp(x, g.w, g.p);
}

// the 16 bytes at byte a (0..15) of the 32 bytes lo:hi
__device__ __forceinline__ uint4 realign(const uint4& lo, const uint4& hi, int a) {
  uint32_t v0, v1, v2, v3, v4;
  switch (a >> 2) {
    case 0: v0 = lo.x; v1 = lo.y; v2 = lo.z; v3 = lo.w; v4 = hi.x; break;
    case 1: v0 = lo.y; v1 = lo.z; v2 = lo.w; v3 = hi.x; v4 = hi.y; break;
    case 2: v0 = lo.z; v1 = lo.w; v2 = hi.x; v3 = hi.y; v4 = hi.z; break;
    default: v0 = lo.w; v1 = hi.x; v2 = hi.y; v3 = hi.z; v4 = hi.w; break;
  }
  const int s = (a & 3) * 8;
  return make_uint4(__funnelshift_r(v0, v1, s), __funnelshift_r(v1, v2, s),
                    __funnelshift_r(v2, v3, s), __funnelshift_r(v3, v4, s));
}

template <typename T>
__device__ __forceinline__ void copy_elems(unsigned char* dst, const unsigned char* src, int from,
                                           int to) {
  for (int b = from; b < to; b += (int)sizeof(T))
    *reinterpret_cast<T*>(dst + b) = *reinterpret_cast<const T*>(src + b);
}

template <typename T>
__global__ void __launch_bounds__(256) patch_kernel(const T* __restrict__ frames,
                                                    const int* __restrict__ offsets,
                                                    const float* __restrict__ actions,
                                                    T* __restrict__ out, const Geom g) {
  const int row_bytes = g.p * g.c * (int)sizeof(T);
  // units of a row: 0 = its head and tail elements, then its aligned words
  const int units = row_bytes / 16 + 2;
  for (long long item = blockIdx.x; item < g.items; item += gridDim.x) {
    const long long n = item / g.bands;
    const int r0 = (int)(item - n * g.bands) * g.rows;
    const int rows = min(g.rows, g.p - r0);
    int y, x;
    start_of(offsets, actions, g, n, y, x);
    for (int idx = threadIdx.x; idx < rows * units; idx += blockDim.x) {
      const int r = r0 + idx / units, u = idx % units;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          frames + ((n * g.h + y + r) * g.w + x) * (long long)g.c);
      unsigned char* dst =
          reinterpret_cast<unsigned char*>(out + (n * g.p + r) * (long long)g.p * g.c);
      const int head = min((int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15), row_bytes);
      const int words = (row_bytes - head) / 16;
      if (u == 0) {
        copy_elems<T>(dst, src, 0, head);
        copy_elems<T>(dst, src, head + 16 * words, row_bytes);
      } else if (u <= words) {
        const int at = head + 16 * (u - 1);
        const int a = (int)(reinterpret_cast<uintptr_t>(src + at) & 15);
        const uint4* word = reinterpret_cast<const uint4*>(src + at - a);
        const uint4 lo = __ldg(word);
        *reinterpret_cast<uint4*>(dst + at) = a ? realign(lo, __ldg(word + 1), a) : lo;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* frames, const int* offsets, const float* actions, void* out,
                   const Geom& g, int grid, cudaStream_t stream) {
  patch_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(frames), offsets, actions,
                                            static_cast<T*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Exactly one of
// offsets ((N, 2) int32, contiguous) and actions ((B, T, 2) float32 with
// element strides sb, st, sk, N = B * T, with span) is given. elem_size is
// the frames' element size in bytes: 1, 2 or 4. rows and grid are the host
// plan's (ops/patch.py PatchPlan).
extern "C" int patch_extract(const void* frames, const void* offsets, const void* actions,
                             void* out, long long n, int h, int w, int c, int p, int elem_size,
                             int span, int t, long long sb, long long st, long long sk,
                             int rows, int grid, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n > 2147483647LL || p < 1 || p > h || p > w || c < 1 || rows < 1 || rows > p ||
      grid < 1 || (offsets == nullptr) == (actions == nullptr) ||
      (actions != nullptr && (t < 1 || n % t != 0)))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.p = p;
  g.rows = rows;
  g.bands = (p + rows - 1) / rows;
  g.items = n * g.bands;
  g.span = span;
  g.t = t;
  g.sb = sb;
  g.st = st;
  g.sk = sk;
  const int* offs = static_cast<const int*>(offsets);
  const float* acts = static_cast<const float*>(actions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size != 1 && elem_size != 2 && elem_size != 4) return (int)cudaErrorInvalidValue;
  switch (elem_size) {
    case 1: return (int)launch<uint8_t>(frames, offs, acts, out, g, grid, s);
    case 2: return (int)launch<uint16_t>(frames, offs, acts, out, g, grid, s);
    default: return (int)launch<uint32_t>(frames, offs, acts, out, g, grid, s);
  }
}
