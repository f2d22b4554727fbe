// Batched per-sample patch extraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel extract_patches_flat
// (adafocus_tpu/ops/patch.py, _make_patch_kernel): out[n] =
// frames[n, y:y+P, x:x+P, :] over unpadded (N, H, W, C) frames, with the
// (y, x) start of each sample read from an (N, 2) int32 tensor and handled
// as lax.dynamic_slice handles it: a negative start counts from the end
// (start + dim), then it is clamped to [0, H-P] x [0, W-P].
//
// Bound: bytes. The kernel does no arithmetic; the least it can take is the
// patch bytes read once plus the output written once over the card's
// memory rate (N=1024, P=96, C=3, bf16: 2 x 56.6 MB, about 34 us on an
// H100 SXM at 3.35 TB/s).
//
// Design: one block per patch, N on gridDim.x (up to 2^31 - 1). Each patch
// row is one contiguous run of P*C elements inside a W*C frame row, so
// threadIdx.y strides over the P rows and threadIdx.x over the run, with
// neighbouring threads on neighbouring addresses. The copy is bitwise and
// templated on the element size (1, 2 or 4 bytes), which covers bf16, f16,
// f32, int8 and uint8. None of the TPU kernel's Mosaic workarounds (lane
// padding, 8-row bands, the lane roll) is needed: any H, W, P and C work.
// Vector loads and TMA are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void patch_extract_kernel(const T* __restrict__ frames,
                                     const int* __restrict__ offsets,
                                     T* __restrict__ out, int h, int w, int c,
                                     int p) {
  const long long n = blockIdx.x;
  int y = offsets[2 * n];
  int x = offsets[2 * n + 1];
  if (y < 0) y += h;
  if (x < 0) x += w;
  y = min(max(y, 0), h - p);
  x = min(max(x, 0), w - p);

  const long long frame_row = (long long)w * c;
  const int run = p * c;
  const T* src = frames + (n * h + y) * frame_row + (long long)x * c;
  T* dst = out + n * p * (long long)run;
  for (int r = threadIdx.y; r < p; r += blockDim.y) {
    const T* s = src + r * frame_row;
    T* d = dst + (long long)r * run;
    for (int e = threadIdx.x; e < run; e += blockDim.x) d[e] = s[e];
  }
}

template <typename T>
cudaError_t launch(const void* frames, const void* offsets, void* out,
                   long long n, int h, int w, int c, int p,
                   cudaStream_t stream) {
  const dim3 block(64, 8);
  patch_extract_kernel<T><<<(unsigned int)n, block, 0, stream>>>(
      static_cast<const T*>(frames), static_cast<const int*>(offsets),
      static_cast<T*>(out), h, w, c, p);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). elem_size is the
// frames' element size in bytes: 1, 2 or 4.
extern "C" int patch_extract(const void* frames, const void* offsets,
                             void* out, long long n, int h, int w, int c,
                             int p, int elem_size, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n > 2147483647LL || p < 1 || p > h || p > w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: return (int)launch<uint8_t>(frames, offsets, out, n, h, w, c, p, s);
    case 2: return (int)launch<uint16_t>(frames, offsets, out, n, h, w, c, p, s);
    case 4: return (int)launch<uint32_t>(frames, offsets, out, n, h, w, c, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
