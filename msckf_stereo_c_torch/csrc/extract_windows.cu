// Window extraction: out[n] = img[oy:oy+S, ox:ox+S] for N integer origins.
//
// Replaces the Pallas kernel msckf_stereo_c_tpu/ops/patch_extract.py:
// _kernel_factory (driven by _extract_batched / extract_patches_pallas).
//
// Bound: pure data movement, N*S*S*4 bytes read and as many written
// (about 1.6 MB at N=144, S=37: 0.5 us at 3.35 TB/s), so at the main
// path's sizes the launch itself is the floor.
//
// Design: one block per window, threads striding over the S*S window in
// row-major order so that neighbouring threads read neighbouring pixels of
// one image row (coalesced) and write a contiguous output.  The TPU
// kernel's aligned block loads, power-of-two roll extents and 64-feature
// chunk padding are not needed here.  The kernel clamps each origin into
// [0, W-S] x [0, H-S] itself: on the GPU an out-of-range origin would be a
// memory fault, where lax.dynamic_slice clamps.  An optional per-window
// image index selects one of B images (a flat feature axis that a batch of
// sequences can fold into); it is clamped into [0, B-1] for the same reason.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void extract_windows_kernel(const float* __restrict__ img,
                                       const int32_t* __restrict__ origins,
                                       const int32_t* __restrict__ img_index,
                                       float* __restrict__ out, int B, int H,
                                       int W, int S, long long img_stride) {
  const int n = blockIdx.x;
  const int ox = min(max(origins[2 * n], 0), W - S);
  const int oy = min(max(origins[2 * n + 1], 0), H - S);
  const int b = img_index ? min(max(img_index[n], 0), B - 1) : 0;
  const long long base = (long long)b * img_stride;
  const float* src = img + base + (long long)oy * W + ox;
  float* dst = out + (long long)n * S * S;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int r = i / S;
    const int c = i - r * S;
    dst[i] = src[(long long)r * W + c];
  }
}

extern "C" int extract_windows(const void* img, const void* origins,
                               const void* img_index, void* out, int n, int B,
                               int H, int W, int S, long long img_stride,
                               void* stream) {
  if (n > 0) {
    extract_windows_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const int32_t*)origins, (const int32_t*)img_index,
        (float*)out, B, H, W, S, img_stride);
  }
  return (int)cudaGetLastError();
}
