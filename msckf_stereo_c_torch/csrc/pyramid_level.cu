// One level of the tracker's image pyramid for every image of a stack, in
// one pass: the 5-tap binomial blur [1 4 6 4 1]/16 with REFLECT_101 borders,
// written at full resolution (the presmoothed level 0) and/or at every
// second row and column (OpenCV pyrDown, (n+1)/2 each way).
//
// Replaces no Pallas kernel: the JAX package's pyr_down and smooth5
// (msckf_stereo_c_tpu/ops/pyramid.py) are two dense banded GEMMs each,
// which the TPU's matrix unit takes whole.  Its plain version in the port,
// ops/pyramid.py:pyramid_level_reference, pads and filters each axis with
// shifted tensor ops: 18 elementwise and pad launches a blurred level, each
// a full pass over the stack (72 a presmoothed tracker pyramid of four
// levels, 54 without).
//
// Per image (in (H, W) row-major, H, W >= 3), as the plain chain computes
// it, every operation rounded on its own (__f*_rn, __d*_rn: nvcc contracts
// nothing into an FMA):
//   x = op(in), with op the bf16 passes' view of a float32 operand:
//       passes 0 x, passes 1 r(x), passes 3 r(x) + r(x - r(x)),
//       r the round to nearest even bf16 (float64 is left as it is);
//   v[r][c] = op(((((x[r-2] + 4 x[r-1]) + 6 x[r]) + 4 x[r+1]) + x[r+2]) * (1/16)),
//   out[r][c] = ((((v[r][c-2] + 4 v[r][c-1]) + 6 v[r][c]) + 4 v[r][c+1]) + v[r][c+2]) * (1/16),
//   rows and columns outside the image mirrored about the edge pixel
//   (-1 -> 1, n -> n-2).
// The vertical pass at even rows and the horizontal one at even columns read
// the same values in pyrDown as in the full blur, so the decimated level is
// the full one at even rows and columns, bit for bit: one read of level 0
// gives both the presmoothed level 0 and level 1.
//
// Bound: bytes.  Each input pixel is read once and each output pixel
// written once; 16 flops a blurred pixel against 8-12 bytes.  At
// the eval cell's B = 512, 752x480 float32, a presmoothed level 0 with
// level 1 reads 0.74 GB and writes 0.92 GB: 0.50 ms at 3.35 TB/s.
//
// Design: a block takes one image (blockIdx.z, looping past 65,535) and a
// kTileH x kTileW tile of the input; it loads the tile and a 2-pixel halo
// into shared memory once (borders mirrored, the bf16 view applied), runs
// the vertical pass over the tile's rows (its even rows alone when no
// full-resolution output is asked for) and every column of the halo into a
// second shared buffer, then the horizontal pass, and writes only the
// outputs.  Templated on float32 and float64.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kHaloW = kTileW + 4;
constexpr int kThreads = 256;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
};

// float32 -> bf16, round to nearest even -> float32, as torch's
// Tensor.to(torch.bfloat16) rounds (c10::BFloat16's round_to_nearest_even).
__device__ __forceinline__ float round_bf16(float x) {
  if (x != x) return __uint_as_float(0x7fc00000u);
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// The operand as ops/precision.py:operand gives it to the passes.
template <typename T>
__device__ __forceinline__ T operand(T x, int passes) {
  return x;
}

template <>
__device__ __forceinline__ float operand<float>(float x, int passes) {
  if (passes == 0) return x;
  const float hi = round_bf16(x);
  if (passes == 1) return hi;
  return __fadd_rn(hi, round_bf16(__fsub_rn(x, hi)));
}

template <typename T>
__device__ __forceinline__ T blur5(T t0, T t1, T t2, T t3, T t4) {
  using F = Rn<T>;
  T a = F::add(t0, F::mul(T(4), t1));
  a = F::add(a, F::mul(T(6), t2));
  a = F::add(a, F::mul(T(4), t3));
  a = F::add(a, t4);
  return F::mul(a, T(1.0 / 16.0));
}

// REFLECT_101 for i in [-2, n + 1] (n >= 3); indices further out, which
// feed no output, are clamped into the image.
__device__ __forceinline__ int mirror(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads) pyramid_level_kernel(
    const T* __restrict__ in, T* __restrict__ full, T* __restrict__ half, long long n_images, int H, int W,
    int passes) {
  constexpr int kVRows = kFull ? kTileH : kTileH / 2;
  __shared__ T s_in[kTileH + 4][kHaloW];
  __shared__ T s_v[kVRows][kHaloW];
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tid = threadIdx.x;
  for (long long n = blockIdx.z; n < n_images; n += gridDim.z) {
    const T* img = in + n * H * W;
    for (int i = tid; i < (kTileH + 4) * kHaloW; i += kThreads) {
      const int r = i / kHaloW, c = i - r * kHaloW;
      s_in[r][c] = operand(img[(long long)mirror(y0 + r - 2, H) * W + mirror(x0 + c - 2, W)], passes);
    }
    __syncthreads();
    for (int i = tid; i < kVRows * kHaloW; i += kThreads) {
      const int rr = i / kHaloW, c = i - rr * kHaloW;
      const int r = kFull ? rr : 2 * rr;
      s_v[rr][c] = operand(blur5(s_in[r][c], s_in[r + 1][c], s_in[r + 2][c], s_in[r + 3][c], s_in[r + 4][c]),
                           passes);
    }
    __syncthreads();
    if constexpr (kFull) {
      T* out = full + n * H * W;
      T* dec = half == nullptr ? nullptr : half + n * Ho * Wo;
      for (int i = tid; i < kTileH * kTileW; i += kThreads) {
        const int r = i / kTileW, c = i - r * kTileW;
        const int y = y0 + r, x = x0 + c;
        if (y >= H || x >= W) continue;
        const T h = blur5(s_v[r][c], s_v[r][c + 1], s_v[r][c + 2], s_v[r][c + 3], s_v[r][c + 4]);
        out[(long long)y * W + x] = h;
        if (dec != nullptr && !(r & 1) && !(c & 1)) dec[(long long)(y >> 1) * Wo + (x >> 1)] = h;
      }
    } else {
      T* dec = half + n * Ho * Wo;
      for (int i = tid; i < (kTileH / 2) * (kTileW / 2); i += kThreads) {
        const int rr = i / (kTileW / 2), cc = i - rr * (kTileW / 2);
        const int y = (y0 >> 1) + rr, x = (x0 >> 1) + cc;
        if (y >= Ho || x >= Wo) continue;
        const int c = 2 * cc;
        dec[(long long)y * Wo + x] =
            blur5(s_v[rr][c], s_v[rr][c + 1], s_v[rr][c + 2], s_v[rr][c + 3], s_v[rr][c + 4]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const void* in, void* full, void* half, long long n_images, int H, int W, int passes,
                  void* stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH,
                  (unsigned)(n_images < 65535 ? n_images : 65535));
  if (full != nullptr)
    pyramid_level_kernel<T, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)in, (T*)full, (T*)half, n_images, H, W, passes);
  else
    pyramid_level_kernel<T, false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)in, (T*)full, (T*)half, n_images, H, W, passes);
  return (int)cudaGetLastError();
}

// in (n_images, H, W), full (n_images, H, W) or null, half (n_images,
// (H+1)/2, (W+1)/2) or null, not both null; all contiguous, on one device,
// float32 (is_double 0) or float64 (1); H, W >= 3; passes 0, 1 or 3 (read
// for float32 only).  Launches nothing for n_images <= 0.  Returns the
// cudaError_t of the launch.
extern "C" int pyramid_level(const void* in, void* full, void* half, long long n_images, int H, int W,
                             int passes, int is_double, void* stream) {
  if (n_images <= 0) return (int)cudaSuccess;
  if ((full == nullptr && half == nullptr) || H < 3 || W < 3 || (passes != 0 && passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  return is_double ? launch<double>(in, full, half, n_images, H, W, passes, stream)
                   : launch<float>(in, full, half, n_images, H, W, passes, stream);
}
