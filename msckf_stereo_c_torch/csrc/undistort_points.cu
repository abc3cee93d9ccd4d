// The camera model's undistortion of pixel points, in one pass.
//
// Replaces no Pallas kernel: the JAX package's undistort_points
// (msckf_stereo_c_tpu/ops/camera.py) is a chain of jnp ops that XLA fused.
// Its plain version in the port, ops/camera.py:undistort_points_reference,
// runs the 20 fixed-point iterations as separate tensor ops: about 563
// launches a call on the card (567 with R), seven calls a tracker frame,
// over half of the frame's launches.
//
// Per point (any leading shape, flattened; points (n, 2) [x y] pixels,
// intrinsics [fx fy cx cy], dist (4,), R (3, 3) row-major or null,
// new_intrinsics (4,) or null):
//   x = (px - cx) / fx, y = (py - cy) / fy;
//   radtan (model 0), ``iters`` times from (xd, yd) = (x, y):
//     r2 = x*x + y*y, radial = (1 + k1*r2) + (k2*r2)*r2,
//     dx = ((2*p1)*x)*y + p2*(r2 + (2*x)*x), dy = p1*(r2 + (2*y)*y) + ((2*p2)*x)*y,
//     x = (xd - dx) / radial, y = (yd - dy) / radial;
//   equidistant (model 1): theta_d = sqrt(max(xd*xd + yd*yd, 1e-16)),
//     ``iters`` times theta = theta_d / (1 + t2*(k1 + t2*(k2 + t2*(k3 + t2*k4)))),
//     t2 = theta*theta, then (x, y) = (xd, yd) * (tan(theta) / theta_d);
//   with R: the ray R [x y 1], divided by its z;
//   with new_intrinsics: (x*fx' + cx', y*fy' + cy').
// Every operation is the plain chain's, in its order, each rounded on its
// own (__f*_rn, __d*_rn: nvcc contracts nothing into an FMA), so the radtan
// path without R gives the chain's bits.  The R product is the chain's
// K=3 GEMM, written as FMAs in k order; tan is the libdevice tanf / tan that
// torch.tan calls; sqrt and the clamp are IEEE and keep a NaN, as torch's.
//
// Bound: latency.  16 bytes (float32) and about 570 floating-point
// operations a point: at the eval cell's 73,728 points (B = 512, 96 + 48 a
// lane) 1.2 MB and 42 MFLOP, about 0.6 us at 67 TFLOP/s.  Each point is a
// chain of 20 dependent iterations with two divisions each.
//
// Design: one launch, one thread a point, every iteration in registers; the
// parameters are read from device memory (no host read), templated on
// float32 and float64.
#include <cuda_runtime.h>
#include <math.h>

constexpr int kThreads = 128;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float tan(float a) { return tanf(a); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double tan(double a) { return ::tan(a); }
};

template <typename T>
__device__ __forceinline__ void radtan(const T* D, int iters, T& x, T& y) {
  using F = Rn<T>;
  const T k1 = D[0], k2 = D[1], p1 = D[2], p2 = D[3];
  const T two_p1 = F::mul(T(2), p1), two_p2 = F::mul(T(2), p2);
  const T xd = x, yd = y;
  for (int i = 0; i < iters; ++i) {
    const T r2 = F::add(F::mul(x, x), F::mul(y, y));
    const T radial = F::add(F::add(T(1), F::mul(k1, r2)), F::mul(F::mul(k2, r2), r2));
    const T dx = F::add(F::mul(F::mul(two_p1, x), y), F::mul(p2, F::add(r2, F::mul(F::mul(T(2), x), x))));
    const T dy = F::add(F::mul(p1, F::add(r2, F::mul(F::mul(T(2), y), y))), F::mul(F::mul(two_p2, x), y));
    x = F::div(F::sub(xd, dx), radial);
    y = F::div(F::sub(yd, dy), radial);
  }
}

template <typename T>
__device__ __forceinline__ void equidistant(const T* D, int iters, T& x, T& y) {
  using F = Rn<T>;
  const T k1 = D[0], k2 = D[1], k3 = D[2], k4 = D[3];
  T s = F::add(F::mul(x, x), F::mul(y, y));
  s = s < T(1e-16) ? T(1e-16) : s;  // torch.clamp(min=1e-16): a NaN stays NaN
  const T theta_d = F::sqrt(s);
  T theta = theta_d;
  for (int i = 0; i < iters; ++i) {
    const T t2 = F::mul(theta, theta);
    T p = F::add(k3, F::mul(t2, k4));
    p = F::add(k2, F::mul(t2, p));
    p = F::add(k1, F::mul(t2, p));
    theta = F::div(theta_d, F::add(T(1), F::mul(t2, p)));
  }
  const T scale = F::div(F::tan(theta), theta_d);
  x = F::mul(x, scale);
  y = F::mul(y, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) undistort_points_kernel(
    const T* __restrict__ pts, const T* __restrict__ K, const T* __restrict__ D, const T* __restrict__ R,
    const T* __restrict__ Knew, T* __restrict__ out, long long n, int model, int iters) {
  using F = Rn<T>;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  T x = F::div(F::sub(pts[2 * i], K[2]), K[0]);
  T y = F::div(F::sub(pts[2 * i + 1], K[3]), K[1]);
  if (model == 1)
    equidistant(D, iters, x, y);
  else
    radtan(D, iters, x, y);
  if (R != nullptr) {
    T ray[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) ray[r] = F::fma(R[3 * r + 2], T(1), F::fma(R[3 * r + 1], y, F::mul(R[3 * r], x)));
    x = F::div(ray[0], ray[2]);
    y = F::div(ray[1], ray[2]);
  }
  if (Knew != nullptr) {
    x = F::add(F::mul(x, Knew[0]), Knew[2]);
    y = F::add(F::mul(y, Knew[1]), Knew[3]);
  }
  out[2 * i] = x;
  out[2 * i + 1] = y;
}

template <typename T>
static int launch(const void* pts, const void* K, const void* D, const void* R, const void* Knew, void* out,
                  long long n, int model, int iters, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  undistort_points_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)pts, (const T*)K, (const T*)D, (const T*)R, (const T*)Knew, (T*)out, n, model, iters);
  return (int)cudaGetLastError();
}

// pts and out (n, 2), intrinsics and dist (4,), R (3, 3) or null,
// new_intrinsics (4,) or null; all contiguous, on one device, float32
// (is_double 0) or float64 (1); model 0 radtan, 1 equidistant.  Launches
// nothing for n <= 0.  Returns the cudaError_t of the launch.
extern "C" int undistort_points(const void* pts, const void* intrinsics, const void* dist, const void* R,
                                const void* new_intrinsics, void* out, long long n, int model, int iters,
                                int is_double, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return is_double ? launch<double>(pts, intrinsics, dist, R, new_intrinsics, out, n, model, iters, stream)
                   : launch<float>(pts, intrinsics, dist, R, new_intrinsics, out, n, model, iters, stream);
}
