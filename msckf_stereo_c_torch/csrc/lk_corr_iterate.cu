// Lucas-Kanade iteration loop on precomputed correlation surfaces.
//
// Replaces the Pallas kernel msckf_stereo_c_tpu/ops/klt_corr.py:
// _iter_kernel_factory (driven by _iterate_fn / _iterate_pallas /
// _run_iterations).
//
// Per feature, up to `iters` Gauss-Newton steps:
//   tent weights at f clamped to [0, hi];  b = t - sum w*C  (x and y);
//   delta = G^-1 b;  f <- clip(f + delta, 0, hi);  freeze once |delta| < eps.
// sc (N, 8) = (gxx, gxy, gyy, tgx, tgy, f0x, f0y, conv0); Cx, Cy (N, K, K)
// with a feature stride `fstride` (they may be views into one (N, 2, K, K)
// convolution output); out (N, 2).
//
// Bound: the bytes the steps touch.  Each step reads the 2x2 cells around
// the iterate of Cx and Cy, and a lane that starts frozen reads nothing of
// them; chip_smoke.py replays the steps and counts the distinct 32-byte
// sectors.  On bench-scene features at N=144, K=21 that is 67968 B (sc,
// out and the touched sectors), 0.0000203 ms at 3.35 TB/s, against
// 508032 B of whole surfaces.  ~40 flops a step are negligible beside it,
// so the floor is launch latency.
//
// Design: one warp per feature, four features per block.  The warp copies
// its feature's two surfaces (3.5 KB) into shared memory with coalesced
// loads; one lane then runs the loop.  The TPU kernel summed w*C over all
// K*K cells every step because a gather is costly there; the tent weight
// is non-zero only on the 2x2 cells around (fy, fx), so each step reads
// four taps per surface.  With hi = K-2 the tap at floor+1 is always in
// range, and fminf/fmaxf send NaN to the bounds, so no read leaves the
// surface.  Each feature exits on its own: lanes are independent and a
// frozen lane never moves, which gives the Pallas batch-wide exit's result.
// The TPU lane padding (K*K to 128, padded rows with conv0 = 1) and the
// 512-feature VMEM chunking are gone.
#include <cuda_runtime.h>

constexpr int kWarps = 4;

__global__ void lk_corr_iterate_kernel(const float* __restrict__ sc,
                                       const float* __restrict__ cx,
                                       const float* __restrict__ cy,
                                       float* __restrict__ out,
                                       long long fstride, int n, int K,
                                       int iters, float eps, float hi) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= n) return;  // uniform per warp
  const int KK = K * K;
  float* sx = smem + warp * 2 * KK;
  float* sy = sx + KK;
  const float* gx = cx + (long long)f * fstride;
  const float* gy = cy + (long long)f * fstride;
  for (int i = lane; i < KK; i += 32) {
    sx[i] = gx[i];
    sy[i] = gy[i];
  }
  __syncwarp();
  if (lane != 0) return;

  const float* s = sc + 8 * (long long)f;
  const float gxx = s[0], gxy = s[1], gyy = s[2], tgx = s[3], tgy = s[4];
  float fx = s[5], fy = s[6];
  bool conv = s[7] > 0.5f;
  const float det = gxx * gyy - gxy * gxy;
  const float inv_det = 1.0f / (fabsf(det) > 1e-30f ? det : 1e-30f);

  for (int it = 0; it < iters && !conv; ++it) {
    const float fxs = fminf(fmaxf(fx, 0.0f), hi);
    const float fys = fminf(fmaxf(fy, 0.0f), hi);
    const int x0 = (int)floorf(fxs);
    const int y0 = (int)floorf(fys);
    const float ax = fxs - (float)x0;
    const float ay = fys - (float)y0;
    const float w00 = (1.0f - ay) * (1.0f - ax);
    const float w01 = (1.0f - ay) * ax;
    const float w10 = ay * (1.0f - ax);
    const float w11 = ay * ax;
    const int i00 = y0 * K + x0;
    const float sumx = w00 * sx[i00] + w01 * sx[i00 + 1] + w10 * sx[i00 + K] +
                       w11 * sx[i00 + K + 1];
    const float sumy = w00 * sy[i00] + w01 * sy[i00 + 1] + w10 * sy[i00 + K] +
                       w11 * sy[i00 + K + 1];
    const float bx = tgx - sumx;
    const float by = tgy - sumy;
    const float dx = (gyy * bx - gxy * by) * inv_det;
    const float dy = (-gxy * bx + gxx * by) * inv_det;
    fx = fminf(fmaxf(fx + dx, 0.0f), hi);
    fy = fminf(fmaxf(fy + dy, 0.0f), hi);
    conv = sqrtf(dx * dx + dy * dy) < eps;
  }
  out[2 * (long long)f] = fx;
  out[2 * (long long)f + 1] = fy;
}

extern "C" int lk_corr_iterate(const void* sc, const void* cx, const void* cy,
                               void* out, long long fstride, int n, int K,
                               int iters, float eps, float hi, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    const size_t smem = (size_t)kWarps * 2 * K * K * sizeof(float);
    lk_corr_iterate_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const float*)sc, (const float*)cx, (const float*)cy, (float*)out,
        fstride, n, K, iters, eps, hi);
  }
  return (int)cudaGetLastError();
}
