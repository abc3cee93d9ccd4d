// Affine-photometric Lucas-Kanade iteration loop on precomputed
// correlation surfaces.
//
// Replaces the Pallas kernel msckf_stereo_c_tpu/ops/klt_corr.py:
// _iter_kernel_factory_gain (driven by _iterate_fn_gain / _iterate_pallas /
// _run_iterations with a third surface Ct).
//
// Per feature, up to `iters` Gauss-Newton steps:
//   tent weights at f clamped to [0, hi];
//   bx = tgx - sum w*Cx,  by = tgy - sum w*Cy,  bt = st2 - sum w*Ct;
//   delta = B (bx, by, bt), B the 2x3 displacement rows of the bordered
//   (translation + gain or offset) normal-matrix inverse;
//   f <- clip(f + delta, 0, hi);  freeze once |delta| < eps.
// sc (N, 12) = (B00, B01, B02, B10, B11, B12, tgx, tgy, st2, f0x, f0y,
// conv0); Cx, Cy, Ct (N, K, K) with one feature stride `fstride` (views
// into one (N, 3, K, K) convolution output); out (N, 2).  The same kernel
// serves klt_norm 'offset' (Ct the box-sum surface, st2 = sum T) and
// 'gain' (Ct the zero-mean-template surface, st2 = sum (T - mean T)^2).
//
// Bound: the bytes the steps touch.  Each step reads the 2x2 cells around
// the iterate of three surfaces (the same cells of each); a lane that starts
// frozen reads none.  chip_smoke.py replays the steps (k_trace) and counts
// the distinct 32-byte sectors: at N = 144 and K = 21 that is tens of KB,
// a bound of a few hundredths of a microsecond at 3.35 TB/s, far below
// the launch latency.  The ~50 flops a step are negligible beside it.
//
// Design: K1's (csrc/lk_corr_iterate.cu), with a third surface.  One warp
// per feature, four features per block; the warp copies its feature's three
// surfaces (5.3 KB) into shared memory with coalesced loads, then one lane
// runs the loop.  The tent weight is non-zero only on the 2x2 cells around
// (fy, fx), so each step reads four taps per surface; with hi = K-2 the
// tap at floor+1 is in range, and fminf/fmaxf send NaN to the bounds, so no
// read leaves the surface.  Each feature exits on its own: lanes are
// independent and a frozen lane never moves, which gives the Pallas
// batch-wide exit's result.  The TPU's lane padding (K*K to 128, sc to 16
// columns, padded rows with conv0 = 1) and its 512-feature VMEM chunks
// are gone.
#include <cuda_runtime.h>

constexpr int kWarps = 4;

__global__ void lk_corr_iterate_gain_kernel(const float* __restrict__ sc,
                                            const float* __restrict__ cx,
                                            const float* __restrict__ cy,
                                            const float* __restrict__ ct,
                                            float* __restrict__ out,
                                            long long fstride, int n, int K,
                                            int iters, float eps, float hi) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= n) return;  // uniform per warp
  const int KK = K * K;
  float* sx = smem + warp * 3 * KK;
  float* sy = sx + KK;
  float* st = sy + KK;
  const float* gx = cx + (long long)f * fstride;
  const float* gy = cy + (long long)f * fstride;
  const float* gt = ct + (long long)f * fstride;
  for (int i = lane; i < KK; i += 32) {
    sx[i] = gx[i];
    sy[i] = gy[i];
    st[i] = gt[i];
  }
  __syncwarp();
  if (lane != 0) return;

  const float* s = sc + 12 * (long long)f;
  const float B00 = s[0], B01 = s[1], B02 = s[2];
  const float B10 = s[3], B11 = s[4], B12 = s[5];
  const float tgx = s[6], tgy = s[7], st2 = s[8];
  float fx = s[9], fy = s[10];
  bool conv = s[11] > 0.5f;

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
    const float sumt = w00 * st[i00] + w01 * st[i00 + 1] + w10 * st[i00 + K] +
                       w11 * st[i00 + K + 1];
    const float bx = tgx - sumx;
    const float by = tgy - sumy;
    const float bt = st2 - sumt;
    const float dx = B00 * bx + B01 * by + B02 * bt;
    const float dy = B10 * bx + B11 * by + B12 * bt;
    fx = fminf(fmaxf(fx + dx, 0.0f), hi);
    fy = fminf(fmaxf(fy + dy, 0.0f), hi);
    conv = sqrtf(dx * dx + dy * dy) < eps;
  }
  out[2 * (long long)f] = fx;
  out[2 * (long long)f + 1] = fy;
}

extern "C" int lk_corr_iterate_gain(const void* sc, const void* cx,
                                    const void* cy, const void* ct, void* out,
                                    long long fstride, int n, int K, int iters,
                                    float eps, float hi, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    const size_t smem = (size_t)kWarps * 3 * K * K * sizeof(float);
    lk_corr_iterate_gain_kernel<<<blocks, kWarps * 32, smem,
                                  (cudaStream_t)stream>>>(
        (const float*)sc, (const float*)cx, (const float*)cy, (const float*)ct,
        (float*)out, fstride, n, K, iters, eps, hi);
  }
  return (int)cudaGetLastError();
}
