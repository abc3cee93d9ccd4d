// Lucas-Kanade alignment in one kernel: the search window, the two
// correlation surfaces and the Gauss-Newton loop.
//
// Redesigns, for Hopper, two Pallas kernels and the XLA convolution between
// them: the search-window copy of msckf_stereo_c_tpu/ops/patch_extract.py:
// _kernel_factory (K2), the depthwise correlation of
// msckf_stereo_c_tpu/ops/klt_corr.py:_corr_surfaces, and the LK loop of
// msckf_stereo_c_tpu/ops/klt_corr.py:_iter_kernel_factory (K1).
//
// Per feature n, with K = S - P + 1:
//   win     = img[b, oy:oy+S, ox:ox+S]     (origin and b clamped as K2 does)
//   Cx[y,x] = sum_{i,j} gx[n,i,j] * win[y+i, x+j]    (Cy likewise with gy)
//   then up to `iters` steps of K1's loop on (Cx, Cy): four bilinear taps per
//   surface at f clamped to [0, hi], delta = G^-1 (t - taps),
//   f <- clip(f + delta, 0, hi), freeze once |delta| < eps.
// sc (N, 8) = (gxx, gxy, gyy, tgx, tgy, f0x, f0y, conv0); gx, gy (N, P, P);
// out (N, 2); surf (N, 2, K, K) receives the surfaces when it is not null.
//
// Bound: bytes.  A lane that starts frozen needs nothing but sc and out; a
// lane that steps needs its two filters and, of the image, only the P x P
// footprints of the surface cells its steps touch (a few neighbouring
// cells, about (P+3)^2 pixels), not its whole S x S window.
// chip_smoke.py:footprint_sectors counts the distinct 32-byte sectors of
// those footprints on bench-scene features; PERF.md gives the bound it
// makes.  The operations the result needs are the steps (~42 flops each)
// and the surface cells they touch (2 * P^2 * 2 flops per cell): about
// 1.7 MFLOP at N=144, 0.03 us at 67 TFLOP/s.  Computing the whole surfaces,
// as this design does, is
// 2 * N * K^2 * P^2 * 2 = 57 MFLOP at N=144 (0.85 us), and the slowest
// lane's dependent 30-step chain is the floor in practice.
//
// Design: one block of 256 threads per feature.
//   * The S x S window goes from the image into shared memory by cp.async:
//     16-byte copies of the 4-aligned superset of each row when the row
//     pitch and the image base allow it (W = 752, 376, 188), 4-byte copies
//     otherwise (W = 94).  The filters come the same way (4-byte: a
//     feature's P*P floats are not 16-byte aligned), interleaved as
//     float2 (gx, gy).  Not TMA: one 35x35 tile per feature does not pay
//     for a tensor map encoded on the host each call, and level 3's
//     376-byte pitch is not 16-byte aligned.
//   * All threads compute both K x K surfaces into shared memory with f32
//     FFMA, each thread a run of kTx neighbouring cells of one row: a
//     window value loaded once serves both filters and kTx cells (a
//     sliding register window), a filter pair is one 8-byte broadcast
//     load.  Each cell sums its P*P taps in row-major order from zero, a
//     fixed order.  Not tensor cores: they would be TF32, and the tracker
//     runs in full f32.
//   * Under the bf16 precision names (template PASSES, the wrapper's
//     `passes`) the surface phase computes what the TPU's matrix unit
//     computed for the depthwise convolution under the front end's
//     precision scope: with one pass, each window value and tap is rounded
//     to bf16 (round to nearest even) in shared memory once it has arrived,
//     and the same FFMA loop runs; with three, hi = r(v) and lo = r(v - hi)
//     of both are kept in shared memory and each tap is three FFMAs, small
//     terms first (lo_g hi_w, hi_g lo_w, hi_g hi_w).  A product of two bf16
//     values is exact in f32, so only the order of the sums differs from
//     the plain version's.  PASSES = 0 is the f32 code above.  The LK loop
//     is f32 in every mode: the Pallas loop body has no product.
//   * The surfaces are stored interleaved as float2 (Cx, Cy), so each of a
//     step's four taps is one 8-byte shared load.
//   * One lane then runs K1's loop exactly as lk_corr_iterate.cu does (the
//     same clamps, sqrtf(dx^2 + dy^2) < eps, its own exit).  A lane frozen
//     from the start skips the window and the surfaces, unless `surf` asks
//     for them.
// Shared memory: S * pitch + 2 * P^2 floats and K^2 float2, 10.9 KB at
// S=35, P=15 (the window and the taps twice with three passes: 18.3 KB);
// the wrapper refuses an (S, P) above 48 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kTx = 3;  // neighbouring surface cells of one row per thread

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Row pitch of the window in shared memory: a multiple of 4 floats above
// S + 3, so that a 4-aligned superset of any row fits and the sliding
// register window of the last cell run stays inside its row.
__host__ __device__ inline int window_pitch(int S) { return ((S + 3) | 3) + 1; }

// r(v): v rounded to the nearest bf16 (ties to even) and back to f32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The passes' operands in place: n floats at x rounded to bf16 (one pass),
// or split into hi (at x) and lo (at lo) (three passes).
template <int PASSES>
__device__ __forceinline__ void split_passes(float* x, float* lo, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = x[i];
    const float h = bf16_round(v);
    x[i] = h;
    if constexpr (PASSES == 3) lo[i] = bf16_round(v - h);
  }
}

template <int PASSES>
__global__ void __launch_bounds__(kThreads)
lk_corr_align_kernel(const float* __restrict__ img, const int32_t* __restrict__ origins,
                     const int32_t* __restrict__ img_index, const float* __restrict__ gx,
                     const float* __restrict__ gy, const float* __restrict__ sc,
                     float* __restrict__ out, float* __restrict__ surf, int B, int H, int W,
                     long long img_stride, int S, int P, int iters, float eps, float hi,
                     int vec) {
  extern __shared__ float4 smem4[];
  const int n = blockIdx.x;
  const float* s = sc + 8 * (long long)n;
  if (s[7] > 0.5f && surf == nullptr) {  // frozen from the start
    if (threadIdx.x == 0) {
      out[2 * (long long)n] = s[5];
      out[2 * (long long)n + 1] = s[6];
    }
    return;
  }
  const int K = S - P + 1;
  const int PP = P * P;
  const int pitch = window_pitch(S);
  constexpr int kCopies = PASSES == 3 ? 2 : 1;  // hi and lo with three passes
  float* win = reinterpret_cast<float*>(smem4);
  float* win_lo = win + S * pitch;                                    // three passes
  float2* g2 = reinterpret_cast<float2*>(win + kCopies * S * pitch);  // (gx, gy) taps
  float2* g2_lo = g2 + PP;                                            // three passes
  float2* cs = g2 + kCopies * PP;                                     // (Cx, Cy) cells

  const int ox = min(max(origins[2 * n], 0), W - S);
  const int oy = min(max(origins[2 * n + 1], 0), H - S);
  const int b = img_index ? min(max(img_index[n], 0), B - 1) : 0;
  const float* src = img + (long long)b * img_stride + (long long)oy * W;
  int c0;  // column of the window's first pixel in its shared row
  if (vec) {
    const int a0 = ox & ~3;
    const int nv = ((ox + S + 3) >> 2) - (a0 >> 2);  // 16-byte chunks per row
    c0 = ox - a0;
    for (int i = threadIdx.x; i < S * nv; i += kThreads) {
      const int r = i / nv;
      const int v = i - r * nv;
      cp_async16(win + r * pitch + 4 * v, src + (long long)r * W + a0 + 4 * v);
    }
  } else {
    c0 = 0;
    for (int i = threadIdx.x; i < S * S; i += kThreads) {
      const int r = i / S;
      const int c = i - r * S;
      cp_async4(win + r * pitch + c, src + (long long)r * W + ox + c);
    }
  }
  const float* gxn = gx + (long long)n * PP;
  const float* gyn = gy + (long long)n * PP;
  for (int i = threadIdx.x; i < PP; i += kThreads) {
    cp_async4(&g2[i].x, gxn + i);
    cp_async4(&g2[i].y, gyn + i);
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (PASSES > 0) {
    split_passes<PASSES>(win, win_lo, S * pitch);
    split_passes<PASSES>(&g2[0].x, &g2_lo[0].x, 2 * PP);
    __syncthreads();
  }

  // Surfaces: thread t computes cells (y, x .. x+kTx-1) of both surfaces.
  const int groups = (K + kTx - 1) / kTx;
  for (int t = threadIdx.x; t < K * groups; t += kThreads) {
    const int y = t / groups;
    const int x = (t - y * groups) * kTx;
    float ax[kTx], ay[kTx];
#pragma unroll
    for (int k = 0; k < kTx; ++k) ax[k] = ay[k] = 0.0f;
    for (int i = 0; i < P; ++i) {
      const float* wr = win + (y + i) * pitch + c0 + x;
      const float* wlr = win_lo + (y + i) * pitch + c0 + x;
      const float2* gr = g2 + i * P;
      const float2* glr = g2_lo + i * P;
      float w[kTx], wl[kTx];
#pragma unroll
      for (int k = 1; k < kTx; ++k) {
        w[k] = wr[k - 1];
        if constexpr (PASSES == 3) wl[k] = wlr[k - 1];
      }
      for (int j = 0; j < P; ++j) {
#pragma unroll
        for (int k = 0; k + 1 < kTx; ++k) {
          w[k] = w[k + 1];
          if constexpr (PASSES == 3) wl[k] = wl[k + 1];
        }
        w[kTx - 1] = wr[j + kTx - 1];
        const float2 g = gr[j];
        if constexpr (PASSES == 3) {
          wl[kTx - 1] = wlr[j + kTx - 1];
          const float2 gl = glr[j];
#pragma unroll
          for (int k = 0; k < kTx; ++k) {
            ax[k] = fmaf(g.x, w[k], fmaf(g.x, wl[k], fmaf(gl.x, w[k], ax[k])));
            ay[k] = fmaf(g.y, w[k], fmaf(g.y, wl[k], fmaf(gl.y, w[k], ay[k])));
          }
        } else {
#pragma unroll
          for (int k = 0; k < kTx; ++k) {
            ax[k] = fmaf(g.x, w[k], ax[k]);
            ay[k] = fmaf(g.y, w[k], ay[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTx; ++k) {
      if (x + k < K) {
        const int cell = y * K + x + k;
        cs[cell] = make_float2(ax[k], ay[k]);
        if (surf) {
          surf[(2 * (long long)n) * K * K + cell] = ax[k];
          surf[(2 * (long long)n + 1) * K * K + cell] = ay[k];
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

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
    const float2 c00 = cs[i00], c01 = cs[i00 + 1], c10 = cs[i00 + K], c11 = cs[i00 + K + 1];
    const float sumx = w00 * c00.x + w01 * c01.x + w10 * c10.x + w11 * c11.x;
    const float sumy = w00 * c00.y + w01 * c01.y + w10 * c10.y + w11 * c11.y;
    const float bx = tgx - sumx;
    const float by = tgy - sumy;
    const float dx = (gyy * bx - gxy * by) * inv_det;
    const float dy = (-gxy * bx + gxx * by) * inv_det;
    fx = fminf(fmaxf(fx + dx, 0.0f), hi);
    fy = fminf(fmaxf(fy + dy, 0.0f), hi);
    conv = sqrtf(dx * dx + dy * dy) < eps;
  }
  out[2 * (long long)n] = fx;
  out[2 * (long long)n + 1] = fy;
}

extern "C" int lk_corr_align(const void* img, const void* origins, const void* img_index,
                             const void* gx, const void* gy, const void* sc, void* out,
                             void* surf, int n, int B, int H, int W, long long img_stride,
                             int S, int P, int iters, float eps, float hi, int vec,
                             int passes, void* stream) {
  if (passes != 0 && passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int K = S - P + 1;
    const size_t copies = passes == 3 ? 2 : 1;
    const size_t smem = copies * ((size_t)(S * window_pitch(S)) * sizeof(float) +
                                  (size_t)(P * P) * sizeof(float2)) +
                        (size_t)(K * K) * sizeof(float2);
    auto kernel = passes == 0   ? lk_corr_align_kernel<0>
                  : passes == 1 ? lk_corr_align_kernel<1>
                                : lk_corr_align_kernel<3>;
    kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)img, (const int32_t*)origins, (const int32_t*)img_index,
        (const float*)gx, (const float*)gy, (const float*)sc, (float*)out, (float*)surf, B, H,
        W, img_stride, S, P, iters, eps, hi, vec);
  }
  return (int)cudaGetLastError();
}
