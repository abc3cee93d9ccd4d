// Affine-photometric Lucas-Kanade alignment in one kernel: the search
// window, the three correlation surfaces and the bordered Gauss-Newton loop.
//
// Redesigns, for Hopper, two Pallas kernels and the XLA convolution between
// them: the search-window copy of msckf_stereo_c_tpu/ops/patch_extract.py:
// _kernel_factory (K2), the depthwise correlation of
// msckf_stereo_c_tpu/ops/klt_corr.py:_corr_surfaces with a third filter,
// and the photometric LK loop of
// msckf_stereo_c_tpu/ops/klt_corr.py:_iter_kernel_factory_gain (K3).
//
// Per feature n, with K = S - P + 1:
//   win     = img[b, oy:oy+S, ox:ox+S]     (origin and b clamped as K2 does)
//   Cx[y,x] = sum_{i,j} gx[n,i,j] * win[y+i, x+j]   (Cy with gy, Ct with gt)
//   then up to `iters` steps of K3's loop on (Cx, Cy, Ct): four bilinear taps
//   per surface at f clamped to [0, hi], (bx, by, bt) = (tgx, tgy, st2) -
//   taps, delta = Binv (bx, by, bt), f <- clip(f + delta, 0, hi), freeze
//   once |delta| < eps.
// sc (N, 12) = (B00, B01, B02, B10, B11, B12, tgx, tgy, st2, f0x, f0y,
// conv0); gx, gy, gt (N, P, P); out (N, 2); surf (N, 3, K, K) receives the
// surfaces when it is not null.  klt_norm 'offset' passes gt = ones (Ct the
// box sum), 'gain' the zero-mean template (Ct its correlation).
//
// Bound: bytes.  A lane that starts frozen needs nothing but sc and out; a
// lane that steps needs its three filters and, of the image, only the P x P
// footprints of the surface cells its steps touch, not its whole S x S
// window (chip_smoke.py:footprint_sectors counts their 32-byte sectors on
// stress-scene features; PERF.md gives the bound it makes).  The
// operations the result needs are the steps (~55 flops each) and the
// touched cells (3 * P^2 * 2 flops per cell).  Computing the whole
// surfaces, as this design does, is 3 * N * K^2 * P^2 * 2 = 85.7 MFLOP at
// N=144, K=21, P=15 (1.28 us at 67 TFLOP/s), and the slowest lane's
// dependent 30-step chain is the floor in practice.
//
// Design: lk_corr_align.cu's, with a third surface.  One block of 256
// threads per feature.
//   * The S x S window goes from the image into shared memory by cp.async:
//     16-byte copies of the 4-aligned superset of each row when the row
//     pitch and the image base allow it (W = 752, 376, 188), 4-byte copies
//     otherwise (W = 94).  The filters come the same way (4-byte: a
//     feature's P*P floats are not 16-byte aligned), interleaved as float4
//     (gx, gy, gt, unused), so one 16-byte broadcast load serves a tap of
//     all three filters.
//   * All threads compute the three K x K surfaces into shared memory with
//     f32 FFMA, each thread a run of kTx neighbouring cells of one row: a
//     window value loaded once serves three filters and kTx cells.  Each
//     cell sums its P*P taps in row-major order from zero, the order in
//     which cuDNN's depthwise kernel sums them.  Not tensor cores: they
//     would be TF32, and the tracker runs in full f32.
//   * The bf16 precision names (template PASSES) as in lk_corr_align.cu:
//     window values and taps rounded to bf16 in shared memory (one pass),
//     or kept as hi and lo with three FFMAs a tap, small terms first
//     (three passes).  The loop is f32 in every mode.
//   * The surfaces are stored interleaved as float4 (Cx, Cy, Ct, unused),
//     so each of a step's four taps is one 16-byte shared load.
//   * One lane then runs K3's loop exactly as lk_corr_iterate_gain.cu does
//     (the same clamps, delta = Binv (bx, by, bt), sqrtf(dx^2 + dy^2) <
//     eps, its own exit).  With hi <= K - 2 the four taps stay inside the
//     surface.  A lane frozen from the start skips the window and the
//     surfaces, unless `surf` asks for them.
// Shared memory: S * pitch floats, P^2 and K^2 float4, 15.9 KB at S=35,
// P=15 (the window and the taps twice with three passes: 25.5 KB); the
// wrapper refuses an (S, P) above 48 KB.
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

// Row pitch of the window in shared memory, as in lk_corr_align.cu: a
// multiple of 4 floats above S + 3.
__host__ __device__ inline int window_pitch(int S) { return ((S + 3) | 3) + 1; }

// r(v): v rounded to the nearest bf16 (ties to even) and back to f32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The passes' operands in place, as in lk_corr_align.cu.
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
lk_corr_align_gain_kernel(const float* __restrict__ img, const int32_t* __restrict__ origins,
                          const int32_t* __restrict__ img_index, const float* __restrict__ gx,
                          const float* __restrict__ gy, const float* __restrict__ gt,
                          const float* __restrict__ sc, float* __restrict__ out,
                          float* __restrict__ surf, int B, int H, int W, long long img_stride,
                          int S, int P, int iters, float eps, float hi, int vec) {
  extern __shared__ float4 smem4[];
  const int n = blockIdx.x;
  const float* s = sc + 12 * (long long)n;
  if (s[11] > 0.5f && surf == nullptr) {  // frozen from the start
    if (threadIdx.x == 0) {
      out[2 * (long long)n] = s[9];
      out[2 * (long long)n + 1] = s[10];
    }
    return;
  }
  const int K = S - P + 1;
  const int KK = K * K;
  const int PP = P * P;
  const int pitch = window_pitch(S);
  constexpr int kCopies = PASSES == 3 ? 2 : 1;  // hi and lo with three passes
  float* win = reinterpret_cast<float*>(smem4);
  float* win_lo = win + S * pitch;                                    // three passes
  float4* g4 = reinterpret_cast<float4*>(win + kCopies * S * pitch);  // (gx, gy, gt, -) taps
  float4* g4_lo = g4 + PP;                                            // three passes
  float4* cs = g4 + kCopies * PP;                                     // (Cx, Cy, Ct, -) cells

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
  const float* gtn = gt + (long long)n * PP;
  for (int i = threadIdx.x; i < PP; i += kThreads) {
    cp_async4(&g4[i].x, gxn + i);
    cp_async4(&g4[i].y, gyn + i);
    cp_async4(&g4[i].z, gtn + i);
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (PASSES > 0) {
    split_passes<PASSES>(win, win_lo, S * pitch);
    split_passes<PASSES>(&g4[0].x, &g4_lo[0].x, 4 * PP);
    __syncthreads();
  }

  // Surfaces: thread t computes cells (y, x .. x+kTx-1) of all three.
  const int groups = (K + kTx - 1) / kTx;
  for (int t = threadIdx.x; t < K * groups; t += kThreads) {
    const int y = t / groups;
    const int x = (t - y * groups) * kTx;
    float ax[kTx], ay[kTx], at[kTx];
#pragma unroll
    for (int k = 0; k < kTx; ++k) ax[k] = ay[k] = at[k] = 0.0f;
    for (int i = 0; i < P; ++i) {
      const float* wr = win + (y + i) * pitch + c0 + x;
      const float* wlr = win_lo + (y + i) * pitch + c0 + x;
      const float4* gr = g4 + i * P;
      const float4* glr = g4_lo + i * P;
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
        const float4 g = gr[j];
        if constexpr (PASSES == 3) {
          wl[kTx - 1] = wlr[j + kTx - 1];
          const float4 gl = glr[j];
#pragma unroll
          for (int k = 0; k < kTx; ++k) {
            ax[k] = fmaf(g.x, w[k], fmaf(g.x, wl[k], fmaf(gl.x, w[k], ax[k])));
            ay[k] = fmaf(g.y, w[k], fmaf(g.y, wl[k], fmaf(gl.y, w[k], ay[k])));
            at[k] = fmaf(g.z, w[k], fmaf(g.z, wl[k], fmaf(gl.z, w[k], at[k])));
          }
        } else {
#pragma unroll
          for (int k = 0; k < kTx; ++k) {
            ax[k] = fmaf(g.x, w[k], ax[k]);
            ay[k] = fmaf(g.y, w[k], ay[k]);
            at[k] = fmaf(g.z, w[k], at[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTx; ++k) {
      if (x + k < K) {
        const int cell = y * K + x + k;
        cs[cell] = make_float4(ax[k], ay[k], at[k], 0.0f);
        if (surf) {
          float* sn = surf + 3 * (long long)n * KK + cell;
          sn[0] = ax[k];
          sn[KK] = ay[k];
          sn[2 * KK] = at[k];
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

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
    const float4 c00 = cs[i00], c01 = cs[i00 + 1], c10 = cs[i00 + K], c11 = cs[i00 + K + 1];
    const float sumx = w00 * c00.x + w01 * c01.x + w10 * c10.x + w11 * c11.x;
    const float sumy = w00 * c00.y + w01 * c01.y + w10 * c10.y + w11 * c11.y;
    const float sumt = w00 * c00.z + w01 * c01.z + w10 * c10.z + w11 * c11.z;
    const float bx = tgx - sumx;
    const float by = tgy - sumy;
    const float bt = st2 - sumt;
    const float dx = B00 * bx + B01 * by + B02 * bt;
    const float dy = B10 * bx + B11 * by + B12 * bt;
    fx = fminf(fmaxf(fx + dx, 0.0f), hi);
    fy = fminf(fmaxf(fy + dy, 0.0f), hi);
    conv = sqrtf(dx * dx + dy * dy) < eps;
  }
  out[2 * (long long)n] = fx;
  out[2 * (long long)n + 1] = fy;
}

extern "C" int lk_corr_align_gain(const void* img, const void* origins, const void* img_index,
                                  const void* gx, const void* gy, const void* gt, const void* sc,
                                  void* out, void* surf, int n, int B, int H, int W,
                                  long long img_stride, int S, int P, int iters, float eps,
                                  float hi, int vec, int passes, void* stream) {
  if (passes != 0 && passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int K = S - P + 1;
    const size_t copies = passes == 3 ? 2 : 1;
    const size_t smem = copies * ((size_t)(S * window_pitch(S)) * sizeof(float) +
                                  (size_t)(P * P) * sizeof(float4)) +
                        (size_t)(K * K) * sizeof(float4);
    auto kernel = passes == 0   ? lk_corr_align_gain_kernel<0>
                  : passes == 1 ? lk_corr_align_gain_kernel<1>
                                : lk_corr_align_gain_kernel<3>;
    kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)img, (const int32_t*)origins, (const int32_t*)img_index,
        (const float*)gx, (const float*)gy, (const float*)gt, (const float*)sc, (float*)out,
        (float*)surf, B, H, W, img_stride, S, P, iters, eps, hi, vec);
  }
  return (int)cudaGetLastError();
}
