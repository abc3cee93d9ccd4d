// Template super-patches: the (P+3) window at each point, interpolated
// bilinearly as it is copied.
//
// Redesigns, for Hopper, the template-window copy of the Pallas kernel
// msckf_stereo_c_tpu/ops/patch_extract.py:_kernel_factory (K2) together
// with the bilinear blend that followed it in XLA
// (msckf_stereo_c_tpu/ops/klt_corr.py:_interp_template, Pallas branch).
//
// Per point n, with Tq = P + 3 and q = P + 2:
//   torg = clip(floor(pts) - (P+1)//2, 0, [W - Tq, H - Tq])
//   a    = clip(pts - (P+1)/2 - torg, 0, 1)
//   out[n, r, c] = ((t[r][c] (1-ax)) (1-ay) + (t[r][c+1] ax) (1-ay))
//                  + (t[r+1][c] (1-ax)) ay + (t[r+1][c+1] ax) ay
// with t = img[b, ty:ty+Tq, tx:tx+Tq], b the clamped image index.  Every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn), in the
// plain version's order, so nothing contracts into an FMA and the result
// is bit-exact with it.
//
// Bound: bytes, the distinct 32-byte sectors of the N windows plus the
// N * q^2 * 4 bytes written and the points read: about 0.4 MB at N=144,
// P=15, 0.12 us at 3.35 TB/s; the blend's 11 flops an output are
// negligible.  At the main path's sizes the launch is the floor.
//
// Design: one block per point.  The block reads its Tq x Tq window once
// into shared memory (neighbouring threads on neighbouring pixels of a
// row), then writes the q x q outputs contiguously, each from four shared
// reads.  Two eager copies of the window (K2's output, then the four
// slices) and about 14 elementwise launches are gone.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_template_kernel(const float* __restrict__ img, const float* __restrict__ pts,
                        const int32_t* __restrict__ img_index, float* __restrict__ out,
                        int B, int H, int W, long long img_stride, int P) {
  extern __shared__ float win[];
  const int n = blockIdx.x;
  const int Tq = P + 3;
  const int q = P + 2;
  const float px = pts[2 * n];
  const float py = pts[2 * n + 1];
  const float lo = (float)((P + 1) / 2);   // (P+1)//2
  const float half = 0.5f * (float)(P + 1);  // (P+1)/2, exact
  const float tx = fminf(fmaxf(__fsub_rn(floorf(px), lo), 0.0f), (float)(W - Tq));
  const float ty = fminf(fmaxf(__fsub_rn(floorf(py), lo), 0.0f), (float)(H - Tq));
  const float ax = fminf(fmaxf(__fsub_rn(__fsub_rn(px, half), tx), 0.0f), 1.0f);
  const float ay = fminf(fmaxf(__fsub_rn(__fsub_rn(py, half), ty), 0.0f), 1.0f);
  const float omx = __fsub_rn(1.0f, ax);
  const float omy = __fsub_rn(1.0f, ay);

  const int b = img_index ? min(max(img_index[n], 0), B - 1) : 0;
  const float* src = img + (long long)b * img_stride + (long long)(int)ty * W + (int)tx;
  for (int i = threadIdx.x; i < Tq * Tq; i += kThreads) {
    const int r = i / Tq;
    const int c = i - r * Tq;
    win[i] = src[(long long)r * W + c];
  }
  __syncthreads();

  float* dst = out + (long long)n * q * q;
  for (int i = threadIdx.x; i < q * q; i += kThreads) {
    const int r = i / q;
    const int c = i - r * q;
    const float* t = win + r * Tq + c;
    float v = __fmul_rn(__fmul_rn(t[0], omx), omy);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t[1], ax), omy));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t[Tq], omx), ay));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(t[Tq + 1], ax), ay));
    dst[i] = v;
  }
}

extern "C" int extract_template(const void* img, const void* pts, const void* img_index,
                                void* out, int n, int B, int H, int W, long long img_stride,
                                int P, void* stream) {
  if (n > 0) {
    const size_t smem = (size_t)(P + 3) * (P + 3) * sizeof(float);
    extract_template_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)pts, (const int32_t*)img_index, (float*)out, B, H, W,
        img_stride, P);
  }
  return (int)cudaGetLastError();
}
