// Backward template super-patches: the (P+2) template at a forward LK
// result, interpolated from the image as it is copied.
//
// Redesigns, for Hopper, the last window copy of the Pallas kernel
// msckf_stereo_c_tpu/ops/patch_extract.py:_kernel_factory (K2) on the
// tracker's path, the (Sb, Sb) forward block of
// msckf_stereo_c_tpu/ops/klt_corr.py:stereo_anchor_lr_fused, together with
// the tent-weight resample that followed it in XLA (_tent_weights,
// _sample).
//
// Per feature n, with T = P + 3 and q = P + 2:
//   ob  = clip(pts - (P+1)/2 - o, 0, Sb - T)            (f32, in this order)
//   out = Wy(ob_y) . img[b, oy:oy+Sb, ox:ox+Sb] . Wx(ob_x)^T
// with o the int32 block origin (clamped into the image as K2 clamps it
// for the copy; ob takes it as given) and W(a)[i, j] = max(0, 1 - |j -
// (a + i)|) the (q, Sb) tent rows.  A tent row has two non-zero weights, at
// floor(a + i) and the column after it, and a + i rounded in f32 lies in
// [floor(a) + i, floor(a) + i + 1]: so only the T x T window at
// o + floor(ob) is read.  The weights are computed as the plain version
// computes them (a + i, j - that, 1 - |.|, each rounded), and the blend
// runs rows first, then columns, the contraction order of the plain
// version's einsum: two products summed by one FMA each.  The plain
// version's batched GEMM sums the zero-weight columns as well and its
// association is not specified, so the two agree to rounding, not bit for
// bit.
//
// Bound: bytes, the distinct 32-byte sectors of the N windows plus the
// N * q^2 * 4 bytes written and the points and origins read: about 0.4 MB
// at N=144, P=15, 0.12 us at 3.35 TB/s; the blend's ~30 flops an output
// are negligible.  At the main path's sizes the launch is the floor.
//
// Design: extract_template.cu's.  One block per feature reads its T x T
// window once into shared memory (neighbouring threads on neighbouring
// pixels of a row), then writes the q x q outputs contiguously, each from
// four shared reads, column by column: out[n] is stored transposed, the
// layout in which the plain version's einsum returns it (strides (q^2, 1,
// q)), so the template quantities computed from it downstream sum in the
// same order.  The (Sb, Sb) block in device memory, the two (q, Sb) weight
// matrices and the two GEMMs are gone.
//
// Under the bf16 precision names (template PASSES, the wrapper's `passes`)
// the blend's operands are what the passes see of them, as in the JAX
// package's _sample with its bf16 compute dtype: each pixel as it is read
// into shared memory and each tent weight as it is computed becomes r(v)
// (one pass) or hi + lo (three passes, exact in f32), r rounding to the
// nearest bf16; the products and the intermediate row blend stay f32.  The
// tent weights 1 - frac are not exact in bf16.  PASSES = 0 is the f32 code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;

// Tent weights of output row (or column) i at fractional origin a, a0 =
// floor(a): the first non-zero input row j (relative to a0) and the
// weights of rows j and j + 1.
struct Tent {
  int j;
  float w0, w1;
};

// v as the passes see it: v (none), r(v) (one), r(v) + r(v - r(v)) (three).
template <int PASSES>
__device__ __forceinline__ float passes_operand(float v) {
  if constexpr (PASSES == 0) {
    return v;
  } else {
    const float h = __bfloat162float(__float2bfloat16_rn(v));
    if constexpr (PASSES == 1) return h;
    return h + __bfloat162float(__float2bfloat16_rn(v - h));
  }
}

template <int PASSES>
__device__ __forceinline__ Tent tent(float a, int a0, int i) {
  const float t = __fadd_rn(a, (float)i);
  const float f = floorf(t);
  Tent r;
  r.j = (int)f - a0;  // in {i, i + 1}
  r.w0 = passes_operand<PASSES>(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(f, t))), 0.0f));
  r.w1 = passes_operand<PASSES>(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(__fadd_rn(f, 1.0f), t))), 0.0f));
  return r;
}

template <int PASSES>
__global__ void __launch_bounds__(kThreads)
resample_template_kernel(const float* __restrict__ img, const float* __restrict__ pts,
                         const int32_t* __restrict__ origins,
                         const int32_t* __restrict__ img_index, float* __restrict__ out, int B,
                         int H, int W, long long img_stride, int Sb, int P) {
  extern __shared__ float win[];
  const int n = blockIdx.x;
  const int T = P + 3;
  const int q = P + 2;
  const float half = 0.5f * (float)(P + 1);  // (P+1)/2, exact
  const float top = (float)(Sb - T);
  const int ox = origins[2 * n];
  const int oy = origins[2 * n + 1];
  const float obx = fminf(fmaxf(__fsub_rn(__fsub_rn(pts[2 * n], half), (float)ox), 0.0f), top);
  const float oby = fminf(fmaxf(__fsub_rn(__fsub_rn(pts[2 * n + 1], half), (float)oy), 0.0f), top);
  const int ix = (int)floorf(obx);
  const int iy = (int)floorf(oby);

  const int b = img_index ? min(max(img_index[n], 0), B - 1) : 0;
  const int wx = min(max(ox, 0), W - Sb) + ix;
  const int wy = min(max(oy, 0), H - Sb) + iy;
  const float* src = img + (long long)b * img_stride + (long long)wy * W + wx;
  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    const int r = i / T;
    const int c = i - r * T;
    win[i] = passes_operand<PASSES>(src[(long long)r * W + c]);
  }
  __syncthreads();

  float* dst = out + (long long)n * q * q;  // column c of the template at dst + c * q
  for (int i = threadIdx.x; i < q * q; i += kThreads) {
    const int c = i / q;
    const int r = i - c * q;
    const Tent ty = tent<PASSES>(oby, iy, r);
    const Tent tx = tent<PASSES>(obx, ix, c);
    // Where a + i rounds up to an integer, the second weight is 0 and its
    // row (or column) may lie one past the window: read the last one.
    const float* r0 = win + ty.j * T;
    const float* r1 = win + min(ty.j + 1, T - 1) * T;
    const int c1 = min(tx.j + 1, T - 1);
    const float v0 = __fmaf_rn(ty.w1, r1[tx.j], __fmul_rn(ty.w0, r0[tx.j]));
    const float v1 = __fmaf_rn(ty.w1, r1[c1], __fmul_rn(ty.w0, r0[c1]));
    dst[i] = __fmaf_rn(tx.w1, v1, __fmul_rn(tx.w0, v0));
  }
}

extern "C" int resample_template(const void* img, const void* pts, const void* origins,
                                 const void* img_index, void* out, int n, int B, int H, int W,
                                 long long img_stride, int Sb, int P, int passes, void* stream) {
  if (passes != 0 && passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const size_t smem = (size_t)(P + 3) * (P + 3) * sizeof(float);
    auto kernel = passes == 0   ? resample_template_kernel<0>
                  : passes == 1 ? resample_template_kernel<1>
                                : resample_template_kernel<3>;
    kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)pts, (const int32_t*)origins, (const int32_t*)img_index,
        (float*)out, B, H, W, img_stride, Sb, P);
  }
  return (int)cudaGetLastError();
}
