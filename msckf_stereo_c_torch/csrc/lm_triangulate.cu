// Every track's inverse-depth Levenberg-Marquardt triangulation, in one pass.
//
// Replaces no Pallas kernel: the JAX package's triangulate_track
// (msckf_stereo_c_tpu/models/triangulation.py:139-173) is a per-track
// lax.while_loop that XLA vmaps over the track pool, so each track stops on
// its own.  Its plain version in the port, models/triangulation.py:
// triangulate_tracks_reference, runs the same per-track loop masked over
// all tracks of all lanes, with one host read an iteration for its exit;
// on the card that is about 120 small launches and a device-to-host round
// trip per iteration, up to 30 iterations a call.
//
// Per track (lane b, track k; obs (M, 4) [x0 y0 x1 y1], obs_valid (M,)),
// with the window's cameras cam_q (M, 4) JPL and cam_p (M, 3):
//   i0 = first valid slot (0 when none), i_last = last (M - 1 when none);
//   each slot's cam0 and cam1 pose re-based to cam0 at i0: x_ci = R_i x + t_i;
//   a two-view depth along the i0 cam0 ray from the i_last cam1 view, then
//   x = (alpha, beta, rho) inverse depth, cost(x) = sum over valid
//   observations of |h_xy / h_z - z|^2 with h = R [alpha beta 1] + rho t;
//   up to 30 damped Gauss-Newton steps with Huber weights (eps 0.01),
//   lambda from 1e-3, x10 on a rejected step, x0.1 on an accepted one,
//   clamped to [1e-10, 1e12]; the track stops when |delta| <= 5e-7 (a NaN
//   delta stops it too, as a NaN never compares greater);
//   valid = every valid observation's depth > 0 and at least 2 of them;
//   pos_w = R_base p + t_base.
// Each comparison and clamp is the plain version's, NaN included: a NaN
// cost is never accepted (cost_new < cost is false), torch.clamp keeps a
// NaN (no fmax), and torch.where(|d| > eps, d, eps) takes eps for a NaN.
// A slot without an observation adds its J^T J and J^T r terms with
// weight 0, as the plain version's einsum does, so a non-finite
// observation or projection there (0 * inf) makes the step NaN and ends
// the track where it started; the cost and the cheirality vote skip such
// a slot, as the plain version's torch.where does.
// The tracks of lanes outside ``active`` make no step, as in the plain
// version.  With ``iters`` non-null each track's number of steps is
// written there too (0 for a lane outside ``active``).
//
// Bound: latency.  The work is about 200 floating-point operations per
// observation and step; the bytes are one read of obs, obs_valid and the
// cameras and the outputs written (16,384 tracks at M = 20: 5.6 MB, 1.7 us
// at 3.35 TB/s).  Each step is a chain of dependent operations and warp
// reductions, and the slowest track of a block sets its time.
//
// Design: one warp per track, 8 tracks a block.  Lane j owns slots
// j and j + 32 (S = 1 or 2 a lane, fixed at compile time) and keeps their two
// re-based poses and observations in registers: the (2M, 3, 3) pose stack
// and the step's temporaries never reach device memory.  A step adds each
// lane's slots' Huber-weighted J^T J (6 entries) and J^T r (3), and a cost
// its observations' squared residuals; a butterfly of __shfl_xor_sync gives every
// lane the same sums (IEEE addition commutes, so each lane's pairwise sums
// are the same bits), so every lane solves the same 3x3 system (adjugate,
// ops/linalg.py:solve3x3's det guard) and takes the same branch: the warp
// leaves its loop when its track stops, and no lane waits on another
// track.  float32 or float64 throughout, in FMAs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIters = 30;

template <typename T>
struct Pose {
  T R[9];  // row-major
  T t[3];
};

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }  // NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// C(q) = (2w^2 - 1) I - 2w [qv]x + 2 qv qv^T (utils/quaternion.py:jpl_to_rot).
template <typename T>
__device__ __forceinline__ void jpl_to_rot(const T* q, T* C) {
  const T x = q[0], y = q[1], z = q[2], w = q[3];
  const T d = T(2) * w * w - T(1);
  C[0] = d + T(2) * x * x;
  C[1] = T(2) * w * z + T(2) * x * y;
  C[2] = -(T(2) * w * y) + T(2) * x * z;
  C[3] = -(T(2) * w * z) + T(2) * y * x;
  C[4] = d + T(2) * y * y;
  C[5] = T(2) * w * x + T(2) * y * z;
  C[6] = T(2) * w * y + T(2) * z * x;
  C[7] = -(T(2) * w * x) + T(2) * z * y;
  C[8] = d + T(2) * z * z;
}

template <typename T>
__device__ __forceinline__ void matmul3(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename T>
__device__ __forceinline__ void matvec3(const T* A, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

// The cam0 and cam1 poses of slot m re-based to the base cam0 frame
// (Rb = R_c0_w of the base slot, tb its position):
// (R, t) = (Rwc Rb, Rwc tb - Rwc t_cw) with Rwc = C(q_m) for cam0 and
// R_c0_c1 C(q_m) for cam1, t_cw = p_m and C(q_m)^T t_c1_c0 + p_m.
template <typename T>
__device__ __forceinline__ void slot_poses(const T* q, const T* p, const T* R01, const T* t10, const T* Rb,
                                           const T* tb, Pose<T>& c0, Pose<T>& c1) {
  T C[9], C1[9], CtT[9], tc1[3], a[3], b[3];
  jpl_to_rot(q, C);
  matmul3(R01, C, C1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) CtT[3 * i + j] = C[3 * j + i];
  matvec3(CtT, t10, tc1);
#pragma unroll
  for (int i = 0; i < 3; ++i) tc1[i] += p[i];
  matmul3(C, Rb, c0.R);
  matvec3(C, tb, a);
  matvec3(C, p, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) c0.t[i] = a[i] + -b[i];
  matmul3(C1, Rb, c1.R);
  matvec3(C1, tb, a);
  matvec3(C1, tc1, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) c1.t[i] = a[i] + -b[i];
}

// h = R [x0 x1 1] + x2 t (triangulation.py:_project).
template <typename T>
__device__ __forceinline__ void project(const Pose<T>& c, const T* x, T* h) {
#pragma unroll
  for (int i = 0; i < 3; ++i) h[i] = (c.R[3 * i] * x[0] + c.R[3 * i + 1] * x[1] + c.R[3 * i + 2]) + x[2] * c.t[i];
}

template <typename T>
__device__ __forceinline__ T sq_residual(const Pose<T>& c, const T* x, T zx, T zy) {
  T h[3];
  project(c, x, h);
  const T ex = h[0] / h[2] - zx, ey = h[1] / h[2] - zy;
  return ex * ex + ey * ey;
}

// Huber-weighted J^T J (upper triangle: 00 01 02 11 12 22) and J^T r of one
// view of a slot, added to acc[0..8] (triangulation.py:_normal_equations);
// weight 0 where the slot holds no observation.
template <typename T>
__device__ __forceinline__ void add_normal(const Pose<T>& c, const T* x, T zx, T zy, bool observed, T* acc) {
  T h[3];
  project(c, x, h);
  const T h3 = h[2], hh = h3 * h3;
  const T W0[3] = {c.R[0], c.R[1], c.t[0]};
  const T W1[3] = {c.R[3], c.R[4], c.t[1]};
  const T W2[3] = {c.R[6], c.R[7], c.t[2]};
  const T g0 = h[0] / hh, g1 = h[1] / hh;
  T J0[3], J1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    J0[a] = W0[a] / h3 - g0 * W2[a];
    J1[a] = W1[a] / h3 - g1 * W2[a];
  }
  const T r0 = h[0] / h3 - zx, r1 = h[1] / h3 - zy;
  const T e = sqrt_t(r0 * r0 + r1 * r1);
  const T w = e <= T(0.01) ? T(1) : sqrt_t(T(2) * T(0.01) / clamp_min(e, T(1e-12)));
  const T w2 = observed ? w * w : T(0);
  acc[0] += w2 * (J0[0] * J0[0] + J1[0] * J1[0]);
  acc[1] += w2 * (J0[0] * J0[1] + J1[0] * J1[1]);
  acc[2] += w2 * (J0[0] * J0[2] + J1[0] * J1[2]);
  acc[3] += w2 * (J0[1] * J0[1] + J1[1] * J1[1]);
  acc[4] += w2 * (J0[1] * J0[2] + J1[1] * J1[2]);
  acc[5] += w2 * (J0[2] * J0[2] + J1[2] * J1[2]);
  acc[6] += w2 * (J0[0] * r0 + J1[0] * r1);
  acc[7] += w2 * (J0[1] * r0 + J1[1] * r1);
  acc[8] += w2 * (J0[2] * r0 + J1[2] * r1);
}

template <typename T, int S>
__global__ void __launch_bounds__(32 * kWarps)
lm_triangulate_kernel(const T* __restrict__ obs, const bool* __restrict__ obs_valid, const T* __restrict__ cam_q,
                      const T* __restrict__ cam_p, const T* __restrict__ R_c0_c1, const T* __restrict__ t_c0_c1,
                      const bool* __restrict__ active, T* __restrict__ pos_w, bool* __restrict__ valid,
                      long long* __restrict__ base_slot, int* __restrict__ iters, long long n_tracks, int K0,
                      int M) {
  const int lane = threadIdx.x & 31;
  const long long track = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (track >= n_tracks) return;  // the whole warp
  const long long b = track / K0;
  const T* ob = obs + track * M * 4;
  const bool* vb = obs_valid + track * M;
  const T* qb = cam_q + b * M * 4;
  const T* pb = cam_p + b * M * 3;

  // Which slots hold an observation, by ballot.
  bool ov[S], in_window[S];
  unsigned bits[S];
  int n_valid = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int m = lane + 32 * s;
    in_window[s] = m < M;
    ov[s] = in_window[s] && vb[m];
    bits[s] = __ballot_sync(kFull, ov[s]);
    n_valid += __popc(bits[s]);
  }
  int i0 = -1, i_last = -1;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (i0 < 0 && bits[s]) i0 = 32 * s + __ffs(bits[s]) - 1;
    if (bits[S - 1 - s] && i_last < 0) i_last = 32 * (S - 1 - s) + 31 - __clz(bits[S - 1 - s]);
  }
  if (i0 < 0) i0 = 0;
  if (i_last < 0) i_last = M - 1;

  T R01[9], t10[3], Rb[9], tb[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R01[i] = R_c0_c1[i];
  // t_c1_c0 = -R_c0_c1^T t_c0_c1
#pragma unroll
  for (int i = 0; i < 3; ++i) t10[i] = -(R01[i] * t_c0_c1[0] + R01[3 + i] * t_c0_c1[1] + R01[6 + i] * t_c0_c1[2]);
  {
    T C[9];
    jpl_to_rot(qb + 4 * i0, C);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Rb[3 * i + j] = C[3 * j + i];
      tb[i] = pb[3 * i0 + i];
    }
  }

  Pose<T> c0[S], c1[S];
  T z[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int m = min(lane + 32 * s, M - 1);  // lanes past M hold a copy of the last slot, never read
    slot_poses(qb + 4 * m, pb + 3 * m, R01, t10, Rb, tb, c0[s], c1[s]);
#pragma unroll
    for (int i = 0; i < 4; ++i) z[s][i] = ob[4 * m + i];
  }

  // Two-view linear depth from the base cam0 ray and the last cam1 view
  // (every lane computes the last slot's cam1 pose itself).
  T x[3];
  {
    Pose<T> l0, l1;
    slot_poses(qb + 4 * i_last, pb + 3 * i_last, R01, t10, Rb, tb, l0, l1);
    const T zf0 = ob[4 * i0], zf1 = ob[4 * i0 + 1];
    const T zl0 = ob[4 * i_last + 2], zl1 = ob[4 * i_last + 3];
    const T ray[3] = {zf0, zf1, T(1)};
    T mv[3];
    matvec3(l1.R, ray, mv);
    const T A0 = mv[0] - zl0 * mv[2], A1 = mv[1] - zl1 * mv[2];
    const T b0 = zl0 * l1.t[2] - l1.t[0], b1 = zl1 * l1.t[2] - l1.t[1];
    const T depth = (A0 * b0 + A1 * b1) / clamp_min(A0 * A0 + A1 * A1, T(1e-12));
    const T p0[3] = {zf0 * depth, zf1 * depth, depth};
    const T sd = fabs(p0[2]) > T(1e-8) ? p0[2] : T(1);
    x[0] = p0[0] / sd;
    x[1] = p0[1] / sd;
    x[2] = T(1) / sd;
  }

  auto cost_of = [&](const T* xv) {
    T c = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (ov[s]) c += sq_residual(c0[s], xv, z[s][0], z[s][1]) + sq_residual(c1[s], xv, z[s][2], z[s][3]);
    return warp_sum(c);
  };

  T cost = cost_of(x);
  T lam = T(1e-3);
  int it = 0;
  bool run = active == nullptr || active[b];
  while (run && it < kIters) {  // warp-uniform: every lane holds the same sums
    T acc[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) acc[i] = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (in_window[s]) {
        add_normal(c0[s], x, z[s][0], z[s][1], ov[s], acc);
        add_normal(c1[s], x, z[s][2], z[s][3], ov[s], acc);
      }
#pragma unroll
    for (int i = 0; i < 9; ++i) acc[i] = warp_sum(acc[i]);
    // solve3x3 of (A + lam I) delta = b, ops/linalg.py's adjugate
    const T a00 = acc[0] + lam, a01 = acc[1], a02 = acc[2];
    const T a10 = acc[1], a11 = acc[3] + lam, a12 = acc[4];
    const T a20 = acc[2], a21 = acc[4], a22 = acc[5] + lam;
    const T c00 = a11 * a22 - a12 * a21, c01 = a02 * a21 - a01 * a22, c02 = a01 * a12 - a02 * a11;
    const T c10 = a12 * a20 - a10 * a22, c11 = a00 * a22 - a02 * a20, c12 = a02 * a10 - a00 * a12;
    const T c20 = a10 * a21 - a11 * a20, c21 = a01 * a20 - a00 * a21, c22 = a00 * a11 - a01 * a10;
    const T det = a00 * c00 + a01 * c01 + a02 * c02;
    const T inv_det = T(1) / (fabs(det) > T(1e-30) ? det : T(1e-30));
    const T g0 = acc[6], g1 = acc[7], g2 = acc[8];
    const T d[3] = {(c00 * g0 + c01 * g1 + c02 * g2) * inv_det, (c10 * g0 + c11 * g1 + c12 * g2) * inv_det,
                    (c20 * g0 + c21 * g1 + c22 * g2) * inv_det};
    const T x_new[3] = {x[0] - d[0], x[1] - d[1], x[2] - d[2]};
    const T cost_new = cost_of(x_new);
    if (cost_new < cost) {
#pragma unroll
      for (int i = 0; i < 3; ++i) x[i] = x_new[i];
      cost = cost_new;
      lam = clamp_min(lam * T(0.1), T(1e-10));
    } else {
      lam = clamp_max(lam * T(10.0), T(1e12));
    }
    run = sqrt_t(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) > T(5e-7);
    ++it;
  }

  const T inv_rho = T(1) / (fabs(x[2]) > T(1e-12) ? x[2] : T(1e-12));
  const T pbase[3] = {x[0] * inv_rho, x[1] * inv_rho, inv_rho};
  // Cheirality: in front of every observing camera.
  bool front = true;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (ov[s]) {
      const T d0 = c0[s].R[6] * pbase[0] + c0[s].R[7] * pbase[1] + c0[s].R[8] * pbase[2] + c0[s].t[2];
      const T d1 = c1[s].R[6] * pbase[0] + c1[s].R[7] * pbase[1] + c1[s].R[8] * pbase[2] + c1[s].t[2];
      front = front && d0 > T(0) && d1 > T(0);
    }
  front = __all_sync(kFull, front);
  if (lane == 0) {
    T pw[3];
    matvec3(Rb, pbase, pw);
#pragma unroll
    for (int i = 0; i < 3; ++i) pos_w[3 * track + i] = pw[i] + tb[i];
    valid[track] = front && n_valid >= 2;
    base_slot[track] = i0;
    if (iters != nullptr) iters[track] = it;
  }
}

template <typename T, int S>
static int launch(const void* obs, const void* obs_valid, const void* cam_q, const void* cam_p, const void* R01,
                  const void* t01, const void* active, void* pos_w, void* valid, void* base_slot, void* iters,
                  long long n_tracks, int K0, int M, void* stream) {
  const long long blocks = (n_tracks + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  lm_triangulate_kernel<T, S><<<(unsigned)blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const T*)obs, (const bool*)obs_valid, (const T*)cam_q, (const T*)cam_p, (const T*)R01, (const T*)t01,
      (const bool*)active, (T*)pos_w, (bool*)valid, (long long*)base_slot, (int*)iters, n_tracks, K0, M);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(const void* obs, const void* obs_valid, const void* cam_q, const void* cam_p, const void* R01,
                    const void* t01, const void* active, void* pos_w, void* valid, void* base_slot, void* iters,
                    long long n_tracks, int K0, int M, void* stream) {
  if (M <= 32)
    return launch<T, 1>(obs, obs_valid, cam_q, cam_p, R01, t01, active, pos_w, valid, base_slot, iters, n_tracks,
                        K0, M, stream);
  if (M <= 64)
    return launch<T, 2>(obs, obs_valid, cam_q, cam_p, R01, t01, active, pos_w, valid, base_slot, iters, n_tracks,
                        K0, M, stream);
  return (int)cudaErrorInvalidValue;
}

// obs (B, K0, M, 4), obs_valid (B, K0, M) bool, cam_q (B, M, 4), cam_p
// (B, M, 3), R_c0_c1 (3, 3), t_c0_c1 (3,), active (B,) bool or null; out
// pos_w (B, K0, 3), valid (B, K0) bool, base_slot (B, K0) int64, iters
// (B, K0) int32 or null; all contiguous, float32 (is_double 0) or float64
// (1); n_tracks = B * K0, 1 <= M <= 64.  Returns the cudaError_t of the
// launch.
extern "C" int lm_triangulate(const void* obs, const void* obs_valid, const void* cam_q, const void* cam_p,
                              const void* R_c0_c1, const void* t_c0_c1, const void* active, void* pos_w, void* valid,
                              void* base_slot, void* iters, long long n_tracks, int K0, int M, int is_double,
                              void* stream) {
  if (n_tracks <= 0 || K0 <= 0 || M <= 0) return (int)cudaSuccess;
  return is_double ? launch_t<double>(obs, obs_valid, cam_q, cam_p, R_c0_c1, t_c0_c1, active, pos_w, valid,
                                      base_slot, iters, n_tracks, K0, M, stream)
                   : launch_t<float>(obs, obs_valid, cam_q, cam_p, R_c0_c1, t_c0_c1, active, pos_w, valid,
                                     base_slot, iters, n_tracks, K0, M, stream);
}
