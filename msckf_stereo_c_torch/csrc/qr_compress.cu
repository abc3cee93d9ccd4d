// The R factor of a thin QR of every lane's stacked [H | r], in one pass.
//
// Replaces no Pallas kernel: the textbook update's compression
// (msckf_stereo_c_tpu/models/update.py:compress_measurements, method 'qr')
// is jnp.linalg.qr, which XLA lowers to its own QR on the TPU.  In the port
// its plain version is torch.linalg.qr(mode='r')
// (models/update.py:compress_measurements, ops/linalg.py:qr_r_reference);
// on the card ATen runs that as one cuSOLVER geqrf per lane, called from
// the host, for matrices of more than 256 rows.
//
// Per lane b, A = A[b] (m, n) row-major: R (n, n) upper triangular with
// R^T R = A^T A (with A = [H | r] and D = n - 1, R[:D, :D] and R[:D, D]
// are the compressed H and r).  R is built by adding A's rows to it, c at
// a time:
// [R; C] with C the next c rows is brought back to upper-triangular form
// by one Householder reflector per column j, over the c + 1 entries
// R[j][j] and C[:, j] (R below its diagonal is zero, so no other row of R
// takes part), LAPACK's dlarfg convention:
//   beta = -sign(alpha) sqrt(alpha^2 + |x|^2), tau = (beta - alpha) / beta,
//   v = [1; x / (alpha - beta)], and tau = 0 (no reflection) where |x| = 0;
//   for each column k > j: w = R[j][k] + v^T C[:, k];
//   R[j][k] -= tau w; C[:, k] -= tau v w.
// [R; 0] = Q^T [0; A] with Q orthogonal, so R^T R = A^T A to rounding.  R
// is unique only up to the signs of its rows where A has full column rank,
// and is not unique where it has not; the EKF update
// (models/update.py:_sqrt_update) depends on R only through R^T R and
// R^T r, which every such R shares.  A lane whose rows are all zero gives
// R = 0 exactly.  A NaN spreads as in LAPACK: a column whose |x|^2 is NaN
// still forms its (NaN) reflector, so a lane that holds a NaN gets a
// non-finite R.
//
// With W non-null the kernel also writes, per lane, the rows of A that
// hold a nonzero (or NaN) entry and the columns that do (W[b] = {rows,
// columns}, int32): the block whose QR is the lane's least work.
//
// Bound: operations.  Householder's least work is 2mn^2 - 2n^3/3 flops a
// lane on its nonzero block (m rows, n columns; at a dense B=512, m=2560,
// n=142: 5.2e10, 0.77 ms at 67 TFLOP/s float32); the bytes are one read
// of A (0.74 GB, 0.22 ms at 3.35 TB/s) and the R written.  A chunk column
// of zeros costs no reflector (tau = 0).
//
// Design: one block per lane, one thread per column (n <= kMaxThreads).
// The lane's R lives in shared memory, packed row-major upper-triangular
// (row j holds R[j][j..n-1]; 40.8 KB at n=142, so four blocks fit an SM),
// and never reaches device memory until the end.  Each thread keeps its
// column of the current chunk of C in registers, so A is read from
// device memory once, coalesced by rows.  Per column j the owner thread
// (k == j) forms the reflector and publishes v and tau in shared memory
// (double-buffered by the parity of j), and one barrier a column lets
// every thread k > j apply it to its own column: no reduction across
// threads.  The chunk's c rows are a compile-time width (64 in float32,
// 32 in float64) so that the column stays in registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

template <typename T, int C>
__global__ void qr_compress_kernel(const T* __restrict__ A, T* __restrict__ R, int* __restrict__ W, int m, int n) {
  extern __shared__ unsigned char smem_raw[];
  // The chunk's nonzero rows as bits, double-buffered by the chunk's parity:
  // every thread ORs its column's bits in before the chunk's first barrier,
  // and thread 0 counts and clears them after its last.
  __shared__ unsigned long long rowbits[2];
  T* Rs = reinterpret_cast<T*>(smem_raw);                 // packed rows, n (n + 1) / 2 entries
  T* vbuf = Rs + (size_t)n * (n + 1) / 2;                  // [2][C] reflector vectors
  T* taub = vbuf + 2 * C;                                  // [2] their tau
  const int k = threadIdx.x;
  const bool col = k < n;
  const T* Ab = A + (size_t)blockIdx.x * m * n;
  const bool count = W != nullptr;
  int nz_rows = 0;
  bool col_nz = false;
  if (k == 0) rowbits[0] = rowbits[1] = 0ull;

  // Row j's entries start at j * n - j (j - 1) / 2; entry (j, k) is k - j on.
  for (int i = k; i < n * (n + 1) / 2; i += blockDim.x) Rs[i] = T(0);
  __syncthreads();

  T x[C];
  for (int r0 = 0, chunk = 0; r0 < m; r0 += C, ++chunk) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int row = r0 + i;
      x[i] = (col && row < m) ? Ab[(size_t)row * n + k] : T(0);
    }
    if (count) {
      unsigned long long bits = 0ull;
#pragma unroll
      for (int i = 0; i < C; ++i) bits |= (unsigned long long)(x[i] != T(0)) << i;
      if (bits) {
        atomicOr(&rowbits[chunk & 1], bits);
        col_nz = true;
      }
    }
    for (int j = 0; j < n; ++j) {
      const int rowj = j * n - j * (j - 1) / 2 - j;  // Rs index of (j, k) is rowj + k
      T* v = vbuf + (j & 1) * C;
      if (k == j) {
        T s0 = T(0), s1 = T(0);
#pragma unroll
        for (int i = 0; i < C; i += 2) {
          s0 += x[i] * x[i];
          s1 += x[i + 1] * x[i + 1];
        }
        const T ss = s0 + s1;
        const T alpha = Rs[rowj + k];
        T tau = T(0);
        if (!(ss == T(0))) {  // a NaN sum forms a NaN reflector
          const T nrm = sqrt_t(alpha * alpha + ss);
          const T beta = alpha >= T(0) ? -nrm : nrm;
          tau = (beta - alpha) / beta;
          const T scale = T(1) / (alpha - beta);
#pragma unroll
          for (int i = 0; i < C; ++i) v[i] = x[i] * scale;
          Rs[rowj + k] = beta;
        }
        taub[j & 1] = tau;
      }
      __syncthreads();
      const T tau = taub[j & 1];
      if (k > j && col && tau != T(0)) {
        T w0 = Rs[rowj + k], w1 = T(0), w2 = T(0), w3 = T(0);
#pragma unroll
        for (int i = 0; i < C; i += 4) {
          w0 += v[i] * x[i];
          w1 += v[i + 1] * x[i + 1];
          w2 += v[i + 2] * x[i + 2];
          w3 += v[i + 3] * x[i + 3];
        }
        const T tw = tau * ((w0 + w1) + (w2 + w3));
        Rs[rowj + k] -= tw;
#pragma unroll
        for (int i = 0; i < C; ++i) x[i] -= tw * v[i];
      }
    }
    if (count && k == 0) {
      nz_rows += __popcll(rowbits[chunk & 1]);
      rowbits[chunk & 1] = 0ull;
    }
  }
  if (count) {
    const int nz_cols = __syncthreads_count(col && col_nz);
    if (k == 0) {
      W[2 * blockIdx.x] = nz_rows;
      W[2 * blockIdx.x + 1] = nz_cols;
    }
  }
  __syncthreads();
  if (col) {
    T* Rb = R + (size_t)blockIdx.x * n * n;
    for (int j = 0; j < n; ++j) Rb[(size_t)j * n + k] = k >= j ? Rs[j * n - j * (j - 1) / 2 - j + k] : T(0);
  }
}

template <typename T, int C>
static int launch(const void* A, void* R, int* W, int B, int m, int n, void* stream) {
  const int threads = (n + 31) / 32 * 32;
  const size_t smem = ((size_t)n * (n + 1) / 2 + 2 * C + 2) * sizeof(T);
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (smem + sizeof(unsigned long long) * 2 > 48 * 1024) {  // rowbits is static
    const cudaError_t e = cudaFuncSetAttribute(qr_compress_kernel<T, C>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qr_compress_kernel<T, C><<<B, threads, smem, (cudaStream_t)stream>>>((const T*)A, (T*)R, W, m, n);
  return (int)cudaGetLastError();
}

// A (B, m, n) and R (B, n, n), contiguous, float32 (is_double 0) or
// float64 (1); W (B, 2) int32 or null.  Returns the cudaError_t of the
// launch.
extern "C" int qr_compress(const void* A, void* R, void* W, int B, int m, int n, int is_double, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaSuccess;
  int* w = (int*)W;
  return is_double ? launch<double, 32>(A, R, w, B, m, n, stream) : launch<float, 64>(A, R, w, B, m, n, stream);
}
