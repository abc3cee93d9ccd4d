// FAST-9/16 corners and the per-cell pick of every lane's image, in one pass.
//
// Replaces no Pallas kernel: msckf_stereo_c_tpu/ops/fast.py's
// fast_score_map and detect_grid_corners were jnp code that XLA fused on
// the TPU.  Their plain PyTorch copy (ops/fast.py:detect_grid_corners_reference)
// stacks 16 shifted float32 copies of each image and rolls 16-plane bool
// masks, about 56 GB of live tensors at B=512, 480x752.
//
// Per pixel p of the tiles (rows < Gy*cell, columns < Gx*cell) of image b,
// with the circle of radius 3 in OpenCV's order, k = 0..15:
//   d_k    = I(p + circle_k) - I(p)                        (float32)
//   bright = sum_k (d_k > t) << k,  dark = sum_k (d_k < -t) << k
//   corner: a circular run of >= 9 set bits in either code.  On the doubled
//           word w = code | code << 16: m = w & w>>1; m &= m>>2; m &= m>>4;
//           m &= w>>8; bit k of m is bits k..k+8 of w, so the test is
//           m & 0xFFFF != 0 (the plain version's roll order)
//   score  = the sum, in k order, of |d_k| over the k in either code; 0
//            where p is no corner or lies within 3 pixels of the border.
// Per cell: the largest score, ties to the smallest row-major index
// r * cell + c (torch.argmax's and jnp.argmax's first maximum), as one
// max over the key (float bits of the score) << 32 | ~index: scores are
// >= +0, so their bits order as the floats do.  An all-zero cell picks
// index 0.  xy = the cell's origin + (index % cell, index / cell);
// valid = score > 0 && !occupied.
//
// Bound: bytes.  One read of each image, B*H*W*4 bytes (0.74 GB at B=512,
// 480x752: 0.22 ms at 3.35 TB/s), and 13 bytes a cell written.  No
// 16-plane tensor exists.
//
// Design: one block per (lane, cell row, group of 128/cell cells, at
// least one).  The block copies its tile with a 3-pixel halo, (rows + 6) x
// (columns + 6) pixels, into shared memory once (16-byte loads where W is
// a multiple of 4 floats), scores every pixel from shared memory, and
// folds each thread's best key per cell into the cell's slot with a
// shared-memory 64-bit atomicMax.  A pixel reads its 4 compass points
// first and the other 12 only where two neighbouring ones pass a test (a
// run of 9 needs that); the score's sum is taken only for corners.  Cells taller than 32 or wider than 128
// pixels are walked in sub-tiles of at most 32 x 128.  Only the per-cell
// results (and, when asked for, the score map) reach device memory.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kTileRows = 32;   // pixel rows of a sub-tile, at most
constexpr int kTileCols = 128;  // pixel columns of a sub-tile, at most
constexpr int kSmemRows = kTileRows + 6;
// The halo's 3 columns each side, up to 3 more to start on a 16-byte
// boundary, rounded up to whole float4s.
constexpr int kSmemCols = kTileCols + 12;

__device__ __forceinline__ bool has_run9(unsigned code) {
  const unsigned w = code | (code << 16);
  unsigned m = w & (w >> 1);  // runs >= 2
  m &= m >> 2;                // >= 4
  m &= m >> 4;                // >= 8
  m &= w >> 8;                // >= 9
  return (m & 0xFFFFu) != 0u;
}

__device__ __forceinline__ bool compass_pair(bool a, bool b, bool c, bool d) {
  return (a && b) || (b && c) || (c && d) || (d && a);
}

__global__ void __launch_bounds__(kThreads)
fast_grid_corners_kernel(const float* __restrict__ img, const uint8_t* __restrict__ occupied,
                         float* __restrict__ xy, float* __restrict__ score, uint8_t* __restrict__ valid,
                         float* __restrict__ score_out, int H, int W, int cell, int Gy, int Gx,
                         int cells_per_block, int groups, float t, int vec) {
  __shared__ __align__(16) float tile[kSmemRows * kSmemCols];
  __shared__ unsigned long long keys[kTileCols];
  // The circle (dy, dx), OpenCV's order.
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

  const int group = blockIdx.x % groups;
  const int gy = (blockIdx.x / groups) % Gy;
  const long long b = blockIdx.x / ((unsigned)groups * (unsigned)Gy);
  const int gx0 = group * cells_per_block;
  const int nc = min(cells_per_block, Gx - gx0);
  const int y0 = gy * cell;
  const int x0 = gx0 * cell;
  const int band_w = nc * cell;
  const float nt = -t;
  const float* src = img + b * H * W;
  for (int i = threadIdx.x; i < nc; i += kThreads) keys[i] = 0ull;

  for (int ry = 0; ry < cell; ry += kTileRows) {
    const int th = min(kTileRows, cell - ry);
    for (int rx = 0; rx < band_w; rx += kTileCols) {
      const int tw = min(kTileCols, band_w - rx);
      const int first = x0 + rx - 3;                 // image column of the halo's first pixel
      const int xs = first - (((first % 4) + 4) % 4);  // rounded down to a multiple of 4
      const int off = x0 + rx - xs;                  // shared column of the sub-tile's first pixel
      const int chunks = (off + tw + 3 + 3) / 4;     // float4s a shared row holds
      const int ys = y0 + ry - 3;
      __syncthreads();  // the slots are set, the previous sub-tile is read
      for (int i = threadIdx.x; i < (th + 6) * chunks; i += kThreads) {
        const int r = i / chunks;
        const int q = i - r * chunks;
        const int gyy = ys + r;
        const int gxx = xs + 4 * q;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (gyy >= 0 && gyy < H) {
          const float* row = src + (long long)gyy * W;
          if (vec) {
            // W and xs are multiples of 4: the float4 lies wholly inside
            // the row or wholly outside it.
            if (gxx >= 0 && gxx < W) v = *reinterpret_cast<const float4*>(row + gxx);
          } else {
            if (gxx >= 0 && gxx < W) v.x = row[gxx];
            if (gxx + 1 >= 0 && gxx + 1 < W) v.y = row[gxx + 1];
            if (gxx + 2 >= 0 && gxx + 2 < W) v.z = row[gxx + 2];
            if (gxx + 3 >= 0 && gxx + 3 < W) v.w = row[gxx + 3];
          }
        }
        *reinterpret_cast<float4*>(tile + r * kSmemCols + 4 * q) = v;
      }
      __syncthreads();

      // Thread t scores column t % tw of rows t / tw, t / tw + per_pass, ...:
      // all of one cell, so it folds one running best into one slot.
      const int per_pass = kThreads / tw;  // >= 2: tw <= 128
      if (threadIdx.x < per_pass * tw) {
        const int c = threadIdx.x % tw;
        const int x = x0 + rx + c;
        const int lc = (rx + c) / cell;       // the cell, within the group
        const int cx = rx + c - lc * cell;    // the column, within the cell
        unsigned long long best = 0ull;
        for (int r = threadIdx.x / tw; r < th; r += per_pass) {
          const int y = y0 + ry + r;
          const float* p = tile + (r + 3) * kSmemCols + off + c;
          const float ctr = p[0];
          float d[16];
#pragma unroll
          for (int k = 0; k < 16; k += 4) d[k] = __fsub_rn(p[kDy[k] * kSmemCols + kDx[k]], ctr);
          float s = 0.0f;
          const bool inside = y >= 3 && y < H - 3 && x >= 3 && x < W - 3;
          // Any 9 neighbouring circle pixels hold two neighbouring compass
          // points (0, 4, 8, 12): a pixel with no such pair in either test
          // is no corner, and the other 12 pixels are not read for it.
          if (inside && (compass_pair(d[0] > t, d[4] > t, d[8] > t, d[12] > t) ||
                         compass_pair(d[0] < nt, d[4] < nt, d[8] < nt, d[12] < nt))) {
            unsigned bright = 0u, dark = 0u;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              if (k % 4) d[k] = __fsub_rn(p[kDy[k] * kSmemCols + kDx[k]], ctr);
              bright |= (unsigned)(d[k] > t) << k;
              dark |= (unsigned)(d[k] < nt) << k;
            }
            if (has_run9(bright) || has_run9(dark)) {
              const unsigned either = bright | dark;
#pragma unroll
              for (int k = 0; k < 16; ++k) s = __fadd_rn(s, ((either >> k) & 1u) ? fabsf(d[k]) : 0.0f);
            }
          }
          if (score_out) score_out[(b * H + y) * W + x] = s;
          const unsigned index = (unsigned)((ry + r) * cell + cx);
          const unsigned long long key = ((unsigned long long)__float_as_uint(s) << 32) | (unsigned)~index;
          if (key > best) best = key;
        }
        atomicMax(&keys[lc], best);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nc; i += kThreads) {
    const unsigned long long key = keys[i];
    const float s = __uint_as_float((unsigned)(key >> 32));
    const unsigned index = ~(unsigned)key;
    const long long o = (b * Gy + gy) * Gx + gx0 + i;
    xy[2 * o] = (float)(x0 + i * cell + (int)(index % (unsigned)cell));
    xy[2 * o + 1] = (float)(y0 + (int)(index / (unsigned)cell));
    score[o] = s;
    valid[o] = (s > 0.0f && !(occupied && occupied[o])) ? 1 : 0;
  }
}

extern "C" int fast_grid_corners(const void* img, const void* occupied, void* xy, void* score, void* valid,
                                 void* score_out, int B, int H, int W, int cell, float threshold, int vec,
                                 void* stream) {
  if (cell < 1) return (int)cudaErrorInvalidValue;
  const int Gy = H / cell;
  const int Gx = W / cell;
  if (B > 0 && Gy > 0 && Gx > 0) {
    const int per = cell >= kTileCols ? 1 : kTileCols / cell;
    const int groups = (Gx + per - 1) / per;
    const long long blocks = (long long)B * Gy * groups;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    fast_grid_corners_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const uint8_t*)occupied, (float*)xy, (float*)score, (uint8_t*)valid,
        (float*)score_out, H, W, cell, Gy, Gx, per, groups, threshold, vec);
  }
  return (int)cudaGetLastError();
}
