// Warp-level dense Cholesky factor and solve for one small SPD system.
//
// Shared by linalg.cu (kernels 1-3) and newton_structured.cu (kernel 4).
// One warp owns one n x n system (n <= 32) held row-major in shared memory
// with an odd leading dimension `ld`; lane i owns row i, so the column
// sweeps touch one row per lane and the odd stride keeps them free of bank
// conflicts. The arithmetic follows the plain versions in
// ambersim_tpu_torch/engine/linalg.py (sqrt of max(a_jj, 1e-12), divide),
// up to FMA contraction and summation order.
#pragma once

#include <cuda_runtime.h>

namespace amb {

constexpr unsigned kFullMask = 0xffffffffu;

// In-place lower Cholesky. Reads only the lower triangle (i >= k) and
// overwrites it with L; entries above the diagonal are neither read nor
// written. Every lane of the warp must call it.
__device__ inline void warp_cholesky(float* a, int n, int ld) {
  const int i = threadIdx.x & 31;
  for (int j = 0; j < n; ++j) {
    __syncwarp();
    const float d = sqrtf(fmaxf(a[j * ld + j], 1e-12f));
    float c = 0.f;
    if (i >= j && i < n) c = a[i * ld + j] / d;
    __syncwarp();  // every lane has read a[j][j] before lane j overwrites it
    if (i >= j && i < n) a[i * ld + j] = c;
    // rank-1 downdate of the trailing lower triangle, one row per lane
    for (int k = j + 1; k < n; ++k) {
      const float ck = __shfl_sync(kFullMask, c, k);
      if (i >= k && i < n) a[i * ld + k] -= c * ck;
    }
  }
  __syncwarp();
}

// Solve L L^T x = b by forward then backward column sweeps. Lane i passes
// b_i (any value for i >= n) and gets x_i back. Every lane must call it.
__device__ inline float warp_cho_solve(const float* l, float bi, int n, int ld) {
  const int i = threadIdx.x & 31;
  float y = bi;
  for (int j = 0; j < n; ++j) {
    const float yj = __shfl_sync(kFullMask, y, j) / l[j * ld + j];
    if (i == j) {
      y = yj;
    } else if (i > j && i < n) {
      y -= l[i * ld + j] * yj;
    }
  }
  float x = y;
  for (int j = n - 1; j >= 0; --j) {
    const float xj = __shfl_sync(kFullMask, x, j) / l[j * ld + j];
    if (i == j) {
      x = xj;
    } else if (i < j) {
      x -= l[j * ld + i] * xj;  // row j of L is column j of L^T
    }
  }
  return x;
}

}  // namespace amb
