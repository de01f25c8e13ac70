// Warp-level dense Cholesky factor and backward sweep for one small SPD
// system.
//
// Shared by linalg.cu (kernels 1 and 3) and the Newton kernels (4-6). One
// warp owns one n x n system (n <= 32), lane i owning row i. The factor
// keeps the row in registers (`warp_factor`, with the forward sweep of a
// solve riding along); `warp_back_solve` is the one backward sweep. Kernel
// 2 (an L already factored) has sweeps of its own in linalg.cu, which
// multiply by reciprocals of the diagonal. The arithmetic here follows the
// plain versions in ambersim_tpu_torch/engine/linalg.py (square root of
// max(a_jj, 1e-12), divide), up to FMA contraction and summation order.
#pragma once

#include <cuda_runtime.h>

namespace amb {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxN = 32;

// Lower Cholesky in registers: lane i passes row i of the lower triangle
// in r[0..i] (any value above the diagonal and on lanes i >= n; r is
// consumed) and gets row i of L in out[i * ld + 0..i]. r's length kN >= n
// is the row's register tier: kernels 1-4 pass 32 (kMaxN), kernels 5 and 6
// the tier of their nv (newton_warp.cuh's row_tier). Entries above the
// diagonal never reach L, and out's upper triangle is not written. With
// kRhs, lane i also passes b_i in b and gets y_i of L y = b back: the
// forward sweep rides along the factor, column by column (y_j = b_j / L_jj,
// then b_i -= L_ij y_j below it). Every lane of the warp must call it.
//
// At pivot j, r[k] holds column j + k. One shuffle per trailing column
// brings L_(j+k)j, and one FMA downdates the column and moves it down one
// register, so every pivot runs the same code (compile-time register
// indices in a loop that is not unrolled: a short instruction stream).
// Columns go four at a time and a group wholly past column n - 1 is
// skipped; columns past n - 1, and entries above the diagonal, may hold
// anything and are never read into L. The next pivot's own downdate is
// taken first, so the chain from pivot to pivot is one shuffle, a square
// root, a divide and an FMA.
//
// Only a nonzero entry of rows j..n-1 is divided: the IEEE divide takes a
// zero, or the stale values of the other lanes, down its slow path, and
// one lane there holds the whole warp on every pivot. a / d is a itself
// for a = +-0, and the other lanes take c = 0. The forward sweep divides
// by L_jj = piv / d on every lane (lane j's own c, bit for bit).
template <bool kRhs, int kN>
__device__ inline void warp_factor(float (&r)[kN], int n, float* out, int ld, float& b) {
  const int i = threadIdx.x & 31;
  float piv = __shfl_sync(kFullMask, r[0], 0);
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const bool live = i >= j && i < n;
    const float d = sqrtf(fmaxf(piv, 1e-12f));
    const float a = r[0];
    const bool divide = live && a != 0.f;
    const float quo = (divide ? a : 1.f) / d;
    const float c = divide ? quo : (live ? a : 0.f);  // L_ij on rows j..n-1, else 0
    if (live) out[i * ld + j] = c;
    if (kRhs) {
      const float yj = __shfl_sync(kFullMask, b, j) / (piv / d);  // y_j = b_j / L_jj
      b = i == j ? yj : (live ? fmaf(-c, yj, b) : b);
    }
    // lane j+1's diagonal after this pivot, from its own c
    piv = __shfl_sync(kFullMask, fmaf(-c, c, r[1]), j + 1);
#pragma unroll
    for (int k = 1; k < kN; k += 4) {
      if (j + k >= n) break;
#pragma unroll
      for (int q = k; q < k + 4 && q < kN; ++q) r[q - 1] = fmaf(-c, __shfl_sync(kFullMask, c, j + q), r[q]);
    }
  }
}

// Lane i's row of the lower triangle of a system in shared memory at
// leading dimension ld into r (zero above the diagonal and on lanes
// i >= n; n <= kN), for warp_factor. Ends with __syncwarp, so the caller
// may write over the system afterwards.
template <int kN>
__device__ inline void load_rows(float (&r)[kN], const float* a, int n, int ld) {
  const int i = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kN; ++k) r[k] = (k <= i && i < n) ? a[i * ld + k] : 0.f;
  __syncwarp();
}

// Solve L^T x = y by a backward column sweep, L lower at leading dimension
// ld (lane i passes y_i and gets x_i back), the loads of L off the chain.
// Every lane divides the same x_j by L_jj. Every lane must call it.
__device__ inline float warp_back_solve(const float* l, float y, int n, int ld) {
  const int i = threadIdx.x & 31;
  float x = y;
  for (int j = n - 1; j >= 0; --j) {
    const float lji = i < j ? l[j * ld + i] : 0.f;  // row j of L is column j of L^T
    const float xj = __shfl_sync(kFullMask, x, j) / l[j * ld + j];
    x = i == j ? xj : (i < j ? fmaf(-lji, xj, x) : x);
  }
  return x;
}

}  // namespace amb
