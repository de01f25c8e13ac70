// Block-level pieces shared by the Newton kernels 5 and 6 (newton_dense.cu,
// newton_elliptic.cu): one 128-thread block solves one env, with its
// operands in shared memory.
//
// Sums are block reductions whose per-warp partials every thread reads in
// one fixed order, so every thread of the block holds the same value and
// takes the same take/keep and line-search decisions.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

#include "linalg.cuh"

namespace amb {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Two block-wide sums at once (red holds 2 * kWarps floats). Every thread
// returns the same values.
__device__ inline void block_sum2(float& a, float& b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
    red[w] = a;
    red[kWarps + w] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int k = 0; k < kWarps; ++k) {
    a += red[k];
    b += red[kWarps + k];
  }
}

// Row kinds: 0 = equality (two-sided quadratic), 1 = friction (Huber),
// 2 = one-sided (limits, contacts).
__device__ inline int row_kind(int r, int ne, int nf) { return r < ne ? 0 : (r < ne + nf ? 1 : 2); }

// _row_costs_pure (engine/solver.py) for one row: force, Hessian weight (D
// on quadratic rows, else 0) and cost.
__device__ inline void row_eval(float jar, float D, float fl, float act, int kind, float& force, float& h,
                                float& cost) {
  const bool on = act > 0.5f;
  const float Dj = D * jar;
  const bool lin = fabsf(Dj) > fl;
  if (kind == 1) {
    const float sgn = (jar > 0.f) - (jar < 0.f);
    force = on ? (lin ? -sgn * fl : -Dj) : 0.f;
    h = (on && !lin) ? D : 0.f;
    cost = on ? (lin ? fl * fabsf(jar) - 0.5f * fl * fl / fmaxf(D, 1e-12f) : 0.5f * Dj * jar) : 0.f;
  } else {
    const bool gated = on && (kind == 0 || jar < 0.f);
    force = gated ? -Dj : 0.f;
    h = gated ? D : 0.f;
    cost = gated ? 0.5f * Dj * jar : 0.f;
  }
}

// out[r] = J_r . x - sub[r] for rows r < nrows of a dense row-major J
// (sub may be null). Ends with a barrier.
__device__ inline void dense_jmul(const float* J, int nrows, int nv, const float* x, float* out, const float* sub) {
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    float s = 0.f;
    for (int v = 0; v < nv; ++v) s += J[r * nv + v] * x[v];
    out[r] = s - (sub ? sub[r] : 0.f);
  }
  __syncthreads();
}

// out = J^T f over rows r < nrows. Ends with a barrier.
__device__ inline void dense_jtmul(const float* J, int nrows, int nv, const float* f, float* out) {
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += J[r * nv + v] * f[r];
    out[v] = s;
  }
  __syncthreads();
}

// out = M x (nv). Ends with a barrier.
__device__ inline void mmul(const float* M, int nv, const float* x, float* out) {
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float s = 0.f;
    for (int w = 0; w < nv; ++w) s += M[v * nv + w] * x[w];
    out[v] = s;
  }
  __syncthreads();
}

// This thread's share of (q - a_s)^T M (q - a_s); dacc (nv) is scratch.
// Starts with a barrier after writing dacc; the caller block-sums the result.
__device__ inline float smooth_part(const float* M, int nv, const float* q, const float* as, float* dacc) {
  for (int v = threadIdx.x; v < nv; v += kThreads) dacc[v] = q[v] - as[v];
  __syncthreads();
  float smooth = 0.f;
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float s = 0.f;
    for (int w = 0; w < nv; ++w) s += M[v * nv + w] * dacc[w];
    smooth += dacc[v] * s;
  }
  return smooth;
}

// Row v and column w of the k-th entry of a lower triangle (row-major walk).
__device__ inline void tri_index(int k, int& v, int& w) {
  v = 0;
  while ((v + 1) * (v + 2) / 2 <= k) ++v;
  w = k - v * (v + 1) / 2;
}

// Warp 0 factors H (lower triangle, leading dimension ld; L overwrites it)
// with the forward sweep for grad riding along, then sweeps back and writes
// the Newton direction p = -H^{-1} grad. Ends with a barrier.
__device__ inline void newton_direction(float* H, int nv, int ld, const float* grad, float* p) {
  if (threadIdx.x < 32) {
    float r[kMaxN];
    load_rows(r, H, nv, ld);
    float y = threadIdx.x < nv ? grad[threadIdx.x] : 0.f;
    warp_factor<true>(r, nv, H, ld, y);
    __syncwarp();
    const float x = warp_back_solve(H, y, nv, ld);
    if (threadIdx.x < nv) p[threadIdx.x] = -x;
  }
  __syncthreads();
}

}  // namespace amb
