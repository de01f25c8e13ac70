// Kernels 1-3: batched Cholesky factor, Cholesky solve and fused SPD solve.
//
// Replace ambersim_tpu/ops/linalg_pallas.py: cholesky_batched (_chol_kernel,
// linalg_pallas.py:188), cho_solve_batched (_cho_solve_kernel, :194) and
// solve_pd_batched (_solve_pd_kernel, :178), which put the env batch on the
// TPU's 128 lanes and sweep columns over (n, n, TILE) VMEM blocks.
//
// What bounds them here: at the main path's shapes (B = 4096, n = 18) each
// call moves ~5 MB (B*n*n floats in and out), a few microseconds of the
// card's bandwidth; the work is a chain of 2n-3n dependent steps per system,
// so they are bound by latency and by how many systems are in flight.
//
// Design: one warp per system, four systems per 128-thread block, each
// system in shared memory (n <= 32, at most 4.2 KB per warp), lane i owning
// row i (csrc/linalg.cuh). Loads and stores are coalesced over the whole
// n*n block. The warp needs only __syncwarp and shuffles, never a block
// barrier, so 4096 systems are 4096 independent warps across the SMs.
// Lanes n..31 idle: at n = 18 that is 44% of the lanes, the first thing a
// faster version would reclaim (two systems per warp).

#include <cuda_runtime.h>

#include "linalg.cuh"

namespace {

constexpr int kWarps = 4;

__device__ inline void load_matrix(float* a, const float* src, int n, int ld) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < n * n; e += 32) a[(e / n) * ld + (e % n)] = src[e];
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32) cholesky_kernel(const float* __restrict__ A,
                                                               float* __restrict__ L, int B, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;  // whole warps exit together; no block barrier follows
  float* a = smem + w * n * ld;
  load_matrix(a, A + (size_t)sys * n * n, n, ld);
  amb::warp_cholesky(a, n, ld);
  float* dst = L + (size_t)sys * n * n;
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e % n;
    dst[e] = c <= r ? a[r * ld + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kWarps * 32) cho_solve_kernel(const float* __restrict__ Lg,
                                                                const float* __restrict__ b,
                                                                float* __restrict__ x, int B, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;
  float* l = smem + w * n * ld;
  load_matrix(l, Lg + (size_t)sys * n * n, n, ld);
  const float bi = lane < n ? b[(size_t)sys * n + lane] : 0.f;
  const float xi = amb::warp_cho_solve(l, bi, n, ld);
  if (lane < n) x[(size_t)sys * n + lane] = xi;
}

__global__ void __launch_bounds__(kWarps * 32) solve_pd_kernel(const float* __restrict__ A,
                                                               const float* __restrict__ b,
                                                               float* __restrict__ x, int B, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;
  float* a = smem + w * n * ld;
  load_matrix(a, A + (size_t)sys * n * n, n, ld);
  amb::warp_cholesky(a, n, ld);
  const float bi = lane < n ? b[(size_t)sys * n + lane] : 0.f;
  const float xi = amb::warp_cho_solve(a, bi, n, ld);
  if (lane < n) x[(size_t)sys * n + lane] = xi;
}

inline dim3 grid_for(int B) { return dim3((B + kWarps - 1) / kWarps); }
inline size_t smem_for(int n) { return (size_t)kWarps * n * (n | 1) * sizeof(float); }

}  // namespace

// C interface, bound with ctypes (ambersim_tpu_torch/ops/linalg.py). Each
// returns cudaGetLastError() after its launch; the caller has checked
// shapes (1 <= n <= 32, B >= 1), dtype, device and contiguity.
extern "C" {

int amb_cholesky(const float* A, float* L, int B, int n, void* stream) {
  cholesky_kernel<<<grid_for(B), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(A, L, B, n);
  return (int)cudaGetLastError();
}

int amb_cho_solve(const float* L, const float* b, float* x, int B, int n, void* stream) {
  cho_solve_kernel<<<grid_for(B), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(L, b, x, B, n);
  return (int)cudaGetLastError();
}

int amb_solve_pd(const float* A, const float* b, float* x, int B, int n, void* stream) {
  solve_pd_kernel<<<grid_for(B), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(A, b, x, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
