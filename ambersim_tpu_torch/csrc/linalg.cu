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
// Design: one warp per system, four systems per 128-thread block, no
// block barrier. Kernels 1 and 3 load the system with coalesced copies
// (16-byte vectors when the rows allow) into a per-warp staging buffer,
// hand lane i row i in registers and factor there (amb::warp_factor in
// csrc/linalg.cuh: one shuffle and one FMA per trailing column and pivot,
// no shared-memory round trip on the chain), writing L's columns into the
// buffer as they are made: kernel 1 copies it out; kernel 3 lays it at an
// odd leading dimension, carries the forward sweep inside the factor and
// sweeps back (amb::warp_back_solve).
// Kernel 2 loads L with an odd leading dimension (lane i owning row i).
// Lanes n..31 idle: at n = 18 that is 44% of the lanes.

#include <cuda_runtime.h>

#include <stdint.h>

#include "linalg.cuh"

namespace {

constexpr int kWarps = 4;

// Floats of shared memory one warp's system takes: n rows of an odd leading
// dimension, rounded up to 16 bytes so that every warp's buffer is aligned.
__host__ __device__ inline int warp_floats(int n) { return (n * (n | 1) + 3) & ~3; }

// Element-wise copy of count floats within one warp, 16 bytes a lane when
// both ends and the count allow it.
__device__ inline void warp_copy(float* dst, const float* src, int count) {
  const int lane = threadIdx.x & 31;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 && (count & 3) == 0) {
    for (int e = lane; e < count / 4; e += 32)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
  } else {
    for (int e = lane; e < count; e += 32) dst[e] = src[e];
  }
  __syncwarp();
}

// Odd-ld layout for the Cholesky solve (kernel 2): lane i owns row i.
__device__ inline void load_matrix(float* a, const float* src, int n, int ld) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < n * n; e += 32) a[(e / n) * ld + (e % n)] = src[e];
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32) cholesky_kernel(const float* __restrict__ A,
                                                               float* __restrict__ L, int B, int n) {
  extern __shared__ float4 smem4[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;  // whole warps exit together; no block barrier follows
  float* a = reinterpret_cast<float*>(smem4) + w * warp_floats(n);
  warp_copy(a, A + (size_t)sys * n * n, n * n);
  float r[amb::kMaxN];
  amb::load_rows(r, a, n, n);
  for (int k = lane + 1; k < n; ++k) a[lane * n + k] = 0.f;  // L is zero above the diagonal
  float no_rhs = 0.f;
  amb::warp_factor<false>(r, n, a, n, no_rhs);
  __syncwarp();
  warp_copy(L + (size_t)sys * n * n, a, n * n);
}

__global__ void __launch_bounds__(kWarps * 32) cho_solve_kernel(const float* __restrict__ Lg,
                                                                const float* __restrict__ b,
                                                                float* __restrict__ x, int B, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;
  float* l = smem + w * warp_floats(n);
  load_matrix(l, Lg + (size_t)sys * n * n, n, ld);
  const float bi = lane < n ? b[(size_t)sys * n + lane] : 0.f;
  const float xi = amb::warp_cho_solve(l, bi, n, ld);
  if (lane < n) x[(size_t)sys * n + lane] = xi;
}

__global__ void __launch_bounds__(kWarps * 32) solve_pd_kernel(const float* __restrict__ A,
                                                               const float* __restrict__ b,
                                                               float* __restrict__ x, int B, int n) {
  extern __shared__ float4 smem4[];
  const int ld = n | 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;
  float* a = reinterpret_cast<float*>(smem4) + w * warp_floats(n);
  warp_copy(a, A + (size_t)sys * n * n, n * n);
  float r[amb::kMaxN];
  amb::load_rows(r, a, n, n);
  float y = lane < n ? b[(size_t)sys * n + lane] : 0.f;
  amb::warp_factor<true>(r, n, a, ld, y);  // L's rows at pitch ld over the staged copy; L y = b
  __syncwarp();
  const float xi = amb::warp_back_solve(a, y, n, ld);
  if (lane < n) x[(size_t)sys * n + lane] = xi;
}

inline dim3 grid_for(int B) { return dim3((B + kWarps - 1) / kWarps); }
inline size_t smem_for(int n) { return (size_t)kWarps * warp_floats(n) * sizeof(float); }

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
