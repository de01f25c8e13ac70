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
// (16-byte vectors when the rows allow; kernel 3, like kernel 2, an
// aligned window around each system when they do not) into a per-warp
// staging buffer, hand lane i row i in registers and factor there
// (amb::warp_factor in csrc/linalg.cuh: one shuffle and one FMA per
// trailing column and pivot, no shared-memory round trip on the chain),
// writing L's columns into the buffer as they are made: kernel 1 copies it
// out; kernel 3 lays it at an odd leading dimension, carries the forward
// sweep inside the factor and sweeps back (amb::warp_back_solve).
// Kernel 2 copies the system by 16-byte loads whatever n (kernel 1's copy
// when the systems start 16-byte aligned, else an aligned window around
// each), and lane i takes 1/L_ii once. Its two sweeps are the
// TPU body's (_solve_from_l, :61): a step is a multiply by the reciprocal,
// a shuffle and one FMA, the FMA's entry of L read from shared memory off
// the chain, so no divide and no load sits on it; the copy's upper
// triangle is zeroed, so no entry above the diagonal enters the result and
// no step needs a predicate. At most 64 registers a thread, so 32 warps fit
// on an SM and the main path's 4096 systems run in one wave.
// Lanes n..31 idle: at n = 18 that is 44% of the lanes.
// Kernel 2 also takes k right-hand sides per factor, (B, k, n): system
// (e, j) is warp e k + j and reads factor e in place, so the factors are
// not copied k times in device memory (the noslip pass solves every efc row
// of J against one qM factor per env); with k = 1 it is the kernel above.
//
// The arithmetic is that of engine/linalg.py's plain versions up to FMA
// contraction, summation order and, in kernel 2, reciprocals in place of
// divisions.

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

// Copy one system (count floats at src) into the warp's buffer dst by
// 16-byte loads of the aligned window around it, whatever n and src's
// alignment: up to 3 floats before and after the system, in the 16-byte
// chunks that hold its first and last float, are read and dropped. Four
// loads a lane in flight at once (one round for n <= 22, two or three at n = 32).
__device__ inline void warp_copy_window(float* dst, const float* src, int count) {
  const int lane = threadIdx.x & 31;
  const int head = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float4* win = reinterpret_cast<const float4*>(src - head);
  const int chunks = (head + count + 3) >> 2;
  for (int c0 = 0; c0 < chunks; c0 += 4 * 32) {
    float4 v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = c0 + lane + 32 * t;
      v[t] = c < chunks ? win[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = 4 * (c0 + lane + 32 * t) - head;
      const float e[4] = {v[t].x, v[t].y, v[t].z, v[t].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (f + q >= 0 && f + q < count) dst[f + q] = e[q];
    }
  }
  __syncwarp();
}

// Solve L L^T x = b from lower factors L. Lane i holds b_i, then y_i, then
// x_i, and 1/L_ii. The copy's upper triangle is zeroed first (lane c
// clears column c above the diagonal), so that no step needs a predicate:
// step j of either sweep is lane j's unknown times 1/L_jj, shuffled to
// every lane, and one FMA with L_ij (forward) or L_ji (backward), read from
// shared memory off the chain; on the lanes already solved that entry is
// one of the zeros, and the FMA leaves them as they are. Lanes n..31 walk
// row and column n - 1 and are dropped. The loops are unrolled by 4 only,
// so the instruction stream stays short (a warp alone on an SM fetches it
// at L2 latency). A zero L_jj gives inf, and 0 x inf the plain version's
// NaNs. kWindow: the copy for systems that do not all start 16-byte
// aligned (n odd); the aligned ones take warp_copy's 16-byte stores, in an
// instantiation of their own so that neither carries the other's code.
// The B systems are right-hand sides; system sys reads factor sys / k.
template <bool kWindow>
__global__ void __launch_bounds__(kWarps * 32, 8) cho_solve_kernel(const float* __restrict__ Lg,
                                                                   const float* __restrict__ b,
                                                                   float* __restrict__ x, int B, int n, int k) {
  extern __shared__ float4 smem4[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;
  float* l = reinterpret_cast<float*>(smem4) + w * warp_floats(n);
  const int i = min(lane, n - 1);
  const float* factor = Lg + (size_t)(sys / k) * n * n;
  float y = lane < n ? b[(size_t)sys * n + lane] : 0.f;
  if constexpr (kWindow) {
    warp_copy_window(l, factor, n * n);
  } else {
    warp_copy(l, factor, n * n);
  }
  for (int k = 0; k < i; ++k) l[k * n + i] = 0.f;
  __syncwarp();
  const float inv = 1.f / l[i * n + i];
  const float* row = l + i * n;  // L_ij at row[j]
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float yj = __shfl_sync(amb::kFullMask, y * inv, j);  // y_j = (b_j - sum_k<j L_jk y_k) / L_jj
    y = lane == j ? yj : fmaf(-row[j], yj, y);
  }
#pragma unroll 4
  for (int j = n - 1; j >= 0; --j) {
    const float xj = __shfl_sync(amb::kFullMask, y * inv, j);  // x_j = (y_j - sum_k>j L_kj x_k) / L_jj
    y = lane == j ? xj : fmaf(-l[j * n + i], xj, y);
  }
  if (lane < n) x[(size_t)sys * n + lane] = y;
}

// Solve A x = b for SPD A: kernel 1's factor with the forward sweep riding
// along, then the backward sweep. kWindow as in cho_solve_kernel.
template <bool kWindow>
__global__ void __launch_bounds__(kWarps * 32, 8) solve_pd_kernel(const float* __restrict__ A,
                                                                  const float* __restrict__ b,
                                                                  float* __restrict__ x, int B, int n) {
  extern __shared__ float4 smem4[];
  const int ld = n | 1;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sys = blockIdx.x * kWarps + w;
  if (sys >= B) return;
  float* a = reinterpret_cast<float*>(smem4) + w * warp_floats(n);
  if constexpr (kWindow) {
    warp_copy_window(a, A + (size_t)sys * n * n, n * n);
  } else {
    warp_copy(a, A + (size_t)sys * n * n, n * n);
  }
  float r[amb::kMaxN];
  amb::load_rows(r, a, n, n);
  float y = lane < n ? b[(size_t)sys * n + lane] : 0.f;
  amb::warp_factor<true>(r, n, a, ld, y);  // L's rows at pitch ld over the staged copy; L y = b
  __syncwarp();
  const float xi = amb::warp_back_solve(a, y, n, ld);
  if (lane < n) x[(size_t)sys * n + lane] = xi;
}

// Whether every system of a (B, n, n) batch at p starts 16-byte aligned.
inline bool aligned_systems(const float* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (n * n) % 4 == 0;
}

inline dim3 grid_for(int B) { return dim3((B + kWarps - 1) / kWarps); }
inline size_t smem_for(int n) { return (size_t)kWarps * warp_floats(n) * sizeof(float); }

}  // namespace

// C interface, bound with ctypes (ambersim_tpu_torch/ops/linalg.py). Each
// returns cudaGetLastError() after its launch; the caller has checked
// shapes (1 <= n <= 32, B >= 1, k >= 1), dtype, device and contiguity.
extern "C" {

int amb_cholesky(const float* A, float* L, int B, int n, void* stream) {
  cholesky_kernel<<<grid_for(B), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(A, L, B, n);
  return (int)cudaGetLastError();
}

// k right-hand sides per factor: b and x are (B, k, n), L (B, n, n).
int amb_cho_solve_rhs(const float* L, const float* b, float* x, int B, int k, int n, void* stream) {
  const int systems = B * k;
  if (aligned_systems(L, n)) {
    cho_solve_kernel<false><<<grid_for(systems), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(L, b, x, systems,
                                                                                                    n, k);
  } else {
    cho_solve_kernel<true><<<grid_for(systems), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(L, b, x, systems,
                                                                                                   n, k);
  }
  return (int)cudaGetLastError();
}

int amb_cho_solve(const float* L, const float* b, float* x, int B, int n, void* stream) {
  return amb_cho_solve_rhs(L, b, x, B, 1, n, stream);
}

int amb_solve_pd(const float* A, const float* b, float* x, int B, int n, void* stream) {
  if (aligned_systems(A, n)) {
    solve_pd_kernel<false><<<grid_for(B), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(A, b, x, B, n);
  } else {
    solve_pd_kernel<true><<<grid_for(B), kWarps * 32, smem_for(n), (cudaStream_t)stream>>>(A, b, x, B, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
