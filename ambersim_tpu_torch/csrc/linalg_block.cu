// Kernels 1-3 for 32 < n <= 192: batched Cholesky factor, Cholesky solve and
// fused SPD solve, one thread block per system.
//
// Replace the n > 32 range of ambersim_tpu/ops/linalg_pallas.py:
// cholesky_batched (:319), cho_solve_batched (:324) and solve_pd_batched
// (:314), whose bodies past n = 64 are the panel-blocked factor
// _chol_columns_panel (:86-129) and substitutions _solve_from_l_panel
// (:132-175), run over narrow lane tiles of envs past n = 128 (:211-225).
// The TPU puts 32-64 envs on the lanes of one VMEM block and sweeps columns;
// here every system is a block of its own, so there is no env tile to size.
//
// What bounds them here: at the clutter scene's shapes (B = 256, n = 192) a
// factor moves 2 * B * n^2 * 4 B = 75 MB (22 us of HBM3) and does B * n^3 / 3
// = 604 MFLOP (9 us at the float32 rate); a solve moves a third of that. Both
// are far below the chain of n dependent column steps per system, each ended
// by a block barrier: the kernels are bound by that latency and by how many
// systems are in flight. At n = 192 the matrix takes 151 KB of shared memory,
// so one block fits on an SM and 256 systems run in two waves over the 132
// SMs.
//
// Design (simple and right first; a faster version is later work):
//   * the system's lower triangle is loaded row by row, coalesced, into
//     dynamic shared memory at the odd leading dimension ld = n | 1, so a
//     column walk (row i at i * ld) touches 32 different banks per warp;
//   * a right-looking column sweep: the column is scaled by 1/sqrt(max(a_jj,
//     1e-12)) into a column buffer, then the rank-1 downdate of the trailing
//     lower triangle is spread over the block, one warp per row and the lanes
//     over its columns (contiguous addresses); two barriers per column. The
//     diagonal of L goes to its own buffer, so column j's own diagonal entry
//     is never rewritten while other threads read it;
//   * forward and backward substitution by one warp over the rows in shared
//     memory (the lanes own rows i = lane + 32 k), with __syncwarp between
//     the dependent steps instead of block barriers;
//   * the contracts of the warp-per-system kernels (linalg.cu): only the
//     lower triangle is read, L is zero above the diagonal, the arithmetic is
//     that of engine/linalg.py's plain versions up to FMA contraction and
//     summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 192;

__host__ __device__ inline int ld_for(int n) { return n | 1; }

// a (n x ld), then the column buffer, the diagonal of L and the vector
__host__ __device__ inline size_t smem_floats(int n) { return (size_t)n * ld_for(n) + 3 * (size_t)n; }

__device__ inline void load_lower(float* a, const float* __restrict__ src, int n, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += kWarps)
    for (int c = lane; c <= r; c += 32) a[r * ld + c] = src[(size_t)r * n + c];
}

// In-place lower Cholesky of the lower triangle of a; the strict lower part
// of L overwrites a's, the diagonal of L goes to dg. Every thread calls it.
__device__ void block_cholesky(float* a, float* col, float* dg, int n, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    // a[j][j] is final: the downdate of column j - 1 ended at a barrier
    const float d = sqrtf(fmaxf(a[j * ld + j], 1e-12f));
    for (int i = j + threadIdx.x; i < n; i += kThreads) {
      const float c = a[i * ld + j] / d;
      col[i] = c;
      if (i == j) {
        dg[j] = c;
      } else {
        a[i * ld + j] = c;
      }
    }
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += kWarps) {
      const float ci = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32) a[i * ld + k] -= ci * col[k];
    }
    __syncthreads();
  }
}

// Solve L L^T x = b in place in y (b on entry, x on exit) from the strict
// lower part of l and the diagonal dg. Warp 0 alone calls it.
__device__ void warp_cho_solve(const float* l, const float* dg, float* y, int n, int ld) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < n; ++j) {
    __syncwarp();
    const float yj = y[j] / dg[j];
    __syncwarp();  // every lane has read y[j] before lane 0 rewrites it
    if (lane == 0) y[j] = yj;
    for (int i = j + 1 + lane; i < n; i += 32) y[i] -= l[i * ld + j] * yj;
  }
  for (int j = n - 1; j >= 0; --j) {
    __syncwarp();
    const float xj = y[j] / dg[j];
    __syncwarp();
    if (lane == 0) y[j] = xj;
    for (int i = lane; i < j; i += 32) y[i] -= l[j * ld + i] * xj;  // row j of L is column j of L^T
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) cholesky_block_kernel(const float* __restrict__ A,
                                                                  float* __restrict__ L, int n) {
  extern __shared__ float smem[];
  const int ld = ld_for(n);
  float *a = smem, *col = a + (size_t)n * ld, *dg = col + n;
  const size_t base = (size_t)blockIdx.x * n * n;
  load_lower(a, A + base, n, ld);
  block_cholesky(a, col, dg, n, ld);
  float* dst = L + base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += kWarps)
    for (int c = lane; c < n; c += 32) dst[(size_t)r * n + c] = c < r ? a[r * ld + c] : (c == r ? dg[r] : 0.f);
}

__global__ void __launch_bounds__(kThreads) cho_solve_block_kernel(const float* __restrict__ Lg,
                                                                   const float* __restrict__ b,
                                                                   float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  const int ld = ld_for(n);
  float *l = smem, *dg = l + (size_t)n * ld + n, *y = dg + n;
  const size_t base = (size_t)blockIdx.x * n * n;
  load_lower(l, Lg + base, n, ld);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    dg[i] = Lg[base + (size_t)i * n + i];
    y[i] = b[(size_t)blockIdx.x * n + i];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    warp_cho_solve(l, dg, y, n, ld);
    for (int i = threadIdx.x; i < n; i += 32) x[(size_t)blockIdx.x * n + i] = y[i];
  }
}

__global__ void __launch_bounds__(kThreads) solve_pd_block_kernel(const float* __restrict__ A,
                                                                  const float* __restrict__ b,
                                                                  float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  const int ld = ld_for(n);
  float *a = smem, *col = a + (size_t)n * ld, *dg = col + n, *y = dg + n;
  load_lower(a, A + (size_t)blockIdx.x * n * n, n, ld);
  for (int i = threadIdx.x; i < n; i += kThreads) y[i] = b[(size_t)blockIdx.x * n + i];
  block_cholesky(a, col, dg, n, ld);  // starts and ends with a barrier
  if (threadIdx.x < 32) {
    warp_cho_solve(a, dg, y, n, ld);
    for (int i = threadIdx.x; i < n; i += 32) x[(size_t)blockIdx.x * n + i] = y[i];
  }
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel; the
// launch is refused without it.
template <typename K>
cudaError_t opt_in(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)(smem_floats(kMaxN) * sizeof(float)));
  done = err == cudaSuccess;
  return err;
}

bool g_chol_opt = false, g_solve_opt = false, g_pd_opt = false;

}  // namespace

// C interface, bound with ctypes (ambersim_tpu_torch/ops/linalg.py). Each
// returns cudaGetLastError() after its launch (or the opt-in's error); the
// caller has checked shapes (32 < n <= 192, B >= 1), dtype, device and
// contiguity.
extern "C" {

int amb_cholesky_block(const float* A, float* L, int B, int n, void* stream) {
  cudaError_t err = opt_in(cholesky_block_kernel, g_chol_opt);
  if (err != cudaSuccess) return (int)err;
  cholesky_block_kernel<<<B, kThreads, smem_floats(n) * sizeof(float), (cudaStream_t)stream>>>(A, L, n);
  return (int)cudaGetLastError();
}

int amb_cho_solve_block(const float* L, const float* b, float* x, int B, int n, void* stream) {
  cudaError_t err = opt_in(cho_solve_block_kernel, g_solve_opt);
  if (err != cudaSuccess) return (int)err;
  cho_solve_block_kernel<<<B, kThreads, smem_floats(n) * sizeof(float), (cudaStream_t)stream>>>(L, b, x, n);
  return (int)cudaGetLastError();
}

int amb_solve_pd_block(const float* A, const float* b, float* x, int B, int n, void* stream) {
  cudaError_t err = opt_in(solve_pd_block_kernel, g_pd_opt);
  if (err != cudaSuccess) return (int)err;
  solve_pd_block_kernel<<<B, kThreads, smem_floats(n) * sizeof(float), (cudaStream_t)stream>>>(A, b, x, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
