// Kernel 5: the whole pyramidal Newton constraint solve on dense rows in
// MuJoCo order, one thread block per env.
//
// Replaces ambersim_tpu/ops/newton_pallas.py: newton_solve_batched (:247;
// kernel body _newton_kernel :102), which runs the batch on the TPU's lanes
// with J of a 128-512 env tile resident in VMEM. It serves every pyramidal
// model whose rows do not factor into kernel 4's layout (no condim-3
// contact: cartpole's slider limit, arm3's limits and frictionless condim-1
// contacts). Numerically it mirrors the plain version, engine/solver.py
// `_newton_arrays` (a batched _newton_arrays_jnp, JAX solver.py:424): start
// at the cheaper of qacc_smooth and the warmstart, then per iteration the
// row forces (equality rows r < ne, Huber friction rows r < ne + nf, the
// rest one-sided, as _row_masks :93), the gradient M(qacc - a_s) - J^T f,
// the Hessian M + 1e-8 I + J^T diag(h) J, a Cholesky solve for the
// direction, an exact scalar-Newton line search clipped to [0, 4] (a
// non-finite step becomes 0 through a select; the Pallas jnp.clip at :217
// lets NaN through), and the masked improve/convergence update.
//
// What bounds it here: an env reads J once (the humanoid's 169 x 25 rows
// are 17 KB) and then works out of shared memory; the solve is a chain of
// dependent phases separated by block barriers (row passes, reductions, a
// Cholesky of nv <= 32 columns), so it is bound by barrier and reduction
// latency, not by bytes or flops. At cartpole's nefc = 1, nv = 2 most of
// the 128 threads idle: the block is sized for the humanoid-class rows.
//
// Design: 128 threads per env; J, M, H and the row vectors in dynamic
// shared memory. Threads run over rows for J x and row costs, over columns
// for J^T f, over lower-triangle (v, w) pairs for J^T diag(h) J; warp 0
// factors and solves H (csrc/linalg.cuh). The factor holds its rows in 32
// registers a lane, which took the kernel from 56 to 72 registers and seven
// blocks an SM, two waves for 1024 envs; the launch bound caps it at 64 for
// eight blocks an SM (one wave on 132 SMs) at the price of a few spills.

#include <cuda_runtime.h>

#include <math.h>

#include "newton_common.cuh"

namespace {

using amb::block_sum2;
using amb::kThreads;
using amb::kWarps;

struct Dims {
  int nv, nefc, ne, nf, iterations, ls_iterations, use_ws;
};

// Shared-memory layout in floats; one definition for host and device.
struct Layout {
  int J, M, H, aref, D, fl, act, jar, jp, jtmp, frc, as, qacc, qtmp, p, grad, mdacc, vtmp, red, nfloat;
  __host__ __device__ Layout(int nv, int nefc) {
    int o = 0;
    J = o;     o += nefc * nv;
    M = o;     o += nv * nv;
    H = o;     o += nv * (nv | 1);
    aref = o;  o += nefc;
    D = o;     o += nefc;
    fl = o;    o += nefc;
    act = o;   o += nefc;
    jar = o;   o += nefc;
    jp = o;    o += nefc;
    jtmp = o;  o += nefc;
    frc = o;   o += nefc;
    as = o;    o += nv;
    qacc = o;  o += nv;
    qtmp = o;  o += nv;
    p = o;     o += nv;
    grad = o;  o += nv;
    mdacc = o; o += nv;
    vtmp = o;  o += nv;
    red = o;   o += 2 * kWarps;
    nfloat = o;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * (size_t)nfloat; }
};

// 0.5 (q - a_s)^T M (q - a_s) + sum of row costs at jar.
__device__ float total_cost(const Dims& d, const Layout& L, float* f, const float* q, const float* jar) {
  float smooth = amb::smooth_part(f + L.M, d.nv, q, f + L.as, f + L.vtmp);
  float rows = 0.f;
  for (int r = threadIdx.x; r < d.nefc; r += kThreads) {
    float force, h, cost;
    amb::row_eval(jar[r], f[L.D + r], f[L.fl + r], f[L.act + r], amb::row_kind(r, d.ne, d.nf), force, h, cost);
    rows += cost;
  }
  block_sum2(smooth, rows, f + L.red);
  return 0.5f * smooth + rows;
}

__global__ void __launch_bounds__(kThreads, 8) newton_dense_kernel(
    const float* __restrict__ J_g, const float* __restrict__ qM, const float* __restrict__ aref_g,
    const float* __restrict__ D_g, const float* __restrict__ fl_g, const float* __restrict__ act_g,
    const float* __restrict__ as_g, const float* __restrict__ ws_g, const float* __restrict__ tol_g,
    float* __restrict__ qacc_out, float* __restrict__ force_out, float* __restrict__ qfrc_out, Dims d) {
  extern __shared__ float smem[];
  const Layout L(d.nv, d.nefc);
  float* f = smem;
  const int tid = threadIdx.x;
  const size_t env = blockIdx.x;
  const int nv = d.nv, nefc = d.nefc, ld = nv | 1;
  float *J = f + L.J, *M = f + L.M, *H = f + L.H;
  float *aref = f + L.aref, *D = f + L.D, *fl = f + L.fl, *act = f + L.act;
  float *jar = f + L.jar, *jp = f + L.jp, *jtmp = f + L.jtmp, *frc = f + L.frc;
  float *as = f + L.as, *qacc = f + L.qacc, *qtmp = f + L.qtmp, *p = f + L.p;
  float *grad = f + L.grad, *mdacc = f + L.mdacc, *vtmp = f + L.vtmp;

  // ---- load this env's operands ----
  for (int k = tid; k < nefc * nv; k += kThreads) J[k] = J_g[env * nefc * nv + k];
  for (int k = tid; k < nv * nv; k += kThreads) M[k] = qM[env * nv * nv + k];
  for (int r = tid; r < nefc; r += kThreads) {
    const size_t src = env * nefc + r;
    aref[r] = aref_g[src];
    D[r] = D_g[src];
    fl[r] = fl_g[src];
    act[r] = act_g[src];
  }
  for (int k = tid; k < nv; k += kThreads) {
    as[k] = as_g[env * nv + k];
    qtmp[k] = ws_g[env * nv + k];
  }
  const float tol = tol_g[0];
  __syncthreads();

  // ---- starting point: the cheaper of qacc_smooth and the warmstart ----
  amb::dense_jmul(J, nefc, nv, as, jar, aref);
  float cost = total_cost(d, L, f, as, jar);
  for (int v = tid; v < nv; v += kThreads) qacc[v] = as[v];
  if (d.use_ws) {
    amb::dense_jmul(J, nefc, nv, qtmp, jtmp, aref);
    const float cost_w = total_cost(d, L, f, qtmp, jtmp);
    if (cost_w < cost) {
      for (int v = tid; v < nv; v += kThreads) qacc[v] = qtmp[v];
      for (int r = tid; r < nefc; r += kThreads) jar[r] = jtmp[r];
      cost = cost_w;
    }
  }
  __syncthreads();

  float prev_cost = INFINITY;
  for (int it = 0; it < d.iterations; ++it) {
    // row forces and Hessian weights at jar (weights into jtmp)
    for (int r = tid; r < nefc; r += kThreads) {
      float cst;
      amb::row_eval(jar[r], D[r], fl[r], act[r], amb::row_kind(r, d.ne, d.nf), frc[r], jtmp[r], cst);
    }
    for (int v = tid; v < nv; v += kThreads) vtmp[v] = qacc[v] - as[v];
    __syncthreads();
    amb::mmul(M, nv, vtmp, mdacc);
    amb::dense_jtmul(J, nefc, nv, frc, grad);
    for (int v = tid; v < nv; v += kThreads) grad[v] = mdacc[v] - grad[v];
    // lower triangle of H = M + 1e-8 I + J^T diag(h) J
    for (int k = tid; k < nv * (nv + 1) / 2; k += kThreads) {
      int v, w;
      amb::tri_index(k, v, w);
      float s = M[v * nv + w] + (v == w ? 1e-8f : 0.f);
      for (int r = 0; r < nefc; ++r) s += jtmp[r] * J[r * nv + v] * J[r * nv + w];
      H[v * ld + w] = s;
    }
    __syncthreads();
    amb::newton_direction(H, nv, ld, grad, p);
    amb::dense_jmul(J, nefc, nv, p, jp, nullptr);
    amb::mmul(M, nv, p, vtmp);
    float pmp = 0.f, pma = 0.f;
    for (int v = tid; v < nv; v += kThreads) {
      pmp += p[v] * vtmp[v];
      pma += p[v] * mdacc[v];
    }
    block_sum2(pmp, pma, f + L.red);

    // exact line search: scalar Newton on t, then clip to [0, 4]
    float t = 0.f;
    for (int ls = 0; ls < d.ls_iterations; ++ls) {
      float g = 0.f, hh = 0.f;
      for (int r = tid; r < nefc; r += kThreads) {
        float force, h, cst;
        amb::row_eval(jar[r] + t * jp[r], D[r], fl[r], act[r], amb::row_kind(r, d.ne, d.nf), force, h, cst);
        g += force * jp[r];
        hh += h * jp[r] * jp[r];
      }
      block_sum2(g, hh, f + L.red);
      g = pma + t * pmp - g;
      hh = pmp + hh;
      t = t - g / fmaxf(hh, 1e-12f);
    }
    t = isfinite(t) ? fminf(fmaxf(t, 0.f), 4.f) : 0.f;

    for (int v = tid; v < nv; v += kThreads) qtmp[v] = qacc[v] + t * p[v];
    for (int r = tid; r < nefc; r += kThreads) jtmp[r] = jar[r] + t * jp[r];
    __syncthreads();
    const float cost_n = total_cost(d, L, f, qtmp, jtmp);
    const bool active_it = prev_cost - cost > tol;
    const bool take = (cost_n < cost) && active_it;
    if (take) {
      for (int v = tid; v < nv; v += kThreads) qacc[v] = qtmp[v];
      for (int r = tid; r < nefc; r += kThreads) jar[r] = jtmp[r];
    }
    if (active_it) prev_cost = cost;
    if (take) cost = cost_n;
    __syncthreads();
  }

  // ---- outputs: qacc, efc_force, J^T f ----
  for (int r = tid; r < nefc; r += kThreads) {
    float h, cst;
    amb::row_eval(jar[r], D[r], fl[r], act[r], amb::row_kind(r, d.ne, d.nf), frc[r], h, cst);
    force_out[env * nefc + r] = frc[r];
  }
  __syncthreads();
  amb::dense_jtmul(J, nefc, nv, frc, vtmp);
  for (int v = tid; v < nv; v += kThreads) {
    qacc_out[env * nv + v] = qacc[v];
    qfrc_out[env * nv + v] = vtmp[v];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one env needs; the wrapper refuses shapes above the
// card's per-block limit.
size_t amb_newton_dense_smem_bytes(int nv, int nefc) { return Layout(nv, nefc).bytes(); }

// The caller has checked shapes (1 <= nv <= 32, nefc >= 1, B >= 1), dtypes,
// device and contiguity. Returns cudaGetLastError() after the launch.
int amb_newton_dense(const float* J, const float* qM, const float* aref, const float* D, const float* fl,
                     const float* act, const float* a_s, const float* ws, const float* tol, float* qacc,
                     float* force, float* qfrc, int B, int nv, int nefc, int ne, int nf, int iterations,
                     int ls_iterations, int use_ws, void* stream) {
  const Dims d{nv, nefc, ne, nf, iterations, ls_iterations, use_ws};
  const size_t smem = Layout(nv, nefc).bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(newton_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  newton_dense_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(J, qM, aref, D, fl, act, a_s, ws, tol, qacc,
                                                                   force, qfrc, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
