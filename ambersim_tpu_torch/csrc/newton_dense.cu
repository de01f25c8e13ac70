// Kernel 5: the whole pyramidal Newton constraint solve on dense rows in
// MuJoCo order, one warp per env.
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
// What bounds it here: at the paths' shapes (cartpole: nefc 1, nv 2, 2 x 4
// iterations; arm3: nefc 10, nv 3, 4 x 8; B = 1024) an env reads a few
// hundred bytes once, well under a microsecond of the card's bandwidth for
// the batch, and then runs a chain of dependent steps (row passes, warp
// sums, an nv-pivot factor and two sweeps per iteration, a shuffle
// butterfly per line-search step): it is bound by one env's chain and the
// launch, not by bytes or flops.
//
// Design: newton_warp.cuh's warp per env, four envs a block, no block
// barrier. Per env in shared memory: J and qM at pitch P, one record per
// row, and L. Rows go round-robin over lanes for J x, costs and the line
// search; J^T f and the rank-1 Hessian updates h_r J_r^T J_r walk only the
// rows with a nonzero force or weight (a ballot), lane v taking column v,
// on float32 pipes (TF32 would give up the digits the 1e-4 bars need). The
// Hessian's row v lives in lane v's registers, sized to nv's tier (8, 16 or
// 32 floats: one instantiation each), and amb::warp_factor factors it with
// the gradient's forward sweep riding along; amb::warp_back_solve sweeps
// back from L in shared memory.

#include <cuda_runtime.h>

#include <math.h>

#include "newton_warp.cuh"

namespace {

using amb::kEnvs;
using amb::RowsLayout;
using amb::WarpRows;

struct Dims {
  int B, nv, nefc, ne, nf, iterations, ls_iterations, use_ws;
};

template <int kN>
__global__ void __launch_bounds__(kEnvs * 32, 4) newton_dense_kernel(
    const float* __restrict__ J_g, const float* __restrict__ qM, const float* __restrict__ aref_g,
    const float* __restrict__ D_g, const float* __restrict__ fl_g, const float* __restrict__ act_g,
    const float* __restrict__ as_g, const float* __restrict__ ws_g, const float* __restrict__ tol_g,
    float* __restrict__ qacc_out, float* __restrict__ force_out, float* __restrict__ qfrc_out, Dims d) {
  extern __shared__ float4 smem4[];
  const RowsLayout L(d.nv, d.nefc, 0, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env_id = blockIdx.x * kEnvs + warp;
  if (env_id >= d.B) return;  // whole warps exit together; no block barrier follows
#ifdef AMB_NEWTON_CLOCKS
  long long mark = clock64();
#endif
  const WarpRows e(L, reinterpret_cast<float*>(smem4) + warp * L.floats, d.nv, d.nefc, d.nefc);
  const size_t env = env_id;
  const int nv = d.nv, nefc = d.nefc;

  // ---- load: J and qM by cp.async; row records meanwhile ----
  amb::load_rows_async(e, J_g + env * nefc * nv, qM + env * nv * nv);
  for (int r = lane; r < nefc; r += 32) {
    const size_t src = env * nefc + r;
    e.rec[r] = amb::row_record(aref_g[src], D_g[src], fl_g[src], act_g[src], amb::row_kind(r, d.ne, d.nf));
  }
  const float as = lane < nv ? as_g[env * nv + lane] : 0.f;
  const float ws = lane < nv ? ws_g[env * nv + lane] : 0.f;
  const float tol = tol_g[0];
  amb::cp_async_wait_all();
  __syncwarp();
  AMB_MARK(0);

  // total cost at (q, jar + t jp), or at the warmstart's jar when `alt`
  auto cost_at = [&](float q, float t, bool alt) {
    return amb::warp_sum(amb::smooth_cost<kN>(e, q, as) + amb::head_cost(e, t, alt));
  };
  float qacc;
  float cost = amb::start_point<kN>(e, as, ws, d.use_ws, qacc, [&](float q, bool alt) { return cost_at(q, 0.f, alt); });
  AMB_MARK(1);

  float prev_cost = INFINITY;
  const int ls_iterations = d.ls_iterations > 1 ? d.ls_iterations : 1;
  for (int it = 0; it < d.iterations; ++it) {
    amb::put_vec(e.xs, nv, lane < nv ? qacc - as : 0.f);
    const float mdacc = amb::m_dot<kN>(e, e.xs);
    float h[kN];  // row v of H = M + 1e-8 I + J^T diag(h) J
    amb::hessian_start(e, h);
    AMB_MARK(2);
    const float grad = mdacc - amb::head_jtf_hessian<true>(e, h);
    AMB_MARK(3);
    float y = grad;  // L y = grad rides along the factor
    amb::warp_factor<true>(h, nv, e.buf, e.ld, y);
    __syncwarp();
    AMB_MARK(4);
    const float x = amb::warp_back_solve(e.buf, y, nv, e.ld);  // every lane: the sweep shuffles
    const float p = lane < nv ? -x : 0.f;
    AMB_MARK(5);

    amb::put_vec(e.xs, nv, p);
    amb::jmul<0, kN>(e);
    float pmp = p * amb::m_dot<kN>(e, e.xs), pma = p * mdacc;
    amb::warp_sum2(pmp, pma);
    AMB_MARK(6);

    // exact line search: scalar Newton on t, then clip to [0, 4]
    const float4 first = amb::first_record(e);
    float t = 0.f;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      float g = 0.f, hh = 0.f;
      amb::head_line(e, first, t, g, hh);
      amb::warp_sum2(g, hh);
      g = pma + t * pmp - g;
      hh = pmp + hh;
      t = t - g / fmaxf(hh, 1e-12f);
    }
    t = isfinite(t) ? fminf(fmaxf(t, 0.f), 4.f) : 0.f;
    AMB_MARK(7);

    const float qn = amb::along(qacc, t, p);
    amb::improve(e, t, qn, cost_at(qn, t, false), tol, qacc, cost, prev_cost);
    AMB_MARK(8);
  }

  // ---- outputs: qacc, efc_force, J^T f ----
  for (int r = lane; r < nefc; r += 32) {
    const float4 v = e.rec[r];
    float f, w;
    amb::row_eval(v.x, v.z, v.w, f, w);
    force_out[env * nefc + r] = f;
  }
  float unused[kN];
  const float qfrc = amb::head_jtf_hessian<false>(e, unused);
  if (lane < nv) {
    qacc_out[env * nv + lane] = qacc;
    qfrc_out[env * nv + lane] = qfrc;
  }
  AMB_MARK(9);
}

using Kernel = decltype(&newton_dense_kernel<32>);

// The instantiation whose register rows fit nv.
Kernel kernel_for(int nv) {
  const int tier = amb::row_tier(nv);
  return tier == 8 ? newton_dense_kernel<8> : (tier == 16 ? newton_dense_kernel<16> : newton_dense_kernel<32>);
}

cudaError_t allow_smem(Kernel k, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block (kEnvs envs); the wrapper refuses
// shapes above the card's per-block limit.
size_t amb_newton_dense_smem_bytes(int nv, int nefc) { return RowsLayout(nv, nefc, 0, 0).block_bytes(); }

// Envs resident on one SM at these shapes (blocks per SM x envs per block).
int amb_newton_dense_occupancy(int nv, int nefc, int* envs) {
  const Kernel k = kernel_for(nv);
  const size_t smem = RowsLayout(nv, nefc, 0, 0).block_bytes();
  cudaError_t err = allow_smem(k, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kEnvs * 32, smem);
  *envs = blocks * kEnvs;
  return (int)err;
}

// The caller has checked shapes (1 <= nv <= 32, nefc >= 1, B >= 1), dtypes,
// device and contiguity. Returns cudaGetLastError() after the launch.
int amb_newton_dense(const float* J, const float* qM, const float* aref, const float* D, const float* fl,
                     const float* act, const float* a_s, const float* ws, const float* tol, float* qacc,
                     float* force, float* qfrc, int B, int nv, int nefc, int ne, int nf, int iterations,
                     int ls_iterations, int use_ws, void* stream) {
  const Dims d{B, nv, nefc, ne, nf, iterations, ls_iterations, use_ws};
  const Kernel k = kernel_for(nv);
  const size_t smem = RowsLayout(nv, nefc, 0, 0).block_bytes();
  const cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(B + kEnvs - 1) / kEnvs, kEnvs * 32, smem, (cudaStream_t)stream>>>(J, qM, aref, D, fl, act, a_s, ws, tol,
                                                                         qacc, force, qfrc, d);
  return (int)cudaGetLastError();
}

#ifdef AMB_NEWTON_CLOCKS
// Copy kernel 5's phase clocks to out (amb::kPhases values) and zero them.
int amb_newton_dense_phase_clocks(long long* out) { return amb::read_phase_clocks(out); }
#endif

}  // extern "C"
