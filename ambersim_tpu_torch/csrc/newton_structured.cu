// Kernel 4: the whole pyramidal Newton constraint solve on the factored
// (structured) row layout, one thread block per env.
//
// Replaces ambersim_tpu/ops/newton_pallas.py: newton_solve_structured
// (:582; kernel body _structured_kernel :374), which runs the batch on the
// TPU's lanes with every operand of a 128-512 env tile in VMEM. Numerically
// it mirrors the plain path the Pallas kernel is held to,
// _newton_arrays_jnp (ambersim_tpu/engine/solver.py:424) with
// _row_costs_pure (:207): start at the cheaper of qacc_smooth and the
// warmstart, then per iteration Huber/one-sided/equality row forces, the
// gradient M(qacc - a_s) - J^T f, the Hessian M + 1e-8 I + J^T diag(h) J, a
// Cholesky solve for the direction, an exact scalar-Newton line search
// clipped to [0, 4], and the masked improve/convergence update.
//
// Row families, in kernel row order [dense | one-hot | N+U1 | N-U1 | N+U2 |
// N-U2] (PyramidStructure in engine/constraint.py):
//   * dense rows: read from efc_J (equality, tendon friction, ...);
//   * one-hot rows dsc * e_dof (dof friction, scalar joint limits);
//   * condim-3 contacts through the basis [N, U1, U2] (efc_bJ), so the
//     contact part of J^T diag(h) J is B^T S B with 5 coefficients each.
// The per-row operands are read through `perm` (kernel row -> MuJoCo row)
// and efc_force is written back through it, in MuJoCo row order.
//
// What bounds it here: at the quadruped's shapes (nv = 18, nefc = 136,
// 28 contacts, 3 iterations x 6 line-search steps) an env reads ~9 KB once
// and then works out of shared memory, so device-memory traffic is ~40 MB
// for 4096 envs; the solve is a chain of dependent phases (row passes,
// reductions, an 18-column factorization) separated by block barriers, so
// it is bound by barrier and reduction latency, not by flops or bytes.
//
// Design: 128 threads per env, all operands in dynamic shared memory
// (~15 KB at quadruped shapes, so many blocks fit per SM and hide each
// other's barriers). Threads run over rows for J x / J^T f / row costs,
// over contacts for the basis products, over lower-triangle (v, w) pairs
// for the Hessian; warp 0 factors and solves it (csrc/linalg.cuh, nv <= 32).
// Sums are block reductions that every thread reads identically, so every
// thread takes the same take/keep decision. A non-finite line-search step
// is replaced by 0 through a select (no blend with NaN).

#include <cuda_runtime.h>

#include <math.h>

#include "linalg.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Dims {
  int nv, nefc, nd, ndiag, ncon, nd_eq, nd_ft, nfd, iterations, ls_iterations, use_ws;
};

// Shared-memory layout (floats, then ints); one definition for host and device.
struct Layout {
  int Bs, Jd, M, H, aref, D, fl, act, jar, jp, jtmp, frc, coef, dsc, as, qacc, qtmp, p, grad, mdacc, vtmp,
      red, nfloat, perm, ddof, nint;
  __host__ __device__ Layout(int nv, int nefc, int nd, int ndiag, int ncon) {
    int o = 0;
    Bs = o;    o += 3 * ncon * nv;
    Jd = o;    o += nd * nv;
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
    coef = o;  o += 5 * ncon;
    dsc = o;   o += ndiag;
    as = o;    o += nv;
    qacc = o;  o += nv;
    qtmp = o;  o += nv;
    p = o;     o += nv;
    grad = o;  o += nv;
    mdacc = o; o += nv;
    vtmp = o;  o += nv;
    red = o;   o += 2 * kWarps;
    nfloat = o;
    perm = 0;
    ddof = nefc;
    nint = nefc + ndiag;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * (size_t)nfloat + sizeof(int) * (size_t)nint; }
};

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(amb::kFullMask, v, o);
  return v;
}

// Two block-wide sums at once. Every thread returns the same values (the
// per-warp partials are combined in one fixed order).
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

// 0 = equality (two-sided quadratic), 1 = friction (Huber), 2 = one-sided.
__device__ inline int row_kind(int r, const Dims& d) {
  const bool diag_fric = r >= d.nd && r < d.nd + d.nfd;
  if ((r >= d.nd_eq && r < d.nd_eq + d.nd_ft) || diag_fric) return 1;
  return r >= d.nd_eq + d.nd_ft ? 2 : 0;
}

// _row_costs_pure for one row: force, Hessian weight (D on quadratic rows,
// else 0) and cost.
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

struct Env {
  Dims d;
  Layout L;
  float* f;
  int* ip;
  __device__ float* at(int off) const { return f + off; }
};

// out[r] = (J x)_r - sub[r] in kernel row order (sub may be null).
__device__ void jmul(const Env& e, const float* x, float* out, const float* sub) {
  const Dims& d = e.d;
  const float* Bs = e.at(e.L.Bs);
  const float* Jd = e.at(e.L.Jd);
  const float* dsc = e.at(e.L.dsc);
  const int* ddof = e.ip + e.L.ddof;
  const int base = d.nd + d.ndiag;
  for (int it = threadIdx.x; it < base + d.ncon; it += kThreads) {
    if (it < d.nd) {
      float s = 0.f;
      for (int v = 0; v < d.nv; ++v) s += Jd[it * d.nv + v] * x[v];
      out[it] = s - (sub ? sub[it] : 0.f);
    } else if (it < base) {
      const int g = it - d.nd;
      out[it] = dsc[g] * x[ddof[g]] - (sub ? sub[it] : 0.f);
    } else {
      const int c = it - base;
      const float* N = Bs + c * d.nv;
      const float* U1 = Bs + (d.ncon + c) * d.nv;
      const float* U2 = Bs + (2 * d.ncon + c) * d.nv;
      float jN = 0.f, j1 = 0.f, j2 = 0.f;
      for (int v = 0; v < d.nv; ++v) {
        jN += N[v] * x[v];
        j1 += U1[v] * x[v];
        j2 += U2[v] * x[v];
      }
      const int r0 = base + c, nc = d.ncon;
      out[r0] = jN + j1 - (sub ? sub[r0] : 0.f);
      out[r0 + nc] = jN - j1 - (sub ? sub[r0 + nc] : 0.f);
      out[r0 + 2 * nc] = jN + j2 - (sub ? sub[r0 + 2 * nc] : 0.f);
      out[r0 + 3 * nc] = jN - j2 - (sub ? sub[r0 + 3 * nc] : 0.f);
    }
  }
  __syncthreads();
}

// out = J^T f (nv).
__device__ void jtmul(const Env& e, const float* f, float* out) {
  const Dims& d = e.d;
  const float* Bs = e.at(e.L.Bs);
  const float* Jd = e.at(e.L.Jd);
  const float* dsc = e.at(e.L.dsc);
  const int* ddof = e.ip + e.L.ddof;
  const int base = d.nd + d.ndiag, nc = d.ncon;
  for (int v = threadIdx.x; v < d.nv; v += kThreads) {
    float s = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float f0 = f[base + c], f1 = f[base + nc + c], f2 = f[base + 2 * nc + c], f3 = f[base + 3 * nc + c];
      s += (f0 + f1 + f2 + f3) * Bs[c * d.nv + v] + (f0 - f1) * Bs[(nc + c) * d.nv + v] +
           (f2 - f3) * Bs[(2 * nc + c) * d.nv + v];
    }
    for (int g = 0; g < d.ndiag; ++g)
      if (ddof[g] == v) s += dsc[g] * f[d.nd + g];
    for (int r = 0; r < d.nd; ++r) s += Jd[r * d.nv + v] * f[r];
    out[v] = s;
  }
  __syncthreads();
}

// out = M x (nv).
__device__ void mmul(const Env& e, const float* x, float* out) {
  const int nv = e.d.nv;
  const float* M = e.at(e.L.M);
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float s = 0.f;
    for (int w = 0; w < nv; ++w) s += M[v * nv + w] * x[w];
    out[v] = s;
  }
  __syncthreads();
}

// 0.5 (q - a_s)^T M (q - a_s) + sum of row costs at jar.
__device__ float total_cost(const Env& e, const float* q, const float* jar) {
  const Dims& d = e.d;
  float* dacc = e.at(e.L.vtmp);
  const float* as = e.at(e.L.as);
  for (int v = threadIdx.x; v < d.nv; v += kThreads) dacc[v] = q[v] - as[v];
  __syncthreads();
  const float* M = e.at(e.L.M);
  float smooth = 0.f, rows = 0.f;
  for (int v = threadIdx.x; v < d.nv; v += kThreads) {
    float s = 0.f;
    for (int w = 0; w < d.nv; ++w) s += M[v * d.nv + w] * dacc[w];
    smooth += dacc[v] * s;
  }
  const float* D = e.at(e.L.D);
  const float* fl = e.at(e.L.fl);
  const float* act = e.at(e.L.act);
  for (int r = threadIdx.x; r < d.nefc; r += kThreads) {
    float force, h, cost;
    row_eval(jar[r], D[r], fl[r], act[r], row_kind(r, d), force, h, cost);
    rows += cost;
  }
  block_sum2(smooth, rows, e.at(e.L.red));
  return 0.5f * smooth + rows;
}

__global__ void __launch_bounds__(kThreads) newton_structured_kernel(
    const float* __restrict__ J, const float* __restrict__ bJ, const float* __restrict__ dsc_g,
    const float* __restrict__ qM, const float* __restrict__ aref_g, const float* __restrict__ D_g,
    const float* __restrict__ fl_g, const float* __restrict__ act_g, const float* __restrict__ as_g,
    const float* __restrict__ ws_g, const float* __restrict__ tol_g, const int* __restrict__ perm_g,
    const int* __restrict__ ddof_g, float* __restrict__ qacc_out, float* __restrict__ force_out,
    float* __restrict__ qfrc_out, Dims d) {
  extern __shared__ float smem[];
  const Layout L(d.nv, d.nefc, d.nd, d.ndiag, d.ncon);
  Env e{d, L, smem, reinterpret_cast<int*>(smem + L.nfloat)};
  const int tid = threadIdx.x;
  const size_t env = blockIdx.x;
  const int nv = d.nv, nefc = d.nefc;
  int* perm = e.ip + L.perm;
  int* ddof = e.ip + L.ddof;
  float *Bs = e.at(L.Bs), *Jd = e.at(L.Jd), *M = e.at(L.M), *H = e.at(L.H);
  float *aref = e.at(L.aref), *D = e.at(L.D), *fl = e.at(L.fl), *act = e.at(L.act);
  float *jar = e.at(L.jar), *jp = e.at(L.jp), *jtmp = e.at(L.jtmp), *frc = e.at(L.frc);
  float *coef = e.at(L.coef), *dsc = e.at(L.dsc), *as = e.at(L.as), *qacc = e.at(L.qacc);
  float *qtmp = e.at(L.qtmp), *p = e.at(L.p), *grad = e.at(L.grad), *mdacc = e.at(L.mdacc);
  float* vtmp = e.at(L.vtmp);

  // ---- load this env's operands ----
  for (int r = tid; r < nefc; r += kThreads) perm[r] = perm_g[r];
  for (int g = tid; g < d.ndiag; g += kThreads) {
    ddof[g] = ddof_g[g];
    dsc[g] = dsc_g[env * d.ndiag + g];
  }
  for (int k = tid; k < 3 * d.ncon * nv; k += kThreads) Bs[k] = bJ[env * 3 * d.ncon * nv + k];
  for (int k = tid; k < nv * nv; k += kThreads) M[k] = qM[env * nv * nv + k];
  for (int k = tid; k < nv; k += kThreads) {
    as[k] = as_g[env * nv + k];
    qtmp[k] = ws_g[env * nv + k];
  }
  __syncthreads();
  for (int k = tid; k < d.nd * nv; k += kThreads) {
    const int r = k / nv, v = k % nv;
    Jd[k] = J[(env * nefc + perm[r]) * nv + v];
  }
  for (int r = tid; r < nefc; r += kThreads) {
    const size_t src = env * nefc + perm[r];
    aref[r] = aref_g[src];
    D[r] = D_g[src];
    fl[r] = fl_g[src];
    act[r] = act_g[src];
  }
  const float tol = tol_g[0];
  __syncthreads();

  // ---- starting point: the cheaper of qacc_smooth and the warmstart ----
  jmul(e, as, jar, aref);
  float cost = total_cost(e, as, jar);
  for (int v = tid; v < nv; v += kThreads) qacc[v] = as[v];
  if (d.use_ws) {
    jmul(e, qtmp, jtmp, aref);
    const float cost_w = total_cost(e, qtmp, jtmp);
    if (cost_w < cost) {
      for (int v = tid; v < nv; v += kThreads) qacc[v] = qtmp[v];
      for (int r = tid; r < nefc; r += kThreads) jar[r] = jtmp[r];
      cost = cost_w;
    }
  }
  __syncthreads();

  float prev_cost = INFINITY;
  const int base = d.nd + d.ndiag, nc = d.ncon, ld = nv | 1;
  for (int it = 0; it < d.iterations; ++it) {
    // row forces and Hessian weights at jar (weights into jtmp)
    for (int r = tid; r < nefc; r += kThreads) {
      float cst;
      row_eval(jar[r], D[r], fl[r], act[r], row_kind(r, d), frc[r], jtmp[r], cst);
    }
    for (int v = tid; v < nv; v += kThreads) vtmp[v] = qacc[v] - as[v];
    __syncthreads();
    mmul(e, vtmp, mdacc);
    jtmul(e, frc, grad);
    for (int v = tid; v < nv; v += kThreads) grad[v] = mdacc[v] - grad[v];
    for (int c = tid; c < nc; c += kThreads) {
      const float h0 = jtmp[base + c], h1 = jtmp[base + nc + c];
      const float h2 = jtmp[base + 2 * nc + c], h3 = jtmp[base + 3 * nc + c];
      coef[5 * c + 0] = h0 + h1 + h2 + h3;  // N N^T
      coef[5 * c + 1] = h0 + h1;            // U1 U1^T
      coef[5 * c + 2] = h2 + h3;            // U2 U2^T
      coef[5 * c + 3] = h0 - h1;            // N U1^T + U1 N^T
      coef[5 * c + 4] = h2 - h3;            // N U2^T + U2 N^T
    }
    __syncthreads();
    // lower triangle of H = M + 1e-8 I + one-hot diagonal + B^T S B + Jd^T h Jd
    for (int k = tid; k < nv * (nv + 1) / 2; k += kThreads) {
      int v = 0;
      while ((v + 1) * (v + 2) / 2 <= k) ++v;
      const int w = k - v * (v + 1) / 2;
      float s = M[v * nv + w];
      if (v == w) {
        s += 1e-8f;
        for (int g = 0; g < d.ndiag; ++g)
          if (ddof[g] == v) s += jtmp[d.nd + g] * dsc[g] * dsc[g];
      }
      for (int c = 0; c < nc; ++c) {
        const float* N = Bs + c * nv;
        const float* U1 = Bs + (nc + c) * nv;
        const float* U2 = Bs + (2 * nc + c) * nv;
        const float* cf = coef + 5 * c;
        s += cf[0] * N[v] * N[w] + cf[1] * U1[v] * U1[w] + cf[2] * U2[v] * U2[w] +
             cf[3] * (N[v] * U1[w] + U1[v] * N[w]) + cf[4] * (N[v] * U2[w] + U2[v] * N[w]);
      }
      for (int r = 0; r < d.nd; ++r) s += jtmp[r] * Jd[r * nv + v] * Jd[r * nv + w];
      H[v * ld + w] = s;
    }
    __syncthreads();
    if (tid < 32) {
      amb::warp_cholesky(H, nv, ld);
      const float x = amb::warp_cho_solve(H, tid < nv ? grad[tid] : 0.f, nv, ld);
      if (tid < nv) p[tid] = -x;
    }
    __syncthreads();
    jmul(e, p, jp, nullptr);
    mmul(e, p, vtmp);
    float pmp = 0.f, pma = 0.f;
    for (int v = tid; v < nv; v += kThreads) {
      pmp += p[v] * vtmp[v];
      pma += p[v] * mdacc[v];
    }
    block_sum2(pmp, pma, e.at(L.red));

    // exact line search: scalar Newton on t, then clip to [0, 4]
    float t = 0.f;
    for (int ls = 0; ls < d.ls_iterations; ++ls) {
      float g = 0.f, hh = 0.f;
      for (int r = tid; r < nefc; r += kThreads) {
        float force, h, cst;
        row_eval(jar[r] + t * jp[r], D[r], fl[r], act[r], row_kind(r, d), force, h, cst);
        g += force * jp[r];
        hh += h * jp[r] * jp[r];
      }
      block_sum2(g, hh, e.at(L.red));
      g = pma + t * pmp - g;
      hh = pmp + hh;
      t = t - g / fmaxf(hh, 1e-12f);
    }
    t = isfinite(t) ? fminf(fmaxf(t, 0.f), 4.f) : 0.f;

    for (int v = tid; v < nv; v += kThreads) qtmp[v] = qacc[v] + t * p[v];
    for (int r = tid; r < nefc; r += kThreads) jtmp[r] = jar[r] + t * jp[r];
    __syncthreads();
    const float cost_n = total_cost(e, qtmp, jtmp);
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

  // ---- outputs: qacc, efc_force in MuJoCo row order, J^T f ----
  for (int r = tid; r < nefc; r += kThreads) {
    float h, cst;
    row_eval(jar[r], D[r], fl[r], act[r], row_kind(r, d), frc[r], h, cst);
    force_out[env * nefc + perm[r]] = frc[r];
  }
  __syncthreads();
  jtmul(e, frc, vtmp);
  for (int v = tid; v < nv; v += kThreads) {
    qacc_out[env * nv + v] = qacc[v];
    qfrc_out[env * nv + v] = vtmp[v];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one env needs; the wrapper refuses shapes above the
// card's per-block limit.
size_t amb_newton_smem_bytes(int nv, int nefc, int nd, int ndiag, int ncon) {
  return Layout(nv, nefc, nd, ndiag, ncon).bytes();
}

// The caller has checked shapes (1 <= nv <= 32, ncon >= 1, B >= 1), dtypes,
// device and contiguity. Returns cudaGetLastError() after the launch.
int amb_newton_structured(const float* J, const float* bJ, const float* dsc, const float* qM, const float* aref,
                          const float* D, const float* fl, const float* act, const float* a_s, const float* ws,
                          const float* tol, const int* perm, const int* diag_dofs, float* qacc, float* force,
                          float* qfrc, int B, int nv, int nefc, int nd, int ndiag, int ncon, int nd_eq, int nd_ft,
                          int nfd, int iterations, int ls_iterations, int use_ws, void* stream) {
  const Dims d{nv, nefc, nd, ndiag, ncon, nd_eq, nd_ft, nfd, iterations, ls_iterations, use_ws};
  const size_t smem = Layout(nv, nefc, nd, ndiag, ncon).bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(newton_structured_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  newton_structured_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      J, bJ, dsc, qM, aref, D, fl, act, a_s, ws, tol, perm, diag_dofs, qacc, force, qfrc, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
