// Kernel 6: the whole elliptic-cone Newton constraint solve, one thread
// block per env, for a model whose contacts form one contiguous tail of a
// single condim (cdim in 2..6) behind nh head rows (equality, friction,
// limits).
//
// Replaces ambersim_tpu/ops/newton_pallas.py: newton_solve_elliptic
// (:1083; kernel body _elliptic_kernel :803), which runs the batch on the
// TPU's lanes with J of a 128-512 env tile in VMEM. Numerically it mirrors
// the plain version, engine/solver.py `_newton_arrays_elliptic` (a batched
// _newton_arrays_elliptic_jnp, JAX solver.py:624-811):
//   * rows are read in kernel order [head | N(S) | T_1(S) ... T_nfr(S)]
//     through `perm` (kernel row -> MuJoCo row), and efc_force is written
//     back through it;
//   * per contact, the mu-scaled circular cone (mu = mu0/sqrt(impratio) and
//     the row scale, folded by the launcher into (B, S) / (B, nfr*S)
//     planes) decides the zone: bottom if mu*N <= -T, top if N >= mu*T,
//     the projection onto the cone boundary otherwise;
//   * H = M + 1e-8 I + J_h^T diag(h) J_h + sum_s R_s^T W_s R_s, assembled as
//     J^T JW with JW = diag(h) J_h on head rows and W_s R_s on each block;
//   * the line search is the guarded bracketed Newton on t of the closed
//     form per-contact scalars (N(t) linear, T(t)^2 quadratic), with a
//     select plus isfinite on the Newton step. The Pallas kernel blends
//     ok*tn + (1-ok)*mid (:1041-1042), which turns a non-finite tn into NaN.
//
// What bounds it here: as kernels 4 and 5, barrier and reduction latency
// (an env reads its ~8 KB of rows once and works out of shared memory).
//
// Design: 128 threads per env. Threads run over rows (J x, head costs),
// over contacts (zones, W blocks, line-search scalars), over (contact,
// column) pairs for W R and over lower-triangle (v, w) pairs for J^T JW;
// warp 0 factors and solves H. Every block sum is read in one fixed order,
// so all threads hold the same t, bracket and take/keep decision.

#include <cuda_runtime.h>

#include <math.h>

#include "newton_common.cuh"

namespace {

using amb::block_sum2;
using amb::kThreads;
using amb::kWarps;

constexpr int kMaxFr = 5;  // friction dims per cone: cdim <= 6

struct Dims {
  int nv, nefc, ne, nf, nh, S, cdim, iterations, ls_iterations, use_ws;
};

// Shared-memory layout (floats, then ints); one definition for host and device.
struct Layout {
  int J, JW, M, H, aref, D, fl, act, jar, jp, jtmp, frc, mu, scale, W, aq, bq, cq, hbot, as, qacc, qtmp, p, grad,
      mdacc, vtmp, red, nfloat, perm, nint;
  __host__ __device__ Layout(int nv, int nefc, int S, int cdim) {
    int o = 0;
    J = o;     o += nefc * nv;
    JW = o;    o += nefc * nv;
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
    mu = o;    o += S;
    scale = o; o += (cdim - 1) * S;
    W = o;     o += cdim * cdim * S;
    aq = o;    o += S;
    bq = o;    o += S;
    cq = o;    o += S;
    hbot = o;  o += S;
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
    nint = nefc;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * (size_t)nfloat + sizeof(int) * (size_t)nint; }
};

// Zone state of contact s at jar (JAX _newton_arrays_elliptic_jnp's cone_state).
struct Cone {
  float N, T2, T, cfac, y[kMaxFr];
  bool bottom, middle;
};

__device__ inline Cone cone_state(const Dims& d, const float* jar, const float* scale, float mu, int s) {
  Cone c;
  const int nfr = d.cdim - 1;
  c.N = jar[d.nh + s];
  c.T2 = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxFr; ++k) {
    c.y[k] = k < nfr ? jar[d.nh + (k + 1) * d.S + s] * scale[k * d.S + s] : 0.f;
    c.T2 += c.y[k] * c.y[k];
  }
  c.T = sqrtf(fmaxf(c.T2, 1e-24f));
  c.bottom = mu * c.N <= -c.T;
  const bool top = c.N >= mu * c.T;
  c.middle = !(c.bottom || top);
  c.cfac = (mu * c.T - c.N) / (1.f + mu * mu);
  return c;
}

// One guarded bracketed Newton step on the line-search parameter t, given
// phi'(t) = g and phi''(t) = h (engine/solver.py ls_bracket_step). A step
// outside (lo, hi), or a non-finite one, is replaced by the midpoint
// through a select, never a blend.
__device__ inline void ls_bracket_step(float& t, float& lo, float& hi, float g, float h) {
  if (g < 0.f) {
    lo = fmaxf(lo, t);
  } else {
    hi = fminf(hi, t);
  }
  const float tn = t - g / fmaxf(h, 1e-12f);
  const bool ok = tn > lo && tn < hi && isfinite(tn);
  t = ok ? tn : 0.5f * (lo + hi);
}

struct Env {
  Dims d;
  Layout L;
  float* f;
  __device__ float* at(int off) const { return f + off; }
};

// 0.5 (q - a_s)^T M (q - a_s) + head row costs + cone costs at jar.
__device__ float total_cost(const Env& e, const float* q, const float* jar) {
  const Dims& d = e.d;
  float smooth = amb::smooth_part(e.at(e.L.M), d.nv, q, e.at(e.L.as), e.at(e.L.vtmp));
  const float *D = e.at(e.L.D), *fl = e.at(e.L.fl), *act = e.at(e.L.act);
  const float *mu = e.at(e.L.mu), *scale = e.at(e.L.scale);
  float rows = 0.f;
  for (int it = threadIdx.x; it < d.nh + d.S; it += kThreads) {
    if (it < d.nh) {
      float force, h, cost;
      amb::row_eval(jar[it], D[it], fl[it], act[it], amb::row_kind(it, d.ne, d.nf), force, h, cost);
      rows += cost;
    } else {
      const int s = it - d.nh;
      const float m = mu[s], Dn = D[d.nh + s];
      const Cone c = cone_state(d, jar, scale, m, s);
      const float cost = (c.bottom ? 0.5f * Dn * (c.N * c.N + c.T2) : 0.f) +
                         (c.middle ? 0.5f * Dn * c.cfac * c.cfac * (1.f + m * m) : 0.f);
      rows += cost * act[d.nh + s];
    }
  }
  block_sum2(smooth, rows, e.at(e.L.red));
  return 0.5f * smooth + rows;
}

// Row forces at jar into frc; with hw, also the head rows' Hessian weights
// into hw and each contact's W block. Ends with a barrier.
__device__ void forces(const Env& e, const float* jar, float* frc, float* hw) {
  const Dims& d = e.d;
  const int nfr = d.cdim - 1, cd = d.cdim;
  const float *D = e.at(e.L.D), *fl = e.at(e.L.fl), *act = e.at(e.L.act);
  const float *mu = e.at(e.L.mu), *scale = e.at(e.L.scale);
  float* W = e.at(e.L.W);
  for (int it = threadIdx.x; it < d.nh + d.S; it += kThreads) {
    if (it < d.nh) {
      float h, cst;
      amb::row_eval(jar[it], D[it], fl[it], act[it], amb::row_kind(it, d.ne, d.nf), frc[it], h, cst);
      if (hw) hw[it] = h;
      continue;
    }
    const int s = it - d.nh;
    const float m = mu[s], Dn = D[d.nh + s], actN = act[d.nh + s];
    const Cone c = cone_state(d, jar, scale, m, s);
    const float fN = c.bottom ? -Dn * c.N : (c.middle ? Dn * c.cfac : 0.f);
    const float cy = c.bottom ? -Dn : (c.middle ? -Dn * c.cfac * m / c.T : 0.f);
    frc[d.nh + s] = fN * actN;
#pragma unroll
    for (int k = 0; k < kMaxFr; ++k)
      if (k < nfr) frc[d.nh + (k + 1) * d.S + s] = cy * c.y[k] * scale[k * d.S + s] * actN;
    if (!hw) continue;
    // W = g_mid v v^T + curv (I - yh yh^T) (scale scale^T) on the friction
    // dims + bottom-zone diag(D), with v = (-1, mu yh_k scale_k); index 0 is
    // the normal row, 1 + k the k-th friction row (loops unrolled to
    // cdim <= 6 so the per-contact arrays stay in registers)
    const float mid = c.middle ? actN : 0.f;
    const float g_mid = Dn / (1.f + m * m) * mid;
    const float curv = Dn * m * c.cfac / c.T * mid;
    const float bot_a = c.bottom ? actN : 0.f;
    float yh[kMaxFr + 1], sc[kMaxFr + 1], v[kMaxFr + 1];
    yh[0] = 0.f;
    sc[0] = 0.f;
    v[0] = -1.f;
#pragma unroll
    for (int k = 0; k < kMaxFr; ++k) {
      yh[k + 1] = c.y[k] / c.T;
      sc[k + 1] = k < nfr ? scale[k * d.S + s] : 0.f;
      v[k + 1] = m * yh[k + 1] * sc[k + 1];
    }
    float* Ws = W + s * cd * cd;
#pragma unroll
    for (int a = 0; a <= kMaxFr; ++a) {
#pragma unroll
      for (int b = 0; b <= kMaxFr; ++b) {
        if (a >= cd || b >= cd) continue;
        float w = g_mid * v[a] * v[b];
        if (a && b) w += curv * ((a == b ? 1.f : 0.f) - yh[a] * yh[b]) * (sc[a] * sc[b]);
        if (a == b) w += bot_a * D[d.nh + a * d.S + s];
        Ws[a * cd + b] = w;
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) newton_elliptic_kernel(
    const float* __restrict__ J_g, const float* __restrict__ qM, const float* __restrict__ aref_g,
    const float* __restrict__ D_g, const float* __restrict__ fl_g, const float* __restrict__ act_g,
    const float* __restrict__ as_g, const float* __restrict__ ws_g, const float* __restrict__ tol_g,
    const float* __restrict__ mu_g, const float* __restrict__ scale_g, const int* __restrict__ perm_g,
    float* __restrict__ qacc_out, float* __restrict__ force_out, float* __restrict__ qfrc_out, Dims d) {
  extern __shared__ float smem[];
  const Layout L(d.nv, d.nefc, d.S, d.cdim);
  Env e{d, L, smem};
  const int tid = threadIdx.x;
  const size_t env = blockIdx.x;
  const int nv = d.nv, nefc = d.nefc, nh = d.nh, S = d.S, cd = d.cdim, nfr = cd - 1, ld = nv | 1;
  int* perm = reinterpret_cast<int*>(smem + L.nfloat);
  float *J = e.at(L.J), *JW = e.at(L.JW), *M = e.at(L.M), *H = e.at(L.H);
  float *aref = e.at(L.aref), *D = e.at(L.D), *fl = e.at(L.fl), *act = e.at(L.act);
  float *jar = e.at(L.jar), *jp = e.at(L.jp), *jtmp = e.at(L.jtmp), *frc = e.at(L.frc);
  float *mu = e.at(L.mu), *scale = e.at(L.scale), *W = e.at(L.W);
  float *aq = e.at(L.aq), *bq = e.at(L.bq), *cq = e.at(L.cq), *hbot = e.at(L.hbot);
  float *as = e.at(L.as), *qacc = e.at(L.qacc), *qtmp = e.at(L.qtmp), *p = e.at(L.p);
  float *grad = e.at(L.grad), *mdacc = e.at(L.mdacc), *vtmp = e.at(L.vtmp);

  // ---- load this env's operands, rows in kernel order ----
  for (int r = tid; r < nefc; r += kThreads) perm[r] = perm_g[r];
  for (int k = tid; k < nv * nv; k += kThreads) M[k] = qM[env * nv * nv + k];
  for (int k = tid; k < nv; k += kThreads) {
    as[k] = as_g[env * nv + k];
    qtmp[k] = ws_g[env * nv + k];
  }
  for (int k = tid; k < S; k += kThreads) mu[k] = mu_g[env * S + k];
  for (int k = tid; k < nfr * S; k += kThreads) scale[k] = scale_g[env * nfr * S + k];
  __syncthreads();
  for (int k = tid; k < nefc * nv; k += kThreads) {
    const int r = k / nv, v = k % nv;
    J[k] = J_g[(env * nefc + perm[r]) * nv + v];
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
  amb::dense_jmul(J, nefc, nv, as, jar, aref);
  float cost = total_cost(e, as, jar);
  for (int v = tid; v < nv; v += kThreads) qacc[v] = as[v];
  if (d.use_ws) {
    amb::dense_jmul(J, nefc, nv, qtmp, jtmp, aref);
    const float cost_w = total_cost(e, qtmp, jtmp);
    if (cost_w < cost) {
      for (int v = tid; v < nv; v += kThreads) qacc[v] = qtmp[v];
      for (int r = tid; r < nefc; r += kThreads) jar[r] = jtmp[r];
      cost = cost_w;
    }
  }
  __syncthreads();

  float prev_cost = INFINITY;
  for (int it = 0; it < d.iterations; ++it) {
    // forces, head Hessian weights (into jtmp) and W blocks at jar
    forces(e, jar, frc, jtmp);
    for (int v = tid; v < nv; v += kThreads) vtmp[v] = qacc[v] - as[v];
    __syncthreads();
    amb::mmul(M, nv, vtmp, mdacc);
    amb::dense_jtmul(J, nefc, nv, frc, grad);
    for (int v = tid; v < nv; v += kThreads) grad[v] = mdacc[v] - grad[v];
    // JW: diag(h) J on head rows, W_s R_s on each cone block
    for (int k = tid; k < nh * nv; k += kThreads) JW[k] = jtmp[k / nv] * J[k];
    for (int k = tid; k < S * nv; k += kThreads) {
      const int s = k / nv, v = k % nv;
      const float* Ws = W + s * cd * cd;
      for (int a = 0; a < cd; ++a) {
        float acc = 0.f;
        for (int b = 0; b < cd; ++b) acc += Ws[a * cd + b] * J[(nh + b * S + s) * nv + v];
        JW[(nh + a * S + s) * nv + v] = acc;
      }
    }
    __syncthreads();
    // lower triangle of H = M + 1e-8 I + J^T JW
    for (int k = tid; k < nv * (nv + 1) / 2; k += kThreads) {
      int v, w;
      amb::tri_index(k, v, w);
      float s = M[v * nv + w] + (v == w ? 1e-8f : 0.f);
      for (int r = 0; r < nefc; ++r) s += J[r * nv + v] * JW[r * nv + w];
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
    // closed-form line-search scalars per contact
    for (int s = tid; s < S; s += kThreads) {
      const float dN = jp[nh + s];
      float a = 0.f, b = 0.f, c = 0.f, hb = D[nh + s] * dN * dN;
      for (int k = 0; k < nfr; ++k) {
        const int r = nh + (k + 1) * S + s;
        const float sk = scale[k * S + s];
        const float y = jar[r] * sk, dy = jp[r] * sk;
        a += y * y;
        b += y * dy;
        c += dy * dy;
        hb += D[r] * jp[r] * jp[r];
      }
      aq[s] = a;
      bq[s] = b;
      cq[s] = c;
      hbot[s] = hb;
    }
    block_sum2(pmp, pma, e.at(L.red));  // its barriers also publish aq..hbot

    float t = 0.f, lo = 0.f, hi = 4.f;
    for (int ls = 0; ls < d.ls_iterations; ++ls) {
      float g = 0.f, hh = 0.f;
      for (int i = tid; i < nh + S; i += kThreads) {
        if (i < nh) {
          float force, h, cst;
          amb::row_eval(jar[i] + t * jp[i], D[i], fl[i], act[i], amb::row_kind(i, d.ne, d.nf), force, h, cst);
          g -= force * jp[i];
          hh += h * jp[i] * jp[i];
          continue;
        }
        const int s = i - nh;
        const float m = mu[s], one = 1.f + m * m, Dn = D[nh + s], actN = act[nh + s];
        const float dN = jp[nh + s], b = bq[s], c = cq[s];
        const float Tt = sqrtf(fmaxf(aq[s] + 2.f * b * t + c * t * t, 1e-24f));
        const float Tp = (b + c * t) / Tt;
        const float Nt = jar[nh + s] + t * dN;
        const bool bot = m * Nt <= -Tt;
        const bool mid = !(bot || Nt >= m * Tt);
        const float cfac = (m * Tt - Nt) / one;
        const float g_b = Dn * (Nt * dN + b + c * t);
        const float g_m = -Dn * cfac * (dN - m * Tp);
        const float dd = m * Tp - dN;
        const float h_m = Dn / one * dd * dd + Dn * m * cfac / Tt * fmaxf(c - Tp * Tp, 0.f);
        g += (bot ? g_b : (mid ? g_m : 0.f)) * actN;
        hh += (bot ? hbot[s] : (mid ? h_m : 0.f)) * actN;
      }
      block_sum2(g, hh, e.at(L.red));
      ls_bracket_step(t, lo, hi, pma + t * pmp + g, pmp + hh);
    }
    t = fminf(fmaxf(t, 0.f), 4.f);

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
  forces(e, jar, frc, nullptr);
  for (int r = tid; r < nefc; r += kThreads) force_out[env * nefc + perm[r]] = frc[r];
  amb::dense_jtmul(J, nefc, nv, frc, vtmp);
  for (int v = tid; v < nv; v += kThreads) {
    qacc_out[env * nv + v] = qacc[v];
    qfrc_out[env * nv + v] = vtmp[v];
  }
}

// Applies ls_bracket_step to n independent (t, lo, hi, g, h) states: a
// probe of the line-search step kernel 6 runs, for the checks of its
// non-finite handling. out holds (t, lo, hi) per state.
__global__ void ls_step_probe_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = in[5 * i], lo = in[5 * i + 1], hi = in[5 * i + 2];
  ls_bracket_step(t, lo, hi, in[5 * i + 3], in[5 * i + 4]);
  out[3 * i] = t;
  out[3 * i + 1] = lo;
  out[3 * i + 2] = hi;
}

}  // namespace

extern "C" {

// Dynamic shared memory one env needs; the wrapper refuses shapes above the
// card's per-block limit.
size_t amb_newton_elliptic_smem_bytes(int nv, int nefc, int S, int cdim) { return Layout(nv, nefc, S, cdim).bytes(); }

// The caller has checked shapes (1 <= nv <= 32, S >= 1, 2 <= cdim <= 6,
// nefc = nh + S * cdim, B >= 1), dtypes, device and contiguity. Returns
// cudaGetLastError() after the launch.
int amb_newton_elliptic(const float* J, const float* qM, const float* aref, const float* D, const float* fl,
                        const float* act, const float* a_s, const float* ws, const float* tol, const float* mu,
                        const float* scale, const int* perm, float* qacc, float* force, float* qfrc, int B, int nv,
                        int nefc, int ne, int nf, int nh, int S, int cdim, int iterations, int ls_iterations,
                        int use_ws, void* stream) {
  const Dims d{nv, nefc, ne, nf, nh, S, cdim, iterations, ls_iterations, use_ws};
  const size_t smem = Layout(nv, nefc, S, cdim).bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(newton_elliptic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  newton_elliptic_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(J, qM, aref, D, fl, act, a_s, ws, tol, mu,
                                                                      scale, perm, qacc, force, qfrc, d);
  return (int)cudaGetLastError();
}

// in (n, 5) = (t, lo, hi, g, h), out (n, 3) = (t, lo, hi) after one step.
int amb_elliptic_ls_step(const float* in, float* out, int n, void* stream) {
  ls_step_probe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
