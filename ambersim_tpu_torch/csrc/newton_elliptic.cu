// Kernel 6: the whole elliptic-cone Newton constraint solve, one warp per
// env, for a model whose contacts form one contiguous tail of a single
// condim (cdim in 2..6) behind nh head rows (equality, friction, limits).
//
// Replaces ambersim_tpu/ops/newton_pallas.py: newton_solve_elliptic
// (:1083; kernel body _elliptic_kernel :803), which runs the batch on the
// TPU's lanes with J of a 128-512 env tile in VMEM. Numerically it mirrors
// the plain version, engine/solver.py `_newton_arrays_elliptic` (a batched
// _newton_arrays_elliptic_jnp, JAX solver.py:624-811):
//   * rows stay in MuJoCo order, head rows then each contact's cdim rows
//     (the TPU kernel regroups them [head | N(S) | T_1(S) ...] for its
//     lanes; here a contact's lane reads its own rows where they sit);
//   * per contact, the mu-scaled circular cone (mu = mu0/sqrt(impratio) and
//     the row scale, folded by the launcher into (B, S) / (B, nfr*S)
//     planes) decides the zone: bottom if mu*N <= -T, top if N >= mu*T,
//     the projection onto the cone boundary otherwise;
//   * H = M + 1e-8 I + J_h^T diag(h) J_h + sum_s R_s^T W_s R_s, with R_s
//     the contact's cdim rows and W_s its cdim x cdim weight (JAX
//     _elliptic_W, solver.py:158);
//   * the line search is the guarded bracketed Newton on t of the closed
//     form per-contact scalars (N(t) linear, T(t)^2 quadratic), with a
//     select plus isfinite on the Newton step. The Pallas kernel blends
//     ok*tn + (1-ok)*mid (:1041-1042), which turns a non-finite tn into NaN.
//
// What bounds it here: at the elliptic quadruped's shapes (nv 18, nefc 108
// = 24 head rows + 28 contacts x cdim 3, 3 iterations x 6 line-search
// steps, B = 4096) an env reads ~9 KB once, ~40 MB for the batch (12 us at
// 3.35 TB/s); the rest is each env's chain of dependent steps (row and
// contact passes, warp sums, an 18-pivot factor and two sweeps, a square
// root per contact and line-search step), so it is bound by that chain's
// latency and by instruction issue, as kernel 4 is.
//
// Design: newton_warp.cuh's warp per env, four envs a block, no block
// barrier. Per env in shared memory (~13.7 KB at the quadruped's shapes,
// 16 envs an SM, two waves for 4096 envs): J and qM at pitch P (one
// coalesced copy each), one record per row (a contact's rows carry D = 0 when it is
// inactive, and its activity in the kind slot), the (mu, scale) planes,
// and one scratch buffer for the W blocks, then L, then the line-search
// scalars. Head rows go round-robin over lanes as in kernel 5; contact s
// goes to lane s % 32, which evaluates its zone, forces and W_s in
// registers and publishes W_s only when the contact carries weight (a
// ballot picks those). Lane v's Hessian row takes, per weighted contact,
// c_b(v) = sum_a R_a(v) W_ab and then H_vw += sum_b c_b(v) R_b(w): cdim
// FMAs an entry, on float32 pipes. The factor and sweeps are kernel 4's
// (amb::warp_factor sized to nv's tier, amb::warp_back_solve). In the line
// search a contact's scalars (a, b, c, h_bot) stay with its lane; each
// step sums the head rows' and the contacts' (phi', phi'') apart, one
// butterfly each, and joins them as the plain version does, whose
// expressions the contacts' terms follow operation for operation with no
// fused multiply-add: the bracket's Newton step can land within an ulp or
// two of the bracket's ends, where the plain version keeps stepping and a
// step rounded otherwise falls back to the midpoint, and from there a
// converged solve can end elsewhere. A divide whose dividend may be zero
// (an inactive contact's D = 0) is taken only where it is not: the IEEE
// divide's slow path on one lane holds the warp.

#include <cuda_runtime.h>

#include <math.h>

#include "newton_warp.cuh"

#ifdef AMB_ELLIPTIC_TRACE  // env AMB_ELLIPTIC_TRACE's line search printed (tools/elliptic_trace.py)
#include <cstdio>
#endif

namespace {

using amb::kEnvs;
using amb::kFullMask;
using amb::RowsLayout;
using amb::WarpRows;

constexpr int kMaxCd = 6;  // cdim <= 6
constexpr int kMaxFr = kMaxCd - 1;

struct Dims {
  int B, nv, nefc, ne, nf, nh, S, cdim, iterations, ls_iterations, use_ws;
};

// One env's layout: the extra region holds mu (S) and the nfr scale planes
// (S each); buf fits L, the W blocks (cdim^2 each) and the line-search
// scalars (4 each).
__host__ __device__ inline RowsLayout layout(int nv, int nefc, int S, int cdim) {
  return RowsLayout(nv, nefc, cdim * S, cdim * cdim * S);
}

// The contacts of one env.
struct Cones {
  int nh, S, cd;
  const float* mu;     // (S)
  const float* scale;  // (cd - 1) planes of S
  __device__ int row(int a, int s) const { return nh + s * cd + a; }  // the row of dim a of contact s
};

// a / b where `on` and a != 0, else 0: a zero dividend sends the IEEE
// divide down its slow path, and one lane there holds the warp.
__device__ inline float quot_if(bool on, float a, float b) {
  const bool divide = on && a != 0.f;
  const float q = (divide ? a : 1.f) / b;
  return divide ? q : 0.f;
}

// Zone state of a contact at jar (JAX _newton_arrays_elliptic_jnp's cone_state).
struct Cone {
  float N, T2, T, cfac, y[kMaxFr];
  bool bottom, middle;
};

template <class Jar>
__device__ inline Cone cone_state(const Cones& c, int s, float mu, Jar jar) {
  Cone z;
  z.N = jar(c.row(0, s));
  z.T2 = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxFr; ++k) {
    z.y[k] = k + 1 < c.cd ? jar(c.row(k + 1, s)) * c.scale[k * c.S + s] : 0.f;
    z.T2 += z.y[k] * z.y[k];
  }
  z.T = sqrtf(fmaxf(z.T2, 1e-24f));
  z.bottom = mu * z.N <= -z.T;
  const bool top = z.N >= mu * z.T;
  z.middle = !(z.bottom || top);
  z.cfac = (mu * z.T - z.N) / (1.f + mu * mu);
  return z;
}

// This lane's share of the cone costs at the rows' jar(r).
template <class Jar>
__device__ inline float cones_cost(const WarpRows& e, const Cones& c, Jar jar) {
  float sum = 0.f;
  for (int s = e.lane; s < c.S; s += 32) {
    const float m = c.mu[s], Dn = e.rec[c.row(0, s)].z;
    const Cone z = cone_state(c, s, m, jar);
    sum += (z.bottom ? 0.5f * Dn * (z.N * z.N + z.T2) : 0.f) +
           (z.middle ? 0.5f * Dn * z.cfac * z.cfac * (1.f + m * m) : 0.f);
  }
  return sum;
}

// The forces of a contact's cdim rows (dims past cdim get 0).
__device__ inline void cone_forces(const Cones& c, const Cone& z, int s, float mu, float Dn, float (&f)[kMaxCd]) {
  f[0] = z.bottom ? -Dn * z.N : (z.middle ? Dn * z.cfac : 0.f);
  const float cy = z.bottom ? -Dn : quot_if(z.middle, -Dn * z.cfac * mu, z.T);
#pragma unroll
  for (int k = 0; k < kMaxFr; ++k) f[k + 1] = k + 1 < c.cd ? cy * z.y[k] * c.scale[k * c.S + s] : 0.f;
}

// W_s into Ws (cdim x cdim, row-major): g_mid v v^T + curv (I - yh yh^T)
// (scale scale^T) on the friction dims in the middle zone, diag(D) in the
// bottom zone, with v = (-1, mu yh_k scale_k); index 0 is the normal row,
// 1 + k the k-th friction row (loops unrolled to cdim <= 6 so the arrays
// stay in registers).
__device__ inline void cone_weight(const WarpRows& e, const Cones& c, const Cone& z, int s, float mu, float Dn,
                                   float* Ws) {
  const int cd = c.cd;
  const float mid = z.middle ? 1.f : 0.f;
  const float g_mid = Dn / (1.f + mu * mu) * mid;
  const float curv = quot_if(z.middle, Dn * mu * z.cfac, z.T);
  float yh[kMaxCd], sc[kMaxCd], v[kMaxCd], Dd[kMaxCd];
  yh[0] = 0.f;
  sc[0] = 0.f;
  v[0] = -1.f;
  Dd[0] = Dn;
#pragma unroll
  for (int k = 0; k < kMaxFr; ++k) {
    const bool in = k + 1 < cd;
    yh[k + 1] = in ? z.y[k] / z.T : 0.f;
    sc[k + 1] = in ? c.scale[k * c.S + s] : 0.f;
    v[k + 1] = mu * yh[k + 1] * sc[k + 1];
    Dd[k + 1] = in ? e.rec[c.row(k + 1, s)].z : 0.f;
  }
#pragma unroll
  for (int a = 0; a < kMaxCd; ++a) {
#pragma unroll
    for (int b = 0; b < kMaxCd; ++b) {
      if (a >= cd || b >= cd) continue;
      float w = g_mid * v[a] * v[b];
      if (a && b) w += curv * ((a == b ? 1.f : 0.f) - yh[a] * yh[b]) * (sc[a] * sc[b]);
      if (a == b && z.bottom) w += Dd[a];
      Ws[a * cd + b] = w;
    }
  }
}

// J^T f over the contacts at jar for lane v's dof and, with kHess, the
// rank-cdim updates R_s^T W_s R_s of lane v's Hessian row. Contact s's lane
// evaluates it; a ballot picks the contacts that carry force and weight
// (an active contact in the bottom or middle zone), whose forces come by
// shuffle and W_s through buf.
template <bool kHess, int kN>
__device__ inline float cones_jtf_hessian(const WarpRows& e, const Cones& c, float (&h)[kN]) {
  const int lane = e.lane, cd = c.cd;
  const bool dof = lane < e.nv;
  float jtf = 0.f;
  for (int s0 = 0; s0 < c.S; s0 += 32) {
    const int s = s0 + lane;
    float f[kMaxCd] = {};
    bool on = false;
    if (s < c.S) {
      const float m = c.mu[s];
      const float4 n = e.rec[c.row(0, s)];
      const Cone z = cone_state(c, s, m, [&](int r) { return e.rec[r].x; });
      on = n.w > 0.5f && (z.bottom || z.middle);
      cone_forces(c, z, s, m, n.z, f);
      if (kHess && on) cone_weight(e, c, z, s, m, n.z, e.buf + s * cd * cd);
    }
    unsigned mask = __ballot_sync(kFullMask, on);
    __syncwarp();
    while (mask) {
      const int bit = __ffs(mask) - 1;
      mask &= mask - 1;
      const int cc = s0 + bit;
      float R[kMaxCd];  // R_a(v), a < cd
#pragma unroll
      for (int a = 0; a < kMaxCd; ++a) {
        if (a >= cd) break;
        R[a] = dof ? e.J[c.row(a, cc) * e.P + lane] : 0.f;
        jtf += __shfl_sync(kFullMask, f[a], bit) * R[a];
      }
      if (kHess) {
        const float* W = e.buf + cc * cd * cd;
#pragma unroll
        for (int b = 0; b < kMaxCd; ++b) {
          if (b >= cd) break;
          float cb = 0.f;
#pragma unroll
          for (int a = 0; a < kMaxCd; ++a) {
            if (a >= cd) break;
            cb += R[a] * W[a * cd + b];
          }
          amb::axpy_row<kN>(h, cb, e.J + c.row(b, cc) * e.P, e.nv);
        }
      }
    }
  }
  return jtf;
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

// Each contact's closed-form line-search scalars into buf (float4 each):
// a = |y|^2, b = y . dy, c = |dy|^2 on the scaled friction dims and
// h_bot = sum D dx^2 over its rows, from jar and jp. Like cone_line, in the
// plain version's operations and order, each product rounded before it is
// added (no fused multiply-add). Ends with __syncwarp.
__device__ inline void cones_line_prepare(const WarpRows& e, const Cones& c) {
  float4* q = reinterpret_cast<float4*>(e.buf);
  for (int s = e.lane; s < c.S; s += 32) {
    const float4 n = e.rec[c.row(0, s)];
    float a = 0.f, b = 0.f, cc = 0.f, hb = __fmul_rn(__fmul_rn(n.z, n.y), n.y);
#pragma unroll
    for (int k = 0; k < kMaxFr; ++k) {
      if (k + 1 >= c.cd) break;
      const float4 v = e.rec[c.row(k + 1, s)];
      const float sk = c.scale[k * c.S + s];
      const float y = __fmul_rn(v.x, sk), dy = __fmul_rn(v.y, sk);
      a = __fadd_rn(a, __fmul_rn(y, y));
      b = __fadd_rn(b, __fmul_rn(y, dy));
      cc = __fadd_rn(cc, __fmul_rn(dy, dy));
      hb = __fadd_rn(hb, __fmul_rn(__fmul_rn(v.z, v.y), v.y));
    }
    q[s] = make_float4(a, b, cc, hb);
  }
  __syncwarp();
}

// What a contact's line-search step reads: its normal row's record, its
// scalars (cones_line_prepare) and mu.
struct ConeLine {
  float4 n, q;
  float m;
};

__device__ inline ConeLine cone_line_data(const WarpRows& e, const Cones& c, int s) {
  return ConeLine{e.rec[c.row(0, s)], reinterpret_cast<const float4*>(e.buf)[s], c.mu[s]};
}

// One contact's phi'(t) and phi''(t) into g and hh (an inactive contact adds
// nothing: its D is 0). The plain version's expressions operation for
// operation (engine/solver.py `_newton_arrays_elliptic`), each rounded as
// it rounds them (no fused multiply-add): the bracket's decisions turn on
// the last bits of phi', so the kernel rounds it no other way than the
// sums' order forces.
__device__ inline void cone_line(const ConeLine& k, float t, float& g, float& hh) {
  const float4 n = k.n, q = k.q;
  const float Dn = n.z;
  if (Dn == 0.f) return;
  const float m = k.m, one = __fadd_rn(1.f, __fmul_rn(m, m)), dN = n.y, b = q.y, cc = q.z;
  const float ct = __fmul_rn(cc, t);
  const float T2 = __fadd_rn(__fadd_rn(q.x, __fmul_rn(__fmul_rn(2.f, b), t)), __fmul_rn(ct, t));
  const float Tt = __fsqrt_rn(fmaxf(T2, 1e-24f));
  const float Tp = quot_if(true, __fadd_rn(b, ct), Tt);
  const float Nt = __fadd_rn(n.x, __fmul_rn(t, dN));
  const float mT = __fmul_rn(m, Tt);
  const bool bot = __fmul_rn(m, Nt) <= -Tt;
  const bool mid = !(bot || Nt >= mT);
  const float cfac = __fdiv_rn(__fsub_rn(mT, Nt), one);
  const float g_b = __fmul_rn(Dn, __fadd_rn(__fadd_rn(__fmul_rn(Nt, dN), b), ct));
  const float mTp = __fmul_rn(m, Tp);
  const float g_m = __fmul_rn(__fmul_rn(-Dn, cfac), __fsub_rn(dN, mTp));
  const float dd = __fsub_rn(mTp, dN);
  const float curv = quot_if(mid, __fmul_rn(__fmul_rn(Dn, m), cfac), Tt);
  const float h_m = __fadd_rn(__fmul_rn(__fdiv_rn(Dn, one), __fmul_rn(dd, dd)),
                              __fmul_rn(curv, fmaxf(__fsub_rn(cc, __fmul_rn(Tp, Tp)), 0.f)));
  g = __fadd_rn(g, bot ? g_b : (mid ? g_m : 0.f));
  hh = __fadd_rn(hh, bot ? q.w : (mid ? h_m : 0.f));
}

// This lane's share of the contacts' phi'(t) and phi''(t), its first
// contact's data given (held in registers through a line search: at the
// paths' shapes a lane owns one contact).
__device__ inline void cones_line(const WarpRows& e, const Cones& c, const ConeLine& first, float t, float& g,
                                  float& hh) {
  if (e.lane < c.S) cone_line(first, t, g, hh);
  for (int s = e.lane + 32; s < c.S; s += 32) cone_line(cone_line_data(e, c, s), t, g, hh);
}

template <int kN>
__global__ void __launch_bounds__(kEnvs * 32, 4) newton_elliptic_kernel(
    const float* __restrict__ J_g, const float* __restrict__ qM, const float* __restrict__ aref_g,
    const float* __restrict__ D_g, const float* __restrict__ fl_g, const float* __restrict__ act_g,
    const float* __restrict__ as_g, const float* __restrict__ ws_g, const float* __restrict__ tol_g,
    const float* __restrict__ mu_g, const float* __restrict__ scale_g, float* __restrict__ qacc_out,
    float* __restrict__ force_out, float* __restrict__ qfrc_out, Dims d) {
  extern __shared__ float4 smem4[];
  const RowsLayout L = layout(d.nv, d.nefc, d.S, d.cdim);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env_id = blockIdx.x * kEnvs + warp;
  if (env_id >= d.B) return;  // whole warps exit together; no block barrier follows
#ifdef AMB_NEWTON_CLOCKS
  long long mark = clock64();
#endif
  const WarpRows e(L, reinterpret_cast<float*>(smem4) + warp * L.floats, d.nv, d.nefc, d.nh);
  const Cones c{d.nh, d.S, d.cdim, e.extra, e.extra + d.S};
  const size_t env = env_id;
  const int nv = d.nv, nefc = d.nefc, nh = d.nh, S = d.S, nfr = d.cdim - 1;

  // ---- load: J, qM and the cone planes by cp.async; row records meanwhile ----
  amb::load_rows_async(e, J_g + env * nefc * nv, qM + env * nv * nv);
  for (int k = lane; k < S; k += 32) amb::cp_async4(e.extra + k, mu_g + env * S + k);
  for (int k = lane; k < nfr * S; k += 32) amb::cp_async4(e.extra + S + k, scale_g + env * nfr * S + k);
  for (int r = lane; r < nefc; r += 32) {
    const size_t src = env * nefc + r;
    if (r < nh) {
      e.rec[r] = amb::row_record(aref_g[src], D_g[src], fl_g[src], act_g[src], amb::row_kind(r, d.ne, d.nf));
    } else {  // a contact's rows carry its normal row's activity
      const bool on = act_g[env * nefc + c.row(0, (r - nh) / d.cdim)] > 0.5f;
      e.rec[r] = make_float4(0.f, aref_g[src], on ? D_g[src] : 0.f, on ? 1.f : 0.f);
    }
  }
  const float as = lane < nv ? as_g[env * nv + lane] : 0.f;
  const float ws = lane < nv ? ws_g[env * nv + lane] : 0.f;
  const float tol = tol_g[0];
  amb::cp_async_wait_all();
  __syncwarp();
  AMB_MARK(0);

  // total cost at (q, jar + t jp), or at the warmstart's jar when `alt`
  auto cost_at = [&](float q, float t, bool alt) {
    const float cones = cones_cost(e, c, [&](int r) {
      const float4 v = e.rec[r];
      return alt ? v.y : amb::along(v.x, t, v.y);
    });
    return amb::warp_sum(amb::smooth_cost<kN>(e, q, as) + amb::head_cost(e, t, alt) + cones);
  };
  float qacc;
  float cost = amb::start_point<kN>(e, as, ws, d.use_ws, qacc, [&](float q, bool alt) { return cost_at(q, 0.f, alt); });
  AMB_MARK(1);

  float prev_cost = INFINITY;
  const int ls_iterations = d.ls_iterations > 1 ? d.ls_iterations : 1;
  for (int it = 0; it < d.iterations; ++it) {
    amb::put_vec(e.xs, nv, lane < nv ? qacc - as : 0.f);
    const float mdacc = amb::m_dot<kN>(e, e.xs);
    float h[kN];  // row v of H = M + 1e-8 I + J_h^T diag(h) J_h + sum_s R_s^T W_s R_s
    amb::hessian_start(e, h);
    float jtf = amb::head_jtf_hessian<true>(e, h);
    AMB_MARK(2);
    jtf += cones_jtf_hessian<true>(e, c, h);
    const float grad = mdacc - jtf;
    __syncwarp();  // every lane is done with the W blocks in buf
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
    cones_line_prepare(e, c);
    AMB_MARK(6);

    // guarded bracketed Newton on t in [0, 4]
    const float4 first_row = amb::first_record(e);
    const ConeLine first_cone = lane < S ? cone_line_data(e, c, lane) : ConeLine{};
    float t = 0.f, lo = 0.f, hi = 4.f;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      // phi' = (pma + t pmp - sum_head f jp) + sum_cones g, phi'' = (pmp +
      // sum_head h jp^2) + sum_cones h, summed as the plain version sums them
      float fj = 0.f, hj = 0.f, gc = 0.f, hc = 0.f;
      amb::head_line(e, first_row, t, fj, hj);
      cones_line(e, c, first_cone, t, gc, hc);
      amb::warp_sum2(fj, hj);
      amb::warp_sum2(gc, hc);
      const float g = __fadd_rn(__fsub_rn(__fadd_rn(pma, __fmul_rn(t, pmp)), fj), gc);
      const float hh = __fadd_rn(__fadd_rn(pmp, hj), hc);
#ifdef AMB_ELLIPTIC_TRACE
      if (env_id == AMB_ELLIPTIC_TRACE && lane == 0)
        printf("kernel it %d ls %d: t %.9g lo %.9g hi %.9g phi' %.9g phi'' %.9g\n", it, ls, t, lo, hi, g, hh);
#endif
      ls_bracket_step(t, lo, hi, g, hh);
    }
    t = fminf(fmaxf(t, 0.f), 4.f);
    AMB_MARK(7);

    const float qn = amb::along(qacc, t, p);
    const float cost_n = cost_at(qn, t, false);
#ifdef AMB_ELLIPTIC_TRACE
    if (env_id == AMB_ELLIPTIC_TRACE && lane == 0)
      printf("kernel it %d: t %.9g cost %.9g trial cost %.9g\n", it, t, cost, cost_n);
#endif
    amb::improve(e, t, qn, cost_n, tol, qacc, cost, prev_cost);
    AMB_MARK(8);
  }

  // ---- outputs: qacc, efc_force, J^T f ----
  for (int r = lane; r < nh; r += 32) {
    const float4 v = e.rec[r];
    float f, w;
    amb::row_eval(v.x, v.z, v.w, f, w);
    force_out[env * nefc + r] = f;
  }
  for (int s = lane; s < S; s += 32) {
    const float m = c.mu[s];
    const Cone z = cone_state(c, s, m, [&](int r) { return e.rec[r].x; });
    float f[kMaxCd];
    cone_forces(c, z, s, m, e.rec[c.row(0, s)].z, f);
#pragma unroll
    for (int a = 0; a < kMaxCd; ++a)
      if (a < d.cdim) force_out[env * nefc + c.row(a, s)] = f[a];
  }
  float unused[kN];
  const float qfrc = amb::head_jtf_hessian<false>(e, unused) + cones_jtf_hessian<false>(e, c, unused);
  if (lane < nv) {
    qacc_out[env * nv + lane] = qacc;
    qfrc_out[env * nv + lane] = qfrc;
  }
  AMB_MARK(9);
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

using Kernel = decltype(&newton_elliptic_kernel<32>);

// The instantiation whose register rows fit nv.
Kernel kernel_for(int nv) {
  const int tier = amb::row_tier(nv);
  return tier == 8 ? newton_elliptic_kernel<8> : (tier == 16 ? newton_elliptic_kernel<16> : newton_elliptic_kernel<32>);
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
size_t amb_newton_elliptic_smem_bytes(int nv, int nefc, int S, int cdim) {
  return layout(nv, nefc, S, cdim).block_bytes();
}

// Envs resident on one SM at these shapes (blocks per SM x envs per block).
int amb_newton_elliptic_occupancy(int nv, int nefc, int S, int cdim, int* envs) {
  const Kernel k = kernel_for(nv);
  const size_t smem = layout(nv, nefc, S, cdim).block_bytes();
  cudaError_t err = allow_smem(k, smem);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kEnvs * 32, smem);
  *envs = blocks * kEnvs;
  return (int)err;
}

// The caller has checked shapes (1 <= nv <= 32, S >= 1, 2 <= cdim <= 6,
// nefc = nh + S * cdim, B >= 1), dtypes, device and contiguity. Returns
// cudaGetLastError() after the launch.
int amb_newton_elliptic(const float* J, const float* qM, const float* aref, const float* D, const float* fl,
                        const float* act, const float* a_s, const float* ws, const float* tol, const float* mu,
                        const float* scale, float* qacc, float* force, float* qfrc, int B, int nv, int nefc, int ne,
                        int nf, int nh, int S, int cdim, int iterations, int ls_iterations, int use_ws, void* stream) {
  const Dims d{B, nv, nefc, ne, nf, nh, S, cdim, iterations, ls_iterations, use_ws};
  const Kernel k = kernel_for(nv);
  const size_t smem = layout(nv, nefc, S, cdim).block_bytes();
  const cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(B + kEnvs - 1) / kEnvs, kEnvs * 32, smem, (cudaStream_t)stream>>>(J, qM, aref, D, fl, act, a_s, ws, tol, mu,
                                                                         scale, qacc, force, qfrc, d);
  return (int)cudaGetLastError();
}

// in (n, 5) = (t, lo, hi, g, h), out (n, 3) = (t, lo, hi) after one step.
int amb_elliptic_ls_step(const float* in, float* out, int n, void* stream) {
  ls_step_probe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

#ifdef AMB_NEWTON_CLOCKS
// Copy kernel 6's phase clocks to out (amb::kPhases values) and zero them.
int amb_newton_elliptic_phase_clocks(long long* out) { return amb::read_phase_clocks(out); }
#endif

}  // extern "C"
