// Kernel 4: the whole pyramidal Newton constraint solve on the factored
// (structured) row layout, one warp per env.
//
// Replaces ambersim_tpu/ops/newton_pallas.py: newton_solve_structured
// (:582; kernel body _structured_kernel :374, Hessian :492), which runs the
// batch on the TPU's lanes with every operand of a 128-512 env tile in
// VMEM. Numerically it mirrors the plain path the Pallas kernel is held to,
// _newton_arrays (ambersim_tpu_torch/engine/solver.py; the JAX package's
// _newton_arrays_jnp, solver.py:424, with _row_costs_pure, :207): start at
// the cheaper of qacc_smooth and the warmstart, then per iteration
// Huber/one-sided/equality row forces, the gradient M(qacc - a_s) - J^T f,
// the Hessian M + 1e-8 I + J^T diag(h) J, a Cholesky solve for the
// direction, an exact scalar-Newton line search clipped to [0, 4] (a
// non-finite step selected to 0), and the masked improve/convergence
// update; efc_force goes back through `perm` in MuJoCo row order.
//
// Row families, in kernel row order [dense | one-hot | N+U1 | N-U1 | N+U2 |
// N-U2] (PyramidStructure in engine/constraint.py):
//   * dense rows: read from efc_J (equality, tendon friction, ...);
//   * one-hot rows dsc * e_dof (dof friction, scalar joint limits);
//   * condim-3 contacts through the basis [N, U1, U2] (efc_bJ), so the
//     contact part of J^T diag(h) J is B^T S B with 5 coefficients each.
//
// What bounds it here: at the quadruped's shapes (nv = 18, nefc = 136,
// 28 contacts, 3 iterations x 6 line-search steps) an env reads ~9 KB once,
// ~40 MB for 4096 envs (12 us at 3.35 TB/s); the rest is each env's chain
// of dependent phases (row passes, reductions, an 18-pivot factor and two
// sweeps), so it is bound by that chain's latency and by instruction
// issue, not by flops or bytes.
//
// Design: one warp per env, lane v owning dof v (nv <= 32), four envs per
// 128-thread block, no block barrier (only __syncwarp). Sums over lanes are
// __shfl_xor_sync butterflies, which leave the same bits in every lane, so
// every lane takes the same take/keep and line-search decisions.
//   * Per env in shared memory (~13 KB at the quadruped's shapes: 16 envs
//     an SM, so 4096 envs take two waves): qM, the basis rows and the dense
//     rows at a pitch P (nv rounded up to 4 floats, P/4 odd: 16-byte
//     aligned broadcast reads, and lane c reading its own contact's row
//     with no bank conflict), one float4 record {jar, jp, D, kind} per row
//     (ceil(nefc/32) rows a lane; an inactive row carries D = 0, and the
//     kind, decided once, rides in the frictionloss slot: >= 0 Huber with
//     that frictionloss, -1 equality, -3 one-sided), and a scratch buffer.
//     The Hessian's row v lives in lane v's registers (compile-time
//     indices).
//   * J^T f and the Hessian walk only the contacts with a nonzero force or
//     weight (a ballot), with f's and h's four pyramid rows folded first;
//     the Hessian per contact is the rank-3 update H_vw += a_v N_w + b_v
//     U1_w + c_v U2_w (a = c0 N + c3 U1 + c4 U2, b = c3 N + c1 U1,
//     c = c4 N + c2 U2): 3 FMAs per entry, on float32 pipes (TF32 would
//     give up the digits the 1e-4 bars need).
//   * The factor is amb::warp_factor on the Hessian rows in registers,
//     with the forward sweep for the gradient riding along; L goes to the
//     scratch buffer for the backward sweep (amb::warp_back_solve).
//   * Loads: the basis, dense rows and qM by cp.async, in flight while the
//     row operands are gathered through perm.

#include <cuda_runtime.h>

#include <math.h>

#include "newton_warp.cuh"

namespace {

using amb::kEnvs;
using amb::kFullMask;
using amb::kKindEq;
using amb::kKindOneSided;
using amb::kMaxN;
using amb::round4;
using amb::store_row;
using amb::warp_sum;
using amb::warp_sum2;

constexpr int kGroups = kMaxN / 4;    // float4 groups of a row of dofs

struct Dims {
  int B, nv, nefc, nd, ndiag, ncon, nd_eq, nd_ft, nfd, iterations, ls_iterations, use_ws;
};

// Shared-memory layout of one env, in 4-byte words (each region 16-byte
// aligned; ddof holds ints). One definition for host and device.
struct Layout {
  int P, ld, R, Bs, Jd, M, rec, buf, cf, dsc, xs, xw, ddof, floats;
  __host__ __device__ Layout(int nv, int nefc, int nd, int ndiag, int ncon) {
    P = amb::row_pitch(nv);
    ld = nv | 1;
    R = (nefc + 31) / 32;
    int o = 0;
    Bs = o;   o += 3 * ncon * P;
    Jd = o;   o += nd * P;
    M = o;    o += nv * P;
    rec = o;  o += 4 * 32 * R;                                           // row records, padded to 32 R
    buf = o;  o += round4(nv * ld > 64 * R ? nv * ld : 64 * R);          // (force, h) per row, or L
    cf = o;   o += 8 * ncon;                                             // per contact: 5 weights, 3 forces
    dsc = o;  o += round4(ndiag);
    xs = o;   o += P;
    xw = o;   o += P;
    ddof = o; o += round4(ndiag);
    floats = o;
  }
  __host__ __device__ size_t env_bytes() const { return sizeof(float) * (size_t)floats; }
};

// Row kind in kernel row order: 0 = equality, 1 = friction (Huber),
// 2 = one-sided.
__device__ inline int row_kind(int r, const Dims& d) {
  const bool diag_fric = r >= d.nd && r < d.nd + d.nfd;
  if ((r >= d.nd_eq && r < d.nd_eq + d.nd_ft) || diag_fric) return 1;
  return r >= d.nd_eq + d.nd_ft ? 2 : 0;
}

struct Env {
  Dims d;
  Layout L;
  float* Bs;
  float* Jd;
  float* M;
  float4* rec;
  float* buf;
  float* cf;
  float* dsc;
  float* xs;
  float* xw;
  int* ddof;
  int lane;
};

// (M x)_v for lane v's dof (lanes past nv read row 0), x a broadcast
// vector; M's and x's padding are zero.
__device__ inline float m_dot(const Env& e, const float* x) {
  const float4* m = reinterpret_cast<const float4*>(e.M + (e.lane < e.d.nv ? e.lane : 0) * e.L.P);
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (4 * g >= e.d.nv) break;
    const float4 a = m[g], v = reinterpret_cast<const float4*>(x)[g];
    s = fmaf(a.x, v.x, s);
    s = fmaf(a.y, v.y, s);
    s = fmaf(a.z, v.z, s);
    s = fmaf(a.w, v.w, s);
  }
  return s;
}

// Products of J with xs (and xw in mode 2) for every row, by family; lane c
// takes contact c's four rows. Ends with __syncwarp.
template <int kMode>
__device__ void jmul(const Env& e) {
  const Dims& d = e.d;
  const int lane = e.lane, P = e.L.P, nc = d.ncon, base = d.nd + d.ndiag;
  const float4* x4 = reinterpret_cast<const float4*>(e.xs);
  const float4* w4 = reinterpret_cast<const float4*>(e.xw);
  for (int c = lane; c < nc; c += 32) {
    const float4* N = reinterpret_cast<const float4*>(e.Bs + c * P);
    const float4* U1 = reinterpret_cast<const float4*>(e.Bs + (nc + c) * P);
    const float4* U2 = reinterpret_cast<const float4*>(e.Bs + (2 * nc + c) * P);
    float jN = 0.f, j1 = 0.f, j2 = 0.f, kN = 0.f, k1 = 0.f, k2 = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (4 * g >= d.nv) break;
      const float4 n = N[g], u = U1[g], w = U2[g], x = x4[g];
      jN += n.x * x.x + n.y * x.y + n.z * x.z + n.w * x.w;
      j1 += u.x * x.x + u.y * x.y + u.z * x.z + u.w * x.w;
      j2 += w.x * x.x + w.y * x.y + w.z * x.z + w.w * x.w;
      if (kMode == 2) {
        const float4 y = w4[g];
        kN += n.x * y.x + n.y * y.y + n.z * y.z + n.w * y.w;
        k1 += u.x * y.x + u.y * y.y + u.z * y.z + u.w * y.w;
        k2 += w.x * y.x + w.y * y.y + w.z * y.z + w.w * y.w;
      }
    }
    const int r0 = base + c;
    store_row<kMode>(e.rec, r0, jN + j1, kN + k1);
    store_row<kMode>(e.rec, r0 + nc, jN - j1, kN - k1);
    store_row<kMode>(e.rec, r0 + 2 * nc, jN + j2, kN + k2);
    store_row<kMode>(e.rec, r0 + 3 * nc, jN - j2, kN - k2);
  }
  for (int g = lane; g < d.ndiag; g += 32) {
    const int v = e.ddof[g];
    store_row<kMode>(e.rec, d.nd + g, e.dsc[g] * e.xs[v], kMode == 2 ? e.dsc[g] * e.xw[v] : 0.f);
  }
  for (int r = lane; r < d.nd; r += 32) {
    const float4* J = reinterpret_cast<const float4*>(e.Jd + r * P);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (4 * g >= d.nv) break;
      const float4 j = J[g], x = x4[g];
      a += j.x * x.x + j.y * x.y + j.z * x.z + j.w * x.w;
      if (kMode == 2) {
        const float4 y = w4[g];
        b += j.x * y.x + j.y * y.y + j.z * y.z + j.w * y.w;
      }
    }
    store_row<kMode>(e.rec, r, a, b);
  }
  __syncwarp();
}

// 0.5 (q - a_s)^T M (q - a_s) + sum of row costs at jar + t jp (at jar_w,
// the jp slot, when `alt`), the same in every lane.
__device__ float total_cost(const Env& e, float q, float as, float t, bool alt) {
  const float dacc = e.lane < e.d.nv ? q - as : 0.f;
  amb::put_vec(e.xs, e.d.nv, dacc);
  float s = 0.5f * dacc * m_dot(e, e.xs);
#pragma unroll 4
  for (int k = 0; k < e.L.R; ++k) {
    const float4 r = e.rec[e.lane + 32 * k];
    s += amb::row_cost(alt ? r.y : amb::along(r.x, t, r.y), r.z, r.w);
  }
  return warp_sum(s);
}

// Forces and Hessian weights at jar: (force, h) per row into buf, then the
// contacts' folded weights and forces into cf. Ends with __syncwarp.
__device__ void forces_at_jar(const Env& e) {
  float2* fh = reinterpret_cast<float2*>(e.buf);
#pragma unroll 4
  for (int k = 0; k < e.L.R; ++k) {
    const int r = e.lane + 32 * k;
    const float4 v = e.rec[r];
    float f, h;
    amb::row_eval(v.x, v.z, v.w, f, h);
    fh[r] = make_float2(f, h);
  }
  __syncwarp();
  const int nc = e.d.ncon, base = e.d.nd + e.d.ndiag;
  for (int c = e.lane; c < nc; c += 32) {
    const float2 a = fh[base + c], b = fh[base + nc + c], g = fh[base + 2 * nc + c], h = fh[base + 3 * nc + c];
    float4* out = reinterpret_cast<float4*>(e.cf + 8 * c);
    out[0] = make_float4(a.y + b.y + g.y + h.y, a.y + b.y, g.y + h.y, a.y - b.y);  // N N, U1 U1, U2 U2, N U1
    out[1] = make_float4(g.y - h.y, a.x + b.x + g.x + h.x, a.x - b.x, g.x - h.x);  // N U2; forces on N, U1, U2
  }
  __syncwarp();
}

// J^T f at jar for lane v's dof and, with kHess, the Hessian's row v
// (h holds M's row on entry). forces_at_jar has run.
template <bool kHess>
__device__ float jtf_hessian(const Env& e, float (&h)[kMaxN]) {
  const Dims& d = e.d;
  const int lane = e.lane, P = e.L.P, nc = d.ncon;
  const bool dof = lane < d.nv;
  const float2* fh = reinterpret_cast<const float2*>(e.buf);
  const float4* cf4 = reinterpret_cast<const float4*>(e.cf);
  float jtf = 0.f, hdiag = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int c = c0 + lane;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (c < nc) {
      a = cf4[2 * c];
      b = cf4[2 * c + 1];
    }
    // a contact with all four weights zero has a == b.x == 0 (the weights are D >= 0 or 0)
    const unsigned hmask = __ballot_sync(kFullMask, kHess && (a.y != 0.f || a.z != 0.f || a.w != 0.f || b.x != 0.f));
    unsigned mask = hmask | __ballot_sync(kFullMask, b.y != 0.f || b.z != 0.f || b.w != 0.f);
    while (mask) {
      const int bit = __ffs(mask) - 1;
      mask &= mask - 1;
      const int cc = c0 + bit;
      const float4 ca = cf4[2 * cc], cb = cf4[2 * cc + 1];
      const float* N = e.Bs + cc * P;
      const float* U1 = e.Bs + (nc + cc) * P;
      const float* U2 = e.Bs + (2 * nc + cc) * P;
      const float n = dof ? N[lane] : 0.f, u1 = dof ? U1[lane] : 0.f, u2 = dof ? U2[lane] : 0.f;
      jtf += cb.y * n + cb.z * u1 + cb.w * u2;
      if (kHess && ((hmask >> bit) & 1u)) {
        const float av = ca.x * n + ca.w * u1 + cb.x * u2;
        const float bv = ca.w * n + ca.y * u1;
        const float cv = cb.x * n + ca.z * u2;
        const float4* N4 = reinterpret_cast<const float4*>(N);
        const float4* V4 = reinterpret_cast<const float4*>(U1);
        const float4* W4 = reinterpret_cast<const float4*>(U2);
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (4 * g >= d.nv) break;
          const float4 x = N4[g], y = V4[g], z = W4[g];
          h[4 * g] += av * x.x + bv * y.x + cv * z.x;
          h[4 * g + 1] += av * x.y + bv * y.y + cv * z.y;
          h[4 * g + 2] += av * x.z + bv * y.z + cv * z.z;
          h[4 * g + 3] += av * x.w + bv * y.w + cv * z.w;
        }
      }
    }
  }
#pragma unroll 4
  for (int g = 0; g < d.ndiag; ++g) {
    const float2 v = fh[d.nd + g];
    const float s = e.dsc[g];
    if (lane == e.ddof[g]) {
      jtf += s * v.x;
      hdiag += v.y * s * s;
    }
  }
  for (int r = 0; r < d.nd; ++r) {
    const float2 v = fh[r];
    const float* J = e.Jd + r * P;
    const float jv = dof ? J[lane] : 0.f;
    jtf += jv * v.x;
    if (kHess && v.y != 0.f) {
      const float gv = v.y * jv;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (4 * g >= d.nv) break;
        const float4 x = reinterpret_cast<const float4*>(J)[g];
        h[4 * g] += gv * x.x;
        h[4 * g + 1] += gv * x.y;
        h[4 * g + 2] += gv * x.z;
        h[4 * g + 3] += gv * x.w;
      }
    }
  }
  if (kHess) {
#pragma unroll
    for (int w = 0; w < kMaxN; ++w)
      if (w == lane) h[w] += hdiag;
  }
  return jtf;
}

__global__ void __launch_bounds__(kEnvs * 32, 4) newton_structured_kernel(
    const float* __restrict__ J, const float* __restrict__ bJ, const float* __restrict__ dsc_g,
    const float* __restrict__ qM, const float* __restrict__ aref_g, const float* __restrict__ D_g,
    const float* __restrict__ fl_g, const float* __restrict__ act_g, const float* __restrict__ as_g,
    const float* __restrict__ ws_g, const float* __restrict__ tol_g, const int* __restrict__ perm_g,
    const int* __restrict__ ddof_g, float* __restrict__ qacc_out, float* __restrict__ force_out,
    float* __restrict__ qfrc_out, Dims d) {
  extern __shared__ float4 smem4[];
  const Layout L(d.nv, d.nefc, d.nd, d.ndiag, d.ncon);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env_id = blockIdx.x * kEnvs + warp;
  if (env_id >= d.B) return;  // whole warps exit together; no block barrier follows
#ifdef AMB_NEWTON_CLOCKS
  long long mark = clock64();
#endif
  float* f = reinterpret_cast<float*>(smem4) + warp * L.floats;
  const Env e{d, L, f + L.Bs, f + L.Jd, f + L.M, reinterpret_cast<float4*>(f + L.rec), f + L.buf, f + L.cf,
              f + L.dsc, f + L.xs, f + L.xw, reinterpret_cast<int*>(f + L.ddof), lane};
  const size_t env = env_id;
  const int nv = d.nv, nefc = d.nefc, P = L.P;

  // ---- load: basis, dense rows and qM by cp.async; row records meanwhile ----
  amb::copy_rows(e.Bs, bJ + env * 3 * d.ncon * nv, 3 * d.ncon, nv, P);
  amb::copy_rows(e.M, qM + env * nv * nv, nv, nv, P);
  for (int r = 0; r < d.nd; ++r) {
    const float* jr = J + (env * nefc + perm_g[r]) * nv;
    for (int c = lane; c < P; c += 32) {
      if (c < nv) amb::cp_async4(e.Jd + r * P + c, jr + c);
      else e.Jd[r * P + c] = 0.f;
    }
  }
  for (int g = lane; g < d.ndiag; g += 32) {
    e.ddof[g] = ddof_g[g];
    e.dsc[g] = dsc_g[env * d.ndiag + g];
  }
#pragma unroll 4
  for (int k = 0; k < L.R; ++k) {
    const int r = lane + 32 * k;
    float4 v = make_float4(0.f, 0.f, 0.f, kKindOneSided);  // padding rows: inactive
    if (r < nefc) {
      const size_t src = env * nefc + perm_g[r];
      const bool on = act_g[src] > 0.5f;
      const int kind = row_kind(r, d);
      v.y = aref_g[src];
      v.z = on ? D_g[src] : 0.f;
      v.w = kind == 1 ? (on ? fl_g[src] : 0.f) : (kind == 0 ? kKindEq : kKindOneSided);
    }
    e.rec[r] = v;
  }
  for (int c = nv + lane; c < P; c += 32) e.xs[c] = e.xw[c] = 0.f;
  const float as = lane < nv ? as_g[env * nv + lane] : 0.f;
  const float ws = lane < nv ? ws_g[env * nv + lane] : 0.f;
  const float tol = tol_g[0];
  amb::cp_async_wait_all();
  __syncwarp();
  AMB_MARK(0);

  // ---- starting point: the cheaper of qacc_smooth and the warmstart ----
  amb::put_vec(e.xs, e.d.nv, as);
  float cost, qacc = as;
  if (d.use_ws) {
    amb::put_vec(e.xw, e.d.nv, ws);
    jmul<2>(e);
    cost = total_cost(e, as, as, 0.f, false);
    const float cost_w = total_cost(e, ws, as, 0.f, true);
    if (cost_w < cost) {
      qacc = ws;
      for (int k = 0; k < L.R; ++k) e.rec[lane + 32 * k].x = e.rec[lane + 32 * k].y;
      cost = cost_w;
    }
  } else {
    jmul<1>(e);
    cost = total_cost(e, as, as, 0.f, false);
  }
  AMB_MARK(1);

  float prev_cost = INFINITY;
  const int ls_iterations = d.ls_iterations > 1 ? d.ls_iterations : 1;
  for (int it = 0; it < d.iterations; ++it) {
    forces_at_jar(e);
    AMB_MARK(2);
    amb::put_vec(e.xs, e.d.nv, lane < nv ? qacc - as : 0.f);
    const float mdacc = m_dot(e, e.xs);
    float h[kMaxN];  // row v of H = M + 1e-8 I + J^T diag(h) J
    const float4* m4 = reinterpret_cast<const float4*>(e.M + (lane < nv ? lane : 0) * P);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 a = m4[g];
      h[4 * g] = a.x;
      h[4 * g + 1] = a.y;
      h[4 * g + 2] = a.z;
      h[4 * g + 3] = a.w;
    }
#pragma unroll
    for (int w = 0; w < kMaxN; ++w)
      if (w == lane) h[w] += 1e-8f;
    const float grad = mdacc - jtf_hessian<true>(e, h);
    __syncwarp();  // every lane is done with the (force, h) rows in buf
    AMB_MARK(3);
    float y = grad;  // L y = grad rides along the factor
    amb::warp_factor<true>(h, nv, e.buf, L.ld, y);
    __syncwarp();
    AMB_MARK(4);
    const float x = amb::warp_back_solve(e.buf, y, nv, L.ld);  // every lane: the sweep shuffles
    const float p = lane < nv ? -x : 0.f;
    AMB_MARK(5);

    amb::put_vec(e.xs, e.d.nv, p);
    jmul<0>(e);
    float pmp = p * m_dot(e, e.xs), pma = p * mdacc;
    warp_sum2(pmp, pma);
    AMB_MARK(6);

    // exact line search: scalar Newton on t, then clip to [0, 4]
    float t = 0.f;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      float g = 0.f, hh = 0.f;
#pragma unroll 4
      for (int k = 0; k < L.R; ++k) {
        const float4 r = e.rec[lane + 32 * k];
        float fr, hr;
        amb::row_eval(amb::along(r.x, t, r.y), r.z, r.w, fr, hr);
        g += fr * r.y;
        hh += hr * r.y * r.y;
      }
      warp_sum2(g, hh);
      g = pma + t * pmp - g;
      hh = pmp + hh;
      t = t - g / fmaxf(hh, 1e-12f);
    }
    t = isfinite(t) ? fminf(fmaxf(t, 0.f), 4.f) : 0.f;
    AMB_MARK(7);

    const float qn = __fadd_rn(qacc, __fmul_rn(t, p));
    const float cost_n = total_cost(e, qn, as, t, false);
    const bool active_it = prev_cost - cost > tol;
    const bool take = (cost_n < cost) && active_it;
    if (take) {
      qacc = qn;
      for (int k = 0; k < L.R; ++k) {
        float4& r = e.rec[lane + 32 * k];
        r.x = amb::along(r.x, t, r.y);
      }
    }
    if (active_it) prev_cost = cost;
    if (take) cost = cost_n;
    AMB_MARK(8);
  }

  // ---- outputs: qacc, efc_force in MuJoCo row order, J^T f ----
  forces_at_jar(e);
  const float2* fh = reinterpret_cast<const float2*>(e.buf);
  for (int k = 0; k < L.R; ++k) {
    const int r = lane + 32 * k;
    if (r < nefc) force_out[env * nefc + perm_g[r]] = fh[r].x;
  }
  float unused[kMaxN];
  const float qfrc = jtf_hessian<false>(e, unused);
  if (lane < nv) {
    qacc_out[env * nv + lane] = qacc;
    qfrc_out[env * nv + lane] = qfrc;
  }
  AMB_MARK(9);
}

inline size_t block_bytes(const Layout& L) { return kEnvs * L.env_bytes(); }

}  // namespace

extern "C" {

// Dynamic shared memory of one block (kEnvs envs); the wrapper refuses
// shapes above the card's per-block limit.
size_t amb_newton_smem_bytes(int nv, int nefc, int nd, int ndiag, int ncon) {
  return block_bytes(Layout(nv, nefc, nd, ndiag, ncon));
}

static cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(newton_structured_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Envs resident on one SM at these shapes (blocks per SM x envs per block).
int amb_newton_occupancy(int nv, int nefc, int nd, int ndiag, int ncon, int* envs) {
  const size_t smem = block_bytes(Layout(nv, nefc, nd, ndiag, ncon));
  cudaError_t err = allow_smem(smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, newton_structured_kernel, kEnvs * 32, smem);
  *envs = blocks * kEnvs;
  return (int)err;
}

// The caller has checked shapes (1 <= nv <= 32, ncon >= 1, B >= 1), dtypes,
// device and contiguity. Returns cudaGetLastError() after the launch.
int amb_newton_structured(const float* J, const float* bJ, const float* dsc, const float* qM, const float* aref,
                          const float* D, const float* fl, const float* act, const float* a_s, const float* ws,
                          const float* tol, const int* perm, const int* diag_dofs, float* qacc, float* force,
                          float* qfrc, int B, int nv, int nefc, int nd, int ndiag, int ncon, int nd_eq, int nd_ft,
                          int nfd, int iterations, int ls_iterations, int use_ws, void* stream) {
  const Dims d{B, nv, nefc, nd, ndiag, ncon, nd_eq, nd_ft, nfd, iterations, ls_iterations, use_ws};
  const size_t smem = block_bytes(Layout(nv, nefc, nd, ndiag, ncon));
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  newton_structured_kernel<<<(B + kEnvs - 1) / kEnvs, kEnvs * 32, smem, (cudaStream_t)stream>>>(
      J, bJ, dsc, qM, aref, D, fl, act, a_s, ws, tol, perm, diag_dofs, qacc, force, qfrc, d);
  return (int)cudaGetLastError();
}

#ifdef AMB_NEWTON_CLOCKS
// Copy kernel 4's phase clocks to out (amb::kPhases values) and zero them.
int amb_newton_phase_clocks(long long* out) { return amb::read_phase_clocks(out); }
#endif

}  // extern "C"
