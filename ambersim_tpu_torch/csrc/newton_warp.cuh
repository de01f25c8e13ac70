// Warp-per-env pieces of the Newton kernels 4-6 (newton_structured.cu,
// newton_dense.cu, newton_elliptic.cu): one warp solves one env, lane v
// owning dof v (nv <= 32), four envs per 128-thread block, no block
// barrier. Sums over lanes are __shfl_xor_sync butterflies, which leave the
// same bits in every lane, so every lane takes the same take/keep and
// line-search decisions.
//
// A row lives in one float4 record {jar, jp, D, kind}: jar = J qacc - aref;
// jp = J p (aref until the start is chosen; the warmstart's jar until the
// first direction); D, zero on an inactive row; and the kind, decided once,
// in the frictionloss slot: >= 0 Huber with that frictionloss, -1
// equality, -3 one-sided. The arithmetic follows the plain version
// (engine/solver.py _row_costs_pure and _newton_arrays), up to FMA
// contraction and summation order.
//
// Kernels 5 and 6 keep their rows as a dense J in shared memory
// (WarpRows): rows go round-robin over lanes (lane l owns rows l, l + 32,
// ...) for J x, costs and the line search; J^T f and the Hessian walk only
// the rows whose force or weight is nonzero (a ballot), each broadcast from
// its lane by a shuffle, and lane v takes column v. Their factor's rows are
// sized to nv (row_tier), so the small models keep their registers.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

#include "linalg.cuh"

namespace amb {

constexpr int kEnvs = 4;  // warps (envs) per block
constexpr float kKindEq = -1.f;  // kind codes in a record's w slot
constexpr float kKindOneSided = -3.f;

// Phase clocks, compiled in only with -DAMB_NEWTON_CLOCKS (tools/newton_probe.py
// builds such a copy): env 0's lane 0 adds the clock64() cycles since its
// last mark (a `long long mark` the kernel starts) to slot k, so the slots
// split one env's time by phase. Each source has its own slots.
constexpr int kPhases = 10;
#ifdef AMB_NEWTON_CLOCKS
namespace {
__device__ long long phase_clocks[kPhases];

// Copy this source's phase clocks to out (kPhases values) and zero them.
inline int read_phase_clocks(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_clocks, sizeof(long long) * kPhases);
  const long long zero[kPhases] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_clocks, zero, sizeof(zero));
  return (int)err;
}
}  // namespace
#define AMB_MARK(k)                                                 \
  do {                                                              \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                      \
      const long long now = clock64();                              \
      amb::phase_clocks[k] += now - mark;                           \
      mark = now;                                                   \
    }                                                               \
  } while (0)
#else
#define AMB_MARK(k) \
  do {              \
  } while (0)
#endif

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats a row of nv dofs takes in shared memory: nv rounded up to 4
// floats, P/4 odd (16-byte aligned broadcast reads, and lanes reading
// their own rows' float4 groups with no bank conflict).
__host__ __device__ inline int row_pitch(int nv) { return 4 * (((nv + 3) / 4) | 1); }

// Register tier of the factor's rows for nv: 8, 16 or 32 floats a lane.
__host__ __device__ inline int row_tier(int nv) { return nv <= 8 ? 8 : (nv <= 16 ? 16 : 32); }

__device__ inline void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// nrow rows of nv floats (contiguous at src) into rows of pitch P at dst by
// cp.async, coalesced over the whole block, padding zeroed. One warp.
__device__ inline void copy_rows(float* dst, const float* src, int nrow, int nv, int P) {
  const int lane = threadIdx.x & 31, q = 32 / nv, rem = 32 % nv;
  int row = lane / nv, col = lane % nv;
  for (int k = lane; k < nrow * nv; k += 32) {
    cp_async4(dst + row * P + col, src + k);
    row += q;
    col += rem;
    if (col >= nv) {
      col -= nv;
      ++row;
    }
  }
  for (int r = lane; r < nrow; r += 32)
    for (int c = nv; c < P; ++c) dst[r * P + c] = 0.f;
}

__device__ inline void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFullMask, a, o);
    b += __shfl_xor_sync(kFullMask, b, o);
  }
}

__device__ inline float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFullMask, a, o);
  return a;
}

// Row kind in MuJoCo row order (_row_masks): 0 = equality (r < ne),
// 1 = friction (Huber, r < ne + nf), 2 = one-sided.
__device__ inline int row_kind(int r, int ne, int nf) { return r < ne ? 0 : (r < ne + nf ? 1 : 2); }

// A row's record before the start is chosen: {0, aref, D, kind code}, D
// and a Huber row's frictionloss zero when the row is inactive.
__device__ inline float4 row_record(float aref, float D, float fl, float act, int kind) {
  const bool on = act > 0.5f;
  return make_float4(0.f, aref, on ? D : 0.f, kind == 1 ? (on ? fl : 0.f) : (kind == 0 ? kKindEq : kKindOneSided));
}

// _row_costs_pure for one row of a record: force and Hessian weight (D on
// quadratic rows, else 0); selects, no branch.
__device__ inline void row_eval(float jar, float D, float kind, float& force, float& h) {
  const float Dj = D * jar;
  const bool fric = kind >= 0.f;  // Huber, frictionloss = kind
  const bool lin = fric && fabsf(Dj) > kind;
  const bool quad = fric ? !lin : (kind > -2.f || jar < 0.f);
  const float sgn = (jar > 0.f) - (jar < 0.f);
  force = lin ? -sgn * kind : (quad ? -Dj : 0.f);
  h = quad ? D : 0.f;
}

// The row's cost. Only a Huber row in its linear zone with a nonzero
// frictionloss divides (the others would send the IEEE divide down its
// slow path for the warp).
__device__ inline float row_cost(float jar, float D, float kind) {
  const bool fric = kind >= 0.f;
  const bool lin = fric && fabsf(D * jar) > kind;
  const bool quad = fric ? !lin : (kind > -2.f || jar < 0.f);
  const float h2 = 0.5f * kind * kind;
  const bool divide = lin && h2 != 0.f;
  const float quo = (divide ? h2 : 1.f) / fmaxf(D, 1e-12f);
  const float shift = divide ? quo : 0.f;
  return lin ? kind * fabsf(jar) - shift : (quad ? 0.5f * D * jar * jar : 0.f);
}

// jar + t jp, rounded as the plain version rounds it (product, then sum)
__device__ inline float along(float jar, float t, float jp) { return __fadd_rn(jar, __fmul_rn(t, jp)); }

// Row r's dot products a (with xs) and b (with xw) into its record, by
// mode: 0: jp = a; 1: jar = a - aref; 2: jar = a - aref, jar_w = b - aref
// (aref rides in the jp slot until then).
template <int kMode>
__device__ inline void store_row(float4* rec, int r, float a, float b) {
  float* x = reinterpret_cast<float*>(rec) + 4 * r;
  if (kMode == 0) {
    x[1] = a;
  } else {
    const float aref = x[1];
    x[0] = a - aref;
    if (kMode == 2) x[1] = b - aref;
  }
}

// Lane v's dof value into a broadcast vector (lanes >= nv write nothing;
// the padding stays zero).
__device__ inline void put_vec(float* x, int nv, float v) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < nv) x[lane] = v;
  __syncwarp();
}

// row . x over the first nv floats (float4 groups; both 16-byte aligned,
// x's padding zero), kN >= nv.
template <int kN>
__device__ inline float row_dot(const float* row, const float* x, int nv) {
  const float4* a4 = reinterpret_cast<const float4*>(row);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < kN / 4; ++g) {
    if (4 * g >= nv) break;
    const float4 a = a4[g], v = x4[g];
    s += a.x * v.x + a.y * v.y + a.z * v.z + a.w * v.w;
  }
  return s;
}

// h[w] += c * row[w] for the first nv columns (float4 groups), kN >= nv.
template <int kN>
__device__ inline void axpy_row(float (&h)[kN], float c, const float* row, int nv) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int g = 0; g < kN / 4; ++g) {
    if (4 * g >= nv) break;
    const float4 x = r4[g];
    h[4 * g] += c * x.x;
    h[4 * g + 1] += c * x.y;
    h[4 * g + 2] += c * x.z;
    h[4 * g + 3] += c * x.w;
  }
}

// One env's dense rows and qM in shared memory (kernels 5 and 6), in
// 4-byte words, each region 16-byte aligned. One definition for host and
// device. `extra` holds a kernel's own per-env operands; `buf` is the
// factor's L and the kernel's scratch.
struct RowsLayout {
  int P, ld, R, J, M, rec, extra, buf, xs, xw, floats;
  __host__ __device__ RowsLayout(int nv, int nefc, int extra_floats, int buf_floats) {
    P = row_pitch(nv);
    ld = nv | 1;
    R = (nefc + 31) / 32;
    int o = 0;
    J = o;     o += nefc * P;
    M = o;     o += nv * P;
    rec = o;   o += 4 * nefc;
    extra = o; o += round4(extra_floats);
    buf = o;   o += round4(nv * ld > buf_floats ? nv * ld : buf_floats);
    xs = o;    o += P;
    xw = o;    o += P;
    floats = o;
  }
  __host__ __device__ size_t block_bytes() const { return sizeof(float) * (size_t)floats * kEnvs; }
};

// Pointers into one env's region of a RowsLayout.
struct WarpRows {
  int nv, nefc, nh, P, ld, lane;  // rows r < nh are head rows (all rows in kernel 5)
  float* J;                       // nefc rows at pitch P
  float* M;                       // qM, nv rows at pitch P
  float4* rec;                    // one record per row
  float* extra;
  float* buf;
  float* xs;                      // broadcast vectors of P floats, padding zero
  float* xw;
  __device__ WarpRows(const RowsLayout& L, float* f, int nv_, int nefc_, int nh_)
      : nv(nv_), nefc(nefc_), nh(nh_), P(L.P), ld(L.ld), lane(threadIdx.x & 31), J(f + L.J), M(f + L.M),
        rec(reinterpret_cast<float4*>(f + L.rec)), extra(f + L.extra), buf(f + L.buf), xs(f + L.xs),
        xw(f + L.xw) {}
};

// Load J and qM by cp.async and zero the vectors' padding. The caller
// writes the records meanwhile and then waits (cp_async_wait_all,
// __syncwarp).
__device__ inline void load_rows_async(const WarpRows& e, const float* J, const float* qM) {
  copy_rows(e.J, J, e.nefc, e.nv, e.P);
  copy_rows(e.M, qM, e.nv, e.nv, e.P);
  for (int c = e.nv + e.lane; c < e.P; c += 32) e.xs[c] = e.xw[c] = 0.f;
}

// (M x)_v for lane v's dof (lanes past nv read row 0), x a broadcast vector.
template <int kN>
__device__ inline float m_dot(const WarpRows& e, const float* x) {
  return row_dot<kN>(e.M + (e.lane < e.nv ? e.lane : 0) * e.P, x, e.nv);
}

// J xs (and J xw in mode 2) into every row's record (store_row). Ends with
// __syncwarp.
template <int kMode, int kN>
__device__ inline void jmul(const WarpRows& e) {
  for (int r = e.lane; r < e.nefc; r += 32) {
    const float* row = e.J + r * e.P;
    store_row<kMode>(e.rec, r, row_dot<kN>(row, e.xs, e.nv), kMode == 2 ? row_dot<kN>(row, e.xw, e.nv) : 0.f);
  }
  __syncwarp();
}

// 0.5 dacc^T M dacc's share of lane v, dacc = q - as (0 past nv).
template <int kN>
__device__ inline float smooth_cost(const WarpRows& e, float q, float as) {
  const float dacc = e.lane < e.nv ? q - as : 0.f;
  put_vec(e.xs, e.nv, dacc);
  return 0.5f * dacc * m_dot<kN>(e, e.xs);
}

// This lane's share of the head rows' cost at jar + t jp (at the jp slot,
// the warmstart's jar, when `alt`).
__device__ inline float head_cost(const WarpRows& e, float t, bool alt) {
  float s = 0.f;
#pragma unroll 4
  for (int r = e.lane; r < e.nh; r += 32) {
    const float4 v = e.rec[r];
    s += row_cost(alt ? v.y : along(v.x, t, v.y), v.z, v.w);
  }
  return s;
}

// The lane's first head row's record (row `lane`), held in registers
// through a line search: at the paths' shapes a lane owns one row.
__device__ inline float4 first_record(const WarpRows& e) {
  return e.lane < e.nh ? e.rec[e.lane] : make_float4(0.f, 0.f, 0.f, kKindOneSided);
}

// This lane's share of the head rows' sum f jp and sum h jp^2 at jar + t jp,
// its first row's record given (first_record).
__device__ inline void head_line(const WarpRows& e, float4 first, float t, float& g, float& hh) {
  auto add = [&](float4 v) {
    float fr, hr;
    row_eval(along(v.x, t, v.y), v.z, v.w, fr, hr);
    g += fr * v.y;
    hh += hr * v.y * v.y;
  };
  if (e.lane < e.nh) add(first);
  for (int r = e.lane + 32; r < e.nh; r += 32) add(e.rec[r]);
}

// Lane v's row of H = M + 1e-8 I, the start of the Hessian (zero past nv).
template <int kN>
__device__ inline void hessian_start(const WarpRows& e, float (&h)[kN]) {
  const float4* m4 = reinterpret_cast<const float4*>(e.M + (e.lane < e.nv ? e.lane : 0) * e.P);
#pragma unroll
  for (int g = 0; g < kN / 4; ++g) {
    const float4 a = 4 * g < e.nv ? m4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
    h[4 * g] = a.x;
    h[4 * g + 1] = a.y;
    h[4 * g + 2] = a.z;
    h[4 * g + 3] = a.w;
  }
#pragma unroll
  for (int w = 0; w < kN; ++w)
    if (w == e.lane) h[w] += 1e-8f;
}

// J^T f over the head rows at jar for lane v's dof and, with kHess, the
// rank-1 updates h_r J_r^T J_r of lane v's Hessian row: a ballot per 32
// rows picks the rows with a nonzero force or weight, broadcast from their
// lanes.
template <bool kHess, int kN>
__device__ inline float head_jtf_hessian(const WarpRows& e, float (&h)[kN]) {
  const int lane = e.lane;
  const bool dof = lane < e.nv;
  float jtf = 0.f;
  for (int r0 = 0; r0 < e.nh; r0 += 32) {
    float f = 0.f, w = 0.f;
    if (r0 + lane < e.nh) {
      const float4 v = e.rec[r0 + lane];
      row_eval(v.x, v.z, v.w, f, w);
    }
    const unsigned hmask = __ballot_sync(kFullMask, kHess && w != 0.f);
    unsigned mask = hmask | __ballot_sync(kFullMask, f != 0.f);
    while (mask) {
      const int bit = __ffs(mask) - 1;
      mask &= mask - 1;
      const float fr = __shfl_sync(kFullMask, f, bit), wr = __shfl_sync(kFullMask, w, bit);
      const float* J = e.J + (r0 + bit) * e.P;
      const float jv = dof ? J[lane] : 0.f;
      jtf += jv * fr;
      if (kHess && ((hmask >> bit) & 1u)) axpy_row<kN>(h, wr * jv, J, e.nv);
    }
  }
  return jtf;
}

// The starting point: the cheaper of qacc_smooth (as) and the warmstart
// (ws) by cost(q, alt), which prices lane q's dof and the rows at jar
// (alt: at the warmstart's jar). Sets qacc and every row's jar; returns
// the cost.
template <int kN, class Cost>
__device__ inline float start_point(const WarpRows& e, float as, float ws, bool use_ws, float& qacc, Cost cost) {
  put_vec(e.xs, e.nv, as);
  qacc = as;
  if (!use_ws) {
    jmul<1, kN>(e);
    return cost(as, false);
  }
  put_vec(e.xw, e.nv, ws);
  jmul<2, kN>(e);
  float c = cost(as, false);
  const float c_w = cost(ws, true);
  if (c_w < c) {
    qacc = ws;
    for (int r = e.lane; r < e.nefc; r += 32) e.rec[r].x = e.rec[r].y;
    c = c_w;
  }
  __syncwarp();
  return c;
}

// The masked improve/convergence update after a trial step t: take it
// when it lowers the cost on an iteration that is still active (the
// previous one lowered the cost by more than tol). Ends with __syncwarp.
__device__ inline void improve(const WarpRows& e, float t, float qn, float cost_n, float tol, float& qacc,
                               float& cost, float& prev_cost) {
  const bool active_it = prev_cost - cost > tol;
  const bool take = (cost_n < cost) && active_it;
  if (take) {
    qacc = qn;
    for (int r = e.lane; r < e.nefc; r += 32) {
      float4& v = e.rec[r];
      v.x = along(v.x, t, v.y);
    }
  }
  if (active_it) prev_cost = cost;
  if (take) cost = cost_n;
  __syncwarp();
}

}  // namespace amb
