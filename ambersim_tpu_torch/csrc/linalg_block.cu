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
// factor reads the lower triangle (19 MB) and writes L (38 MB), 17 us of
// HBM3, and does B n^3 / 3 = 604 MFLOP, 9 us at the float32 rate. Both are
// below one system's dependent chain (12 panels, each a 16-step pivot chain
// and a triangular solve before its update can start), so the kernels are
// bound by that chain's latency and by how many systems are in flight.
//
// Factor and fused solve (cholesky_block, solve_pd_block): a right-looking
// factor blocked by 16 x 16 tiles, one 256-thread block per system.
//   * Storage: only the lower triangle of tiles lives in shared memory, rows
//     at a pitch of 20 floats (16-byte aligned; 8 consecutive rows start in
//     8 different bank groups): 78 tiles plus a transposed copy of the
//     current diagonal tile, 101 KB at n = 192, so two blocks fit on an SM
//     and the 256 clutter systems run in one wave. n is rounded up to a
//     multiple of 16 in shared memory only: padded rows are identity rows,
//     never read from or written to device memory.
//   * The lower triangle arrives by cp.async, every copy of a thread in
//     flight at once, 16 bytes a copy when n is a multiple of 4.
//   * Per panel p, three block barriers (36 a system at n = 192):
//     1. one thread per row solves the tiles below the diagonal tile against
//        it (TRSM), the row in registers, the tile's columns read as rows of
//        its transpose, four floats a load;
//     2. the SYRK update T_IK -= L_Ip L_Kp^T of tile column p + 1: each
//        thread keeps a 4 x 4 block of the output in registers over the
//        16-deep product, its operands read as float4 (8 FMAs a load);
//     3. look-ahead: warp 0 factors diagonal tile p + 1 in registers (lane r
//        holds row r, the column broadcast by shuffles, the pivot
//        rsqrt(max(a_jj, 1e-12))) while the other warps do the SYRK of the
//        rest of the trailing triangle.
//   * solve_pd carries b as one more row below the matrix: step 1 solves its
//     panel segment (forward substitution, y = L^-1 b by tiles) and steps 2-3
//     update its trailing segments. The backward substitution then walks the
//     tiles from the last: warp 0 brings the next segment up to date and
//     solves its transposed diagonal tile in registers (back_diag) while the
//     other warps subtract the solved segment from the rows still open, one
//     barrier a tile (12 at n = 192).
//   * No tensor cores: TF32 keeps about three digits, which would break the
//     2e-4 bar against the plain version and the Newton solve's float32
//     sensitivity; the 604 MFLOP take 9 us on the CUDA cores. 3xTF32 on the
//     SYRK is a follow-up if the update turns out bound by the FMA rate; today
//     the diagonal tiles' pivot chain is the longer part.
//
// Cholesky solve (cho_solve_block): the factor's lower triangle goes into
// the same tiles (two blocks an SM at n = 192, one wave for the clutter
// systems), by cp.async in one group per tile column: columns 0-2 up front,
// then column p + 3 issued by warps 1-7 during panel p (a block's copies
// issue no faster than the SM's share of L2, ~6k cycles for all 78 tiles on
// an H100, so issuing them all first would hold the sweep back as long).
// The forward substitution starts once columns 0 and 1 are in and goes by
// tiles, the TPU's panels (_solve_from_l_panel): warp 0 brings segment
// p + 1 up to date with the solved y_p, takes 1/L_jj of its diagonal tile
// and solves it in registers (fwd_panel) while the other warps subtract
// L_Kp y_p from the segments below, a thread a row, one barrier a tile; the
// backward one is solve_pd_block's (tiled_back_solve). Zero entries of L are
// not skipped: a zero pivot's 1/L_jj = inf meets them as 0 x inf, the plain
// version's NaNs. With k right-hand sides per factor, (B, k, n), each is a
// block of its own that reads its factor in place (block e k + j, factor e).
//
// The contracts of the warp-per-system kernels (linalg.cu) hold: only the
// lower triangle enters the results (up to 3 entries above the diagonal are
// copied with a row's last group and never used), L is zero above the
// diagonal, and the arithmetic is that of engine/linalg.py's plain versions
// up to FMA contraction, summation order and reciprocals in place of
// divisions.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 192;
constexpr unsigned kFull = 0xffffffffu;

// ---- the tiled factor (kernels 1 and 3) ----

constexpr int kT = 16;  // tile and panel width
// Row pitch of a tile in shared memory: rows stay 16-byte aligned for float4
// accesses, and 8 consecutive rows (one phase of a float4 warp access) start
// in 8 different 4-bank groups (5 r mod 8), so row walks are conflict-free.
constexpr int kPitch = 20;
constexpr int kTileFloats = kT * kPitch;

__host__ __device__ inline int tiles_for(int n) { return (n + kT - 1) / kT; }

// tiles of the lower triangle, the transposed diagonal tile, then 1/pivot
// and 1/L_jj of every (padded) column, then the right-hand side
__host__ __device__ inline size_t tiled_smem_bytes(int n) {
  const int nt = tiles_for(n);
  return ((size_t)(nt * (nt + 1) / 2 + 1) * kTileFloats + 3 * (size_t)nt * kT) * sizeof(float);
}

// offset of lower-triangle tile (I, J), I >= J
__device__ inline int tile_off(int I, int J) { return (I * (I + 1) / 2 + J) * kTileFloats; }

// row i of the lower triangle that holds entry u (u = i (i + 1) / 2 + k, k <= i)
__device__ inline int tri_row(int u) {
  int i = (int)((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
  if ((i + 1) * (i + 2) / 2 <= u) ++i;
  if (i * (i + 1) / 2 > u) --i;
  return i;
}

__device__ inline void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ inline void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

// Copy the lower triangle of one system into the tiles with cp.async, all
// copies of a thread in flight at once, coalesced along each row: 16 bytes a
// copy when n is a multiple of 4 (rows 16-byte aligned), else 4. Padded rows
// are written as identity rows. The group of 4 that holds a row's diagonal
// entry also copies up to 3 entries above it, and the rest of a diagonal
// tile's upper part is left as it is: nothing reads above the diagonal of a
// diagonal tile into L. The caller waits at a barrier.
__device__ void load_tiles(float* tiles, const float* __restrict__ src, int n, int nt) {
  const int total_tiles = nt * (nt + 1) / 2;
  if ((n & 3) == 0) {
    // tile row I holds 16 rows of 4 (I + 1) groups: 64 (I + 1) groups
    for (int e = threadIdx.x; e < 64 * total_tiles; e += kThreads) {
      const int I = tri_row(e >> 6), f = e - 32 * I * (I + 1), w4 = 4 * (I + 1);
      const int r = f / w4, c = (f - r * w4) * 4, R = I * kT + r;
      float* dst = tiles + tile_off(I, c / kT) + r * kPitch + c % kT;
      if (R >= n) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(c == R ? 1.f : 0.f, c + 1 == R ? 1.f : 0.f, c + 2 == R ? 1.f : 0.f, c + 3 == R ? 1.f : 0.f);
      } else if (c <= R) {
        cp_async16(dst, src + (size_t)R * n + c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kT * kT * total_tiles; e += kThreads) {
      const int I = tri_row(e >> 8), f = e - 128 * I * (I + 1), width = kT * (I + 1);
      const int r = f / width, c = f - r * width, R = I * kT + r;
      float* dst = tiles + tile_off(I, c / kT) + r * kPitch + c % kT;
      if (R >= n) {
        *dst = c == R ? 1.f : 0.f;
      } else if (c <= R) {
        cp_async4(dst, src + (size_t)R * n + c);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ inline void load_row(float (&x)[kT], const float* row) {
#pragma unroll
  for (int k = 0; k < kT; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    x[k] = v.x;
    x[k + 1] = v.y;
    x[k + 2] = v.z;
    x[k + 3] = v.w;
  }
}

__device__ inline void store_row(float* row, const float (&x)[kT]) {
#pragma unroll
  for (int k = 0; k < kT; k += 4) *reinterpret_cast<float4*>(row + k) = make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
}

// Warp 0: factor diagonal tile t in registers (lane r holds row r; lanes
// 16-31 mirror 0-15 and write nothing). Stores the factor, its transpose in
// lt (columns of L as rows, for the TRSM's column walks), 1/pivot and 1/L_jj.
__device__ void factor_diag(float* t, float* lt, float* pinv, float* ldinv) {
  const int lane = threadIdx.x & 31, r = lane & (kT - 1);
  float v[kT], prr = 0.f, lrr = 0.f;
  load_row(v, t + r * kPitch);
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const float rinv = rsqrtf(fmaxf(__shfl_sync(kFull, v[j], j), 1e-12f));
    const float c = v[j] * rinv;  // L_rj for r >= j
    v[j] = c;
    if (r == j) {
      prr = rinv;
      lrr = c;
    }
#pragma unroll
    for (int k = j + 1; k < kT; ++k) v[k] = fmaf(-c, __shfl_sync(kFull, c, k), v[k]);
  }
  if (lane < kT) {
    store_row(t + r * kPitch, v);
#pragma unroll
    for (int k = 0; k < kT; ++k) lt[k * kPitch + r] = v[k];
    pinv[r] = prr;
    ldinv[r] = 1.f / lrr;
  }
}

// x L^T = x in place for one row x of 16 (stride 1) against the diagonal
// tile, given as its transpose lt: x_k = (x_k - sum_{j<k} x_j L_kj) * inv[k],
// column j of L read as row j of lt, four floats a load.
__device__ inline void trsm_row(float* x_row, const float* lt, const float* inv) {
  float x[kT], w[kT];
  load_row(x, x_row);
  load_row(w, inv);
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    x[j] *= w[j];
#pragma unroll
    for (int k4 = (j + 1) / 4 * 4; k4 < kT; k4 += 4) {
      const float4 l = *reinterpret_cast<const float4*>(lt + j * kPitch + k4);
      if (k4 > j) x[k4] = fmaf(-x[j], l.x, x[k4]);
      if (k4 + 1 > j) x[k4 + 1] = fmaf(-x[j], l.y, x[k4 + 1]);
      if (k4 + 2 > j) x[k4 + 2] = fmaf(-x[j], l.z, x[k4 + 2]);
      if (k4 + 3 > j) x[k4 + 3] = fmaf(-x[j], l.w, x[k4 + 3]);
    }
  }
  store_row(x_row, x);
}

// Warp 0: solve L_PP^T x = y for segment y (16) of tile t in place. Every
// lane solves the whole segment in registers (lane 0 writes it): x_j =
// y_j / L_jj, then y_r -= L_jr x_j for r < j, row j of the tile read four
// floats a load (its entries from the diagonal on unused). No shuffle: the
// chain is a multiply and an FMA a step.
__device__ void back_diag(const float* t, const float* ldinv, float* y) {
  float v[kT], inv[kT];
  load_row(v, y);
  load_row(inv, ldinv);
#pragma unroll
  for (int j = kT - 1; j >= 0; --j) {
    float l[kT];
    load_row(l, t + j * kPitch);  // row j of L is column j of L^T
    v[j] *= inv[j];
#pragma unroll
    for (int r = 0; r < j; ++r) v[r] = fmaf(-l[r], v[j], v[r]);
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) store_row(y, v);
}

// The SYRK update of panel p, T_IK -= L_Ip L_Kp^T, on the trailing tiles of
// tile column k0 alone (`column`) or of the triangle of tile columns k0 to
// the last; with kSolve also b's segments of those columns,
// y_K -= L_Kp y_p. Worker t of `workers` takes items t, t + workers, ...:
// a 4 x 4 output block of a tile, or one entry of y.
template <bool kSolve>
__device__ void syrk(float* tiles, float* y, int nt, int p, int k0, bool column, int t, int workers) {
  const int mt = nt - k0;
  if (mt <= 0) return;
  const int tile_items = kT * (column ? mt : mt * (mt + 1) / 2);
  const int items = tile_items + (kSolve ? kT * (column ? 1 : mt) : 0);
  for (int w = t; w < items; w += workers) {
    if (w < tile_items) {
      // rows r0 + 4 s and columns c0 + 4 c of tile (I, K): a phase of 8
      // threads reads 4 consecutive rows of L_Ip and 2 of L_Kp as float4,
      // conflict-free at the pitch of 20
      const int u = w >> 4, sub = w & 15;
      int I = k0 + u, K = k0;
      if (!column) {
        const int i = tri_row(u);
        I = k0 + i;
        K = k0 + (u - i * (i + 1) / 2);
      }
      const int r0 = sub & 3, c0 = sub >> 2;
      const float* li = tiles + tile_off(I, p) + r0 * kPitch;
      const float* lk = tiles + tile_off(K, p) + c0 * kPitch;
      float acc[4][4] = {};
#pragma unroll
      for (int q = 0; q < kT; q += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[s] = *reinterpret_cast<const float4*>(li + 4 * s * kPitch + q);
          b[s] = *reinterpret_cast<const float4*>(lk + 4 * s * kPitch + q);
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[s][c] = fmaf(a[s].x, b[c].x, acc[s][c]);
            acc[s][c] = fmaf(a[s].y, b[c].y, acc[s][c]);
            acc[s][c] = fmaf(a[s].z, b[c].z, acc[s][c]);
            acc[s][c] = fmaf(a[s].w, b[c].w, acc[s][c]);
          }
      }
      float* out = tiles + tile_off(I, K) + r0 * kPitch + c0;
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) out[4 * s * kPitch + 4 * c] -= acc[s][c];
    } else {
      const int e = w - tile_items, K = k0 + (e >> 4), c = e & 15;
      float l[kT];
      load_row(l, tiles + tile_off(K, p) + c * kPitch);
      const float* yp = y + p * kT;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kT; ++q) s = fmaf(yp[q], l[q], s);
      y[K * kT + c] -= s;
    }
  }
}

// The blocked factor of the tiles (and, with kSolve, the forward substitution
// of y), right-looking with a look-ahead: panel p's SYRK first updates tile
// column p + 1, then warp 0 factors tile (p + 1, p + 1) while the other warps
// update the rest. Three barriers a panel. Every thread calls it; it starts
// and ends with a barrier.
template <bool kSolve>
__device__ void tiled_factor(float* tiles, float* lt, float* pinv, float* ldinv, float* y, int nt) {
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (warp == 0) factor_diag(tiles, lt, pinv, ldinv);
  __syncthreads();
  for (int p = 0; p < nt; ++p) {
    // the rows below the diagonal tile (and b's segment p) against it
    const int m = nt - 1 - p;
    if (threadIdx.x < kT * m) {
      const int R = (p + 1) * kT + threadIdx.x;
      trsm_row(tiles + tile_off(R / kT, p) + (R % kT) * kPitch, lt, pinv + p * kT);
    } else if (kSolve && threadIdx.x == kT * m) {
      trsm_row(y + p * kT, lt, ldinv + p * kT);
    }
    __syncthreads();
    if (m == 0) break;
    syrk<kSolve>(tiles, y, nt, p, p + 1, true, threadIdx.x, kThreads);
    __syncthreads();
    if (warp == 0) {
      const int q = p + 1;
      factor_diag(tiles + tile_off(q, q), lt, pinv + q * kT, ldinv + q * kT);
    } else {
      syrk<kSolve>(tiles, y, nt, p, p + 2, false, threadIdx.x - 32, kThreads - 32);
    }
    __syncthreads();
  }
}

// The backward substitution L^T x = y in place in y, a tile at a time from
// the last: warp 0 brings segment P - 1 up to date with the solved x_P and
// solves its transposed diagonal tile (back_diag) while the other warps
// subtract x_P from the rows still open, one barrier a tile (12 at
// n = 192). Every thread calls it after a barrier; it ends with one.
__device__ void tiled_back_solve(const float* tiles, const float* ldinv, float* y, int nt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) back_diag(tiles + tile_off(nt - 1, nt - 1), ldinv + (nt - 1) * kT, y + (nt - 1) * kT);
  __syncthreads();
  for (int P = nt - 1; P >= 1; --P) {
    const float* xp = y + P * kT;  // solved
    if (warp == 0) {
      // segment P - 1 takes x_P's contribution, then its own diagonal solve
      if (lane < kT) {
        const float* l = tiles + tile_off(P, P - 1) + lane;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kT; ++c) s = fmaf(l[c * kPitch], xp[c], s);
        y[(P - 1) * kT + lane] -= s;
      }
      __syncwarp();
      back_diag(tiles + tile_off(P - 1, P - 1), ldinv + (P - 1) * kT, y + (P - 1) * kT);
    } else {
      for (int i = threadIdx.x - 32; i < (P - 1) * kT; i += kThreads - 32) {
        const float* l = tiles + tile_off(P, i / kT) + i % kT;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kT; ++c) s = fmaf(l[c * kPitch], xp[c], s);
        y[i] -= s;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2) cholesky_block_kernel(const float* __restrict__ A,
                                                                     float* __restrict__ L, int n) {
  extern __shared__ float smem[];
  const int nt = tiles_for(n);
  float* tiles = smem;
  float* lt = tiles + nt * (nt + 1) / 2 * kTileFloats;
  float* pinv = lt + kTileFloats;
  float* ldinv = pinv + nt * kT;
  const size_t base = (size_t)blockIdx.x * n * n;
  load_tiles(tiles, A + base, n, nt);
  tiled_factor<false>(tiles, lt, pinv, ldinv, nullptr, nt);
  float* dst = L + base;
  if ((n & 3) == 0) {  // rows are 16-byte aligned: four floats a store
    const int q = n >> 2;
    for (int e = threadIdx.x; e < n * q; e += kThreads) {
      const int R = e / q, C = (e - R * q) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (C <= R) {
        v = *reinterpret_cast<const float4*>(tiles + tile_off(R / kT, C / kT) + (R % kT) * kPitch + C % kT);
        if (C + 1 > R) v.y = 0.f;
        if (C + 2 > R) v.z = 0.f;
        if (C + 3 > R) v.w = 0.f;
      }
      reinterpret_cast<float4*>(dst)[e] = v;
    }
  } else {
    for (int e = threadIdx.x; e < n * n; e += kThreads) {
      const int R = e / n, C = e - R * n;
      dst[e] = C <= R ? tiles[tile_off(R / kT, C / kT) + (R % kT) * kPitch + C % kT] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) solve_pd_block_kernel(const float* __restrict__ A,
                                                                     const float* __restrict__ b,
                                                                     float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  const int nt = tiles_for(n);
  float* tiles = smem;
  float* lt = tiles + nt * (nt + 1) / 2 * kTileFloats;
  float* pinv = lt + kTileFloats;
  float* ldinv = pinv + nt * kT;
  float* y = ldinv + nt * kT;
  load_tiles(tiles, A + (size_t)blockIdx.x * n * n, n, nt);
  for (int i = threadIdx.x; i < nt * kT; i += kThreads) y[i] = i < n ? b[(size_t)blockIdx.x * n + i] : 0.f;
  tiled_factor<true>(tiles, lt, pinv, ldinv, y, nt);  // y = L^-1 b
  tiled_back_solve(tiles, ldinv, y, nt);
  for (int i = threadIdx.x; i < n; i += kThreads) x[(size_t)blockIdx.x * n + i] = y[i];
}

// ---- the Cholesky solve (kernel 2) ----

// the tiles of the lower triangle, then 1/L_jj of every (padded) column and
// the right-hand side
__host__ __device__ inline size_t solve_smem_bytes(int n) {
  const int nt = tiles_for(n);
  return ((size_t)(nt * (nt + 1) / 2) * kTileFloats + 2 * (size_t)nt * kT) * sizeof(float);
}

// Copy tile column J of the lower triangle (tiles (J..nt-1, J)) by cp.async
// as load_tiles does; worker t of `workers` takes items t, t + workers, ...
// The caller commits the group.
__device__ void load_tile_column(float* tiles, const float* __restrict__ src, int n, int nt, int J, int t,
                                 int workers) {
  const int rows = (nt - J) * kT;
  if ((n & 3) == 0) {
    for (int e = t; e < 4 * rows; e += workers) {
      const int R = J * kT + (e >> 2), c = J * kT + 4 * (e & 3);
      float* dst = tiles + tile_off(R / kT, J) + (R % kT) * kPitch + 4 * (e & 3);
      if (R >= n) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(c == R ? 1.f : 0.f, c + 1 == R ? 1.f : 0.f, c + 2 == R ? 1.f : 0.f, c + 3 == R ? 1.f : 0.f);
      } else if (c <= R) {
        cp_async16(dst, src + (size_t)R * n + c);
      }
    }
  } else {
    for (int e = t; e < kT * rows; e += workers) {
      const int R = J * kT + (e >> 4), c = J * kT + (e & 15);
      float* dst = tiles + tile_off(R / kT, J) + (R % kT) * kPitch + (e & 15);
      if (R >= n) {
        *dst = c == R ? 1.f : 0.f;
      } else if (c <= R) {
        cp_async4(dst, src + (size_t)R * n + c);
      }
    }
  }
}

// Close this thread's current group of cp.async copies, then wait until all
// but the newest group have landed.
__device__ inline void cp_async_commit_wait_one() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// L_R,p y_p for row R below panel p: the row's 16 entries of tile (R / 16,
// p) against the solved segment p, both read four floats a load, in four
// partial sums.
__device__ inline float fwd_dot(const float* tiles, const float* y, int R, int p) {
  float l[kT], v[kT], s[4] = {};
  load_row(l, tiles + tile_off(R / kT, p) + (R % kT) * kPitch);
  load_row(v, y + p * kT);
#pragma unroll
  for (int q = 0; q < kT; ++q) s[q & 3] = fmaf(l[q], v[q], s[q & 3]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// Warp 0: segment q of y takes the solved segment q - 1's contribution (for
// q > 0; lane r < 16 its row r, which also takes 1/L_rr into ldinv), then
// L_qq y_q = y_q, the mirror of back_diag: every lane solves the whole
// segment in registers (lane 0 writes it), y_i = (y_i - sum_k<i L_ik y_k) /
// L_ii, row i of the tile read four floats a load (its entries from the
// diagonal on unused). No shuffle: the chain is an FMA and a multiply a
// step.
__device__ void fwd_panel(const float* tiles, float* ldinv, float* y, int q) {
  const int lane = threadIdx.x & 31;
  const float* t = tiles + tile_off(q, q);
  float* yq = y + q * kT;
  if (lane < kT) {
    ldinv[q * kT + lane] = 1.f / t[lane * (kPitch + 1)];
    if (q > 0) yq[lane] -= fwd_dot(tiles, y, q * kT + lane, q - 1);
  }
  __syncwarp();
  float v[kT], inv[kT];
  load_row(v, yq);
  load_row(inv, ldinv + q * kT);
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    float l[kT];
    load_row(l, t + i * kPitch);
#pragma unroll
    for (int k = 0; k < i; ++k) v[i] = fmaf(-l[k], v[k], v[i]);
    v[i] *= inv[i];
  }
  __syncwarp();
  if (lane == 0) store_row(yq, v);
}

// Block sys solves right-hand side sys of the B k, against factor sys / k.
__global__ void __launch_bounds__(kThreads, 2) cho_solve_block_kernel(const float* __restrict__ Lg,
                                                                      const float* __restrict__ b,
                                                                      float* __restrict__ x, int n, int k) {
  extern __shared__ float smem[];
  const int nt = tiles_for(n), warp = threadIdx.x >> 5;
  float* tiles = smem;
  float* ldinv = tiles + nt * (nt + 1) / 2 * kTileFloats;
  float* y = ldinv + nt * kT;
  const float* src = Lg + (size_t)(blockIdx.x / k) * n * n;
  // b and tile columns 0, 1 and 2 by every thread, one group each (b with
  // column 0); then column p + 3 by warps 1-7 during panel p, one group a
  // panel on every thread (empty on warp 0 and past the last column), so
  // that column p + 2 has landed at the end of panel p
  for (int i = threadIdx.x; i < nt * kT; i += kThreads) {
    if (i < n) {
      cp_async4(y + i, b + (size_t)blockIdx.x * n + i);
    } else {
      y[i] = 0.f;
    }
  }
  load_tile_column(tiles, src, n, nt, 0, threadIdx.x, kThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  load_tile_column(tiles, src, n, nt, 1, threadIdx.x, kThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  load_tile_column(tiles, src, n, nt, 2, threadIdx.x, kThreads);  // nt >= 3 past n = 32
  cp_async_commit_wait_one();  // columns 0 and 1
  __syncthreads();
  // forward substitution L y = b, a tile at a time
  if (warp == 0) fwd_panel(tiles, ldinv, y, 0);
  __syncthreads();
  for (int p = 0; p + 1 < nt; ++p) {
    if (warp == 0) {
      fwd_panel(tiles, ldinv, y, p + 1);
    } else {
      if (p + 3 < nt) load_tile_column(tiles, src, n, nt, p + 3, threadIdx.x - 32, kThreads - 32);
      for (int R = (p + 2) * kT + threadIdx.x - 32; R < nt * kT; R += kThreads - 32) y[R] -= fwd_dot(tiles, y, R, p);
    }
    cp_async_commit_wait_one();  // column p + 2
    __syncthreads();
  }
  tiled_back_solve(tiles, ldinv, y, nt);  // L^T x = y
  for (int i = threadIdx.x; i < n; i += kThreads) x[(size_t)blockIdx.x * n + i] = y[i];
}

// Opt in to more than 48 KB of dynamic shared memory (the size at n = 192)
// and to the largest shared-memory carveout, once per kernel; the launch is
// refused without the first.
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

bool g_chol_opt = false, g_solve_opt = false, g_pd_opt = false;

cudaError_t opt_in_chol() { return opt_in(cholesky_block_kernel, tiled_smem_bytes(kMaxN), g_chol_opt); }
cudaError_t opt_in_solve() { return opt_in(cho_solve_block_kernel, solve_smem_bytes(kMaxN), g_solve_opt); }
cudaError_t opt_in_pd() { return opt_in(solve_pd_block_kernel, tiled_smem_bytes(kMaxN), g_pd_opt); }

}  // namespace

// C interface, bound with ctypes (ambersim_tpu_torch/ops/linalg.py). Each
// returns cudaGetLastError() after its launch (or the opt-in's error); the
// caller has checked shapes (32 < n <= 192, B >= 1, k >= 1), dtype, device
// and contiguity.
extern "C" {

int amb_cholesky_block(const float* A, float* L, int B, int n, void* stream) {
  cudaError_t err = opt_in_chol();
  if (err != cudaSuccess) return (int)err;
  cholesky_block_kernel<<<B, kThreads, tiled_smem_bytes(n), (cudaStream_t)stream>>>(A, L, n);
  return (int)cudaGetLastError();
}

// k right-hand sides per factor: b and x are (B, k, n), L (B, n, n).
int amb_cho_solve_block_rhs(const float* L, const float* b, float* x, int B, int k, int n, void* stream) {
  cudaError_t err = opt_in_solve();
  if (err != cudaSuccess) return (int)err;
  cho_solve_block_kernel<<<B * k, kThreads, solve_smem_bytes(n), (cudaStream_t)stream>>>(L, b, x, n, k);
  return (int)cudaGetLastError();
}

int amb_cho_solve_block(const float* L, const float* b, float* x, int B, int n, void* stream) {
  return amb_cho_solve_block_rhs(L, b, x, B, 1, n, stream);
}

int amb_solve_pd_block(const float* A, const float* b, float* x, int B, int n, void* stream) {
  cudaError_t err = opt_in_pd();
  if (err != cudaSuccess) return (int)err;
  solve_pd_block_kernel<<<B, kThreads, tiled_smem_bytes(n), (cudaStream_t)stream>>>(A, b, x, n);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a block kernel at size n (0: cholesky_block,
// 1: cho_solve_block, 2: solve_pd_block), after the same opt-in as a launch.
int amb_linalg_block_occupancy(int kernel, int n, int* blocks) {
  cudaError_t err;
  switch (kernel) {
    case 0:
      err = opt_in_chol();
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cholesky_block_kernel, kThreads,
                                                            tiled_smem_bytes(n));
      break;
    case 1:
      err = opt_in_solve();
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cho_solve_block_kernel, kThreads,
                                                            solve_smem_bytes(n));
      break;
    case 2:
      err = opt_in_pd();
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, solve_pd_block_kernel, kThreads,
                                                            tiled_smem_bytes(n));
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
