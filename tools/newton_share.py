#!/usr/bin/env python3
"""How far float32 rounding alone moves the Newton kernels' synthetic
problems from float64, for equally valid float32 orders of the same sums.

    python3 tools/newton_share.py [--kernel 4 5 6] [--nv 1 7 18 25 32] [--seeds 3 80] [--device cpu]

For each kernel, on the problems that chip_smoke.py and
tests/test_torch_cuda.py hold against float64 (4096 envs), prints each
env share within the comparison's tolerance of the float64 solve for:

  * plain: the plain version in float32 (what the kernel is held to);
  * reordered: the same with rows (kernel 6: contacts) permuted within their
    families and the dofs permuted (4-8 draws; the same solve in exact
    arithmetic);
  * the kernel's order: the plain version with the kernel's algebra and
    summation order, in float32 and, as a check of that algebra, float64.
    Kernel 4 (`factored`): products with the basis N, U1, U2, the four
    pyramid forces folded before J^T f, the Hessian's contact part as a
    rank-3 update per contact. Kernels 5 and 6 (`warp order`): the Hessian
    built by rank-1 updates row by row (kernel 6: then a rank-cdim update
    per contact, c_b = sum_a R_a W_ab first), J^T f summed row by row, and
    every sum over rows, contacts or dofs taken as one warp takes it (row r
    on lane r % 32, each lane's rows in order, then an xor butterfly).

Kernel 4: synthetic_structured_problem's own problems (80% of rows active,
D in [1, 10]; seed = SEED + nv, 5 x 8 iterations, the warmstart on),
within rtol/atol NEWTON_TOL (chip_smoke.newton_within). Kernel 5:
synthetic_dense_problem's own (seeds 80 + nv and 130 + nv), likewise.
Kernel 6: synthetic_elliptic_problem at nv x cdim 2-6 as chip_smoke's
sweep (seed 7 + nv + nh + cdim; nh 9 when nv + cdim is odd; the
warmstart off at cdim 4) and the card tests' (seed 120 + nv, nh 9, cdim
2 + nv % 5, the warmstart on and off), at 3 x 1 within ELLIPTIC_ENV_TOL
and 15 x 15 within ELLIPTIC_CONVERGED_TOL (chip_smoke.env_rel_err), with
the most any float32 order's converged cost exceeds the larger of plain
float32's and float64's.

chip_smoke.NEWTON_F64_SLACK rests on these numbers (the largest shortfall
of an order below plain's share). Imports nothing of JAX; runs on the CPU
or, faster, on a card (--device cuda).

    python3 tools/newton_share.py --paths 96 98 100 102 104

prints instead, on a card, kernel 5's shares on its paths' own operands
(chip_smoke.check_newton_dense's: arm3 and cartpole, 1024 envs from their
paths' starts, taken after each given number of steps), rolled out on the
card (the kernels) and on the CPU (the plain versions): the kernel within
NEWTON_TOL of plain float32, plain float32 of float64 and the kernel of
float64. They show how far the share between two float32 solves moves with
the rounding of the rollout that reached the operands.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

KW = dict(iterations=5, ls_iterations=8, use_ws=True)


def factored_newton(st, pa: dict, bJ, *, iterations: int, ls_iterations: int, use_ws: bool):
    """engine.solver._newton_arrays with kernel 4's algebra for the contact
    rows; the other rows as the plain version takes them."""
    import torch

    from ambersim_tpu_torch.engine.linalg import solve_pd_unrolled
    from ambersim_tpu_torch.engine.solver import _mv, _row_costs_pure

    J, qM, aref, D, fl, act, a_s, ws, tol = (pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol"))
    ne, nf, n = pa["ne"], pa["nf"], st.ncon3
    N, U1, U2 = bJ[:, :n], bJ[:, n : 2 * n], bJ[:, 2 * n :]
    adr = [torch.as_tensor(st.adr3 + q, device=J.device) for q in range(4)]
    rest = torch.ones(J.shape[1], dtype=torch.bool, device=J.device)
    for a in adr:
        rest[a] = False
    Jr = J * rest[None, :, None]

    def jmul(x):
        out, jn, j1, j2 = _mv(J, x), _mv(N, x), _mv(U1, x), _mv(U2, x)
        for a, v in zip(adr, (jn + j1, jn - j1, jn + j2, jn - j2)):
            out[:, a] = v
        return out

    def jtmul(f):
        f0, f1, f2, f3 = (f[:, a, None] for a in adr)
        return (Jr * f[..., None]).sum(-2) + ((f0 + f1 + f2 + f3) * N + (f0 - f1) * U1 + (f2 - f3) * U2).sum(-2)

    def total_cost(qacc, jar):
        dacc = qacc - a_s
        return 0.5 * (dacc * _mv(qM, dacc)).sum(-1) + _row_costs_pure(jar, D, fl, act, ne, nf)[0].sum(-1)

    jar = jmul(a_s) - aref
    cost, qacc = total_cost(a_s, jar), a_s
    if use_ws:
        jar_w = jmul(ws) - aref
        cost_w = total_cost(ws, jar_w)
        better = cost_w < cost
        qacc, jar = torch.where(better[:, None], ws, a_s), torch.where(better[:, None], jar_w, jar)
        cost = torch.where(better, cost_w, cost)
    prev = torch.full_like(cost, float("inf"))
    eye = torch.eye(a_s.shape[-1], dtype=a_s.dtype, device=a_s.device)
    for _ in range(iterations):
        _, force, quad = _row_costs_pure(jar, D, fl, act, ne, nf)
        Mdacc = _mv(qM, qacc - a_s)
        grad = Mdacc - jtmul(force)
        h = torch.where(quad, D, 0.0)
        h0, h1, h2, h3 = (h[:, a, None] for a in adr)
        c0, c1, c2, c3, c4 = h0 + h1 + h2 + h3, h0 + h1, h2 + h3, h0 - h1, h2 - h3
        H = qM + 1e-8 * eye + (Jr * h[..., None]).transpose(-1, -2) @ Jr
        H = (H + (c0 * N + c3 * U1 + c4 * U2).transpose(-1, -2) @ N + (c3 * N + c1 * U1).transpose(-1, -2) @ U1
             + (c4 * N + c2 * U2).transpose(-1, -2) @ U2)
        p = -solve_pd_unrolled(H, grad)
        jp, pmp, pma = jmul(p), (p * _mv(qM, p)).sum(-1), (p * Mdacc).sum(-1)
        t = torch.zeros_like(cost)
        for _ls in range(max(ls_iterations, 1)):
            _, ft, qt = _row_costs_pure(jar + t[:, None] * jp, D, fl, act, ne, nf)
            g = pma + t * pmp - (ft * jp).sum(-1)
            t = t - g / torch.clamp(pmp + torch.where(qt, D * jp * jp, 0.0).sum(-1), min=1e-12)
        t = torch.where(torch.isfinite(t), torch.clamp(t, 0.0, 4.0), 0.0)
        qn, jn = qacc + t[:, None] * p, jar + t[:, None] * jp
        cn = total_cost(qn, jn)
        active = prev - cost > tol
        take = (cn < cost) & active
        qacc, jar = torch.where(take[:, None], qn, qacc), torch.where(take[:, None], jn, jar)
        prev, cost = torch.where(active, cost, prev), torch.where(take, cn, cost)
    force = _row_costs_pure(jar, D, fl, act, ne, nf)[1]
    return qacc, force, jtmul(force)


def butterfly(lanes):
    """(B, 32) lane values summed as a warp's xor butterfly sums them."""
    import torch

    idx = torch.arange(32, device=lanes.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ o]
    return lanes[:, 0]


def lane_partials(x):
    """(B, R) terms on lanes r % 32, each lane's summed in order: (B, 32)."""
    import torch

    B, R = x.shape
    if R == 0:
        return x.new_zeros(B, 32)
    k = -(-R // 32)
    lanes = torch.nn.functional.pad(x, (0, 32 * k - R)).view(B, k, 32)
    acc = lanes[:, 0]
    for j in range(1, k):
        acc = acc + lanes[:, j]
    return acc


def lane_sum(x):
    return butterfly(lane_partials(x))


def rank1_rows(H, J, w):
    """H + sum_r w_r J_r^T J_r, added row by row as the kernels add them."""
    for r in range(J.shape[1]):
        c = w[:, r, None] * J[:, r]
        H = H + c[:, :, None] * J[:, r, None, :]
    return H


def jtf_rows(J, f):
    """J^T f summed row by row."""
    out = J[:, 0] * f[:, 0, None]
    for r in range(1, J.shape[1]):
        out = out + J[:, r] * f[:, r, None]
    return out


def warp_dense(pa: dict, *, iterations: int, ls_iterations: int, use_ws: bool):
    """engine.solver._newton_arrays in kernel 5's algebra and summation order."""
    import torch

    from ambersim_tpu_torch.engine.linalg import solve_pd_unrolled
    from ambersim_tpu_torch.engine.solver import _mv, _row_costs_pure

    J, qM, aref, D, fl, act, a_s, ws, tol = (pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol"))
    ne, nf, nv = pa["ne"], pa["nf"], a_s.shape[-1]

    def dofs(x):
        return torch.nn.functional.pad(x, (0, 32 - nv))

    def total_cost(qacc, jar):
        dacc = qacc - a_s
        return butterfly(dofs(0.5 * dacc * _mv(qM, dacc)) + lane_partials(_row_costs_pure(jar, D, fl, act, ne, nf)[0]))

    jar = _mv(J, a_s) - aref
    cost, qacc = total_cost(a_s, jar), a_s
    if use_ws:
        jar_w = _mv(J, ws) - aref
        cost_w = total_cost(ws, jar_w)
        better = cost_w < cost
        qacc, jar = torch.where(better[:, None], ws, a_s), torch.where(better[:, None], jar_w, jar)
        cost = torch.where(better, cost_w, cost)
    prev = torch.full_like(cost, float("inf"))
    eye = torch.eye(nv, dtype=a_s.dtype, device=a_s.device)
    for _ in range(iterations):
        _, force, quad = _row_costs_pure(jar, D, fl, act, ne, nf)
        Mdacc = _mv(qM, qacc - a_s)
        H = rank1_rows(qM + 1e-8 * eye, J, torch.where(quad, D, 0.0))
        p = -solve_pd_unrolled(H, Mdacc - jtf_rows(J, force))
        jp = _mv(J, p)
        pmp, pma = butterfly(dofs(p * _mv(qM, p))), butterfly(dofs(p * Mdacc))
        t = torch.zeros_like(cost)
        for _ls in range(max(ls_iterations, 1)):
            _, ft, qt = _row_costs_pure(jar + t[:, None] * jp, D, fl, act, ne, nf)
            g = pma + t * pmp - lane_sum(ft * jp)
            hh = pmp + lane_sum(torch.where(qt, D, 0.0) * jp * jp)
            t = t - g / torch.clamp(hh, min=1e-12)
        t = torch.where(torch.isfinite(t), torch.clamp(t, 0.0, 4.0), 0.0)
        qn, jn = qacc + t[:, None] * p, jar + t[:, None] * jp
        cn = total_cost(qn, jn)
        active = prev - cost > tol
        take = (cn < cost) & active
        qacc, jar = torch.where(take[:, None], qn, qacc), torch.where(take[:, None], jn, jar)
        prev, cost = torch.where(active, cost, prev), torch.where(take, cn, cost)
    force = _row_costs_pure(jar, D, fl, act, ne, nf)[1]
    return qacc, force, jtf_rows(J, force)


def warp_elliptic(pa: dict, *, iterations: int, ls_iterations: int, use_ws: bool):
    """engine.solver._newton_arrays_elliptic in kernel 6's algebra and
    summation order."""
    import torch

    from ambersim_tpu_torch.engine.linalg import solve_pd_unrolled
    from ambersim_tpu_torch.engine.solver import _Cone, _mv, _row_costs_pure, cone_params, ls_bracket_step

    J, qM, aref, D, fl, act, a_s, ws, tol = (pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol"))
    ne, nf, nh, S, cd = pa["ne"], pa["nf"], pa["base"], pa["ncon"], pa["cdim"]
    B, _, nv = J.shape
    mu, scale = cone_params(pa["fr"], pa["impratio"], cd)
    one_mu2 = 1.0 + mu * mu
    D_h, D_c = D[:, :nh], D[:, nh:].reshape(B, S, cd)
    fl_h, act_h, J_h = fl[:, :nh], act[:, :nh], J[:, :nh]
    actN = act[:, nh:].reshape(B, S, cd)[..., 0]
    Dn, Rc = D_c[..., 0], J[:, nh:].reshape(B, S, cd, nv)
    eye = torch.eye(nv, dtype=a_s.dtype, device=a_s.device)
    eye_f = torch.eye(cd - 1, dtype=a_s.dtype, device=a_s.device)

    def dofs(x):
        return torch.nn.functional.pad(x, (0, 32 - nv))

    def total_cost(qacc, jar):
        z = _Cone(jar, nh, S, cd, mu, scale, one_mu2)
        cone = (torch.where(z.bottom, 0.5 * Dn * (z.N * z.N + z.T2), 0.0)
                + torch.where(z.middle, 0.5 * Dn * z.cfac * z.cfac * one_mu2, 0.0)) * actN
        head = _row_costs_pure(jar[:, :nh], D_h, fl_h, act_h, ne, nf)[0]
        dacc = qacc - a_s
        return butterfly(dofs(0.5 * dacc * _mv(qM, dacc)) + lane_partials(head) + lane_partials(cone))

    def forces(jar):
        _, f_h, quad_h = _row_costs_pure(jar[:, :nh], D_h, fl_h, act_h, ne, nf)
        z = _Cone(jar, nh, S, cd, mu, scale, one_mu2)
        fN = torch.where(z.bottom, -Dn * z.N, torch.where(z.middle, Dn * z.cfac, 0.0))
        fY = torch.where(z.bottom[..., None], -Dn[..., None] * z.y,
                         torch.where(z.middle[..., None], (-Dn * z.cfac * mu / z.T)[..., None] * z.y, 0.0))
        f_c = (torch.cat([fN[..., None], fY * scale], dim=-1) * actN[..., None]).reshape(B, -1)
        return torch.cat([f_h, f_c], dim=1), quad_h, z

    jar = _mv(J, a_s) - aref
    cost, qacc = total_cost(a_s, jar), a_s
    if use_ws:
        jar_w = _mv(J, ws) - aref
        cost_w = total_cost(ws, jar_w)
        better = cost_w < cost
        qacc, jar = torch.where(better[:, None], ws, a_s), torch.where(better[:, None], jar_w, jar)
        cost = torch.where(better, cost_w, cost)
    prev = torch.full_like(cost, float("inf"))
    for _ in range(iterations):
        force, quad_h, z = forces(jar)
        Mdacc = _mv(qM, qacc - a_s)
        yh = z.y / z.T[..., None]
        v = torch.cat([-torch.ones_like(mu)[..., None], mu[..., None] * yh * scale], dim=-1)
        W = (Dn / one_mu2 * z.middle * actN)[..., None, None] * v[..., :, None] * v[..., None, :]
        W[..., 1:, 1:] += (Dn * mu * z.cfac / z.T * z.middle * actN)[..., None, None] * (
            eye_f - yh[..., :, None] * yh[..., None, :]) * (scale[..., :, None] * scale[..., None, :])
        W = W + (z.bottom * actN)[..., None, None] * torch.diag_embed(D_c)
        H = rank1_rows(qM + 1e-8 * eye, J_h, torch.where(quad_h, D_h, 0.0))
        for s in range(S):
            for b in range(cd):
                c = Rc[:, s, 0] * W[:, s, 0, b, None]
                for a in range(1, cd):
                    c = c + Rc[:, s, a] * W[:, s, a, b, None]
                H = H + c[:, :, None] * Rc[:, s, b, None, :]
        p = -solve_pd_unrolled(H, Mdacc - jtf_rows(J, force))
        jp = _mv(J, p)
        pmp, pma = butterfly(dofs(p * _mv(qM, p))), butterfly(dofs(p * Mdacc))
        dxc = jp[:, nh:].reshape(B, S, cd)
        dN, dy = dxc[..., 0], dxc[..., 1:] * scale
        aq, bq, cq = z.T2, (z.y * dy).sum(-1), (dy * dy).sum(-1)
        h_bot = (D_c * dxc * dxc).sum(-1)
        t, lo, hi = torch.zeros_like(cost), torch.zeros_like(cost), torch.full_like(cost, 4.0)
        for _ls in range(max(ls_iterations, 1)):
            _, ft, qt = _row_costs_pure(jar[:, :nh] + t[:, None] * jp[:, :nh], D_h, fl_h, act_h, ne, nf)
            tc = t[:, None]
            Tt = torch.sqrt(torch.clamp(aq + 2.0 * bq * tc + cq * tc * tc, min=1e-24))
            Tp = (bq + cq * tc) / Tt
            Nt = z.N + tc * dN
            bot = mu * Nt <= -Tt
            mid = ~(bot | (Nt >= mu * Tt))
            cfac = (mu * Tt - Nt) / one_mu2
            g_m = -Dn * cfac * (dN - mu * Tp)
            h_m = Dn / one_mu2 * (mu * Tp - dN) ** 2 + Dn * mu * cfac / Tt * torch.clamp(cq - Tp * Tp, min=0.0)
            gb = torch.where(bot, Dn * (Nt * dN + bq + cq * tc), torch.where(mid, g_m, 0.0)) * actN
            hb = torch.where(bot, h_bot, torch.where(mid, h_m, 0.0)) * actN
            jp_h = jp[:, :nh]
            g = pma + t * pmp - lane_sum(ft * jp_h) + lane_sum(gb)
            hh = pmp + lane_sum(torch.where(qt, D_h, 0.0) * jp_h * jp_h) + lane_sum(hb)
            t, lo, hi = ls_bracket_step(t, lo, hi, g, hh)
        t = torch.clamp(t, 0.0, 4.0)
        qn, jn = qacc + t[:, None] * p, jar + t[:, None] * jp
        cn = total_cost(qn, jn)
        active = prev - cost > tol
        take = (cn < cost) & active
        qacc, jar = torch.where(take[:, None], qn, qacc), torch.where(take[:, None], jn, jar)
        prev, cost = torch.where(active, cost, prev), torch.where(take, cn, cost)
    force = forces(jar)[0]
    return qacc, force, jtf_rows(J, force)


def reordered(pa: dict, rng):
    """_newton_arrays on pa with rows permuted within their families and the
    dofs permuted, outputs in pa's order (kernels 4 and 5)."""
    import torch

    from ambersim_tpu_torch.engine.solver import _newton_arrays

    ne, nf, nefc, nv = pa["ne"], pa["nf"], pa["J"].shape[1], pa["a_s"].shape[1]
    r = torch.as_tensor(list(rng.permutation(ne)) + list(ne + rng.permutation(nf))
                        + list(ne + nf + rng.permutation(nefc - ne - nf)), device=pa["J"].device)
    d = torch.as_tensor(rng.permutation(nv), device=pa["J"].device)
    q = dict(pa, J=pa["J"][:, r][:, :, d].contiguous(), qM=pa["qM"][:, d][:, :, d].contiguous())
    q.update({k: pa[k][:, r].contiguous() for k in ("aref", "D", "fl", "act")})
    q.update({k: pa[k][:, d].contiguous() for k in ("a_s", "ws")})
    qacc, force, qfrc = _newton_arrays(**q, **KW)
    return qacc[:, torch.argsort(d)], force[:, torch.argsort(r)], qfrc[:, torch.argsort(d)]


def reordered_elliptic(pa: dict, rng, kw: dict):
    """_newton_arrays_elliptic on pa with head rows permuted within their
    families, the contacts permuted and the dofs permuted, outputs in pa's
    order."""
    import torch

    from ambersim_tpu_torch.engine.solver import _newton_arrays_elliptic

    ne, nf, nh, S, cd = pa["ne"], pa["nf"], pa["base"], pa["ncon"], pa["cdim"]
    nv = pa["a_s"].shape[1]
    sp = rng.permutation(S)
    head = list(rng.permutation(ne)) + list(ne + rng.permutation(nf)) + list(ne + nf + rng.permutation(nh - ne - nf))
    r = torch.as_tensor(head + [nh + s * cd + a for s in sp for a in range(cd)], device=pa["J"].device)
    d = torch.as_tensor(rng.permutation(nv), device=pa["J"].device)
    q = dict(pa, J=pa["J"][:, r][:, :, d].contiguous(), qM=pa["qM"][:, d][:, :, d].contiguous(),
             fr=pa["fr"][:, torch.as_tensor(sp, device=pa["J"].device)].contiguous())
    q.update({k: pa[k][:, r].contiguous() for k in ("aref", "D", "fl", "act")})
    q.update({k: pa[k][:, d].contiguous() for k in ("a_s", "ws")})
    qacc, force, qfrc = _newton_arrays_elliptic(**q, **kw)
    return qacc[:, torch.argsort(d)], force[:, torch.argsort(r)], qfrc[:, torch.argsort(d)]


def dense_path_shares(steps: list) -> int:
    """Kernel 5's shares on arm3's and cartpole's operands after each of
    `steps` steps, rolled out on the card and on the CPU."""
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.engine.forward import full_f32_matmul
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_dense

    dev = torch.device("cuda", 0)
    with full_f32_matmul():
        for name in ("arm3", "cartpole"):
            m = load_model(name, device=dev)
            kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
            for where in (dev, torch.device("cpu")):
                mr = m if where == dev else load_model(name, device=where)
                start = cs.PATHS[name]["start"](mr, 1024, where)
                for n in steps:
                    d = cs.pre_solve(m, rollout(mr, start, n).to(dev))
                    pa = dict(cs.solver_operands(m, d, seed=4), ne=int(m.skel.ne), nf=int(m.skel.nf))
                    got = newton_solve_dense(*(pa[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws",
                                                                "tol")), ne=pa["ne"], nf=pa["nf"], **kw)
                    plain = _newton_arrays(**pa, **kw)
                    exact = _newton_arrays(**cs.as_dtype(pa, torch.float64), **kw)
                    k_p, p_e, k_e = (cs.newton_within(a, b).double().mean().item()
                                     for a, b in ((got, plain), (plain, exact), (got, exact)))
                    print(f"kernel 5 {name}, rolled out {n} steps on {where.type}: share of envs within "
                          f"{cs.NEWTON_TOL}: kernel-plain {k_p:.4f}, plain-f64 {p_e:.4f}, kernel-f64 {k_e:.4f}",
                          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", type=int, nargs="+", default=[4, 5, 6], choices=(4, 5, 6))
    ap.add_argument("--nv", type=int, nargs="+", default=[1, 7, 18, 25, 32])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 80], help="kernel 4: seed = SEED + nv, as chip_smoke's "
                    "sweep (3) and tests/test_torch_cuda.py's (80)")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--paths", type=int, nargs="+", default=[], help="kernel 5 on its paths' operands after these "
                    "numbers of steps, on a card")
    args = ap.parse_args()
    if args.paths:
        return dense_path_shares(args.paths)

    import numpy as np
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch.engine.forward import full_f32_matmul
    from ambersim_tpu_torch.engine.solver import _newton_arrays, _newton_arrays_elliptic, cone_params
    from ambersim_tpu_torch.engine.solver import elliptic_total_cost

    def share(got, exact, within=cs.newton_within):
        return within(got, exact).double().mean().item()

    def line(what, plain, others: dict):
        worst = max(plain - min(v) for v in others.values())
        parts = "; ".join(f"{k} {min(v):.4f}" + (f"-{max(v):.4f}" if len(v) > 1 else "") for k, v in others.items())
        print(f"{what}: share of envs within tolerance of float64: plain {plain:.4f}; {parts}; "
              f"largest shortfall below plain {worst:+.4f}", flush=True)
        return worst

    def cost(pa, q):
        p = cs.as_dtype(pa, torch.float64)
        mu, scale = cone_params(p["fr"], p["impratio"], p["cdim"])
        q = q.double()
        jar = (p["J"] * q[:, None, :]).sum(-1) - p["aref"]
        return elliptic_total_cost(q, jar, p["qM"], p["a_s"], p["D"], p["fl"], p["act"], mu, scale, ne=p["ne"],
                                   nf=p["nf"], nh=p["base"], S=p["ncon"], cdim=p["cdim"])

    worst, worst_envs = {}, 0
    with full_f32_matmul():
        if 4 in args.kernel:
            for base in args.seeds:
                for nv in args.nv:
                    st, pa, bJ, _ = cs.synthetic_structured_problem(args.envs, seed=base + nv, device=args.device,
                                                                    nv=nv)
                    exact = _newton_arrays(**cs.as_dtype(pa, torch.float64), **KW)
                    plain = share(_newton_arrays(**pa, **KW), exact)
                    rng = np.random.default_rng(0)
                    fact64 = share(factored_newton(st, cs.as_dtype(pa, torch.float64), bJ.double(), **KW), exact)
                    w = line(f"kernel 4 nv={nv} seed={base + nv} (factored in float64: {fact64:.4f})", plain, {
                        "reordered": [share(reordered(pa, rng), exact) for _ in range(8)],
                        "factored": [share(factored_newton(st, pa, bJ, **KW), exact)]})
                    worst[4] = max(worst.get(4, -1.0), w)
        if 5 in args.kernel:
            for base in (80, 130):
                for nv in args.nv:
                    pa = cs.synthetic_dense_problem(args.envs, nv, seed=base + nv, device=args.device)
                    exact = _newton_arrays(**cs.as_dtype(pa, torch.float64), **KW)
                    plain = share(_newton_arrays(**pa, **KW), exact)
                    rng = np.random.default_rng(0)
                    w64 = share(warp_dense(cs.as_dtype(pa, torch.float64), **KW), exact)
                    w = line(f"kernel 5 nv={nv} seed={base + nv} (warp order in float64: {w64:.4f})", plain, {
                        "reordered": [share(reordered(pa, rng), exact) for _ in range(8)],
                        "warp order": [share(warp_dense(pa, **KW), exact)]})
                    worst[5] = max(worst.get(5, -1.0), w)
        if 6 in args.kernel:
            cases = []
            for nv in args.nv:
                for cd in range(2, 7):
                    nh = 9 if (nv + cd) % 2 else 0
                    cases.append((nv, nh, cd, 7 + nv + nh + cd, (cd != 4,)))
                cases.append((nv, 9, 2 + nv % 5, 120 + nv, (True, False)))
            for nv, nh, cd, seed, modes in cases:
                pa = cs.synthetic_elliptic_problem(args.envs, nv=nv, nh=nh, S=6, cdim=cd, seed=seed,
                                                   device=args.device)
                for use_ws in modes:
                    for iterations, ls_iterations, tol in ((3, 1, cs.ELLIPTIC_ENV_TOL),
                                                           (15, 15, cs.ELLIPTIC_CONVERGED_TOL)):
                        kw = dict(iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws)

                        def within(a, b):
                            return cs.env_rel_err(a, b, "")[0] <= tol

                        exact = _newton_arrays_elliptic(**cs.as_dtype(pa, torch.float64), **kw)
                        want = _newton_arrays_elliptic(**pa, **kw)
                        rng = np.random.default_rng(0)
                        runs = {"reordered": [reordered_elliptic(pa, rng, kw) for _ in range(4)],
                                "warp order": [warp_elliptic(pa, **kw)]}
                        w64 = share(warp_elliptic(cs.as_dtype(pa, torch.float64), **kw), exact, within)
                        what = (f"kernel 6 nv={nv} nh={nh} cdim={cd} seed={seed} ws={use_ws} "
                                f"({iterations} x {ls_iterations}; warp order in float64: {w64:.4f})")
                        w = line(what, share(want, exact, within),
                                 {k: [share(x, exact, within) for x in v] for k, v in runs.items()})
                        worst[6] = max(worst.get(6, -1.0), w)
                        if iterations == 15:
                            ref = torch.maximum(cost(pa, want[0]), cost(pa, exact[0]))
                            over = {k: [(cost(pa, x[0]) - ref) / ref.abs().clamp(min=1.0) for x in v]
                                    for k, v in runs.items()}
                            envs = {k: [int((e > cs.ELLIPTIC_COST_RTOL).sum()) for e in v] for k, v in over.items()}
                            ex = max(e.max().item() for v in over.values() for e in v)
                            counts = "; ".join(f"{k} {min(v)}-{max(v)}" for k, v in envs.items())
                            print(f"  converged, envs whose cost exceeds max(plain, float64) by more than "
                                  f"{cs.ELLIPTIC_COST_RTOL}: {counts} (largest excess {ex:.3e})", flush=True)
                            worst_envs = max(worst_envs, *(max(v) for v in envs.values()))
    for k, w in worst.items():
        print(f"kernel {k}: the largest shortfall of a float32 order below plain's share {w:+.4f}")
    if 6 in worst:
        print(f"kernel 6, converged: at most {worst_envs} envs of {args.envs} with a cost above max(plain, float64) "
              f"by more than {cs.ELLIPTIC_COST_RTOL}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
