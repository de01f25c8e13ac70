#!/usr/bin/env python3
"""How far float32 rounding alone moves kernel 4's synthetic Newton
problems from float64, for equally valid float32 orders of the same sums.

    python3 tools/newton_share.py [--nv 1 7 18 25 32] [--seeds 3 80] [--device cpu]

On chip_smoke.synthetic_structured_problem's own problems (80% of rows
active, D in [1, 10]; 4096 envs, seed = SEED + nv, 5 x 8 iterations, the
warmstart on) prints each env share within rtol/atol NEWTON_TOL of the
float64 solve (chip_smoke.newton_within) for:

  * plain: engine.solver._newton_arrays in float32 (what kernel 4 is held to);
  * reordered: the same with the rows permuted within their families and the
    dofs permuted (8 draws; the solve is the same in exact arithmetic);
  * factored: the same solve with kernel 4's algebra for the contacts
    (products with the basis N, U1, U2, the four pyramid forces folded
    before J^T f, the Hessian's contact part as a rank-3 update per contact),
    in float32 and, as a check of that algebra, in float64.

chip_smoke.NEWTON_F64_SLACK rests on these numbers. Imports nothing of JAX.
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


def reordered(pa: dict, rng):
    """_newton_arrays on pa with rows permuted within their families and the
    dofs permuted, outputs in pa's order."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nv", type=int, nargs="+", default=[1, 7, 18, 25, 32])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 80], help="seed = SEED + nv, as chip_smoke's sweep (3) "
                    "and tests/test_torch_cuda.py's (80)")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch.engine.forward import full_f32_matmul
    from ambersim_tpu_torch.engine.solver import _newton_arrays

    def share(got, exact):
        return cs.newton_within(got, exact).double().mean().item()

    with full_f32_matmul():
        for base in args.seeds:
            for nv in args.nv:
                st, pa, bJ, _ = cs.synthetic_structured_problem(cs.NUM_ENVS, seed=base + nv, device=args.device, nv=nv)
                exact = _newton_arrays(**cs.as_dtype(pa, torch.float64), **KW)
                plain = share(_newton_arrays(**pa, **KW), exact)
                rng = np.random.default_rng(0)
                shuffled = [share(reordered(pa, rng), exact) for _ in range(8)]
                fact = share(factored_newton(st, pa, bJ, **KW), exact)
                fact64 = share(factored_newton(st, cs.as_dtype(pa, torch.float64), bJ.double(), **KW), exact)
                print(f"nv={nv} seed={base + nv}: share within {cs.NEWTON_TOL} of float64: plain {plain:.4f}; "
                      f"reordered {min(shuffled):.4f}-{max(shuffled):.4f}; factored {fact:.4f} "
                      f"(float64 {fact64:.4f}); factored - plain {fact - plain:+.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
