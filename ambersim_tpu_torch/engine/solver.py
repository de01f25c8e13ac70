"""Pyramidal Newton constraint solver (port of the pyramidal branch of
ambersim_tpu/engine/solver.py).

Primal formulation (MuJoCo): minimize over qacc
    0.5*(a - a_smooth)^T M (a - a_smooth) + sum_i s_i(J_i a - aref_i)
with s_i quadratic on equality rows, Huber on friction rows and one-sided
quadratic on limit/contact rows; inactive rows contribute nothing.

On CUDA tensors `solve` runs kernel 4 (ops/newton.py) on the factored row
layout; on CPU tensors it runs `_newton_arrays`, a batched port of
_newton_arrays_jnp (solver.py:424) with _row_costs_pure (:207), which is
the plain version the kernel is held against.
"""

from __future__ import annotations

import torch

from ambersim_tpu_torch.core.types import Data, DisableBit, Model
from ambersim_tpu_torch.engine.constraint import _pyramid_structure
from ambersim_tpu_torch.engine.linalg import solve_pd_unrolled


def _row_costs_pure(jar: torch.Tensor, D, fl, active, ne: int, nf: int):
    """Per-row cost, force (-dcost/djar) and quadratic-region mask for
    pyramidal rows in MuJoCo order (ne equality rows, then nf friction rows)."""
    idx = torch.arange(jar.shape[-1], device=jar.device)
    is_eq = idx < ne
    is_fric = (idx >= ne) & (idx < ne + nf)
    one_sided = ~(is_eq | is_fric)
    act_b = active if active.dtype == torch.bool else active > 0.5

    quad_cost = 0.5 * D * jar * jar
    quad_force = -D * jar
    lin = (D * jar).abs() > fl  # friction Huber: linear beyond |D*jar| > fl
    fric_cost = torch.where(lin, fl * jar.abs() - 0.5 * fl * fl / torch.clamp(D, min=1e-12), quad_cost)
    fric_force = torch.where(lin, -torch.sign(jar) * fl, quad_force)

    gated = torch.where(one_sided, jar < 0, True)
    cost = torch.where(is_fric, fric_cost, quad_cost) * gated * act_b
    force = torch.where(is_fric, fric_force, quad_force) * gated * act_b
    quad = torch.where(is_fric, ~lin, gated) & act_b
    return cost, force, quad


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (B, r, c) x (B, c) -> (B, r)."""
    return (A * x[:, None, :]).sum(-1)


def _newton_arrays(J, qM, aref, D, fl, act, a_s, ws, tol, *, ne, nf, iterations, ls_iterations, use_ws):
    """Batched pyramidal Newton on dense rows in MuJoCo order. Returns
    (qacc, efc_force, J^T efc_force)."""
    nv = a_s.shape[-1]

    def total_cost(qacc, jar):
        dacc = qacc - a_s
        cost, _, _ = _row_costs_pure(jar, D, fl, act, ne, nf)
        return 0.5 * (dacc * _mv(qM, dacc)).sum(-1) + cost.sum(-1)

    jar = _mv(J, a_s) - aref
    cost = total_cost(a_s, jar)
    qacc = a_s
    if use_ws:
        jar_w = _mv(J, ws) - aref
        cost_w = total_cost(ws, jar_w)
        better = cost_w < cost
        qacc = torch.where(better[:, None], ws, a_s)
        jar = torch.where(better[:, None], jar_w, jar)
        cost = torch.where(better, cost_w, cost)
    prev_cost = torch.full_like(cost, float("inf"))
    eye = torch.eye(nv, dtype=a_s.dtype, device=a_s.device)

    for _ in range(iterations):
        _, force, quad = _row_costs_pure(jar, D, fl, act, ne, nf)
        Mdacc = _mv(qM, qacc - a_s)
        grad = Mdacc - (J * force[..., None]).sum(-2)
        h = torch.where(quad, D, 0.0)
        H = qM + (J * h[..., None]).transpose(-1, -2) @ J + 1e-8 * eye
        p = -solve_pd_unrolled(H, grad)
        jp = _mv(J, p)
        pmp = (p * _mv(qM, p)).sum(-1)
        pma = (p * Mdacc).sum(-1)

        t = torch.zeros_like(cost)
        for _ls in range(max(ls_iterations, 1)):
            _, force_t, quad_t = _row_costs_pure(jar + t[:, None] * jp, D, fl, act, ne, nf)
            g = pma + t * pmp - (force_t * jp).sum(-1)
            hh = pmp + torch.where(quad_t, D * jp * jp, 0.0).sum(-1)
            t = t - g / torch.clamp(hh, min=1e-12)
        t = torch.where(torch.isfinite(t), torch.clamp(t, 0.0, 4.0), 0.0)

        qacc_n = qacc + t[:, None] * p
        jar_n = jar + t[:, None] * jp
        cost_n = total_cost(qacc_n, jar_n)
        active_it = prev_cost - cost > tol
        take = (cost_n < cost) & active_it
        qacc = torch.where(take[:, None], qacc_n, qacc)
        jar = torch.where(take[:, None], jar_n, jar)
        prev_cost = torch.where(active_it, cost, prev_cost)
        cost = torch.where(take, cost_n, cost)

    _, force, _ = _row_costs_pure(jar, D, fl, act, ne, nf)
    return qacc, force, (J * force[..., None]).sum(-2)


def solve(m: Model, d: Data) -> Data:
    """Newton solve for qacc, efc_force and qfrc_constraint."""
    s = m.skel
    if s.nefc == 0 or s.nv == 0:
        return d.replace(qacc=d.qacc_smooth)
    st = _pyramid_structure(s)
    iterations = int(max(m.opt.iterations, 1))
    ls_iterations = int(max(m.opt.ls_iterations, 1))
    use_ws = not (m.opt.disableflags & DisableBit.WARMSTART)
    tol = m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(), min=1.0)
    act = d.efc_active.to(d.qpos.dtype)
    if d.qpos.device.type == "cpu":
        qacc, force, qfrc = _newton_arrays(
            d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, act, d.qacc_smooth, d.qacc_warmstart, tol,
            ne=int(s.ne), nf=int(s.nf), iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws,
        )
    else:
        from ambersim_tpu_torch.ops.newton import newton_solve_structured

        qacc, force, qfrc = newton_solve_structured(
            d.efc_J, d.efc_bJ, d.efc_dsc, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, act,
            d.qacc_smooth, d.qacc_warmstart, tol.reshape(1),
            st=st, iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws,
        )
    return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force=force, qacc_warmstart=qacc)
