"""Constraint solvers: Newton and preconditioned nonlinear CG, pyramidal and
elliptic cones (port of ambersim_tpu/engine/solver.py).

Primal formulation (MuJoCo): minimize over qacc
    0.5*(a - a_smooth)^T M (a - a_smooth) + sum_i s_i(J_i a - aref_i)
with s_i quadratic on equality rows, Huber on friction rows and one-sided
quadratic on limit/contact rows; inactive rows contribute nothing. With
elliptic cones each contact's rows [N, T1, T2, ...] cost the squared
distance to the friction cone instead (bottom / middle / top zones); a
condim-4 or -6 contact adds its torsional and rolling rows to the cone.

`solve` routes by row layout and by nv, decided from shapes before any
launch. A CPU tensor takes the route's plain version; a CUDA tensor launches
the route's kernel (ops/newton.py) and never falls back to a plain version:
  * pyramidal rows that factor (PyramidStructure) -> kernel 4, plain
    `_newton_arrays` (batched _newton_arrays_jnp, solver.py:424);
  * other pyramidal rows -> kernel 5 on dense rows, the same plain version;
  * elliptic cones with one contiguous condim tail (cdim 2-6) -> kernel 6,
    plain `_newton_arrays_elliptic` (batched _newton_arrays_elliptic_jnp, :624);
  * any other elliptic layout (condims mixed, condim-1 contacts among them)
    -> `_newton_elliptic_general` on every device (batched
    _solve_newton_elliptic, :949), for which the JAX package has no kernel
    either; its Hessian solve is engine.linalg.solve_pd, kernel 3 on the card;
  * nv > ops.newton.MAX_NV (kernels 4-6 factor their Hessian with one warp)
    -> `_newton_arrays` / `_newton_arrays_elliptic` themselves on the card,
    their Hessian solve through engine.linalg.solve_pd, i.e. kernel 3, and
    the pyramidal one with Option.hessian_bf16's bfloat16 Hessian product
    when the model asks for it (check_slice refuses it elsewhere). This
    is the JAX package's own ladder on the TPU (solver.py:586-612, :855-873:
    structured -> dense -> jnp when the Newton kernels do not fit VMEM, as
    at the 32-body clutter scene's nv = 192), whose jnp Newton calls
    linalg.solve_pd under the env vmap (:481).
With Option.solver CG, `solve` takes `_solve_cg` before any Newton route,
on every device (the JAX package has no CG kernel either): Polak-Ribiere
CG preconditioned with M^-1, whose applications are engine.linalg.cho_solve
on qM's factor, kernel 2 on the card, once before the loop and once an
iteration.
Reverse-mode gradients: each kernel route goes through
linalg.differentiable_dispatch, whose backward pass runs autograd through
the route's plain version (what the JAX package differentiates,
solver.py:615-619); kernel 4's factored operands (efc_bJ, efc_dsc) get no
gradient there, which reaches the same rows through efc_J. The batched
arrays differentiate directly, their Hessian solve through kernel 3's
Function.
Outside the kernels J^T diag(h) J is a batched matrix product (engine.forward
turns TF32 off for it); the matrix-vector products stay elementwise sums,
the order the CPU parity bars were set in.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core.types import ConeType, Data, DisableBit, Model, SolverType
from ambersim_tpu_torch.engine import linalg
from ambersim_tpu_torch.engine.constraint import _pyramid_structure
from ambersim_tpu_torch.engine.linalg import differentiable_dispatch, solve_pd_unrolled
from ambersim_tpu_torch.engine.schedule import device_index
from ambersim_tpu_torch.ops.newton import MAX_NV

_META_CACHE: dict = {}


def _elliptic_meta(s):
    """Static per-condim contact blocks [(cdim, slots (S,), rows (S, cdim),
    base, full)] of an elliptic row layout (JAX solver.py:47-95). `base` is
    the first row of the block when it is the single contiguous condim tail
    of the efc rows, else None; `full` marks slots == arange(ncon). Raises
    ValueError when the rows are not laid out for elliptic cones (opt.cone
    flipped on a model compiled with pyramidal cones)."""
    key = (s, "elliptic_meta")
    if key not in _META_CACHE:
        con_dim = np.asarray(s.con_dim)
        if len(con_dim):
            first = int(np.min(s.con_efcadr))
            if int(s.nefc) - first != int(sum(max(int(c), 1) for c in con_dim)):
                raise ValueError(
                    "elliptic solve on a model whose constraint layout is not elliptic: compile it with "
                    "cone='elliptic' (tools/export_model_npz.py --cone elliptic) instead of flipping opt.cone"
                )
        meta = []
        cdims = sorted(set(int(x) for x in con_dim))
        for cdim in cdims:
            if cdim == 1:
                continue
            slots = np.nonzero(con_dim == cdim)[0]
            rows = np.asarray(s.con_efcadr)[slots][:, None] + np.arange(cdim)[None, :]
            flat = rows.reshape(-1)
            base = None
            if (
                len(cdims) == 1
                and flat.size
                and np.array_equal(flat, np.arange(flat[0], flat[0] + flat.size))
                and int(flat[-1]) + 1 == int(s.nefc)
            ):
                base = int(flat[0])
            meta.append((cdim, slots, rows, base, bool(np.array_equal(slots, np.arange(int(s.ncon))))))
        _META_CACHE[key] = meta
    return _META_CACHE[key]


def _is_elliptic(m: Model) -> bool:
    return m.opt.cone == int(ConeType.ELLIPTIC) and len(_elliptic_meta(m.skel)) > 0


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


def _newton_arrays(J, qM, aref, D, fl, act, a_s, ws, tol, *, ne, nf, iterations, ls_iterations, use_ws,
                   solve=solve_pd_unrolled, hess_bf16=False):
    """Batched pyramidal Newton on dense rows in MuJoCo order. Returns
    (qacc, efc_force, J^T efc_force). Plain version of kernels 4 and 5 with
    the default `solve`; `solve` = engine.linalg.solve_pd makes it the
    large-nv route, whose Hessian solve is kernel 3 on the card.

    `hess_bf16` (Option.hessian_bf16, JAX solver.py:465-480) rounds both
    operands of J^T diag(h) J to bfloat16 and keeps the product and its sums
    in float32, as the JAX package's preferred_element_type=float32 does: a
    product of two bfloat16 values is exact in float32, so the rounded
    operands go through the float32 product (TF32 off in engine.forward).
    Only the Newton direction changes; gradient, cost and line search stay
    float32."""
    nv = a_s.shape[-1]
    J_h = J.to(torch.bfloat16).float() if hess_bf16 else J

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
        Jw = J * h[..., None]
        if hess_bf16:
            Jw = Jw.to(torch.bfloat16).float()
        H = qM + Jw.transpose(-1, -2) @ J_h + 1e-8 * eye
        p = -solve(H, grad)
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


def cone_params(fr: torch.Tensor, impratio, cdim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mu-scaled circular-cone parameters per contact: mu = mu0/sqrt(impratio)
    (B, S) and the friction-row scale mu_k/mu0*sqrt(impratio) (B, S, cdim-1)
    that maps row residuals to cone coordinates (JAX _elliptic_zone).
    fr (B, S, >= cdim-1) is the contacts' friction."""
    mu0 = torch.clamp(fr[..., 0], min=1e-12)
    sq = torch.sqrt(torch.as_tensor(impratio, dtype=fr.dtype, device=fr.device))
    return mu0 / sq, fr[..., : cdim - 1] / mu0[..., None] * sq


def ls_bracket_step(t, lo, hi, g, h):
    """One guarded bracketed Newton step on the line-search parameter: g and
    h are phi'(t) and phi''(t). phi' is monotone, so sign(g) keeps [lo, hi]
    a bracket; a Newton step outside it, or non-finite, is replaced by the
    midpoint through a select (JAX solver.py:774-778; kernel 6 does the same)."""
    neg = g < 0
    lo = torch.where(neg, torch.maximum(lo, t), lo)
    hi = torch.where(neg, hi, torch.minimum(hi, t))
    tn = t - g / torch.clamp(h, min=1e-12)
    ok = (tn > lo) & (tn < hi) & torch.isfinite(tn)
    return torch.where(ok, tn, 0.5 * (lo + hi)), lo, hi


class _Cone:
    """Zone state of every cone block at one jar, (B, S) planes (JAX
    _newton_arrays_elliptic_jnp's cone_state)."""

    def __init__(self, jar, nh, S, cdim, mu, scale, one_mu2):
        x = jar[:, nh:].reshape(jar.shape[0], S, cdim)
        self.N = x[..., 0]
        self.y = x[..., 1:] * scale
        self.T2 = (self.y * self.y).sum(-1)
        self.T = torch.sqrt(torch.clamp(self.T2, min=1e-24))
        self.bottom = mu * self.N <= -self.T
        top = self.N >= mu * self.T
        self.middle = ~(self.bottom | top)
        self.cfac = (mu * self.T - self.N) / one_mu2


class _Ray:
    """A cone block's terms of phi'(t) and phi''(t) along jar + t jp in
    closed form, (B, S) planes (JAX solver.py:330-382): each block's N(t) =
    N0 + t dN is linear and T(t)^2 = aq + 2 bq t + cq t^2 quadratic, so a
    line-search step needs no (S, cdim) tensor rebuild."""

    def __init__(self, z: _Cone, dxc, D_c, Dn, mu, scale, one_mu2, actN):
        self.dN = dxc[..., 0]
        dy = dxc[..., 1:] * scale
        self.aq, self.bq, self.cq = z.T2, (z.y * dy).sum(-1), (dy * dy).sum(-1)
        self.N0 = z.N
        self.h_bot = (D_c * dxc * dxc).sum(-1)
        self.Dn, self.mu, self.one_mu2, self.actN = Dn, mu, one_mu2, actN

    def terms(self, t):
        """The block's contributions to phi'(t) and phi''(t), each (B,)."""
        aq, bq, cq, dN, Dn, mu, one_mu2 = self.aq, self.bq, self.cq, self.dN, self.Dn, self.mu, self.one_mu2
        tc = t[:, None]
        Tt = torch.sqrt(torch.clamp(aq + 2.0 * bq * tc + cq * tc * tc, min=1e-24))
        Tp = (bq + cq * tc) / Tt
        Nt = self.N0 + tc * dN
        bot_t = mu * Nt <= -Tt
        mid_t = ~(bot_t | (Nt >= mu * Tt))
        cfac_t = (mu * Tt - Nt) / one_mu2
        g_b = Dn * (Nt * dN + bq + cq * tc)
        g_m = -Dn * cfac_t * (dN - mu * Tp)
        h_m = Dn / one_mu2 * (mu * Tp - dN) ** 2 + Dn * mu * cfac_t / Tt * torch.clamp(cq - Tp * Tp, min=0.0)
        gb = torch.where(bot_t, g_b, torch.where(mid_t, g_m, 0.0)) * self.actN
        hb = torch.where(bot_t, self.h_bot, torch.where(mid_t, h_m, 0.0)) * self.actN
        return gb.sum(-1), hb.sum(-1)


def elliptic_total_cost(qacc, jar, qM, a_s, D, fl, act, mu, scale, *, ne, nf, nh, S, cdim):
    """Elliptic primal cost per env at (qacc, jar = J qacc - aref)."""
    B = jar.shape[0]
    one_mu2 = 1.0 + mu * mu
    D_c = D[:, nh:].reshape(B, S, cdim)
    Dn, actN = D_c[..., 0], act[:, nh:].reshape(B, S, cdim)[..., 0]
    z = _Cone(jar, nh, S, cdim, mu, scale, one_mu2)
    cone = (
        torch.where(z.bottom, 0.5 * Dn * (z.N * z.N + z.T2), 0.0)
        + torch.where(z.middle, 0.5 * Dn * z.cfac * z.cfac * one_mu2, 0.0)
    ) * actN
    head, _, _ = _row_costs_pure(jar[:, :nh], D[:, :nh], fl[:, :nh], act[:, :nh], ne, nf)
    dacc = qacc - a_s
    return 0.5 * (dacc * _mv(qM, dacc)).sum(-1) + head.sum(-1) + cone.sum(-1)


def _newton_arrays_elliptic(
    J, qM, aref, D, fl, act, a_s, ws, tol, fr, impratio,
    *, ne, nf, base, ncon, cdim, iterations, ls_iterations, use_ws, solve=solve_pd_unrolled,
):
    """Batched elliptic Newton for one contiguous condim tail of `ncon`
    cone blocks starting at row `base`, rows in MuJoCo order; fr (B, ncon, 5)
    is the blocks' contact friction. Returns (qacc, efc_force, J^T
    efc_force). Plain version of kernel 6 (with the default `solve`, as in
    `_newton_arrays`): a batch-first port of _newton_arrays_elliptic_jnp
    (JAX solver.py:624-811), including its isfinite select in the line
    search."""
    B, _, nv = J.shape
    dtype = a_s.dtype
    S, nfr, nh = ncon, cdim - 1, base
    mu, scale = cone_params(fr, impratio, cdim)  # (B, S), (B, S, nfr)
    one_mu2 = 1.0 + mu * mu
    D_h, D_c = D[:, :nh], D[:, nh:].reshape(B, S, cdim)
    fl_h, act_h = fl[:, :nh], act[:, :nh]
    actN = act[:, nh:].reshape(B, S, cdim)[..., 0]
    Dn = D_c[..., 0]
    Rc = J[:, nh:].reshape(B, S, cdim, nv)
    J_h = J[:, :nh]
    eye = torch.eye(nv, dtype=dtype, device=J.device)
    eye_f = torch.eye(nfr, dtype=dtype, device=J.device)
    statics = dict(ne=ne, nf=nf, nh=nh, S=S, cdim=cdim)

    def total_cost(qacc, jar):
        return elliptic_total_cost(qacc, jar, qM, a_s, D, fl, act, mu, scale, **statics)

    def cone_force(z):
        fN = torch.where(z.bottom, -Dn * z.N, torch.where(z.middle, Dn * z.cfac, 0.0))
        fY = torch.where(
            z.bottom[..., None], -Dn[..., None] * z.y,
            torch.where(z.middle[..., None], (-Dn * z.cfac * mu / z.T)[..., None] * z.y, 0.0),
        )
        return (torch.cat([fN[..., None], fY * scale], dim=-1) * actN[..., None]).reshape(B, -1)

    def forces(jar):
        _, force_h, quad_h = _row_costs_pure(jar[:, :nh], D_h, fl_h, act_h, ne, nf)
        z = _Cone(jar, nh, S, cdim, mu, scale, one_mu2)
        return torch.cat([force_h, cone_force(z)], dim=1), quad_h, z

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

    for _ in range(iterations):
        force, quad_h, z = forces(jar)
        Mdacc = _mv(qM, qacc - a_s)
        grad = Mdacc - (J * force[..., None]).sum(-2)

        # Hessian: head quadratic rows + per-block W in row space
        h_h = torch.where(quad_h, D_h, 0.0)
        g_mid = Dn / one_mu2 * z.middle * actN
        curv = Dn * mu * z.cfac / z.T * z.middle * actN
        yh = z.y / z.T[..., None]
        bot_a = z.bottom * actN
        v = torch.cat([-torch.ones_like(mu)[..., None], mu[..., None] * yh * scale], dim=-1)  # (B, S, cdim)
        W = g_mid[..., None, None] * v[..., :, None] * v[..., None, :]
        curv_blk = curv[..., None, None] * (eye_f - yh[..., :, None] * yh[..., None, :]) * (
            scale[..., :, None] * scale[..., None, :]
        )
        W[..., 1:, 1:] += curv_blk
        W = W + bot_a[..., None, None] * torch.diag_embed(D_c)
        H = qM + (J_h * h_h[..., None]).transpose(-1, -2) @ J_h
        H = H + torch.einsum("bscv,bscd,bsdw->bvw", Rc, W, Rc) + 1e-8 * eye
        p = -solve(H, grad)
        jp = _mv(J, p)
        pmp = (p * _mv(qM, p)).sum(-1)
        pma = (p * Mdacc).sum(-1)

        # closed-form scalar line search (_Ray)
        ray = _Ray(z, jp[:, nh:].reshape(B, S, cdim), D_c, Dn, mu, scale, one_mu2, actN)
        jar_h, jp_h = jar[:, :nh], jp[:, :nh]
        t = torch.zeros_like(cost)
        lo = torch.zeros_like(cost)
        hi = torch.full_like(cost, 4.0)
        for _ls in range(max(ls_iterations, 1)):
            _, force_t, quad_t = _row_costs_pure(jar_h + t[:, None] * jp_h, D_h, fl_h, act_h, ne, nf)
            g = pma + t * pmp - (force_t * jp_h).sum(-1)
            hh = pmp + torch.where(quad_t, D_h * jp_h * jp_h, 0.0).sum(-1)
            gb, hb = ray.terms(t)
            t, lo, hi = ls_bracket_step(t, lo, hi, g + gb, hh + hb)
        t = torch.clamp(t, 0.0, 4.0)

        qacc_n = qacc + t[:, None] * p
        jar_n = jar + t[:, None] * jp
        cost_n = total_cost(qacc_n, jar_n)
        active_it = prev_cost - cost > tol
        take = (cost_n < cost) & active_it
        qacc = torch.where(take[:, None], qacc_n, qacc)
        jar = torch.where(take[:, None], jar_n, jar)
        prev_cost = torch.where(active_it, cost, prev_cost)
        cost = torch.where(take, cost_n, cost)

    force, _, _ = forces(jar)
    return qacc, force, (J * force[..., None]).sum(-2)


def elliptic_tail(s):
    """(cdim, slots, base, full) of the single contiguous elliptic condim
    tail (kernel 6's layout), or None for any other elliptic layout, which
    takes `_newton_elliptic_general`."""
    meta = _elliptic_meta(s)
    if len(meta) != 1 or meta[0][3] is None:
        return None
    cdim, slots, _, base, full = meta[0]
    return cdim, slots, base, full


def _cone_operands(D, act, blocks, impratio) -> list:
    """Per condim block of `blocks` (its rows (S, cdim) and friction): the
    rows, their D (B, S, cdim), the normal rows' activity (B, S) and the
    cone parameters mu (B, S) and scale (B, S, cdim-1)."""
    out = []
    for rows, fr in blocks:
        mu, scale = cone_params(fr, impratio, rows.shape[1])
        out.append(dict(rows=rows, D=D[:, rows], act=act[:, rows[:, 0]], mu=mu, scale=scale))
    return out


def _zone(x, c: dict) -> dict:
    """Cone projection state of one condim block at its rows' jar x
    (B, S, cdim) (JAX _elliptic_zone, solver.py:102-157): the block's cost
    on its normal rows (B, S), its row forces (B, S, cdim) and what the
    Hessian weights need."""
    B, S, cdim = x.shape
    mu, scale, Dn = c["mu"], c["scale"], c["D"][..., 0]
    one = 1.0 + mu * mu
    z = _Cone(x.reshape(B, -1), 0, S, cdim, mu, scale, one)
    bottom, middle, cfac = z.bottom, z.middle, z.cfac
    cost = torch.where(bottom, 0.5 * Dn * (z.N * z.N + z.T2), torch.where(middle, 0.5 * Dn * cfac * cfac * one, 0.0))
    yhat = z.y / z.T[..., None]
    fN = torch.where(bottom, -Dn * z.N, torch.where(middle, Dn * cfac, 0.0))
    fY = torch.where(bottom[..., None], -Dn[..., None] * z.y,
                     torch.where(middle[..., None], (-Dn * cfac * mu)[..., None] * yhat, 0.0))
    f_rows = torch.cat([fN[..., None], fY * scale], -1) * c["act"][..., None]
    return dict(cone=z, yhat=yhat, T=z.T, bottom=bottom, middle=middle, cfac=cfac, cost=cost * c["act"],
                f_rows=f_rows)


def _zone_W(z: dict, c: dict) -> torch.Tensor:
    """(B, S, cdim, cdim) Hessian weights of a block's rows from its zone
    state (JAX _elliptic_W, solver.py:160-197): middle zone Dn/(1+mu^2) v v^T
    with v = (-1, mu yhat scale) plus the norm's curvature Dn mu cfac / T
    (I - yhat yhat^T) on the friction dims (T >= 1e-12, so the JAX
    package's clamp of it is the identity), bottom zone diag(D)."""
    mu, scale, yhat, Dn = c["mu"], c["scale"], z["yhat"], c["D"][..., 0]
    v = torch.cat([-torch.ones_like(mu)[..., None], mu[..., None] * yhat * scale], -1)
    W_mid = (Dn / (1.0 + mu * mu))[..., None, None] * v[..., :, None] * v[..., None, :]
    eye_f = torch.eye(scale.shape[-1], dtype=mu.dtype, device=mu.device)
    curv = (Dn * mu * z["cfac"] / z["T"])[..., None, None] * (
        eye_f - yhat[..., :, None] * yhat[..., None, :]) * (scale[..., :, None] * scale[..., None, :])
    W_mid = W_mid + torch.nn.functional.pad(curv, (1, 0, 1, 0))
    W_bot = torch.diag_embed(c["D"])
    W = torch.where(z["middle"][..., None, None], W_mid, torch.where(z["bottom"][..., None, None], W_bot, 0.0))
    return W * c["act"][..., None, None]


def _head_cost(jar, D, fl, act, head, ne: int, nf: int):
    """(cost, force, quad) of the pyramidal head rows `head` (every row
    outside the cone blocks, in row order: equality and friction rows
    first, so ne and nf hold for them)."""
    return _row_costs_pure(jar[:, head], D[:, head], fl[:, head], act[:, head], ne, nf)


def _total(qacc, jar, qM, a_s, D, fl, act, head, cones, ne: int, nf: int):
    dacc = qacc - a_s
    cone_cost = sum(_zone(jar[:, c["rows"]], c)["cost"].sum(-1) for c in cones)
    return 0.5 * (dacc * _mv(qM, dacc)).sum(-1) + _head_cost(jar, D, fl, act, head, ne, nf)[0].sum(-1) + cone_cost


def general_total_cost(qacc, jar, qM, a_s, D, fl, act, head, blocks, impratio, *, ne: int, nf: int):
    """Elliptic primal cost per env at (qacc, jar = J qacc - aref) on any
    elliptic layout (JAX _total_cost's general branch, solver.py:264-298):
    the smooth cost, the head rows' and each cone block's."""
    return _total(qacc, jar, qM, a_s, D, fl, act, head, _cone_operands(D, act, blocks, impratio), ne, nf)


def _line_search(jar, jp, pma, pmp, D, fl, act, head, cones, ne: int, nf: int, ls_iterations: int, zones=None):
    """The general _line_search's guarded bracketed scalar Newton on t, the
    head rows' terms on their gathered rows, each cone block's in closed
    form (_Ray; `zones` are the blocks' zone states at jar where known)."""
    jar_h, jp_h, D_h, fl_h, act_h = jar[:, head], jp[:, head], D[:, head], fl[:, head], act[:, head]
    if zones is None:
        zones = [_zone(jar[:, c["rows"]], c) for c in cones]
    rays = [_Ray(z["cone"], jp[:, c["rows"]], c["D"], c["D"][..., 0], c["mu"], c["scale"], 1.0 + c["mu"] * c["mu"],
                 c["act"]) for c, z in zip(cones, zones)]
    t = torch.zeros_like(pma)
    lo = torch.zeros_like(pma)
    hi = torch.full_like(pma, 4.0)
    for _ in range(max(ls_iterations, 1)):
        _, force, quad = _row_costs_pure(jar_h + t[:, None] * jp_h, D_h, fl_h, act_h, ne, nf)
        g = pma + t * pmp - (force * jp_h).sum(-1)
        h = pmp + torch.where(quad, D_h * jp_h * jp_h, 0.0).sum(-1)
        for ray in rays:
            gb, hb = ray.terms(t)
            g, h = g + gb, h + hb
        t, lo, hi = ls_bracket_step(t, lo, hi, g, h)
    return torch.clamp(t, 0.0, 4.0)


def general_line_search(jar, jp, pma, pmp, D, fl, act, head, blocks, impratio, *, ne: int, nf: int,
                        ls_iterations: int):
    """(B,) step t in [0, 4] along jar + t jp: the guarded bracketed scalar
    Newton of the JAX package's general _line_search (solver.py:299-410).
    phi'(t) = pma + t pmp - force(t) . jp and phi''(t) = pmp + the quadratic
    head rows' D jp^2 + each block's jp_rows^T W(t) jp_rows, the last two
    in the closed form of its scalar path (`_Ray`), the same function."""
    return _line_search(jar, jp, pma, pmp, D, fl, act, head, _cone_operands(D, act, blocks, impratio), ne, nf,
                        ls_iterations)


def _newton_elliptic_general(J, qM, aref, D, fl, act, a_s, ws, tol, head, blocks, impratio,
                             *, ne, nf, iterations, ls_iterations, use_ws, solve=solve_pd_unrolled):
    """Batched elliptic Newton on any elliptic layout: condim blocks of
    2-6 rows anywhere among the rows, condim-1 contacts among the
    pyramidal head rows `head` (every other row, in order). `blocks` is
    [(rows (S, cdim) row indices on J's device, friction (B, S, >=
    cdim-1))] (elliptic_blocks). Returns (qacc, efc_force, J^T efc_force).
    A batch-first port of _solve_newton_elliptic (JAX solver.py:949-1022)
    with the general branch of its _line_search (general_line_search);
    the head rows and each block are summed apart (J^T f, the Hessian, the
    line search's phi' and phi''). No kernel of the JAX package takes this
    layout; its Hessian solve is `solve` (engine.linalg.solve_pd, kernel 3
    on the card) once an iteration."""
    nv = J.shape[-1]
    eye = torch.eye(nv, dtype=a_s.dtype, device=a_s.device)
    cones = _cone_operands(D, act, blocks, impratio)
    J_h, D_h = J[:, head], D[:, head]
    J_b = [J[:, c["rows"]] for c in cones]  # (B, S, cdim, nv) each

    def total_cost(qacc, jar):
        return _total(qacc, jar, qM, a_s, D, fl, act, head, cones, ne, nf)

    def forces(jar):
        _, force, quad = _head_cost(jar, D, fl, act, head, ne, nf)
        return force, quad, [_zone(jar[:, c["rows"]], c) for c in cones]

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

    for _ in range(iterations):
        force, quad, zones = forces(jar)
        Mdacc = _mv(qM, qacc - a_s)
        grad = Mdacc - (J_h * force[..., None]).sum(-2)
        H = qM + (J_h * torch.where(quad, D_h, 0.0)[..., None]).transpose(-1, -2) @ J_h
        for c, Jb, z in zip(cones, J_b, zones):
            grad = grad - (Jb * z["f_rows"][..., None]).sum((1, 2))
            WJ = (_zone_W(z, c) @ Jb).flatten(1, 2)  # (B, S cdim, nv)
            H = H + Jb.flatten(1, 2).transpose(-1, -2) @ WJ
        p = -solve(H + 1e-8 * eye, grad)
        jp = _mv(J, p)
        t = _line_search(jar, jp, (p * Mdacc).sum(-1), (p * _mv(qM, p)).sum(-1), D, fl, act, head, cones, ne, nf,
                         ls_iterations, zones)

        qacc_n = qacc + t[:, None] * p
        jar_n = jar + t[:, None] * jp
        cost_n = total_cost(qacc_n, jar_n)
        active_it = prev_cost - cost > tol
        take = (cost_n < cost) & active_it
        qacc = torch.where(take[:, None], qacc_n, qacc)
        jar = torch.where(take[:, None], jar_n, jar)
        prev_cost = torch.where(active_it, cost, prev_cost)
        cost = torch.where(take, cost_n, cost)

    force_h, _, zones = forces(jar)
    force = torch.zeros_like(jar)
    force[:, head] = force_h
    for c, z in zip(cones, zones):
        force[:, c["rows"]] = z["f_rows"]
    return qacc, force, (J * force[..., None]).sum(-2)


def _layout(m: Model, d: Data, D, act) -> tuple:
    """(head, cones) of m's rows: every row pyramidal (slice(None), []), or
    under elliptic cones the rows outside the cone blocks and each condim
    block's operands (_cone_operands)."""
    if not _is_elliptic(m):
        return slice(None), []
    head, blocks = elliptic_blocks(m.skel, d)
    return head, _cone_operands(D, act, blocks, m.opt.impratio)


def _layout_costs(jar, D, fl, act, head, cones, ne: int, nf: int):
    """Per-row (cost, force, quad) of every row, (B, nefc) each: the head
    rows' pyramidal terms, each cone block's cost on its normal row and its
    forces on its rows, with no quadratic rows (their Hessian is _zone_W's)."""
    if not cones:
        return _head_cost(jar, D, fl, act, head, ne, nf)
    cost, force = torch.zeros_like(jar), torch.zeros_like(jar)
    quad = torch.zeros(jar.shape, dtype=torch.bool, device=jar.device)
    cost[:, head], force[:, head], quad[:, head] = _head_cost(jar, D, fl, act, head, ne, nf)
    for c in cones:
        z = _zone(jar[:, c["rows"]], c)
        cost[:, c["rows"][:, 0]] = z["cost"]
        force[:, c["rows"]] = z["f_rows"]
    return cost, force, quad


def _row_costs(m: Model, d: Data, jar):
    """Per-row cost, force (-dcost/djar) and quadratic mask of m's rows at
    jar, (B, nefc) each (JAX solver.py:233-261): pyramidal rows, and under
    elliptic cones each block's cone terms on its rows, contiguous tail or
    any other layout."""
    s = m.skel
    act = d.efc_active.to(jar.dtype)
    head, cones = _layout(m, d, d.efc_D, act)
    return _layout_costs(jar, d.efc_D, d.efc_frictionloss, act, head, cones, int(s.ne), int(s.nf))


def _solve_cg(m: Model, d: Data, tol, *, iterations: int, ls_iterations: int, use_ws: bool):
    """Polak-Ribiere nonlinear CG on the primal cost, preconditioned with
    M^-1, an exact line search an iteration (JAX _solve_cg, solver.py:
    1024-1086, batch-first). Returns (qacc, efc_force, J^T efc_force).

    The cost is the JAX package's `_total_cost` (solver.py:264-296; `_total`
    here, the single tail's closed form being _zone's cost) and the line
    search its `_line_search` (solver.py:299-408): the generic path's
    guarded bracketed Newton on t for pyramidal rows (not the Newton
    arrays' unguarded steps), each cone block in the closed form of its
    scalar path (`_line_search` here). M^-1 g is
    linalg.cho_solve on d.qLD: before the loop and once an iteration. As
    in the JAX package, an iteration's step is kept only where it lowers
    the cost and the cost before it fell by more than tol from the one
    before that (prev_cost, carried unmasked); the gradient is taken again
    at the kept point either way, beta = max(0, g_n (Mg_n - Mg) / max(g Mg,
    1e-12)), and the result is the warmstart of the next step."""
    s = m.skel
    ne, nf = int(s.ne), int(s.nf)
    J, aref, qM, a_s = d.efc_J, d.efc_aref, d.qM, d.qacc_smooth
    D, fl = d.efc_D, d.efc_frictionloss
    act = d.efc_active.to(a_s.dtype)
    head, cones = _layout(m, d, D, act)

    def total_cost(qacc, jar):
        return _total(qacc, jar, qM, a_s, D, fl, act, head, cones, ne, nf)

    def force_at(jar):
        return _layout_costs(jar, D, fl, act, head, cones, ne, nf)[1]

    def grad(qacc, jar):
        return _mv(qM, qacc - a_s) - (J * force_at(jar)[..., None]).sum(-2)

    jar = _mv(J, a_s) - aref
    cost = total_cost(a_s, jar)
    qacc = a_s
    if use_ws:
        jar_w = _mv(J, d.qacc_warmstart) - aref
        cost_w = total_cost(d.qacc_warmstart, jar_w)
        better = cost_w < cost
        qacc = torch.where(better[:, None], d.qacc_warmstart, a_s)
        jar = torch.where(better[:, None], jar_w, jar)
        cost = torch.where(better, cost_w, cost)
    g = grad(qacc, jar)
    mg = linalg.cho_solve(d.qLD, g)
    p = -mg
    prev_cost = torch.full_like(cost, float("inf"))

    for _ in range(iterations):
        jp = _mv(J, p)
        t = _line_search(jar, jp, (p * _mv(qM, qacc - a_s)).sum(-1), (p * _mv(qM, p)).sum(-1), D, fl, act, head,
                         cones, ne, nf, ls_iterations)
        qacc_n = qacc + t[:, None] * p
        jar_n = jar + t[:, None] * jp
        cost_n = total_cost(qacc_n, jar_n)
        improved = (cost_n < cost) & (prev_cost - cost > tol)
        qacc_n = torch.where(improved[:, None], qacc_n, qacc)
        jar_n = torch.where(improved[:, None], jar_n, jar)
        g_n = grad(qacc_n, jar_n)
        mg_n = linalg.cho_solve(d.qLD, g_n)
        beta = torch.clamp((g_n * (mg_n - mg)).sum(-1) / torch.clamp((g * mg).sum(-1), min=1e-12), min=0.0)
        p = -mg_n + beta[:, None] * p
        prev_cost = cost
        cost = torch.where(improved, cost_n, cost)
        qacc, jar, g, mg = qacc_n, jar_n, g_n, mg_n

    force = force_at(jar)
    return qacc, force, (J * force[..., None]).sum(-2)


def elliptic_blocks(s, d: Data) -> tuple:
    """(head, blocks) of an elliptic layout for `_newton_elliptic_general`
    on d's device: the rows outside every cone block, in order, and each
    condim block's rows (S, cdim) with its contacts' friction."""
    dev = d.qpos.device
    meta = _elliptic_meta(s)
    cone_rows = np.concatenate([rows.reshape(-1) for _, _, rows, _, _ in meta])
    head = device_index(np.setdiff1d(np.arange(int(s.nefc)), cone_rows), dev)
    return head, [(device_index(rows, dev), d.contact.friction if full else
                   d.contact.friction[:, device_index(slots, dev)]) for _, slots, rows, _, full in meta]


def _structured_kernel(J, bJ, dsc, qM, aref, D, fl, act, a_s, ws, tol, *, st, ne, nf, **kw):
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    return newton_solve_structured(J, bJ, dsc, qM, aref, D, fl, act, a_s, ws, tol, st=st, **kw)


def _structured_plain(J, bJ, dsc, *rows, st, **kw):
    """Kernel 4's plain version on its arguments: the dense rows J alone."""
    return _newton_arrays(J, *rows, **kw)


def _dense_kernel(*rows, **kw):
    from ambersim_tpu_torch.ops.newton import newton_solve_dense

    return newton_solve_dense(*rows, **kw)


def _elliptic_kernel(*rows, impratio, **kw):
    from ambersim_tpu_torch.ops.newton import newton_solve_elliptic

    return newton_solve_elliptic(*rows, impratio, **kw)


def _elliptic_plain(*rows, impratio, **kw):
    return _newton_arrays_elliptic(*rows, impratio, **kw)


# kernels 4, 5 and 6, each with its plain version's gradient
newton_structured = differentiable_dispatch(_structured_kernel, _structured_plain)
newton_dense = differentiable_dispatch(_dense_kernel, _newton_arrays)
newton_elliptic = differentiable_dispatch(_elliptic_kernel, _elliptic_plain)


def solve(m: Model, d: Data) -> Data:
    """Constraint solve for qacc, efc_force and qfrc_constraint: CG when the
    model asks for it (JAX solver.py:411-421), else Newton by the routes
    above. check_slice refuses the PGS solver, which the JAX package runs
    as Newton without a word."""
    s = m.skel
    if s.nefc == 0 or s.nv == 0:
        return d.replace(qacc=d.qacc_smooth)
    iterations = int(max(m.opt.iterations, 1))
    ls_iterations = int(max(m.opt.ls_iterations, 1))
    use_ws = not (m.opt.disableflags & DisableBit.WARMSTART)
    # tolerance nv max(total mass, 1), per env with a per-env body_mass:
    # CG and the general elliptic solve keep each env's (the JAX package
    # runs them under vmap); the Newton kernels and their plain versions
    # take its minimum over envs, the JAX package's vmap rule for its
    # kernels (solver.py:572-575, 846-851), so no env stops early on
    # another's tolerance
    tol = m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(-1), min=1.0)
    if m.opt.solver == int(SolverType.CG):
        qacc, force, qfrc = _solve_cg(m, d, tol, iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws)
        return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force=force, qacc_warmstart=qacc)
    act = d.efc_active.to(d.qpos.dtype)
    # the plain versions on a CPU tensor; on the card the batched arrays
    # themselves when nv is past the Newton kernels (their Hessian solve is
    # kernel 3 through linalg.solve_pd)
    arrays = d.qpos.device.type == "cpu" or s.nv > MAX_NV
    rows = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, act, d.qacc_smooth, d.qacc_warmstart)
    statics = dict(iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws)
    if _is_elliptic(m):
        tail = elliptic_tail(s)
        if tail is None:
            # any other elliptic layout: the general path, Hessian solves through kernel 3
            qacc, force, qfrc = _newton_elliptic_general(*rows, tol, *elliptic_blocks(s, d), m.opt.impratio, ne=int(s.ne),
                                                         nf=int(s.nf), **statics, solve=linalg.solve_pd)
            return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force=force, qacc_warmstart=qacc)
        tol = tol.min()
        cdim, slots, base, full = tail
        fr = d.contact.friction if full else d.contact.friction[:, device_index(slots, d.qpos.device)]
        cone = dict(ne=int(s.ne), nf=int(s.nf), base=base, ncon=len(slots), cdim=cdim, **statics)
        if arrays:
            qacc, force, qfrc = _newton_arrays_elliptic(*rows, tol, fr, m.opt.impratio, **cone, solve=linalg.solve_pd)
        else:
            qacc, force, qfrc = newton_elliptic(*rows, tol.reshape(1), fr, impratio=m.opt.impratio, **cone)
        return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force=force, qacc_warmstart=qacc)

    st = _pyramid_structure(s)
    tol = tol.min()
    if arrays:
        qacc, force, qfrc = _newton_arrays(*rows, tol, ne=int(s.ne), nf=int(s.nf), **statics, solve=linalg.solve_pd,
                                           hess_bf16=bool(m.opt.hessian_bf16))
    elif st is not None:
        qacc, force, qfrc = newton_structured(d.efc_J, d.efc_bJ, d.efc_dsc, *rows[1:], tol.reshape(1), st=st,
                                              ne=int(s.ne), nf=int(s.nf), **statics)
    else:
        qacc, force, qfrc = newton_dense(*rows, tol.reshape(1), ne=int(s.ne), nf=int(s.nf), **statics)
    return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force=force, qacc_warmstart=qacc)
