"""Newton constraint solver: pyramidal and elliptic cones (port of the Newton
branches of ambersim_tpu/engine/solver.py).

Primal formulation (MuJoCo): minimize over qacc
    0.5*(a - a_smooth)^T M (a - a_smooth) + sum_i s_i(J_i a - aref_i)
with s_i quadratic on equality rows, Huber on friction rows and one-sided
quadratic on limit/contact rows; inactive rows contribute nothing. With
elliptic cones each condim-3 contact's rows [N, T1, T2] cost the squared
distance to the friction cone instead (bottom / middle / top zones).

`solve` routes by row layout and by nv, decided from shapes before any
launch. A CPU tensor takes the route's plain version; a CUDA tensor launches
the route's kernel (ops/newton.py) and never falls back to a plain version:
  * pyramidal rows that factor (PyramidStructure) -> kernel 4, plain
    `_newton_arrays` (batched _newton_arrays_jnp, solver.py:424);
  * other pyramidal rows -> kernel 5 on dense rows, the same plain version;
  * elliptic cones with one contiguous condim tail -> kernel 6, plain
    `_newton_arrays_elliptic` (batched _newton_arrays_elliptic_jnp, :624);
  * nv > ops.newton.MAX_NV (kernels 4-6 factor their Hessian with one warp)
    -> `_newton_arrays` / `_newton_arrays_elliptic` themselves on the card,
    their Hessian solve through engine.linalg.solve_pd, i.e. kernel 3, and
    the pyramidal one with Option.hessian_bf16's bfloat16 Hessian product
    when the model asks for it (check_slice refuses it elsewhere). This
    is the JAX package's own ladder on the TPU (solver.py:586-612, :855-873:
    structured -> dense -> jnp when the Newton kernels do not fit VMEM, as
    at the 32-body clutter scene's nv = 192), whose jnp Newton calls
    linalg.solve_pd under the env vmap (:481).
Any other elliptic layout raises NotImplementedError (io.bridge.check_slice).
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

from ambersim_tpu_torch.core.types import ConeType, Data, DisableBit, Model
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

        # closed-form scalar line search: along jar + t jp each block's N is
        # linear and T^2 quadratic in t
        dxc = jp[:, nh:].reshape(B, S, cdim)
        dN = dxc[..., 0]
        dy = dxc[..., 1:] * scale
        aq, bq, cq = z.T2, (z.y * dy).sum(-1), (dy * dy).sum(-1)
        N0 = z.N
        h_bot = (D_c * dxc * dxc).sum(-1)
        jar_h, jp_h = jar[:, :nh], jp[:, :nh]
        t = torch.zeros_like(cost)
        lo = torch.zeros_like(cost)
        hi = torch.full_like(cost, 4.0)
        for _ls in range(max(ls_iterations, 1)):
            _, force_t, quad_t = _row_costs_pure(jar_h + t[:, None] * jp_h, D_h, fl_h, act_h, ne, nf)
            g = pma + t * pmp - (force_t * jp_h).sum(-1)
            hh = pmp + torch.where(quad_t, D_h * jp_h * jp_h, 0.0).sum(-1)
            tc = t[:, None]
            Tt = torch.sqrt(torch.clamp(aq + 2.0 * bq * tc + cq * tc * tc, min=1e-24))
            Tp = (bq + cq * tc) / Tt
            Nt = N0 + tc * dN
            bot_t = mu * Nt <= -Tt
            mid_t = ~(bot_t | (Nt >= mu * Tt))
            cfac_t = (mu * Tt - Nt) / one_mu2
            g_b = Dn * (Nt * dN + bq + cq * tc)
            g_m = -Dn * cfac_t * (dN - mu * Tp)
            h_m = Dn / one_mu2 * (mu * Tp - dN) ** 2 + Dn * mu * cfac_t / Tt * torch.clamp(cq - Tp * Tp, min=0.0)
            gb = torch.where(bot_t, g_b, torch.where(mid_t, g_m, 0.0)) * actN
            hb = torch.where(bot_t, h_bot, torch.where(mid_t, h_m, 0.0)) * actN
            t, lo, hi = ls_bracket_step(t, lo, hi, g + gb.sum(-1), hh + hb.sum(-1))
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
    tail; NotImplementedError for any other elliptic layout."""
    meta = _elliptic_meta(s)
    if len(meta) != 1 or meta[0][3] is None:
        raise NotImplementedError(
            "elliptic cones with mixed contact condims (no single contiguous condim tail of the efc rows)"
        )
    cdim, slots, _, base, full = meta[0]
    return cdim, slots, base, full


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
    """Newton solve for qacc, efc_force and qfrc_constraint."""
    s = m.skel
    if s.nefc == 0 or s.nv == 0:
        return d.replace(qacc=d.qacc_smooth)
    iterations = int(max(m.opt.iterations, 1))
    ls_iterations = int(max(m.opt.ls_iterations, 1))
    use_ws = not (m.opt.disableflags & DisableBit.WARMSTART)
    tol = m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(), min=1.0)
    act = d.efc_active.to(d.qpos.dtype)
    # the plain versions on a CPU tensor; on the card the batched arrays
    # themselves when nv is past the Newton kernels (their Hessian solve is
    # kernel 3 through linalg.solve_pd)
    arrays = d.qpos.device.type == "cpu" or s.nv > MAX_NV
    rows = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, act, d.qacc_smooth, d.qacc_warmstart)
    statics = dict(iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws)
    if _is_elliptic(m):
        cdim, slots, base, full = elliptic_tail(s)
        fr = d.contact.friction if full else d.contact.friction[:, device_index(slots, d.qpos.device)]
        cone = dict(ne=int(s.ne), nf=int(s.nf), base=base, ncon=len(slots), cdim=cdim, **statics)
        if arrays:
            qacc, force, qfrc = _newton_arrays_elliptic(*rows, tol, fr, m.opt.impratio, **cone, solve=linalg.solve_pd)
        else:
            qacc, force, qfrc = newton_elliptic(*rows, tol.reshape(1), fr, impratio=m.opt.impratio, **cone)
        return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force=force, qacc_warmstart=qacc)

    st = _pyramid_structure(s)
    if arrays:
        qacc, force, qfrc = _newton_arrays(*rows, tol, ne=int(s.ne), nf=int(s.nf), **statics, solve=linalg.solve_pd,
                                           hess_bf16=bool(m.opt.hessian_bf16))
    elif st is not None:
        qacc, force, qfrc = newton_structured(d.efc_J, d.efc_bJ, d.efc_dsc, *rows[1:], tol.reshape(1), st=st,
                                              ne=int(s.ne), nf=int(s.nf), **statics)
    else:
        qacc, force, qfrc = newton_dense(*rows, tol.reshape(1), ne=int(s.ne), nf=int(s.nf), **statics)
    return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force=force, qacc_warmstart=qacc)
