"""Noslip post-pass: Gauss-Seidel on the friction rows' dual with the
regularization removed and the normal forces frozen (mjOption.
noslip_iterations; port of ambersim_tpu/engine/noslip.py).

With A = J M^-1 J^T and b = aref - J qacc_smooth the constraint forces
minimize E(f) = 0.5 f^T A f - f^T b over the cones; res = A f - b is its
gradient. A sweep updates, in efc row order:

  * each frictionloss row i: f_i <- clip(f_i - res_i / A_ii, -floss, floss);
  * each pyramidal contact's friction axis pair (i1, i2): the pair sum s is
    frozen and x = f1 - f2 takes one Newton step clipped to |x| <= s;
  * each elliptic contact's friction rows: one block-Newton step (normal
    frozen), then the cone's scaling onto ||f_t / mu|| <= f_N.

Gauss-Seidel is sequential by definition: the updates run one after the
other, each over the whole env batch, and are never merged or reordered.
The walk is a plan built once per skeleton (`noslip_plan`), so that an
update is a handful of tensor ops on precomputed columns of A. M^-1 J^T is
one engine.linalg.cho_solve of every efc row against qM's factor: kernel 2
with k = nefc right-hand sides per env on the card, the factors read in
place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ambersim_tpu_torch.core.types import ConeType, Data, Model
from ambersim_tpu_torch.engine import linalg
from ambersim_tpu_torch.engine.schedule import device_index

_EPS = 1e-12
_PLANS: dict = {}


@dataclasses.dataclass(frozen=True)
class NoslipPlan:
    """The sweep's updates in row order: frictionloss rows, then per contact
    slot its pyramidal axis pairs (i1, i1 + 1) or its elliptic block (the
    normal row, the friction rows, the slot)."""

    fl_rows: tuple
    pairs: tuple  # i1 of each pair, i2 = i1 + 1
    blocks: tuple  # (adr, cdim, slot)
    walk: tuple  # ("fl", index) / ("pair", index) / ("block", index), in update order

    @property
    def updates(self) -> int:
        return len(self.walk)


def noslip_plan(s, elliptic: bool) -> NoslipPlan:
    """The sweep of skeleton `s` under pyramidal or elliptic cones (JAX
    noslip.py:80-108), built once per skeleton and cone."""
    key = (s, elliptic)
    if key not in _PLANS:
        ne, nf = int(s.ne), int(s.nf)
        fl_rows = tuple(range(ne, ne + nf))
        walk = [("fl", i) for i in range(nf)]
        pairs, blocks = [], []
        for slot in range(int(s.ncon)):
            adr, cdim = int(s.con_efcadr[slot]), int(s.con_dim[slot])
            if cdim <= 1:
                continue
            if elliptic:
                walk.append(("block", len(blocks)))
                blocks.append((adr, cdim, slot))
            else:
                for k in range(cdim - 1):
                    walk.append(("pair", len(pairs)))
                    pairs.append(adr + 2 * k)
        _PLANS[key] = NoslipPlan(fl_rows, tuple(pairs), tuple(blocks), tuple(walk))
    return _PLANS[key]


def _sweep(plan: NoslipPlan, f, res, cols: dict) -> tuple:
    """One Gauss-Seidel sweep over the plan's updates; returns the new f and
    res. Each update makes new tensors (select_scatter / slice_scatter and
    res + v) and writes none it was given, so autograd can record the
    sweep."""
    for kind, u in plan.walk:
        if kind == "fl":
            i = plan.fl_rows[u]
            x = torch.clamp(f[:, i] - res[:, i] / cols["fl_diag"][:, u], -cols["floss"][:, u], cols["floss"][:, u])
            res = res + cols["fl_col"][:, :, u] * (x - f[:, i])[:, None]
            f = f.select_scatter(x, 1, i)
        elif kind == "pair":
            i = plan.pairs[u]
            fp, rp = f[:, i:i + 2], res[:, i:i + 2]
            s, x = fp[:, 0] + fp[:, 1], fp[:, 0] - fp[:, 1]
            x_new = torch.clamp(x - 0.5 * (rp[:, 0] - rp[:, 1]) / cols["pair_h"][:, u], -s, s)
            df = 0.5 * (x_new - x)
            res = res + cols["pair_col"][:, :, u] * df[:, None]
            f = f.slice_scatter(fp + df[:, None] * cols["pm"], 1, i, i + 2)
        else:
            adr, cdim, slot = plan.blocks[u]
            rows = slice(adr + 1, adr + cdim)
            ft = f[:, rows] - torch.linalg.solve(cols["block_A"][u], res[:, rows])
            mu = torch.clamp(cols["friction"][:, slot, : cdim - 1], min=_EPS)
            fN = f[:, adr]
            nrm = torch.linalg.vector_norm(ft / mu, dim=-1)
            ft = ft * torch.where(nrm > fN, fN / torch.clamp(nrm, min=_EPS), 1.0)[:, None]
            res = res + (cols["A"][:, :, rows] * (ft - f[:, rows])[:, None, :]).sum(-1)
            f = f.slice_scatter(ft, 1, adr + 1, adr + cdim)
    return f, res


def noslip(m: Model, d: Data) -> Data:
    """Run opt.noslip_iterations sweeps of the friction post-pass from the
    solver's efc_force (JAX noslip.py:59-143); returns Data with efc_force,
    qfrc_constraint, qacc and qacc_warmstart updated. Each sweep is kept
    per env while that env is still active; an env stops once its dual cost
    falls by no more than noslip_tolerance * nv * max(total mass, 1) in a
    sweep (the sweep that finds it still counts)."""
    s = m.skel
    iters = int(m.opt.noslip_iterations)
    if iters <= 0 or s.nefc == 0:
        return d
    plan = noslip_plan(s, m.opt.cone == int(ConeType.ELLIPTIC))
    J = d.efc_J
    minv_j = linalg.cho_solve(d.qLD, J.contiguous())  # (B, nefc, nv): row r is M^-1 J_r
    A = J @ minv_j.transpose(-1, -2)
    b = d.efc_aref - (J * d.qacc_smooth[:, None, :]).sum(-1)
    f0 = d.efc_force

    def matvec(x):
        return (A * x[:, None, :]).sum(-1)

    def cost(x):
        return (0.5 * x * matvec(x)).sum(-1) - (x * b).sum(-1)

    dev = J.device
    cols = dict(A=A, friction=d.contact.friction, pm=torch.tensor([1.0, -1.0], dtype=J.dtype, device=dev))
    if plan.fl_rows:
        fl = device_index(np.asarray(plan.fl_rows), dev)
        cols.update(fl_diag=torch.clamp(A[:, fl, fl], min=_EPS), fl_col=A[:, :, fl], floss=d.efc_frictionloss[:, fl])
    if plan.pairs:
        i1 = device_index(np.asarray(plan.pairs), dev)
        i2 = device_index(np.asarray(plan.pairs) + 1, dev)
        h = 0.25 * (A[:, i1, i1] - 2.0 * A[:, i1, i2] + A[:, i2, i2])
        cols.update(pair_h=torch.clamp(h, min=_EPS), pair_col=A[:, :, i1] - A[:, :, i2])
    cols["block_A"] = [A[:, adr + 1:adr + cdim, adr + 1:adr + cdim]
                       + _EPS * torch.eye(cdim - 1, dtype=J.dtype, device=dev) for adr, cdim, _ in plan.blocks]

    scale = m.opt.noslip_tolerance * s.nv * torch.clamp(m.body_mass.sum(-1), min=1.0)  # per env with per-env masses
    f, res = f0, matvec(f0) - b
    c_prev = cost(f0)
    active = torch.ones_like(c_prev, dtype=torch.bool)
    for _ in range(iters):
        f_n, res_n = _sweep(plan, f, res, cols)
        c_n = cost(f_n)
        take = active
        f = torch.where(take[:, None], f_n, f)
        res = torch.where(take[:, None], res_n, res)
        active = active & (c_prev - c_n > scale)
        c_prev = torch.where(take, c_n, c_prev)

    qacc = d.qacc_smooth + (f[..., None] * minv_j).sum(1)
    return d.replace(efc_force=f, qfrc_constraint=(J * f[..., None]).sum(1), qacc=qacc, qacc_warmstart=qacc)
