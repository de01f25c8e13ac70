"""Constraint assembly for the ported slice: dof friction, scalar joint
limits and condim-3 pyramidal contacts -> batch-first efc rows (J, D, aref,
pos, active) plus the factored operands efc_bJ/efc_dsc of the structured
Newton kernel. Port of ambersim_tpu/engine/constraint.py (`_impedance`,
`_kbi`, `PyramidStructure`, and the matching branches of `make_constraint`);
`io.bridge.check_slice` refuses models with other row families.

Conventions (MuJoCo, parity-tested by the JAX package):
  * impedance: solimp=(d0,dmax,width,mid,power) sigmoid on |pos|/width
  * aref = -b*(J qvel) - k*imp*pos, b = 2/(dmax*tc), k = 1/(dmax^2 tc^2 dr^2)
    for standard solref (tc, dr); direct for <= 0
  * D = imp / ((1-imp) * diagApprox)
  * pyramid rows J = Jn +- mu_i Jt_i, diagApprox = 2 mu0^2 (1+mu0^2) invweight / impratio
  * limits: one row per limited joint, J = +1 near the lower bound, -1 near the upper
Every row exists every step; efc_active gates it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ambersim_tpu_torch.core.types import Data, DisableBit, EqType, JointType, Model
from ambersim_tpu_torch.engine.schedule import device_index

_MINVAL = 1e-10
_MINIMP = 0.0001
_MAXIMP = 0.9999


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo impedance sigmoid. solimp (..., 5), pos (...)."""
    d0, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(pos.abs() / torch.clamp(width, min=_MINVAL), 0.0, 1.0)
    mid = torch.clamp(mid, _MINIMP, _MAXIMP)
    power = torch.clamp(power, min=1.0)
    a = 1.0 / torch.pow(mid, power - 1.0)
    b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(x < mid, a * torch.pow(x, power), 1.0 - b * torch.pow(1.0 - x, power))
    return torch.clamp(d0 + y * (dmax - d0), _MINIMP, _MAXIMP)


def _kbi(m: Model, solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor):
    """Stiffness, damping and impedance per row. solref (..., 2)."""
    imp = _impedance(solimp, pos)
    tc, dr = solref[..., 0], solref[..., 1]
    if not (m.opt.disableflags & DisableBit.REFSAFE):
        tc = torch.maximum(tc, 2.0 * m.opt.timestep)
    dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
    b_std = 2.0 / (dmax * torch.clamp(tc, min=_MINVAL))
    k_std = 1.0 / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=_MINVAL)
    direct = (solref[..., 0] <= 0) & (solref[..., 1] <= 0)
    k = torch.where(direct, -solref[..., 0] / torch.clamp(dmax * dmax, min=_MINVAL), k_std)
    b = torch.where(direct, -solref[..., 1] / torch.clamp(dmax, min=_MINVAL), b_std)
    return k, b, imp


_CACHE: dict = {}


class PyramidStructure(NamedTuple):
    """Static factored layout of the pyramidal efc rows (consumed by the
    structured Newton kernel, csrc/newton_structured.cu).

    Row families, classified by replaying make_constraint's static row walk:
      * dense rows  — no exploitable structure (equality, tendon friction,
        ball/tendon limits, frictionless condim-1 contact rows)
      * one-hot rows — J = s * e_dof with a static dof and dynamic sign
        (dof friction, scalar joint limits): diagonal Hessian updates
      * condim-3 pyramid blocks — rows [N+U1, N-U1, N+U2, N-U2] with
        U_k = mu_k * T_k, so the basis [N, U1, U2] is recoverable from the
        assembled rows by half sums/differences; the Gram contribution is
        B^T S B with a 5-coefficient S per contact (3 basis rows instead of
        4 dense rows, and no J*h buffer)

    `perm` maps kernel row order [dense | one-hot | N+U1* | N-U1* | N+U2* |
    N-U2*] (contact rows grouped by pyramid direction so the kernel slices
    contiguously) to MuJoCo row order; `is_fric`/`one_sided` are the row-type
    masks in kernel order."""

    nd: int
    ndiag: int
    ncon3: int
    # family-segment boundaries in kernel order (rows are contiguous by
    # construction: eq | tendon-friction | dense one-sided | one-hot friction
    # | one-hot limits | contacts); the kernel derives row types from these
    nd_eq: int  # dense equality rows (two-sided quadratic)
    nd_ft: int  # dense tendon-friction rows (Huber)
    nfd: int  # one-hot dof-friction rows (Huber); remaining one-hot = limits
    dense_rows: np.ndarray  # (nd,) MuJoCo row ids
    diag_rows: np.ndarray  # (ndiag,)
    diag_dofs: np.ndarray  # (ndiag,)
    adr3: np.ndarray  # (ncon3,) first MuJoCo row of each condim-3 block
    perm: np.ndarray  # (nefc,) kernel row -> MuJoCo row
    inv_perm: np.ndarray  # (nefc,) MuJoCo row -> kernel row
    is_fric: np.ndarray  # (nefc, 1) float32, kernel order (Huber rows)
    one_sided: np.ndarray  # (nefc, 1) float32, kernel order


def _row_families(s):
    """(family, dof) per non-contact MuJoCo efc row, mirroring
    make_constraint's assembly order exactly."""
    rows = []
    eq_rows = {EqType.JOINT: 1, EqType.TENDON: 1, EqType.CONNECT: 3, EqType.WELD: 6}
    for e in range(s.neq):
        rows += [("eq", -1)] * eq_rows[EqType(int(s.eq_type[e]))]
    for dof in s.friction_dofid:
        rows.append(("fric_dof", int(dof)))
    for _ in getattr(s, "friction_tenid", ()):
        rows.append(("fric_ten", -1))
    for j in s.limit_jntid:
        if int(s.jnt_type[j]) == int(JointType.BALL):
            rows.append(("lim_dense", -1))
        else:
            rows.append(("lim_dof", int(s.jnt_dofadr[j])))
    for _ in getattr(s, "limit_tenid", ()):
        rows.append(("lim_dense", -1))
    return rows


def _pyramid_structure(s) -> "PyramidStructure | None":
    """Static factored row layout, or None when the model doesn't qualify
    (elliptic handled elsewhere; condim 4/6 pyramid blocks keep the dense
    kernel)."""
    key = (s, "pyr_struct")
    if key in _CACHE:
        return _CACHE[key]

    def build():
        if s.nefc == 0 or s.ncon == 0:
            return None
        con_dim = np.asarray(s.con_dim)
        if not np.all(np.isin(con_dim, (1, 3))) or not np.any(con_dim == 3):
            return None
        fams = _row_families(s)
        # the skeleton's efc layout must actually be the pyramidal one
        # (1 row for condim 1, 2*(cdim-1) otherwise): elliptic-compiled
        # skeletons lay out condim-3 contacts as 3 rows and do not factor
        rows_per = np.where(con_dim == 1, 1, 2 * (con_dim - 1))
        expected_adr = len(fams) + np.concatenate([[0], np.cumsum(rows_per[:-1])])
        if s.nefc != len(fams) + int(rows_per.sum()) or not np.array_equal(
            np.asarray(s.con_efcadr), expected_adr
        ):
            return None
        dense, dense_fam, diag_rows, diag_dofs, diag_fam = [], [], [], [], []
        for i, (fam, dof) in enumerate(fams):
            if fam in ("fric_dof", "lim_dof"):
                diag_rows.append(i)
                diag_dofs.append(dof)
                diag_fam.append(fam)
            else:
                dense.append(i)
                dense_fam.append(fam)
        adr = np.asarray(s.con_efcadr)
        for c in np.nonzero(con_dim == 1)[0]:
            dense.append(int(adr[c]))
            dense_fam.append("con1")
        adr3 = adr[np.nonzero(con_dim == 3)[0]]
        ncon3 = len(adr3)
        perm = np.concatenate(
            [
                np.asarray(dense, np.int64),
                np.asarray(diag_rows, np.int64),
                adr3 + 0,
                adr3 + 1,
                adr3 + 2,
                adr3 + 3,
            ]
        ).astype(np.int64)
        assert perm.shape == (s.nefc,) and np.array_equal(np.sort(perm), np.arange(s.nefc))
        inv_perm = np.argsort(perm)
        fam_k = dense_fam + diag_fam + ["con"] * (4 * ncon3)
        is_fric = np.asarray(
            [f in ("fric_dof", "fric_ten") for f in fam_k], np.float32
        )[:, None]
        one_sided = np.asarray(
            [f in ("lim_dof", "lim_dense", "con1", "con") for f in fam_k], np.float32
        )[:, None]
        # family segments must be contiguous in kernel order (the kernel
        # rebuilds the masks from these boundaries)
        nd_eq = dense_fam.count("eq")
        nd_ft = dense_fam.count("fric_ten")
        nfd = diag_fam.count("fric_dof")
        assert dense_fam == ["eq"] * nd_eq + ["fric_ten"] * nd_ft + dense_fam[nd_eq + nd_ft :]
        assert all(f in ("lim_dense", "con1") for f in dense_fam[nd_eq + nd_ft :])
        assert diag_fam == ["fric_dof"] * nfd + ["lim_dof"] * (len(diag_fam) - nfd)
        return PyramidStructure(
            nd=len(dense),
            ndiag=len(diag_rows),
            ncon3=ncon3,
            nd_eq=nd_eq,
            nd_ft=nd_ft,
            nfd=nfd,
            dense_rows=np.asarray(dense, np.int64),
            diag_rows=np.asarray(diag_rows, np.int64),
            diag_dofs=np.asarray(diag_dofs, np.int64),
            adr3=adr3.astype(np.int64),
            perm=perm,
            inv_perm=inv_perm,
            is_fric=is_fric,
            one_sided=one_sided,
        )

    st = build()
    _CACHE[key] = st
    return st



def _geom_support(s) -> np.ndarray:
    """(ngeom, nv) float32 dof-support table of each geom's body."""
    key = (s, "geom_support")
    if key not in _CACHE:
        from ambersim_tpu_torch.engine.smooth import _body_dof_support

        _CACHE[key] = _body_dof_support(s).astype(np.float32)[s.geom_bodyid]
    return _CACHE[key]


def _point_jac_rows(m: Model, d: Data, pos: torch.Tensor, signed_support: torch.Tensor):
    """Translational jacobian of the relative velocity at world points.

    pos (B, n, 3); signed_support (n, nv). Returns three (B, n, nv) tensors,
    one per world axis."""
    s = m.skel
    origin = d.subtree_com[:, device_index(s.body_rootid[s.dof_bodyid], d.qpos.device)]  # (B, nv, 3)
    cd = d.cdof[:, None]  # (B, 1, nv, 6)
    r = pos[:, :, None, :] - origin[:, None]  # (B, n, nv, 3)
    jx = cd[..., 3] + cd[..., 1] * r[..., 2] - cd[..., 2] * r[..., 1]
    jy = cd[..., 4] + cd[..., 2] * r[..., 0] - cd[..., 0] * r[..., 2]
    jz = cd[..., 5] + cd[..., 0] * r[..., 1] - cd[..., 1] * r[..., 0]
    return [jx * signed_support, jy * signed_support, jz * signed_support]


def _frame_rows(frame: torch.Tensor, jac_rows):
    """Project world-axis jacobian rows onto contact frames (B, n, 3, 3):
    three (B, n, nv) rows in frame coordinates (normal, tangent1, tangent2)."""
    return [
        frame[..., i, 0:1] * jac_rows[0] + frame[..., i, 1:2] * jac_rows[1] + frame[..., i, 2:3] * jac_rows[2]
        for i in range(3)
    ]


def make_constraint(m: Model, d: Data) -> Data:
    s = m.skel
    nv, nefc = s.nv, s.nefc
    if nefc == 0:
        return d
    dev = d.qpos.device
    B = d.qpos.shape[0]

    def ix(a):
        return device_index(a, dev)

    efc_J = d.qpos.new_zeros((B, nefc, nv))
    efc_bJ = torch.zeros_like(d.efc_bJ)
    efc_dsc = torch.zeros_like(d.efc_dsc)
    ndiag = efc_dsc.shape[1]  # > 0 iff the rows factor (PyramidStructure)
    efc_pos = d.qpos.new_zeros((B, nefc))
    efc_margin = d.qpos.new_zeros((B, nefc))
    efc_D = d.qpos.new_zeros((B, nefc))
    efc_aref = d.qpos.new_zeros((B, nefc))
    efc_fl = d.qpos.new_zeros((B, nefc))
    efc_active = torch.zeros((B, nefc), dtype=torch.bool, device=dev)
    row = 0

    # -------- friction loss: dof rows --------
    nfd = len(s.friction_dofid)
    if nfd:
        dofs = ix(s.friction_dofid)
        rows = ix(np.arange(row, row + nfd))
        k, b, imp = _kbi(m, m.dof_solref[dofs], m.dof_solimp[dofs], d.qpos.new_zeros((nfd,)))
        efc_J[:, rows, dofs] = 1.0
        if ndiag:
            # dof-friction rows are the first nfd entries of the one-hot section
            efc_dsc[:, :nfd] = 1.0
        efc_aref[:, rows] = -b * d.qvel[:, dofs]
        efc_D[:, rows] = imp / torch.clamp((1 - imp) * m.dof_invweight0[dofs], min=_MINVAL)
        efc_fl[:, rows] = m.dof_frictionloss[dofs]
        efc_active[:, rows] = not (m.opt.disableflags & DisableBit.FRICTIONLOSS)
        row += nfd

    # -------- limits: scalar joints --------
    nlj = len(s.limit_jntid)
    if nlj:
        jids = s.limit_jntid
        qas, das = ix(s.jnt_qposadr[jids]), ix(s.jnt_dofadr[jids])
        rows = ix(np.arange(row, row + nlj))
        jt = ix(jids)
        q = d.qpos[:, qas]
        dist_lo, dist_hi = q - m.jnt_range[jt, 0], m.jnt_range[jt, 1] - q
        lower = dist_lo < dist_hi
        dist = torch.where(lower, dist_lo, dist_hi)
        sign = torch.where(lower, 1.0, -1.0)
        margin = m.jnt_margin[jt]
        pos = dist - margin
        k, b, imp = _kbi(m, m.jnt_solref[jt], m.jnt_solimp[jt], pos)
        efc_J[:, rows, das] = sign
        if ndiag:
            # limit signs follow the nfd dof-friction entries of the one-hot section
            efc_dsc[:, nfd : nfd + nlj] = sign
        efc_pos[:, rows] = pos
        efc_margin[:, rows] = margin.expand(B, -1)
        efc_aref[:, rows] = -b * (sign * d.qvel[:, das]) - k * imp * pos
        efc_D[:, rows] = imp / torch.clamp((1 - imp) * m.dof_invweight0[das], min=_MINVAL)
        efc_active[:, rows] = (not (m.opt.disableflags & DisableBit.LIMIT)) & (dist < margin)
        row += nlj

    # -------- contacts: condim-3 pyramids --------
    if s.ncon and not (m.opt.disableflags & DisableBit.CONTACT):
        c = d.contact
        gsup = _geom_support(s)
        signed_sup = ix(gsup[s.con_geom2] - gsup[s.con_geom1])  # (ncon, nv)
        b1, b2 = ix(s.geom_bodyid[s.con_geom1]), ix(s.geom_bodyid[s.con_geom2])
        invweight = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
        jn, jt1, jt2 = _frame_rows(c.frame, _point_jac_rows(m, d, c.pos, signed_sup))  # (B, ncon, nv)
        pos_c = c.dist - c.includemargin
        k, b, imp = _kbi(m, c.solref, c.solimp, pos_c)
        mu0 = c.friction[..., 0]
        diag = 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) * invweight / m.opt.impratio
        D_c = imp / torch.clamp((1 - imp) * diag, min=_MINVAL)
        active_c = c.dist < c.includemargin

        qv = d.qvel[:, None, :]
        jnq = (jn * qv).sum(-1)  # (B, ncon)
        row_Js, jq_rows, mbs = [], [], []
        for f, base in ((1, jt1), (2, jt2)):
            mu_f = c.friction[..., f - 1]
            mb = mu_f[..., None] * base
            mbs.append(mb)
            bq = mu_f * (base * qv).sum(-1)
            row_Js += [jn + mb, jn - mb]
            jq_rows += [jnq + bq, jnq - bq]
        if efc_bJ.shape[1] == 3 * s.ncon:
            # factored basis [N | mu1*T1 | mu2*T2] (PyramidStructure.adr3 order)
            efc_bJ = torch.cat([jn, mbs[0], mbs[1]], dim=1)
        kip = k * imp * pos_c
        row_idx = ix((s.con_efcadr[:, None] + np.arange(4)[None, :]).reshape(-1))
        efc_J[:, row_idx] = torch.stack(row_Js, dim=2).reshape(B, -1, nv)
        efc_pos[:, row_idx] = c.dist.repeat_interleave(4, dim=1)
        efc_margin[:, row_idx] = c.includemargin.repeat_interleave(4, dim=1)
        efc_aref[:, row_idx] = torch.stack([-b * jq - kip for jq in jq_rows], dim=2).reshape(B, -1)
        efc_D[:, row_idx] = D_c.repeat_interleave(4, dim=1)
        efc_active[:, row_idx] = active_c.repeat_interleave(4, dim=1)

    return d.replace(
        efc_J=efc_J,
        efc_bJ=efc_bJ,
        efc_dsc=efc_dsc,
        efc_pos=efc_pos,
        efc_margin=efc_margin,
        efc_D=efc_D,
        efc_aref=efc_aref,
        efc_frictionloss=efc_fl,
        efc_active=efc_active,
    )
