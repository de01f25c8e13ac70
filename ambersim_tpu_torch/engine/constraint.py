"""Constraint assembly for the ported slice: joint, tendon, connect and
weld equality rows, dof and tendon friction, scalar and ball joint limits,
tendon limits, frictionless condim-1 contacts and condim-3, 4 and 6
contacts (pyramidal or elliptic cones) -> batch-first efc rows (J, D, aref, pos,
active) plus the factored operands efc_bJ/efc_dsc of the structured Newton
kernel. Port of ambersim_tpu/engine/constraint.py (`_impedance`, `_kbi`,
`PyramidStructure`, and the matching branches of `make_constraint`);
`io.bridge.check_slice` refuses models with other row families.

Conventions (MuJoCo, parity-tested by the JAX package):
  * impedance: solimp=(d0,dmax,width,mid,power) sigmoid on |pos|/width
  * aref = -b*(J qvel) - k*imp*pos, b = 2/(dmax*tc), k = 1/(dmax^2 tc^2 dr^2)
    for standard solref (tc, dr); direct for <= 0
  * D = imp / ((1-imp) * diagApprox)
  * condim-1 rows J = Jn, diagApprox = invweight
  * pyramid rows J = Jn +- mu_i Jt_i, 2 (cdim-1) a contact, diagApprox =
    2 mu0^2 (1+mu0^2) invweight / impratio
  * elliptic rows J = [Jn, Jt_1 .. Jt_(cdim-1)], D_n on diagApprox = invweight,
    D_f = D_n impratio (mu_f/mu0)^2, friction rows without a position term
  * friction directions: the frame's two tangents, then (condim 4, 6) the
    torsional row about the normal and the two rolling rows, each the
    relative angular velocity's Jacobian in the contact frame
  * limits: one row per limited joint, J = +1 near the lower bound, -1 near
    the upper; a ball joint's row is on its total rotation angle, J = -axis
  * joint equality: pos = (q1 - q1_0) - poly(q2 - q2_0) with the polycoef
    quartic, J = e_dof1 - poly'(q2 - q2_0) e_dof2, diagApprox = the two
    dofs' invweight (joint 1 alone when joint2 is absent); tendon equality
    likewise on ten_length - length0 and ten_J, on the tendons' invweight0
  * connect: 3 rows, the two bodies' anchors apart, J the difference of
    their point Jacobians; weld: those and 3 rows of the relative rotation's
    quat_sub residual scaled by torquescale, on the bodies' translational
    and rotational invweight0
  * tendon friction rows J = ten_J, tendon limit rows J = +-ten_J (dense)
Every row exists every step; efc_active gates it. Equality rows come first,
in model order, 1, 1, 3 or 6 rows each (`_eq_plan`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import ConeType, Data, DisableBit, EqType, JointType, Model
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
    for e in range(s.neq):
        rows += [("eq", -1)] * _EQ_ROWS[int(s.eq_type[e])]
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


def _contact_support(m: Model, d: Data):
    """(signed dof support (ncon, nv), invweight (ncon,), body 1, body 2
    (ncon,)) of the contact slots, or each (B, ncon, ...) where capped
    groups and the row cap choose pairs at run time: then they are selected
    by each env's contact geom ids (the reference's one-hot products at
    precision=HIGHEST, constraint.py:548-562, as exact gathers)."""
    s = m.skel
    dev = d.qpos.device
    gsup = _geom_support(s)
    if len(s.bpg_adr) == 0 and s.ncon == s.ncand:
        # every contact slot has a compile-time geom pair
        signed_sup = device_index(gsup[s.con_geom2] - gsup[s.con_geom1], dev)  # (ncon, nv)
        b1, b2 = device_index(s.geom_bodyid[s.con_geom1], dev), device_index(s.geom_bodyid[s.con_geom2], dev)
        return signed_sup, m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0], b1, b2
    g1, g2 = d.contact.geom1.long(), d.contact.geom2.long()
    gsup_t = device_index(gsup, dev)
    biw = m.body_invweight0[device_index(s.geom_bodyid, dev), 0]  # (ngeom,)
    gbody = device_index(s.geom_bodyid, dev)
    return gsup_t[g2] - gsup_t[g1], biw[g1] + biw[g2], gbody[g1], gbody[g2]


def _point_jac_rows(m: Model, d: Data, pos: torch.Tensor, signed_support: torch.Tensor):
    """Translational jacobian of the relative velocity at world points.

    pos (B, n, 3); signed_support (n, nv), or (B, n, nv) when the contact
    geoms differ per env. Returns three (B, n, nv) tensors, one per world
    axis."""
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


def _poly(c: torch.Tensor, z: torch.Tensor):
    """The equality's quartic polycoef c (..., 5) at z and its derivative."""
    poly = c[:, 0] + z * (c[:, 1] + z * (c[:, 2] + z * (c[:, 3] + z * c[:, 4])))
    dpoly = c[:, 1] + z * (2 * c[:, 2] + z * (3 * c[:, 3] + z * 4 * c[:, 4]))
    return poly, dpoly


def _joint_eq(m: Model, d: Data, eqs: np.ndarray):
    """Joint equality rows `eqs`: (eqs, J (B, E, nv), pos (B, E), diagApprox
    (E,)): pos = (q1 - q1_0) - poly(q2 - q2_0), J = e_dof1 - poly' e_dof2,
    joint 1 alone (pos = q1 - q1_0 - c0) where joint2 is absent."""
    s = m.skel
    dev = d.qpos.device

    def ix(a):
        return device_index(a, dev)

    j1, j2 = np.asarray(s.eq_obj1id)[eqs], np.asarray(s.eq_obj2id)[eqs]
    two = j2 >= 0
    e2 = np.nonzero(two)[0]  # the rows coupling two joints
    j2 = np.where(two, j2, j1)  # a one-joint row reads its own joint; `two` drops that term
    qa1, da1 = ix(s.jnt_qposadr[j1]), ix(s.jnt_dofadr[j1])
    qa2, da2 = ix(s.jnt_qposadr[j2]), ix(s.jnt_dofadr[j2])
    two_t = ix(two)
    c = m.eq_data[ix(eqs), :5]
    poly, dpoly = _poly(c, d.qpos[:, qa2] - m.qpos0[..., qa2])
    pos = (d.qpos[:, qa1] - m.qpos0[..., qa1]) - torch.where(two_t, poly, c[:, 0])
    J_eq = d.qpos.new_zeros((d.qpos.shape[0], len(eqs), s.nv))
    J_eq[:, ix(np.arange(len(eqs))), da1] = 1.0
    J_eq[:, ix(e2), ix(s.jnt_dofadr[j2[e2]])] = -dpoly[:, ix(e2)]
    diag = m.dof_invweight0[da1] + torch.where(two_t, m.dof_invweight0[da2], 0.0)
    return eqs, J_eq, pos, diag


def _tendon_eq(m: Model, d: Data, eqs: np.ndarray):
    """Tendon equality rows `eqs`, as `_joint_eq` on tendon lengths less
    their length0: J = ten_J1 - poly' ten_J2, diagApprox the tendons'
    invweight0 (JAX constraint.py:330-350)."""
    s = m.skel
    dev = d.qpos.device

    def ix(a):
        return device_index(a, dev)

    t1, t2 = np.asarray(s.eq_obj1id)[eqs], np.asarray(s.eq_obj2id)[eqs]
    two = ix(t2 >= 0)
    t2 = np.where(t2 >= 0, t2, t1)
    t1, t2 = ix(t1), ix(t2)
    c = m.eq_data[ix(eqs), :5]
    poly, dpoly = _poly(c, d.ten_length[:, t2] - m.tendon_length0[t2])
    pos = (d.ten_length[:, t1] - m.tendon_length0[t1]) - torch.where(two, poly, c[:, 0])
    J1, J2 = d.ten_J[:, t1], d.ten_J[:, t2]
    J_eq = torch.where(two[:, None], J1 - dpoly[..., None] * J2, J1)
    diag = torch.where(two, m.tendon_invweight0[t1] + m.tendon_invweight0[t2], m.tendon_invweight0[t1])
    return eqs, J_eq, pos, diag


_EQ_ROWS = {int(EqType.JOINT): 1, int(EqType.TENDON): 1, int(EqType.CONNECT): 3, int(EqType.WELD): 6}


def _eq_plan(s):
    """(first row of each equality, its rows in all, the equalities of each
    type in model order): the static layout of the equality rows."""
    key = (s, "eq_plan")
    if key not in _CACHE:
        eq_type = np.asarray(s.eq_type, np.int64)
        nrow = np.asarray([_EQ_ROWS[int(t)] for t in eq_type], np.int64)
        adr = np.concatenate([[0], np.cumsum(nrow)[:-1]]).astype(np.int64)
        by_type = {t: np.nonzero(eq_type == int(t))[0] for t in EqType}
        _CACHE[key] = adr, int(nrow.sum()), by_type
    return _CACHE[key]


def _body_eq(m: Model, d: Data, eqs: np.ndarray, weld: bool):
    """Connect (3 rows each) or weld (6 rows each) equality rows `eqs`,
    batched over the equalities (JAX constraint.py:353-400): (J (B, E, nrow,
    nv), pos (B, E, nrow), diagApprox (E, nrow)). The residual is anchor 1
    less anchor 2 in the world, J the difference of the two bodies' point
    Jacobians there; a weld adds the relative rotation's quat_sub from its
    qpos0 value (eq_data[6:10]), J the bodies' rotational Jacobians apart,
    both scaled by torquescale (eq_data[10], 1 where it is not positive). A
    mocap body has no dofs: its support row is zero."""
    from ambersim_tpu_torch.engine.smooth import _body_dof_support

    s = m.skel
    dev = d.qpos.device

    def ix(a):
        return device_index(a, dev)

    b1, b2 = np.asarray(s.eq_obj1id)[eqs], np.asarray(s.eq_obj2id)[eqs]
    data = m.eq_data[ix(eqs)]
    # a weld's anchor is on body 2 (eq_data[:3]) and its counterpart on body 1
    anchor1, anchor2 = (data[:, 3:6], data[:, :3]) if weld else (data[:, :3], data[:, 3:6])
    x1, x2 = ix(b1), ix(b2)
    p1 = d.xpos[:, x1] + am.rotate(anchor1, d.xquat[:, x1])
    p2 = d.xpos[:, x2] + am.rotate(anchor2, d.xquat[:, x2])
    sup = _body_dof_support(s).astype(np.float32)
    jr1 = _point_jac_rows(m, d, p1, device_index(sup[b1], dev, d.qpos.dtype))
    jr2 = _point_jac_rows(m, d, p2, device_index(sup[b2], dev, d.qpos.dtype))
    J = torch.stack([a - b for a, b in zip(jr1, jr2)], 2)  # (B, E, 3, nv)
    pos = p1 - p2
    diag = (m.body_invweight0[x1, 0] + m.body_invweight0[x2, 0])[:, None].expand(-1, 3)
    if weld:
        target = am.mul_quat(d.xquat[:, x1], data[:, 6:10])  # body 2's rotation at the weld's qpos0 pose
        rot = am.quat_sub(d.xquat[:, x2], target)
        ssup = device_index(sup[b1] - sup[b2], dev, d.qpos.dtype)  # (E, nv)
        jacr = d.cdof[:, None, :, :3].transpose(-1, -2) * ssup[None, :, None, :]  # (B, E, 3, nv)
        ts = torch.where(data[:, 10] > 0, data[:, 10], 1.0)
        J = torch.cat([J, jacr * ts[:, None, None]], 2)
        pos = torch.cat([pos, rot * ts[:, None]], -1)
        diag_r = (m.body_invweight0[x1, 1] + m.body_invweight0[x2, 1])[:, None].expand(-1, 3)
        diag = torch.cat([diag, diag_r], -1)
    return J, pos, diag


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

    # -------- equality: one group per type, the first rows --------
    if s.neq:
        eq_adr, n_eq_rows, by_type = _eq_plan(s)
        on = ix(np.asarray(s.eq_active0, bool)) & (not (m.opt.disableflags & DisableBit.EQUALITY))
        ej, et = by_type[EqType.JOINT], by_type[EqType.TENDON]  # one row each
        for eqs, J_eq, pos, diag in (_joint_eq(m, d, ej), _tendon_eq(m, d, et)):
            if not len(eqs):
                continue
            e, rows = ix(eqs), ix(row + eq_adr[eqs])
            k, b, imp = _kbi(m, m.eq_solref[e], m.eq_solimp[e], pos)
            efc_J[:, rows] = J_eq
            efc_pos[:, rows] = pos
            efc_aref[:, rows] = -b * (J_eq * d.qvel[:, None, :]).sum(-1) - k * imp * pos
            efc_D[:, rows] = imp / torch.clamp((1 - imp) * diag, min=_MINVAL)
            efc_active[:, rows] = on[e]
        for eqs, weld in ((by_type[EqType.CONNECT], False), (by_type[EqType.WELD], True)):
            if not len(eqs):
                continue
            J_eq, pos, diag = _body_eq(m, d, eqs, weld)  # (B, E, nrow, nv), (B, E, nrow), (E, nrow)
            nrow = pos.shape[-1]
            e = ix(eqs)
            rows = ix((row + eq_adr[eqs][:, None] + np.arange(nrow)[None, :]).reshape(-1))
            k, b, imp = _kbi(m, m.eq_solref[e][:, None, :], m.eq_solimp[e][:, None, :], pos)
            efc_J[:, rows] = J_eq.reshape(B, -1, nv)
            efc_pos[:, rows] = pos.reshape(B, -1)
            aref = -b * (J_eq * d.qvel[:, None, None, :]).sum(-1) - k * imp * pos
            efc_aref[:, rows] = aref.reshape(B, -1)
            efc_D[:, rows] = (imp / torch.clamp((1 - imp) * diag, min=_MINVAL)).reshape(B, -1)
            efc_active[:, rows] = on[e].repeat_interleave(nrow)
        row += n_eq_rows

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
        efc_fl[:, rows] = m.dof_frictionloss[..., dofs]
        efc_active[:, rows] = not (m.opt.disableflags & DisableBit.FRICTIONLOSS)
        row += nfd
    # -------- friction loss: tendon rows (dense) --------
    nft = len(s.friction_tenid)
    if nft:
        tens = ix(s.friction_tenid)
        rows = ix(np.arange(row, row + nft))
        k, b, imp = _kbi(m, m.tendon_solref_fri[tens], m.tendon_solimp_fri[tens], d.qpos.new_zeros((nft,)))
        efc_J[:, rows] = d.ten_J[:, tens]
        # d.ten_velocity is the Data's own: the JAX package sets it in
        # fwd_velocity, after this stage (smooth.py:1268-1270), so within a
        # step the row reads the tendon velocity of the step before
        efc_aref[:, rows] = -b * d.ten_velocity[:, tens]
        efc_D[:, rows] = imp / torch.clamp((1 - imp) * m.tendon_invweight0[tens], min=_MINVAL)
        efc_fl[:, rows] = m.tendon_frictionloss[tens]
        efc_active[:, rows] = not (m.opt.disableflags & DisableBit.FRICTIONLOSS)
        row += nft

    # -------- limits: joints in id order, scalar rows and ball rows --------
    nlj = len(s.limit_jntid)
    if nlj:
        ball = np.asarray(s.jnt_type)[s.limit_jntid] == int(JointType.BALL)
        scalar = np.nonzero(~ball)[0]
        lim_on = not (m.opt.disableflags & DisableBit.LIMIT)
        if len(scalar):
            jids = s.limit_jntid[scalar]
            qas, das = ix(s.jnt_qposadr[jids]), ix(s.jnt_dofadr[jids])
            rows = ix(row + scalar)
            jt = ix(jids)
            q = d.qpos[:, qas]
            dist_lo, dist_hi = q - m.jnt_range[jt, 0], m.jnt_range[jt, 1] - q
            lower = dist_lo < dist_hi
            dist = torch.where(lower, dist_lo, dist_hi)
            sign = torch.where(lower, 1.0, -1.0).to(q.dtype)
            margin = m.jnt_margin[jt]
            pos = dist - margin
            k, b, imp = _kbi(m, m.jnt_solref[jt], m.jnt_solimp[jt], pos)
            efc_J[:, rows, das] = sign
            if ndiag:
                # the scalar limits' signs follow the nfd dof-friction entries
                # of the one-hot section (a ball limit's row is dense)
                efc_dsc[:, nfd : nfd + len(scalar)] = sign
            efc_pos[:, rows] = pos
            efc_margin[:, rows] = margin.expand(B, -1)
            efc_aref[:, rows] = -b * (sign * d.qvel[:, das]) - k * imp * pos
            efc_D[:, rows] = imp / torch.clamp((1 - imp) * m.dof_invweight0[das], min=_MINVAL)
            efc_active[:, rows] = lim_on & (dist < margin)
        if ball.any():
            # one row on the total rotation angle (mj_instantiateLimit):
            # dist = max(range) - |angle|, J = -axis (JAX constraint.py:474-499)
            jids = s.limit_jntid[ball]
            jt, da = ix(jids), s.jnt_dofadr[jids]
            rows = ix(row + np.nonzero(ball)[0])
            q = d.qpos[:, ix(s.jnt_qposadr[jids][:, None] + np.arange(4))]  # (B, L, 4)
            v = q[..., 1:]
            ss = (v * v).sum(-1)
            # the norm and the axis in forms whose gradient stays finite at
            # the identity (sin_half 0), with the same values
            sin_half = torch.where(ss > 0, torch.sqrt(torch.where(ss > 0, ss, 1.0)), 0.0)
            angle = 2.0 * torch.atan2(sin_half, q[..., 0])
            angle = torch.where(angle > np.pi, angle - 2.0 * np.pi, angle)
            axis = v / torch.clamp(sin_half, min=_MINVAL)[..., None] * torch.sign(angle)[..., None]
            dist = torch.maximum(m.jnt_range[jt, 0], m.jnt_range[jt, 1]) - angle.abs()
            margin = m.jnt_margin[jt]
            pos = dist - margin
            k, b, imp = _kbi(m, m.jnt_solref[jt], m.jnt_solimp[jt], pos)
            dofs = ix(da[:, None] + np.arange(3))
            J_b = -axis
            efc_J[:, rows[:, None], dofs] = J_b
            efc_pos[:, rows] = pos
            efc_margin[:, rows] = margin.expand(B, -1)
            efc_aref[:, rows] = -b * (J_b * d.qvel[:, dofs]).sum(-1) - k * imp * pos
            efc_D[:, rows] = imp / torch.clamp((1 - imp) * m.dof_invweight0[ix(da)], min=_MINVAL)
            efc_active[:, rows] = lim_on & (dist < margin)
        row += nlj
    # -------- limits: tendons (dense rows) --------
    nlt = len(s.limit_tenid)
    if nlt:
        tens = ix(s.limit_tenid)
        rows = ix(np.arange(row, row + nlt))
        L = d.ten_length[:, tens]
        dist_lo, dist_hi = L - m.tendon_range[tens, 0], m.tendon_range[tens, 1] - L
        lower = dist_lo < dist_hi
        dist = torch.where(lower, dist_lo, dist_hi)
        sign = torch.where(lower, 1.0, -1.0).to(L.dtype)
        margin = m.tendon_margin[tens]
        pos = dist - margin
        k, b, imp = _kbi(m, m.tendon_solref_lim[tens], m.tendon_solimp_lim[tens], pos)
        J_lim = sign[..., None] * d.ten_J[:, tens]
        efc_J[:, rows] = J_lim
        efc_pos[:, rows] = pos
        efc_margin[:, rows] = margin.expand(B, -1)
        efc_aref[:, rows] = -b * (J_lim * d.qvel[:, None, :]).sum(-1) - k * imp * pos
        efc_D[:, rows] = imp / torch.clamp((1 - imp) * m.tendon_invweight0[tens], min=_MINVAL)
        efc_active[:, rows] = (not (m.opt.disableflags & DisableBit.LIMIT)) & (dist < margin)
        row += nlt

    # -------- contacts: one group per condim --------
    if s.ncon and not (m.opt.disableflags & DisableBit.CONTACT):
        c = d.contact
        signed_sup, invweight, _, _ = _contact_support(m, d)
        jframe = _frame_rows(c.frame, _point_jac_rows(m, d, c.pos, signed_sup))  # 3 x (B, ncon, nv)
        pos_c = c.dist - c.includemargin
        k, b, imp = _kbi(m, c.solref, c.solimp, pos_c)
        active_c = c.dist < c.includemargin
        elliptic = m.opt.cone == int(ConeType.ELLIPTIC)
        qv = d.qvel[:, None, :]
        con_dim = np.asarray(s.con_dim)

        # torsional and rolling directions (condim 4 and 6): the angular part
        # of cdof on the signed support, in the contact frame (JAX constraint.py:579)
        jrot = _frame_rows(c.frame, _rot_jac_rows(d, signed_sup)) if (con_dim > 3).any() else None

        for cdim in sorted(set(con_dim.tolist())):
            slots = np.nonzero(con_dim == cdim)[0]
            sl = None if len(slots) == s.ncon else ix(slots)  # one condim: no gathers

            def g(x, sl=sl):
                return x if sl is None else x[:, sl]

            iw = invweight if sl is None else invweight[..., sl]
            jn, fr, k_g, b_g, imp_g, pos_g = g(jframe[0]), g(c.friction), g(k), g(b), g(imp), g(pos_c)
            dist_g, margin_g, act_g = g(c.dist), g(c.includemargin), g(active_c)
            jnq = (jn * qv).sum(-1)  # (B, S)
            # friction direction f = 1 .. cdim-1: the two tangents, then the
            # frame's torsional (f = 3) and rolling (f = 4, 5) rows
            bases = [g(jframe[f]) if f < 3 else g(jrot[f - 3]) for f in range(1, cdim)]
            if elliptic and cdim > 1:
                # elliptic rows [normal, friction dims]: raw frame rows, aref_f
                # without a position term, D_n on plain invweight and
                # D_f = D_n * impratio * (mu_f / mu0)^2 (JAX constraint.py:588-625)
                nrow = cdim
                row_Js = [jn] + bases
                D_n = imp_g / torch.clamp((1 - imp_g) * iw, min=_MINVAL)
                mu0 = torch.clamp(fr[..., 0], min=1e-12)
                rows_aref = [-b_g * jnq - k_g * imp_g * pos_g]
                rows_D = [D_n]
                for f, base in enumerate(bases, 1):
                    rows_aref.append(-b_g * (base * qv).sum(-1))
                    rows_D.append(D_n * m.opt.impratio * (fr[..., f - 1] / mu0) ** 2)
                zero = torch.zeros_like(dist_g)
                rows_pos, rows_margin = [dist_g] + [zero] * (cdim - 1), [margin_g] + [zero] * (cdim - 1)
            else:
                nrow = 1 if cdim == 1 else 2 * (cdim - 1)
                if cdim == 1:
                    # frictionless: one normal row, diagApprox = plain invweight
                    diag = iw
                    row_Js, jq_rows = [jn], [jnq]
                else:
                    # pyramid rows N +- mu_f T_f, diagApprox 2 mu0^2 (1+mu0^2) invweight / impratio
                    mu0 = fr[..., 0]
                    diag = 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) * iw / m.opt.impratio
                    row_Js, jq_rows, mbs = [], [], []
                    for f, base in enumerate(bases, 1):
                        mu_f = fr[..., f - 1]
                        mb = mu_f[..., None] * base
                        mbs.append(mb)
                        bq = mu_f * (base * qv).sum(-1)
                        row_Js += [jn + mb, jn - mb]
                        jq_rows += [jnq + bq, jnq - bq]
                    if cdim == 3 and efc_bJ.shape[1] == 3 * len(slots):
                        # factored basis [N | mu1*T1 | mu2*T2] (PyramidStructure.adr3
                        # order); a condim-4/6 block never factors
                        efc_bJ = torch.cat([jn, mbs[0], mbs[1]], dim=1)
                kip = k_g * imp_g * pos_g
                rows_aref = [-b_g * jq - kip for jq in jq_rows]
                rows_D = [imp_g / torch.clamp((1 - imp_g) * diag, min=_MINVAL)] * nrow
                rows_pos, rows_margin = [dist_g] * nrow, [margin_g] * nrow
            row_idx = ix((s.con_efcadr[slots][:, None] + np.arange(nrow)[None, :]).reshape(-1))
            efc_J[:, row_idx] = torch.stack(row_Js, dim=2).reshape(B, -1, nv)
            efc_pos[:, row_idx] = torch.stack(rows_pos, dim=2).reshape(B, -1)
            efc_margin[:, row_idx] = torch.stack(rows_margin, dim=2).reshape(B, -1)
            efc_aref[:, row_idx] = torch.stack(rows_aref, dim=2).reshape(B, -1)
            efc_D[:, row_idx] = torch.stack(rows_D, dim=2).reshape(B, -1)
            efc_active[:, row_idx] = act_g.repeat_interleave(nrow, dim=1)

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


def _rot_jac_rows(d: Data, signed_sup: torch.Tensor):
    """Rotational jacobian of the relative angular velocity (the torsional
    and rolling rows of condim 4 and 6) as three (B, ncon, nv) world-axis
    rows: cdof's angular part on the signed support (JAX constraint.py:682-685)."""
    return [d.cdof[:, None, :, i] * signed_sup for i in range(3)]
