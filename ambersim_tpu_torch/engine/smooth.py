"""Smooth (unconstrained) dynamics: FK (mocap bodies included), COM
quantities, CRBA, RNE, passive forces, energy and actuation (motors, affine
servos, filter/filterexact/integrator activations). Port of the main-path
subset of ambersim_tpu/engine/smooth.py.

Every function takes a Model and a batch-first Data and returns an updated
Data. Tree propagation is level-vectorized over the static schedule
(engine/schedule.py); indices are cached device tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import (
    BiasType,
    Data,
    DisableBit,
    DynType,
    GainType,
    JointType,
    Model,
    TrnType,
)
from ambersim_tpu_torch.engine import linalg
from ambersim_tpu_torch.engine.schedule import device_index, tree_schedule

_SUPPORT_CACHE: dict = {}


def _span(base: np.ndarray, width: int) -> np.ndarray:
    """(len(base), width) static index block base + 0..width-1."""
    return base[:, None] + np.arange(width)[None, :]


def kinematics(m: Model, d: Data) -> Data:
    """Forward kinematics: joint -> cartesian body/geom/site/joint frames."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    B = d.qpos.shape[0]

    def ix(a):
        return device_index(a, dev)

    xpos = d.qpos.new_zeros((B, s.nbody, 3))
    xquat = d.qpos.new_zeros((B, s.nbody, 4))
    xquat[..., 0] = 1.0
    xanchor = d.qpos.new_zeros((B, s.njnt, 3))
    xaxis = d.qpos.new_zeros((B, s.njnt, 3))

    # mocap bodies: jointless world children whose frame comes from
    # d.mocap_pos / mocap_quat instead of body_pos / body_quat (per env)
    body_pos, body_quat = m.body_pos, m.body_quat
    if s.nmocap:
        mid = ix(s.mocap_bodyid)
        body_pos = body_pos.expand(B, -1, -1).clone()
        body_quat = body_quat.expand(B, -1, -1).clone()
        body_pos[:, mid] = d.mocap_pos
        body_quat[:, mid] = am.normalize_quat(d.mocap_quat)

    for level in sched.levels:
        for sig, ids, parents, jnt_slots in level:
            pt = ix(parents)
            pos = xpos[:, pt] + am.rotate(body_pos[..., ix(ids), :], xquat[:, pt])
            quat = am.mul_quat(xquat[:, pt], body_quat[..., ix(ids), :])
            for slot, jtype_int in enumerate(sig):
                jids = jnt_slots[slot]
                jt = ix(jids)
                jtype = JointType(jtype_int)
                qa = s.jnt_qposadr[jids]
                if jtype == JointType.FREE:
                    pos = d.qpos[:, ix(_span(qa, 3))]
                    quat = am.normalize_quat(d.qpos[:, ix(_span(qa + 3, 4))])
                    xanchor[:, jt] = pos
                    xaxis[:, jt] = am.rotate(m.jnt_axis[jt], quat)
                elif jtype == JointType.BALL:
                    qloc = am.normalize_quat(d.qpos[:, ix(_span(qa, 4))])
                    anchor = pos + am.rotate(m.jnt_pos[jt], quat)
                    quat = am.mul_quat(quat, qloc)
                    pos = anchor - am.rotate(m.jnt_pos[jt], quat)
                    xanchor[:, jt] = anchor
                    xaxis[:, jt] = am.rotate(m.jnt_axis[jt], quat)
                elif jtype == JointType.HINGE:
                    angle = d.qpos[:, ix(qa)] - m.qpos0[ix(qa)]
                    anchor = pos + am.rotate(m.jnt_pos[jt], quat)
                    qloc = am.axis_angle_to_quat(m.jnt_axis[jt], angle)
                    quat = am.mul_quat(quat, qloc)
                    pos = anchor - am.rotate(m.jnt_pos[jt], quat)
                    xanchor[:, jt] = anchor
                    xaxis[:, jt] = am.rotate(m.jnt_axis[jt], quat)
                else:  # SLIDE
                    ax = am.rotate(m.jnt_axis[jt], quat)
                    pos = pos + ax * (d.qpos[:, ix(qa)] - m.qpos0[ix(qa)])[..., None]
                    xanchor[:, jt] = pos + am.rotate(m.jnt_pos[jt], quat)
                    xaxis[:, jt] = ax
            xpos[:, ix(ids)] = pos
            xquat[:, ix(ids)] = am.normalize_quat(quat)

    xipos = xpos + am.rotate(m.body_ipos, xquat)
    ximat = am.quat_to_mat(am.mul_quat(xquat, m.body_iquat))
    bid = ix(s.geom_bodyid)
    geom_xpos = xpos[:, bid] + am.rotate(m.geom_pos, xquat[:, bid])
    geom_xmat = am.quat_to_mat(am.mul_quat(xquat[:, bid], m.geom_quat))
    sbid = ix(s.site_bodyid)
    site_xpos = xpos[:, sbid] + am.rotate(m.site_pos, xquat[:, sbid])
    site_xmat = am.quat_to_mat(am.mul_quat(xquat[:, sbid], m.site_quat))
    return d.replace(
        xpos=xpos,
        xquat=xquat,
        xanchor=xanchor,
        xaxis=xaxis,
        xipos=xipos,
        ximat=ximat,
        geom_xpos=geom_xpos,
        geom_xmat=geom_xmat,
        site_xpos=site_xpos,
        site_xmat=site_xmat,
    )


def com_pos(m: Model, d: Data) -> Data:
    """Subtree COM, com-frame spatial inertias (cinert) and dof axes (cdof)."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    B = d.qpos.shape[0]

    def ix(a):
        return device_index(a, dev)

    # subtree com: bottom-up level accumulation (index_add_ sums siblings
    # that share a parent)
    mass_acc = m.body_mass.clone()
    mpos_acc = m.body_mass[:, None] * d.xipos
    for child_ids, parent_ids in sched.reverse_levels:
        ct, pt = ix(child_ids), ix(parent_ids)
        mass_acc.index_add_(0, pt, mass_acc[ct])
        mpos_acc.index_add_(1, pt, mpos_acc[:, ct])
    subtree_com = mpos_acc / torch.clamp(mass_acc, min=1e-12)[:, None]
    origin = subtree_com[:, ix(s.body_rootid)]

    # cinert = spatial inertia about the subtree-com origin:
    # [[W + m((c.c)E - c c^T), m S(c)], [-m S(c), m E]], W = R diag(I) R^T
    R = am.quat_to_mat(am.mul_quat(d.xquat, m.body_iquat))  # (B, nbody, 3, 3)
    W = (R * m.body_inertia[:, None, :]) @ R.transpose(-1, -2)
    mass = m.body_mass[:, None, None]
    c = d.xipos - origin
    c2 = (c * c).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=c.dtype, device=dev)
    tl = W + mass * (c2 * eye - c[..., :, None] * c[..., None, :])
    tr = mass * _skew(c)
    br = (mass * eye).expand(B, -1, -1, -1)
    cinert = torch.cat([torch.cat([tl, tr], -1), torch.cat([tr.transpose(-1, -2), br], -1)], -2)

    # cdof: order-free, vectorized per joint type
    cdof = d.qpos.new_zeros((B, s.nv, 6))
    for jtype_int, jids in sched.jnt_by_type.items():
        jtype = JointType(jtype_int)
        jt = ix(jids)
        b = ix(s.jnt_bodyid[jids])
        da = s.jnt_dofadr[jids]
        o = origin[:, b]
        if jtype == JointType.HINGE:
            ax = d.xaxis[:, jt]
            cdof[:, ix(da)] = torch.cat([ax, am.cross(ax, o - d.xanchor[:, jt])], -1)
        elif jtype == JointType.SLIDE:
            ax = d.xaxis[:, jt]
            cdof[:, ix(da)] = torch.cat([torch.zeros_like(ax), ax], -1)
        else:
            xmat = am.quat_to_mat(d.xquat[:, b])  # (B, G, 3, 3)
            anchors = d.xanchor[:, jt]
            if jtype == JointType.FREE:
                eye_g = eye.expand(xmat.shape)
                cdof[:, ix(_span(da, 3))] = torch.cat([torch.zeros_like(eye_g), eye_g], -1)
                da = da + 3
            axes = xmat.transpose(-1, -2)  # rows = body axes
            lin = am.cross(axes, (o - anchors)[:, :, None, :])
            cdof[:, ix(_span(da, 3))] = torch.cat([axes, lin], -1)

    return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with S(v) @ x = v x x."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(v.shape[:-1] + (3, 3))


def com_vel(m: Model, d: Data) -> Data:
    """Body spatial velocities and cdof time-derivatives (mirrors mj_comVel)."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    B = d.qpos.shape[0]

    def ix(a):
        return device_index(a, dev)

    cvel = d.qpos.new_zeros((B, s.nbody, 6))
    cdof_dot = d.qpos.new_zeros((B, s.nv, 6))

    def advance(v, idx):
        return v + (d.cdof[:, idx] * d.qvel[:, idx][..., None]).sum(-2)

    for level in sched.levels:
        for sig, ids, parents, jnt_slots in level:
            v = cvel[:, ix(parents)]
            for slot, jtype_int in enumerate(sig):
                jtype = JointType(jtype_int)
                da = s.jnt_dofadr[jnt_slots[slot]]
                if jtype == JointType.FREE:
                    # world-fixed translation axes have zero derivative and
                    # join the running velocity before the rotation axes
                    v = advance(v, ix(_span(da, 3)))
                    idx = ix(_span(da + 3, 3))
                else:
                    idx = ix(_span(da, jtype.dof_width))
                cdof_dot[:, idx] = am.motion_cross(v[:, :, None, :], d.cdof[:, idx])
                v = advance(v, idx)
            cvel[:, ix(ids)] = v
    return d.replace(cvel=cvel, cdof_dot=cdof_dot)


def crb(m: Model, d: Data) -> Data:
    """Composite-rigid-body mass matrix, dense."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device

    def ix(a):
        return device_index(a, dev)

    crb_body = d.cinert.clone()  # accumulated in place below
    for child_ids, parent_ids in sched.reverse_levels:
        keep = parent_ids > 0
        if keep.any():
            crb_body.index_add_(1, ix(parent_ids[keep]), crb_body[:, ix(child_ids[keep])])
    if s.nv == 0:
        return d.replace(qM=d.qpos.new_zeros((d.qpos.shape[0], 0, 0)))
    cm = crb_body[:, ix(s.dof_bodyid)]  # (B, nv, 6, 6)
    f = (cm * d.cdof[:, :, None, :]).sum(-1)  # (B, nv, 6)
    m_full = (f[:, :, None, :] * d.cdof[:, None, :, :]).sum(-1)  # (B, nv, nv)
    half = torch.where(ix(s.ancestor_mask), m_full, 0.0)
    qM = half + half.transpose(-1, -2) - torch.diag_embed(torch.diagonal(half, dim1=-2, dim2=-1))
    qM = qM + torch.diag(m.dof_armature)
    return d.replace(qM=qM)


def factor_m(m: Model, d: Data) -> Data:
    """Dense Cholesky of qM (kernel 1 on CUDA tensors)."""
    return d.replace(qLD=linalg.cholesky(d.qM))


def solve_m(m: Model, d: Data, x: torch.Tensor) -> torch.Tensor:
    """qM^{-1} x via the cached Cholesky factor (kernel 2 on CUDA tensors)."""
    return linalg.cho_solve(d.qLD, x)


def rne(m: Model, d: Data) -> Data:
    """Recursive Newton-Euler: bias forces C(q,v)v + g(q), level-vectorized."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    B = d.qpos.shape[0]

    def ix(a):
        return device_index(a, dev)

    gscale = 0.0 if m.opt.disableflags & DisableBit.GRAVITY else 1.0
    acc = d.qpos.new_zeros((B, s.nbody, 6))
    acc[:, 0, 3:] = -gscale * m.opt.gravity

    for level in sched.levels:
        for sig, ids, parents, jnt_slots in level:
            a = acc[:, ix(parents)]
            for slot, jtype_int in enumerate(sig):
                idx = ix(_span(s.jnt_dofadr[jnt_slots[slot]], JointType(jtype_int).dof_width))
                a = a + (d.cdof_dot[:, idx] * d.qvel[:, idx][..., None]).sum(-2)
            acc[:, ix(ids)] = a

    iv = (d.cinert * d.cvel[..., None, :]).sum(-1)
    frc = (d.cinert * acc[..., None, :]).sum(-1) + am.force_cross(d.cvel, iv)
    frc[:, 0] = 0.0
    for child_ids, parent_ids in sched.reverse_levels:
        keep = parent_ids > 0
        if keep.any():
            frc.index_add_(1, ix(parent_ids[keep]), frc[:, ix(child_ids[keep])])
    qfrc_bias = (d.cdof * frc[:, ix(s.dof_bodyid)]).sum(-1)
    return d.replace(qfrc_bias=qfrc_bias)


def passive(m: Model, d: Data) -> Data:
    """Joint spring/damper passive forces (mirrors mj_passive)."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    if s.nv == 0:
        return d

    def ix(a):
        return device_index(a, dev)

    spring = torch.zeros_like(d.qvel)
    for jtype_int, jids in sched.jnt_by_type.items():
        jtype = JointType(jtype_int)
        qa = s.jnt_qposadr[jids]
        da = s.jnt_dofadr[jids]
        k = m.jnt_stiffness[ix(jids)]
        if jtype in (JointType.HINGE, JointType.SLIDE):
            spring.index_add_(1, ix(da), -k * (d.qpos[:, ix(qa)] - m.qpos_spring[ix(qa)]))
        elif jtype == JointType.BALL:
            q4 = ix(_span(qa, 4))
            dif = am.quat_sub(d.qpos[:, q4], m.qpos_spring[q4])
            spring[:, ix(_span(da, 3))] += -k[:, None] * dif
        else:  # FREE
            q3 = ix(_span(qa, 3))
            spring[:, ix(_span(da, 3))] += -k[:, None] * (d.qpos[:, q3] - m.qpos_spring[q3])
            q4 = ix(_span(qa + 3, 4))
            dif = am.quat_sub(d.qpos[:, q4], m.qpos_spring[q4])
            spring[:, ix(_span(da + 3, 3))] += -k[:, None] * dif
    damper = -m.dof_damping * d.qvel
    df = m.opt.disableflags
    if df & DisableBit.SPRING:
        spring = torch.zeros_like(spring)
    if df & DisableBit.DAMPER:
        damper = torch.zeros_like(damper)
    return d.replace(qfrc_spring=spring, qfrc_damper=damper, qfrc_passive=spring + damper)


def _joint_arrays(s):
    """(dof ids, qpos ids) driven by each actuator: every actuator sits on a
    hinge/slide joint (`io.bridge.check_slice` admits no other)."""
    j = np.asarray(s.actuator_trnid)
    return np.asarray(s.jnt_dofadr)[j], np.asarray(s.jnt_qposadr)[j]


def _all_motors(s) -> bool:
    """Every actuator a motor: fixed gain, no bias, no dynamics."""
    return bool(
        (np.asarray(s.actuator_gaintype) == int(GainType.FIXED)).all()
        and (np.asarray(s.actuator_biastype) == int(BiasType.NONE)).all()
        and (np.asarray(s.actuator_dyntype) == int(DynType.NONE)).all()
    )


def dyn_actuators(s) -> np.ndarray:
    """Actuators with activation dynamics, in the order of d.act."""
    return np.nonzero(np.asarray(s.actuator_dyntype) != int(DynType.NONE))[0]


def fwd_actuation(m: Model, d: Data) -> Data:
    """ctrl -> generalized actuator force for actuators on hinge/slide joints:
    gain (fixed or affine) times input (ctrl, or the activation) plus bias
    (none or affine), act_dot of filter, filterexact and integrator
    dynamics, the forcerange clamp, disabled actuator groups and the joints'
    actuatorfrcrange clamp. A model of motors alone keeps the motor
    arithmetic, gainprm[0] * ctrl, with no bias term."""
    s = m.skel
    dev = d.qpos.device
    if s.nu == 0:
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))

    def ix(a):
        return device_index(a, dev)

    ctrl = d.ctrl
    if not (m.opt.disableflags & DisableBit.CLAMPCTRL):
        lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
        ctrl = torch.where(ix(s.actuator_ctrllimited), torch.clamp(ctrl, lo, hi), ctrl)
    dof, qa = _joint_arrays(s)
    gear = m.actuator_gear[:, 0]
    length = d.qpos[:, ix(qa)] * gear
    velocity = d.qvel[:, ix(dof)] * gear
    act_dot = d.act_dot
    if _all_motors(s):
        force = m.actuator_gainprm[:, 0] * ctrl
    else:
        gp, bp = m.actuator_gainprm, m.actuator_biasprm
        gain = torch.where(
            ix(np.asarray(s.actuator_gaintype) == int(GainType.FIXED)), gp[:, 0],
            gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity)
        bias = torch.where(
            ix(np.asarray(s.actuator_biastype) == int(BiasType.AFFINE)),
            bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity, 0.0)
        inp = ctrl  # the force's input: ctrl, or the activation where there are dynamics
        if s.na:
            # filter / filterexact: act_dot = (ctrl - act) / tau; integrator: ctrl
            dyn_u = dyn_actuators(s)
            dyn = np.asarray(s.actuator_dyntype)[dyn_u]
            is_filter = ix((dyn == int(DynType.FILTER)) | (dyn == int(DynType.FILTEREXACT)))
            tau = torch.clamp(m.actuator_dynprm[ix(dyn_u), 0], min=1e-8)
            u = ix(dyn_u)
            act_dot = torch.where(is_filter, (ctrl[:, u] - d.act) / tau, ctrl[:, u])
            inp = ctrl.clone()
            inp[:, u] = d.act
        force = gain * inp + bias
    force = torch.where(
        ix(s.actuator_forcelimited),
        torch.clamp(force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]),
        force,
    )
    if m.opt.disableactuator:
        # <option actuatorgroupdisable>: no force from actuators of disabled
        # groups; their lengths, velocities and activations still advance
        group = np.asarray(s.actuator_group)
        disabled = ((m.opt.disableactuator >> np.clip(group, 0, 30)) & 1).astype(bool) & (group >= 0)
        force = torch.where(ix(disabled), 0.0, force)
    qfrc = torch.zeros_like(d.qvel).index_add_(1, ix(dof), gear * force)
    if np.asarray(s.jnt_actfrclimited).any():
        # a joint's actuatorfrcrange clamps the total actuator force on its dofs
        dof_jnt = np.asarray(s.dof_jntid)
        rng = m.jnt_actfrcrange[ix(dof_jnt)]
        qfrc = torch.where(ix(np.asarray(s.jnt_actfrclimited)[dof_jnt]), torch.clamp(qfrc, rng[:, 0], rng[:, 1]), qfrc)
    if m.opt.disableflags & DisableBit.ACTUATION:
        force = torch.zeros_like(force)
        qfrc = torch.zeros_like(qfrc)
    return d.replace(
        actuator_length=length, actuator_velocity=velocity, actuator_force=force, act_dot=act_dot,
        qfrc_actuator=qfrc,
    )


def energy_pos(m: Model, d: Data) -> torch.Tensor:
    """(B,) potential energy (mj_energyPos): gravity (unless GRAVITY is
    disabled) and joint springs (unless SPRING is disabled); ball and free
    rotational springs as 0.5 k |quat_sub|^2, as in `passive`. The tendon
    springs' part waits with the tendons (`io.bridge.check_slice`)."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device

    def ix(a):
        return device_index(a, dev)

    e = d.qpos.new_zeros(d.qpos.shape[0])
    if not (m.opt.disableflags & DisableBit.GRAVITY):
        e = e - (m.body_mass[:, None] * d.xipos * m.opt.gravity).sum((-2, -1))
    if m.opt.disableflags & DisableBit.SPRING:
        return e
    for jtype_int, jids in sched.jnt_by_type.items():
        jtype = JointType(jtype_int)
        qa = s.jnt_qposadr[jids]
        k = m.jnt_stiffness[ix(jids)]
        if jtype in (JointType.HINGE, JointType.SLIDE):
            e = e + (0.5 * k * (d.qpos[:, ix(qa)] - m.qpos_spring[ix(qa)]) ** 2).sum(-1)
        elif jtype == JointType.BALL:
            dif = am.quat_sub(d.qpos[:, ix(_span(qa, 4))], m.qpos_spring[ix(_span(qa, 4))])
            e = e + (0.5 * k * (dif**2).sum(-1)).sum(-1)
        else:  # FREE: translational and rotational parts
            dt3 = d.qpos[:, ix(_span(qa, 3))] - m.qpos_spring[ix(_span(qa, 3))]
            e = e + (0.5 * k * (dt3**2).sum(-1)).sum(-1)
            dif = am.quat_sub(d.qpos[:, ix(_span(qa + 3, 4))], m.qpos_spring[ix(_span(qa + 3, 4))])
            e = e + (0.5 * k * (dif**2).sum(-1)).sum(-1)
    return e


def energy_vel(m: Model, d: Data) -> torch.Tensor:
    """(B,) kinetic energy 0.5 qvel' M qvel (mj_energyVel); needs crb."""
    if m.skel.nv == 0:
        return d.qpos.new_zeros(d.qpos.shape[0])
    return 0.5 * (d.qvel * (d.qM * d.qvel[:, None, :]).sum(-1)).sum(-1)


def actuator_moment(m: Model, d: Data) -> torch.Tensor:
    """(B, nu, nv) transmission moment matrix of joint transmissions: the
    gear on a hinge/slide joint's dof (JOINT or JOINTINPARENT), and the gear
    vector on a free (6) or ball (3) joint's dofs (JOINT). The JAX package's
    tendon, site, slider-crank, body and ball/free JOINTINPARENT
    transmissions are refused by name (ROADMAP, queue 1, item 5)."""
    s = m.skel
    moment = d.qpos.new_zeros((d.qpos.shape[0], s.nu, s.nv))
    scalar = (int(TrnType.JOINT), int(TrnType.JOINTINPARENT))
    for u in range(s.nu):
        trn, j = int(s.actuator_trntype[u]), int(s.actuator_trnid[u])
        jtype = JointType(int(s.jnt_type[j])) if trn in scalar else None
        da = int(s.jnt_dofadr[j]) if jtype is not None else 0
        if jtype in (JointType.HINGE, JointType.SLIDE):
            moment[:, u, da] = m.actuator_gear[u, 0]
        elif trn == int(TrnType.JOINT):
            width = jtype.dof_width if jtype == JointType.FREE else 3
            moment[:, u, da : da + width] = m.actuator_gear[u, :width]
        else:
            what = TrnType(trn).name + (f" on {jtype.name.lower()} joints" if jtype is not None else "")
            raise NotImplementedError(
                f"actuator transmission {what} is not ported (ROADMAP, queue 1, item 5: engine breadth)"
            )
    return moment


def _body_dof_support(s) -> np.ndarray:
    """(nbody, nv) bool: dofs on the path from each body to the world."""
    if s not in _SUPPORT_CACHE:
        sup = np.zeros((s.nbody, s.nv), dtype=bool)
        for b in range(s.nbody):
            bb = b
            while bb > 0:
                da, dn = int(s.body_dofadr[bb]), int(s.body_dofnum[bb])
                if dn:
                    sup[b, da : da + dn] = True
                bb = int(s.body_parentid[bb])
        _SUPPORT_CACHE[s] = sup
    return _SUPPORT_CACHE[s]


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
    """Map xfrc_applied (force/torque at body com, world frame) to qfrc."""
    s = m.skel
    if s.nv == 0 or s.nbody <= 1:
        return torch.zeros_like(d.qvel)
    origin = d.subtree_com[:, device_index(s.body_rootid, d.qpos.device)]
    force = d.xfrc_applied[..., :3]
    torque = d.xfrc_applied[..., 3:]
    fspatial = torch.cat([torque + am.cross(d.xipos - origin, force), force], -1)  # (B, nbody, 6)
    per_body = (fspatial[:, :, None, :] * d.cdof[:, None, :, :]).sum(-1)  # (B, nbody, nv)
    sup = device_index(_body_dof_support(s).astype(np.float32), d.qpos.device)
    return (per_body * sup).sum(1)


def fwd_position_smooth(m: Model, d: Data) -> Data:
    d = kinematics(m, d)
    d = com_pos(m, d)
    d = crb(m, d)
    return factor_m(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
    d = com_vel(m, d)
    d = passive(m, d)
    return rne(m, d)


def fwd_acceleration(m: Model, d: Data) -> Data:
    qfrc_smooth = d.qfrc_passive + d.qfrc_actuator + d.qfrc_applied + xfrc_accumulate(m, d) - d.qfrc_bias
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=solve_m(m, d, qfrc_smooth))
