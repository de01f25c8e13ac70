"""Smooth (unconstrained) dynamics: FK (mocap bodies included), COM
quantities, camera and light frames, tendon lengths and Jacobians (fixed and
spatial, with sphere and cylinder wraps and pulleys), CRBA, RNE, passive
forces (joint and tendon springs and dampers, inertia-box fluid drag,
gravity compensation), energy and actuation (joint and tendon transmissions;
motors, affine servos, FLV muscles; filter/filterexact/integrator/muscle
activations). Port of the main-path subset of
ambersim_tpu/engine/smooth.py.

Every function takes a Model and a batch-first Data and returns an updated
Data. Tree propagation is level-vectorized over the static schedule
(engine/schedule.py); indices are cached device tensors. The JAX package
unrolls one branch per spatial tendon and path element; here a plan per
skeleton (`tendon_plan`) groups the spatial tendons' segments by kind, so
the tendon stage's op count is set by the kinds present, not by the number
of tendons.
"""

from __future__ import annotations

import dataclasses

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
_PLAN_CACHE: dict = {}


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
                    angle = d.qpos[:, ix(qa)] - m.qpos0[..., ix(qa)]
                    anchor = pos + am.rotate(m.jnt_pos[jt], quat)
                    qloc = am.axis_angle_to_quat(m.jnt_axis[jt], angle)
                    quat = am.mul_quat(quat, qloc)
                    pos = anchor - am.rotate(m.jnt_pos[jt], quat)
                    xanchor[:, jt] = anchor
                    xaxis[:, jt] = am.rotate(m.jnt_axis[jt], quat)
                else:  # SLIDE
                    ax = am.rotate(m.jnt_axis[jt], quat)
                    pos = pos + ax * (d.qpos[:, ix(qa)] - m.qpos0[..., ix(qa)])[..., None]
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
    # that share a parent); body_mass may carry an env axis
    mass_acc = m.body_mass.clone()
    mpos_acc = m.body_mass[..., None] * d.xipos
    for child_ids, parent_ids in sched.reverse_levels:
        ct, pt = ix(child_ids), ix(parent_ids)
        mass_acc.index_add_(-1, pt, mass_acc[..., ct])
        mpos_acc.index_add_(1, pt, mpos_acc[:, ct])
    subtree_com = mpos_acc / torch.clamp(mass_acc, min=1e-12)[..., None]
    origin = subtree_com[:, ix(s.body_rootid)]

    # cinert = spatial inertia about the subtree-com origin:
    # [[W + m((c.c)E - c c^T), m S(c)], [-m S(c), m E]], W = R diag(I) R^T
    R = am.quat_to_mat(am.mul_quat(d.xquat, m.body_iquat))  # (B, nbody, 3, 3)
    W = (R * m.body_inertia[..., None, :]) @ R.transpose(-1, -2)
    mass = m.body_mass[..., None, None]
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


def _camlight_frames(m: Model, d: Data, bodyid, mode, target, pos, pos0, poscom0):
    """Positions (B, G, 3) of G cameras or lights and, per object, which
    frame it takes: FIXED and TARGETBODY(COM) ride the body frame (the
    local offset `pos`), TRACK keeps its world offset `pos0` from the body,
    TRACKCOM `poscom0` from the body's subtree com. Returns (pos, the body
    rotation (B, G, 3, 3), the target point (B, G, 3) or None, the masks
    of the tracking and the targeting objects)."""
    from ambersim_tpu_torch.core.types import CamLightMode as CM

    dev = d.qpos.device
    b = device_index(bodyid, dev)
    R = am.quat_to_mat(d.xquat[:, b])
    track, tcom = mode == int(CM.TRACK), mode == int(CM.TRACKCOM)
    out = d.xpos[:, b] + (R * pos[:, None, :]).sum(-1)
    if track.any():
        out = torch.where(device_index(track, dev)[:, None], d.xpos[:, b] + pos0, out)
    if tcom.any():
        out = torch.where(device_index(tcom, dev)[:, None], d.subtree_com[:, b] + poscom0, out)
    aim = (mode == int(CM.TARGETBODY)) | (mode == int(CM.TARGETBODYCOM))
    tgt = None
    if aim.any():
        t = device_index(np.where(aim, target, 0), dev)
        tgt = torch.where(device_index(mode == int(CM.TARGETBODYCOM), dev)[:, None], d.subtree_com[:, t], d.xpos[:, t])
    return out, R, tgt, track | tcom, aim


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-15)


def camlight(m: Model, d: Data) -> Data:
    """Camera and light frames (mj_camlight; JAX smooth.py:213-267), all
    cameras in one batch and all lights in another, each mode a masked
    select: FIXED rides the body frame; TRACK keeps a constant world offset
    from the body, its orientation frozen at qpos0; TRACKCOM the same from
    the body's subtree com; TARGETBODY(COM) rides the body and aims the
    camera's -z at the target body (or its subtree com): z = unit(pos -
    target), x = unit(z_world x z), y = z x x, and a light's direction at
    it. A FIXED or targeting light's direction is normalized."""
    s = m.skel
    dev = d.qpos.device
    out = {}
    if s.ncam:
        mode = np.asarray(s.cam_mode)
        pos, R, tgt, frozen, aim = _camlight_frames(m, d, s.cam_bodyid, mode, s.cam_targetbodyid, m.cam_pos,
                                                    m.cam_pos0, m.cam_poscom0)
        mat = R @ am.quat_to_mat(m.cam_quat)
        if frozen.any():
            mat = torch.where(device_index(frozen, dev)[:, None, None], m.cam_mat0, mat)
        if tgt is not None:
            z = _unit(pos - tgt)
            x = _unit(am.cross(torch.tensor([0.0, 0.0, 1.0], dtype=z.dtype, device=dev).expand_as(z), z))
            mat = torch.where(device_index(aim, dev)[:, None, None], torch.stack([x, am.cross(z, x), z], -1), mat)
        out.update(cam_xpos=pos, cam_xmat=mat)
    if s.nlight:
        mode = np.asarray(s.light_mode)
        pos, R, tgt, frozen, aim = _camlight_frames(m, d, s.light_bodyid, mode, s.light_targetbodyid, m.light_pos,
                                                    m.light_pos0, m.light_poscom0)
        xdir = (R * m.light_dir[:, None, :]).sum(-1)
        if tgt is not None:
            xdir = torch.where(device_index(aim, dev)[:, None], tgt - pos, xdir)
        xdir = _unit(xdir)
        if frozen.any():
            xdir = torch.where(device_index(frozen, dev)[:, None], m.light_dir0, xdir)
        out.update(light_xpos=pos, light_xdir=xdir)
    return d.replace(**out)


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
    qM = qM + torch.diag_embed(m.dof_armature)
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
    """Passive forces (mirrors mj_passive): joint and tendon springs and
    dampers, each zeroed by its own disable flag, then fluid drag and
    gravity compensation unless SPRING and DAMPER are both disabled."""
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
        k = m.jnt_stiffness[..., ix(jids)]
        if jtype in (JointType.HINGE, JointType.SLIDE):
            spring.index_add_(1, ix(da), -k * (d.qpos[:, ix(qa)] - m.qpos_spring[ix(qa)]))
        elif jtype == JointType.BALL:
            q4 = ix(_span(qa, 4))
            dif = am.quat_sub(d.qpos[:, q4], m.qpos_spring[q4])
            spring[:, ix(_span(da, 3))] += -k[..., None] * dif
        else:  # FREE
            q3 = ix(_span(qa, 3))
            spring[:, ix(_span(da, 3))] += -k[..., None] * (d.qpos[:, q3] - m.qpos_spring[q3])
            q4 = ix(_span(qa + 3, 4))
            dif = am.quat_sub(d.qpos[:, q4], m.qpos_spring[q4])
            spring[:, ix(_span(da + 3, 3))] += -k[..., None] * dif
    damper = -m.dof_damping * d.qvel
    if s.ntendon:
        # the tendons' deadband springs (springlength's [lo, hi] range) and dampers
        spring = spring + _ten_transpose(d, -m.tendon_stiffness * _ten_deadband(m, d))
        damper = damper + _ten_transpose(d, -m.tendon_damping * d.ten_velocity)
    df = m.opt.disableflags
    if df & DisableBit.SPRING:
        spring = torch.zeros_like(spring)
    if df & DisableBit.DAMPER:
        damper = torch.zeros_like(damper)
    qfrc_passive = spring + damper
    if passive_extras_on(m):
        # fluid drag and gravity compensation: one wrench at each body's com
        force = torque = None
        if getattr(s, "has_fluid", False):
            force, torque = _fluid_wrench(m, d)
        if getattr(s, "has_gravcomp", False) and not (df & DisableBit.GRAVITY):
            # the antigravity force gravcomp * mass * (-g) (none without gravity)
            fg = -(m.body_gravcomp * m.body_mass)[..., None] * m.opt.gravity
            force = fg if force is None else force + fg
        if force is not None:
            qfrc_passive = qfrc_passive + _com_wrench_to_qfrc(m, d, force, torque)
    return d.replace(qfrc_spring=spring, qfrc_damper=damper, qfrc_passive=qfrc_passive)


def passive_extras_on(m: Model) -> bool:
    """Whether `passive` adds fluid drag or gravity compensation: the model
    has either, and SPRING and DAMPER are not both disabled (mj_passive
    returns early then; JAX smooth.py:428-436)."""
    s = m.skel
    both_off = (m.opt.disableflags & int(DisableBit.PASSIVE)) == int(DisableBit.PASSIVE)
    return bool(getattr(s, "has_fluid", False) or getattr(s, "has_gravcomp", False)) and not both_off


def _com_wrench_to_qfrc(m: Model, d: Data, force: torch.Tensor, torque) -> torch.Tensor:
    """(B, nv) generalized force of world wrenches on each body at its com
    (force (B or none, nbody, 3), torque (B, nbody, 3) or None): the
    spatial force about the root's subtree com, carried to the dofs that
    support each body (`_body_dof_support`)."""
    s = m.skel
    dev = d.qpos.device
    r = d.xipos - d.subtree_com[:, device_index(s.body_rootid, dev)]
    ang = am.cross(r, force.expand_as(r))
    if torque is not None:
        ang = ang + torque
    f = torch.cat([ang, force.expand_as(r)], -1)  # (B, nbody, 6)
    sup = device_index(_body_dof_support(s).T.astype(np.float32), dev, dtype=f.dtype)  # (nv, nbody)
    return (d.cdof * (sup @ f)).sum(-1)


def _fluid_box(m: Model):
    """(box sides (.., nbody, 3), equivalent sphere diameters (.., nbody),
    live mask): each body's inertia box, half-sizes sqrt((I_j + I_k - I_i)
    3 / 2m), for bodies of mass above 1e-9."""
    mass = m.body_mass
    I = m.body_inertia
    Ij, Ik = torch.roll(I, -1, -1), torch.roll(I, -2, -1)
    half = torch.sqrt(torch.clamp((Ij + Ik - I) * 3.0 / (2.0 * torch.clamp(mass, min=1e-12)[..., None]), min=1e-12))
    return 2.0 * half, 2.0 * half.mean(-1), mass > 1e-9


def _fluid_local_vel(m: Model, d: Data):
    """Each body's (angular, linear) velocity at its com in its inertial
    frame (B, nbody, 3), the linear one relative to opt.wind."""
    s = m.skel
    r = d.xipos - d.subtree_com[:, device_index(s.body_rootid, d.qpos.device)]
    ang = d.cvel[..., :3]
    lin = d.cvel[..., 3:] + am.cross(ang, r)
    return am.mat_t_vec(d.ximat, ang), am.mat_t_vec(d.ximat, lin - m.opt.wind)


def _fluid_wrench(m: Model, d: Data):
    """World (force, torque) (B, nbody, 3) of the inertia-box fluid model
    at each body's com (mj_passive; JAX smooth.py:495-541): viscous sphere
    drag and quadratic density drag on the body's local velocity, zero on
    bodies of mass <= 1e-9."""
    side, diam, live = _fluid_box(m)
    lang, llin = _fluid_local_vel(m, d)
    rho, beta = m.opt.density, m.opt.viscosity
    sj, sk = torch.roll(side, -1, -1), torch.roll(side, -2, -1)
    force = -3.0 * np.pi * diam[..., None] * beta * llin - 0.5 * rho * sj * sk * llin.abs() * llin
    torque = (-np.pi * diam[..., None] ** 3 * beta * lang
              - rho * side * (sj**4 + sk**4) * lang.abs() * lang / 64.0)
    force = torch.where(live[..., None], force, 0.0)
    torque = torch.where(live[..., None], torque, 0.0)
    return (d.ximat * force[..., None, :]).sum(-1), (d.ximat * torque[..., None, :]).sum(-1)


def fluid_deriv(m: Model, d: Data) -> torch.Tensor:
    """(B, nv, nv) d(fluid force)/dqvel in closed form, the fluid part of
    the JAX package's forward-mode _qderiv_vel_ad (integrate.py:117-147).
    Each body's drag is diagonal in its inertial frame in the local
    velocity: d force_i/d llin_i = -3 pi diam beta - rho s_j s_k |llin_i|
    (|v| v has derivative 2 |v|, also 0 at 0 as forward-mode AD takes it),
    d torque_i/d lang_i = -pi diam^3 beta - rho s_i (s_j^4 + s_k^4)
    |lang_i| / 32; with A = J R the com's Jacobian in that frame, D =
    sum over bodies of A diag(k) A^T, symmetric. J are the com's rotational
    and point Jacobians; the wind only shifts llin."""
    s = m.skel
    side, diam, live = _fluid_box(m)
    lang, llin = _fluid_local_vel(m, d)
    rho, beta = m.opt.density, m.opt.viscosity
    sj, sk = torch.roll(side, -1, -1), torch.roll(side, -2, -1)
    kf = -3.0 * np.pi * diam[..., None] * beta - rho * sj * sk * llin.abs()
    kt = -np.pi * diam[..., None] ** 3 * beta - rho * side * (sj**4 + sk**4) * lang.abs() / 32.0
    kf = torch.where(live[..., None], kf, 0.0)
    kt = torch.where(live[..., None], kt, 0.0)
    bodies = np.arange(s.nbody)
    a_lin = _point_jac(m, d, d.xipos, bodies) @ d.ximat  # (B, nbody, nv, 3)
    a_ang = _rot_jac(m, d, bodies) @ d.ximat
    return ((a_lin * kf[:, :, None]) @ a_lin.transpose(-1, -2) + (a_ang * kt[:, :, None]) @ a_ang.transpose(-1, -2)).sum(1)


def _ten_deadband(m: Model, d: Data) -> torch.Tensor:
    """(B, ntendon) each tendon's length past its springlength range [lo, hi]."""
    lo, hi = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
    L = d.ten_length
    return torch.where(L < lo, L - lo, 0.0) + torch.where(L > hi, L - hi, 0.0)


def _ten_transpose(d: Data, f: torch.Tensor) -> torch.Tensor:
    """ten_J^T f: (B, ntendon) tendon forces -> (B, nv) generalized forces."""
    return (d.ten_J * f[..., None]).sum(1)


@dataclasses.dataclass(frozen=True)
class TrnPlan:
    """The actuators grouped by transmission kind (cached by skeleton), so
    the actuation stage's op count is set by the kinds present, not by the
    number of actuators. `joint` are the actuators on hinge and slide
    joints (JOINT and JOINTINPARENT coincide there): one dof each, the gear
    on it. Every other actuator is in `rows`, in model order, and in one
    kind's group below; its moment is a full (nv,) row."""

    joint: np.ndarray  # (J,) hinge/slide actuators
    joint_dof: np.ndarray  # (J,) their dofs
    joint_qa: np.ndarray  # (J,) their qpos addresses
    rows: np.ndarray  # (R,) every other actuator
    tendon: np.ndarray  # actuators on tendons ...
    tendon_id: np.ndarray  # ... and their tendons
    ball: np.ndarray  # JOINT on a ball joint: gear[:3] on its dofs
    ball_inparent: np.ndarray  # JOINTINPARENT on a ball joint: R(q)^T gear[:3]
    ball_jnt: np.ndarray  # (len(ball) + len(ball_inparent),) their joints, ball first
    free: np.ndarray  # JOINT on a free joint: gear[:6] on its dofs, length 0
    free_inparent: np.ndarray  # JOINTINPARENT on a free joint: gear[:3], R(q)^T gear[3:]
    free_jnt: np.ndarray  # (len(free) + len(free_inparent),) their joints, free first
    site: np.ndarray  # SITE, with or without a refsite
    site_id: np.ndarray  # their sites
    site_ref: np.ndarray  # their refsites (-1 for none): length and moment in its frame
    crank: np.ndarray  # SLIDERCRANK ...
    crank_slider: np.ndarray  # ... their slider sites
    crank_site: np.ndarray  # ... and crank sites
    body: np.ndarray  # BODY (adhesion) ...
    body_id: np.ndarray  # ... and their bodies

    @property
    def kinds(self) -> tuple:
        """The groups in the order their rows are computed (`_trn_rows`)."""
        return (self.tendon, self.ball, self.ball_inparent, self.free, self.free_inparent, self.site, self.crank,
                self.body)


def trn_plan(s) -> TrnPlan:
    """The skeleton's TrnPlan, built once and cached."""
    key = (s, "trn")
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]
    trn, ids = np.asarray(s.actuator_trntype), np.asarray(s.actuator_trnid)
    refid = np.asarray(getattr(s, "actuator_refid", np.full(s.nu, -1)))
    on_joint = (trn == int(TrnType.JOINT)) | (trn == int(TrnType.JOINTINPARENT))
    jtype = np.where(on_joint, np.asarray(s.jnt_type)[np.where(on_joint, ids, 0)], -1)
    scalar = on_joint & ((jtype == int(JointType.HINGE)) | (jtype == int(JointType.SLIDE)))
    inparent = trn == int(TrnType.JOINTINPARENT)

    def pick(mask):
        return np.nonzero(mask)[0].astype(np.int64)

    ball = pick(on_joint & ~inparent & (jtype == int(JointType.BALL)))
    ball_in = pick(inparent & (jtype == int(JointType.BALL)))
    free = pick(on_joint & ~inparent & (jtype == int(JointType.FREE)))
    free_in = pick(inparent & (jtype == int(JointType.FREE)))
    site = pick(trn == int(TrnType.SITE))
    crank = pick(trn == int(TrnType.SLIDERCRANK))
    body = pick(trn == int(TrnType.BODY))
    tendon = pick(trn == int(TrnType.TENDON))
    joint = pick(scalar)
    plan = TrnPlan(
        joint=joint, joint_dof=np.asarray(s.jnt_dofadr)[ids[joint]], joint_qa=np.asarray(s.jnt_qposadr)[ids[joint]],
        rows=pick(~scalar), tendon=tendon, tendon_id=ids[tendon], ball=ball, ball_inparent=ball_in,
        ball_jnt=ids[np.concatenate([ball, ball_in])], free=free, free_inparent=free_in,
        free_jnt=ids[np.concatenate([free, free_in])], site=site, site_id=ids[site], site_ref=refid[site],
        crank=crank, crank_slider=ids[crank], crank_site=refid[crank], body=body, body_id=ids[body])
    _PLAN_CACHE[key] = plan
    return plan


def _quat2vel(q: torch.Tensor) -> torch.Tensor:
    """mju_quat2Vel(q, dt=1): the expmap 3-vector of (..., 4) quaternions,
    without the shortest-arc sign flip (JAX smooth.py:718-727)."""
    v = q[..., 1:]
    s2 = (v * v).sum(-1)
    good = s2 > 1e-24
    sin_half = torch.sqrt(torch.where(good, s2, 1.0))
    angle = 2.0 * torch.atan2(sin_half, q[..., 0])
    return torch.where(good[..., None], v / sin_half[..., None] * angle[..., None], 2.0 * v)


def _rot_jac(m: Model, d: Data, body: np.ndarray) -> torch.Tensor:
    """(B, G, nv, 3) rotational Jacobians of bodies `body` (G,)."""
    sup = device_index(_body_dof_support(m.skel)[body], d.qpos.device, dtype=d.qpos.dtype)
    return d.cdof[:, None, :, :3] * sup[None, :, :, None]


def _slidercrank(m: Model, d: Data, u: np.ndarray, slider: np.ndarray, crank: np.ndarray):
    """Slider-crank transmissions (mj_transmission SLIDERCRANK; JAX
    smooth.py:729-756) of actuators `u`: a rod of length r from the crank
    site to a piston sliding along the slider site's z axis. Returns length
    a.v - sqrt((a.v)^2 - v.v + r^2), v the slider-to-crank vector, and its
    (B, G, nv) derivative, without the gear. Where the discriminant is not
    positive the rod is broken and the root and its derivative drop out: a
    batch-wide where whose root is taken of 1 there, so the branch not taken
    keeps a finite gradient."""
    s = m.skel
    dev = d.qpos.device
    sid, cid = device_index(slider, dev), device_index(crank, dev)
    bs, bc = np.asarray(s.site_bodyid)[slider], np.asarray(s.site_bodyid)[crank]
    a = d.site_xmat[:, sid][..., :, 2]  # (B, G, 3)
    v = d.site_xpos[:, cid] - d.site_xpos[:, sid]
    dv = _point_jac(m, d, d.site_xpos[:, cid], bc) - _point_jac(m, d, d.site_xpos[:, sid], bs)  # (B, G, nv, 3)
    da = am.cross(_rot_jac(m, d, bs), a[:, :, None, :])  # d(a)/dqvel_k = w_k x a
    av = _dot(a, v)
    dav = _dot(dv, a[:, :, None, :]) + _dot(da, v[:, :, None, :])  # (B, G, nv)
    r = m.actuator_cranklength[device_index(u, dev)]
    sdet = av * av - _dot(v, v) + r * r
    ok = sdet > 1e-12
    sq = torch.sqrt(torch.where(ok, sdet, 1.0))
    length = av - torch.where(ok, sq, 0.0)
    dlen = dav - torch.where(ok[..., None], (av[..., None] * dav - _dot(dv, v[:, :, None, :])) / sq[..., None], 0.0)
    return length, dlen


def _adhesion(m: Model, d: Data, body: np.ndarray) -> torch.Tensor:
    """(B, G, nv) moments of adhesion (BODY) transmissions on bodies `body`:
    minus the mean contact-normal Jacobian row over the contacts of the body
    within includemargin (JAX smooth.py:686-715). Reads d.contact, so it
    runs after collision."""
    from ambersim_tpu_torch.engine.constraint import _contact_support, _frame_rows, _point_jac_rows

    dev = d.qpos.device
    c = d.contact
    signed_sup, _, gb1, gb2 = _contact_support(m, d)
    jn = _frame_rows(c.frame, _point_jac_rows(m, d, c.pos, signed_sup))[0]  # (B, ncon, nv)
    b = device_index(body, dev)[:, None]  # (G, 1)
    mask = (c.dist < c.includemargin)[:, None, :] & ((gb1[..., None, :] == b) | (gb2[..., None, :] == b))  # (B, G, ncon)
    cnt = mask.to(jn.dtype).sum(-1)
    return -torch.where(mask[..., None], jn[:, None], 0.0).sum(2) / torch.clamp(cnt, min=1.0)[..., None]


def _trn_rows(m: Model, d: Data):
    """Lengths (B, R) and moment rows (B, R, nv) of the plan's `rows`
    actuators, one batch per transmission kind: a tendon's gear[0] ten_J; a
    ball joint's gear . expmap(its quat) (JOINT and JOINTINPARENT alike) on
    its dofs, the moment gear[:3] (JOINT) or R(q)^T gear[:3]
    (JOINTINPARENT); a free joint's length 0, its moment gear[:6] (JOINT)
    or gear[:3] and R(q)^T gear[3:] (JOINTINPARENT); a site's wrench gear
    in its frame, length 0, or with a refsite the site's pose relative to
    the refsite in the refsite's frame and the two sites' Jacobians apart
    (the rotation composed as site_quat * body xquat, JAX smooth.py:758-
    778); a slider-crank's gear[0] times its length and derivative; an
    adhesion body's `_adhesion`, length 0."""
    s = m.skel
    dev, dt = d.qpos.device, d.qpos.dtype
    B = d.qpos.shape[0]
    plan = trn_plan(s)

    def ix(a):
        return device_index(a, dev)

    gear = m.actuator_gear
    lengths, moments = [], []
    if len(plan.tendon):
        g0 = gear[..., ix(plan.tendon), 0]
        lengths.append(d.ten_length[:, ix(plan.tendon_id)] * g0)
        moments.append(g0[..., None] * d.ten_J[:, ix(plan.tendon_id)])
    nball = len(plan.ball) + len(plan.ball_inparent)
    if nball:
        bu = np.concatenate([plan.ball, plan.ball_inparent])
        q = am.normalize_quat(d.qpos[:, ix(np.asarray(s.jnt_qposadr)[plan.ball_jnt][:, None] + np.arange(4))])
        g = gear[..., ix(bu), :3]
        lengths.append((g * _quat2vel(q)).sum(-1))
        mom3 = g.expand(B, -1, -1)
        if len(plan.ball_inparent):
            inp = ix(np.arange(len(plan.ball), nball))
            mom3 = mom3.clone()
            mom3[:, inp] = am.mat_t_vec(am.quat_to_mat(q[:, inp]), mom3[:, inp])
        row = d.qpos.new_zeros((B, nball, s.nv))
        row[:, ix(np.arange(nball)[:, None]), ix(np.asarray(s.jnt_dofadr)[plan.ball_jnt][:, None] + np.arange(3))] = mom3
        moments.append(row)
    nfree = len(plan.free) + len(plan.free_inparent)
    if nfree:
        fu = np.concatenate([plan.free, plan.free_inparent])
        g = gear[..., ix(fu), :].expand(B, -1, -1)
        if len(plan.free_inparent):
            inp = ix(np.arange(len(plan.free), nfree))
            qa = np.asarray(s.jnt_qposadr)[plan.free_jnt[len(plan.free):]]
            R = am.quat_to_mat(am.normalize_quat(d.qpos[:, ix(qa[:, None] + 3 + np.arange(4))]))
            g = g.clone()
            g[:, inp, 3:] = am.mat_t_vec(R, g[:, inp, 3:])
        row = d.qpos.new_zeros((B, nfree, s.nv))
        row[:, ix(np.arange(nfree)[:, None]), ix(np.asarray(s.jnt_dofadr)[plan.free_jnt][:, None] + np.arange(6))] = g
        lengths.append(d.qpos.new_zeros((B, nfree)))
        moments.append(row)
    if len(plan.site):
        sid, ref = plan.site_id, plan.site_ref
        has_ref = ref >= 0
        rid = np.where(has_ref, ref, sid)  # a site without a refsite takes its own frame
        bs, br = np.asarray(s.site_bodyid)[sid], np.asarray(s.site_bodyid)[rid]
        R = d.site_xmat[:, ix(rid)]  # (B, G, 3, 3) world <- the frame the gear is in
        g = gear[..., ix(plan.site), :]
        rf = ix(has_ref)[:, None, None]
        jacp = _point_jac(m, d, d.site_xpos[:, ix(sid)], bs)
        jacr = _rot_jac(m, d, bs)
        jacp = jacp - torch.where(rf, _point_jac(m, d, d.site_xpos[:, ix(rid)], br), 0.0)
        jacr = jacr - torch.where(rf, _rot_jac(m, d, br), 0.0)
        fdir = (R * g[..., None, :3]).sum(-1)  # R @ gear[:3]
        tdir = (R * g[..., None, 3:]).sum(-1)
        moments.append(_dot(jacp, fdir[:, :, None, :]) + _dot(jacr, tdir[:, :, None, :]))
        # the refsite's length (0 without one)
        vec = am.mat_t_vec(R, d.site_xpos[:, ix(sid)] - d.site_xpos[:, ix(rid)])
        rot = am.quat_sub(am.mul_quat(m.site_quat[ix(sid)], d.xquat[:, ix(bs)]),
                          am.mul_quat(m.site_quat[ix(rid)], d.xquat[:, ix(br)]))
        lengths.append(torch.where(ix(has_ref), _dot(g[..., :3], vec) + _dot(g[..., 3:], rot), 0.0))
    if len(plan.crank):
        length, dlen = _slidercrank(m, d, plan.crank, plan.crank_slider, plan.crank_site)
        g0 = gear[..., ix(plan.crank), 0]
        lengths.append(g0 * length)
        moments.append(g0[..., None] * dlen)
    if len(plan.body):
        lengths.append(d.qpos.new_zeros((B, len(plan.body))))
        moments.append(_adhesion(m, d, plan.body))
    length, moment = torch.cat(lengths, 1), torch.cat(moments, 1)
    order = np.argsort(np.concatenate(plan.kinds))  # the kinds' actuators back to model order
    if (order == np.arange(len(order))).all():
        return length, moment
    return length[:, ix(order)], moment[:, ix(order)]


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


_EPS_MUSCLE = 1e-10


def muscle_gain_bias(m: Model, length: torch.Tensor, velocity: torch.Tensor, u=None):
    """FLV muscle curves (mju_muscleGain / mju_muscleBias) of actuators `u`
    (all by default; numpy ids) at `length` and `velocity` (..., len(u)):
    returns (gain, bias). biasprm == gainprm for muscles."""
    u = np.arange(m.skel.nu) if u is None else np.asarray(u)
    ux = device_index(u, length.device)
    prm, LR, acc0 = m.actuator_gainprm[..., ux, :], m.actuator_lengthrange[ux], m.actuator_acc0[ux]
    r0, r1, force, scale, lmin, lmax, vmax, fpmax, fvmax = prm[..., :9].unbind(-1)
    force = torch.where(force < 0, scale / torch.clamp(acc0, min=_EPS_MUSCLE), force)
    L0 = (LR[:, 1] - LR[:, 0]) / torch.clamp(r1 - r0, min=_EPS_MUSCLE)
    L = r0 + (length - LR[:, 0]) / torch.clamp(L0, min=_EPS_MUSCLE)
    V = velocity / torch.clamp(L0 * vmax, min=_EPS_MUSCLE)

    def sq(x):
        return x * x

    # active force-length: a piecewise-quadratic bump over [lmin, 1, lmax]
    left, right = 0.5 * (lmin + 1.0), 0.5 * (1.0 + lmax)
    FL = torch.where(
        (L <= lmin) | (L >= lmax), 0.0,
        torch.where(L < left, 0.5 * sq((L - lmin) / torch.clamp(left - lmin, min=_EPS_MUSCLE)),
                    torch.where(L < 1.0, 1.0 - 0.5 * sq((1.0 - L) / torch.clamp(1.0 - left, min=_EPS_MUSCLE)),
                                torch.where(L < right,
                                            1.0 - 0.5 * sq((L - 1.0) / torch.clamp(right - 1.0, min=_EPS_MUSCLE)),
                                            0.5 * sq((lmax - L) / torch.clamp(lmax - right, min=_EPS_MUSCLE))))))
    # force-velocity: parabolic on [-1, 0], saturating at fvmax
    y = fvmax - 1.0
    FV = torch.where(V <= -1.0, 0.0, torch.where(
        V <= 0.0, sq(V + 1.0), torch.where(V <= y, fvmax - sq(y - V) / torch.clamp(y, min=_EPS_MUSCLE), fvmax)))
    # passive force-length: a quadratic ramp to fpmax / 2 at b, linear past it
    b = 0.5 * (1.0 + lmax)
    xb = torch.clamp(b - 1.0, min=_EPS_MUSCLE)
    FP = torch.where(L <= 1.0, 0.0, torch.where(L <= b, 0.5 * fpmax * sq((L - 1.0) / xb),
                                                fpmax * (0.5 + (L - b) / xb)))
    return -force * FL * FV, -force * FP


def muscle_dynamics(m: Model, ctrl: torch.Tensor, act: torch.Tensor, u) -> torch.Tensor:
    """mju_muscleDynamics of actuators `u` (numpy ids; ctrl and act are their
    columns): the activation ODE, whose time constant blends activation and
    deactivation by a quintic smoothstep when tausmooth > 0."""
    prm = m.actuator_dynprm[device_index(np.asarray(u), ctrl.device)]
    tau_act, tau_deact, tsmooth = prm[:, 0], prm[:, 1], prm[:, 2]
    dctrl = torch.clamp(ctrl, 0.0, 1.0) - act
    t1 = tau_act * (0.5 + 1.5 * act)
    t2 = tau_deact / (0.5 + 1.5 * act)
    xs = torch.clamp(dctrl / torch.clamp(tsmooth, min=_EPS_MUSCLE) + 0.5, 0.0, 1.0)
    sig = xs * xs * xs * (xs * (6.0 * xs - 15.0) + 10.0)
    tau = torch.where(tsmooth > 0, t2 + (t1 - t2) * sig, torch.where(dctrl > 0, t1, t2))
    return dctrl / torch.clamp(tau, min=_EPS_MUSCLE)


def clamped_ctrl(m: Model, d: Data) -> torch.Tensor:
    """(B, nu) ctrl clamped to ctrlrange where ctrllimited, unless
    CLAMPCTRL is disabled (JAX smooth.clamped_ctrl)."""
    if m.opt.disableflags & DisableBit.CLAMPCTRL:
        return d.ctrl
    lo, hi = m.actuator_ctrlrange[..., 0], m.actuator_ctrlrange[..., 1]
    return torch.where(device_index(m.skel.actuator_ctrllimited, d.qpos.device), torch.clamp(d.ctrl, lo, hi), d.ctrl)


def fwd_actuation(m: Model, d: Data) -> Data:
    """ctrl -> generalized actuator force, over every transmission
    (`trn_plan`, `_trn_rows`): gain (fixed, affine or muscle) times input
    (ctrl, or the activation where there are dynamics) plus bias (none,
    affine or muscle), act_dot of filter, filterexact, integrator and
    muscle dynamics, the forcerange clamp, disabled actuator groups and the
    joints' actuatorfrcrange clamp. Actuators on hinge and slide joints take
    their dof's qpos and qvel times the gear, with no moment row; a model
    of motors alone keeps the motor arithmetic, gainprm[0] * ctrl, with no
    bias term."""
    s = m.skel
    dev = d.qpos.device
    if s.nu == 0:
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))

    def ix(a):
        return device_index(a, dev)

    ctrl = clamped_ctrl(m, d)
    plan = trn_plan(s)
    ju, dof, qa, ru = plan.joint, plan.joint_dof, plan.joint_qa, plan.rows
    gear = m.actuator_gear[..., 0]
    if len(ru):
        # every other transmission: its length and its moment row
        rlen, rmom = _trn_rows(m, d)  # (B, R), (B, R, nv)
        length = d.qpos.new_zeros((d.qpos.shape[0], s.nu))
        velocity = torch.zeros_like(length)
        length[:, ix(ju)] = d.qpos[:, ix(qa)] * gear[..., ix(ju)]
        velocity[:, ix(ju)] = d.qvel[:, ix(dof)] * gear[..., ix(ju)]
        length[:, ix(ru)] = rlen
        velocity[:, ix(ru)] = (rmom * d.qvel[:, None, :]).sum(-1)
    else:
        length = d.qpos[:, ix(qa)] * gear
        velocity = d.qvel[:, ix(dof)] * gear
    act_dot = d.act_dot
    if _all_motors(s):
        force = m.actuator_gainprm[..., 0] * ctrl
    else:
        gp, bp = m.actuator_gainprm, m.actuator_biasprm
        gaintype, biastype = np.asarray(s.actuator_gaintype), np.asarray(s.actuator_biastype)
        gain = torch.where(
            ix(gaintype == int(GainType.FIXED)), gp[..., 0],
            gp[..., 0] + gp[..., 1] * length + gp[..., 2] * velocity)
        bias = torch.where(
            ix(biastype == int(BiasType.AFFINE)),
            bp[..., 0] + bp[..., 1] * length + bp[..., 2] * velocity, 0.0)
        if (gaintype == int(GainType.MUSCLE)).any():
            # the FLV curves, evaluated on the muscles' columns only (the
            # JAX package evaluates them on every column and selects)
            mu = np.nonzero((gaintype == int(GainType.MUSCLE)) | (biastype == int(BiasType.MUSCLE)))[0]
            mgain, mbias = muscle_gain_bias(m, length[:, ix(mu)], velocity[:, ix(mu)], mu)
            gain, bias = gain.clone(), bias.clone()
            g_m, b_m = gaintype[mu] == int(GainType.MUSCLE), biastype[mu] == int(BiasType.MUSCLE)
            gain[:, ix(mu)] = torch.where(ix(g_m), mgain, gain[:, ix(mu)])
            bias[:, ix(mu)] = torch.where(ix(b_m), mbias, bias[:, ix(mu)])
        inp = ctrl  # the force's input: ctrl, or the activation where there are dynamics
        if s.na:
            # filter / filterexact: act_dot = (ctrl - act) / tau; integrator: ctrl
            dyn_u = dyn_actuators(s)
            dyn = np.asarray(s.actuator_dyntype)[dyn_u]
            is_filter = ix((dyn == int(DynType.FILTER)) | (dyn == int(DynType.FILTEREXACT)))
            tau = torch.clamp(m.actuator_dynprm[ix(dyn_u), 0], min=1e-8)
            u = ix(dyn_u)
            act_dot = torch.where(is_filter, (ctrl[:, u] - d.act) / tau, ctrl[:, u])
            muscle = np.nonzero(dyn == int(DynType.MUSCLE))[0]
            if len(muscle):  # the muscles' activation ODE, on their columns only
                k = ix(muscle)
                act_dot = act_dot.clone()
                act_dot[:, k] = muscle_dynamics(m, ctrl[:, ix(dyn_u[muscle])], d.act[:, k], dyn_u[muscle])
            inp = ctrl.clone()
            inp[:, u] = d.act
        force = gain * inp + bias
    force = torch.where(
        ix(s.actuator_forcelimited),
        torch.clamp(force, m.actuator_forcerange[..., 0], m.actuator_forcerange[..., 1]),
        force,
    )
    if m.opt.disableactuator:
        # <option actuatorgroupdisable>: no force from actuators of disabled
        # groups; their lengths, velocities and activations still advance
        group = np.asarray(s.actuator_group)
        disabled = ((m.opt.disableactuator >> np.clip(group, 0, 30)) & 1).astype(bool) & (group >= 0)
        force = torch.where(ix(disabled), 0.0, force)
    if len(ru):
        qfrc = torch.zeros_like(d.qvel).index_add_(1, ix(dof), gear[..., ix(ju)] * force[:, ix(ju)])
        qfrc = qfrc + (rmom * force[:, ix(ru), None]).sum(1)
    else:
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
    disabled) and joint and tendon springs (unless SPRING is disabled); ball
    and free rotational springs as 0.5 k |quat_sub|^2, as in `passive`, the
    tendons' deadband springs as 0.5 k (length past the range)^2."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device

    def ix(a):
        return device_index(a, dev)

    e = d.qpos.new_zeros(d.qpos.shape[0])
    if not (m.opt.disableflags & DisableBit.GRAVITY):
        e = e - (m.body_mass[..., None] * d.xipos * m.opt.gravity).sum((-2, -1))
    if m.opt.disableflags & DisableBit.SPRING:
        return e
    for jtype_int, jids in sched.jnt_by_type.items():
        jtype = JointType(jtype_int)
        qa = s.jnt_qposadr[jids]
        k = m.jnt_stiffness[..., ix(jids)]
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
    if s.ntendon:
        e = e + (0.5 * m.tendon_stiffness * _ten_deadband(m, d) ** 2).sum(-1)
    return e


def energy_vel(m: Model, d: Data) -> torch.Tensor:
    """(B,) kinetic energy 0.5 qvel' M qvel (mj_energyVel); needs crb."""
    if m.skel.nv == 0:
        return d.qpos.new_zeros(d.qpos.shape[0])
    return 0.5 * (d.qvel * (d.qM * d.qvel[:, None, :]).sum(-1)).sum(-1)


def actuator_moment(m: Model, d: Data) -> torch.Tensor:
    """(B, nu, nv) transmission moment matrix: the gear on a hinge/slide
    joint's dof, every other transmission's row from `_trn_rows` (an
    adhesion row reads d.contact)."""
    s = m.skel
    dev = d.qpos.device
    plan = trn_plan(s)
    moment = d.qpos.new_zeros((d.qpos.shape[0], s.nu, s.nv))
    if len(plan.joint):
        moment[:, device_index(plan.joint, dev), device_index(plan.joint_dof, dev)] = (
            m.actuator_gear[..., device_index(plan.joint, dev), 0])
    if len(plan.rows):
        moment[:, device_index(plan.rows, dev)] = _trn_rows(m, d)[1]
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
    return _com_wrench_to_qfrc(m, d, d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:])


# ---------------------------------------------------------------------------
# tendons


@dataclasses.dataclass(frozen=True)
class _SegGroup:
    """Spatial-tendon segments of one kind: straight, or wrapping a sphere
    or a cylinder geom, with or without a sidesite."""

    gtype: int  # -1 (straight), GeomType.SPHERE or GeomType.CYLINDER
    side: bool  # a sidesite (wraps only)
    site1: np.ndarray  # (G,) the segment's end sites
    site2: np.ndarray
    geom: np.ndarray  # (G,) the wrap geom
    sidesite: np.ndarray  # (G,) its sidesite


@dataclasses.dataclass(frozen=True)
class TendonPlan:
    spatial: np.ndarray  # (T,) the spatial tendons
    groups: tuple
    order: np.ndarray  # (nseg,) segment k's place in the groups' concatenated values
    div: np.ndarray  # (nseg,) each segment's pulley divisor
    segs: np.ndarray  # (T, width) each spatial tendon's segments, padded with nseg (a zero)


def tendon_plan(s) -> TendonPlan:
    """The spatial tendons' segments grouped by kind (cached by skeleton).
    A path is walked as the JAX package walks it (smooth.py:1207-1236): a
    segment joins each site to the site before it, through the geom between
    them if there is one; a pulley starts a new branch with its divisor."""
    key = (s, "tendon")
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]
    spatial = [t for t in range(s.ntendon) if s.tendon_kind[t] == "spatial"]
    segs, per_tendon = [], []  # segment: (kind key, site1, site2, geom, sidesite, div)
    for t in spatial:
        mine, div, prev, pending = [], 1.0, None, None
        for el in s.tendon_path[t]:
            if el[0] == "pulley":
                div, prev, pending = float(el[1]), None, None
            elif el[0] == "geom":
                pending = (int(el[1]), int(el[2]))
            else:
                sid = int(el[1])
                if prev is not None:
                    if pending is None:
                        kind, g, side = (-1, False), -1, -1
                    else:
                        g, side = pending
                        kind = (int(s.geom_type[g]), side >= 0)
                    mine.append(len(segs))
                    segs.append((kind, prev, sid, g, side, div))
                    pending = None
                prev = sid
        per_tendon.append(mine)
    kinds = sorted({seg[0] for seg in segs})
    groups, order = [], np.zeros(len(segs), np.int64)
    start = 0
    for kind in kinds:
        ids = [k for k, seg in enumerate(segs) if seg[0] == kind]
        order[ids] = start + np.arange(len(ids))
        start += len(ids)
        col = [np.asarray([segs[k][i] for k in ids], np.int64) for i in (1, 2, 3, 4)]
        groups.append(_SegGroup(kind[0], kind[1], *col))
    width = max((len(x) for x in per_tendon), default=0)
    padded = np.full((len(spatial), width), len(segs), np.int64)
    for i, x in enumerate(per_tendon):
        padded[i, : len(x)] = x
    plan = TendonPlan(np.asarray(spatial, np.int64), tuple(groups), order,
                      np.asarray([seg[5] for seg in segs], np.float64), padded)
    _PLAN_CACHE[key] = plan
    return plan


def _point_jac(m: Model, d: Data, p: torch.Tensor, body: np.ndarray) -> torch.Tensor:
    """(B, G, nv, 3) translational Jacobians of world points p (B, G, 3)
    fixed to bodies `body` (G,)."""
    s = m.skel
    dev = d.qpos.device
    sup = device_index(_body_dof_support(s)[body], dev, dtype=d.qpos.dtype)  # (G, nv)
    origin = d.subtree_com[:, device_index(np.asarray(s.body_rootid)[s.dof_bodyid], dev)]  # (B, nv, 3)
    r = p[:, :, None, :] - origin[:, None]  # (B, G, nv, 3)
    ang = d.cdof[:, None, :, :3].expand_as(r)  # one op at every G (broadcasting in cross skips it at G = 1)
    return (d.cdof[:, None, :, 3:] + am.cross(ang, r)) * sup[None, :, :, None]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _straight(m: Model, d: Data, p1, b1, p2, b2):
    """Length (B, G) and Jacobian row (B, G, nv) of straight segments p1 -> p2
    between points fixed to bodies b1 and b2."""
    v = p2 - p1
    ln = _norm(v)
    u = v / torch.clamp(ln, min=1e-12)[..., None]
    djac = _point_jac(m, d, p2, b2) - _point_jac(m, d, p1, b1)
    return ln, (djac * u[:, :, None, :]).sum(-1)


def _acos(x: torch.Tensor) -> torch.Tensor:
    """arccos of x clamped to [-1, 1], whose gradient is 0 (not infinite) at
    and past the ends."""
    x = torch.clamp(x, -1.0, 1.0)
    inside = x.abs() < 1.0
    return torch.where(inside, torch.acos(torch.where(inside, x, 0.0)), torch.where(x > 0, 0.0, float(np.pi)))


def _sqrt0(x: torch.Tensor) -> torch.Tensor:
    """sqrt of x >= 0 whose gradient at 0 is 0 (not infinite)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _wrap(m: Model, d: Data, g: _SegGroup):
    """Length and Jacobian row of segments wrapping a sphere or a cylinder
    (mju_wrap; the JAX package's _wrap_seg, smooth.py:1048-1204, batched over
    envs and the group's segments). Both the wrapped path (tangent, arc,
    tangent) and the straight one are computed and selected per env; the
    tangent points are fixed to the geom's body, and the Jacobian is the two
    straight end pieces'. With a sidesite, the long way round when the
    sidesite is across the chord from the center, and a sidesite inside the
    geom bends the segment at one circle point (found by bisection) where
    the straight segment misses the disk."""
    from ambersim_tpu_torch.core.types import GeomType

    s = m.skel
    dev, dt = d.qpos.device, d.qpos.dtype

    def ix(a):
        return device_index(a, dev)

    s1, s2, gid = ix(g.site1), ix(g.site2), ix(g.geom)
    b1, b2 = np.asarray(s.site_bodyid)[g.site1], np.asarray(s.site_bodyid)[g.site2]
    bg = np.asarray(s.geom_bodyid)[g.geom]
    p1, p2 = d.site_xpos[:, s1], d.site_xpos[:, s2]
    R, c = d.geom_xmat[:, gid], d.geom_xpos[:, gid]  # world <- local
    r = m.geom_size[gid, 0]
    a, b = am.mat_t_vec(R, p1 - c), am.mat_t_vec(R, p2 - c)
    cyl = g.gtype == int(GeomType.CYLINDER)
    eps = 1e-12
    zero = torch.zeros_like(a[..., 0])
    if cyl:
        # the circle problem in the plane across the cylinder's axis
        A3 = torch.stack([a[..., 0], a[..., 1], zero], -1)
        B3 = torch.stack([b[..., 0], b[..., 1], zero], -1)
        e1 = A3 / torch.clamp(_norm(A3), min=eps)[..., None]
        perp = am.cross(device_index(np.array([0.0, 0.0, 1.0]), dev, dtype=dt), e1)
        e2 = torch.where(_dot(B3, perp) >= 0, 1.0, -1.0)[..., None] * perp  # B on e2's nonnegative side
        ax, bx, by = _dot(A3, e1), _dot(B3, e1), _dot(B3, e2)
    else:
        # the plane through a, b and the center
        e1 = a / torch.clamp(_norm(a), min=eps)[..., None]
        borth = b - _dot(b, e1)[..., None] * e1
        e2 = borth / torch.clamp(_norm(borth), min=eps)[..., None]
        ax, bx, by = _dot(a, e1), _dot(b, e1), _dot(b, e2)
    la = torch.clamp(torch.sqrt(ax * ax), min=eps)
    lb = torch.clamp(torch.sqrt(bx * bx + by * by), min=eps)
    phi = _acos((ax * bx) / (la * lb))  # [0, pi]

    # the taut path passes on the sidesite's side of the center: a sidesite
    # across the chord from the center forces the long way round
    if g.side:
        ss = am.mat_t_vec(R, d.site_xpos[:, ix(g.sidesite)] - c)
        if cyl:
            ss = torch.stack([ss[..., 0], ss[..., 1], zero], -1)
        sx, sy = _dot(ss, e1), _dot(ss, e2)
        side_inside = torch.sqrt(sx * sx + sy * sy) < r
        cx, cy = bx - ax, by
        nn = torch.clamp(torch.sqrt(cy * cy + cx * cx), min=eps)
        nx, ny = -cy / nn, cx / nn
        h_line, h_side = nx * ax, nx * sx + ny * sy
        sgn = torch.where(h_line * h_side >= 0, 1.0, -1.0)
        big_phi = torch.where(sgn > 0, phi, 2.0 * np.pi - phi)
    else:
        sgn = torch.ones_like(phi)
        big_phi = phi
    alpha_a, alpha_b = _acos(r / la), _acos(r / lb)
    wrapped = (big_phi > alpha_a + alpha_b) & (la > r) & (lb > r)
    arc_ang = torch.clamp(big_phi - alpha_a - alpha_b, min=0.0)
    t1, t2 = sgn * alpha_a, phi - sgn * alpha_b
    az, bz = a[..., 2], b[..., 2]

    def world(p):
        return c + (R * p[..., None, :]).sum(-1)

    def on_circle(x, y, z=None):
        """Local point x e1 + y e2 (+ z along the axis) -> world."""
        p = x[..., None] * e1 + y[..., None] * e2
        if z is not None:
            p = torch.stack([p[..., 0], p[..., 1], p[..., 2] + z], -1)
        return world(p)

    if cyl:
        len_a2 = torch.sqrt(torch.clamp(la * la - r * r, min=eps))
        len_b2 = torch.sqrt(torch.clamp(lb * lb - r * r, min=eps))
        arc2 = r * arc_ang
        tot2 = torch.clamp(len_a2 + arc2 + len_b2, min=eps)
        z1 = az + (bz - az) * len_a2 / tot2
        z2 = az + (bz - az) * (len_a2 + arc2) / tot2
        T1w = on_circle(r * torch.cos(t1), r * torch.sin(t1), z1)
        T2w = on_circle(r * torch.cos(t2), r * torch.sin(t2), z2)
        L_wrap = (_sqrt0(len_a2 * len_a2 + (z1 - az) ** 2) + _sqrt0(arc2 * arc2 + (z2 - z1) ** 2)
                  + _sqrt0(len_b2 * len_b2 + (bz - z2) ** 2))
    else:
        T1w = world(r[..., None] * (torch.cos(t1)[..., None] * e1 + torch.sin(t1)[..., None] * e2))
        T2w = world(r[..., None] * (torch.cos(t2)[..., None] * e1 + torch.sin(t2)[..., None] * e2))
        L_wrap = (torch.sqrt(torch.clamp(la * la - r * r, min=eps)) + r * arc_ang
                  + torch.sqrt(torch.clamp(lb * lb - r * r, min=eps)))
    _, j1 = _straight(m, d, p1, b1, T1w, bg)
    _, j2 = _straight(m, d, T2w, bg, p2, b2)
    L_str, J_str = _straight(m, d, p1, b1, p2, b2)
    if not g.side:
        return torch.where(wrapped, L_wrap, L_str), torch.where(wrapped[..., None], j1 + j2, J_str)

    # interior wrap (a sidesite inside the geom): where the straight segment
    # misses the disk, the tendon bends at the circle point of least total
    # length, by bisection on the reflection condition over [0, phi]
    bvx, bvy = lb * torch.cos(phi), lb * torch.sin(phi)

    def h(theta):
        tx, ty = r * torch.cos(theta), r * torch.sin(theta)
        n1 = torch.clamp(torch.sqrt((tx - la) ** 2 + ty * ty), min=eps)
        n2 = torch.clamp(torch.sqrt((tx - bvx) ** 2 + (ty - bvy) ** 2), min=eps)
        ux, uy = (tx - la) / n1 + (tx - bvx) / n2, ty / n1 + (ty - bvy) / n2
        return -torch.sin(theta) * ux + torch.cos(theta) * uy

    lo_t, hi_t = torch.zeros_like(phi), phi
    h_lo = h(lo_t)
    for _ in range(30):
        mid_t = 0.5 * (lo_t + hi_t)
        h_mid = h(mid_t)
        same = h_mid * h_lo > 0
        lo_t = torch.where(same, mid_t, lo_t)
        h_lo = torch.where(same, h_mid, h_lo)
        hi_t = torch.where(same, hi_t, mid_t)
    theta_b = 0.5 * (lo_t + hi_t)
    tbx, tby = r * torch.cos(theta_b), r * torch.sin(theta_b)
    if cyl:
        lenA2 = torch.sqrt((tbx - la) ** 2 + tby * tby)
        lenB2 = torch.sqrt((tbx - bvx) ** 2 + (tby - bvy) ** 2)
        Tbw = on_circle(tbx, tby, az + (bz - az) * lenA2 / torch.clamp(lenA2 + lenB2, min=eps))
    else:
        Tbw = on_circle(tbx, tby)
    lb1, jb1 = _straight(m, d, p1, b1, Tbw, bg)
    lb2, jb2 = _straight(m, d, Tbw, bg, p2, b2)
    bend = side_inside & (phi <= alpha_a + alpha_b) & (la > r) & (lb > r)
    wrapped = wrapped & ~side_inside
    L = torch.where(wrapped, L_wrap, torch.where(bend, lb1 + lb2, L_str))
    J = torch.where(wrapped[..., None], j1 + j2, torch.where(bend[..., None], jb1 + jb2, J_str))
    return L, J


def tendon(m: Model, d: Data) -> Data:
    """Tendon lengths and Jacobians. Fixed tendons are linear in qpos with
    the compile-time Jacobian; spatial tendons run their segments' geometry,
    one batch per segment kind (`tendon_plan`), each segment divided by its
    branch's pulley divisor and summed over its tendon."""
    s = m.skel
    if s.ntendon == 0:
        return d
    dev = d.qpos.device
    B = d.qpos.shape[0]
    ten_length = (m.tendon_Jq * d.qpos[:, None, :]).sum(-1)
    ten_J = m.tendon_J.expand(B, -1, -1)
    plan = tendon_plan(s)
    if len(plan.spatial):
        Ls, Js = [], []
        for g in plan.groups:
            if g.gtype < 0:
                p1, p2 = d.site_xpos[:, device_index(g.site1, dev)], d.site_xpos[:, device_index(g.site2, dev)]
                L, J = _straight(m, d, p1, np.asarray(s.site_bodyid)[g.site1], p2,
                                 np.asarray(s.site_bodyid)[g.site2])
            else:
                L, J = _wrap(m, d, g)
            Ls.append(L)
            Js.append(J)
        order = device_index(plan.order, dev)
        div = device_index(plan.div, dev, dtype=d.qpos.dtype)
        L = torch.cat(Ls, 1)[:, order] / div
        J = torch.cat(Js, 1)[:, order] / div[:, None]
        segs, sp = device_index(plan.segs, dev), device_index(plan.spatial, dev)
        L = torch.cat([L, L.new_zeros((B, 1))], 1)[:, segs].sum(-1)
        J = torch.cat([J, J.new_zeros((B, 1, s.nv))], 1)[:, segs].sum(-2)
        ten_length, ten_J = ten_length.clone(), ten_J.clone()
        ten_length[:, sp] = L
        ten_J[:, sp] = J
    return d.replace(ten_length=ten_length, ten_J=ten_J)


def fwd_position_smooth(m: Model, d: Data) -> Data:
    d = kinematics(m, d)
    d = com_pos(m, d)
    if m.skel.ncam or m.skel.nlight:
        d = camlight(m, d)
    d = tendon(m, d)
    d = crb(m, d)
    return factor_m(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
    if m.skel.ntendon:
        d = d.replace(ten_velocity=(d.ten_J * d.qvel[:, None, :]).sum(-1))
    d = com_vel(m, d)
    d = passive(m, d)
    return rne(m, d)


def fwd_acceleration(m: Model, d: Data) -> Data:
    qfrc_smooth = d.qfrc_passive + d.qfrc_actuator + d.qfrc_applied + xfrc_accumulate(m, d) - d.qfrc_bias
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=solve_m(m, d, qfrc_smooth))
