"""Sensor evaluation: the position, velocity and acceleration stages and the
post-constraint accelerations (port of ambersim_tpu/engine/sensor.py).

As in the JAX package all three stages run once, at the end of `forward`,
after qacc and efc_force are known: sensordata never feeds back into the
dynamics. The JAX package unrolls one branch per sensor at trace time; an
eager port would pay host dispatch for each. So a per-skeleton plan
(`sensor_plan`, built once on the host and cached) groups the sensors of
one type and one attachment kind (object and reference types, a site's
shape, a contact sensor's data, reduction and count) into index arrays,
and each group is a few batched gathers whatever its size: the stage
issues a number of device ops set by the types and kinds present, not by
the number of sensors. The shared intermediates (cacc, the contact forces
and wrenches, cfrc_int, subtree momentum) are computed once a call and
only when a present type needs them.

Every function takes a Model and a batch-first Data. CAMPROJECTION reads
the camera frames of `smooth.camlight`; the rangefinder casts one
`engine.ray.ray` a sensor; the tendon limit sensors read the tendon's
limit row, as the joint limit sensors read the joint's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import (ConeType, Data, DisableBit, JointType, Model, ObjType, SensorType, SiteType,
                                           TrnType)
from ambersim_tpu_torch.engine.schedule import device_index, tree_schedule

# geom-distance trio: the cutoff is the search range, not an output clamp
_GEOMPAIR = {SensorType.GEOMDIST, SensorType.GEOMNORMAL, SensorType.GEOMFROMTO}
# the acceleration stage (mj_sensorAcc), whose values derive from qacc and
# efc_force, and the contact sensor
ACC_STAGE = {
    SensorType.TOUCH, SensorType.ACCELEROMETER, SensorType.FORCE, SensorType.TORQUE, SensorType.ACTUATORFRC,
    SensorType.JOINTACTFRC, SensorType.TENDONACTFRC, SensorType.JOINTLIMITFRC, SensorType.TENDONLIMITFRC,
    SensorType.FRAMELINACC, SensorType.FRAMEANGACC, SensorType.CONTACT,
}
# the velocity stage (mj_sensorVel); every other type is the position stage's
VEL_STAGE = {
    SensorType.VELOCIMETER, SensorType.GYRO, SensorType.JOINTVEL, SensorType.TENDONVEL, SensorType.ACTUATORVEL,
    SensorType.BALLANGVEL, SensorType.JOINTLIMITVEL, SensorType.TENDONLIMITVEL, SensorType.FRAMELINVEL,
    SensorType.FRAMEANGVEL, SensorType.SUBTREELINVEL, SensorType.SUBTREEANGMOM, SensorType.E_KINETIC,
}
# the lazy intermediates and the types that read them
_NEEDS_CACC = {SensorType.ACCELEROMETER, SensorType.FORCE, SensorType.TORQUE, SensorType.FRAMELINACC,
               SensorType.FRAMEANGACC}
_NEEDS_CON_FORCES = {SensorType.TOUCH, SensorType.FORCE, SensorType.TORQUE}
_FRAME = {SensorType.FRAMEPOS, SensorType.FRAMEQUAT, SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS,
          SensorType.FRAMEZAXIS, SensorType.FRAMELINVEL, SensorType.FRAMEANGVEL, SensorType.FRAMELINACC,
          SensorType.FRAMEANGACC}
_PER_SENSOR_KIND = _GEOMPAIR | {SensorType.CONTACT, SensorType.USER, SensorType.RANGEFINDER}
# the cutoff clamps every type's values but these
_UNCLIPPED = _GEOMPAIR | {SensorType.CONTACT, SensorType.USER}
_LIMIT = {SensorType.JOINTLIMITPOS, SensorType.JOINTLIMITVEL, SensorType.JOINTLIMITFRC,
          SensorType.TENDONLIMITPOS, SensorType.TENDONLIMITVEL, SensorType.TENDONLIMITFRC}
_LIMIT_POS = {SensorType.JOINTLIMITPOS, SensorType.TENDONLIMITPOS}
_LIMIT_VEL = {SensorType.JOINTLIMITVEL, SensorType.TENDONLIMITVEL}
# <contact> sensor data fields in their required order: (name, bit, width)
_CONTACT_FIELDS = (("found", 1, 1), ("force", 2, 3), ("torque", 4, 3), ("dist", 8, 1), ("pos", 16, 3),
                   ("normal", 32, 3), ("tangent", 64, 3))


# ---------------------------------------------------------------------------
# the plan


@dataclasses.dataclass(frozen=True)
class _Group:
    """Sensors of one type and one attachment kind, in model order."""

    stype: SensorType
    objtype: int
    reftype: int  # -1 without a reference frame
    kind: tuple  # a site's shape (touch, insidesite, a contact sensor's site), a contact sensor's intprm
    ids: np.ndarray  # (G,) sensor ids
    objid: np.ndarray
    refid: np.ndarray
    dim: int  # columns a sensor (USER sensors: the group's columns)


@dataclasses.dataclass(frozen=True)
class SensorPlan:
    groups: tuple
    present: frozenset
    inv: np.ndarray  # sensordata column -> its place in the groups' concatenated values
    col_sensor: np.ndarray  # the sensor of each concatenated value
    clip: np.ndarray  # bool: the cutoff clamps this value (not the geom-distance trio, contact, user)
    positive: np.ndarray  # bool: the clamp's lower end is 0 (touch), else -cutoff


_PLANS: dict = {}


def sensor_plan(s) -> SensorPlan:
    """The skeleton's sensor groups and the column map that writes their
    values into sensordata; cached by skeleton."""
    plan = _PLANS.get(s)
    if plan is not None:
        return plan
    types = np.asarray(s.sensor_type)
    objtype, objid = np.asarray(s.sensor_objtype), np.asarray(s.sensor_objid)
    reftype, refid = np.asarray(s.sensor_reftype), np.asarray(s.sensor_refid)
    intprm = np.asarray(s.sensor_intprm).reshape(s.nsensor, -1)
    site_type = np.asarray(s.site_type)
    members: dict = {}
    for i in range(s.nsensor):
        st = SensorType(int(types[i]))
        rt = int(reftype[i]) if int(refid[i]) >= 0 else -1
        kind: tuple = ()
        if st == SensorType.TOUCH:
            kind = (int(site_type[objid[i]]),)
        elif st == SensorType.INSIDESITE:
            kind = (int(site_type[refid[i]]),)
        elif st == SensorType.CONTACT:
            site = int(site_type[objid[i]]) if int(objtype[i]) == int(ObjType.SITE) else -1
            kind = (int(intprm[i, 0]), int(intprm[i, 1]), int(intprm[i, 2]), site)
        elif st == SensorType.USER:
            kind = (int(s.sensor_dim[i]),)
        if st in _PER_SENSOR_KIND:  # the kind is looked up a sensor inside the group
            key = (int(st), -1, -1, kind)
        else:
            key = (int(st), int(objtype[i]), rt, kind)
        members.setdefault(key, []).append(i)
    groups, cols, col_sensor = [], [], []
    adr, dims = np.asarray(s.sensor_adr), np.asarray(s.sensor_dim)
    for (st, ot, rt, kind), ids in members.items():
        ids = np.asarray(ids)
        groups.append(_Group(SensorType(st), int(objtype[ids[0]]) if ot >= 0 else ot, rt, kind, ids, objid[ids],
                             refid[ids], int(dims[ids[0]])))
        for i in ids:
            cols.extend(range(int(adr[i]), int(adr[i] + dims[i])))
            col_sensor.extend([i] * int(dims[i]))
    cols, col_sensor = np.asarray(cols, np.int64), np.asarray(col_sensor, np.int64)
    assert sorted(cols.tolist()) == list(range(s.nsensordata)), "sensors must cover sensordata"
    ctypes = types[col_sensor]
    plan = SensorPlan(
        groups=tuple(groups),
        present=frozenset(SensorType(int(t)) for t in types),
        inv=np.argsort(cols),
        col_sensor=col_sensor,
        clip=~np.isin(ctypes, [int(t) for t in _UNCLIPPED]),
        positive=ctypes == int(SensorType.TOUCH),
    )
    _PLANS[s] = plan
    return plan


# ---------------------------------------------------------------------------
# frames, velocities and accelerations of attachment objects (G objects)


def _ix(a, dev):
    return device_index(np.asarray(a), dev)


_tmul = am.mat_t_vec


def _object_pos_mat(m: Model, d: Data, objtype: int, ids):
    """World (pos (B, G, 3), mat (B, G, 3, 3)) of attachment objects."""
    t = ObjType(objtype)
    ix = _ix(ids, d.qpos.device)
    if t == ObjType.BODY:  # the inertial frame
        return d.xipos[:, ix], d.ximat[:, ix]
    if t == ObjType.XBODY:  # the body frame
        return d.xpos[:, ix], am.quat_to_mat(d.xquat[:, ix])
    if t == ObjType.GEOM:
        return d.geom_xpos[:, ix], d.geom_xmat[:, ix]
    if t == ObjType.SITE:
        return d.site_xpos[:, ix], d.site_xmat[:, ix]
    raise NotImplementedError(f"sensor objtype {t}")


def _object_bodyid(s, objtype: int, ids) -> np.ndarray:
    t = ObjType(objtype)
    ids = np.asarray(ids)
    if t in (ObjType.BODY, ObjType.XBODY):
        return ids
    if t == ObjType.GEOM:
        return np.asarray(s.geom_bodyid)[ids]
    if t == ObjType.SITE:
        return np.asarray(s.site_bodyid)[ids]
    raise NotImplementedError(f"sensor objtype {t}")


def _object_quat(m: Model, d: Data, objtype: int, ids) -> torch.Tensor:
    """World orientation (B, G, 4), composed from the body's quaternion."""
    s, dev = m.skel, d.qpos.device
    t = ObjType(objtype)
    ix = _ix(ids, dev)
    if t == ObjType.XBODY:
        return d.xquat[:, ix]
    if t == ObjType.BODY:
        return am.mul_quat(d.xquat[:, ix], m.body_iquat[ix])
    if t == ObjType.GEOM:
        return am.mul_quat(d.xquat[:, _ix(np.asarray(s.geom_bodyid)[ids], dev)], m.geom_quat[ix])
    return am.mul_quat(d.xquat[:, _ix(np.asarray(s.site_bodyid)[ids], dev)], m.site_quat[ix])


def _point_vel(m: Model, d: Data, bodyid, pos):
    """World (angvel, linvel) of body-fixed world points (cf. mj_objectVelocity)."""
    dev = d.qpos.device
    origin = d.subtree_com[:, _ix(np.asarray(m.skel.body_rootid)[bodyid], dev)]
    cvel = d.cvel[:, _ix(bodyid, dev)]
    ang = cvel[..., :3]
    return ang, cvel[..., 3:] + am.cross(ang, pos - origin)


def _point_acc(m: Model, d: Data, bodyid, pos):
    """World (angacc, linacc) of body-fixed points from the post-constraint
    cacc, with the rotating-frame term (cf. mj_objectAcceleration)."""
    dev = d.qpos.device
    origin = d.subtree_com[:, _ix(np.asarray(m.skel.body_rootid)[bodyid], dev)]
    r = pos - origin
    b = _ix(bodyid, dev)
    ang_v = d.cvel[:, b, :3]
    lin_v = d.cvel[:, b, 3:] + am.cross(ang_v, r)
    ang_a = d.cacc[:, b, :3]
    return ang_a, d.cacc[:, b, 3:] + am.cross(ang_a, r) + am.cross(ang_v, lin_v)


def rne_postconstraint(m: Model, d: Data) -> Data:
    """Post-constraint spatial accelerations cacc (the forward pass of
    mj_rnePostConstraint: gravity offset at the root, the full qacc), level
    by level as `smooth.com_vel`."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    gscale = 0.0 if m.opt.disableflags & DisableBit.GRAVITY else 1.0
    cacc = d.qpos.new_zeros((d.qpos.shape[0], s.nbody, 6))
    cacc[:, 0, 3:] = -gscale * m.opt.gravity
    for level in sched.levels:
        for sig, ids, parents, jnt_slots in level:
            a = cacc[:, _ix(parents, dev)]
            for slot, jtype_int in enumerate(sig):
                w = JointType(jtype_int).dof_width
                idx = _ix(np.asarray(s.jnt_dofadr)[jnt_slots[slot]][:, None] + np.arange(w), dev)
                a = a + (d.cdof_dot[:, idx] * d.qvel[:, idx][..., None]).sum(-2)
                a = a + (d.cdof[:, idx] * d.qacc[:, idx][..., None]).sum(-2)
            cacc[:, _ix(ids, dev)] = a
    return d.replace(cacc=cacc)


# ---------------------------------------------------------------------------
# contact forces


def _contact_wrench(m: Model, d: Data) -> torch.Tensor:
    """(B, ncon, 6) contact-frame wrench (fn, ft1, ft2, tn, tt1, tt2) on each
    slot's geom2 from efc_force (mj_contactForce), zero where the slot's
    first row is inactive. Pyramidal rows are n +/- mu_i t_i facets:
    normal = the facets' sum, tangent i = mu_i (f_2i - f_2i+1); elliptic
    rows are the cone's axes. The slots of one condim are one gather."""
    s = m.skel
    dev = d.qpos.device
    elliptic = m.opt.cone == int(ConeType.ELLIPTIC)
    B = d.qpos.shape[0]
    con_dim = np.asarray(s.con_dim)[: s.ncon]
    con_adr = np.asarray(s.con_efcadr)[: s.ncon]
    parts, order = [], []
    for cdim in sorted(set(con_dim.tolist())):
        slots = np.nonzero(con_dim == cdim)[0]
        adr = con_adr[slots]
        zero = d.qpos.new_zeros((B, len(slots)))
        if cdim == 1:
            cols = [d.efc_force[:, _ix(adr, dev)]]
        elif elliptic:
            f = d.efc_force[:, _ix(adr[:, None] + np.arange(cdim), dev)]
            cols = list(f.unbind(-1))
        else:
            f = d.efc_force[:, _ix(adr[:, None] + np.arange(2 * (cdim - 1)), dev)]
            mu = d.contact.friction[:, _ix(slots, dev)]
            cols = [f.sum(-1)] + [mu[..., i] * (f[..., 2 * i] - f[..., 2 * i + 1]) for i in range(cdim - 1)]
        w = torch.stack(cols + [zero] * (6 - len(cols)), -1)
        active = d.efc_active[:, _ix(adr, dev)]
        parts.append(torch.where(active[..., None], w, 0.0))
        order.append(slots)
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, 1)[:, _ix(np.argsort(np.concatenate(order)), dev)]


def _contact_forces_world(wrench: torch.Tensor, d: Data):
    """Per slot (normal force (B, ncon), world force on geom2 (B, ncon, 3))."""
    frame = d.contact.frame
    fw = frame[..., 0, :] * wrench[..., 0:1] + frame[..., 1, :] * wrench[..., 1:2] + frame[..., 2, :] * wrench[..., 2:3]
    return wrench[..., 0], fw


def _cfrc_int(m: Model, d: Data, con_force: torch.Tensor) -> torch.Tensor:
    """(B, nbody, 6) interaction force each body receives through its parent
    joint (the backward pass of mj_rnePostConstraint): gravity through the
    root's cacc offset, the contact forces, xfrc_applied."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    origin_all = d.subtree_com[:, _ix(s.body_rootid, dev)]
    iv = (d.cinert * d.cvel[..., None, :]).sum(-1)
    frc = (d.cinert * d.cacc[..., None, :]).sum(-1) + am.force_cross(d.cvel, iv)
    xang = d.xfrc_applied[..., 3:] + am.cross(d.xipos - origin_all, d.xfrc_applied[..., :3])
    frc = frc - torch.cat([xang, d.xfrc_applied[..., :3]], -1)
    # the force on geom2's body is +fw at the contact point, on geom1's -fw
    bodyid = _ix(s.geom_bodyid, dev)
    for sgn, geom in ((1.0, d.contact.geom2), (-1.0, d.contact.geom1)):
        bid = bodyid[geom.long()]  # (B, ncon)
        f_lin = sgn * con_force
        ang = am.cross(d.contact.pos - torch.take_along_dim(origin_all, bid[..., None], dim=1), f_lin)
        frc = frc.scatter_add(1, bid[..., None].expand(-1, -1, 6), -torch.cat([ang, f_lin], -1))
    frc[:, 0] = 0.0
    for child_ids, parent_ids in sched.reverse_levels:
        frc.index_add_(1, _ix(parent_ids, dev), frc[:, _ix(child_ids, dev)])
    return frc


def _inside_site(m: Model, d: Data, site_ids, site_type: int, point: torch.Tensor) -> torch.Tensor:
    """(B, G, N) bool: world points `point` (B, 1 or G, N, 3) inside the
    volumes of the G sites `site_ids`, all of shape `site_type`."""
    dev = d.qpos.device
    ix = _ix(site_ids, dev)
    size = m.site_size[ix][:, None, :]  # (G, 1, 3)
    local = _tmul(d.site_xmat[:, ix, None], point - d.site_xpos[:, ix, None])  # (B, G, N, 3)
    x, y, z = local.unbind(-1)
    st = SiteType(site_type)
    if st == SiteType.SPHERE:
        return (local**2).sum(-1) <= size[..., 0] ** 2
    if st == SiteType.CAPSULE:
        zc = torch.clamp(z, -size[..., 1], size[..., 1])
        return x**2 + y**2 + (z - zc) ** 2 <= size[..., 0] ** 2
    if st == SiteType.CYLINDER:
        return (x**2 + y**2 <= size[..., 0] ** 2) & (z.abs() <= size[..., 1])
    if st == SiteType.ELLIPSOID:
        return ((local / torch.clamp(size, min=1e-12)) ** 2).sum(-1) <= 1.0
    return (local.abs() <= size).all(-1)  # BOX


def _subtree_momentum(m: Model, d: Data, angmom: bool):
    """Per body (subtree com linvel (B, nbody, 3), angular momentum about
    the subtree com or None), mirroring mj_subtreeVel."""
    s = m.skel
    sched = tree_schedule(s)
    dev = d.qpos.device
    origin = d.subtree_com[:, _ix(s.body_rootid, dev)]
    ang = d.cvel[..., :3]
    lin = d.cvel[..., 3:] + am.cross(ang, d.xipos - origin)  # body com velocity
    mom = m.body_mass[..., None] * lin  # body_mass may carry an env axis
    mass_acc = m.body_mass.clone()
    mom_acc = mom.clone()
    for child_ids, parent_ids in sched.reverse_levels:
        ct, pt = _ix(child_ids, dev), _ix(parent_ids, dev)
        mass_acc.index_add_(-1, pt, mass_acc[..., ct])
        mom_acc.index_add_(1, pt, mom_acc[:, ct])
    linvel = mom_acc / torch.clamp(mass_acc, min=1e-12)[..., None]
    if not angmom:
        return linvel, None
    # world rotational inertia of each body, then the parallel-axis shifts
    # level by level
    R = d.ximat
    inertia = ((R * m.body_inertia[..., None, :])[..., :, None, :] * R[..., None, :, :]).sum(-1)  # R diag(I) R^T
    am_acc = (inertia * ang[..., None, :]).sum(-1) + am.cross(d.xipos - d.subtree_com, mom)
    body_mom = mom.clone()
    for child_ids, parent_ids in sched.reverse_levels:
        ct, pt = _ix(child_ids, dev), _ix(parent_ids, dev)
        shift = am.cross(d.subtree_com[:, ct] - d.subtree_com[:, pt], body_mom[:, ct])
        am_acc.index_add_(1, pt, am_acc[:, ct] + shift)
        body_mom.index_add_(1, pt, body_mom[:, ct])
    return linvel, am_acc


def _limit_rows(s, ids, tendon: bool = False) -> np.ndarray:
    """efc row of each joint's (or tendon's) limit row, or -1 (static
    layout: the tendon limit rows follow the joint limit rows)."""
    limit_ids = np.asarray(s.limit_tenid if tendon else s.limit_jntid)
    first = s.ne + s.nf + (len(s.limit_jntid) if tendon else 0)
    rows = []
    for j in np.asarray(ids):
        where = np.nonzero(limit_ids == j)[0]
        rows.append(int(first + where[0]) if len(where) else -1)
    return np.asarray(rows, np.int64)


# ---------------------------------------------------------------------------
# the groups


def _contact_group(m: Model, d: Data, g: _Group, wrench: torch.Tensor) -> torch.Tensor:
    """mjSENS_CONTACT for G sensors of one data spec, reduction and count:
    match contact slots by the side criteria, reduce, and write `num` slots
    of the selected fields, (B, G, dim). In-order matches report the stored
    contact-frame wrench (on the second matched side), normal = frame n,
    tangent = frame t1; a swapped match negates the third wrench components
    and the normal and tangent. netforce sums the world wrenches on the
    second side about the |F|-weighted centroid of the matched contacts."""
    s = m.skel
    dev = d.qpos.device
    B = d.qpos.shape[0]
    dataspec, reduce_, num, _site = g.kind
    sel_fields = [(n, w) for n, b, w in _CONTACT_FIELDS if dataspec & b]
    if s.ncon == 0:
        return d.qpos.new_zeros((B, len(g.ids), g.dim))

    def side_masks(types, ids) -> np.ndarray:
        out = np.zeros((len(ids), s.ngeom), bool)
        bodyid = np.asarray(s.geom_bodyid)
        for k, (t, i) in enumerate(zip(types, ids)):
            t = ObjType(int(t))
            if t in (ObjType.UNKNOWN, ObjType.SITE):
                out[k] = True  # any geom (a site filters by position)
            elif t == ObjType.GEOM:
                out[k, i] = True
            elif t == ObjType.BODY:
                out[k] = bodyid == i
            elif t == ObjType.XBODY:  # the subtree of body i (parents precede children)
                sub = np.zeros(s.nbody, bool)
                sub[i] = True
                for b in range(i + 1, s.nbody):
                    sub[b] |= sub[s.body_parentid[b]]
                out[k] = sub[bodyid]
            else:
                raise NotImplementedError(f"contact sensor criterion objtype {t}")
        return out

    objtype = np.asarray(s.sensor_objtype)[g.ids]
    m1 = _ix(side_masks(objtype, g.objid), dev)  # (G, ngeom)
    m2 = _ix(side_masks(np.asarray(s.sensor_reftype)[g.ids], g.refid), dev)
    g1, g2 = d.contact.geom1.long(), d.contact.geom2.long()  # (B, ncon)
    inorder = m1[:, g1] & m2[:, g2]  # (G, B, ncon)
    swapped = m1[:, g2] & m2[:, g1] & ~inorder
    inorder, swapped = inorder.transpose(0, 1), swapped.transpose(0, 1)  # (B, G, ncon)
    active = d.efc_active[:, _ix(np.asarray(s.con_efcadr)[: s.ncon], dev)]
    matched = (inorder | swapped) & active[:, None, :]
    if _site >= 0:
        matched = matched & _inside_site(m, d, g.objid, _site, d.contact.pos[:, None])
    sigma = torch.where(swapped, -1.0, 1.0)  # (B, G, ncon)
    maskf = matched.to(d.qpos.dtype)
    found = maskf.sum(-1)  # (B, G)
    frame = d.contact.frame[:, None]  # (B, 1, ncon, 3, 3)

    def third():
        return torch.stack([torch.ones_like(sigma), torch.ones_like(sigma), sigma], -1)

    # each field of every slot (B, G, ncon, width), computed only when selected
    per_slot = {
        "force": lambda: wrench[:, None, :, :3] * third(),
        "torque": lambda: wrench[:, None, :, 3:] * third(),
        "dist": lambda: d.contact.dist[:, None, :, None].expand(-1, len(g.ids), -1, -1),
        "pos": lambda: d.contact.pos[:, None].expand(-1, len(g.ids), -1, -1),
        "normal": lambda: sigma[..., None] * frame[..., 0, :],
        "tangent": lambda: sigma[..., None] * frame[..., 1, :],
    }
    names = [n for n, _ in sel_fields if n != "found"]
    slot_ids = torch.arange(num, device=dev)

    def assemble(rows: dict, found_col) -> torch.Tensor:
        parts = [found_col[..., None] if n == "found" else rows[n] for n, _ in sel_fields]
        return torch.cat(parts, -1).reshape(B, len(g.ids), -1)

    if reduce_ == 0:  # none: the first `num` matched slots in slot order
        rank = torch.cumsum(maskf, -1)  # (B, G, ncon)
        hit = matched[..., None, :] & (rank[..., None, :] == (slot_ids + 1).to(rank.dtype)[:, None])  # (B, G, num, ncon)
        which = hit.to(d.qpos.dtype).argmax(-1)  # the slot each row reads (0 where none)
        keep = hit.any(-1)[..., None]
        rows = {n: torch.where(keep, torch.take_along_dim(per_slot[n](), which[..., None], dim=2), 0.0)
                for n in names}
        return assemble(rows, found[..., None] * (found[..., None] > slot_ids))
    first = (slot_ids == 0)[:, None]  # (num, 1): the winner's row
    nonzero = (found > 0)[..., None, None]
    if reduce_ in (1, 2):  # mindist / maxforce: one winner in row 0
        if reduce_ == 1:
            win = torch.where(matched, d.contact.dist[:, None], 1e30).argmin(-1)
        else:
            win = torch.where(matched, wrench[:, None, :, 0], -1e30).argmax(-1)
        rows = {n: torch.where(first & nonzero, torch.take_along_dim(per_slot[n](), win[..., None, None], dim=2),
                               0.0) for n in names}
        return assemble(rows, found[..., None] * first[:, 0])
    # netforce
    wr = wrench[:, None]
    Fw = maskf[..., None] * sigma[..., None] * (wr[..., :3, None] * frame).sum(-2)

    def ref():  # the |F|-weighted centroid
        wts = torch.linalg.vector_norm(Fw, dim=-1)  # (B, G, ncon)
        return (wts[..., None] * d.contact.pos[:, None]).sum(-2) / torch.clamp(wts.sum(-1), min=1e-15)[..., None]

    def torque():
        Tw = maskf[..., None] * sigma[..., None] * (wr[..., 3:, None] * frame).sum(-2)
        return (am.cross(d.contact.pos[:, None] - ref()[..., None, :], Fw) + Tw).sum(-2)

    total = {
        "force": lambda: Fw.sum(-2),
        "torque": torque,
        "dist": lambda: d.qpos.new_zeros((B, len(g.ids), 1)),
        "pos": lambda: ref() * nonzero[..., 0],
        "normal": lambda: _ix(np.array([1.0, 0.0, 0.0], np.float32), dev) * nonzero[..., 0],
        "tangent": lambda: _ix(np.array([0.0, 1.0, 0.0], np.float32), dev) * nonzero[..., 0],
    }
    rows = {n: torch.where(first, total[n]()[..., None, :], 0.0) for n in names}
    return assemble(rows, found[..., None] * first[:, 0])


def _geompair_group(m: Model, d: Data, g: _Group) -> torch.Tensor:
    """<distance>, <normal>, <fromto> (B, G, dim): the least surface
    distance over a sensor's geom pairs (one pair, or every cross pair of
    two bodies' geoms), the first pair on ties, with the cutoff as the
    search range: past it (cutoff, 0, 0)."""
    from ambersim_tpu_torch.engine.collision import geom_pair_distance

    s = m.skel
    dev = d.qpos.device
    B = d.qpos.shape[0]
    pairs = []
    for ot, a, b in zip(np.asarray(s.sensor_objtype)[g.ids], g.objid, g.refid):
        if int(ot) == int(ObjType.GEOM):
            pairs.append([(int(a), int(b))])
        else:  # two bodies' geoms
            ga = range(int(s.body_geomadr[a]), int(s.body_geomadr[a]) + int(s.body_geomnum[a]))
            gb = range(int(s.body_geomadr[b]), int(s.body_geomadr[b]) + int(s.body_geomnum[b]))
            pairs.append([(i, j) for i in ga for j in gb])
    flat = [p for ps in pairs for p in ps]
    if not flat:
        return d.qpos.new_zeros((B, len(g.ids), g.dim))
    di, p1, p2 = geom_pair_distance(m, d, np.array([p[0] for p in flat]), np.array([p[1] for p in flat]))
    width = max(len(ps) for ps in pairs)
    pad = len(flat)  # an extra pair at +inf for sensors with fewer pairs
    idx, start = np.full((len(pairs), width), pad), 0
    for k, ps in enumerate(pairs):
        idx[k, : len(ps)] = start + np.arange(len(ps))
        start += len(ps)
    di = torch.cat([di, di.new_full((B, 1), float("inf"))], 1)
    cand = _ix(idx, dev)  # (G, width)
    k = di[:, cand].argmin(-1)  # (B, G): the first least pair of each sensor
    best = torch.clamp(torch.take_along_dim(cand[None], k[..., None], dim=-1)[..., 0], max=pad - 1)
    dist = torch.take_along_dim(di, best, dim=1)
    p1, p2 = (torch.take_along_dim(p, best[..., None], dim=1) for p in (p1, p2))
    cutoff = m.sensor_cutoff[_ix(g.ids, dev)]
    empty = _ix(np.array([not ps for ps in pairs]), dev)[:, None]
    if g.stype == SensorType.GEOMDIST:
        out = torch.minimum(dist, cutoff)[..., None]
    elif g.stype == SensorType.GEOMNORMAL:
        n = p2 - p1
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-15)
        out = torch.where((dist < cutoff)[..., None], n, 0.0)
    else:
        out = torch.where((dist < cutoff)[..., None], torch.cat([p1, p2], -1), 0.0)
    return torch.where(empty, 0.0, out)


def _eval_group(m: Model, d: Data, g: _Group, lazy: dict) -> torch.Tensor:
    """(B, G, dim) values of one group."""
    s = m.skel
    dev = d.qpos.device
    B = d.qpos.shape[0]
    st, ids, objid, refid = g.stype, g.ids, g.objid, g.refid
    G = len(ids)

    def ix(a):
        return _ix(a, dev)

    if st == SensorType.USER:  # no user callback: user sensors read 0
        return d.qpos.new_zeros((B, G, g.dim))
    if st == SensorType.CONTACT:
        return _contact_group(m, d, g, lazy["wrench"])
    if st in _GEOMPAIR:
        return _geompair_group(m, d, g)
    if st == SensorType.CLOCK:
        return d.time[:, None, None].expand(B, G, 1)
    if st == SensorType.JOINTPOS:
        return d.qpos[:, ix(np.asarray(s.jnt_qposadr)[objid])][..., None]
    if st == SensorType.JOINTVEL:
        return d.qvel[:, ix(np.asarray(s.jnt_dofadr)[objid])][..., None]
    if st == SensorType.JOINTACTFRC:
        return d.qfrc_actuator[:, ix(np.asarray(s.jnt_dofadr)[objid])][..., None]
    if st == SensorType.TENDONPOS:
        return d.ten_length[:, ix(objid)][..., None]
    if st == SensorType.TENDONVEL:
        return d.ten_velocity[:, ix(objid)][..., None]
    if st == SensorType.TENDONACTFRC:
        # the force of the actuators with a transmission on the tendon, summed
        on = (np.asarray(s.actuator_trntype) == int(TrnType.TENDON))[None] & (
            np.asarray(s.actuator_trnid)[None] == objid[:, None])  # (G, nu)
        return torch.where(ix(on), d.actuator_force[:, None, :], 0.0).sum(-1)[..., None]
    if st == SensorType.BALLQUAT:
        return am.normalize_quat(d.qpos[:, ix(np.asarray(s.jnt_qposadr)[objid][:, None] + np.arange(4))])
    if st == SensorType.BALLANGVEL:
        return d.qvel[:, ix(np.asarray(s.jnt_dofadr)[objid][:, None] + np.arange(3))]
    if st == SensorType.ACTUATORPOS:
        return d.actuator_length[:, ix(objid)][..., None]
    if st == SensorType.ACTUATORVEL:
        return d.actuator_velocity[:, ix(objid)][..., None]
    if st == SensorType.ACTUATORFRC:
        return d.actuator_force[:, ix(objid)][..., None]
    if st == SensorType.CAMPROJECTION:
        # site objid in camera refid's pixel coordinates (JAX sensor.py:642-
        # 660): the focal length from cam_intrinsic / cam_sensorsize where the
        # sensor size is set, else from fovy; the principal point unused
        cam = ix(refid)
        p = _tmul(d.cam_xmat[:, cam], d.site_xpos[:, ix(objid)] - d.cam_xpos[:, cam])
        res, ss, intr = m.cam_resolution[cam], m.cam_sensorsize[cam], m.cam_intrinsic[cam]
        use_intrinsic = (ss[:, 0] > 0) & (ss[:, 1] > 0)
        f_fovy = 0.5 / torch.tan(m.cam_fovy[cam] * np.pi / 360.0) * res[:, 1]
        fx = torch.where(use_intrinsic, intr[:, 0] / torch.where(ss[:, 0] > 0, ss[:, 0], 1.0) * res[:, 0], f_fovy)
        fy = torch.where(use_intrinsic, intr[:, 1] / torch.where(ss[:, 1] > 0, ss[:, 1], 1.0) * res[:, 1], f_fovy)
        den = p[..., 2]
        den = torch.where(den.abs() < 1e-12, torch.where(den < 0, -1e-12, 1e-12), den)
        return torch.stack([-fx * p[..., 0] / den + res[:, 0] / 2.0, fy * p[..., 1] / den + res[:, 1] / 2.0], -1)
    if st == SensorType.SUBTREECOM:
        return d.subtree_com[:, ix(objid)]
    if st == SensorType.SUBTREELINVEL:
        return lazy["subtree"][0][:, ix(objid)]
    if st == SensorType.SUBTREEANGMOM:
        return lazy["subtree"][1][:, ix(objid)]
    if st in (SensorType.E_POTENTIAL, SensorType.E_KINETIC):
        from ambersim_tpu_torch.engine import smooth

        e = smooth.energy_pos(m, d) if st == SensorType.E_POTENTIAL else smooth.energy_vel(m, d)
        return e[:, None, None].expand(B, G, 1)
    if st == SensorType.RANGEFINDER:
        from ambersim_tpu_torch.engine.ray import ray

        # one ray a sensor along its site's z axis, the site's own body excluded
        dist = [ray(m, d, d.site_xpos[:, i], d.site_xmat[:, i, :, 2], bodyexclude=int(s.site_bodyid[i]))[0]
                for i in objid]
        return torch.stack(dist, 1)[..., None]
    if st in _LIMIT:
        rows = _limit_rows(s, objid, tendon=int(st) >= int(SensorType.TENDONLIMITPOS))
        if not (rows >= 0).any():
            return d.qpos.new_zeros((B, G, 1))
        r = ix(np.maximum(rows, 0))
        active = d.efc_active[:, r] & ix(rows >= 0)
        if st in _LIMIT_POS:
            val = d.efc_pos[:, r] - d.efc_margin[:, r]
        elif st in _LIMIT_VEL:
            val = (d.efc_J[:, r] * d.qvel[:, None, :]).sum(-1)
        else:
            val = d.efc_force[:, r]
        return torch.where(active, val, 0.0)[..., None]
    if st == SensorType.INSIDESITE:
        point, _ = _object_pos_mat(m, d, g.objtype, objid)
        return _inside_site(m, d, refid, g.kind[0], point[:, :, None, :]).to(d.qpos.dtype)
    if st == SensorType.TOUCH:
        # the normal forces of the contacts on the site's body inside the site
        sbody = ix(np.asarray(s.site_bodyid)[objid])[:, None]  # (G, 1)
        bodyid = ix(s.geom_bodyid)
        b1, b2 = bodyid[d.contact.geom1.long()][:, None], bodyid[d.contact.geom2.long()][:, None]  # (B, 1, ncon)
        inside = _inside_site(m, d, objid, g.kind[0], d.contact.pos[:, None])
        hit = ((b1 == sbody) | (b2 == sbody)) & inside
        return torch.where(hit, lazy["con_normal"][:, None], 0.0).sum(-1)[..., None]
    if st in (SensorType.MAGNETOMETER, SensorType.VELOCIMETER, SensorType.GYRO, SensorType.ACCELEROMETER,
              SensorType.FORCE, SensorType.TORQUE):
        # site-frame sensors
        pos, mat = d.site_xpos[:, ix(objid)], d.site_xmat[:, ix(objid)]
        bodyid = np.asarray(s.site_bodyid)[objid]
        if st == SensorType.MAGNETOMETER:
            return _tmul(mat, m.opt.magnetic)
        if st in (SensorType.VELOCIMETER, SensorType.GYRO):
            ang, lin = _point_vel(m, d, bodyid, pos)
            return _tmul(mat, lin if st == SensorType.VELOCIMETER else ang)
        if st == SensorType.ACCELEROMETER:
            return _tmul(mat, _point_acc(m, d, bodyid, pos)[1])
        cfrc = lazy["cfrc_int"][:, ix(bodyid)]
        if st == SensorType.FORCE:
            return _tmul(mat, cfrc[..., 3:])
        origin = d.subtree_com[:, ix(np.asarray(s.body_rootid)[bodyid])]
        return _tmul(mat, cfrc[..., :3] - am.cross(pos - origin, cfrc[..., 3:]))  # the torque about the site
    if st in _FRAME:
        has_ref = g.reftype >= 0
        pos, mat = _object_pos_mat(m, d, g.objtype, objid)
        if has_ref:
            rpos, rmat = _object_pos_mat(m, d, g.reftype, refid)
        if st == SensorType.FRAMEPOS:
            return _tmul(rmat, pos - rpos) if has_ref else pos
        if st == SensorType.FRAMEQUAT:
            q = _object_quat(m, d, g.objtype, objid)
            if has_ref:
                q = am.mul_quat(am.neg_quat(_object_quat(m, d, g.reftype, refid)), q)
            return am.normalize_quat(q)
        if st in (SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS, SensorType.FRAMEZAXIS):
            axis = mat[..., :, int(st) - int(SensorType.FRAMEXAXIS)]
            return _tmul(rmat, axis) if has_ref else axis
        bodyid = _object_bodyid(s, g.objtype, objid)
        if st == SensorType.FRAMELINACC:
            return _point_acc(m, d, bodyid, pos)[1]
        if st == SensorType.FRAMEANGACC:
            return _point_acc(m, d, bodyid, pos)[0]
        ang, lin = _point_vel(m, d, bodyid, pos)
        if has_ref:
            rang, rlin = _point_vel(m, d, _object_bodyid(s, g.reftype, refid), rpos)
        if st == SensorType.FRAMELINVEL:
            return _tmul(rmat, lin - rlin - am.cross(rang, pos - rpos)) if has_ref else lin
        return _tmul(rmat, ang - rang) if has_ref else ang  # FRAMEANGVEL
    raise NotImplementedError(f"sensor type {st.name}")


def sensors(m: Model, d: Data) -> Data:
    """Evaluate every sensor into d.sensordata (the position, velocity and
    acceleration stages), then the cutoff clamp (to [0, cutoff] for touch,
    [-cutoff, cutoff] else; not the geom-distance trio, whose cutoff is its
    search range)."""
    s = m.skel
    if s.nsensor == 0 or (m.opt.disableflags & DisableBit.SENSOR):
        return d
    plan = sensor_plan(s)
    dev = d.qpos.device
    present = plan.present
    lazy: dict = {}
    if present & _NEEDS_CACC:
        d = rne_postconstraint(m, d)
    if s.ncon and present & (_NEEDS_CON_FORCES | {SensorType.CONTACT}):
        lazy["wrench"] = _contact_wrench(m, d)
    if present & _NEEDS_CON_FORCES:
        if s.ncon:
            lazy["con_normal"], con_force = _contact_forces_world(lazy["wrench"], d)
        else:
            lazy["con_normal"] = d.qpos.new_zeros((d.qpos.shape[0], 0))
            con_force = d.qpos.new_zeros((d.qpos.shape[0], 0, 3))
        if present & {SensorType.FORCE, SensorType.TORQUE}:
            lazy["cfrc_int"] = _cfrc_int(m, d, con_force)
    if present & {SensorType.SUBTREELINVEL, SensorType.SUBTREEANGMOM}:
        lazy["subtree"] = _subtree_momentum(m, d, SensorType.SUBTREEANGMOM in present)
    vals = torch.cat([_eval_group(m, d, g, lazy).reshape(d.qpos.shape[0], -1) for g in plan.groups], 1)
    cutoff = m.sensor_cutoff[_ix(plan.col_sensor, dev)]
    on = _ix(plan.clip, dev) & (cutoff > 0)
    lo = torch.where(_ix(plan.positive, dev), 0.0, -cutoff)
    vals = torch.where(on, torch.minimum(torch.maximum(vals, lo), cutoff), vals)
    return d.replace(sensordata=vals[:, _ix(plan.inv, dev)])
