"""Compile-time derived constants: invweight0, acc0 and the tendons' length0
and springlength (mirrors mj_setConst).

Port of ambersim_tpu/engine/setconst.py. The port's own smooth pass
(`smooth.fwd_position_smooth`, float32, tendons included) runs on the CPU at
qpos0; the inverse of qM and the rest are float64 numpy, as in the JAX
package. Works on the arrays of `mjcf.compile_spec_arrays`, before any Model
is on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core.types import JointType


def set_constants(skel_fields: dict, leaves: dict) -> dict:
    """`leaves` with dof_invweight0, body_invweight0 and actuator_acc0 set,
    and with tendons tendon_invweight0 (ten_J M^-1 ten_J^T at qpos0),
    tendon_length0 and the NaN (spatial default) springlength rows filled
    with length0. acc0 runs over every transmission of
    `smooth.actuator_moment`; an adhesion (BODY) actuator's moment reads
    make_data's empty contact, so its acc0 is 0, as the JAX package's
    set_constants computes it."""
    from ambersim_tpu_torch.engine import smooth
    from ambersim_tpu_torch.engine.init import make_data
    from ambersim_tpu_torch.io.bridge import build_model

    if skel_fields["nv"] == 0:
        return leaves
    model = build_model(skel_fields, leaves, device="cpu")
    s = model.skel
    with torch.no_grad():
        d = smooth.fwd_position_smooth(model, make_data(model, 1))
        moment0 = smooth.actuator_moment(model, d)[0].numpy().astype(np.float64) if s.nu else None
    qm = d.qM[0].numpy()
    minv_np = np.linalg.inv(qm)
    dof_invweight0 = np.diag(minv_np).copy()
    # mj_setConst averages invweight over a ball joint's 3 dofs and a free
    # joint's translational / rotational triples (oracle-pinned)
    for j in range(s.njnt):
        jtype = int(s.jnt_type[j])
        da = int(s.jnt_dofadr[j])
        if jtype == int(JointType.BALL):
            dof_invweight0[da : da + 3] = dof_invweight0[da : da + 3].mean()
        elif jtype == int(JointType.FREE):
            dof_invweight0[da : da + 3] = dof_invweight0[da : da + 3].mean()
            dof_invweight0[da + 3 : da + 6] = dof_invweight0[da + 3 : da + 6].mean()

    # body invweight0: mean diagonal of J M^-1 J^T for com translation/rotation
    supports = smooth._body_dof_support(s)  # (nbody, nv)
    cdof = d.cdof[0].numpy()
    xipos = d.xipos[0].numpy()
    origin_np = d.subtree_com[0].numpy()[s.body_rootid]
    body_inv = np.zeros((s.nbody, 2), dtype=np.float32)
    for b in range(1, s.nbody):
        jac = np.zeros((6, s.nv))
        offset = xipos[b] - origin_np[b]
        for v in range(s.nv):
            if not supports[b, v]:
                continue
            ang = cdof[v, :3]
            lin = cdof[v, 3:] + np.cross(ang, offset)
            jac[:3, v] = ang
            jac[3:, v] = lin
        a = jac @ minv_np @ jac.T
        body_inv[b, 0] = (a[3, 3] + a[4, 4] + a[5, 5]) / 3.0  # translation
        body_inv[b, 1] = (a[0, 0] + a[1, 1] + a[2, 2]) / 3.0  # rotation
    out = dict(leaves)
    out["dof_invweight0"] = np.asarray(dof_invweight0, np.float32)
    out["body_invweight0"] = body_inv
    if s.ntendon:
        # the run-time Jacobian at qpos0 covers fixed (constant) and spatial rows
        tj = d.ten_J[0].numpy().astype(np.float64)
        out["tendon_invweight0"] = np.asarray(np.einsum("ti,ij,tj->t", tj, minv_np, tj), np.float32)
        length0 = d.ten_length[0].numpy().astype(np.float32)
        out["tendon_length0"] = length0
        ls = np.array(leaves["tendon_lengthspring"], np.float32)
        nan_rows = np.isnan(ls).any(axis=1)
        if nan_rows.any():
            ls[nan_rows] = length0[nan_rows, None]
            out["tendon_lengthspring"] = ls
    if s.nu:
        # acc0 = |M^-1 moment| at qpos0 (muscle force auto-scaling, mj_setConst)
        out["actuator_acc0"] = np.asarray(np.linalg.norm(moment0 @ minv_np, axis=1), np.float32)
    return out
