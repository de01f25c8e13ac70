"""Batched Data allocation (port of ambersim_tpu/engine/init.py)."""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core.types import Contact, Data, Model


def _pyr_sizes(s) -> tuple[int, int]:
    """(ncon3, ndiag) when the efc rows factor (sizes Data.efc_bJ/efc_dsc);
    (0, 0) when the model doesn't qualify."""
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    st = _pyramid_structure(s)
    return (st.ncon3, st.ndiag) if st is not None else (0, 0)


def make_data(m: Model, batch_size: int, keyframe: int | None = None) -> Data:
    """Allocate `batch_size` fresh envs on the model's device: at qpos0 (each
    env at its own where qpos0 is per env) with zero velocity, activations
    and ctrl and the mocap bodies at their body_pos / body_quat, or at
    keyframe `keyframe` (its time, qpos, qvel, act, ctrl and mocap poses)."""
    s = m.skel
    dev = m.device
    B = batch_size
    f32 = torch.float32

    def z(*shape):
        return torch.zeros((B,) + shape, dtype=f32, device=dev)

    def tile(x, *shape):
        x = torch.as_tensor(x, dtype=f32, device=dev)
        return x.expand((B,) + shape).clone()

    def eyes(n):
        return tile(torch.eye(3), n, 3, 3)

    ncon3, ndiag = _pyr_sizes(s)
    mocap_ids = torch.as_tensor(np.array(s.mocap_bodyid, np.int64), device=dev)
    k = keyframe
    if k is None:
        time, qpos, qvel, act, ctrl = z(), tile(m.qpos0, s.nq), z(s.nv), z(s.na), z(s.nu)
        mocap_pos, mocap_quat = m.body_pos[mocap_ids], m.body_quat[mocap_ids]
    else:
        time, qpos, qvel, act, ctrl = (tile(x[k], *x.shape[1:]) for x in (
            m.key_time, m.key_qpos, m.key_qvel, m.key_act, m.key_ctrl))
        mocap_pos, mocap_quat = m.key_mpos[k], m.key_mquat[k]
    contact = Contact(
        dist=torch.full((B, s.ncon), 1e10, dtype=f32, device=dev),
        pos=z(s.ncon, 3),
        frame=eyes(s.ncon),
        friction=z(s.ncon, 5),
        solref=z(s.ncon, 2),
        solimp=z(s.ncon, 5),
        includemargin=z(s.ncon),
        gap=z(s.ncon),
        geom1=torch.as_tensor(np.array(s.con_geom1[: s.ncon], np.int32), device=dev).expand(B, -1).clone(),
        geom2=torch.as_tensor(np.array(s.con_geom2[: s.ncon], np.int32), device=dev).expand(B, -1).clone(),
    )
    return Data(
        time=time,
        qpos=qpos,
        qvel=qvel,
        act=act,
        ctrl=ctrl,
        qfrc_applied=z(s.nv),
        xfrc_applied=z(s.nbody, 6),
        qacc_warmstart=z(s.nv),
        mocap_pos=tile(mocap_pos, s.nmocap, 3),
        mocap_quat=tile(mocap_quat, s.nmocap, 4),
        xpos=z(s.nbody, 3),
        xquat=tile(torch.tensor([1.0, 0, 0, 0]), s.nbody, 4),
        xipos=z(s.nbody, 3),
        ximat=eyes(s.nbody),
        xanchor=z(s.njnt, 3),
        xaxis=z(s.njnt, 3),
        geom_xpos=z(s.ngeom, 3),
        geom_xmat=eyes(s.ngeom),
        site_xpos=z(s.nsite, 3),
        site_xmat=eyes(s.nsite),
        cam_xpos=z(s.ncam, 3),
        cam_xmat=eyes(s.ncam),
        light_xpos=z(s.nlight, 3),
        light_xdir=z(s.nlight, 3),
        ten_length=z(s.ntendon),
        ten_velocity=z(s.ntendon),
        ten_J=z(s.ntendon, s.nv),
        subtree_com=z(s.nbody, 3),
        cinert=z(s.nbody, 6, 6),
        cdof=z(s.nv, 6),
        cdof_dot=z(s.nv, 6),
        cvel=z(s.nbody, 6),
        qM=z(s.nv, s.nv),
        qLD=z(s.nv, s.nv),
        qfrc_bias=z(s.nv),
        qfrc_passive=z(s.nv),
        qfrc_spring=z(s.nv),
        qfrc_damper=z(s.nv),
        actuator_length=z(s.nu),
        actuator_velocity=z(s.nu),
        actuator_force=z(s.nu),
        act_dot=z(s.na),
        qfrc_actuator=z(s.nv),
        qfrc_smooth=z(s.nv),
        qacc_smooth=z(s.nv),
        qfrc_constraint=z(s.nv),
        qacc=z(s.nv),
        qfrc_inverse=z(s.nv),
        contact=contact,
        efc_J=z(s.nefc, s.nv),
        efc_bJ=z(3 * ncon3, s.nv),
        efc_dsc=z(ndiag),
        efc_D=z(s.nefc),
        efc_aref=z(s.nefc),
        efc_pos=z(s.nefc),
        efc_margin=z(s.nefc),
        efc_frictionloss=z(s.nefc),
        efc_active=torch.zeros((B, s.nefc), dtype=torch.bool, device=dev),
        efc_force=z(s.nefc),
        cacc=z(s.nbody, 6),
        sensordata=z(s.nsensordata),
        energy=z(2),
        solver_fwdinv=z(2),
    )
