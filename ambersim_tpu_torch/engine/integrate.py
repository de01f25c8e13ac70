"""Semi-implicit Euler with implicit joint damping (port of `euler`,
`integrate_pos` and `_advance_act` of ambersim_tpu/engine/integrate.py).

As in MuJoCo's mj_Euler: with joint damping present (and EULERDAMP and
DAMPER not disabled) the damping is integrated implicitly by solving
(M + h diag(damping)) dv = h M qacc, through kernel 3 on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import Data, DisableBit, JointType, Model
from ambersim_tpu_torch.engine import linalg
from ambersim_tpu_torch.engine.schedule import device_index, tree_schedule


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    """qpos (+) qvel * dt on (B, nq)/(B, nv), quaternion expmap for ball/free joints."""
    s = m.skel
    sched = tree_schedule(s)
    dev = qpos.device

    def ix(a):
        return device_index(a, dev)

    out = qpos.clone()  # written in place below
    for jtype_int, jids in sched.jnt_by_type.items():
        jtype = JointType(jtype_int)
        qa = s.jnt_qposadr[jids]
        da = s.jnt_dofadr[jids]
        if jtype == JointType.FREE:
            out[:, ix(qa[:, None] + np.arange(3))] += qvel[:, ix(da[:, None] + np.arange(3))] * dt
            q4 = ix(qa[:, None] + 3 + np.arange(4))
            out[:, q4] = am.quat_integrate(qpos[:, q4], qvel[:, ix(da[:, None] + 3 + np.arange(3))], dt)
        elif jtype == JointType.BALL:
            q4 = ix(qa[:, None] + np.arange(4))
            out[:, q4] = am.quat_integrate(qpos[:, q4], qvel[:, ix(da[:, None] + np.arange(3))], dt)
        else:
            out[:, ix(qa)] += qvel[:, ix(da)] * dt
    return out


def _advance_act(m: Model, d: Data, h) -> Data:
    """Actuator activations; `io.bridge.check_slice` admits only na == 0."""
    if m.skel.na:
        raise NotImplementedError("actuator activations (na > 0)")
    return d


def euler(m: Model, d: Data) -> Data:
    """Semi-implicit Euler step given d.qacc."""
    s = m.skel
    h = m.opt.timestep
    d = _advance_act(m, d, h)
    use_implicit = (
        bool(s.has_damping)
        and not (m.opt.disableflags & DisableBit.EULERDAMP)
        and not (m.opt.disableflags & DisableBit.DAMPER)
    )
    if use_implicit:
        mh = d.qM + h * torch.diag(m.dof_damping)
        # RHS h * qM @ qacc, as the JAX package computes it (equal to MuJoCo's
        # h * (qfrc_smooth + qfrc_constraint) up to the solver's residual)
        rhs = h * (d.qM * d.qacc[:, None, :]).sum(-1)
        qvel = d.qvel + linalg.solve_pd(mh, rhs)
    else:
        qvel = d.qvel + h * d.qacc
    qpos = integrate_pos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, time=d.time + h)
