"""Semi-implicit Euler with implicit joint damping and the actuator
activations (port of `euler`, `integrate_pos` and `_advance_act` of
ambersim_tpu/engine/integrate.py).

As in MuJoCo's mj_Euler: with joint damping present (and EULERDAMP and
DAMPER not disabled) the damping is integrated implicitly by solving
(M + h diag(damping)) dv = h M qacc, through kernel 3 on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import Data, DisableBit, DynType, JointType, Model
from ambersim_tpu_torch.engine import linalg, smooth
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
    """Integrate the actuator activations (filter, filterexact, integrator
    dynamics): Euler on act_dot, the exact exponential for FILTEREXACT, and
    the actrange clamp of act-limited actuators (cf. mj_advance)."""
    s = m.skel
    if s.na == 0:
        return d
    dev = d.act.device
    act = d.act + h * d.act_dot
    dyn_u = smooth.dyn_actuators(s)
    exact = np.asarray(s.actuator_dyntype)[dyn_u] == int(DynType.FILTEREXACT)
    if exact.any():
        tau = torch.clamp(m.actuator_dynprm[device_index(dyn_u, dev), 0], min=1e-8)
        act = torch.where(device_index(exact, dev), d.act + d.act_dot * tau * (1.0 - torch.exp(-h / tau)), act)
    limited = np.asarray(s.actuator_actlimited)[dyn_u]
    if limited.any():
        rng = m.actuator_actrange[device_index(dyn_u, dev)]
        act = torch.where(device_index(limited, dev), torch.clamp(act, rng[:, 0], rng[:, 1]), act)
    return d.replace(act=act)


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
