"""The integrators: semi-implicit Euler with implicit joint damping,
implicitfast, implicit and RK4, and the actuator activations (port of
ambersim_tpu/engine/integrate.py).

  * euler (mj_Euler): with joint damping present (and EULERDAMP and DAMPER
    not disabled) the damping is integrated implicitly by solving
    (M + h diag(damping)) dv = h M qacc, through kernel 3 on CUDA tensors.
  * implicitfast (mjINT_IMPLICITFAST): (M - h D) dv = h (qfrc_smooth +
    qfrc_constraint) with D the velocity derivative of the passive and
    actuator forces (`_qderiv_vel`: dof and tendon dampers, affine gain and
    bias terms through the transmission moments; the symmetric part of the
    fluid drag's, `smooth.fluid_deriv`), symmetric, so the solve is kernel
    3 on CUDA tensors.
  * implicit (mjINT_IMPLICIT): D adds the fluid drag's derivative and the
    Coriolis and centrifugal derivative d(-qfrc_bias)/dqvel (`_coriolis_deriv`, exact central
    differences of the bias's quadratic form through com_vel and rne);
    M - h D is not symmetric and is solved by LU,
    torch.linalg.solve, as the JAX package solves it with jnp.linalg.solve
    outside any Pallas kernel.
  * rk4 (mjINT_RK4): the classic four stages over (qpos, qvel, act), three
    more forward passes a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import BiasType, Data, DisableBit, DynType, GainType, JointType, Model
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
        mh = d.qM + h * torch.diag_embed(m.dof_damping)  # dof_damping may carry an env axis
        # RHS h * qM @ qacc, as the JAX package computes it (equal to MuJoCo's
        # h * (qfrc_smooth + qfrc_constraint) up to the solver's residual)
        rhs = h * (d.qM * d.qacc[:, None, :]).sum(-1)
        qvel = d.qvel + linalg.solve_pd(mh, rhs)
    else:
        qvel = d.qvel + h * d.qacc
    qpos = integrate_pos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, time=d.time + h)


def _act_input(m: Model, d: Data) -> torch.Tensor:
    """(B, nu) each actuator's force input: ctrl (clamped to ctrlrange unless
    CLAMPCTRL is disabled), the activation where the actuator has dynamics
    (JAX smooth.act_input)."""
    s = m.skel
    inp = smooth.clamped_ctrl(m, d)
    if s.na:
        inp = inp.clone()
        inp[:, device_index(smooth.dyn_actuators(s), d.qpos.device)] = d.act
    return inp


def _qderiv_vel(m: Model, d: Data) -> torch.Tensor:
    """(B, nv, nv) analytic derivative of the velocity-dependent passive and
    actuator forces, D = d(qfrc_passive + qfrc_actuator)/dqvel (JAX
    integrate.py:80-114): -diag(dof_damping) less ten_J^T diag(tendon
    damping) ten_J (none with DAMPER disabled), plus moment^T diag(df/dvel)
    moment over the actuators (affine gain prm[2] times the input, affine
    bias prm[2]) unless ACTUATION is disabled."""
    s = m.skel
    B, nv = d.qvel.shape
    if m.opt.disableflags & DisableBit.DAMPER:
        D = d.qvel.new_zeros((B, nv, nv))
    else:
        D = -torch.diag_embed(m.dof_damping).expand(B, nv, nv)
        if s.ntendon:
            tj = d.ten_J
            D = D - tj.transpose(-1, -2) @ (m.tendon_damping[:, None] * tj)
    if s.nu and not (m.opt.disableflags & DisableBit.ACTUATION):
        dev = d.qpos.device
        moment = smooth.actuator_moment(m, d)  # (B, nu, nv)
        affine_g = device_index(np.asarray(s.actuator_gaintype) == int(GainType.AFFINE), dev)
        affine_b = device_index(np.asarray(s.actuator_biastype) == int(BiasType.AFFINE), dev)
        dgain = torch.where(affine_g, m.actuator_gainprm[..., 2], 0.0) * _act_input(m, d)
        dbias = torch.where(affine_b, m.actuator_biasprm[..., 2], 0.0)
        D = D + moment.transpose(-1, -2) @ ((dgain + dbias)[..., None] * moment)
    return D


def _coriolis_deriv(m: Model, d: Data) -> torch.Tensor:
    """(B, nv, nv) d(-qfrc_bias)/dqvel, the Coriolis and centrifugal part of
    the JAX package's _qderiv_vel_ad (integrate.py:117-147, its jacfwd
    through com_vel and rne). Without gravity the bias is a quadratic form
    q(v) in qvel (cvel and cdof_dot are linear in it, rne's terms products
    of two of them), so the central difference (q(v + s e_j) - q(v - s e_j))
    / 2s is its derivative along e_j exactly, at any step s; with s the
    env's |qvel| the rounding stays at a few ulps of the largest entry, as
    forward-mode AD's does. The 2 nv evaluations are folded into the env
    axis: one com_vel and rne over B * 2 nv rows."""
    B, nv = d.qvel.shape

    def rep(x):
        return x.repeat_interleave(2 * nv, 0)

    step = torch.clamp(torch.linalg.vector_norm(d.qvel, dim=-1), min=1e-6)  # (B,)
    eye = torch.eye(nv, dtype=d.qvel.dtype, device=d.qvel.device)
    v = rep(d.qvel) + (torch.cat([eye, -eye], 0) * step[:, None, None]).reshape(-1, nv)
    m0 = m.replace(opt=m.opt.replace(disableflags=m.opt.disableflags | DisableBit.GRAVITY))
    dd = d.replace(cdof=rep(d.cdof), cinert=rep(d.cinert), qpos=rep(d.qpos), qvel=v)
    q = smooth.rne(m0, smooth.com_vel(m0, dd)).qfrc_bias.reshape(B, 2, nv, nv)  # [b, +/-, j, i]
    return -((q[:, 0] - q[:, 1]) / (2.0 * step[:, None, None])).transpose(-1, -2)  # [b, i, j] = -d bias_i/d qvel_j


def implicit_system(m: Model, d: Data, full: bool):
    """(A, rhs) of the implicit-in-velocity solve A dv = rhs at d (the
    activations already advanced): A = qM - h D with D `_qderiv_vel` plus
    the fluid-drag derivative where `passive` adds fluid forces
    (`smooth.fluid_deriv`; implicitfast takes its symmetric part 0.5 (Df +
    Df^T) as the JAX package does, implicit takes it as it is), plus the
    Coriolis derivative when `full` (implicit), else plus the JAX
    package's 1e-10 ridge (implicitfast: symmetric positive definite for
    physical damping and velocity gains); rhs = h (qfrc_smooth +
    qfrc_constraint)."""
    h = m.opt.timestep
    D = _qderiv_vel(m, d)
    if getattr(m.skel, "has_fluid", False) and smooth.passive_extras_on(m):
        Df = smooth.fluid_deriv(m, d)
        D = D + (Df if full else 0.5 * (Df + Df.transpose(-1, -2)))
    rhs = h * (d.qfrc_smooth + d.qfrc_constraint)
    if full:
        return d.qM - h * (D + _coriolis_deriv(m, d)), rhs
    return d.qM - h * D + 1e-10 * torch.eye(m.skel.nv, dtype=D.dtype, device=D.device), rhs


def _implicit_step(m: Model, d: Data, full: bool) -> Data:
    """implicitfast (full False: kernel 3 on CUDA tensors) or implicit (full
    True: an LU, torch.linalg.solve) given d.qacc's forward."""
    h = m.opt.timestep
    d = _advance_act(m, d, h)
    A, rhs = implicit_system(m, d, full)
    qvel = d.qvel + (torch.linalg.solve(A, rhs) if full else linalg.solve_pd(A, rhs))
    return d.replace(qpos=integrate_pos(m, d.qpos, qvel, h), qvel=qvel, time=d.time + h)


def implicitfast(m: Model, d: Data) -> Data:
    """Implicit-in-velocity step without the Coriolis derivative
    (mjINT_IMPLICITFAST; JAX integrate.py:150-179): kernel 3 on CUDA tensors."""
    return _implicit_step(m, d, full=False)


def implicit(m: Model, d: Data) -> Data:
    """Implicit-in-velocity step with the Coriolis derivative (mjINT_IMPLICIT;
    JAX integrate.py:182-195): an LU solve, torch.linalg.solve."""
    return _implicit_step(m, d, full=True)


def rk4(m: Model, d: Data, forward_fn) -> Data:
    """Classic fourth-order Runge-Kutta over (qpos, qvel, act) (mjINT_RK4;
    JAX integrate.py:225-256). `d` holds stage 1's forward; `forward_fn`
    computes stages 2-4."""
    h = m.opt.timestep
    qpos0, qvel0, act0 = d.qpos, d.qvel, d.act

    def stage(k, a):
        return d.replace(qpos=integrate_pos(m, qpos0, k.qvel, a), qvel=qvel0 + a * k.qacc, act=act0 + a * k.act_dot)

    k1 = d
    k2 = forward_fn(m, stage(k1, h / 2))
    k3 = forward_fn(m, stage(k2, h / 2))
    k4 = forward_fn(m, stage(k3, h))
    ks = (k1, k2, k3, k4)

    def avg(f):
        a, b, c, e = (getattr(k, f) for k in ks)
        return (a + 2 * b + 2 * c + e) / 6.0

    return d.replace(qpos=integrate_pos(m, qpos0, avg("qvel"), h), qvel=qvel0 + h * avg("qacc"),
                     act=act0 + h * avg("act_dot"), time=d.time + h)
