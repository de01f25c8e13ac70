"""Forward dynamics and step (port of ambersim_tpu/engine/forward.py)."""

from __future__ import annotations

import contextlib

import torch

from ambersim_tpu_torch.core.types import Data, DisableBit, EnableBit, IntegratorType, Model, check_env_leaves
from ambersim_tpu_torch.engine import collision, constraint, integrate, noslip, sensor, smooth, solver
from ambersim_tpu_torch.io.bridge import check_slice


@contextlib.contextmanager
def full_f32_matmul():
    """Scope in which float32 products stay in full float32 on the card
    (TF32 keeps about three decimal digits: the port's counterpart of the
    JAX package's precision=HIGHEST on its selection contractions). Turns
    both TF32 flags off and gives the caller's values back on exit; also a
    decorator."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fwd_position(m: Model, d: Data) -> Data:
    d = smooth.fwd_position_smooth(m, d)
    if not (m.opt.disableflags & DisableBit.CONSTRAINT):
        d = collision.collision(m, d)
        d = constraint.make_constraint(m, d)
    return d


@full_f32_matmul()
def forward(m: Model, d: Data) -> Data:
    """Full forward dynamics: populate qacc without integrating."""
    check_slice(m)
    check_env_leaves(m, d.qpos.shape[0])
    energy = m.opt.enableflags & EnableBit.ENERGY
    d = fwd_position(m, d)
    if energy:  # mj_energyPos at the end of the position stage
        e_pos = smooth.energy_pos(m, d)
    d = smooth.fwd_velocity(m, d)
    if energy:  # mj_energyVel at the end of the velocity stage
        d = d.replace(energy=torch.stack([e_pos, smooth.energy_vel(m, d)], -1))
    d = smooth.fwd_actuation(m, d)
    d = smooth.fwd_acceleration(m, d)
    if m.opt.disableflags & DisableBit.CONSTRAINT or m.skel.nefc == 0:
        # the integrator reads qacc; no constraint force this step
        d = d.replace(qacc=d.qacc_smooth, qfrc_constraint=torch.zeros_like(d.qfrc_constraint))
    else:
        d = solver.solve(m, d)
        if m.opt.noslip_iterations > 0:
            d = noslip.noslip(m, d)
    if m.opt.enableflags & EnableBit.FWDINV:
        # mj_compareFwdInv: the constraint force recovered from the solved
        # qacc by the inverse direction, and the discrepancy's norms
        from ambersim_tpu_torch.engine.inverse import inv_constraint

        di = inv_constraint(m, d)
        d = d.replace(solver_fwdinv=torch.stack([
            torch.linalg.vector_norm(d.qfrc_constraint - di.qfrc_constraint, dim=-1),
            torch.linalg.vector_norm(d.efc_force - di.efc_force, dim=-1)], -1))
    if m.skel.nsensor and not (m.opt.disableflags & DisableBit.SENSOR):
        d = sensor.sensors(m, d)
    return d


def step(m: Model, d: Data) -> Data:
    """One physics step: forward dynamics, then the model's integrator
    (JAX forward.py:78-87)."""
    d = forward(m, d)
    if m.opt.integrator == int(IntegratorType.RK4):
        return integrate.rk4(m, d, forward)
    if m.opt.integrator == int(IntegratorType.IMPLICIT):
        return integrate.implicit(m, d)
    if m.opt.integrator == int(IntegratorType.IMPLICITFAST):
        return integrate.implicitfast(m, d)
    return integrate.euler(m, d)
