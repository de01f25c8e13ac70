"""Forward dynamics and step (port of ambersim_tpu/engine/forward.py without
the ENERGY, FWDINV, noslip and sensor branches, which `check_slice`
refuses)."""

from __future__ import annotations

import torch

from ambersim_tpu_torch.core.types import Data, DisableBit, Model
from ambersim_tpu_torch.engine import collision, constraint, integrate, smooth, solver
from ambersim_tpu_torch.io.bridge import check_slice


def full_f32_matmul() -> None:
    """Keep float32 products in full float32 on the card: TF32 keeps about
    three decimal digits (the port's counterpart of the JAX package's
    precision=HIGHEST on its selection contractions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fwd_position(m: Model, d: Data) -> Data:
    d = smooth.fwd_position_smooth(m, d)
    if not (m.opt.disableflags & DisableBit.CONSTRAINT):
        d = collision.collision(m, d)
        d = constraint.make_constraint(m, d)
    return d


def forward(m: Model, d: Data) -> Data:
    """Full forward dynamics: populate qacc without integrating."""
    check_slice(m)
    full_f32_matmul()
    d = fwd_position(m, d)
    d = smooth.fwd_velocity(m, d)
    d = smooth.fwd_actuation(m, d)
    d = smooth.fwd_acceleration(m, d)
    if m.opt.disableflags & DisableBit.CONSTRAINT or m.skel.nefc == 0:
        # the integrator reads qacc; no constraint force this step
        return d.replace(qacc=d.qacc_smooth, qfrc_constraint=torch.zeros_like(d.qfrc_constraint))
    return solver.solve(m, d)


def step(m: Model, d: Data) -> Data:
    """One physics step: forward dynamics + semi-implicit Euler."""
    return integrate.euler(m, forward(m, d))
