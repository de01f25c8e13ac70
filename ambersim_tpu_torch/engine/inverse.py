"""Inverse dynamics (mj_inverse; port of ambersim_tpu/engine/inverse.py).

Given (qpos, qvel, qacc) in a batch of Data, the applied generalized force
that would produce qacc:

    qfrc_inverse = M qacc + qfrc_bias - qfrc_passive - qfrc_constraint

The constraint force needs no iterative solve in this direction: with
jar = J qacc - aref each row's force is the derivative of its penalty cost,
the per-row force the solver uses (solver._row_costs), so the forward and
inverse directions agree by construction. Pyramidal and elliptic cones,
frictionloss, limit and equality rows.
"""

from __future__ import annotations

import torch

from ambersim_tpu_torch.core.types import Data, DisableBit, Model
from ambersim_tpu_torch.engine import smooth, solver
from ambersim_tpu_torch.engine.forward import fwd_position, full_f32_matmul
from ambersim_tpu_torch.io.bridge import check_slice


def inv_constraint(m: Model, d: Data) -> Data:
    """efc_force and qfrc_constraint recovered from d.qacc (mj_invConstraint)."""
    check_slice(m)
    if m.skel.nefc == 0 or (m.opt.disableflags & DisableBit.CONSTRAINT):
        return d.replace(qfrc_constraint=torch.zeros_like(d.qacc), efc_force=torch.zeros_like(d.efc_force))
    jar = (d.efc_J * d.qacc[:, None, :]).sum(-1) - d.efc_aref
    _, force, _ = solver._row_costs(m, d, jar)
    return d.replace(qfrc_constraint=(d.efc_J * force[..., None]).sum(1), efc_force=force)


@full_f32_matmul()
def inverse(m: Model, d: Data) -> Data:
    """Full inverse dynamics: the position and velocity stages, the
    constraint force from d.qacc, and qfrc_inverse; d.qacc is the input."""
    check_slice(m)
    d = fwd_position(m, d)
    d = smooth.fwd_velocity(m, d)
    d = inv_constraint(m, d)
    qfrc = (d.qM * d.qacc[:, None, :]).sum(-1) + d.qfrc_bias - d.qfrc_passive - d.qfrc_constraint
    return d.replace(qfrc_inverse=qfrc)
