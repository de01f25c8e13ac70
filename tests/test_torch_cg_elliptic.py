"""The port's CG solver under elliptic cones against the JAX package's on
the CPU: the quadruped compiled with elliptic cones (one contiguous
condim-3 tail: the JAX package's closed-form cost and line search) and the
soft-feet quadruped's mixed condims 3 and 4 (its general form with
_elliptic_W), from the main path's start under its PD controller, at the
rollout bars (tools/solver_parity.py). The elliptic quadruped at
CONVERGED_CG (15 x 15; tests/test_torch_cg.py says why), the soft feet at
30 x 30: at 15 x 15 their CG is not converged and the two packages part
by 1.7e-3 in qvel after one step (4.3e-4 at 30 x 30 and at 50 x 50).
"""

import chip_smoke
from tools import solver_parity as sp
from tools import torch_parity as tp


def test_quadruped_elliptic_cg_rollout():
    """The elliptic quadruped under CG, 4 envs x 3 steps."""
    from ambersim_tpu_torch.engine.solver import elliptic_tail

    jm = sp.quick_jax_model(sp.quadruped_xml(cone="elliptic"), **sp.CONVERGED_CG)
    assert elliptic_tail(tp.torch_model(jm).skel) is not None
    sp.rollout(jm, sp.quadruped_start(jm, seed=7), 3, pd=True)


def test_soft_feet_mixed_condims_cg():
    """One CG step of the soft-feet quadruped compiled with elliptic cones, at 30 x 30."""
    from ambersim_tpu_torch.engine.solver import elliptic_tail

    jm = sp.quick_jax_model(chip_smoke.soft_feet_xml("elliptic"), solver=sp.CG, iterations=30, ls_iterations=30)
    assert elliptic_tail(tp.torch_model(jm).skel) is None
    sp.rollout(jm, sp.quadruped_start(jm, seed=4), 1, pd=True)
