"""The port's noslip pass (engine/noslip.py) against the JAX package's
(ambersim_tpu/engine/noslip.py) on the CPU: tests/test_noslip.py's scene
(a box pushed near its stick boundary on a plane, a hinge held below its
frictionloss) at both cones and 1 and 3 iterations, and its rollout at 10
iterations. The quadruped is in test_torch_noslip_quadruped.py.

Bars: qacc within 1e-4 of the JAX package's plus 1e-4 of its largest
|qacc|, efc_force within 1e-4 plus 1e-4 relative; the hinge held as the JAX
test holds it (|qacc_hinge| < 1e-5); rollouts at the repo's rollout bars
(tools/solver_parity.py).
"""

import numpy as np
import pytest

import chip_smoke
from tools import solver_parity as sp
from tools import torch_parity as tp
from tools.weld_parity import np_batch

NOSLIP_XML = chip_smoke.tests_xml("test_noslip.py", "XML")
QACC_TOL = 1e-4
B = 4


def _scene(ni: int, cone: str, push: bool = True, **opt):
    """The scene's JAX Model and 4 seeded starts at rest: the hinge's motor
    at 0.5 (below its frictionloss 0.8) plus 0.1 N(0, 1), and with `push`
    the box pushed along x by 8 N (mu N = 9.81) plus 0.5 N(0, 1)."""
    jm = sp.quick_jax_model(NOSLIP_XML.replace("{NI}", str(ni)).replace("{CONE}", cone), **opt)
    rng = np.random.default_rng(ni)
    xfrc = np.zeros((B, jm.skel.nbody, 6), np.float32)
    xfrc[:, 1, 0] = (8.0 + 0.5 * rng.standard_normal(B)) if push else 0.0
    ctrl = (0.5 + 0.1 * rng.standard_normal((B, 1))).astype(np.float32)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    return jm, np_batch(jm, qpos=qpos, ctrl=ctrl, xfrc_applied=xfrc)


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
@pytest.mark.parametrize("ni", [1, 3])
def test_noslip_forward(ni, cone):
    """One forward from the same Data: qacc and efc_force as the JAX
    package's, the hinge held."""
    jm, jd = _scene(ni, cone)
    got, want = sp.forward_pair(jm, jd)
    scale = np.abs(np.asarray(want.qacc)).max()
    tp.assert_close("qacc", got.qacc, want.qacc, 0.0, QACC_TOL * (1.0 + scale))
    tp.assert_close("efc_force", got.efc_force, want.efc_force, QACC_TOL, QACC_TOL)
    tp.assert_close("qfrc_constraint", got.qfrc_constraint, want.qfrc_constraint, QACC_TOL, QACC_TOL)
    assert float(got.qacc[:, 6].abs().max()) < 1e-5


def test_noslip_rollout():
    """The scene at 10 noslip iterations (the JAX package's scan path), the
    box resting, 4 envs x 30 steps: the rollout bars, and the hinge never
    moves (tests/test_noslip.py's rollout). Newton at 15 x 15: the CPU's
    plain Newton arrays take 2.3 s a step at the scene's 100 x 50."""
    jm, jd = _scene(10, "pyramidal", push=False, iterations=15, ls_iterations=15)
    d, _ = sp.rollout(jm, jd, 30, pd=False)
    assert float(d.qpos[:, 7].abs().max()) < 1e-7
