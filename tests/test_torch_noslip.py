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


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
def test_noslip_gradient_matches_forward_mode(cone):
    """Reverse-mode gradients through the noslip pass, whose sweep updates
    make new tensors and write none that autograd saved: d(w . qacc)/d(ctrl,
    xfrc_applied) of a forward at 3 noslip iterations (Newton 8 x 8), in
    float64, along two seeded directions against forward mode
    (torch.autograd.forward_ad) within 1e-10 of the derivative's scale
    (they meet to ~1e-13). An in-place sweep makes the reverse pass raise:
    it overwrites a view of the residual that the pass saved."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from ambersim_tpu_torch.engine import forward

    jm, jd = _scene(3, cone, iterations=8, ls_iterations=8)
    tm = chip_smoke.float64_copy(tp.torch_model(jm))
    d = chip_smoke.float64_copy(tp.torch_batch(tp.torch_model(jm), jd))
    w = torch.as_tensor(np.random.default_rng(7).standard_normal(tuple(d.qacc.shape)))

    def loss(ctrl, xfrc):
        return (w * forward(tm, d.replace(ctrl=ctrl, xfrc_applied=xfrc)).qacc).sum()

    ctrl, xfrc = (d.ctrl.clone().requires_grad_(True), d.xfrc_applied.clone().requires_grad_(True))
    gc, gx = torch.autograd.grad(loss(ctrl, xfrc), (ctrl, xfrc))
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for _ in range(2):
            vc, vx = (torch.as_tensor(rng.standard_normal(tuple(t.shape))) for t in (ctrl, xfrc))
            ad = ((gc * vc).sum() + (gx * vx).sum()).item()
            with fwAD.dual_level():
                jv = fwAD.unpack_dual(loss(fwAD.make_dual(d.ctrl, vc), fwAD.make_dual(d.xfrc_applied, vx))).tangent
            assert abs(ad - jv.item()) <= 1e-10 * max(1.0, abs(jv.item())), (ad, jv.item())
