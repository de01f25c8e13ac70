"""The port's noslip pass on the main path's quadruped against the JAX
package's, on the CPU: noslip_iterations 5 under its own Newton 3 x 6, 4
envs x 3 steps from the main path's start under its PD controller, at the
repo's rollout bars (tools/solver_parity.py).

Five iterations, not the card path's three: up to four the JAX package
unrolls its sweeps (noslip.py:131-134), and its jit of the quadruped's
three unrolled sweeps of 68 updates takes ~70 s on a CPU; from five it
scans one sweep (16 s). The port runs the same sweep code for any count;
three iterations are held on tests/test_noslip.py's scene
(test_torch_noslip.py) and card against CPU by chip_smoke.py.
"""

from tools import solver_parity as sp


def test_quadruped_noslip():
    from ambersim_tpu_torch.engine.noslip import noslip_plan
    from tools import torch_parity as tp

    jm = sp.quick_jax_model(sp.quadruped_xml(noslip_iterations=5))
    tm = tp.torch_model(jm)
    assert int(tm.opt.noslip_iterations) == 5 and noslip_plan(tm.skel, False).updates == 12 + 28 * 2
    d, jd = sp.rollout(jm, sp.quadruped_start(jm, seed=8), 3, pd=True)
    tp.assert_close("efc_force", d.efc_force, jd.efc_force, 1e-3, 1e-2)
