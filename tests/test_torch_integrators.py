"""The PyTorch port's RK4, implicit and implicitfast integrators against
the JAX package (CPU), and the velocity derivatives they solve with.

Fixtures (tools/step_parity.py): tests/test_integrators.py's RK4 double
pendulum, IMPLICITFAST (damped joints, a velocity and a position servo) and
its stiff velocity servo; tests/test_implicit.py's GYRO_XML (a tumbling free
box) under implicit and implicitfast, and CHAIN_XML (a damped triple
pendulum with a velocity servo, implicit); tests/test_flags.py's
PASSIVE_RICH (a fixed tendon's damper among the dampers) under implicitfast
and implicit, without its fluid and gravity compensation (tests/
test_torch_fluid.py holds those and the fluid part of the derivatives);
and the main path's quadruped under each integrator.

Bars: 4 envs x 20 steps from numpy-seeded states at qpos atol 1e-4 and qvel
atol 1e-3 (the quadruped 4 x 10 at its own 3 x 6 Newton iterations, with
the main path's PD controller); `_qderiv_vel` and the Coriolis derivative
on the JAX package's post-forward Data within DERIV_RTOL 1e-4 of each env's
largest |entry|.
"""

import jax
import numpy as np
import pytest
import torch

from tools import step_parity as sp

FIXTURES = ["rk4_pendulum", "implicitfast", "stiff", "gyro_implicit", "gyro_implicitfast", "chain",
            "passive_implicitfast", "passive_implicit"]
DERIV_FIXTURES = ["implicitfast", "gyro_implicit", "chain", "passive_implicit", "quadruped_implicit"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", FIXTURES)
def test_rollout_matches_jax(name):
    d, _ = sp.assert_rollout(name)
    assert not torch.equal(d.qvel, torch.as_tensor(np.asarray(sp.start(name, sp.case(name)[0]).qvel)))


@pytest.mark.parametrize("name", list(sp.QUADRUPED))
def test_quadruped_rollout_matches_jax(name):
    """The main path's quadruped under RK4, implicit and implicitfast: 4 envs
    x 10 PD-controlled steps, the trunk still standing."""
    d, _ = sp.assert_rollout(name, sp.QUADRUPED_STEPS)
    assert ((d.qpos[:, 2] > 0.2) & (d.qpos[:, 2] < 0.32)).all()


@pytest.mark.parametrize("name", DERIV_FIXTURES)
def test_velocity_derivatives_match_jax(name):
    """`_qderiv_vel` (dof and tendon dampers, the affine actuator terms) and
    `_coriolis_deriv` (exact central differences of the bias's quadratic
    form) against the JAX package's _qderiv_vel and
    _qderiv_vel_ad(include_bias=True) on its post-forward Data."""
    from ambersim_tpu.engine import integrate as jintegrate
    from ambersim_tpu_torch.engine import integrate

    jm, tm, _ = sp.case(name)
    _, ref = sp.forward_pair(name)

    def derivs(d):
        return jintegrate._qderiv_vel(jm, d), jintegrate._qderiv_vel_ad(jm, d, include_bias=True)

    want_D, want_C = jax.jit(jax.vmap(derivs))(ref)
    d = sp.tp.torch_batch(tm, ref)
    got_D, got_C = integrate._qderiv_vel(tm, d), integrate._coriolis_deriv(tm, d)
    sp.assert_deriv(got_D, want_D, "_qderiv_vel")
    sp.assert_deriv(got_C, want_C, "Coriolis derivative")
    assert np.abs(np.asarray(want_C)).max() > 0


def test_tendon_damper_enters_the_derivative():
    """PASSIVE_RICH's tendon damper: -ten_J^T damping ten_J in D beside the
    dof dampers (the hinge's 2 and the tendon's 0.7 on the same dof)."""
    from ambersim_tpu_torch.engine import integrate

    _, tm, _ = sp.case("passive_implicitfast")
    got, _ = sp.forward_pair("passive_implicitfast")
    D = integrate._qderiv_vel(tm, got)
    tj = got.ten_J[:, 0]
    want = -torch.diag(tm.dof_damping) - 0.7 * tj[:, :, None] * tj[:, None, :]
    torch.testing.assert_close(D, want, rtol=1e-6, atol=1e-6)
    assert (tj[:, 0] != 0).all()
