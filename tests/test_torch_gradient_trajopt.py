"""GradientShootingOptimizer of the PyTorch port against the JAX package
(CPU), on tests/trajopt/test_gradient_optimizer.py's inline pendulum
(Newton 1 x 4, ctrlrange +-2), built from the same XML
(tools/torch_parity.jax_model_from_xml):

  * the first Adam iterates (1 and 3 steps; the best iterate kept, the
    ctrlrange clip) match the JAX package's optimize (rtol 1e-4, atol
    1e-5 on us and xs);
  * a batch of two problems equals each problem solved alone, and the
    30-step descent lowers the cost below 0.9 of the guess's and moves
    the swing toward the goal (:28-52's property, slow-marked there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

PENDULUM = """
<mujoco><option timestep="0.02" iterations="1" ls_iterations="4"/>
<compiler angle="radian"/><worldbody>
  <body pos="0 0 1">
    <joint name="h" axis="0 1 0" damping="0.1"/>
    <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.03" mass="0.3"/>
  </body>
</worldbody>
<actuator><motor joint="h" gear="1" ctrlrange="-2 2"/></actuator>
</mujoco>
"""
WEIGHTS = (0.1 * np.eye(2, dtype=np.float32), 10.0 * np.eye(2, dtype=np.float32), 0.001 * np.eye(1, dtype=np.float32),
           np.array([1.0, 0.0], np.float32))


@pytest.fixture(scope="module")
def models():
    jm = tp.jax_model_from_xml(PENDULUM)
    return jm, tp.torch_model(jm)


def _optimizer(m, iters):
    from ambersim_tpu_torch.trajopt import GradientShootingOptimizer, StaticGoalQuadraticCost

    cost = StaticGoalQuadraticCost(*(torch.as_tensor(w) for w in WEIGHTS))
    return GradientShootingOptimizer(model=m, cost_function=cost, iters=iters, learning_rate=0.1)


@pytest.mark.parametrize("iters", (1, 3))
def test_first_adam_iterates_match_jax(models, iters):
    from ambersim_tpu.trajopt import GradientShootingOptimizer as JaxOptimizer
    from ambersim_tpu.trajopt import ShootingParams as JaxParams
    from ambersim_tpu.trajopt import StaticGoalQuadraticCost as JaxCost
    from ambersim_tpu_torch.trajopt import ShootingParams

    jm, tm = models
    guess = 0.3 * np.random.default_rng(iters).standard_normal((20, 1)).astype(np.float32)
    jopt = JaxOptimizer(model=jm, cost_function=JaxCost(*(jnp.asarray(w) for w in WEIGHTS)), iters=iters,
                        learning_rate=0.1)
    want_xs, want_us = jax.jit(jopt.optimize)(JaxParams(x0=jnp.zeros(2), us_guess=jnp.asarray(guess)))
    xs, us = _optimizer(tm, iters).optimize(ShootingParams(x0=torch.zeros(2), us_guess=torch.tensor(guess)))
    np.testing.assert_allclose(us.numpy(), np.asarray(want_us), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xs.numpy(), np.asarray(want_xs), rtol=1e-4, atol=1e-5)


def test_batch_equals_single_problems_and_descends(models):
    from ambersim_tpu_torch.trajopt import ShootingParams, shoot

    _, tm = models
    opt = _optimizer(tm, 30)
    x0s = torch.tensor([[0.0, 0.0], [-0.4, 0.0]])
    guess = torch.zeros(2, 20, 1)
    xs, us = opt.optimize(ShootingParams(x0=x0s, us_guess=guess))
    assert xs.shape == (2, 21, 2) and us.shape == (2, 20, 1)
    for i in range(2):
        xs_i, us_i = opt.optimize(ShootingParams(x0=x0s[i], us_guess=guess[i]))
        torch.testing.assert_close(us[i], us_i, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(xs[i], xs_i, rtol=1e-5, atol=1e-6)
    cost = opt.cost_function
    c_guess, c_star = cost.cost(shoot(tm, x0s[0], guess[0]), guess[0]), cost.cost(xs[0], us[0])
    assert float(c_star) < 0.9 * float(c_guess)
    assert float(us.abs().max()) <= 2.0 + 1e-6
    assert float(xs[0, -1, 0]) > 0.3
