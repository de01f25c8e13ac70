"""iLQR over a batch of problems in the port (ILQR.optimize with x0 (P, nx)
and us_guess (P, N, nu), one batch all the way down) against the JAX
package (CPU).

The JAX package's users run jax.vmap(opt.optimize) over a batch
(tests/trajopt/test_ilqr.py:130-150, slow-marked there). vmap of a
deterministic function equals the function problem by problem, so each
problem is held against the JAX package's single-problem
jax.jit(opt.optimize), one compile for all of them. Cases:

  * the JAX test's pendulum (PENDULUM, goal pi/2), its four starts spread
    over [-1, 1] rad at rest, N = 20, 4 iterations, from the zero guess:
    each problem's xs and us within 1e-4 of the JAX package's solve (the
    single-problem test's bar, tests/test_torch_ilqr.py), within 1e-6 of
    the port's own single-problem solve (the same arithmetic on another
    batch shape), and no worse than its guess;
  * the ball joint (BALL_BODY, nq 4 != nv 3) at a batch of 2 with
    tests/test_torch_ilqr.py's costs, 1 iteration, each problem against the
    JAX package's tape within 1e-4;
  * run_mpc_batch over ILQR: two pendulum problems, 3 control steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ilqr import BALL_BODY, PENDULUM, _ball_costs, _pendulum_costs
from tools import torch_parity as tp

TOL = 1e-4
SAME = 1e-6
N, ITERS = 20, 4
STARTS = np.stack([np.array([a, 0.0], np.float32) for a in np.linspace(-1.0, 1.0, 4)])


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pendulum():
    jm = tp.jax_model_from_xml(PENDULUM)
    return jm, tp.torch_model(jm), np.array([np.pi / 2, 0.0], np.float32)


def test_pendulum_batch_matches_jax_and_single_solves(pendulum):
    from ambersim_tpu.trajopt import ILQR as JaxILQR
    from ambersim_tpu.trajopt import ILQRParams as JaxParams
    from ambersim_tpu_torch.trajopt import ILQR, ILQRParams, shoot

    jm, m, goal = pendulum
    guess = np.zeros((len(STARTS), N, 1), np.float32)
    jopt = jax.jit(JaxILQR(jm, *_pendulum_costs(goal, "jax"), iterations=ITERS).optimize)
    opt = ILQR(m, *_pendulum_costs(goal, "torch"), iterations=ITERS)
    xs, us = opt.optimize(ILQRParams(x0=torch.as_tensor(STARTS), us_guess=torch.as_tensor(guess)))
    assert xs.shape == (len(STARTS), N + 1, 2) and us.shape == (len(STARTS), N, 1)
    for i, x0 in enumerate(STARTS):
        want_xs, want_us = jopt(JaxParams(x0=jnp.asarray(x0), us_guess=jnp.asarray(guess[i])))
        tp.assert_close(f"xs problem {i}", xs[i], np.asarray(want_xs), 0.0, TOL)
        tp.assert_close(f"us problem {i}", us[i], np.asarray(want_us), 0.0, TOL)
        one_xs, one_us = opt.optimize(ILQRParams(x0=torch.as_tensor(x0), us_guess=torch.as_tensor(guess[i])))
        tp.assert_close(f"xs problem {i} alone", xs[i], one_xs.numpy(), 0.0, SAME)
        tp.assert_close(f"us problem {i} alone", us[i], one_us.numpy(), 0.0, SAME)
        g = torch.as_tensor(guess[i])
        assert float(opt._traj_cost(xs[i], us[i])) <= float(opt._traj_cost(shoot(m, torch.as_tensor(x0), g), g)) + 1e-6


def test_ball_joint_batch_matches_jax():
    from ambersim_tpu.trajopt import ILQR as JaxILQR
    from ambersim_tpu.trajopt import ILQRParams as JaxParams
    from ambersim_tpu.trajopt import state_diff as jax_diff
    from ambersim_tpu_torch.trajopt import ILQR, ILQRParams, state_diff

    jm = tp.jax_model_from_xml(BALL_BODY)
    m = tp.torch_model(jm)
    goal = np.array([np.cos(0.4), 0.0, np.sin(0.4), 0.0, 0.0, 0.0, 0.0], np.float32)
    guess = 0.3 * np.random.default_rng(6).standard_normal((2, 10, 3)).astype(np.float32)
    x0 = np.array([[1.0, 0.0, 0.0, 0.0, 0.1, -0.2, 0.05], [1.0, 0.0, 0.0, 0.0, -0.3, 0.1, 0.2]], np.float32)
    jax_opt = JaxILQR(jm, *_ball_costs(lambda x, g: jax_diff(jm, x, g), jnp.asarray(goal)), iterations=1)
    jopt = jax.jit(jax_opt.optimize)
    opt = ILQR(m, *_ball_costs(lambda x, g: state_diff(m, x[None], g[None])[0], torch.tensor(goal)), iterations=1)
    _, us = opt.optimize(ILQRParams(x0=torch.as_tensor(x0), us_guess=torch.as_tensor(guess)))
    for i in range(2):
        _, want_us = jopt(JaxParams(x0=jnp.asarray(x0[i]), us_guess=jnp.asarray(guess[i])))
        tp.assert_close(f"us problem {i}", us[i], np.asarray(want_us), TOL, TOL)


def test_run_mpc_batch_takes_ilqr(pendulum):
    """run_mpc_batch with an ILQR optimizer re-solves every problem's
    horizon as one batched optimize a control step; its first problem's
    first control is the batched solve's."""
    from ambersim_tpu_torch.trajopt import ILQR, ILQRParams, run_mpc_batch

    _, m, goal = pendulum
    opt = ILQR(m, *_pendulum_costs(goal, "torch"), iterations=1)
    params = ILQRParams(x0=torch.as_tensor(STARTS[:2]), us_guess=torch.zeros(2, 10, 1))
    xs, us, data = run_mpc_batch(m, opt, params, 3)
    assert xs.shape == (2, 4, 2) and us.shape == (2, 3, 1) and data.qpos.shape == (2, 1)
    assert torch.isfinite(xs).all() and not torch.equal(us[0], us[1])
    _, first = opt.optimize(params)
    torch.testing.assert_close(us[:, 0], first[:, 0], rtol=0, atol=SAME)
