"""iLQR of the PyTorch port against the JAX package (CPU).

  * `state_add` / `state_diff` on the quadruped's free joint (nq 19 != nv
    18): the port's batched functions against the JAX package's on seeded
    states and tangent increments, and the round trip;
  * `_linearize`'s A_k and B_k (one step of the N knots repeated 2 nv
    times, one backward pass with one-hot cotangents) against the JAX
    package's jacrev on the pendulum asset and on the hand at the
    predictive-sampling workload's options (BASELINE.md:13), 3 knots,
    within 1e-4 of each's largest entry;
  * ILQR on tests/trajopt/test_ilqr.py's pendulum from a seeded random
    guess, 1 iteration: never worse than the guess, and the JAX package's
    tape; and examples/trajopt/ex_ilqr.py's task 1 (the pendulum asset, 50
    knots, 12 iterations) reaching the JAX package's final angle;
  * ILQR on tests/trajopt/test_ilqr.py's BALL_BODY (three motors on a ball
    joint, nq 4 != nv 3) with the pendulum case's costs on the tangent
    state, from a seeded random guess, 1 iteration: never worse than the
    guess, and the JAX package's tape. (With the manifold test's costs,
    0.01 |u|^2 a knot and 200 |x_N - goal|^2, the Riccati sweep takes
    Q_zz - Q_zu Q_uu^-1 Q_zu^T of nearly equal terms: the two packages'
    linearizations, 1e-6 apart, give feedforward gains 3e-3 apart.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tools import torch_parity as tp

PENDULUM = """
<mujoco><option timestep="0.05" gravity="0 0 -9.81"/>
<compiler angle="radian"/><worldbody>
  <body pos="0 0 1">
    <joint name="h" axis="0 1 0" damping="0.05"/>
    <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.03" mass="0.3"/>
  </body>
</worldbody>
<actuator><motor joint="h" gear="1" ctrlrange="-3 3"/></actuator>
</mujoco>
"""
CONTACT = 1 << 4  # DisableBit.CONTACT
BALL_BODY = chip_smoke.tests_xml("test_ilqr.py", "BALL_BODY", folder="tests/trajopt")


def test_state_add_diff_match_jax_on_the_free_joint():
    from ambersim_tpu.trajopt import state_add as jax_add
    from ambersim_tpu.trajopt import state_diff as jax_diff
    from ambersim_tpu_torch.trajopt import state_add, state_diff

    jm = tp.jax_asset_model("quadruped")
    m = tp.torch_model(jm)
    s = jm.skel
    assert s.nq == s.nv + 1
    rng = np.random.default_rng(3)
    x = np.concatenate([tp.bench_qpos(jm, 5, 3), rng.standard_normal((5, s.nv)).astype(np.float32)], axis=1)
    z = 0.05 * rng.standard_normal((5, 2 * s.nv)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, b: jax_add(jm, a, b))(jnp.asarray(x), jnp.asarray(z)))
    got = state_add(m, torch.tensor(x), torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want_back = np.asarray(jax.vmap(lambda a, b: jax_diff(jm, a, b))(jnp.asarray(want), jnp.asarray(x)))
    back = state_diff(m, got, torch.tensor(x))
    np.testing.assert_allclose(back.numpy(), want_back, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), z, rtol=1e-4, atol=1e-5)
    assert torch.equal(state_diff(m, torch.tensor(x), torch.tensor(x)), torch.zeros(5, 2 * s.nv))


def _hand_trajopt(jm):
    return jm.replace(opt=jm.opt.replace(disableflags=jm.opt.disableflags | CONTACT, iterations=1, ls_iterations=4))


@pytest.mark.parametrize("name", ("pendulum", "hand"))
def test_linearize_matches_jax(name):
    from ambersim_tpu.trajopt import ILQR as JaxILQR
    from ambersim_tpu.trajopt import shoot as jax_shoot
    from ambersim_tpu_torch.trajopt import ILQR

    jm = tp.jax_asset_model(name)
    if name == "hand":
        jm = _hand_trajopt(jm)
    m = tp.torch_model(jm)
    s, N = jm.skel, 3
    rng = np.random.default_rng(4)
    x0 = np.concatenate([np.asarray(jm.qpos0, np.float32) + 0.05 * rng.standard_normal(s.nq).astype(np.float32),
                         0.1 * rng.standard_normal(s.nv).astype(np.float32)])
    us = 0.3 * rng.standard_normal((N, s.nu)).astype(np.float32)
    xs = np.asarray(jax_shoot(jm, jnp.asarray(x0), jnp.asarray(us)))

    def running(x, u):
        return (u * u).sum()

    jopt = JaxILQR(model=jm, running_cost=running, terminal_cost=lambda x: (x * x).sum())
    want_A, want_B = jax.jit(jopt._linearize)(jnp.asarray(xs), jnp.asarray(us))
    opt = ILQR(model=m, running_cost=running, terminal_cost=lambda x: (x * x).sum())
    A, B = opt._linearize(torch.tensor(xs), torch.tensor(us))
    for got, want in ((A, want_A), (B, want_B)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _pendulum_costs(goal, framework):
    goal = jnp.asarray(goal) if framework == "jax" else torch.tensor(goal)

    def running(x, u):
        dx = x - goal
        return 0.5 * (dx @ dx) + 0.05 * (u @ u)

    def terminal(x):
        dx = x - goal
        return 50.0 * (dx @ dx)

    return running, terminal


def test_ilqr_never_worse_than_guess_and_matches_jax():
    from ambersim_tpu.trajopt import ILQR as JaxILQR
    from ambersim_tpu.trajopt import ILQRParams as JaxParams
    from ambersim_tpu_torch.trajopt import ILQR, ILQRParams, shoot

    jm = tp.jax_model_from_xml(PENDULUM)
    m = tp.torch_model(jm)
    goal = np.array([np.pi / 2, 0.0], np.float32)
    guess = 0.5 * np.random.default_rng(3).standard_normal((20, 1)).astype(np.float32)
    x0 = np.array([0.4, -0.3], np.float32)
    jopt = JaxILQR(jm, *_pendulum_costs(goal, "jax"), iterations=1)
    _, want_us = jax.jit(jopt.optimize)(JaxParams(x0=jnp.asarray(x0), us_guess=jnp.asarray(guess)))
    opt = ILQR(m, *_pendulum_costs(goal, "torch"), iterations=1)
    xs, us = opt.optimize(ILQRParams(x0=torch.tensor(x0), us_guess=torch.tensor(guess)))
    xs_guess = shoot(m, torch.tensor(x0), torch.tensor(guess))
    assert float(opt._traj_cost(xs, us)) <= float(opt._traj_cost(xs_guess, torch.tensor(guess))) + 1e-6
    np.testing.assert_allclose(us.numpy(), np.asarray(want_us), rtol=1e-4, atol=1e-4)


def test_ilqr_reach_task_matches_jax():
    """examples/trajopt/ex_ilqr.py task 1: the port's final angle within
    1e-4 of the JAX package's (0.6759 on a CPU; goal 0.7)."""
    from ambersim_tpu.trajopt import ILQR as JaxILQR
    from ambersim_tpu.trajopt import ILQRParams as JaxParams
    from ambersim_tpu_torch.trajopt import ILQR, ILQRParams

    jm = tp.jax_asset_model("pendulum")
    m = tp.torch_model(jm)
    goal = np.array([0.7, 0.0], np.float32)

    def costs(g):
        def running(x, u):
            return 0.02 * (u @ u)

        def terminal(x):
            dx = x - g
            return 100.0 * (dx @ dx)

        return running, terminal

    jopt = JaxILQR(jm, *costs(jnp.asarray(goal)), iterations=12)
    want_xs, _ = jax.jit(jopt.optimize)(JaxParams(x0=jnp.zeros(2), us_guess=jnp.zeros((50, 1))))
    opt = ILQR(m, *costs(torch.tensor(goal)), iterations=12)
    xs, us = opt.optimize(ILQRParams(x0=torch.zeros(2), us_guess=torch.zeros(50, 1)))
    assert torch.isfinite(xs).all() and float(us.abs().max()) <= 2.0 + 1e-6
    assert abs(float(xs[-1, 0]) - float(want_xs[-1, 0])) <= 1e-4
    assert abs(float(xs[-1, 0]) - 0.7) < 0.03


def _ball_costs(diff, goal):
    """The pendulum case's costs on BALL_BODY's tangent state: 0.5 |x - goal|^2
    + 0.05 |u|^2 a knot, 50 |x_N - goal|^2 at the end, x - goal by
    `diff` (state_diff), toward 0.8 rad about y."""
    def running(x, u):
        dx = diff(x, goal)
        return 0.5 * (dx @ dx) + 0.05 * (u @ u)

    def terminal(x):
        dx = diff(x, goal)
        return 50.0 * (dx @ dx)

    return running, terminal


def test_ilqr_ball_joint_never_worse_than_guess_and_matches_jax():
    from ambersim_tpu.trajopt import ILQR as JaxILQR
    from ambersim_tpu.trajopt import ILQRParams as JaxParams
    from ambersim_tpu.trajopt import state_diff as jax_diff
    from ambersim_tpu_torch.trajopt import ILQR, ILQRParams, shoot, state_diff

    jm = tp.jax_model_from_xml(BALL_BODY)
    m = tp.torch_model(jm)
    assert (m.skel.nq, m.skel.nv) == (4, 3)
    goal = np.array([np.cos(0.4), 0.0, np.sin(0.4), 0.0, 0.0, 0.0, 0.0], np.float32)
    guess = 0.3 * np.random.default_rng(6).standard_normal((10, 3)).astype(np.float32)
    x0 = np.array([1.0, 0.0, 0.0, 0.0, 0.1, -0.2, 0.05], np.float32)
    jopt = JaxILQR(jm, *_ball_costs(lambda x, g: jax_diff(jm, x, g), jnp.asarray(goal)), iterations=1)
    _, want_us = jax.jit(jopt.optimize)(JaxParams(x0=jnp.asarray(x0), us_guess=jnp.asarray(guess)))
    opt = ILQR(m, *_ball_costs(lambda x, g: state_diff(m, x[None], g[None])[0], torch.tensor(goal)), iterations=1)
    xs, us = opt.optimize(ILQRParams(x0=torch.tensor(x0), us_guess=torch.tensor(guess)))
    xs_guess = shoot(m, torch.tensor(x0), torch.tensor(guess))
    assert float(opt._traj_cost(xs, us)) <= float(opt._traj_cost(xs_guess, torch.tensor(guess))) + 1e-6
    np.testing.assert_allclose(us.numpy(), np.asarray(want_us), rtol=1e-4, atol=1e-4)
