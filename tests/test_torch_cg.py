"""The port's CG solver (engine/solver._solve_cg) against the JAX package's
(ambersim_tpu/engine/solver.py:1024-1086) on the CPU: the quadruped, tests/
test_constraint_parity.py's BALL_PLANE at 20 iterations, and one gradient
through three CG steps against jax.grad, and the quadruped's gradient
through its contact rows against jax.grad. The elliptic cases are in
test_torch_cg_elliptic.py.

The quadruped runs at CONVERGED_CG (15 x 15). At the model's own 3 x 6 the
JAX package's CG is chaotic in its line search: from the main path's start
the bracketed Newton on t takes t = 2.009 (the cost up 330x, the step
rejected) eagerly and t = 0.0185 under jit on the same env, and the two
runs end 474 apart in qacc; the port follows the eager run there. Bars: the
repo's rollout bars (qpos 1e-4, qvel 1e-3, tools/solver_parity.py); at
15 x 15 the port meets the JAX package's jitted step within 1.4e-6 in qpos
and 2e-4 in qvel after 5 steps on the quadruped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tools import grad_spread
from tools import solver_parity as sp
from tools import torch_parity as tp
from tools.weld_parity import np_batch

GRAD_TOL = 1e-4  # of the largest |g| (tests/test_torch_grad.py)
B = 4
BALL_PLANE = chip_smoke.tests_xml("test_constraint_parity.py", "BALL_PLANE")
# tests/test_inverse.py's pendulum: a motor, damping, a frictionloss row and a limited range
PENDULUM = chip_smoke.tests_xml("test_inverse.py", "PENDULUM")


def test_quadruped_cg_rollout():
    """The quadruped under CG, 4 envs x 5 steps from the main path's start
    under its PD controller; every step within the rollout bars."""
    jm = sp.quick_jax_model(sp.quadruped_xml(), **sp.CONVERGED_CG)
    d, jd = sp.rollout(jm, sp.quadruped_start(jm, seed=3), 5, pd=True)
    assert tp.torch_model(jm).opt.solver == sp.CG and bool(d.efc_active.any())


def test_ball_plane_cg():
    """BALL_PLANE under CG at 20 iterations (its own 50 line-search steps):
    4 envs x 20 steps from seeded velocities, the ball 1 mm into the floor."""
    jm = sp.quick_jax_model(BALL_PLANE, solver=sp.CG, iterations=20)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    qpos[:, 2] = 0.099
    qvel = 0.5 * np.random.default_rng(5).standard_normal((B, jm.skel.nv)).astype(np.float32)
    sp.rollout(jm, np_batch(jm, qpos=qpos, qvel=qvel), 20, pd=False)


def test_cg_gradient_matches_jax():
    """d(sum qpos + sum qvel)/d(ctrl) through 3 CG steps of the limited pendulum, its
    frictionloss and limit rows active, against jax.grad of the JAX
    package's vmapped step, within GRAD_TOL of the largest |g|, at 50 x 50:
    at 15 x 15 the two packages' CG iterates part by up to 1% of |g| on
    two of the four envs (8e-7 at 50 x 50, as under Newton)."""
    from ambersim_tpu.engine import step as jax_step
    from ambersim_tpu_torch.engine import make_data, step

    jm = sp.quick_jax_model(PENDULUM, solver=sp.CG, iterations=50, ls_iterations=50)
    tm = tp.torch_model(jm)
    T = 3
    rng = np.random.default_rng(6)
    qpos = np.asarray([[2.49], [-2.49], [0.3], [-1.0]], np.float32)
    qvel = np.asarray([[0.5], [-0.5], [0.01], [-2.0]], np.float32)
    ctrl = 0.3 * rng.standard_normal((T, B, 1)).astype(np.float32)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)

    def loss(u):
        d, _ = jax.lax.scan(lambda d, uk: (jax.vmap(jax_step, (None, 0))(jm, d.replace(ctrl=uk)), None), jd, u)
        return d.qpos.sum() + d.qvel.sum()

    want = np.asarray(sp.compiled(jax.grad(loss), jnp.asarray(ctrl))(jnp.asarray(ctrl)))
    u = torch.tensor(ctrl, requires_grad=True)
    d = make_data(tm, B).replace(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    for k in range(T):
        d = step(tm, d.replace(ctrl=u[k]))
    assert bool(d.efc_active.all(1).any())
    (d.qpos.sum() + d.qvel.sum()).backward()
    got = u.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= GRAD_TOL * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("iterations,ls_iterations", [(1, 4), (3, 2)])
def test_quadruped_cg_gradient_matches_jax(iterations, ls_iterations):
    """d(sum qpos + sum qvel after one step)/d(ctrl, qvel0) of the quadruped
    under CG from the main path's start, its feet's contact rows active,
    against jax.grad of the JAX package's step (tools/grad_spread.py's
    setup and helpers, 4 envs), within GRAD_TOL of each input's largest
    |g|: at chip_smoke.GRAD_PATHS' quadruped_cg options (3 x 2) and at 1 x
    4. No bar holds at 15 x 15: there the converged solve's unrolled
    gradient moves by 0.17 of the largest |g| in the JAX package's own
    float64 under a 1e-9 nudge of qvel0 (tools/grad_spread.py)."""
    from ambersim_tpu_torch.engine import make_data, step

    jm, qpos, u = grad_spread._setup(iterations, ls_iterations, B, 1)
    tm = tp.torch_model(jm)
    d = step(tm, make_data(tm, B).replace(qpos=torch.tensor(qpos), ctrl=torch.tensor(u[0])))
    assert bool(d.efc_active[:, int(tm.skel.ne + tm.skel.nf):].any(1).all())
    want = grad_spread.jax_grads(jm, qpos, u, jnp.float32)
    got = grad_spread.port_grads(jm, qpos, u, torch.float32)
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.abs(w).max() > 0
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), np.abs(g - w).max() / np.abs(w).max()
