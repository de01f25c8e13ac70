"""Trajectory optimization of the PyTorch port against the JAX package (CPU).

  * StaticGoalQuadraticCost: cost, analytic gradient and block-diagonal
    Hessian against the JAX package's on numpy-seeded trajectories (rtol
    1e-5, atol 1e-5), batched over samples, and the CostFunction base's
    torch.func defaults against the analytic forms;
  * `shoot` on the hand at the predictive-sampling workload's options
    (BASELINE.md:13: Newton 1 x 4 iterations, dt 0.002, contacts
    disabled), 8 samples x 5 steps as one batch, against the JAX package's
    vmap(shoot) at the main path's rollout bars (qpos 1e-4, qvel 1e-3);
  * the sampler fed the samples the JAX package's sampler draws picks the
    index the JAX package picks;
  * the batched cost-decrease property of the JAX package's
    tests/trajopt/test_predictive_sampler.py, and the sampler's draws;
  * run_mpc and run_mpc_batch on the hand: shapes, the final Data, and a
    closed loop that ends nearer the goal than the open-loop solve replayed
    blindly (tests/trajopt/test_mpc.py:16-39's property).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

TOL = 1e-5
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
NS, HORIZON = 8, 5
TRAJOPT = dict(iterations=1, ls_iterations=4)
CONTACT = 1 << 4  # DisableBit.CONTACT


def _trajopt_options(m):
    return m.replace(opt=m.opt.replace(disableflags=m.opt.disableflags | CONTACT, **TRAJOPT))


def _weights(nx: int, nu: int, seed: int = 0):
    """tests/trajopt/test_predictive_sampler.py:36-41's Q, Qf, R and xg, as numpy."""
    xg = np.zeros(nx, np.float32)
    xg[0], xg[1] = 0.8, 0.5
    return (0.1 * np.eye(nx, dtype=np.float32), 10.0 * np.eye(nx, dtype=np.float32),
            0.001 * np.eye(nu, dtype=np.float32), xg)


def _costs(weights):
    from ambersim_tpu.trajopt import StaticGoalQuadraticCost as JaxCost
    from ambersim_tpu_torch.trajopt import StaticGoalQuadraticCost

    return (JaxCost(*(jnp.asarray(w) for w in weights)), StaticGoalQuadraticCost(*(torch.as_tensor(w) for w in weights)))


@pytest.fixture(scope="module")
def cost_case():
    rng = np.random.default_rng(20)
    n, m, N = 6, 3, 5
    weights = [rng.standard_normal((n, n)), rng.standard_normal((n, n)), rng.standard_normal((m, m)),
               rng.standard_normal(n)]
    weights = [w.astype(np.float32) for w in weights]
    xs = rng.standard_normal((4, N + 1, n)).astype(np.float32)
    us = rng.standard_normal((4, N, m)).astype(np.float32)
    return _costs(weights), xs, us


def test_cost_matches_jax(cost_case):
    (jc, tc), xs, us = cost_case
    want = np.stack([np.asarray(jc.cost(jnp.asarray(x), jnp.asarray(u))) for x, u in zip(xs, us)])
    tp.assert_close("cost", tc.cost(torch.as_tensor(xs), torch.as_tensor(us)), want, TOL, TOL)


def test_grad_matches_jax(cost_case):
    (jc, tc), xs, us = cost_case
    gx, gu = tc.grad(torch.as_tensor(xs), torch.as_tensor(us))
    for b in range(len(xs)):
        wx, wu = jc.grad(jnp.asarray(xs[b]), jnp.asarray(us[b]))
        tp.assert_close("grad x", gx[b], wx, TOL, TOL)
        tp.assert_close("grad u", gu[b], wu, TOL, TOL)


def test_hess_matches_jax(cost_case):
    (jc, tc), xs, us = cost_case
    got = tc.hess(torch.as_tensor(xs), torch.as_tensor(us))
    for b in range(len(xs)):
        for what, g, w in zip(("hxx", "huu", "hxu"), got, jc.hess(jnp.asarray(xs[b]), jnp.asarray(us[b]))):
            tp.assert_close(what, g[b], w, TOL, TOL)


def test_autodiff_defaults_match_analytic(cost_case):
    """CostFunction.grad / hess (torch.func) of the same cost give the
    analytic forms."""
    from ambersim_tpu_torch.trajopt import CostFunction

    (_, tc), xs, us = cost_case

    class Plain(CostFunction):
        def cost(self, xs, us):
            return tc.cost(xs, us)

    x, u = torch.as_tensor(xs[0]), torch.as_tensor(us[0])
    for what, g, w in zip(("gx", "gu"), Plain().grad(x, u), tc.grad(x, u)):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL, msg=what)
    for what, g, w in zip(("hxx", "huu", "hxu"), Plain().hess(x, u), tc.hess(x, u)):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL, msg=what)


@pytest.fixture(scope="module")
def hand():
    torch.set_num_threads(1)
    jm = _trajopt_options(tp.jax_asset_model("hand"))
    return jm, tp.torch_model(jm)


@pytest.fixture(scope="module")
def sampler_case(hand):
    """The JAX package's sampler (8 samples, 5 knots, stdev 0.3) on the hand
    from a seeded state and guess: its drawn samples, their vmap(shoot)
    rollouts and its optimize result, in one jit."""
    from ambersim_tpu.trajopt import VanillaPredictiveSampler as JaxSampler
    from ambersim_tpu.trajopt import VanillaPredictiveSamplerParams as JaxParams
    from ambersim_tpu.trajopt import shoot as jax_shoot

    jm, tm = hand
    nx, nu = jm.skel.nq + jm.skel.nv, jm.skel.nu
    rng = np.random.default_rng(21)
    x0 = np.concatenate([rng.uniform(0.0, 0.5, jm.skel.nq), 0.2 * rng.standard_normal(jm.skel.nv)]).astype(np.float32)
    guess = (0.5 * rng.standard_normal((HORIZON, nu))).astype(np.float32)
    jc, tc = _costs(_weights(nx, nu))
    sampler = JaxSampler(model=jm, cost_function=jc, nsamples=NS, stdev=0.3)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def run(x0, guess):
        # the draws of VanillaPredictiveSampler.optimize (ambersim_tpu/trajopt/shooting.py:85-92)
        noise = 0.3 * jax.random.normal(key, (NS - 1, HORIZON, nu), guess.dtype)
        samples = jnp.concatenate([guess[None], guess[None] + noise], axis=0)
        limited = jnp.asarray(jm.skel.actuator_ctrllimited)
        samples = jnp.clip(samples, jnp.where(limited, jm.actuator_ctrlrange[:, 0], -jnp.inf),
                           jnp.where(limited, jm.actuator_ctrlrange[:, 1], jnp.inf))
        xs = jax.vmap(jax_shoot, in_axes=(None, None, 0))(jm, x0, samples)
        return samples, xs, sampler.optimize(JaxParams(x0=x0, us_guess=guess, rng=key))

    samples, xs, (xs_star, us_star) = (jax.tree.map(np.array, r) for r in run(jnp.asarray(x0), jnp.asarray(guess)))
    best = int(np.nonzero((samples == us_star[None]).all((1, 2)))[0][0])
    return dict(x0=x0, guess=guess, samples=samples, xs=xs, xs_star=xs_star, best=best, cost=tc)


def test_shoot_matches_jax_vmap(hand, sampler_case):
    """shoot rolls the 8 samples out as one batch of 8 envs."""
    from ambersim_tpu_torch.trajopt import shoot

    _, tm = hand
    c = sampler_case
    got = shoot(tm, torch.as_tensor(c["x0"]), torch.as_tensor(c["samples"]))
    nq = tm.skel.nq
    assert got.shape == (NS, HORIZON + 1, 2 * nq) and torch.isfinite(got).all()
    tp.assert_close("shoot qpos", got[..., :nq], c["xs"][..., :nq], rtol=0.0, atol=QPOS_ATOL)
    tp.assert_close("shoot qvel", got[..., nq:], c["xs"][..., nq:], rtol=0.0, atol=QVEL_ATOL)
    # an unbatched tape gives the unbatched trajectory
    one = shoot(tm, torch.as_tensor(c["x0"]), torch.as_tensor(c["samples"][2]))
    assert one.shape == (HORIZON + 1, 2 * nq)
    torch.testing.assert_close(one, got[2], rtol=0.0, atol=1e-6)


def test_sampler_picks_the_jax_index(hand, sampler_case):
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSampler

    _, tm = hand
    c = sampler_case
    sampler = VanillaPredictiveSampler(model=tm, cost_function=c["cost"], nsamples=NS, stdev=0.3)
    xs_star, us_star, best = sampler.select(torch.as_tensor(c["x0"]), torch.as_tensor(c["samples"]))
    costs = c["cost"].cost(torch.as_tensor(c["xs"]), torch.as_tensor(c["samples"]))
    # the JAX package's pick is not a near tie the bars could flip
    assert (costs - costs[c["best"]]).sort().values[1] > 1e-3
    assert int(best) == c["best"]
    np.testing.assert_array_equal(us_star.numpy(), c["samples"][c["best"]])
    tp.assert_close("xs_star", xs_star[:, : tm.skel.nq], c["xs_star"][:, : tm.skel.nq], rtol=0.0, atol=QPOS_ATOL)


def _sampler(tm, nsamples=24, stdev=0.3, weights=_weights):
    from ambersim_tpu_torch.trajopt import StaticGoalQuadraticCost, VanillaPredictiveSampler

    nx, nu = tm.skel.nq + tm.skel.nv, tm.skel.nu
    cost = StaticGoalQuadraticCost(*(torch.as_tensor(w) for w in weights(nx, nu)))
    return VanillaPredictiveSampler(model=tm, cost_function=cost, nsamples=nsamples, stdev=stdev)


def mpc_weights(nx: int, nu: int):
    """The MPC task's Q = Qf: joint angles at 10 (as tests/trajopt/test_mpc.py
    weighs the pendulum's angle), joint velocities at 1e-3; R and xg as in
    _weights. At _weights' velocity weight (0.1 running, 10 terminal) the
    10-knot (0.02 s) horizon cannot move a finger without paying more for
    its speed than it gains in angle, so the sampler keeps the guess."""
    _, _, R, xg = _weights(nx, nu)
    w = np.diag(np.r_[np.full(nx // 2, 10.0), np.full(nx - nx // 2, 1e-3)]).astype(np.float32)
    return w, w, R, xg


def test_draws(hand):
    """Sample 0 is the (clipped) guess, every sample lies in the ctrlrange,
    and a generator seeded alike draws alike."""
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSamplerParams

    _, tm = hand
    sampler = _sampler(tm)
    guess = 3.0 * torch.as_tensor(np.random.default_rng(22).standard_normal((2, 10, 4)).astype(np.float32))

    def draw(seed):
        return sampler.draw_samples(VanillaPredictiveSamplerParams(
            x0=torch.zeros(2, 16), us_guess=guess, generator=torch.Generator().manual_seed(seed)))

    us = draw(0)
    assert us.shape == (2, 24, 10, 4)
    torch.testing.assert_close(us[:, 0], guess.clamp(-2.0, 2.0), rtol=0, atol=0)
    assert (us.abs() <= 2.0).all() and (us[:, 1:] != us[:, :1]).any()
    assert torch.equal(us, draw(0)) and not torch.equal(us, draw(1))


def test_cost_decrease_batched(hand):
    """Optimized cost <= guess cost for a batch of 8 problems solved at once
    (8 x 24 envs a step): sample 0 is the guess. The slack is the JAX
    package's own (tests/trajopt/test_predictive_sampler.py:84-87): the
    guess rolled out inside the batch and alone may round apart."""
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSamplerParams, shoot

    _, tm = hand
    sampler = _sampler(tm)
    rng = np.random.default_rng(23)
    x0s = torch.as_tensor((0.2 * rng.standard_normal((8, 16))).astype(np.float32))
    guess = torch.as_tensor((0.1 * rng.standard_normal((8, 10, 4))).astype(np.float32))
    params = VanillaPredictiveSamplerParams(x0=x0s, us_guess=guess, generator=torch.Generator().manual_seed(1))
    xs, us = sampler.optimize(params)
    assert xs.shape == (8, 11, 16) and us.shape == (8, 10, 4)
    cost_star = sampler.cost_function.cost(xs, us)
    cost_guess = sampler.cost_function.cost(shoot(tm, x0s, guess), guess)
    assert (cost_star <= cost_guess + 1e-5 + 1e-5 * cost_guess.abs()).all()
    assert (cost_star < cost_guess).any()


def _goal_error(x, xg):
    """Distance of the goal's two joint angles (f1_spread, f1_prox)."""
    return float(torch.linalg.vector_norm(x[..., :2] - xg[:2], dim=-1).max())


def test_mpc_beats_open_loop(hand):
    """20 control steps from rest (32 samples, stdev 0.5): the closed loop
    ends nearer the goal than the open-loop guess (the zero tape) and than
    the first solve's tape replayed blindly (padded with its last knot)."""
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSamplerParams, run_mpc, shoot

    _, tm = hand
    sampler = _sampler(tm, nsamples=32, stdev=0.5, weights=mpc_weights)
    x0, n_steps = torch.zeros(16), 20
    params = VanillaPredictiveSamplerParams(x0=x0, us_guess=torch.zeros(10, 4), generator=torch.Generator().manual_seed(0))
    xs, us, data = run_mpc(tm, sampler, params, n_steps)
    assert xs.shape == (n_steps + 1, 16) and us.shape == (n_steps, 4) and torch.isfinite(xs).all()
    torch.testing.assert_close(data.qpos[0], xs[-1, :8], rtol=0, atol=0)
    _, us_open = sampler.optimize(VanillaPredictiveSamplerParams(
        x0=x0, us_guess=torch.zeros(10, 4), generator=torch.Generator().manual_seed(0)))
    xs_open = shoot(tm, x0, torch.cat([us_open, us_open[-1:].expand(n_steps - 10, -1)]))
    xs_guess = shoot(tm, x0, torch.zeros(n_steps, 4))
    xg = sampler.cost_function.xg
    err = _goal_error(xs[-1], xg)
    assert err < _goal_error(xs_open[-1], xg) and err < _goal_error(xs_guess[-1], xg), err


def test_mpc_batch_over_initial_states(hand):
    """run_mpc_batch steps every problem's solve as one batch (3 x 32 envs)
    and its plant as 3 envs; each problem closes in on the goal, nearer than
    the zero tape takes it."""
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSamplerParams, run_mpc_batch, shoot

    _, tm = hand
    sampler = _sampler(tm, nsamples=32, stdev=0.5, weights=mpc_weights)
    x0s = torch.zeros(3, 16)
    x0s[:, :8] = torch.as_tensor(np.random.default_rng(24).uniform(0.0, 0.2, (3, 8)).astype(np.float32))
    params = VanillaPredictiveSamplerParams(x0=x0s, us_guess=torch.zeros(3, 10, 4),
                                            generator=torch.Generator().manual_seed(2))
    xs, us, data = run_mpc_batch(tm, sampler, params, 15)
    assert xs.shape == (3, 16, 16) and us.shape == (3, 15, 4) and data.qpos.shape == (3, 8)
    xg = sampler.cost_function.xg
    xs_guess = shoot(tm, x0s, torch.zeros(3, 15, 4))
    for b in range(3):
        assert _goal_error(xs[b, -1], xg) < min(_goal_error(xs[b, 0], xg), _goal_error(xs_guess[b, -1], xg))
