"""benchmarks/ladder.py rung 5's humanoid predictive sampling
(:160-184: StaticGoalQuadraticCost with Q = 0.1 I, Qf = 10 I, R = 1e-4 I,
the goal and the start at (qpos0, 0), stdev 0.2), cut to 8 samples x 4
knots, against the JAX package on the CPU, with the Newton solve
converged (15 x 15 iterations):

  * `shoot` rolls the samples that the JAX package's sampler draws (its
    PRNG key, as VanillaPredictiveSampler.optimize draws them) out as one
    batch of 8 envs, against its vmap(shoot), at the main path's rollout
    bars (qpos atol 1e-4, qvel atol 1e-3); measured on a CPU: 1.2e-7 and
    1.7e-5;
  * `select` on those samples picks the index the JAX sampler's rule picks
    (the argmin of its cost over its rollouts, shooting.py), and its
    xs_star meets the JAX package's at the qpos bar.

At the humanoid's own 4 x 8 iterations (the ladder's) the solve stops
short of convergence at qpos0, where ~12 contacts sit within 4e-8 m of the
floor, and a take/keep decision of its last iteration turns on float32
rounding: one of the 8 samples then parts by 6.3e-3 in qvel after 4 steps
(the other seven by <= 1.7e-5). chip_smoke.py drives the sampler at those
options on the card and holds it against the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

NS, HORIZON, STDEV = 8, 4, 0.2
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
CONVERGED = dict(iterations=15, ls_iterations=15)


def _weights(jm):
    """The ladder's Q, Qf, R and goal, as numpy."""
    s = jm.skel
    nx = s.nq + s.nv
    xg = np.concatenate([np.asarray(jm.qpos0, np.float32), np.zeros(s.nv, np.float32)])
    eye = np.eye(nx, dtype=np.float32)
    return 0.1 * eye, 10.0 * eye, 1e-4 * np.eye(s.nu, dtype=np.float32), xg


@pytest.fixture(scope="module")
def case():
    from ambersim_tpu.trajopt import StaticGoalQuadraticCost as JaxCost
    from ambersim_tpu.trajopt import shoot as jax_shoot
    from ambersim_tpu_torch.trajopt import StaticGoalQuadraticCost

    torch.set_num_threads(1)
    jm = tp.with_solver(tp.jax_asset_model("humanoid"), **CONVERGED)
    weights = _weights(jm)
    nu = jm.skel.nu
    x0 = weights[3]
    cost = JaxCost(*(jnp.asarray(w) for w in weights))
    key = jax.random.PRNGKey(0)

    @jax.jit
    def run(x0, guess):
        # the draws of VanillaPredictiveSampler.optimize (ambersim_tpu/trajopt/shooting.py:85-92)
        noise = STDEV * jax.random.normal(key, (NS - 1, HORIZON, nu), guess.dtype)
        samples = jnp.concatenate([guess[None], guess[None] + noise], axis=0)
        limited = jnp.asarray(jm.skel.actuator_ctrllimited)
        samples = jnp.clip(samples, jnp.where(limited, jm.actuator_ctrlrange[:, 0], -jnp.inf),
                           jnp.where(limited, jm.actuator_ctrlrange[:, 1], jnp.inf))
        xs = jax.vmap(jax_shoot, in_axes=(None, None, 0))(jm, x0, samples)
        # VanillaPredictiveSampler.optimize's pick: the cheapest rollout
        best = jnp.argmin(jax.vmap(cost.cost)(xs, samples))
        return samples, xs, best

    guess = np.zeros((HORIZON, nu), np.float32)
    samples, xs, best = (np.array(r) for r in run(jnp.asarray(x0), jnp.asarray(guess)))
    return dict(tm=tp.torch_model(jm), x0=x0, samples=samples, xs=xs, xs_star=xs[int(best)], best=int(best),
                cost=StaticGoalQuadraticCost(*(torch.as_tensor(w) for w in weights)))


def test_shoot_matches_jax_vmap(case):
    from ambersim_tpu_torch.trajopt import shoot

    tm, nq = case["tm"], case["tm"].skel.nq
    got = shoot(tm, torch.as_tensor(case["x0"]), torch.as_tensor(case["samples"]))
    assert got.shape == (NS, HORIZON + 1, nq + tm.skel.nv) and torch.isfinite(got).all()
    tp.assert_close("shoot qpos", got[..., :nq], case["xs"][..., :nq], rtol=0.0, atol=QPOS_ATOL)
    tp.assert_close("shoot qvel", got[..., nq:], case["xs"][..., nq:], rtol=0.0, atol=QVEL_ATOL)


def test_sampler_picks_the_jax_index(case):
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSampler

    tm = case["tm"]
    sampler = VanillaPredictiveSampler(model=tm, cost_function=case["cost"], nsamples=NS, stdev=STDEV)
    xs_star, us_star, best = sampler.select(torch.as_tensor(case["x0"]), torch.as_tensor(case["samples"]))
    costs = case["cost"].cost(torch.as_tensor(case["xs"]), torch.as_tensor(case["samples"]))
    # the JAX package's pick is not a near tie the bars could flip
    assert (costs - costs[case["best"]]).sort().values[1] > 1e-3 * costs.abs().max()
    assert int(best) == case["best"]
    np.testing.assert_array_equal(us_star.numpy(), case["samples"][case["best"]])
    tp.assert_close("xs_star", xs_star[:, : tm.skel.nq], case["xs_star"][:, : tm.skel.nq], rtol=0.0, atol=QPOS_ATOL)
