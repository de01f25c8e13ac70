"""Predictive sampling on the mesh hand (models/hand/hand_mesh.xml) in the
port against the JAX package (CPU): tests/test_models_parity.py:199-221's
smoke test, Newton 1 x 4 iterations with contacts enabled, 8 samples of 8
knots, x0 = 0, the zero guess and its StaticGoalQuadraticCost (goal
f1_prox 1 rad).

The hand's collision meshes are contype=1 conaffinity=2 and the file holds
no object (hand_mesh.xml:9-10, 24), so the model has no contact pair: the
case exercises the port's compile of the decomposed meshes, the four mimic
(joint equality) rows and kernel 4's plain version on them, not mesh-mesh
contact.

Both packages take the same samples: the JAX package's draws
(VanillaPredictiveSampler.optimize's stdev 0.2 normal noise from
PRNGKey(0), the guess first, clipped to the ctrlrange,
ambersim_tpu/trajopt/shooting.py:85-92) go to the port's `select`, whose
chosen index, xs_star and us_star are held against the JAX package's
optimize: the index and us_star exactly, xs_star's qpos within 1e-4 and
qvel within 1e-3 (the repo's rollout bars).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
NS, N, STDEV = 8, 8, 0.2
MESH_HAND = Path(__file__).resolve().parent.parent / "ambersim_tpu" / "models" / "hand" / "hand_mesh.xml"


def test_mesh_hand_sampler_picks_the_jax_sample():
    from ambersim_tpu.trajopt import StaticGoalQuadraticCost as JaxCost
    from ambersim_tpu.trajopt import VanillaPredictiveSampler as JaxSampler
    from ambersim_tpu.trajopt import VanillaPredictiveSamplerParams as JaxParams
    from ambersim_tpu.utils.io_utils import load_model_from_file as jax_load
    from ambersim_tpu_torch.trajopt import StaticGoalQuadraticCost, VanillaPredictiveSampler, shoot
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    torch.set_num_threads(1)
    jm = jax_load(str(MESH_HAND), solver="newton", iterations=1, ls_iterations=4)
    m = load_model_from_file(str(MESH_HAND), solver="newton", iterations=1, ls_iterations=4, device="cpu")
    s = m.skel
    assert s.ncon == 0 and s.neq == 4 and int(s.geom_type.tolist().count(7)) > 0  # meshes, no contact pair
    nx, nu = s.nq + s.nv, s.nu
    xg = np.zeros(nx, np.float32)
    xg[1] = 1.0
    weights = (0.1 * np.eye(nx, dtype=np.float32), 10.0 * np.eye(nx, dtype=np.float32),
               0.001 * np.eye(nu, dtype=np.float32), xg)
    key = jax.random.PRNGKey(0)
    jsampler = JaxSampler(model=jm, cost_function=JaxCost(*(jnp.asarray(w) for w in weights)), nsamples=NS,
                          stdev=STDEV)

    @jax.jit
    def run(x0, guess):
        noise = STDEV * jax.random.normal(key, (NS - 1, N, nu), guess.dtype)
        samples = jnp.concatenate([guess[None], guess[None] + noise], axis=0)
        limited = jnp.asarray(jm.skel.actuator_ctrllimited)
        samples = jnp.clip(samples, jnp.where(limited, jm.actuator_ctrlrange[:, 0], -jnp.inf),
                           jnp.where(limited, jm.actuator_ctrlrange[:, 1], jnp.inf))
        return samples, jsampler.optimize(JaxParams(x0=x0, us_guess=guess, rng=key))

    samples, (xs_star, us_star) = (jax.tree.map(np.array, r) for r in run(jnp.zeros(nx), jnp.zeros((N, nu))))
    best = int(np.nonzero((samples == us_star[None]).all((1, 2)))[0][0])
    cost = StaticGoalQuadraticCost(*(torch.as_tensor(w) for w in weights))
    sampler = VanillaPredictiveSampler(model=m, cost_function=cost, nsamples=NS, stdev=STDEV)
    x0 = torch.zeros(nx)
    got_xs, got_us, got_best = sampler.select(x0, torch.as_tensor(samples))
    # the JAX package's pick is not a near tie the rollout bars could flip
    costs = cost.cost(shoot(m, x0, torch.as_tensor(samples)), torch.as_tensor(samples))
    assert (costs - costs[best]).sort().values[1] > 1e-3 * float(costs[best])
    assert int(got_best) == best
    np.testing.assert_array_equal(got_us.numpy(), us_star)
    assert torch.isfinite(got_xs).all() and got_xs.shape == (N + 1, nx)
    np.testing.assert_allclose(got_xs[:, :s.nq].numpy(), xs_star[:, :s.nq], rtol=0, atol=QPOS_ATOL)
    np.testing.assert_allclose(got_xs[:, s.nq:].numpy(), xs_star[:, s.nq:], rtol=0, atol=QVEL_ATOL)
