"""APG of the PyTorch port against the JAX package (CPU).

  * the networks are policy-only (tests/test_apg_train.py:14-17), and the
    deterministic bundle's head is the action itself;
  * the 4-step pendulum gradient of tests/test_apg_train.py:20-45, from the
    JAX package's params carried across (io.bridge.ppo_params_from_jax) and
    its reset states, through the port's checkpointed rollout
    (apg.train.rollout_loss), against jax.grad (rtol 1e-4 of each leaf's
    largest |g|);
  * a tiny train run at tests/test_apg_train.py:48-70's settings improves
    the training loss, and its policy's actions stay in [-1, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

GRAD_RTOL = 1e-4  # of each leaf's largest |g|


def test_apg_networks_policy_only():
    from ambersim_tpu_torch.rl.apg import make_apg_networks, make_deterministic_networks

    nets = make_apg_networks(observation_size=3, action_size=2)
    assert nets.parametric_action_distribution.param_size == 4
    assert nets.value_network.init(torch.Generator().manual_seed(0)) == {}
    assert torch.equal(nets.value_network.apply(None, {}, torch.ones(5, 3)), torch.zeros(5))
    det = make_deterministic_networks(observation_size=3, action_size=2)
    assert det.parametric_action_distribution.param_size == 2
    params = det.policy_network.init(torch.Generator().manual_seed(0))
    assert det.policy_network.apply(None, params, torch.ones(5, 3)).shape == (5, 2)


def test_apg_gradient_matches_jax():
    from ambersim_tpu.rl import wrappers as jwrappers
    from ambersim_tpu.rl.apg import make_apg_networks as jax_networks
    from ambersim_tpu.rl.pendulum import PendulumSwingupEnv as JaxPendulum
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax, ppo_params_to_numpy
    from ambersim_tpu_torch.rl import wrappers
    from ambersim_tpu_torch.rl.apg import make_apg_networks
    from ambersim_tpu_torch.rl.apg.train import rollout_loss
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    jenv = jwrappers.wrap_for_training(JaxPendulum(), episode_length=8, action_repeat=1)
    jnets = jax_networks(observation_size=3, action_size=1, hidden_layer_sizes=(16,))
    jparams = jnets.policy_network.init(jax.random.PRNGKey(0))
    jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), 2))

    def loss(p, state):
        def step(s, _):
            act = jnets.parametric_action_distribution.mode(jnets.policy_network.apply(None, p, s.obs))
            s = jenv.step(s, act)
            return s, s.reward

        _, rewards = jax.lax.scan(step, state, None, length=4)
        return -jnp.mean(jnp.sum(rewards, axis=0))

    want_loss, want = jax.jit(jax.value_and_grad(loss))(jparams, jstate)

    env = wrappers.wrap_for_training(PendulumSwingupEnv(device="cpu"), episode_length=8)
    nets = make_apg_networks(observation_size=3, action_size=1, hidden_layer_sizes=(16,))
    params = {k: v.requires_grad_(True) for k, v in ppo_params_from_jax(jax.device_get(jparams), "cpu").items()}
    state = env.reset_to(torch.tensor(np.asarray(jstate.pipeline_state.qpos)),
                         torch.tensor(np.asarray(jstate.pipeline_state.qvel)))
    got_loss, _, obs = rollout_loss(env, nets, params, None, state, 4)
    grads = torch.autograd.grad(got_loss, list(params.values()))
    got = ppo_params_to_numpy(dict(zip(params, grads)))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert obs.shape == (4, 2, 3)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(), err_msg=str(path))


def test_apg_smoke_improves_objective():
    from ambersim_tpu_torch.rl.apg import train
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    losses = []
    make_policy, params, metrics = train(
        environment=PendulumSwingupEnv(device="cpu"), episode_length=24, num_envs=8, num_eval_envs=8,
        policy_updates=8, learning_rate=5e-3, max_gradient_norm=1.0, num_evals=3, seed=0, device="cpu",
        progress_fn=lambda step, m: losses.append(m.get("training/episode_loss")),
    )
    assert np.isfinite(metrics["eval/episode_reward"]) and np.isfinite(metrics["training/grad_norm"])
    real = [x for x in losses if x is not None]
    assert len(real) >= 2 and np.isfinite(real).all()
    assert real[-1] < real[0]
    act, _ = make_policy(params, deterministic=True)(torch.zeros(1, 3))
    assert torch.all(act.abs() <= 1.0)
