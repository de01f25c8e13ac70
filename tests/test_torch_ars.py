"""ARS of the PyTorch port against the JAX package (CPU).

  * the candidates' rollout with the normalizer on and a reward shift: 16
    candidates of the pendulum from carried-across params with a leading
    axis and the JAX env's reset states, 8 control steps (an episode of 5),
    against ars/train.py:104-131's rollout composed in JAX: shifted and raw
    returns within rtol 1e-5 (atol 1e-5), obs within 1e-5;
  * three V2-t updates from the same directions (JAX's draws, its keys
    split as ars/train.py:135-153 splits them), seeded returns and obs,
    against the JAX side composed as ars/train.py:155-175 composes it
    (lax.top_k, jnp.std, jnp.tensordot, the normalizer): params within
    rtol 1e-4 and atol 1e-3 x the step size, reward_std within rtol 1e-6,
    the fitness means within rtol 1e-5 (float32 sums in another order);
    one case with tied scores, where the selection must match top_k's
    (ties to the lower index) index for index;
  * a tiny run at tests/test_ars_train.py:51-60's sizes: the progress_fn
    contract, finite metrics, bounded actions; the top_directions refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_es import HIDDEN, check_population_rollout

N_DIRS, TOP, STEP = 8, 3, 0.02
ATOL = 1e-3 * STEP


def test_candidate_rollout_matches_jax():
    check_population_rollout(normalize=True, reward_shift=0.7, seed=5)


def jax_directions(jparams, key):
    """ars/train.py:135-145: (key, key_noise, key_roll) = split(key, 3), one
    key per leaf, N_DIRS normals of its shape."""
    key, key_noise, _ = jax.random.split(key, 3)
    leaves, treedef = jax.tree.flatten(jparams)
    noise_keys = jax.random.split(key_noise, len(leaves))
    deltas = jax.tree.unflatten(
        treedef, [jax.random.normal(k, (N_DIRS,) + leaf.shape, leaf.dtype) for k, leaf in zip(noise_keys, leaves)])
    return deltas, key


def jax_ars_update(jparams, deltas, returns):
    """ars/train.py:155-169; returns the new params, the kept indices and
    reward_std."""
    r_plus, r_minus = returns[:N_DIRS], returns[N_DIRS:]
    _, top_idx = jax.lax.top_k(jnp.maximum(r_plus, r_minus), TOP)
    rp, rm = r_plus[top_idx], r_minus[top_idx]
    reward_std = jnp.maximum(jnp.std(jnp.concatenate([rp, rm])), 1e-6)
    coeff = STEP / (TOP * reward_std)
    params = jax.tree.map(lambda p, d: p + coeff * jnp.tensordot(rp - rm, d[top_idx], axes=1), jparams, deltas)
    return params, np.asarray(top_idx), float(reward_std)


@pytest.mark.parametrize("ties", [False, True])
def test_ars_updates_match_jax(ties):
    from ambersim_tpu.rl.apg.train import make_deterministic_networks as jax_networks
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.ars.train import TrainingState, ars_update, top_directions_of
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs

    torch.set_num_threads(1)
    jnets = jax_networks(3, 1, hidden_layer_sizes=HIDDEN)
    jparams = jnets.policy_network.init(jax.random.PRNGKey(7))
    jnorm = jrs.init_state(jnp.zeros(3))
    ts = TrainingState(policy_params=ppo_params_from_jax(jax.device_get(jparams), "cpu"),
                       normalizer_params=trs.init_state(torch.zeros(3)))
    start = {k: v.clone() for k, v in ts.policy_params.items()}
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(9)
    for _ in range(3):
        deltas, key = jax_directions(jparams, key)
        if ties:
            # few distinct values: max(r+, r-) ties across directions, and the
            # kept set depends on the order among ties
            returns = rng.integers(0, 3, 2 * N_DIRS).astype(np.float32)
        else:
            returns = (10 * rng.standard_normal(2 * N_DIRS)).astype(np.float32)
        raw = returns + 0.5
        obs = rng.standard_normal((8, 2 * N_DIRS, 3)).astype(np.float32)
        jparams, top_idx, reward_std = jax_ars_update(jparams, deltas, jnp.asarray(returns))
        jnorm = jrs.update(jnorm, jnp.asarray(obs).reshape((-1, 3)))

        scores = torch.maximum(torch.as_tensor(returns[:N_DIRS]), torch.as_tensor(returns[N_DIRS:]))
        np.testing.assert_array_equal(top_directions_of(scores, TOP).numpy(), top_idx)
        metrics = ars_update(ts, ppo_params_from_jax(jax.device_get(deltas), "cpu"), torch.as_tensor(returns),
                             torch.as_tensor(raw), torch.as_tensor(obs), TOP, STEP)
        np.testing.assert_allclose(metrics["reward_std"].item(), reward_std, rtol=1e-6)
        raw_scores = np.maximum(raw[:N_DIRS], raw[N_DIRS:])
        np.testing.assert_allclose(metrics["fitness_top"].item(), raw_scores[top_idx].mean(), rtol=1e-5)
        np.testing.assert_allclose(metrics["fitness_mean"].item(), raw.mean(), rtol=1e-5)
    if ties:
        assert len(set(np.maximum(returns[:N_DIRS], returns[N_DIRS:]).tolist())) < N_DIRS
    want = ppo_params_from_jax(jax.device_get(jparams), "cpu")
    for k, w in want.items():
        np.testing.assert_allclose(ts.policy_params[k].numpy(), w.numpy(), rtol=1e-4, atol=ATOL, err_msg=k)
    assert max((ts.policy_params[k] - v).abs().max().item() for k, v in start.items()) > STEP
    for f in ("count", "mean", "summed_variance", "std"):
        np.testing.assert_allclose(getattr(ts.normalizer_params, f).numpy(), np.asarray(getattr(jnorm, f)),
                                   rtol=1e-5, err_msg=f)


def test_reward_std_is_the_population_std():
    """ddof 0, as jnp.std: torch's default (ddof 1) would scale every step."""
    from ambersim_tpu.rl.apg.train import make_deterministic_networks as jax_networks
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.ars.train import TrainingState, ars_update
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs

    jparams = jax_networks(3, 1, hidden_layer_sizes=HIDDEN).policy_network.init(jax.random.PRNGKey(0))
    ts = TrainingState(policy_params=ppo_params_from_jax(jax.device_get(jparams), "cpu"),
                       normalizer_params=trs.init_state(torch.zeros(3)))
    deltas = {k: torch.ones((N_DIRS,) + v.shape) for k, v in ts.policy_params.items()}
    returns = torch.arange(2 * N_DIRS, dtype=torch.float32)
    m = ars_update(ts, deltas, returns, returns, torch.zeros(1, 2 * N_DIRS, 3), TOP, STEP)
    kept = torch.tensor([7.0, 6.0, 5.0, 15.0, 14.0, 13.0])
    assert m["reward_std"].item() == pytest.approx(float(np.std(kept.numpy())), rel=1e-6)
    assert m["reward_std"].item() != pytest.approx(float(kept.std()), rel=1e-3)


def test_ars_train_end_to_end():
    from ambersim_tpu_torch.rl.ars import train
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    torch.set_num_threads(1)
    progress = []
    make_policy, params, metrics = train(
        PendulumSwingupEnv(device="cpu"), episode_length=24, number_of_directions=8, top_directions=4,
        step_size=0.02, exploration_noise_std=0.05, num_eval_envs=8, policy_updates=4, num_evals=2,
        normalize_observations=True, seed=0, device="cpu", progress_fn=lambda step, m: progress.append((step, m)),
    )
    assert [s for s, _ in progress] == [0, 4 * 16 * 24]
    assert set(metrics) == {"eval/episode_reward", "training/fitness_mean", "training/fitness_top",
                            "training/reward_std", "timing/rollout_s", "timing/update_s", "timing/eval_s"}
    assert all(np.isfinite(v) for v in metrics.values())
    normalizer, policy_params = params
    assert float(normalizer.count) == 4 * 16 * 24
    act, _ = make_policy(params, deterministic=True)(torch.randn(5, 3))
    assert act.shape == (5, 1) and torch.all(act.abs() <= 1.0)


def test_ars_validates_top_directions():
    from ambersim_tpu_torch.rl.ars import train
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    with pytest.raises(ValueError, match="top_directions"):
        train(PendulumSwingupEnv(device="cpu"), number_of_directions=4, top_directions=8, policy_updates=1,
              device="cpu")
