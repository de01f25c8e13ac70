"""ES of the PyTorch port against the JAX package (CPU).

  * `centered_rank` against the JAX package's on random arrays and on
    arrays with ties: the same values, bit for bit (both argsorts are
    stable);
  * the population rollout: 16 members of the pendulum, each with its own
    params (the JAX package's params perturbed by its mirrored noise,
    es/train.py:145-155, carried across with their leading population axis
    by io.bridge.ppo_params_from_jax), from the JAX env's reset states, 8
    control steps with an episode of 5 (so the `active` mask and the
    auto-reset both act), against es/train.py:112-138's rollout composed
    in JAX: returns within rtol 1e-5 (atol 1e-5), obs within 1e-5;
  * three updates from the same noise (JAX's draws, its keys split as
    es/train.py:140-155 splits them) and seeded returns and obs, against the
    JAX side composed as es/train.py:156-191 composes it (centered_rank,
    jnp.tensordot, optax.adam, the normalizer): params within rtol 1e-4 and
    atol 1e-3 x the learning rate (ATOL), the normalizer within rtol 1e-5,
    the mean fitness within rtol 1e-5 (float32 sums in another order);
  * a tiny run at tests/test_es_train.py:48-60's sizes: the progress_fn
    contract, finite metrics, bounded actions, and the checkpoint restored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tools import torch_parity as tp

POP, STD, L2, LR = 16, 0.05, 0.005, 0.02
HIDDEN = (8, 8)
ATOL = 1e-3 * LR


@pytest.mark.parametrize("case", ["random", "ties", "all_equal"])
def test_centered_rank_matches_jax(case):
    from ambersim_tpu.rl.es import centered_rank as jax_rank
    from ambersim_tpu_torch.rl.es import centered_rank

    rng = np.random.default_rng(0)
    f = {"random": rng.standard_normal(33), "ties": rng.integers(0, 4, 40).astype(float),
         "all_equal": np.full(8, 3.0)}[case].astype(np.float32)
    want = np.asarray(jax_rank(jnp.asarray(f)))
    got = centered_rank(torch.as_tensor(f)).numpy()
    np.testing.assert_array_equal(got, want)


def jax_population(jnets, jparams, key, population_size, std):
    """es/train.py:140-155: (key, key_noise, key_roll) = split(key, 3), one
    key per leaf, half normals, mirrored. Returns (eps, pop_params, key)."""
    key, key_noise, _ = jax.random.split(key, 3)
    leaves, treedef = jax.tree.flatten(jparams)
    noise_keys = jax.random.split(key_noise, len(leaves))
    half = population_size // 2
    eps_half = [jax.random.normal(k, (half,) + leaf.shape, leaf.dtype) for k, leaf in zip(noise_keys, leaves)]
    eps = jax.tree.unflatten(treedef, [jnp.concatenate([e, -e], axis=0) for e in eps_half])
    pop = jax.tree.map(lambda p, e: p[None] + std * e, jparams, eps)
    return eps, pop, key


def jax_population_rollout(jenv, jnets, pop, jnorm, state, steps, reward_shift=0.0):
    """es/train.py:112-138 (and ars/train.py:104-131 with reward_shift):
    vmapped apply over members, the mode, the active mask."""
    dist = jnets.parametric_action_distribution

    def step(carry, _):
        state, active, total, raw = carry
        logits = jax.vmap(lambda p, o: jnets.policy_network.apply(jnorm, p, o))(pop, state.obs)
        state = jenv.step(state, dist.mode(logits))
        total = total + (state.reward - reward_shift) * active
        raw = raw + state.reward * active
        active = active * (1 - state.done)
        return (state, active, total, raw), state.obs

    n = state.obs.shape[0]
    (_, _, total, raw), obs = jax.lax.scan(step, (state, jnp.ones(n), jnp.zeros(n), jnp.zeros(n)), None,
                                           length=steps)
    return total, raw, obs


def check_population_rollout(normalize: bool, reward_shift: float = 0.0, seed: int = 0):
    """The port's population_rollout against JAX's from carried-across
    population params and the JAX env's reset states (see the module
    docstring); shared with the ARS tests."""
    from ambersim_tpu.rl import wrappers as jwrappers
    from ambersim_tpu.rl.apg.train import make_deterministic_networks as jax_networks
    from ambersim_tpu.rl.pendulum import PendulumSwingupEnv as JaxPendulum
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl import wrappers
    from ambersim_tpu_torch.rl.apg import make_deterministic_networks
    from ambersim_tpu_torch.rl.es.train import population_rollout
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs

    torch.set_num_threads(1)
    steps, episode = 8, 5
    jkw = {"preprocess_observations_fn": jrs.normalize} if normalize else {}
    tkw = {"preprocess_observations_fn": trs.normalize} if normalize else {}
    jnets = jax_networks(3, 1, hidden_layer_sizes=HIDDEN, **jkw)
    tnets = make_deterministic_networks(3, 1, hidden_layer_sizes=HIDDEN, **tkw)
    jparams = jnets.policy_network.init(jax.random.PRNGKey(seed))
    _, pop, _ = jax_population(jnets, jparams, jax.random.PRNGKey(seed + 1), POP, 0.5)
    jnorm = None
    if normalize:
        obs = np.random.default_rng(seed).standard_normal((64, 3)).astype(np.float32) * [1.0, 1.0, 3.0]
        jnorm = jrs.update(jrs.init_state(jnp.zeros(3)), jnp.asarray(obs, jnp.float32))
    jenv = jwrappers.wrap_for_training(JaxPendulum(), episode_length=episode)
    jstate = tp.jax_env_reset(jenv, POP, seed + 2)
    want = jax.jit(lambda pop, jnorm, s: jax_population_rollout(jenv, jnets, pop, jnorm, s, steps, reward_shift))(
        pop, jnorm, jstate)

    env = wrappers.wrap_for_training(PendulumSwingupEnv(device="cpu"), episode_length=episode)
    state = env.reset_to(torch.tensor(np.asarray(jstate.pipeline_state.qpos)),
                         torch.tensor(np.asarray(jstate.pipeline_state.qvel)))
    tpop = ppo_params_from_jax(jax.device_get(pop), "cpu")
    assert tpop["hidden.0.weight"].shape == (POP, HIDDEN[0], 3)
    tnorm = ppo_params_from_jax(jax.device_get(jnorm), "cpu") if normalize else None
    got = population_rollout(env, tnets, tpop, tnorm, state, steps, reward_shift)
    for name, g, w in zip(("returns", "raw returns", "obs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    return got


def test_population_rollout_matches_jax():
    check_population_rollout(normalize=False)


def test_es_updates_match_jax():
    from ambersim_tpu.rl.apg.train import make_deterministic_networks as jax_networks
    from ambersim_tpu.rl.es import centered_rank as jax_rank
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.es.train import es_update, make_training_state
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs

    torch.set_num_threads(1)
    jnets = jax_networks(3, 1, hidden_layer_sizes=HIDDEN)
    jparams = jnets.policy_network.init(jax.random.PRNGKey(3))
    optimizer = optax.adam(learning_rate=LR)
    opt_state = optimizer.init(jparams)
    jnorm = jrs.init_state(jnp.zeros(3))
    ts = make_training_state(ppo_params_from_jax(jax.device_get(jparams), "cpu"), trs.init_state(torch.zeros(3)), LR)
    start = {k: v.clone() for k, v in ts.policy_params.items()}
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(5)
    for _ in range(3):
        eps, _, key = jax_population(jnets, jparams, key, POP, STD)
        returns = rng.standard_normal(POP).astype(np.float32)
        obs = rng.standard_normal((8, POP, 3)).astype(np.float32)
        # es/train.py:157-180
        weights = jax_rank(jnp.asarray(returns))
        grad = jax.tree.map(lambda e, p: -(jnp.tensordot(weights, e, axes=1) / (POP * STD)) + L2 * p, eps, jparams)
        updates, opt_state = optimizer.update(grad, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jnorm = jrs.update(jnorm, jnp.asarray(obs).reshape((-1, 3)))

        metrics = es_update(ts, ppo_params_from_jax(jax.device_get(eps), "cpu"), torch.as_tensor(returns),
                            torch.as_tensor(obs), STD, L2, normalize_observations=True)
        np.testing.assert_allclose(metrics["fitness_mean"].item(), returns.mean(), rtol=1e-5)
        assert metrics["fitness_max"].item() == returns.max()
    want = ppo_params_from_jax(jax.device_get(jparams), "cpu")
    for k, w in want.items():
        np.testing.assert_allclose(ts.policy_params[k].numpy(), w.numpy(), rtol=1e-4, atol=ATOL, err_msg=k)
    assert max((ts.policy_params[k] - v).abs().max().item() for k, v in start.items()) > 2 * LR
    assert ts.train_iters == 3
    for f in ("count", "mean", "summed_variance", "std"):
        np.testing.assert_allclose(getattr(ts.normalizer_params, f).numpy(), np.asarray(getattr(jnorm, f)),
                                   rtol=1e-5, err_msg=f)


def test_es_train_end_to_end(tmp_path):
    """tests/test_es_train.py:48-60's sizes: two progress calls at 0 and
    4 updates x 16 members x 24 steps, finite metrics, bounded actions; the
    checkpoint restores the state and resumes the step count."""
    from ambersim_tpu_torch.io.checkpoint import load_params
    from ambersim_tpu_torch.rl.es import train
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    torch.set_num_threads(1)
    kw = dict(episode_length=24, population_size=16, perturbation_std=0.05, learning_rate=0.02, num_eval_envs=8,
              policy_updates=4, num_evals=2, seed=0, device="cpu")
    progress = []
    ckpt = tmp_path / "es.pkl"
    make_policy, params, metrics = train(PendulumSwingupEnv(device="cpu"), checkpoint_path=str(ckpt),
                                         progress_fn=lambda step, m: progress.append((step, m)), **kw)
    assert [s for s, _ in progress] == [0, 4 * 16 * 24]
    assert set(progress[0][1]) == {"eval/episode_reward"}
    assert set(metrics) == {"eval/episode_reward", "training/fitness_mean", "training/fitness_max",
                            "timing/rollout_s", "timing/update_s", "timing/eval_s"}
    assert all(np.isfinite(v) for v in metrics.values())
    act, _ = make_policy(params, deterministic=True)(torch.randn(5, 3))
    assert act.shape == (5, 1) and torch.all(act.abs() <= 1.0)
    saved = load_params(ckpt, device="cpu")
    assert saved["train_iters"] == 4 and set(saved) == {"policy_params", "optimizer", "normalizer_params",
                                                        "train_iters"}
    resumed = []
    _, params2, _ = train(PendulumSwingupEnv(device="cpu"), restore_checkpoint_path=str(ckpt),
                          progress_fn=lambda step, m: resumed.append(step), **dict(kw, policy_updates=1, num_evals=1))
    assert resumed == [5 * 16 * 24]


def test_es_refusals(monkeypatch):
    from ambersim_tpu_torch.rl.es import train
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    env = PendulumSwingupEnv(device="cpu")
    with pytest.raises(ValueError, match="even"):
        train(env, population_size=3, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1: multi-GPU"):
        train(env, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train(env, device="cuda")
