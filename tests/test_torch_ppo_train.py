"""The PyTorch port's PPO trainer as a whole (CPU).

* Learner parity: one rollout buffer, the JAX package's initial params
  carried across, and the permutations and entropy normals replayed from
  the JAX keys exactly as ambersim_tpu/rl/ppo/train.py:177-231 splits them.
  The JAX side is compute_ppo_loss and optax.adam composed as those lines
  do. After 2 epochs x 4 minibatches the port's params are within rtol 1e-4
  of the JAX side's (atol 2.4e-7, see ATOL).
* End to end on the pendulum at tests/test_ppo_train.py's sizes: the
  progress_fn contract, finite metrics, checkpoint save/load/restore, and the
  inference function acting on obs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tools import torch_parity as tp

OBS, ACT = 5, 2
T, NUM_ENVS, NUM_UNROLLS, NUM_MINIBATCHES, EPOCHS = 8, 16, 2, 4, 2
TOTAL = NUM_ENVS * NUM_UNROLLS
BATCH = TOTAL // NUM_MINIBATCHES
LOSS_KW = dict(entropy_cost=1e-2, discounting=0.97, reward_scaling=0.1, gae_lambda=0.95, clipping_epsilon=0.3,
               normalize_advantage=True)
LR = 3e-4
# Adam moves a param by at most ~LR per step, so a param that starts at 0 (a
# bias) ends within EPOCHS * NUM_MINIBATCHES * LR of 0: rtol 1e-4 of that
# largest move is the absolute floor (measured worst: 9.6e-9 on a bias of 6e-5)
ATOL = 1e-4 * EPOCHS * NUM_MINIBATCHES * LR


def _jax_learner(jn, jparams, jnorm, data, key):
    """train.py:177-231 on one shard: per epoch split(key, 3) -> (key,
    key_perm, key_grad), one permutation, minibatches, and per minibatch
    split(key_grad) -> (key_grad, key_loss). Returns the final params and
    the permutations and entropy normals it drew."""
    from ambersim_tpu.rl.ppo import losses as jl

    opt = optax.adam(learning_rate=LR)
    opt_state = opt.init(jparams)
    params = jparams
    perms, noises = [], []
    for _ in range(EPOCHS):
        key, key_perm, key_grad = jax.random.split(key, 3)
        perm = jax.vmap(lambda k: jax.random.permutation(k, TOTAL))(jax.random.split(key_perm, 1))
        perms.append(np.asarray(perm[0]))

        def shuffle(x, perm=perm):
            xs = jnp.take_along_axis(x.reshape((T, 1, TOTAL) + x.shape[2:]),
                                     perm.reshape((1, 1, TOTAL) + (1,) * (x.ndim - 2)), axis=2)
            xs = jnp.moveaxis(xs.reshape((T, 1, NUM_MINIBATCHES, BATCH) + x.shape[2:]), 2, 0)
            return xs.reshape((NUM_MINIBATCHES, T, BATCH) + x.shape[2:])

        shuffled = jax.tree.map(shuffle, data)
        epoch_noise = []
        for mb in range(NUM_MINIBATCHES):
            key_grad, key_loss = jax.random.split(key_grad)
            epoch_noise.append(np.asarray(jax.random.normal(key_loss, (T, BATCH, ACT))))
            loss_fn = functools.partial(jl.compute_ppo_loss, normalizer_params=jnorm,
                                        data=jax.tree.map(lambda x: x[mb], shuffled), rng=key_loss,
                                        ppo_networks=jn, **LOSS_KW)
            grads = jax.grad(lambda p: loss_fn(p)[0])(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        noises.append(np.stack(epoch_noise))
    return params, np.stack(perms), np.stack(noises)


def test_learner_matches_jax():
    from ambersim_tpu.rl.ppo import losses as jl
    from ambersim_tpu.rl.ppo import networks as jnets
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.ppo import losses as tl
    from ambersim_tpu_torch.rl.ppo import networks as tnets
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs
    from ambersim_tpu_torch.rl.ppo.train import make_training_state, sgd_update

    torch.set_num_threads(1)
    jn = jnets.make_ppo_networks(OBS, ACT, preprocess_observations_fn=jrs.normalize)
    tn = tnets.make_ppo_networks(OBS, ACT, preprocess_observations_fn=trs.normalize)
    kp, kv = jax.random.split(jax.random.PRNGKey(21))
    jparams = {"policy": jn.policy_network.init(kp), "value": jn.value_network.init(kv)}
    buf = tp.ppo_rollout_buffer(22, jn, jparams, jrs.init_state(jnp.zeros(OBS)), T, TOTAL, OBS)
    jnorm = jrs.update(jrs.init_state(jnp.zeros(OBS)), jnp.asarray(buf["observation"]))
    want, perms, noises = _jax_learner(jn, jparams, jnorm, jl.Transition(**{k: jnp.asarray(v) for k, v in buf.items()}),
                                       jax.random.PRNGKey(23))
    assert perms.shape == (EPOCHS, TOTAL) and noises.shape == (EPOCHS, NUM_MINIBATCHES, T, BATCH, ACT)

    tnorm, tparams = ppo_params_from_jax(jax.tree.map(np.asarray, (jnorm, jparams)), device="cpu")
    ts = make_training_state(tparams, tnorm, LR)
    metrics = sgd_update(ts, tl.Transition(**{k: torch.as_tensor(v) for k, v in buf.items()}),
                         torch.as_tensor(perms).long(), torch.as_tensor(noises), tn, NUM_MINIBATCHES, **LOSS_KW)
    assert set(metrics) == {"total_loss", "policy_loss", "v_loss", "entropy_loss"}
    assert all(torch.isfinite(v) for v in metrics.values())
    want = ppo_params_from_jax(jax.tree.map(np.asarray, want), device="cpu")
    moved = 0.0
    for net in ("policy", "value"):
        for k, w in want[net].items():
            got = ts.params[net][k].detach()
            moved = max(moved, (got - tparams[net][k]).abs().max().item())
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4, atol=ATOL, err_msg=f"{net} {k}")
    assert moved > 1e-3  # 8 Adam steps at 3e-4 moved the params


PENDULUM_KW = dict(
    num_timesteps=2048, num_evals=2, reward_scaling=0.1, episode_length=50, normalize_observations=True,
    action_repeat=1, unroll_length=8, num_minibatches=4, num_updates_per_batch=2, discounting=0.95,
    learning_rate=3e-4, entropy_cost=1e-3, num_envs=16, num_eval_envs=8, batch_size=16, seed=0,
)


def test_pendulum_train_end_to_end(tmp_path):
    from ambersim_tpu_torch.io.checkpoint import load_arrays, load_params, save_arrays, save_params
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo import train

    torch.set_num_threads(1)
    calls = []
    ckpt = tmp_path / "state.pkl"
    make_policy, params, metrics = train(
        PendulumSwingupEnv(device="cpu"), progress_fn=lambda step, m: calls.append((step, m)),
        checkpoint_path=str(ckpt), device="cpu", **PENDULUM_KW,
    )
    # 16 envs x 8 steps x 4 unrolls = 512 env steps per training step; 4 steps before the second eval
    assert [step for step, _ in calls] == [0, 2048]
    assert set(calls[0][1]) == {"eval/episode_reward"}
    keys = {"eval/episode_reward", "training/total_loss", "training/policy_loss", "training/v_loss",
            "training/entropy_loss", "timing/rollout_s", "timing/sgd_s", "timing/eval_s"}
    assert set(metrics) == keys and metrics == calls[-1][1]
    assert all(np.isfinite(v) for v in metrics.values())
    normalizer, policy_params = params
    assert float(normalizer.count) == 2048.0
    assert not any(v.requires_grad for v in policy_params.values())

    # the inference function on obs, after a save/load round trip
    save_params(tmp_path / "params.pkl", params)
    params2 = load_params(tmp_path / "params.pkl", device="cpu")
    for k, v in policy_params.items():
        assert torch.equal(params2[1][k], v)
    obs = torch.zeros(4, 3)
    action, extras = make_policy(params2, deterministic=True)(obs)
    assert action.shape == (4, 1) and (action.abs() <= 1).all() and extras == {}
    action, extras = make_policy(params2)(obs, torch.Generator().manual_seed(0))
    assert action.shape == (4, 1) and extras["log_prob"].shape == (4,) and extras["raw_action"].shape == (4, 1)

    # data-only round trip
    save_arrays(tmp_path / "params.npz", params)
    params3 = load_arrays(tmp_path / "params.npz", params, device="cpu")
    assert torch.equal(params3[0].mean, normalizer.mean)

    # the checkpoint after each eval restores the whole training state
    saved = load_params(ckpt, device="cpu")
    assert saved["train_iters"] == 4 and float(saved["normalizer_params"].count) == 2048.0
    resumed = []
    train(PendulumSwingupEnv(device="cpu"), restore_checkpoint_path=str(ckpt), device="cpu",
          progress_fn=lambda step, m: resumed.append(step), **dict(PENDULUM_KW, num_timesteps=512))
    assert resumed == [0, 5 * 512]


def test_cuda_without_a_card_raises(monkeypatch):
    """The trainer never falls back to the CPU."""
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train(PendulumSwingupEnv(device="cpu"), device="cuda", **PENDULUM_KW)
