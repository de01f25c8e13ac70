"""SAC of the PyTorch port against the JAX package (CPU).

  * the replay ring buffer: tests/test_sac_train.py:15-26's inserts and
    wrap, every field bit for bit against the JAX package's buffer, the
    capacity refusal, and a gather from JAX's own sample indices bit for
    bit;
  * the twin-Q network: stacked shapes, independent heads, and both
    critics and the policy applied from JAX's params carried across
    (rtol 1e-5, atol 1e-5);
  * the three losses and their gradients from JAX's params (carried across
    with io.bridge.sac_state_from_jax), a fitted normalizer and JAX's own
    normals, against jax.value_and_grad: values within rtol 1e-5 (atol
    1e-6), gradients within GRAD_RTOL of each leaf's largest |g|, as
    test_torch_apg.py holds them; over all-truncated transitions the
    critic loss is exactly 0;
  * three SGD steps (`sac.train.sgd_step`) against the JAX side composed as
    ambersim_tpu/rl/sac/train.py:164-220 composes them, the keys split as
    there (key_sample replayed as buffer indices, key_alpha, key_critic and
    key_actor as normals): policy, critic, target and log_alpha params
    within rtol 1e-4 and atol 1e-3 x the learning rate (ATOL), the losses
    within rtol 1e-4. The learning rate is large (1e-2) so that an actor
    reading the stepped critic, or a target aliasing the critic, moves the
    params past those bars;
  * a tiny run at tests/test_sac_train.py:91-131's sizes: the progress_fn
    contract, finite metrics, bounded actions, and the checkpoint saved
    and restored.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

OBS, ACT, B, HIDDEN = 5, 2, 32, (16, 16)
CAPACITY = 64
LR = 1e-2
ATOL = 1e-3 * LR
GRAD_RTOL = 1e-4  # of each leaf's largest |g|
LOSS_KW = dict(reward_scaling=0.1, discounting=0.97)
TAU = 0.005


def _jax_transition(rng, n):
    from ambersim_tpu.rl.sac.losses import Transition

    truncation = (rng.uniform(size=n) < 0.2).astype(np.float32)
    done = np.maximum((rng.uniform(size=n) < 0.2).astype(np.float32), truncation)
    return Transition(
        observation=(2 * rng.standard_normal((n, OBS))).astype(np.float32),
        action=rng.standard_normal((n, ACT)).astype(np.float32),
        reward=rng.standard_normal(n).astype(np.float32), discount=1 - done, truncation=truncation,
        next_observation=(2 * rng.standard_normal((n, OBS))).astype(np.float32),
    )


def _torch_transition(jt):
    from ambersim_tpu_torch.rl.sac.losses import Transition

    return Transition(**{f.name: torch.as_tensor(np.asarray(getattr(jt, f.name))) for f in dataclasses.fields(Transition)})


def test_replay_ring_buffer_matches_jax():
    from ambersim_tpu.rl.sac import replay as jreplay
    from ambersim_tpu_torch.rl.sac import replay

    rng = np.random.default_rng(0)
    one = jax.tree.map(lambda x: x[0], _jax_transition(rng, 1))
    jstate = jreplay.init(8, one)
    state = replay.init(8, _torch_transition(one))
    assert state.capacity == 8 and state.data.observation.shape == (8, OBS)
    first = _jax_transition(rng, 5)
    for batch in (first, jax.tree.map(lambda x: x + 100, first)):
        jstate = jreplay.insert(jstate, batch)
        state = replay.insert(state, _torch_transition(batch))
        assert (state.size, state.insert_position) == (int(jstate.size), int(jstate.insert_position))
        for f in dataclasses.fields(state.data):
            np.testing.assert_array_equal(getattr(state.data, f.name).numpy(), np.asarray(getattr(jstate.data, f.name)))
    # the second insert wrapped: slots 5, 6, 7, 0, 1 overwritten, 2 survives
    assert (state.size, state.insert_position) == (8, 2)
    np.testing.assert_array_equal(state.data.reward[0].numpy(), first.reward[3] + 100)
    np.testing.assert_array_equal(state.data.reward[2].numpy(), first.reward[2])
    with pytest.raises(ValueError, match="exceeds buffer capacity 8"):
        replay.insert(state, _torch_transition(_jax_transition(rng, 9)))

    key = jax.random.PRNGKey(3)
    want = jreplay.sample(jstate, key, 16)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jstate.size, 1))  # replay.py:56
    got = replay.sample(state, torch.as_tensor(np.array(idx)))
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)))
    drawn = replay.sample(state, torch.Generator().manual_seed(0), 16)
    assert drawn.observation.shape == (16, OBS) and drawn.reward.shape == (16,)


def test_twin_q_network_and_policy():
    from ambersim_tpu.rl.sac import make_sac_networks as jax_sac_networks
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.sac import make_inference_fn, make_sac_networks

    torch.set_num_threads(1)
    nets = make_sac_networks(OBS, ACT, hidden_layer_sizes=HIDDEN)
    qp = nets.q_network.init(torch.Generator().manual_seed(0))
    assert qp["hidden.0.weight"].shape == (2, HIDDEN[0], OBS + ACT) and qp["hidden.2.bias"].shape == (2, 1)
    obs, act = torch.randn(7, OBS), torch.rand(7, ACT) * 2 - 1
    q = nets.q_network.apply(None, qp, obs, act)
    assert q.shape == (7, 2)
    # each critic drawn on its own: the heads differ
    assert not torch.allclose(q[:, 0], q[:, 1])
    assert not torch.equal(qp["hidden.0.weight"][0], qp["hidden.0.weight"][1])

    jnets = jax_sac_networks(OBS, ACT, hidden_layer_sizes=HIDDEN)
    kq, kp, kn = jax.random.split(jax.random.PRNGKey(1), 3)
    jq, jp = jax.device_get(jnets.q_network.init(kq)), jax.device_get(jnets.policy_network.init(kp))
    want = np.asarray(jnets.q_network.apply(None, jq, jnp.asarray(obs.numpy()), jnp.asarray(act.numpy())))
    got = nets.q_network.apply(None, ppo_params_from_jax(jq, "cpu"), obs, act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tp_ = ppo_params_from_jax(jp, "cpu")
    jpolicy = make_inference_fn_jax(jnets, jp)
    for deterministic in (True, False):
        want_a = np.asarray(jpolicy(deterministic)(jnp.asarray(obs.numpy()), kn)[0])
        noise = torch.as_tensor(np.asarray(jax.random.normal(kn, (7, ACT))))
        got_a, extras = make_inference_fn(nets)((None, tp_), deterministic=deterministic)(obs, noise)
        assert extras == {} and torch.all(got_a.abs() <= 1.0)
        np.testing.assert_allclose(got_a.numpy(), want_a, rtol=1e-5, atol=1e-5)


def make_inference_fn_jax(jnets, jp):
    from ambersim_tpu.rl.sac import make_inference_fn

    return lambda deterministic: make_inference_fn(jnets)((None, jp), deterministic=deterministic)


def _jax_setup(seed: int = 0):
    """JAX SAC networks with the normalizer, a fresh TrainingState as
    ambersim_tpu/rl/sac/train.py:117-129 builds it (log_alpha moved off 0),
    and a fitted normalizer."""
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu.rl.sac import make_sac_networks as jax_sac_networks
    from ambersim_tpu.rl.sac.train import TrainingState

    jnets = jax_sac_networks(OBS, ACT, preprocess_observations_fn=jrs.normalize, hidden_layer_sizes=HIDDEN)
    kp, kq = jax.random.split(jax.random.PRNGKey(seed))
    pp, qp = jnets.policy_network.init(kp), jnets.q_network.init(kq)
    log_alpha = jnp.asarray(-0.3)
    obs = np.random.default_rng(seed).standard_normal((256, OBS)).astype(np.float32) * 1.5 + 0.2
    norm = jrs.update(jrs.init_state(jnp.zeros(OBS)), jnp.asarray(obs))
    opt, alpha_opt = optax.adam(learning_rate=LR), optax.adam(learning_rate=3e-4)
    state = TrainingState(
        policy_optimizer_state=opt.init(pp), policy_params=pp, q_optimizer_state=opt.init(qp), q_params=qp,
        target_q_params=jax.tree.map(lambda x: x + 0.01, qp), alpha_optimizer_state=alpha_opt.init(log_alpha),
        log_alpha=log_alpha, normalizer_params=norm, train_iters=jnp.zeros((), jnp.int32),
    )
    return jnets, state


def _port_networks():
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs
    from ambersim_tpu_torch.rl.sac import make_sac_networks

    return make_sac_networks(OBS, ACT, preprocess_observations_fn=trs.normalize, hidden_layer_sizes=HIDDEN)


def _leaf_close(got, want, what):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=0, atol=GRAD_RTOL * max(np.abs(w).max(), 1e-30),
                               err_msg=what)


def test_losses_and_gradients_match_jax():
    from ambersim_tpu.rl.sac import losses as jl
    from ambersim_tpu_torch.io.bridge import ppo_params_to_numpy, sac_state_from_jax
    from ambersim_tpu_torch.rl.sac import losses as tl

    torch.set_num_threads(1)
    jnets, js = _jax_setup()
    s = sac_state_from_jax(jax.device_get(js), "cpu")
    assert set(s) == {"policy_params", "q_params", "target_q_params", "log_alpha", "normalizer_params"}
    assert s["q_params"]["hidden.0.weight"].shape == (2, HIDDEN[0], OBS + ACT) and s["log_alpha"].shape == ()
    nets = _port_networks()
    jt = _jax_transition(np.random.default_rng(1), B)
    jt = jt.replace(**{k: jnp.asarray(getattr(jt, k)) for k in ("observation", "action", "reward", "discount",
                                                                 "truncation", "next_observation")})
    tt = _torch_transition(jt)
    key = jax.random.PRNGKey(2)
    noise = torch.as_tensor(np.asarray(jax.random.normal(key, (B, ACT))))
    alpha = jnp.exp(js.log_alpha)

    def leaves(t):
        return [t] if isinstance(t, torch.Tensor) else list(t.values())

    cases = {
        "alpha": (jax.value_and_grad(jl.alpha_loss)(js.log_alpha, js.policy_params, js.normalizer_params, jt, key,
                                                    sac_networks=jnets, target_entropy=-0.5 * ACT),
                  lambda p: tl.alpha_loss(p, s["policy_params"], s["normalizer_params"], tt, noise, nets, -0.5 * ACT),
                  s["log_alpha"]),
        "critic": (jax.value_and_grad(jl.critic_loss)(js.q_params, js.policy_params, js.normalizer_params,
                                                      js.target_q_params, alpha, jt, key, sac_networks=jnets,
                                                      **LOSS_KW),
                   lambda p: tl.critic_loss(p, s["policy_params"], s["normalizer_params"], s["target_q_params"],
                                            torch.exp(s["log_alpha"]), tt, noise, nets, **LOSS_KW),
                   s["q_params"]),
        "actor": (jax.value_and_grad(jl.actor_loss)(js.policy_params, js.q_params, js.normalizer_params, alpha, jt,
                                                    key, sac_networks=jnets),
                  lambda p: tl.actor_loss(p, s["q_params"], s["normalizer_params"], torch.exp(s["log_alpha"]), tt,
                                          noise, nets),
                  s["policy_params"]),
    }
    for name, ((want, want_grad), loss_fn, params) in cases.items():
        params = {k: v.clone().requires_grad_(True) for k, v in params.items()} if isinstance(params, dict) else (
            params.clone().requires_grad_(True))
        got = loss_fn(params)
        grads = torch.autograd.grad(got, leaves(params))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6, err_msg=name)
        if name == "alpha":
            _leaf_close(grads[0].numpy(), want_grad, name)
            continue
        got_grad = ppo_params_to_numpy(dict(zip(params, grads)))
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_grad), jax.tree_util.tree_leaves(got_grad)):
            assert np.abs(np.asarray(w)).max() > 0, (name, path)
            _leaf_close(g, w, f"{name} {path}")

    truncated = dataclasses.replace(tt, truncation=torch.ones(B))
    zero = tl.critic_loss(s["q_params"], s["policy_params"], s["normalizer_params"], s["target_q_params"],
                          torch.exp(s["log_alpha"]), truncated, noise, nets, **LOSS_KW)
    assert zero.item() == 0.0


def _jax_sgd_steps(jnets, js, jbuffer, key, steps):
    """ambersim_tpu/rl/sac/train.py:164-220 composed step by step; returns
    the state, the losses and the draws (indices, normals) of each step."""
    from ambersim_tpu.rl.sac import losses as jl
    from ambersim_tpu.rl.sac import replay as jreplay

    opt, alpha_opt = optax.adam(learning_rate=LR), optax.adam(learning_rate=3e-4)
    draws, losses = [], []
    for _ in range(steps):
        key, key_sample, key_alpha, key_critic, key_actor = jax.random.split(key, 5)
        transitions = jreplay.sample(jbuffer, key_sample, B)
        idx = np.asarray(jax.random.randint(key_sample, (B,), 0, jnp.maximum(jbuffer.size, 1)))
        noise = np.stack([np.asarray(jax.random.normal(k, (B, ACT))) for k in (key_alpha, key_critic, key_actor)])
        draws.append((idx, noise))
        aloss, ag = jax.value_and_grad(jl.alpha_loss)(js.log_alpha, js.policy_params, js.normalizer_params,
                                                      transitions, key_alpha, sac_networks=jnets,
                                                      target_entropy=-0.5 * ACT)
        au, alpha_state = alpha_opt.update(ag, js.alpha_optimizer_state)
        log_alpha = optax.apply_updates(js.log_alpha, au)
        alpha = jnp.exp(log_alpha)
        closs, qg = jax.value_and_grad(jl.critic_loss)(js.q_params, js.policy_params, js.normalizer_params,
                                                       js.target_q_params, alpha, transitions, key_critic,
                                                       sac_networks=jnets, **LOSS_KW)
        qu, q_state = opt.update(qg, js.q_optimizer_state)
        q_params = optax.apply_updates(js.q_params, qu)
        target = jax.tree.map(lambda t, p: t * (1 - TAU) + p * TAU, js.target_q_params, q_params)
        ploss, pg = jax.value_and_grad(jl.actor_loss)(js.policy_params, js.q_params, js.normalizer_params, alpha,
                                                      transitions, key_actor, sac_networks=jnets)
        pu, p_state = opt.update(pg, js.policy_optimizer_state)
        policy_params = optax.apply_updates(js.policy_params, pu)
        js = js.replace(policy_optimizer_state=p_state, policy_params=policy_params, q_optimizer_state=q_state,
                        q_params=q_params, target_q_params=target, alpha_optimizer_state=alpha_state,
                        log_alpha=log_alpha)
        losses.append((float(closs), float(ploss), float(aloss), float(alpha)))
    return js, losses, draws


def test_sgd_steps_match_jax():
    from ambersim_tpu.rl.sac import replay as jreplay
    from ambersim_tpu_torch.io.bridge import sac_state_from_jax
    from ambersim_tpu_torch.rl.sac import replay
    from ambersim_tpu_torch.rl.sac.train import make_training_state, sgd_step

    torch.set_num_threads(1)
    jnets, js = _jax_setup(seed=4)
    data = _jax_transition(np.random.default_rng(5), 48)
    jbuffer = jreplay.insert(jreplay.init(CAPACITY, jax.tree.map(lambda x: x[0], data)), data)
    want, losses, draws = _jax_sgd_steps(jnets, js, jbuffer, jax.random.PRNGKey(6), 3)

    s = sac_state_from_jax(jax.device_get(js), "cpu")
    ts = make_training_state(s["policy_params"], s["q_params"], s["log_alpha"], s["normalizer_params"], LR,
                             target_q_params=s["target_q_params"])
    assert ts.target_q_params["hidden.0.weight"].data_ptr() != ts.q_params["hidden.0.weight"].data_ptr()
    buffer = replay.insert(replay.init(CAPACITY, _torch_transition(jax.tree.map(lambda x: x[0], data))),
                           _torch_transition(data))
    nets = _port_networks()
    for (idx, noise), want_losses in zip(draws, losses):
        m = sgd_step(ts, replay.sample(buffer, torch.as_tensor(idx)), torch.as_tensor(noise), nets,
                     target_entropy=-0.5 * ACT, tau=TAU, **LOSS_KW)
        got_losses = [m[k].item() for k in ("critic_loss", "actor_loss", "alpha_loss", "alpha")]
        np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    w = sac_state_from_jax(jax.device_get(want), "cpu")
    for name in ("policy_params", "q_params", "target_q_params"):
        for k, v in w[name].items():
            got = getattr(ts, name)[k].detach()
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=1e-4, atol=ATOL, err_msg=f"{name} {k}")
            assert not torch.equal(got, s[name][k]), f"{name} {k} did not move"
    np.testing.assert_allclose(ts.log_alpha.item(), w["log_alpha"].item(), rtol=1e-4, atol=ATOL)


SAC_KW = dict(num_timesteps=512, episode_length=32, num_envs=8, num_eval_envs=8, batch_size=32, min_replay_size=64,
              max_replay_size=2048, grad_updates_per_step=2, num_evals=2, normalize_observations=True,
              learning_rate=3e-4, discounting=0.95, seed=0, device="cpu")


def test_sac_train_end_to_end(tmp_path):
    """tests/test_sac_train.py:91-131's sizes: 8 prefill actor steps of 8
    envs, then (512 - 64) / 8 = 56 training steps; the checkpoint holds
    every field of the training state, and a run restored from it resumes
    its step count and params."""
    from ambersim_tpu_torch.io.checkpoint import load_params
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.sac import train

    torch.set_num_threads(1)
    progress = []
    ckpt = tmp_path / "sac.pkl"
    make_policy, params, metrics = train(PendulumSwingupEnv(device="cpu"), checkpoint_path=str(ckpt),
                                         progress_fn=lambda step, m: progress.append((step, m)), **SAC_KW)
    assert [s for s, _ in progress] == [0, 64 + 56 * 8]
    assert set(metrics) == {"eval/episode_reward", "training/critic_loss", "training/actor_loss",
                            "training/alpha_loss", "training/alpha", "timing/actor_s", "timing/sgd_s",
                            "timing/eval_s", "timing/prefill_s"}
    assert all(np.isfinite(v) for v in metrics.values())
    normalizer, policy_params = params
    assert float(normalizer.count) == 64 + 56 * 8  # every actor step's obs, the prefill's too
    assert not any(v.requires_grad for v in policy_params.values())
    act, _ = make_policy(params, deterministic=True)(torch.zeros(1, 3))
    assert act.shape == (1, 1) and torch.all(act.abs() <= 1.0)
    act, _ = make_policy(params)(torch.zeros(4, 3), torch.Generator().manual_seed(0))
    assert act.shape == (4, 1) and torch.all(act.abs() <= 1.0)

    saved = load_params(ckpt, device="cpu")
    assert set(saved) == {"policy_params", "policy_optimizer", "q_params", "q_optimizer", "target_q_params",
                          "alpha_optimizer", "log_alpha", "normalizer_params", "train_iters"}
    assert saved["train_iters"] == 56
    for k, v in policy_params.items():
        assert torch.equal(saved["policy_params"][k], v)
    resumed = []
    make_policy2, params2, _ = train(
        PendulumSwingupEnv(device="cpu"), restore_checkpoint_path=str(ckpt),
        progress_fn=lambda step, m: resumed.append(step),
        **dict(SAC_KW, num_timesteps=128, episode_length=16, batch_size=16, min_replay_size=16, max_replay_size=512,
               num_evals=1, seed=1),
    )
    # 2 prefill actor steps, then (128 - 16) / 8 = 14 training steps after the 56 restored
    assert resumed == [16 + (56 + 14) * 8]
    act2, _ = make_policy2(params2, deterministic=True)(torch.zeros(1, 3))
    assert torch.isfinite(act2).all()


def test_sac_refusals(monkeypatch):
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.sac import train

    env = PendulumSwingupEnv(device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1: multi-GPU"):
        train(env, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train(env, device="cuda")
