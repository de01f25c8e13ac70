"""The PyTorch port's PPO losses and update against the JAX package's (CPU):
GAE with terminations and truncations, the clipped-surrogate loss and its
gradient per parameter, one Adam step against optax.adam, and the
trainer's env-major merge and minibatch split fed JAX's permutation.
Bars: GAE 1e-6; loss components 1e-5; gradients rtol 1e-4 with atol 1e-8;
Adam 1e-6;
merge and split identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tools import torch_parity as tp

OBS, ACT = 5, 2
T, B = 8, 16


def _gae_inputs(seed: int):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    truncation = (rng.uniform(size=(T, B)) < 0.15).astype(np.float32)
    termination = (rng.uniform(size=(T, B)) < 0.15).astype(np.float32) * (1 - truncation)
    return dict(truncation=truncation, termination=termination, rewards=f(T, B), values=f(T, B),
                bootstrap_value=f(B))


def test_gae_matches_jax():
    from ambersim_tpu.rl.ppo.losses import compute_gae as jax_gae
    from ambersim_tpu_torch.rl.ppo.losses import compute_gae

    inp = _gae_inputs(0)
    assert inp["truncation"].any() and inp["termination"].any()
    kw = dict(lambda_=0.95, discount=0.97)
    want = jax_gae(**{k: jnp.asarray(v) for k, v in inp.items()}, **kw)
    got = compute_gae(**{k: torch.as_tensor(v) for k, v in inp.items()}, **kw)
    for name, g, w in zip(("vs", "advantages"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def case():
    from ambersim_tpu.rl.ppo import networks as jnets
    from ambersim_tpu.rl.ppo import running_statistics as jrs
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.ppo import networks as tnets
    from ambersim_tpu_torch.rl.ppo import running_statistics as trs

    torch.set_num_threads(1)
    jn = jnets.make_ppo_networks(OBS, ACT, preprocess_observations_fn=jrs.normalize)
    tn = tnets.make_ppo_networks(OBS, ACT, preprocess_observations_fn=trs.normalize)
    kp, kv = jax.random.split(jax.random.PRNGKey(11))
    jparams = {"policy": jn.policy_network.init(kp), "value": jn.value_network.init(kv)}
    data = tp.ppo_rollout_buffer(12, jn, jparams, jrs.init_state(jnp.zeros(OBS)), T, B, OBS)
    jnorm = jrs.update(jrs.init_state(jnp.zeros(OBS)), jnp.asarray(data["observation"]))
    tnorm, tparams = ppo_params_from_jax(jax.tree.map(np.asarray, (jnorm, jparams)), device="cpu")
    return dict(jn=jn, tn=tn, jparams=jparams, jnorm=jnorm, tparams=tparams, tnorm=tnorm, data=data)


LOSS_KW = dict(entropy_cost=1e-2, discounting=0.97, reward_scaling=0.1, gae_lambda=0.95, clipping_epsilon=0.3,
               normalize_advantage=True)


def _losses(case):
    """(JAX loss metrics, JAX grads, port loss metrics, port grads)."""
    from ambersim_tpu.rl.ppo import losses as jl
    from ambersim_tpu_torch.rl.ppo import losses as tl

    key = jax.random.PRNGKey(13)
    noise = np.array(jax.random.normal(key, (T, B, ACT)))  # the normals of JAX's sample-based entropy
    jdata = jl.Transition(**{k: jnp.asarray(v) for k, v in case["data"].items()})
    (_, jm), jgrads = jax.value_and_grad(jl.compute_ppo_loss, has_aux=True)(
        case["jparams"], case["jnorm"], jdata, key, case["jn"], **LOSS_KW)
    params = {net: {k: v.clone().requires_grad_(True) for k, v in p.items()} for net, p in case["tparams"].items()}
    tdata = tl.Transition(**{k: torch.as_tensor(v) for k, v in case["data"].items()})
    loss, tm = tl.compute_ppo_loss(params, case["tnorm"], tdata, torch.as_tensor(noise), case["tn"], **LOSS_KW)
    loss.backward()
    return jm, jgrads, tm, {net: {k: v.grad for k, v in p.items()} for net, p in params.items()}


def test_ppo_loss_and_gradients_match_jax(case):
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax

    jm, jgrads, tm, tgrads = _losses(case)
    for k in ("total_loss", "policy_loss", "v_loss", "entropy_loss"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    # the JAX gradients in the port's layout (kernels transposed)
    want = ppo_params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    for net in ("policy", "value"):
        for k, w in want[net].items():
            # atol: an element of ~1e-7 is float32 cancellation, and moves by
            # 1e-9 with the order of the sums (1 of the 1024 of a value layer)
            np.testing.assert_allclose(tgrads[net][k].numpy(), w.numpy(), rtol=1e-4, atol=1e-8, err_msg=f"{net} {k}")


def test_adam_step_matches_optax(case):
    """One optimizer step of the trainer (make_training_state's Adam) from
    the same params and gradients as optax.adam at the trainer's defaults."""
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax
    from ambersim_tpu_torch.rl.ppo.train import make_training_state

    _, jgrads, _, _ = _losses(case)
    opt = optax.adam(learning_rate=3e-4)
    updates, _ = opt.update(jgrads, opt.init(case["jparams"]), case["jparams"])
    want = ppo_params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(case["jparams"], updates)), device="cpu")
    ts = make_training_state(case["tparams"], case["tnorm"], learning_rate=3e-4)
    grads = ppo_params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    for net, p in ts.params.items():
        for k, v in p.items():
            v.grad = grads[net][k].clone()
    ts.optimizer.step()
    for net in ("policy", "value"):
        for k, w in want[net].items():
            np.testing.assert_allclose(ts.params[net][k].detach().numpy(), w.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{net} {k}")


def test_merge_and_minibatches_match_jax():
    """train.py's env-major merge of (num_unrolls, T, num_envs) and its
    shard-local shuffle into minibatches (one shard), fed JAX's permutation."""
    from ambersim_tpu_torch.rl.ppo.losses import Transition
    from ambersim_tpu_torch.rl.ppo.train import merge_unrolls, minibatches

    num_unrolls, num_envs, num_minibatches = 3, 8, 4
    total = num_unrolls * num_envs
    x = np.random.default_rng(14).standard_normal((num_unrolls, T, num_envs, 2)).astype(np.float32)
    # ambersim_tpu/rl/ppo/train.py:248-253
    jmerged = jnp.moveaxis(jnp.asarray(x), 0, 2).reshape((T, num_envs * num_unrolls, 2))
    # train.py:211-225 with S = 1
    perm = jax.vmap(lambda k: jax.random.permutation(k, total))(jax.random.split(jax.random.PRNGKey(15), 1))
    xs = jnp.take_along_axis(jmerged.reshape((T, 1, total, 2)), perm.reshape((1, 1, total, 1)), axis=2)
    xs = jnp.moveaxis(xs.reshape((T, 1, num_minibatches, total // num_minibatches, 2)), 2, 0)
    jshuffled = xs.reshape((num_minibatches, T, total // num_minibatches, 2))

    fields = {k: torch.as_tensor(x) for k in ("observation", "action", "raw_action", "log_prob", "reward", "discount",
                                               "truncation", "next_observation")}
    merged = merge_unrolls(Transition(**fields), num_envs, num_unrolls)
    np.testing.assert_array_equal(merged.observation.numpy(), np.asarray(jmerged))
    shuffled = minibatches(merged.observation, torch.as_tensor(np.array(perm[0])), num_minibatches)
    np.testing.assert_array_equal(shuffled.numpy(), np.asarray(jshuffled))
