"""PPO trainer (port of ambersim_tpu/rl/ppo/train.py).

Same hyperparameters, return contract `(make_policy, (normalizer_params,
policy_params), metrics)` and `progress_fn(num_steps, metrics)` with the
`eval/episode_reward` and `training/*` keys, plus a `device` argument. Each
training step keeps the JAX package's layout:

  * `num_unrolls` unrolls of `unroll_length` control steps, the policy
    sampled without autograd;
  * the env-major merge (num_unrolls, T, num_envs) -> (T, num_envs *
    num_unrolls), then the normalizer update;
  * `num_updates_per_batch` epochs, each one permutation of the merged batch
    axis split into `num_minibatches`, with Adam at optax's defaults.

The learner (`sgd_update`) takes the permutations and the entropy normals
as tensors, so a test can hand it the JAX package's own. Each eval reads
its results back to the host once. On a CUDA device every env step runs
the port's physics through the hand-written kernels; without a card the
trainer raises rather than step on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ambersim_tpu_torch.engine.forward import full_f32_matmul
from ambersim_tpu_torch.rl import wrappers
from ambersim_tpu_torch.rl.base import MjxEnv, State
from ambersim_tpu_torch.rl.common import check_device, episode_return, refuse_mesh, sync
from ambersim_tpu_torch.rl.ppo import losses as ppo_losses
from ambersim_tpu_torch.rl.ppo import networks as ppo_networks_lib
from ambersim_tpu_torch.rl.ppo import running_statistics


@dataclasses.dataclass
class TrainingState:
    params: Dict[str, ppo_networks_lib.Params]  # {"policy": ..., "value": ...}, leaves that Adam updates
    optimizer: torch.optim.Adam
    normalizer_params: running_statistics.RunningStatisticsState
    train_iters: int = 0


def make_training_state(params, normalizer_params, learning_rate: float) -> TrainingState:
    """Fresh leaf copies of `params` and an Adam over them (optax's defaults)."""
    params = {net: {k: v.detach().clone().requires_grad_(True) for k, v in p.items()} for net, p in params.items()}
    leaves = [v for p in params.values() for v in p.values()]
    optimizer = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainingState(params=params, optimizer=optimizer, normalizer_params=normalizer_params)


def checkpoint_state(ts: TrainingState) -> Dict[str, Any]:
    """What `checkpoint_path` saves (io.checkpoint.save_params) and
    `restore_checkpoint_path` reads."""
    return {
        "params": ts.params,
        "optimizer": ts.optimizer.state_dict(),
        "normalizer_params": ts.normalizer_params,
        "train_iters": ts.train_iters,
    }


@torch.no_grad()
def restore_training_state(ts: TrainingState, saved: Dict[str, Any]) -> None:
    """Load a `checkpoint_state` (tensors on any device) into `ts` in place."""
    for net, p in ts.params.items():
        for k, v in p.items():
            v.copy_(saved["params"][net][k])
    ts.optimizer.load_state_dict(saved["optimizer"])
    device = next(iter(ts.params["policy"].values())).device
    ts.normalizer_params = saved["normalizer_params"].to(device)
    ts.train_iters = int(saved["train_iters"])


def merge_unrolls(data: ppo_losses.Transition, num_envs: int, num_unrolls: int) -> ppo_losses.Transition:
    """(num_unrolls, T, num_envs, ...) -> (T, num_envs * num_unrolls, ...),
    env-major: column e * num_unrolls + u is unroll u of env e."""
    return data.map(lambda x: x.movedim(0, 2).reshape((x.shape[1], num_envs * num_unrolls) + x.shape[3:]))


def minibatches(x: torch.Tensor, perm: torch.Tensor, num_minibatches: int) -> torch.Tensor:
    """(T, total, ...) -> (num_minibatches, T, total // num_minibatches, ...):
    minibatch m holds columns perm[m * batch_size : (m + 1) * batch_size]."""
    T = x.shape[0]
    return x[:, perm].reshape((T, num_minibatches, -1) + x.shape[2:]).movedim(1, 0)


def sgd_update(
    ts: TrainingState,
    data: ppo_losses.Transition,
    perms: torch.Tensor,
    entropy_noise: torch.Tensor,
    ppo_network: ppo_networks_lib.PPONetworks,
    num_minibatches: int,
    **loss_kwargs,
) -> Dict[str, torch.Tensor]:
    """The learner: one epoch per row of `perms` (num_updates_per_batch,
    total_batch); `entropy_noise` (num_updates_per_batch, num_minibatches,
    T, batch_size, action_size) feeds each minibatch's sample-based entropy.
    Updates `ts` in place; returns the mean of each loss metric, on the
    device."""
    metrics = []
    for epoch, perm in enumerate(perms):
        shuffled = data.map(lambda x: minibatches(x, perm, num_minibatches))
        for mb in range(num_minibatches):
            loss, m = ppo_losses.compute_ppo_loss(
                ts.params, ts.normalizer_params, shuffled.map(lambda x: x[mb]), entropy_noise[epoch, mb],
                ppo_network, **loss_kwargs,
            )
            ts.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            ts.optimizer.step()
            metrics.append(m)
    return {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}


@torch.no_grad()
def generate_unroll(env: MjxEnv, state: State, policy, generator: torch.Generator, unroll_length: int):
    """`unroll_length` control steps; returns the last State and the
    transitions stacked time-major, (T, num_envs, ...)."""
    steps = []
    for _ in range(unroll_length):
        action, extras = policy(state.obs, generator)
        next_state = env.step(state, action)
        steps.append(
            ppo_losses.Transition(
                observation=state.obs,
                action=action,
                raw_action=extras["raw_action"],
                log_prob=extras["log_prob"],
                reward=next_state.reward,
                discount=1 - next_state.done,
                truncation=next_state.info["truncation"],
                next_observation=next_state.obs,
            )
        )
        state = next_state
    return state, stack_transitions(steps)


def stack_transitions(steps: list) -> ppo_losses.Transition:
    return ppo_losses.Transition(
        **{f.name: torch.stack([getattr(s, f.name) for s in steps]) for f in dataclasses.fields(ppo_losses.Transition)}
    )


@full_f32_matmul()
def train(
    environment: MjxEnv,
    num_timesteps: int = 1_000_000,
    episode_length: int = 1000,
    action_repeat: int = 1,
    num_envs: int = 1024,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    seed: int = 0,
    unroll_length: int = 10,
    batch_size: int = 32,
    num_minibatches: int = 16,
    num_updates_per_batch: int = 2,
    num_evals: int = 1,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
    network_factory: Callable = ppo_networks_lib.make_ppo_networks,
    progress_fn: Callable[[int, Dict[str, Any]], None] = lambda *args: None,
    mesh: Optional[Any] = None,
    checkpoint_path: Optional[str] = None,
    restore_checkpoint_path: Optional[str] = None,
    randomization_fn: Optional[Callable] = None,
    device="cuda",
) -> Tuple[Callable, Tuple[Any, Any], Dict[str, Any]]:
    """Train a PPO agent on `device` (the card unless "cpu" is asked for); returns (make_policy, (normalizer_params,
    policy_params), metrics). `randomization_fn(model, generator, num_envs) -> (model_v, names)` gives every
    env its own randomized Model (rl.wrappers.DomainRandomizationVmapWrapper); the eval envs draw their own
    batch. Besides the JAX package's keys, metrics carry
    `timing/rollout_s`, `timing/sgd_s` and `timing/eval_s`: host seconds of
    the epoch's phases, each ended by a device synchronize."""
    refuse_mesh(mesh)
    device = check_device(device)
    if (batch_size * num_minibatches) % num_envs != 0:
        raise ValueError("batch_size * num_minibatches must be divisible by num_envs")

    environment = environment.to(device)
    train_rand_fn = eval_rand_fn = None
    if randomization_fn is not None:
        # `randomization_fn(model, generator, num_envs) -> (model_v, names)`:
        # the training envs' batch, then the eval envs' own, both drawn from a
        # host generator seeded seed ^ 0x5EED (JAX train.py:85-90)
        rand_gen = torch.Generator().manual_seed(seed ^ 0x5EED)
        train_rand_fn = functools.partial(randomization_fn, generator=rand_gen, num_envs=num_envs)
        eval_rand_fn = functools.partial(randomization_fn, generator=rand_gen, num_envs=num_eval_envs)
    env = wrappers.wrap_for_training(environment, episode_length, action_repeat, randomization_fn=train_rand_fn)
    eval_env = wrappers.wrap_for_training(environment, episode_length, action_repeat, randomization_fn=eval_rand_fn)
    obs_size = environment.observation_size
    action_size = environment.action_size

    num_unrolls = batch_size * num_minibatches // num_envs
    env_step_per_training_step = num_envs * unroll_length * num_unrolls * action_repeat
    num_evals_after_init = max(num_evals - 1, 1)
    num_training_steps_per_epoch = max(1, -(-num_timesteps // (env_step_per_training_step * num_evals_after_init)))

    preprocess = (
        running_statistics.normalize if normalize_observations else ppo_networks_lib.identity_observation_preprocessor
    )
    ppo_network = network_factory(obs_size, action_size, preprocess_observations_fn=preprocess)
    make_policy = ppo_networks_lib.make_inference_fn(ppo_network)
    loss_kwargs = dict(
        entropy_cost=entropy_cost, discounting=discounting, reward_scaling=reward_scaling, gae_lambda=gae_lambda,
        clipping_epsilon=clipping_epsilon, normalize_advantage=normalize_advantage,
    )

    generator = torch.Generator(device=device).manual_seed(seed)
    init_params = {"policy": ppo_network.policy_network.init(generator),
                   "value": ppo_network.value_network.init(generator)}
    ts = make_training_state(
        init_params, running_statistics.init_state(torch.zeros(obs_size, device=device)), learning_rate
    )
    if restore_checkpoint_path is not None:
        from ambersim_tpu_torch.io.checkpoint import load_params

        restore_training_state(ts, load_params(restore_checkpoint_path, device=device))

    def policy_params():
        return (ts.normalizer_params, {k: v.detach() for k, v in ts.params["policy"].items()})

    def run_evaluation() -> torch.Tensor:
        return episode_return(eval_env, make_policy(policy_params(), deterministic=True), generator, num_eval_envs,
                              episode_length // action_repeat)

    def training_step(env_state: State, timing: Dict[str, float]):
        t0 = time.perf_counter()
        policy = make_policy(policy_params())
        unrolls = []
        for _ in range(num_unrolls):
            env_state, data = generate_unroll(env, env_state, policy, generator, unroll_length)
            unrolls.append(data)
        data = merge_unrolls(stack_transitions(unrolls), num_envs, num_unrolls)
        sync(device)
        t1 = time.perf_counter()
        if normalize_observations:
            ts.normalizer_params = running_statistics.update(ts.normalizer_params, data.observation)
        total_batch = num_envs * num_unrolls
        perms = torch.stack(
            [torch.randperm(total_batch, generator=generator, device=device) for _ in range(num_updates_per_batch)]
        )
        noise = torch.randn(
            (num_updates_per_batch, num_minibatches, unroll_length, batch_size, action_size),
            generator=generator, device=device,
        )
        metrics = sgd_update(ts, data, perms, noise, ppo_network, num_minibatches, **loss_kwargs)
        ts.train_iters += 1
        sync(device)
        timing["timing/rollout_s"] += t1 - t0
        timing["timing/sgd_s"] += time.perf_counter() - t1
        return env_state, metrics

    metrics: Dict[str, Any] = {}
    env_state = env.reset(generator, num_envs)
    if num_evals > 1:
        # the initial eval reads the initial params, before any update
        metrics = {"eval/episode_reward": float(run_evaluation())}
        progress_fn(0, metrics)

    for _ in range(num_evals_after_init):
        timing = {"timing/rollout_s": 0.0, "timing/sgd_s": 0.0}
        step_metrics = []
        for _ in range(num_training_steps_per_epoch):
            env_state, m = training_step(env_state, timing)
            step_metrics.append(m)
        t0 = time.perf_counter()
        episode_reward = run_evaluation()
        keys = list(step_metrics[0])
        # one readback for the eval and every loss metric of the epoch
        host = torch.stack(
            [episode_reward] + [torch.stack([m[k] for m in step_metrics]).mean() for k in keys]
        ).tolist()
        timing["timing/eval_s"] = time.perf_counter() - t0
        metrics = {
            "eval/episode_reward": host[0],
            **{f"training/{k}": v for k, v in zip(keys, host[1:])},
            **timing,
        }
        progress_fn(ts.train_iters * env_step_per_training_step, metrics)
        if checkpoint_path is not None:
            from ambersim_tpu_torch.io.checkpoint import save_params

            save_params(checkpoint_path, checkpoint_state(ts))

    return make_policy, policy_params(), metrics
