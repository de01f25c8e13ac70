"""APG trainer (port of ambersim_tpu/rl/apg/train.py).

Each policy update differentiates the mean per-env episode return of an
`episode_length`-step rollout with respect to the policy parameters: the
chain rule runs through the policy MLP, the contact solve and the
integrator (reverse mode through `step`, each kernel's Function). The
envs are reset fresh before every update.

Rematerialization: each control step runs under
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`, the
counterpart of the JAX package's jax.checkpoint, so the backward pass
recomputes each step's physics instead of keeping its intermediates: the
rollout holds one env State a step. The recompute launches the step's
kernels a second time (on the card a step's kernels launch twice per
update: forward and recompute); each kernel's Function then runs autograd
through its plain version. The JAX package's `make_slim_carry` shrinks a
lax.scan carry; here the checkpoint keeps each step's State by reference
(the full Data, which the next step reads), a few MB an env step at the
quadruped's width, so no slim carry is needed.

Optimizer: optax's clip_by_global_norm then adam becomes
`torch.nn.utils.clip_grad_norm_` then `torch.optim.Adam(eps=1e-8)`. Random
draws come from one explicit `torch.Generator` on the training device; a
stochastic rollout draws its action noise outside the checkpointed step,
so the recompute sees the same noise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ambersim_tpu_torch.engine.forward import full_f32_matmul
from ambersim_tpu_torch.learning.architectures import MLP
from ambersim_tpu_torch.rl import wrappers
from ambersim_tpu_torch.rl.base import MjxEnv, State, draw_normal
from ambersim_tpu_torch.rl.common import check_device, episode_return, refuse_mesh, sync
from ambersim_tpu_torch.rl.ppo import running_statistics
from ambersim_tpu_torch.rl.ppo.distributions import DeterministicTanhDistribution, NormalTanhDistribution
from ambersim_tpu_torch.rl.ppo.networks import (
    FeedForwardNetwork,
    PPONetworks,
    identity_observation_preprocessor,
    make_inference_fn,
    make_network,
)


def _policy_only(dist, observation_size: int, preprocess_observations_fn, hidden_layer_sizes, activation):
    policy = MLP(observation_size, list(hidden_layer_sizes) + [dist.param_size], activation=activation)
    value = FeedForwardNetwork(init=lambda generator: {},
                               apply=lambda pp, p, obs: torch.zeros(obs.shape[:-1], device=obs.device))
    return PPONetworks(
        policy_network=make_network(policy, observation_size, preprocess_observations_fn),
        value_network=value,
        parametric_action_distribution=dist,
    )


def make_apg_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn=identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (32,) * 4,
    activation=nn.functional.silu,
) -> PPONetworks:
    """Policy-only network bundle with a tanh-Normal head (PPONetworks shape
    so make_inference_fn applies unchanged; the value network is unused)."""
    return _policy_only(NormalTanhDistribution(event_size=action_size), observation_size,
                        preprocess_observations_fn, hidden_layer_sizes, activation)


def make_deterministic_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn=identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (32,) * 4,
    activation=nn.functional.silu,
) -> PPONetworks:
    """Policy-only bundle with a deterministic tanh head (param_size ==
    action_size), the default of ES and ARS, which roll out with the mode."""
    return _policy_only(DeterministicTanhDistribution(event_size=action_size), observation_size,
                        preprocess_observations_fn, hidden_layer_sizes, activation)


def rollout_loss(
    env: MjxEnv,
    apg_network: PPONetworks,
    policy_params: Dict[str, torch.Tensor],
    normalizer_params,
    state: State,
    steps: int,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State, torch.Tensor]:
    """-mean per-env return of `steps` control steps from `state`, with the
    graph back to `policy_params`; each step checkpointed. Actions are the
    policy's mode, or samples with `noise` (steps, B, action_size) standard
    normals. Returns (loss, final state, obs (steps, B, obs_size))."""
    dist = apg_network.parametric_action_distribution

    def env_step(state: State, eps: Optional[torch.Tensor]) -> State:
        logits = apg_network.policy_network.apply(normalizer_params, policy_params, state.obs)
        action = dist.mode(logits) if eps is None else dist.sample(logits, eps)
        return env.step(state, action)

    rewards, obs = [], []
    for t in range(steps):
        state = checkpoint(env_step, state, None if noise is None else noise[t], use_reentrant=False)
        rewards.append(state.reward)
        obs.append(state.obs)
    return -torch.stack(rewards).sum(0).mean(), state, torch.stack(obs)


@dataclasses.dataclass
class TrainingState:
    policy_params: Dict[str, torch.Tensor]  # leaves that Adam updates
    optimizer: torch.optim.Adam
    normalizer_params: running_statistics.RunningStatisticsState
    train_iters: int = 0


def checkpoint_state(ts: TrainingState) -> Dict[str, Any]:
    """What `checkpoint_path` saves (io.checkpoint.save_params) and
    `restore_checkpoint_path` reads."""
    return {"policy_params": ts.policy_params, "optimizer": ts.optimizer.state_dict(),
            "normalizer_params": ts.normalizer_params, "train_iters": ts.train_iters}


@torch.no_grad()
def restore_training_state(ts: TrainingState, saved: Dict[str, Any]) -> None:
    """Load a `checkpoint_state` (tensors on any device) into `ts` in place."""
    for k, v in ts.policy_params.items():
        v.copy_(saved["policy_params"][k])
    ts.optimizer.load_state_dict(saved["optimizer"])
    ts.normalizer_params = saved["normalizer_params"].to(next(iter(ts.policy_params.values())).device)
    ts.train_iters = int(saved["train_iters"])


@full_f32_matmul()
def train(
    environment: MjxEnv,
    episode_length: int = 1000,
    action_repeat: int = 1,
    num_envs: int = 32,
    num_eval_envs: int = 128,
    policy_updates: int = 100,
    learning_rate: float = 1e-3,
    max_gradient_norm: float = 1e9,
    seed: int = 0,
    num_evals: int = 1,
    normalize_observations: bool = False,
    deterministic_rollout: bool = True,
    network_factory: Callable = make_apg_networks,
    progress_fn: Callable[[int, Dict[str, Any]], None] = lambda *args: None,
    mesh: Optional[Any] = None,
    checkpoint_path: Optional[str] = None,
    restore_checkpoint_path: Optional[str] = None,
    device="cuda",
) -> Tuple[Callable, Tuple[Any, Any], Dict[str, Any]]:
    """Train a policy by analytic gradients on `device` (the card unless
    "cpu" is asked for); returns (make_policy, (normalizer_params,
    policy_params), metrics). Metrics carry the JAX package's
    `eval/episode_reward`, `training/episode_loss` and `training/grad_norm`
    (the global norm before clipping), plus `timing/forward_s`,
    `timing/backward_s` and `timing/eval_s`: host seconds of the epoch's
    rollouts, backward passes and eval, each ended by a device synchronize."""
    refuse_mesh(mesh)
    device = check_device(device)
    environment = environment.to(device)
    env = wrappers.wrap_for_training(environment, episode_length, action_repeat)
    eval_env = wrappers.wrap_for_training(environment, episode_length, action_repeat)
    obs_size = environment.observation_size
    action_size = environment.action_size
    steps = episode_length // action_repeat

    num_evals_after_init = max(num_evals - 1, 1)
    updates_per_epoch = max(1, -(-policy_updates // num_evals_after_init))
    env_steps_per_update = num_envs * episode_length * action_repeat

    preprocess = running_statistics.normalize if normalize_observations else identity_observation_preprocessor
    apg_network = network_factory(obs_size, action_size, preprocess_observations_fn=preprocess)
    make_policy = make_inference_fn(apg_network)

    generator = torch.Generator(device=device).manual_seed(seed)
    params = {k: v.requires_grad_(True) for k, v in apg_network.policy_network.init(generator).items()}
    ts = TrainingState(
        policy_params=params,
        optimizer=torch.optim.Adam(list(params.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8),
        normalizer_params=running_statistics.init_state(torch.zeros(obs_size, device=device)),
    )
    if restore_checkpoint_path is not None:
        from ambersim_tpu_torch.io.checkpoint import load_params

        restore_training_state(ts, load_params(restore_checkpoint_path, device=device))

    def policy_params():
        return (ts.normalizer_params, {k: v.detach() for k, v in ts.policy_params.items()})

    def run_evaluation() -> torch.Tensor:
        return episode_return(eval_env, make_policy(policy_params(), deterministic=True), generator, num_eval_envs,
                              steps)

    def training_step(env_state: State, timing: Dict[str, float]) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        noise = None if deterministic_rollout else draw_normal(generator, (steps, num_envs, action_size), device)
        loss, _, obs = rollout_loss(env, apg_network, ts.policy_params, ts.normalizer_params, env_state, steps, noise)
        sync(device)
        t1 = time.perf_counter()
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = torch.nn.utils.clip_grad_norm_(list(ts.policy_params.values()), max_gradient_norm)
        ts.optimizer.step()
        if normalize_observations:
            ts.normalizer_params = running_statistics.update(ts.normalizer_params, obs.reshape(-1, obs_size).detach())
        ts.train_iters += 1
        sync(device)
        timing["timing/forward_s"] += t1 - t0
        timing["timing/backward_s"] += time.perf_counter() - t1
        return {"episode_loss": loss.detach(), "grad_norm": grad_norm.detach()}

    metrics: Dict[str, Any] = {}
    if num_evals > 1:
        metrics = {"eval/episode_reward": float(run_evaluation())}
        progress_fn(0, metrics)

    for _ in range(num_evals_after_init):
        timing = {"timing/forward_s": 0.0, "timing/backward_s": 0.0}
        step_metrics = []
        for _ in range(updates_per_epoch):
            # fresh starts each update: the whole episode is the objective
            with torch.no_grad():
                env_state = env.reset(generator, num_envs)
            step_metrics.append(training_step(env_state, timing))
        t0 = time.perf_counter()
        episode_reward = run_evaluation()
        keys = list(step_metrics[0])
        host = torch.stack(
            [episode_reward] + [torch.stack([m[k] for m in step_metrics]).mean() for k in keys]
        ).tolist()
        timing["timing/eval_s"] = time.perf_counter() - t0
        metrics = {
            "eval/episode_reward": host[0],
            **{f"training/{k}": v for k, v in zip(keys, host[1:])},
            **timing,
        }
        progress_fn(ts.train_iters * env_steps_per_update, metrics)
        if checkpoint_path is not None:
            from ambersim_tpu_torch.io.checkpoint import save_params

            save_params(checkpoint_path, checkpoint_state(ts))

    return make_policy, policy_params(), metrics
