"""SAC trainer (port of ambersim_tpu/rl/sac/train.py).

Same hyperparameters, return contract `(make_policy, (normalizer_params,
policy_params), metrics)` and `progress_fn(num_steps, metrics)` as the JAX
package's, plus a `device` argument. Each training step is one actor step
of `num_envs` envs into the on-device replay buffer (after a prefill with
random actions), then `grad_updates_per_step` SGD steps.

`sgd_step` keeps the JAX package's order (rl/sac/train.py:164-220), which
an in-place optimizer loop must take care to keep:

  (a) the alpha loss and its Adam step first: the new alpha feeds both
      later losses;
  (b) the critic loss reads the old policy params;
  (c) the actor loss reads the old critic params, so both losses and both
      gradients are taken before either optimizer steps;
  (d) the Polyak target then moves toward the new critic params;
  (e) the target starts as a clone of the critics, never an alias.

`sgd_step` takes its transitions and normals as tensors, so a test can
replay the JAX package's draws. Random draws come from one explicit
`torch.Generator` on the training device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ambersim_tpu_torch.engine.forward import full_f32_matmul
from ambersim_tpu_torch.rl import wrappers
from ambersim_tpu_torch.rl.base import MjxEnv, State
from ambersim_tpu_torch.rl.common import check_device, episode_return, refuse_mesh, sync
from ambersim_tpu_torch.rl.ppo import running_statistics
from ambersim_tpu_torch.rl.ppo.networks import Params
from ambersim_tpu_torch.rl.sac import losses as sac_losses
from ambersim_tpu_torch.rl.sac import networks as sac_networks_lib
from ambersim_tpu_torch.rl.sac import replay


def _adam(params, learning_rate: float) -> torch.optim.Adam:
    """optax.adam's defaults."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainingState:
    policy_params: Params
    policy_optimizer: torch.optim.Adam
    q_params: Params  # stacked on a leading n_critics axis
    q_optimizer: torch.optim.Adam
    target_q_params: Params
    alpha_optimizer: torch.optim.Adam
    log_alpha: torch.Tensor  # 0-d
    normalizer_params: running_statistics.RunningStatisticsState
    train_iters: int = 0


def make_training_state(policy_params: Params, q_params: Params, log_alpha, normalizer_params,
                        learning_rate: float, target_q_params: Optional[Params] = None) -> TrainingState:
    """Fresh leaf copies of the params and fresh Adams over them (the
    critics' target a clone of `q_params` unless given; alpha's optimizer at
    3e-4, as in the JAX package)."""

    def leaves(p):
        return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}

    policy_params, q_params = leaves(policy_params), leaves(q_params)
    source = q_params if target_q_params is None else target_q_params
    log_alpha = torch.as_tensor(log_alpha).detach().clone().requires_grad_(True)
    return TrainingState(
        policy_params=policy_params,
        policy_optimizer=_adam(list(policy_params.values()), learning_rate),
        q_params=q_params,
        q_optimizer=_adam(list(q_params.values()), learning_rate),
        target_q_params={k: v.detach().clone() for k, v in source.items()},
        alpha_optimizer=_adam([log_alpha], 3e-4),
        log_alpha=log_alpha,
        normalizer_params=normalizer_params,
    )


def sgd_step(
    ts: TrainingState,
    transitions: sac_losses.Transition,
    noise: torch.Tensor,
    sac_network: sac_networks_lib.SACNetworks,
    target_entropy: float,
    reward_scaling: float,
    discounting: float,
    tau: float,
) -> Dict[str, torch.Tensor]:
    """One SGD step of the three losses on a batch of `transitions`;
    `noise` (3, batch, action_size) holds the standard normals of the alpha,
    critic and actor losses' samples. Updates `ts` in place in the order
    (a)-(e) of the module docstring; returns the losses and alpha on the
    device."""
    norm = ts.normalizer_params
    aloss = sac_losses.alpha_loss(ts.log_alpha, ts.policy_params, norm, transitions, noise[0], sac_network,
                                  target_entropy)
    (ts.log_alpha.grad,) = torch.autograd.grad(aloss, [ts.log_alpha])
    ts.alpha_optimizer.step()
    alpha = torch.exp(ts.log_alpha.detach())

    closs = sac_losses.critic_loss(ts.q_params, ts.policy_params, norm, ts.target_q_params, alpha, transitions,
                                   noise[1], sac_network, reward_scaling, discounting)
    q_grads = torch.autograd.grad(closs, list(ts.q_params.values()))
    ploss = sac_losses.actor_loss(ts.policy_params, ts.q_params, norm, alpha, transitions, noise[2], sac_network)
    policy_grads = torch.autograd.grad(ploss, list(ts.policy_params.values()))

    with torch.no_grad():
        for p, g in zip(ts.q_params.values(), q_grads):
            p.grad = g
        ts.q_optimizer.step()
        for k, t in ts.target_q_params.items():
            t.copy_(t * (1 - tau) + ts.q_params[k] * tau)
        for p, g in zip(ts.policy_params.values(), policy_grads):
            p.grad = g
        ts.policy_optimizer.step()
    return {"critic_loss": closs.detach(), "actor_loss": ploss.detach(), "alpha_loss": aloss.detach(), "alpha": alpha}


def checkpoint_state(ts: TrainingState) -> Dict[str, Any]:
    """What `checkpoint_path` saves (io.checkpoint.save_params) and
    `restore_checkpoint_path` reads: every field of the training state."""
    return {
        "policy_params": ts.policy_params, "policy_optimizer": ts.policy_optimizer.state_dict(),
        "q_params": ts.q_params, "q_optimizer": ts.q_optimizer.state_dict(),
        "target_q_params": ts.target_q_params, "alpha_optimizer": ts.alpha_optimizer.state_dict(),
        "log_alpha": ts.log_alpha, "normalizer_params": ts.normalizer_params, "train_iters": ts.train_iters,
    }


@torch.no_grad()
def restore_training_state(ts: TrainingState, saved: Dict[str, Any]) -> None:
    """Load a `checkpoint_state` (tensors on any device) into `ts` in place."""
    for name in ("policy_params", "q_params", "target_q_params"):
        for k, v in getattr(ts, name).items():
            v.copy_(saved[name][k])
    ts.log_alpha.copy_(saved["log_alpha"])
    for name in ("policy_optimizer", "q_optimizer", "alpha_optimizer"):
        getattr(ts, name).load_state_dict(saved[name])
    ts.normalizer_params = saved["normalizer_params"].to(ts.log_alpha.device)
    ts.train_iters = int(saved["train_iters"])


@full_f32_matmul()
def train(
    environment: MjxEnv,
    num_timesteps: int = 1_000_000,
    episode_length: int = 1000,
    action_repeat: int = 1,
    num_envs: int = 128,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    discounting: float = 0.9,
    seed: int = 0,
    batch_size: int = 256,
    num_evals: int = 1,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    tau: float = 0.005,
    min_replay_size: int = 0,
    max_replay_size: int = 1_000_000,
    grad_updates_per_step: int = 1,
    network_factory: Callable = sac_networks_lib.make_sac_networks,
    progress_fn: Callable[[int, Dict[str, Any]], None] = lambda *args: None,
    mesh: Optional[Any] = None,
    checkpoint_path: Optional[str] = None,
    restore_checkpoint_path: Optional[str] = None,
    device="cuda",
) -> Tuple[Callable, Tuple[Any, Any], Dict[str, Any]]:
    """Train a SAC agent on `device` (the card unless "cpu" is asked for);
    returns (make_policy, (normalizer_params, policy_params), metrics).
    Besides the JAX package's keys (`eval/episode_reward`,
    `training/critic_loss`, `actor_loss`, `alpha_loss`, `alpha`), metrics
    carry `timing/actor_s`, `timing/sgd_s` and `timing/eval_s` (host
    seconds of the epoch's actor steps, SGD steps and eval) and
    `timing/prefill_s` (the prefill's), each ended by a device synchronize."""
    refuse_mesh(mesh)
    device = check_device(device)
    environment = environment.to(device)
    env = wrappers.wrap_for_training(environment, episode_length, action_repeat)
    eval_env = wrappers.wrap_for_training(environment, episode_length, action_repeat)
    obs_size = environment.observation_size
    action_size = environment.action_size

    env_steps_per_actor_step = num_envs * action_repeat
    num_prefill_actor_steps = max(-(-min_replay_size // num_envs), 1)
    prefill_env_steps = num_prefill_actor_steps * env_steps_per_actor_step
    num_evals_after_init = max(num_evals - 1, 1)
    num_training_steps_per_epoch = max(
        1, -(-(num_timesteps - prefill_env_steps) // (env_steps_per_actor_step * num_evals_after_init))
    )

    preprocess = (
        running_statistics.normalize if normalize_observations else sac_networks_lib.identity_observation_preprocessor
    )
    sac_network = network_factory(obs_size, action_size, preprocess_observations_fn=preprocess)
    make_policy = sac_networks_lib.make_inference_fn(sac_network)
    dist = sac_network.parametric_action_distribution
    target_entropy = -0.5 * action_size  # brax SAC's default
    loss_kw = dict(target_entropy=target_entropy, reward_scaling=reward_scaling, discounting=discounting, tau=tau)

    generator = torch.Generator(device=device).manual_seed(seed)
    ts = make_training_state(
        sac_network.policy_network.init(generator), sac_network.q_network.init(generator),
        torch.zeros((), device=device), running_statistics.init_state(torch.zeros(obs_size, device=device)),
        learning_rate,
    )
    if restore_checkpoint_path is not None:
        from ambersim_tpu_torch.io.checkpoint import load_params

        restore_training_state(ts, load_params(restore_checkpoint_path, device=device))

    zeros = torch.zeros((), device=device)
    buffer = replay.init(max_replay_size, sac_losses.Transition(
        observation=torch.zeros(obs_size, device=device), action=torch.zeros(action_size, device=device),
        reward=zeros, discount=zeros, truncation=zeros, next_observation=torch.zeros(obs_size, device=device),
    ))

    def policy_params():
        return (ts.normalizer_params, {k: v.detach() for k, v in ts.policy_params.items()})

    @torch.no_grad()
    def actor_step(env_state: State, random_actions: bool) -> State:
        nonlocal buffer
        if random_actions:
            raw = torch.randn((num_envs, action_size), generator=generator, device=device)
        else:
            logits = sac_network.policy_network.apply(ts.normalizer_params, ts.policy_params, env_state.obs)
            raw = dist.sample_no_postprocessing(logits, generator)
        next_state = env.step(env_state, dist.postprocess(raw))
        transitions = sac_losses.Transition(
            observation=env_state.obs, action=raw, reward=next_state.reward, discount=1 - next_state.done,
            truncation=next_state.info["truncation"], next_observation=next_state.obs,
        )
        if normalize_observations:
            ts.normalizer_params = running_statistics.update(ts.normalizer_params, transitions.observation)
        buffer = replay.insert(buffer, transitions)
        return next_state

    def training_step(env_state: State, timing: Dict[str, float]):
        t0 = time.perf_counter()
        env_state = actor_step(env_state, random_actions=False)
        sync(device)
        t1 = time.perf_counter()
        step_metrics = []
        for _ in range(grad_updates_per_step):
            transitions = replay.sample(buffer, generator, batch_size)
            noise = torch.randn((3, batch_size, action_size), generator=generator, device=device)
            step_metrics.append(sgd_step(ts, transitions, noise, sac_network, **loss_kw))
        ts.train_iters += 1
        sync(device)
        timing["timing/actor_s"] += t1 - t0
        timing["timing/sgd_s"] += time.perf_counter() - t1
        return env_state, {k: torch.stack([m[k] for m in step_metrics]).mean() for k in step_metrics[0]}

    def evaluate() -> torch.Tensor:
        return episode_return(eval_env, make_policy(policy_params(), deterministic=True), generator, num_eval_envs,
                              episode_length // action_repeat)

    metrics: Dict[str, Any] = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        env_state = env.reset(generator, num_envs)
    for _ in range(num_prefill_actor_steps):
        env_state = actor_step(env_state, random_actions=True)
    sync(device)
    prefill_s = time.perf_counter() - t0
    if num_evals > 1:
        metrics = {"eval/episode_reward": float(evaluate())}
        progress_fn(0, metrics)

    for _ in range(num_evals_after_init):
        timing = {"timing/actor_s": 0.0, "timing/sgd_s": 0.0}
        step_metrics = []
        for _ in range(num_training_steps_per_epoch):
            env_state, m = training_step(env_state, timing)
            step_metrics.append(m)
        t0 = time.perf_counter()
        episode_reward = evaluate()
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
            "timing/prefill_s": prefill_s,
        }
        progress_fn(prefill_env_steps + ts.train_iters * env_steps_per_actor_step, metrics)
        if checkpoint_path is not None:
            from ambersim_tpu_torch.io.checkpoint import save_params

            save_params(checkpoint_path, checkpoint_state(ts))

    return make_policy, policy_params(), metrics
