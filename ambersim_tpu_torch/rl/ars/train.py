"""ARS trainer (port of ambersim_tpu/rl/ars/train.py).

Augmented Random Search V2-t: for each of `number_of_directions` directions
delta_i, roll out theta + sigma delta_i and theta - sigma delta_i for a
full episode (2 N envs, one per candidate, each acting with the mode of its
own params), keep the `top_directions` pairs by max(r+, r-), and step

    theta += step_size / (top_b * sigma_R) * sum_b (r+_b - r-_b) * delta_b

where sigma_R is the population std (ddof 0) of the kept returns, clamped
at 1e-6. No optimizer. The update (`ars_update`) takes the directions, the
returns and the obs as tensors, so a test can replay the JAX package's
draws; the rollout is ES's (`es.train.population_rollout`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ambersim_tpu_torch.engine.forward import full_f32_matmul
from ambersim_tpu_torch.rl import wrappers
from ambersim_tpu_torch.rl.apg.train import make_deterministic_networks
from ambersim_tpu_torch.rl.base import MjxEnv
from ambersim_tpu_torch.rl.common import check_device, episode_return, refuse_mesh, sync
from ambersim_tpu_torch.rl.es.train import population_rollout
from ambersim_tpu_torch.rl.ppo import running_statistics
from ambersim_tpu_torch.rl.ppo.networks import Params, identity_observation_preprocessor, make_inference_fn


@dataclasses.dataclass
class TrainingState:
    policy_params: Params
    normalizer_params: running_statistics.RunningStatisticsState
    train_iters: int = 0


def draw_directions(generator: torch.Generator, params: Params, number_of_directions: int) -> Params:
    """Per leaf, `number_of_directions` standard normals of its shape."""
    return {k: torch.randn((number_of_directions,) + tuple(p.shape), generator=generator,
                           device=generator.device).to(p.device) for k, p in params.items()}


def candidates(params: Params, deltas: Params, exploration_noise_std: float) -> Params:
    """The candidate layout [theta + s * delta ; theta - s * delta] per leaf."""
    return {k: torch.cat([p[None] + exploration_noise_std * deltas[k], p[None] - exploration_noise_std * deltas[k]])
            for k, p in params.items()}


def top_directions_of(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest scores, largest first, ties to the lower
    index (`jax.lax.top_k`'s order; a stable descending sort, not
    `torch.topk`, whose order among ties is unspecified)."""
    return torch.argsort(scores, descending=True, stable=True)[:k]


@torch.no_grad()
def ars_update(
    ts: TrainingState,
    deltas: Params,
    returns: torch.Tensor,
    raw_returns: torch.Tensor,
    obs: torch.Tensor,
    top_directions: int,
    step_size: float,
    normalize_observations: bool = True,
) -> Dict[str, torch.Tensor]:
    """One V2-t update from the directions `deltas` (leading axis N), the
    2 N candidates' shifted `returns` (selection and step) and `raw_returns`
    (metrics) and the rollout's `obs`. Updates `ts` in place; returns the
    metrics on the device."""
    n = returns.shape[0] // 2
    r_plus, r_minus = returns[:n], returns[n:]
    top = top_directions_of(torch.maximum(r_plus, r_minus), top_directions)
    rp, rm = r_plus[top], r_minus[top]
    reward_std = torch.clamp(torch.std(torch.cat([rp, rm]), correction=0), min=1e-6)
    coeff = step_size / (top_directions * reward_std)
    ts.policy_params = {k: p + coeff * torch.tensordot(rp - rm, deltas[k][top], dims=1)
                        for k, p in ts.policy_params.items()}
    if normalize_observations:
        ts.normalizer_params = running_statistics.update(ts.normalizer_params, obs.reshape(-1, obs.shape[-1]))
    ts.train_iters += 1
    raw_scores = torch.maximum(raw_returns[:n], raw_returns[n:])
    return {"fitness_mean": raw_returns.mean(), "fitness_top": raw_scores[top].mean(), "reward_std": reward_std}


def checkpoint_state(ts: TrainingState) -> Dict[str, Any]:
    """What `checkpoint_path` saves (io.checkpoint.save_params) and
    `restore_checkpoint_path` reads."""
    return {"policy_params": ts.policy_params, "normalizer_params": ts.normalizer_params,
            "train_iters": ts.train_iters}


@full_f32_matmul()
def train(
    environment: MjxEnv,
    episode_length: int = 1000,
    action_repeat: int = 1,
    number_of_directions: int = 60,
    top_directions: int = 20,
    step_size: float = 0.015,
    exploration_noise_std: float = 0.025,
    reward_shift: float = 0.0,
    num_eval_envs: int = 128,
    policy_updates: int = 100,
    seed: int = 0,
    num_evals: int = 1,
    normalize_observations: bool = True,
    network_factory: Callable = make_deterministic_networks,
    progress_fn: Callable[[int, Dict[str, Any]], None] = lambda *args: None,
    mesh: Optional[Any] = None,
    checkpoint_path: Optional[str] = None,
    restore_checkpoint_path: Optional[str] = None,
    device="cuda",
) -> Tuple[Callable, Tuple[Any, Any], Dict[str, Any]]:
    """Train a policy by augmented random search on `device` (the card
    unless "cpu" is asked for); returns (make_policy, (normalizer_params,
    policy_params), metrics). Besides the JAX package's `eval/episode_reward`,
    `training/fitness_mean`, `training/fitness_top` and `training/reward_std`,
    metrics carry `timing/rollout_s`, `timing/update_s` and `timing/eval_s`:
    host seconds of the epoch's rollouts, updates and eval, each ended by a
    device synchronize."""
    if not 0 < top_directions <= number_of_directions:
        raise ValueError("need 0 < top_directions <= number_of_directions")
    refuse_mesh(mesh)
    device = check_device(device)
    environment = environment.to(device)
    env = wrappers.wrap_for_training(environment, episode_length, action_repeat)
    eval_env = wrappers.wrap_for_training(environment, episode_length, action_repeat)
    obs_size = environment.observation_size
    action_size = environment.action_size
    num_candidates = 2 * number_of_directions
    steps = episode_length // action_repeat

    num_evals_after_init = max(num_evals - 1, 1)
    updates_per_epoch = max(1, -(-policy_updates // num_evals_after_init))
    env_steps_per_update = num_candidates * episode_length * action_repeat

    preprocess = running_statistics.normalize if normalize_observations else identity_observation_preprocessor
    ars_network = network_factory(obs_size, action_size, preprocess_observations_fn=preprocess)
    make_policy = make_inference_fn(ars_network)

    generator = torch.Generator(device=device).manual_seed(seed)
    ts = TrainingState(policy_params=ars_network.policy_network.init(generator),
                       normalizer_params=running_statistics.init_state(torch.zeros(obs_size, device=device)))
    if restore_checkpoint_path is not None:
        from ambersim_tpu_torch.io.checkpoint import load_params

        saved = load_params(restore_checkpoint_path, device=device)
        ts = TrainingState(policy_params=saved["policy_params"], normalizer_params=saved["normalizer_params"],
                           train_iters=int(saved["train_iters"]))

    def policy_params():
        return (ts.normalizer_params, ts.policy_params)

    def training_step(timing: Dict[str, float]) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        deltas = draw_directions(generator, ts.policy_params, number_of_directions)
        with torch.no_grad():
            state = env.reset(generator, num_candidates)
        returns, raw_returns, obs = population_rollout(
            env, ars_network, candidates(ts.policy_params, deltas, exploration_noise_std), ts.normalizer_params,
            state, steps, reward_shift,
        )
        sync(device)
        t1 = time.perf_counter()
        metrics = ars_update(ts, deltas, returns, raw_returns, obs, top_directions, step_size, normalize_observations)
        sync(device)
        timing["timing/rollout_s"] += t1 - t0
        timing["timing/update_s"] += time.perf_counter() - t1
        return metrics

    def evaluate() -> torch.Tensor:
        return episode_return(eval_env, make_policy(policy_params(), deterministic=True), generator, num_eval_envs,
                              steps)

    metrics: Dict[str, Any] = {}
    if num_evals > 1:
        metrics = {"eval/episode_reward": float(evaluate())}
        progress_fn(0, metrics)

    for _ in range(num_evals_after_init):
        timing = {"timing/rollout_s": 0.0, "timing/update_s": 0.0}
        step_metrics = [training_step(timing) for _ in range(updates_per_epoch)]
        t0 = time.perf_counter()
        episode_reward = evaluate()
        keys = list(step_metrics[0])
        # one readback for the eval and every metric of the epoch
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
