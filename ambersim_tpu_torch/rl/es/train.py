"""Evolution Strategies trainer (port of ambersim_tpu/rl/es/train.py).

OpenAI-ES with mirrored sampling and centered-rank fitness shaping. Each
policy update draws `population_size // 2` normals per parameter leaf,
mirrors them (`[e; -e]`), rolls out one env per population member, each
acting with the mode of its own perturbed params (`population_rollout`:
`torch.func.vmap` of the network's apply over the leading member axis, a
batched matmul per layer), and hands the fitness-weighted direction with
its l2 term to `torch.optim.Adam` as the params' `.grad`. No gradient runs
through anything; the rollouts step under `torch.no_grad()`.

The update (`es_update`) takes the noise, the returns and the obs as
tensors, so a test can replay the JAX package's draws. Random draws come
from one explicit `torch.Generator` on the training device. The JAX
package's slim-carry scan is not needed: the loop is eager, as in the
port's PPO and APG.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ambersim_tpu_torch.engine.forward import full_f32_matmul
from ambersim_tpu_torch.rl import wrappers

# APG's training state (params, Adam, normalizer, train_iters) and its checkpoint
from ambersim_tpu_torch.rl.apg.train import (
    TrainingState,
    checkpoint_state,
    make_deterministic_networks,
    restore_training_state,
)
from ambersim_tpu_torch.rl.base import MjxEnv, State
from ambersim_tpu_torch.rl.common import check_device, episode_return, refuse_mesh, sync
from ambersim_tpu_torch.rl.ppo import running_statistics
from ambersim_tpu_torch.rl.ppo.networks import Params, PPONetworks, identity_observation_preprocessor, make_inference_fn


def centered_rank(fitness: torch.Tensor) -> torch.Tensor:
    """Centered-rank fitness shaping: raw returns to [-0.5, 0.5] by rank.
    Both argsorts are stable, as `jnp.argsort` is, so tied returns rank in
    index order as in the JAX package."""
    n = fitness.shape[0]
    ranks = torch.argsort(torch.argsort(fitness, stable=True), stable=True)
    return ranks.to(torch.float32) / (n - 1) - 0.5


@torch.no_grad()
def population_rollout(
    env: MjxEnv,
    network: PPONetworks,
    pop_params: Params,
    normalizer_params,
    state: State,
    steps: int,
    reward_shift: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`steps` control steps of one env per member from `state`, each
    acting with the mode of its own params: every leaf of `pop_params`
    carries a leading member axis, and member i's logits are its params
    applied to obs[i] (the JAX package's `jax.vmap(policy_network.apply)`
    over (pop_params, obs)). Returns the episode returns summed until each
    env's first done with `reward_shift` taken off every reward, the same
    without the shift, and the obs after every step (steps, members,
    obs_size)."""
    dist = network.parametric_action_distribution
    apply = torch.func.vmap(lambda p, o: network.policy_network.apply(normalizer_params, p, o))
    n = state.obs.shape[0]
    active = torch.ones(n, device=state.obs.device)
    total = torch.zeros(n, device=state.obs.device)
    raw = torch.zeros(n, device=state.obs.device)
    obs = []
    for _ in range(steps):
        state = env.step(state, dist.mode(apply(pop_params, state.obs)))
        total = total + (state.reward - reward_shift) * active
        raw = raw + state.reward * active
        active = active * (1 - state.done)
        obs.append(state.obs)
    return total, raw, torch.stack(obs)


def mirrored_noise(generator: torch.Generator, params: Params, population_size: int) -> Params:
    """Per leaf, `population_size // 2` standard normals of the leaf's shape,
    then their negatives: (population_size,) + leaf shape."""
    half = population_size // 2
    eps = {}
    for k, p in params.items():
        e = torch.randn((half,) + tuple(p.shape), generator=generator, device=generator.device).to(p.device)
        eps[k] = torch.cat([e, -e])
    return eps


def make_training_state(policy_params: Params, normalizer_params, learning_rate: float) -> TrainingState:
    """Fresh leaf copies of `policy_params` and an Adam over them (optax's
    defaults)."""
    params = {k: v.detach().clone() for k, v in policy_params.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainingState(policy_params=params, optimizer=optimizer, normalizer_params=normalizer_params)


@torch.no_grad()
def es_update(
    ts: TrainingState,
    eps: Params,
    returns: torch.Tensor,
    obs: torch.Tensor,
    perturbation_std: float,
    l2coeff: float,
    fitness_shaping: Callable[[torch.Tensor], torch.Tensor] = centered_rank,
    normalize_observations: bool = False,
) -> Dict[str, torch.Tensor]:
    """One policy update from the population's noise `eps` (leading axis
    population_size), its `returns` and the rollout's `obs`: Adam on the
    negated fitness-weighted direction plus l2coeff * params, then the
    normalizer over every obs. Updates `ts` in place; returns the fitness
    metrics on the device."""
    population_size = returns.shape[0]
    weights = fitness_shaping(returns)
    for k, p in ts.policy_params.items():
        p.grad = -(torch.tensordot(weights, eps[k], dims=1) / (population_size * perturbation_std)) + l2coeff * p
    ts.optimizer.step()
    if normalize_observations:
        ts.normalizer_params = running_statistics.update(ts.normalizer_params, obs.reshape(-1, obs.shape[-1]))
    ts.train_iters += 1
    return {"fitness_mean": returns.mean(), "fitness_max": returns.max()}


@full_f32_matmul()
def train(
    environment: MjxEnv,
    episode_length: int = 1000,
    action_repeat: int = 1,
    population_size: int = 128,
    perturbation_std: float = 0.1,
    learning_rate: float = 0.01,
    l2coeff: float = 0.005,
    fitness_shaping: Callable[[torch.Tensor], torch.Tensor] = centered_rank,
    num_eval_envs: int = 128,
    policy_updates: int = 100,
    seed: int = 0,
    num_evals: int = 1,
    normalize_observations: bool = False,
    network_factory: Callable = make_deterministic_networks,
    progress_fn: Callable[[int, Dict[str, Any]], None] = lambda *args: None,
    mesh: Optional[Any] = None,
    checkpoint_path: Optional[str] = None,
    restore_checkpoint_path: Optional[str] = None,
    device="cuda",
) -> Tuple[Callable, Tuple[Any, Any], Dict[str, Any]]:
    """Train a policy by evolution strategies on `device` (the card unless
    "cpu" is asked for); returns (make_policy, (normalizer_params,
    policy_params), metrics). Besides the JAX package's `eval/episode_reward`,
    `training/fitness_mean` and `training/fitness_max`, metrics carry
    `timing/rollout_s`, `timing/update_s` and `timing/eval_s`: host seconds
    of the epoch's population rollouts, updates and eval, each ended by a
    device synchronize."""
    if population_size % 2 != 0:
        raise ValueError("population_size must be even (mirrored sampling)")
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
    env_steps_per_update = population_size * episode_length * action_repeat

    preprocess = running_statistics.normalize if normalize_observations else identity_observation_preprocessor
    es_network = network_factory(obs_size, action_size, preprocess_observations_fn=preprocess)
    make_policy = make_inference_fn(es_network)

    generator = torch.Generator(device=device).manual_seed(seed)
    ts = make_training_state(es_network.policy_network.init(generator),
                             running_statistics.init_state(torch.zeros(obs_size, device=device)), learning_rate)
    if restore_checkpoint_path is not None:
        from ambersim_tpu_torch.io.checkpoint import load_params

        restore_training_state(ts, load_params(restore_checkpoint_path, device=device))

    def policy_params():
        return (ts.normalizer_params, ts.policy_params)

    def training_step(timing: Dict[str, float]) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        eps = mirrored_noise(generator, ts.policy_params, population_size)
        pop_params = {k: p[None] + perturbation_std * eps[k] for k, p in ts.policy_params.items()}
        with torch.no_grad():
            state = env.reset(generator, population_size)
        returns, _, obs = population_rollout(env, es_network, pop_params, ts.normalizer_params, state, steps)
        sync(device)
        t1 = time.perf_counter()
        metrics = es_update(ts, eps, returns, obs, perturbation_std, l2coeff, fitness_shaping, normalize_observations)
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
        # one readback for the eval and every fitness metric of the epoch
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
