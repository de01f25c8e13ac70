"""PPO losses: GAE + clipped surrogate (port of ambersim_tpu/rl/ppo/losses.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ambersim_tpu_torch.core.types import _Tensors
from ambersim_tpu_torch.rl.ppo.distributions import Seed


@dataclasses.dataclass
class Transition(_Tensors):
    """Env transitions, time-major in rollouts: (unroll, batch, ...)."""

    observation: torch.Tensor
    action: torch.Tensor  # postprocessed action
    raw_action: torch.Tensor
    log_prob: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor  # 0 where terminated
    truncation: torch.Tensor  # 1 where the episode was cut by the time limit
    next_observation: torch.Tensor

    def map(self, fn) -> "Transition":
        return Transition(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})


@torch.no_grad()
def compute_gae(
    truncation: torch.Tensor,
    termination: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    lambda_: float = 0.95,
    discount: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a time-major rollout.

    Args: all (T, B); bootstrap_value (B,). Returns (vs, advantages), both
    without gradient (the JAX package's stop_gradient)."""
    truncation_mask = 1 - truncation
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = (rewards + discount * (1 - termination) * values_t_plus_1 - values) * truncation_mask
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = torch.empty_like(values)
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + discount * (1 - termination[t]) * truncation_mask[t] * lambda_ * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    advantages = (rewards + discount * (1 - termination) * vs_t_plus_1 - values) * truncation_mask
    return vs, advantages


def compute_ppo_loss(
    params: Dict[str, Any],
    normalizer_params,
    data: Transition,
    rng: Seed,
    ppo_networks,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped-surrogate PPO loss on one minibatch of time-major rollouts.
    `rng` (a generator or the normals themselves) feeds the sample-based
    entropy."""
    policy_params, value_params = params["policy"], params["value"]
    dist = ppo_networks.parametric_action_distribution

    logits = ppo_networks.policy_network.apply(normalizer_params, policy_params, data.observation)
    baseline = ppo_networks.value_network.apply(normalizer_params, value_params, data.observation)
    bootstrap = ppo_networks.value_network.apply(normalizer_params, value_params, data.next_observation[-1])

    rewards = data.reward * reward_scaling
    truncation = data.truncation
    termination = (1 - data.discount) * (1 - truncation)

    target_log_prob = dist.log_prob(logits, data.raw_action)
    vs, advantages = compute_gae(
        truncation=truncation,
        termination=termination,
        rewards=rewards,
        values=baseline,
        bootstrap_value=bootstrap,
        lambda_=gae_lambda,
        discount=discounting,
    )
    if normalize_advantage:
        # population std, as jnp.std
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)

    rho = torch.exp(target_log_prob - data.log_prob)
    surrogate = rho * advantages
    surrogate_clipped = torch.clamp(rho, 1 - clipping_epsilon, 1 + clipping_epsilon) * advantages
    policy_loss = -torch.minimum(surrogate, surrogate_clipped).mean()

    v_error = vs - baseline
    v_loss = 0.5 * 0.5 * (v_error * v_error).mean()

    entropy = dist.entropy(logits, rng).mean()
    entropy_loss = -entropy_cost * entropy

    total = policy_loss + v_loss + entropy_loss
    return total, {
        "total_loss": total.detach(),
        "policy_loss": policy_loss.detach(),
        "v_loss": v_loss.detach(),
        "entropy_loss": entropy_loss.detach(),
    }
