"""SAC losses (port of ambersim_tpu/rl/sac/losses.py): the twin-Q TD
critic, the reparameterized actor and the entropy temperature.

Each loss takes its standard normals as `seed` (a torch.Generator, or the
draws themselves as a tensor, so a test can pass the JAX package's). What
the JAX package wraps in `jax.lax.stop_gradient` is computed under
`torch.no_grad()` here, and each loss differentiates only its first
argument, as `jax.value_and_grad` does: the other params are read
detached.
"""

from __future__ import annotations

import dataclasses

import torch

from ambersim_tpu_torch.core.types import _Tensors
from ambersim_tpu_torch.rl.ppo.distributions import Seed


@dataclasses.dataclass
class Transition(_Tensors):
    observation: torch.Tensor
    action: torch.Tensor  # raw (pre-tanh) action
    reward: torch.Tensor
    discount: torch.Tensor  # 1 - done
    truncation: torch.Tensor  # 1 where the episode ended by the time limit
    next_observation: torch.Tensor

    def map(self, fn) -> "Transition":
        return Transition(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})


def _detached(params):
    return {k: v.detach() for k, v in params.items()}


def alpha_loss(log_alpha, policy_params, normalizer_params, transitions: Transition, seed: Seed, sac_networks,
               target_entropy: float) -> torch.Tensor:
    """Temperature loss: alpha * E[-log pi(a|s) - target_entropy]."""
    dist = sac_networks.parametric_action_distribution
    with torch.no_grad():
        logits = sac_networks.policy_network.apply(normalizer_params, _detached(policy_params), transitions.observation)
        log_prob = dist.log_prob(logits, dist.sample_no_postprocessing(logits, seed))
    return torch.mean(torch.exp(log_alpha) * (-log_prob - target_entropy))


def critic_loss(q_params, policy_params, normalizer_params, target_q_params, alpha, transitions: Transition,
                seed: Seed, sac_networks, reward_scaling: float, discounting: float) -> torch.Tensor:
    """Half the mean squared TD error of every critic against the target
    critics' soft value of the next state; timeout transitions (truncation
    1) are masked out, since their done is not a real absorbing state."""
    dist = sac_networks.parametric_action_distribution
    q_old = sac_networks.q_network.apply(normalizer_params, q_params, transitions.observation,
                                         dist.postprocess(transitions.action))
    with torch.no_grad():
        next_logits = sac_networks.policy_network.apply(normalizer_params, _detached(policy_params),
                                                        transitions.next_observation)
        next_raw = dist.sample_no_postprocessing(next_logits, seed)
        next_log_prob = dist.log_prob(next_logits, next_raw)
        next_q = sac_networks.q_network.apply(normalizer_params, _detached(target_q_params),
                                              transitions.next_observation, dist.postprocess(next_raw))
        next_v = torch.amin(next_q, dim=-1) - torch.as_tensor(alpha).detach() * next_log_prob
        target_q = transitions.reward * reward_scaling + transitions.discount * discounting * next_v
    q_error = q_old - target_q.unsqueeze(-1)
    mask = (1.0 - transitions.truncation).unsqueeze(-1)
    return 0.5 * torch.mean(torch.square(q_error) * mask)


def actor_loss(policy_params, q_params, normalizer_params, alpha, transitions: Transition, seed: Seed,
               sac_networks) -> torch.Tensor:
    """E[alpha log pi(a|s) - min_i Q_i(s, a)] with a = tanh(loc + scale *
    noise), differentiated through the sample (the critics read detached)."""
    dist = sac_networks.parametric_action_distribution
    logits = sac_networks.policy_network.apply(normalizer_params, policy_params, transitions.observation)
    raw = dist.sample_no_postprocessing(logits, seed)
    log_prob = dist.log_prob(logits, raw)
    q_action = sac_networks.q_network.apply(normalizer_params, _detached(q_params), transitions.observation,
                                            dist.postprocess(raw))
    return torch.mean(torch.as_tensor(alpha).detach() * log_prob - torch.amin(q_action, dim=-1))
