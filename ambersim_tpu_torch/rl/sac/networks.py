"""SAC network factories (port of ambersim_tpu/rl/sac/networks.py).

The policy is an MLP into a tanh-Normal head. The twin-Q critics are one
MLP whose parameters are stacked on a leading n_critics axis, each critic
initialized from its own draw, and applied in one batched pass
(`torch.func.vmap` of the module's functional call over that axis: a
batched matmul per layer) that returns (batch, n_critics).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch

from ambersim_tpu_torch.learning.architectures import MLP
from ambersim_tpu_torch.rl.ppo.distributions import NormalTanhDistribution, ParametricDistribution
from ambersim_tpu_torch.rl.ppo.networks import (  # noqa: F401  (identity_... is re-exported, as in the JAX package)
    FeedForwardNetwork,
    identity_observation_preprocessor,
    make_network,
)


@dataclasses.dataclass(frozen=True)
class SACNetworks:
    policy_network: FeedForwardNetwork
    q_network: FeedForwardNetwork
    parametric_action_distribution: ParametricDistribution


def make_q_network(
    obs_size: int,
    action_size: int,
    preprocess_observations_fn=identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (256, 256),
    activation=torch.relu,
    n_critics: int = 2,
) -> FeedForwardNetwork:
    """Q(s, a) with `n_critics` independent heads: init(generator) stacks
    each critic's params (drawn one after the other) on a leading axis;
    apply(processor_params, params, obs, actions) returns (batch, n_critics)."""
    module = MLP(obs_size + action_size, list(hidden_layer_sizes) + [1], activation=activation)
    single = make_network(module, obs_size + action_size, identity_observation_preprocessor)

    def init_fn(generator: torch.Generator):
        critics = [single.init(generator) for _ in range(n_critics)]
        return {k: torch.stack([c[k] for c in critics]) for k in critics[0]}

    def apply_fn(processor_params, params, obs, actions):
        x = torch.cat([preprocess_observations_fn(obs, processor_params), actions], dim=-1)
        out = torch.func.vmap(lambda p: torch.func.functional_call(module, p, (x,)))(params)  # (n_critics, batch, 1)
        return out.squeeze(-1).T

    return FeedForwardNetwork(init=init_fn, apply=apply_fn)


def make_sac_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn=identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (256, 256),
    activation=torch.relu,
) -> SACNetworks:
    """SAC's policy and twin critics at the JAX package's default sizes."""
    dist = NormalTanhDistribution(event_size=action_size)
    policy = MLP(observation_size, list(hidden_layer_sizes) + [dist.param_size], activation=activation)
    return SACNetworks(
        policy_network=make_network(policy, observation_size, preprocess_observations_fn),
        q_network=make_q_network(observation_size, action_size, preprocess_observations_fn,
                                 hidden_layer_sizes=hidden_layer_sizes, activation=activation),
        parametric_action_distribution=dist,
    )


def make_inference_fn(sac_networks: SACNetworks):
    """make_policy(params, deterministic=False) -> policy(obs, seed) ->
    (action, {}). `seed` is a torch.Generator or a noise tensor (unused when
    deterministic)."""

    def make_policy(params: Tuple[Any, Any], deterministic: bool = False):
        normalizer_params, policy_params = params[0], params[1]
        dist = sac_networks.parametric_action_distribution

        def policy(observations: torch.Tensor, seed=None):
            logits = sac_networks.policy_network.apply(normalizer_params, policy_params, observations)
            if deterministic:
                return dist.mode(logits), {}
            return dist.sample(logits, seed), {}

        return policy

    return make_policy
