"""Pickle-able PPO network bundle (port of ambersim_tpu/rl/helpers.py).

Bundles the policy module, the value module and the action distribution
class, so that a saved policy can rebuild its networks from the pickle
alone. The modules are `nn.Module`s taking (B, observation_size) inputs,
with `reset_parameters(generator)` (as learning.architectures.MLP has).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Type

import torch
from torch import nn

from ambersim_tpu_torch.rl.ppo.distributions import ParametricDistribution
from ambersim_tpu_torch.rl.ppo.networks import (
    PPONetworks,
    identity_observation_preprocessor,
    make_network,
    scalar_head,
)


@dataclasses.dataclass(frozen=True)
class PPONetworksWrapper:
    """Pickle-able bundle of policy/value modules + action distribution."""

    policy_network: nn.Module
    value_network: nn.Module
    action_distribution: Type[ParametricDistribution]

    def make_ppo_networks(
        self,
        observation_size: int,
        action_size: int,
        preprocess_observations_fn: Callable = identity_observation_preprocessor,
    ) -> PPONetworks:
        """Build PPONetworks, checking the output sizes on a dummy input."""
        dist = self.action_distribution(event_size=action_size)
        dummy = torch.zeros((1, observation_size))
        with torch.no_grad():
            policy_out = self.policy_network(dummy).shape
            value_out = self.value_network(dummy).shape
        if policy_out[-1] != dist.param_size:
            raise ValueError(
                f"policy network output size {policy_out[-1]} does not match "
                f"distribution param_size {dist.param_size}"
            )
        if value_out[-1] != 1:
            raise ValueError(f"value network must output a scalar, got size {value_out[-1]}")
        return PPONetworks(
            policy_network=make_network(self.policy_network, observation_size, preprocess_observations_fn),
            value_network=scalar_head(make_network(self.value_network, observation_size, preprocess_observations_fn)),
            parametric_action_distribution=dist,
        )


# the name the JAX package also exports
BraxPPONetworksWrapper = PPONetworksWrapper
