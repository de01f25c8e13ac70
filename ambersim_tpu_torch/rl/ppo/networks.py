"""PPO network factories (port of ambersim_tpu/rl/ppo/networks.py).

As in the JAX package, a network is an (init, apply) pair and its params
are data: `init(generator)` returns a dict of tensors (an `nn.Module`'s
parameter names to values) and `apply(processor_params, params, obs)` runs
the module on those params with `torch.func.functional_call`. So the
trainer, the checkpoint and the bridge from the JAX package's params all
handle plain dicts of tensors.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from ambersim_tpu_torch.learning.architectures import MLP
from ambersim_tpu_torch.rl.ppo.distributions import NormalTanhDistribution, ParametricDistribution

Params = Dict[str, torch.Tensor]


def identity_observation_preprocessor(observations, preprocessor_params):
    """No-op preprocessor."""
    return observations


@dataclasses.dataclass(frozen=True)
class FeedForwardNetwork:
    init: Callable[[torch.Generator], Params]
    apply: Callable[[Any, Params, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PPONetworks:
    policy_network: FeedForwardNetwork
    value_network: FeedForwardNetwork
    parametric_action_distribution: ParametricDistribution


def make_network(module: nn.Module, obs_size: int, preprocess_observations_fn) -> FeedForwardNetwork:
    """Wrap a module with observation preprocessing into an (init, apply)
    pair. `module.reset_parameters(generator)` draws fresh weights."""

    def init_fn(generator: torch.Generator) -> Params:
        fresh = copy.deepcopy(module).to(generator.device)
        fresh.reset_parameters(generator)
        return {k: p.detach().clone() for k, p in fresh.named_parameters()}

    def apply_fn(processor_params, params: Params, obs: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(module, params, (preprocess_observations_fn(obs, processor_params),))

    return FeedForwardNetwork(init=init_fn, apply=apply_fn)


def scalar_head(network: FeedForwardNetwork) -> FeedForwardNetwork:
    """The network with its last axis (of size 1) dropped: the value network."""
    return FeedForwardNetwork(
        init=network.init, apply=lambda pp, p, obs: network.apply(pp, p, obs).squeeze(-1)
    )


def make_ppo_networks(
    observation_size: int,
    action_size: int,
    preprocess_observations_fn=identity_observation_preprocessor,
    policy_hidden_layer_sizes: Sequence[int] = (32,) * 4,
    value_hidden_layer_sizes: Sequence[int] = (256,) * 5,
    activation=nn.functional.silu,
) -> PPONetworks:
    """PPO policy and value networks at the JAX package's default sizes;
    silu is jax.nn.swish."""
    dist = NormalTanhDistribution(event_size=action_size)
    policy = MLP(observation_size, list(policy_hidden_layer_sizes) + [dist.param_size], activation=activation)
    value = MLP(observation_size, list(value_hidden_layer_sizes) + [1], activation=activation)
    return PPONetworks(
        policy_network=make_network(policy, observation_size, preprocess_observations_fn),
        value_network=scalar_head(make_network(value, observation_size, preprocess_observations_fn)),
        parametric_action_distribution=dist,
    )


def make_inference_fn(ppo_networks: PPONetworks):
    """make_policy(params, deterministic=False) -> policy(obs, seed) ->
    (action, extras). `seed` is a torch.Generator or a noise tensor (unused
    when deterministic)."""

    def make_policy(params: Tuple[Any, Params], deterministic: bool = False):
        normalizer_params, policy_params = params[0], params[1]
        dist = ppo_networks.parametric_action_distribution

        def policy(observations: torch.Tensor, seed=None):
            logits = ppo_networks.policy_network.apply(normalizer_params, policy_params, observations)
            if deterministic:
                return dist.mode(logits), {}
            raw = dist.sample_no_postprocessing(logits, seed)
            log_prob = dist.log_prob(logits, raw)
            return dist.postprocess(raw), {"log_prob": log_prob, "raw_action": raw}

        return policy

    return make_policy
