"""Parametric action distributions (port of ambersim_tpu/rl/ppo/distributions.py).

NormalTanhDistribution: a diagonal Gaussian squashed through tanh, with
param_size = 2 * event_size (mean, log_std). Sampling and the sample-based
entropy take their standard normals from `seed`: a `torch.Generator` to
draw from, or a tensor of the draws themselves (so a test can pass the JAX
package's draws).
"""

from __future__ import annotations

import abc
import math
from typing import Union

import torch
from torch.nn import functional as F

_MIN_STD = 0.001
_LOG2 = 0.6931471805599453

Seed = Union[torch.Generator, torch.Tensor]


def standard_normal(seed: Seed, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of `like`'s shape: `seed` itself when it is a tensor,
    else drawn from the generator (on its device, moved to `like`'s)."""
    if isinstance(seed, torch.Tensor):
        if seed.shape != like.shape:
            raise ValueError(f"noise of shape {tuple(seed.shape)} for parameters of shape {tuple(like.shape)}")
        return seed.to(like.device, like.dtype)
    return torch.randn(like.shape, generator=seed, device=seed.device, dtype=like.dtype).to(like.device)


def _log_det_jacobian(raw: torch.Tensor) -> torch.Tensor:
    return 2.0 * (_LOG2 - raw - F.softplus(-2.0 * raw))


class ParametricDistribution(abc.ABC):
    """Distribution over actions parameterized by a network output vector."""

    def __init__(self, param_size: int, event_size: int):
        self._param_size = param_size
        self._event_size = event_size

    @property
    def param_size(self) -> int:
        return self._param_size

    @property
    def event_size(self) -> int:
        return self._event_size

    @abc.abstractmethod
    def sample_no_postprocessing(self, parameters: torch.Tensor, seed: Seed) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def log_prob(self, parameters: torch.Tensor, raw_actions: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def postprocess(self, raw_actions: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def mode(self, parameters: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def entropy(self, parameters: torch.Tensor, seed: Seed) -> torch.Tensor:
        ...

    def sample(self, parameters: torch.Tensor, seed: Seed) -> torch.Tensor:
        return self.postprocess(self.sample_no_postprocessing(parameters, seed))


class DeterministicTanhDistribution(ParametricDistribution):
    """tanh(loc) with no noise head: param_size == event_size (for trainers
    that roll out with `mode`)."""

    def __init__(self, event_size: int):
        super().__init__(param_size=event_size, event_size=event_size)

    def sample_no_postprocessing(self, parameters, seed):
        return parameters

    def mode(self, parameters):
        return torch.tanh(parameters)

    def postprocess(self, raw_actions):
        return torch.tanh(raw_actions)

    def log_prob(self, parameters, raw_actions):
        # a point mass has no log-density; zeros keep the inference contract
        return parameters.new_zeros(parameters.shape[:-1])

    def entropy(self, parameters, seed):
        return parameters.new_zeros(parameters.shape[:-1])


class NormalTanhDistribution(ParametricDistribution):
    """tanh(Normal(mean, std)) with softplus std floor."""

    def __init__(self, event_size: int, min_std: float = _MIN_STD, var_scale: float = 1.0):
        super().__init__(param_size=2 * event_size, event_size=event_size)
        self._min_std = min_std
        self._var_scale = var_scale

    def _loc_scale(self, parameters: torch.Tensor):
        loc, scale = torch.chunk(parameters, 2, dim=-1)
        return loc, (F.softplus(scale) + self._min_std) * self._var_scale

    def sample_no_postprocessing(self, parameters, seed):
        loc, scale = self._loc_scale(parameters)
        return loc + scale * standard_normal(seed, loc)

    def mode(self, parameters):
        loc, _ = self._loc_scale(parameters)
        return torch.tanh(loc)

    def postprocess(self, raw_actions):
        return torch.tanh(raw_actions)

    def log_prob(self, parameters, raw_actions):
        """log prob of the postprocessed action, at the raw (pre-tanh) action."""
        loc, scale = self._loc_scale(parameters)
        log_unnormalized = -0.5 * torch.square((raw_actions - loc) / scale)
        log_normalization = 0.5 * math.log(2.0 * math.pi) + torch.log(scale)
        return (log_unnormalized - log_normalization - _log_det_jacobian(raw_actions)).sum(-1)

    def entropy(self, parameters, seed):
        """Sample-based entropy of the squashed distribution."""
        loc, scale = self._loc_scale(parameters)
        raw = loc + scale * standard_normal(seed, loc)
        base_entropy = 0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(scale)
        return (base_entropy + _log_det_jacobian(raw)).sum(-1)
