"""Trajectory optimization API (port of ambersim_tpu/trajopt/base.py).

Optimizers and costs are plain Python classes: no pytree is needed, since
nothing is traced. `CostFunction.grad` and `hess` default to torch.func
autodiff of `cost`, so a subclass may override them with analytic forms.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class TrajectoryOptimizerParams(abc.ABC):
    """Parameters consumed by a TrajectoryOptimizer.optimize call."""


class TrajectoryOptimizer(abc.ABC):
    """Abstract trajectory optimizer."""

    @abc.abstractmethod
    def optimize(self, params: TrajectoryOptimizerParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """Optimize a trajectory; returns (xs_star, us_star)."""


@dataclasses.dataclass
class CostFunctionParams(abc.ABC):
    """Parameters consumed by a CostFunction call; costs with static-only
    configuration may ignore it."""


class CostFunction(abc.ABC):
    """Cost over (state trajectory, control trajectory)."""

    @abc.abstractmethod
    def cost(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """Total scalar cost of a trajectory. xs: (N+1, n), us: (N, m)."""

    def grad(self, xs: torch.Tensor, us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dJ/dxs, dJ/dus), by autodiff."""
        return torch.func.grad(self.cost, argnums=(0, 1))(xs, us)

    def hess(self, xs: torch.Tensor, us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(d2J/dxs2, d2J/dus2, d2J/dxsdus), by autodiff."""
        hxx = torch.func.hessian(self.cost, argnums=0)(xs, us)
        huu = torch.func.hessian(self.cost, argnums=1)(xs, us)
        hxu = torch.func.jacfwd(torch.func.grad(self.cost, argnums=0), argnums=1)(xs, us)
        return hxx, huu, hxu
