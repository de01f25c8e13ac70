"""Gradient-based shooting trajectory optimization (port of
ambersim_tpu/trajopt/gradient.py).

The total cost of a rolled-out control tape is differentiated end to end
through the contact dynamics (reverse mode through `step`: each kernel's
Function runs autograd through its plain version) and descended with Adam.
A Python loop takes the place of the JAX package's lax.scan over Adam
steps; a batch of problems (x0 (batch, nq+nv), us_guess (batch, N, nu)) is
one batch of envs all the way down, as vmap(optimize) is there.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ambersim_tpu_torch.core.types import Model
from ambersim_tpu_torch.trajopt.base import CostFunction, TrajectoryOptimizer
from ambersim_tpu_torch.trajopt.shooting import ShootingParams, shoot


@dataclasses.dataclass
class GradientShootingOptimizer(TrajectoryOptimizer):
    """Adam descent on the shooting cost J(us) = cost(shoot(x0, us), us),
    keeping the best iterate seen (the guess is iterate 0, so the result
    never costs more than the guess) and clipping the tape to the
    actuators' ctrlrange after each step."""

    model: Model
    cost_function: CostFunction
    iters: int = 50
    learning_rate: float = 0.05
    b1: float = 0.9
    b2: float = 0.999

    def _cost(self, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        return self.cost_function.cost(shoot(self.model, x0, us), us)

    def _value_and_grad(self, x0: torch.Tensor, us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cost of tape(s) `us` and its gradient (one per problem: the
        problems of a batch are independent envs)."""
        with torch.enable_grad():
            us = us.detach().requires_grad_(True)
            c = self._cost(x0, us)
            (g,) = torch.autograd.grad(c.sum(), us)
        return c.detach(), g

    @torch.no_grad()
    def optimize(self, params: ShootingParams) -> Tuple[torch.Tensor, torch.Tensor]:
        m, x0 = self.model, params.x0
        lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
        us = torch.clamp(params.us_guess, lo, hi)
        mom, vel = torch.zeros_like(us), torch.zeros_like(us)
        best_us = us
        best_cost = torch.full(us.shape[:-2], float("inf"), dtype=us.dtype, device=us.device)
        b1, b2 = torch.tensor(self.b1, dtype=us.dtype), torch.tensor(self.b2, dtype=us.dtype)
        for i in range(self.iters):
            c, g = self._value_and_grad(x0, us)
            better = (c < best_cost)[..., None, None]
            best_us = torch.where(better, us, best_us)
            best_cost = torch.where(c < best_cost, c, best_cost)
            mom = self.b1 * mom + (1 - self.b1) * g
            vel = self.b2 * vel + (1 - self.b2) * g * g
            t = float(i + 1)
            mhat = mom / (1 - (b1**t).to(us.device))
            vhat = vel / (1 - (b2**t).to(us.device))
            us = torch.clamp(us - self.learning_rate * mhat / (torch.sqrt(vhat) + 1e-8), lo, hi)
        # the final candidate may beat every tracked iterate
        use_final = (self._cost(x0, us) < best_cost)[..., None, None]
        us_star = torch.where(use_final, us, best_us)
        return shoot(m, x0, us_star), us_star
