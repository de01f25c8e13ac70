"""Shooting and predictive-sampling trajectory optimization (port of
ambersim_tpu/trajopt/shooting.py).

`shoot` rolls out control tapes as one batch: the JAX package's
vmap(shoot) over samples becomes the port's env axis, so all samples of a
solve (and all problems of a batched solve) step together, and on the card
each step launches kernels 1-4 once for the whole batch.
`VanillaPredictiveSampler` perturbs the control guess with Gaussian noise
(sample 0 is the unperturbed guess), clips to the ctrlrange of limited
actuators, rolls every sample out, costs them in one call and keeps the
cheapest. Its two halves are public, so a caller can feed it samples drawn
elsewhere: `draw_samples` and `select`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ambersim_tpu_torch.core.types import Model
from ambersim_tpu_torch.engine import forward, make_data, step
from ambersim_tpu_torch.engine.schedule import device_index
from ambersim_tpu_torch.rl.base import draw_normal
from ambersim_tpu_torch.trajopt.base import CostFunction, TrajectoryOptimizer, TrajectoryOptimizerParams


def shoot(m: Model, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Roll out controls `us` (B, N, nu) from states `x0` = [qpos, qvel],
    (B, nq+nv) or one (nq+nv,) state for every tape, as one batch of B envs:
    make_data, forward, then N steps. Returns xs (B, N+1, nq+nv). An
    unbatched tape (N, nu) with an unbatched x0 gives (N+1, nq+nv). Under
    grad mode with `us` or `x0` requiring grad, xs carries the graph of the
    rollout (the gradient optimizers differentiate it)."""
    if us.dim() == 2:
        return shoot(m, x0.reshape(1, -1), us[None])[0]
    B, nq = us.shape[0], m.skel.nq
    x0 = x0.expand(B, -1) if x0.dim() == 1 else x0
    d = forward(m, make_data(m, B).replace(qpos=x0[:, :nq].contiguous(), qvel=x0[:, nq:].contiguous()))
    xs = [x0]
    for k in range(us.shape[1]):
        d = step(m, d.replace(ctrl=us[:, k].contiguous()))
        xs.append(torch.cat([d.qpos, d.qvel], dim=-1))
    return torch.stack(xs, dim=1)


@dataclasses.dataclass
class ShootingParams(TrajectoryOptimizerParams):
    """Initial state and control tape guess: x0 (nq+nv,) and us_guess (N, nu),
    or a batch of problems, x0 (batch, nq+nv) and us_guess (batch, N, nu)."""

    x0: torch.Tensor
    us_guess: torch.Tensor

    @property
    def N(self) -> int:
        return self.us_guess.shape[-2]

    def replace(self, **updates) -> "ShootingParams":
        return dataclasses.replace(self, **updates)


class ShootingAlgorithm(TrajectoryOptimizer):
    """Marker base for shooting-type optimizers: the decision variable is an
    open-loop control tape rolled out through the dynamics. `optimize` takes
    one problem or a batch of them (ShootingParams)."""


@dataclasses.dataclass
class VanillaPredictiveSamplerParams(ShootingParams):
    """Adds the generator the samples are drawn from (the JAX package's
    PRNG key). Draws happen on the generator's device, so a CPU generator
    gives the same samples to a solve on the CPU and on the card."""

    generator: torch.Generator = dataclasses.field(default_factory=lambda: torch.Generator().manual_seed(0))


@dataclasses.dataclass
class VanillaPredictiveSampler(ShootingAlgorithm):
    """Predictive sampling: the best of `nsamples` Gaussian perturbations of
    the control guess."""

    model: Model
    cost_function: CostFunction
    nsamples: int = 100
    stdev: float = 0.1

    def draw_samples(self, params: VanillaPredictiveSamplerParams) -> torch.Tensor:
        """(..., nsamples, N, nu) control tapes: the guess, then nsamples - 1
        perturbations of it, clipped to the ctrlrange of limited actuators."""
        m, guess = self.model, params.us_guess
        batch = guess.shape[:-2]
        noise = self.stdev * draw_normal(params.generator, (*batch, self.nsamples - 1, *guess.shape[-2:]),
                                         guess.device)
        us = torch.cat([guess[..., None, :, :], guess[..., None, :, :] + noise], dim=-3)
        limited = device_index(np.asarray(m.skel.actuator_ctrllimited, bool), us.device)
        inf = torch.full_like(m.actuator_ctrlrange[:, 0], float("inf"))
        lo = torch.where(limited, m.actuator_ctrlrange[:, 0], -inf)
        hi = torch.where(limited, m.actuator_ctrlrange[:, 1], inf)
        return torch.clamp(us, lo, hi)

    @torch.no_grad()
    def select(self, x0: torch.Tensor, us_samples: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Roll out every sample from x0 in one batch, cost them in one call
        and take each problem's argmin. x0 (nq+nv,) with us_samples
        (S, N, nu), or x0 (batch, nq+nv) with (batch, S, N, nu). Returns
        (xs_star, us_star, best)."""
        *batch, S, N, nu = us_samples.shape
        x0s = x0.expand(S, -1) if not batch else x0[:, None, :].expand(*batch, S, -1).reshape(-1, x0.shape[-1])
        xs = shoot(self.model, x0s, us_samples.reshape(-1, N, nu)).reshape(*batch, S, N + 1, -1)
        best = torch.argmin(self.cost_function.cost(xs, us_samples), dim=-1)  # (...), first index on ties
        idx = best[..., None, None, None]
        xs_star = torch.take_along_dim(xs, idx, dim=-3).squeeze(-3)
        us_star = torch.take_along_dim(us_samples, idx, dim=-3).squeeze(-3)
        return xs_star, us_star, best

    @torch.no_grad()
    def optimize(self, params: VanillaPredictiveSamplerParams) -> Tuple[torch.Tensor, torch.Tensor]:
        xs_star, us_star, _ = self.select(params.x0, self.draw_samples(params))
        return xs_star, us_star
