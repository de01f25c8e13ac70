"""Quadratic costs with analytic derivatives (port of
ambersim_tpu/trajopt/cost.py)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ambersim_tpu_torch.trajopt.base import CostFunction


@dataclasses.dataclass
class StaticGoalQuadraticCost(CostFunction):
    """J = sum_k [ (x_k - xg)'Q(x_k - xg) + u_k'R u_k ] + (x_N - xg)'Qf(x_N - xg)
    with analytic gradient and block-diagonal Hessian.

    Every method takes trajectories with any leading batch axes, xs
    (..., N+1, n) and us (..., N, m), so the sampler costs all of its
    samples in one call; `cost` returns (...).

    Attributes:
      Q: (n, n) running state cost weight.
      Qf: (n, n) terminal state cost weight.
      R: (m, m) control cost weight.
      xg: (n,) static goal state.
    """

    Q: torch.Tensor
    Qf: torch.Tensor
    R: torch.Tensor
    xg: torch.Tensor

    def cost(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        dx = xs - self.xg
        running = torch.einsum("...ki,ij,...kj->...", dx[..., :-1, :], self.Q, dx[..., :-1, :])
        terminal = torch.einsum("...i,ij,...j->...", dx[..., -1, :], self.Qf, dx[..., -1, :])
        ctrl = torch.einsum("...ki,ij,...kj->...", us, self.R, us)
        return running + terminal + ctrl

    def grad(self, xs: torch.Tensor, us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dx = xs - self.xg
        gx = torch.cat([dx[..., :-1, :] @ (self.Q + self.Q.T), dx[..., -1:, :] @ (self.Qf + self.Qf.T)], dim=-2)
        return gx, us @ (self.R + self.R.T)

    def hess(self, xs: torch.Tensor, us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """hxx (..., N+1, n, N+1, n), huu (..., N, m, N, m) and hxu
        (..., N+1, n, N, m): (Q + Q') on each running knot's block, (Qf +
        Qf') on the terminal one, (R + R') on each control's, zero across."""
        *batch, N1, n = xs.shape
        N, m = us.shape[-2:]
        blocks_x = torch.stack([self.Q + self.Q.T] * (N1 - 1) + [self.Qf + self.Qf.T])  # (N+1, n, n)
        hxx = torch.einsum("kl,kij->kilj", torch.eye(N1, dtype=xs.dtype, device=xs.device), blocks_x)
        huu = torch.einsum("kl,ij->kilj", torch.eye(N, dtype=us.dtype, device=us.device), self.R + self.R.T)
        hxu = xs.new_zeros((*batch, N1, n, N, m))
        return hxx.expand(*batch, *hxx.shape), huu.expand(*batch, *huu.shape), hxu
