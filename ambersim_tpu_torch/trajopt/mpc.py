"""Receding-horizon MPC over a shooting-type optimizer (port of
ambersim_tpu/trajopt/mpc.py).

At every control step the horizon is re-solved from the current state,
warm-started from the previous solution shifted by one knot, and only its
first control is applied. The JAX package scans this loop and vmaps it over
initial states; here a Python loop drives it, and a batch of initial states
is one batch all the way down: each solve rolls out batch x nsamples envs
at once and the plant steps batch envs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ambersim_tpu_torch.core.types import Data, Model
from ambersim_tpu_torch.engine import forward, make_data, step
from ambersim_tpu_torch.trajopt.shooting import ShootingAlgorithm, ShootingParams


def _shift_tape(us: torch.Tensor) -> torch.Tensor:
    """Warm start for the next solve: drop the executed knot, repeat the last."""
    return torch.cat([us[..., 1:, :], us[..., -1:, :]], dim=-2)


def _state(d: Data) -> torch.Tensor:
    return torch.cat([d.qpos, d.qvel], dim=-1)


def run_mpc_batch(
    model: Model,
    optimizer: ShootingAlgorithm,
    params: ShootingParams,
    n_steps: int,
    data: Optional[Data] = None,
    substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, Data]:
    """Closed-loop MPC of a batch of problems for `n_steps` control steps.

    `params` holds x0 (batch, nq+nv) and us_guess (batch, N, nu); a
    generator it carries keeps drawing, so each re-solve sees fresh samples.
    Each control step re-solves every problem's horizon from its current
    state (one batched optimize), applies each first control for `substeps`
    physics steps, and shifts the tapes as the next warm start.

    Returns (xs, us, data_final): the realized states (batch, n_steps+1,
    nq+nv), the applied controls (batch, n_steps, nu) and the plant's final
    Data (batch envs)."""
    nq, batch = model.skel.nq, params.x0.shape[0]
    if data is None:
        data = make_data(model, batch)
    with torch.no_grad():
        data = forward(model, data.replace(qpos=params.x0[:, :nq].contiguous(), qvel=params.x0[:, nq:].contiguous()))
        xs, us = [params.x0], []
        for _ in range(n_steps):
            params = params.replace(x0=_state(data))
            _, us_star = optimizer.optimize(params)
            u = us_star[:, 0].contiguous()
            for _ in range(substeps):
                data = step(model, data.replace(ctrl=u))
            params = params.replace(us_guess=_shift_tape(us_star))
            xs.append(_state(data))
            us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1), data


def run_mpc(
    model: Model,
    optimizer: ShootingAlgorithm,
    params: ShootingParams,
    n_steps: int,
    data: Optional[Data] = None,
    substeps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, Data]:
    """Closed-loop MPC of one problem, x0 (nq+nv,) and us_guess (N, nu):
    run_mpc_batch on a batch of one. Returns xs (n_steps+1, nq+nv), us
    (n_steps, nu) and the plant's final Data (one env)."""
    one = params.replace(x0=params.x0[None], us_guess=params.us_guess[None])
    xs, us, data = run_mpc_batch(model, optimizer, one, n_steps, data, substeps)
    return xs[0], us[0], data
