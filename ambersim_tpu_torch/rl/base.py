"""Environment API: State container + MjxEnv base class (port of
ambersim_tpu/rl/base.py).

The port's envs are batch-first: one `reset` starts B envs and one `step`
advances all of them, so every State tensor carries a leading env axis and
no vmap is needed. The physics underneath is the port's engine, which on a
CUDA model launches the hand-written kernels. An env step builds an
autograd graph only when the caller asks for one (grad mode on and an
action or state that requires grad, as APG's rollout does): each kernel
then goes through its Function, whose backward pass is the plain
version's (engine.linalg.differentiable_dispatch). Callers that want no
graph step under `torch.no_grad()`, as PPO's rollout and eval do.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
from typing import Any, Dict, Optional

import torch

from ambersim_tpu_torch.core.types import Data, Model
from ambersim_tpu_torch.engine import forward, make_data, rollout


@dataclasses.dataclass
class State:
    """Env state of B envs: physics Data plus RL quantities, batch-first."""

    pipeline_state: Data
    obs: torch.Tensor  # (B, observation_size)
    reward: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) float: 1 where the episode ended
    metrics: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **updates: Any) -> "State":
        return dataclasses.replace(self, **updates)


def draw_normal(generator: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """Standard normals drawn on the generator's device, then moved to `device`
    (so a CPU generator gives the same draws to a CPU and a CUDA env)."""
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def draw_uniform(generator: torch.Generator, shape: tuple, low: float, high: float, device) -> torch.Tensor:
    """Uniform draws in [low, high), on the generator's device like draw_normal."""
    u = torch.rand(shape, generator=generator, device=generator.device).to(device)
    return low + (high - low) * u


class MjxEnv(abc.ABC):
    """Batch-first environment whose physics is the port's engine."""

    def __init__(self, model: Model, physics_steps_per_control_step: int = 1):
        self.model = model
        self._physics_steps_per_control_step = physics_steps_per_control_step
        # the constructed model's qpos0: the JAX envs take their default pose
        # from it at construction, so a per-env qpos0 (with_model) moves each
        # env's start and joint zero but not the pose its actions offset
        self._qpos0 = model.qpos0

    @property
    def sys(self) -> Model:
        return self.model

    @property
    def device(self) -> torch.device:
        return self.model.device

    def to(self, device) -> "MjxEnv":
        """A copy of the env with its model on `device`."""
        return self.with_model(self.model.to(torch.device(device)))

    def with_model(self, model: Model) -> "MjxEnv":
        """A copy of the env stepping `model` (e.g. one with per-env leaves)."""
        env = copy.copy(self)
        env.model = model
        return env

    def pipeline_init(self, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: Optional[torch.Tensor] = None) -> Data:
        """B fresh envs at (B, nq) qpos and (B, nv) qvel, through forward."""
        data = make_data(self.model, qpos.shape[0]).replace(qpos=qpos, qvel=qvel)
        if ctrl is not None:
            data = data.replace(ctrl=ctrl)
        return forward(self.model, data)

    def pipeline_step(self, data: Data, ctrl: torch.Tensor) -> Data:
        """`physics_steps_per_control_step` physics steps at fixed (B, nu) ctrl."""
        return rollout(self.model, data.replace(ctrl=ctrl), self._physics_steps_per_control_step)

    @property
    def dt(self) -> torch.Tensor:
        """Control timestep."""
        return self.model.opt.timestep * self._physics_steps_per_control_step

    @property
    def observation_size(self) -> int:
        """Width of obs, from a one-env reset."""
        return int(self.reset(torch.Generator().manual_seed(0), 1).obs.shape[-1])

    @property
    def action_size(self) -> int:
        return self.model.skel.nu

    @property
    def backend(self) -> str:
        return "ambersim_tpu_torch"

    @property
    def unwrapped(self) -> "MjxEnv":
        return self

    def reset(self, generator: torch.Generator, batch_size: int) -> State:
        """`batch_size` envs from starts drawn with `generator`."""
        qpos, qvel = self.draw_start(generator, batch_size)
        return self.reset_to(qpos, qvel, generator)

    @abc.abstractmethod
    def draw_start(self, generator: torch.Generator, batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(qpos, qvel) of `batch_size` random starts, on the model's device."""

    @abc.abstractmethod
    def reset_to(self, qpos: torch.Tensor, qvel: torch.Tensor, generator: Optional[torch.Generator] = None) -> State:
        """The State of envs started at the given (B, nq) qpos and (B, nv) qvel."""

    @abc.abstractmethod
    def step(self, state: State, action: torch.Tensor) -> State:
        ...

    def compute_obs(self, data: Data, info: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def compute_reward(self, data: Data, info: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError
