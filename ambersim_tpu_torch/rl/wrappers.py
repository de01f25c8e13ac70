"""Training wrappers: episode termination, auto-reset and batching (port of
ambersim_tpu/rl/wrappers.py).

The port's envs are batch-first, so `VmapWrapper` only holds a batch size
and no scan carry exists: the JAX package's `make_slim_carry`, which keeps
the lax.scan carry small, has no counterpart here. The trainer's Python
loop passes each State on by reference, and every physics step recomputes
the derived fields it reads. APG's checkpointed rollout keeps each control
step's State by reference too (rl/apg/train.py): 4.6 GiB of device memory
at its peak for 4096 quadruped envs x 20 control steps (chip_smoke.py's
apg_quadruped on an H100), so it needs no slim carry either.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from ambersim_tpu_torch.core.types import _Tensors
from ambersim_tpu_torch.rl.base import MjxEnv, State


class Wrapper(MjxEnv):
    def __init__(self, env: MjxEnv):
        self.env = env

    def reset(self, generator: torch.Generator, batch_size: int | None = None) -> State:
        return self.wrap_reset(self.env.reset(generator, batch_size))

    def reset_to(self, qpos: torch.Tensor, qvel: torch.Tensor, generator: Optional[torch.Generator] = None) -> State:
        return self.wrap_reset(self.env.reset_to(qpos, qvel, generator))

    def wrap_reset(self, state: State) -> State:
        """This wrapper's additions to a freshly reset State."""
        return state

    def draw_start(self, generator: torch.Generator, batch_size: int):
        return self.env.draw_start(generator, batch_size)

    def step(self, state: State, action: torch.Tensor) -> State:
        return self.env.step(state, action)

    def to(self, device) -> "Wrapper":
        wrapper = copy.copy(self)
        wrapper.env = self.env.to(device)
        return wrapper

    @property
    def model(self):
        return self.env.model

    @property
    def dt(self):
        return self.env.dt

    @property
    def observation_size(self) -> int:
        return self.env.observation_size

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def unwrapped(self) -> MjxEnv:
        return self.env.unwrapped


class EpisodeWrapper(Wrapper):
    """End episodes after `episode_length` control steps, with `action_repeat`
    env steps per wrapped step. `steps` counts control steps, so
    episode_length means the same whatever action_repeat is."""

    def __init__(self, env: MjxEnv, episode_length: int, action_repeat: int = 1):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def wrap_reset(self, state: State) -> State:
        zeros = torch.zeros_like(state.reward)
        return state.replace(info={**state.info, "steps": zeros, "truncation": zeros})

    def step(self, state: State, action: torch.Tensor) -> State:
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
        steps = state.info["steps"] + self.action_repeat
        over = steps >= self.episode_length
        done = torch.where(over, torch.ones_like(state.done), state.done)
        truncation = torch.where(over, 1 - state.done, torch.zeros_like(state.done))
        return state.replace(done=done, info={**state.info, "steps": steps, "truncation": truncation})


def select_where(done: torch.Tensor, x, y):
    """Per env, `x` where done else `y`, over a tensor or every field of a
    port dataclass (nested ones included); None stays None."""
    if x is None:
        return None
    if isinstance(x, _Tensors):
        return dataclasses.replace(
            x, **{f.name: select_where(done, getattr(x, f.name), getattr(y, f.name)) for f in dataclasses.fields(x)}
        )
    if not isinstance(x, torch.Tensor):
        return x
    mask = done.reshape(done.shape + (1,) * (x.dim() - 1)) > 0
    return torch.where(mask, x, y)


class AutoResetWrapper(Wrapper):
    """Reset an env to the cached first state and obs when its episode ends."""

    def wrap_reset(self, state: State) -> State:
        return state.replace(info={**state.info, "first_pipeline_state": state.pipeline_state, "first_obs": state.obs})

    def step(self, state: State, action: torch.Tensor) -> State:
        info = state.info
        if "steps" in info:
            info = {**info, "steps": torch.where(state.done > 0, torch.zeros_like(info["steps"]), info["steps"])}
        state = self.env.step(state.replace(done=torch.zeros_like(state.done), info=info), action)
        pipeline_state = select_where(state.done, state.info["first_pipeline_state"], state.pipeline_state)
        obs = select_where(state.done, state.info["first_obs"], state.obs)
        return state.replace(pipeline_state=pipeline_state, obs=obs)


class VmapWrapper(Wrapper):
    """Holds a batch size for `reset`: the env under it is already batch-first."""

    def __init__(self, env: MjxEnv, batch_size: int | None = None):
        super().__init__(env)
        self.batch_size = batch_size

    def reset(self, generator: torch.Generator, batch_size: int | None = None) -> State:
        batch_size = self.batch_size if batch_size is None else batch_size
        if batch_size is None:
            raise ValueError("VmapWrapper.reset needs a batch size (none given and none held)")
        return self.env.reset(generator, batch_size)


class DomainRandomizationVmapWrapper(Wrapper):
    """Per-env randomized models: not ported."""

    def __init__(self, env: MjxEnv, randomization_fn):
        raise NotImplementedError(
            "domain randomization needs per-env Model leaves (a batch axis on Model tensors), "
            "which the port's engine does not take yet"
        )


def wrap_for_training(
    env: MjxEnv, episode_length: int, action_repeat: int = 1, randomization_fn=None
) -> MjxEnv:
    """Standard training stack: episode -> vmap -> autoreset (brax order)."""
    env = EpisodeWrapper(env, episode_length, action_repeat)
    if randomization_fn is None:
        env = VmapWrapper(env)
    else:
        env = DomainRandomizationVmapWrapper(env, randomization_fn)
    return AutoResetWrapper(env)
