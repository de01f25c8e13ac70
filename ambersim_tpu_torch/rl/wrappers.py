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

from ambersim_tpu_torch.core.types import ENV_LEAVES, Model, _Tensors, check_env_leaves
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

    def with_model(self, model: Model) -> "Wrapper":
        wrapper = copy.copy(self)
        wrapper.env = self.env.with_model(model)
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


def check_randomized(base: Model, model: Model, names) -> int:
    """The env count of `model`, `base` with the leaves `names` given a
    leading env axis. Raises NotImplementedError for a name outside
    core.types.ENV_LEAVES or another leaf given an env axis, ValueError for
    a per-env leaf of the wrong shape or one `names` leaves out, each
    naming the leaf."""
    names = tuple(names)
    if not names:
        raise ValueError("randomization_fn named no randomized leaf")
    for k in names:
        if k not in ENV_LEAVES:
            raise NotImplementedError(f"Model leaf {k} cannot be per env; the per-env leaves are {', '.join(ENV_LEAVES)}")
    n = getattr(model, names[0]).shape[0] if getattr(model, names[0]).dim() else 0
    check_env_leaves(model, n)
    for k in ENV_LEAVES:
        want, got = tuple(getattr(base, k).shape), tuple(getattr(model, k).shape)
        if got != ((n,) + want if k in names else want):
            raise ValueError(f"leaf {k} has shape {got}: want {(n,) + want if k in names else want} "
                             f"({'named' if k in names else 'not named'} by randomization_fn, {n} envs)")
    return n


class DomainRandomizationVmapWrapper(Wrapper):
    """Every env its own randomized Model (brax's DomainRandomizationVmapWrapper;
    JAX rl/wrappers.py:122-153). `randomization_fn(model) -> (model_v,
    names)`: `model_v` is the env's Model with the leaves `names` (of
    core.types.ENV_LEAVES) given a leading env axis, every other leaf as it
    was; `names` plays the role of JAX's `in_axes`. The axis's length is
    the number of envs: reset and step run the whole batch against
    `model_v`, each env reading its own values."""

    def __init__(self, env: MjxEnv, randomization_fn):
        model_v, names = randomization_fn(env.model)
        self.num_envs = check_randomized(env.model, model_v, names)
        self._base = env
        super().__init__(env.with_model(model_v))

    def reset(self, generator: torch.Generator, batch_size: int | None = None) -> State:
        if batch_size not in (None, self.num_envs):
            raise ValueError(f"the randomized models hold {self.num_envs} envs, not {batch_size}")
        return self.env.reset(generator, self.num_envs)

    def to(self, device) -> "Wrapper":
        wrapper = super().to(device)
        wrapper._base = self._base.to(device)
        return wrapper

    @property
    def observation_size(self) -> int:
        return self._base.observation_size


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
