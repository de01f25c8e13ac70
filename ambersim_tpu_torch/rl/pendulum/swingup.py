"""Pendulum swingup task (port of ambersim_tpu/rl/pendulum/swingup.py).

Observation (cos q, sin q, qd); reward -(w_q * wrap(q - pi)^2 + w_qd * qd^2
+ w_u * u^2); uniform random starts; optional Gaussian observation noise
drawn from the generator the env was reset with.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ambersim_tpu_torch.io.bridge import load_model
from ambersim_tpu_torch.rl.base import MjxEnv, State, draw_normal, draw_uniform


@dataclasses.dataclass(frozen=True)
class PendulumSwingupConfig:
    """Config for the swingup task. `model` names an exported asset
    (ambersim_tpu_torch/assets/<model>.npz)."""

    model: str = "pendulum"
    # reward weights
    q_weight: float = 1.0
    qd_weight: float = 0.1
    u_weight: float = 0.001
    # initial state ranges
    q_init_min: float = -3.14159
    q_init_max: float = 3.14159
    qd_init_min: float = -1.0
    qd_init_max: float = 1.0
    # observation noise std (0 disables)
    obs_noise_std: float = 0.0
    physics_steps_per_control_step: int = 1


class PendulumSwingupEnv(MjxEnv):
    """Swing the torque-limited pendulum upright."""

    def __init__(self, config: PendulumSwingupConfig | None = None, device="cuda"):
        self.config = config or PendulumSwingupConfig()
        super().__init__(load_model(self.config.model, device=device), self.config.physics_steps_per_control_step)

    def compute_obs(self, data, info):
        q, qd = data.qpos[:, 0], data.qvel[:, 0]
        obs = torch.stack([torch.cos(q), torch.sin(q), qd], dim=-1)
        if self.config.obs_noise_std > 0 and info.get("rng") is not None:
            obs = obs + self.config.obs_noise_std * draw_normal(info["rng"], obs.shape, obs.device)
        return obs

    def compute_reward(self, data, info):
        q, qd = data.qpos[:, 0], data.qvel[:, 0]
        u = data.ctrl[:, 0]
        # wrap the angle error to (-pi, pi] around the upright position
        err = torch.remainder(q - math.pi, 2 * math.pi)
        err = torch.where(err > math.pi, err - 2 * math.pi, err)
        c = self.config
        return -(c.q_weight * err**2 + c.qd_weight * qd**2 + c.u_weight * u**2)

    def draw_start(self, generator, batch_size):
        c, s, dev = self.config, self.model.skel, self.device
        qpos = draw_uniform(generator, (batch_size, s.nq), c.q_init_min, c.q_init_max, dev)
        qvel = draw_uniform(generator, (batch_size, s.nv), c.qd_init_min, c.qd_init_max, dev)
        return qpos, qvel

    def reset_to(self, qpos, qvel, generator: Optional[torch.Generator] = None) -> State:
        data = self.pipeline_init(qpos, qvel)
        zeros = torch.zeros(qpos.shape[0], device=qpos.device)
        info = {"rng": generator, "step": zeros}
        obs = self.compute_obs(data, info)
        return State(data, obs, zeros, zeros, {"reward": zeros}, info)

    def step(self, state: State, action: torch.Tensor) -> State:
        data = self.pipeline_step(state.pipeline_state, action)
        obs = self.compute_obs(data, state.info)
        reward = self.compute_reward(data, state.info)
        return state.replace(
            pipeline_state=data, obs=obs, reward=reward, done=torch.zeros_like(reward),
            metrics={**state.metrics, "reward": reward}, info={**state.info, "step": state.info["step"] + 1},
        )
