"""Humanoid balance task (port of ambersim_tpu/rl/humanoid/balance.py; the
contact-rich PPO half of BASELINE.md config 5).

Stand upright under randomized initial pose and velocity perturbations: keep
the pelvis at nominal height, the torso vertical and the base still, with
energy and action-rate shaping; terminate on falls. The action is a
joint-position offset from the standing pose, turned into motor torques by
a per-joint PD map. Actuator order is not qpos order on this model, so the
map goes through the actuators' transmission joints (trnid).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.engine.schedule import device_index
from ambersim_tpu_torch.io.bridge import load_model
from ambersim_tpu_torch.rl.base import MjxEnv, State, draw_normal


@dataclasses.dataclass(frozen=True)
class HumanoidBalanceConfig:
    """`model` names an exported asset (ambersim_tpu_torch/assets/<model>.npz)."""

    model: str = "humanoid"
    # reward weights
    upright_weight: float = 1.0
    height_weight: float = 2.0
    still_weight: float = 0.4
    pose_weight: float = 0.3
    energy_weight: float = 5e-5
    action_rate_weight: float = 0.05
    alive_bonus: float = 1.0
    # geometry
    stand_height: float = 0.75
    # termination
    min_height: float = 0.45
    max_tilt: float = 0.5  # terminate when the torso's up-z drops below 1 - max_tilt
    # init noise
    joint_noise: float = 0.12
    vel_noise: float = 0.25
    action_scale: float = 0.35
    physics_steps_per_control_step: int = 5
    kp: float = 60.0
    kd: float = 2.5


class HumanoidBalanceEnv(MjxEnv):
    """Stand upright; recover from randomized initial perturbations."""

    def __init__(self, config: HumanoidBalanceConfig | None = None, device="cuda"):
        self.config = config or HumanoidBalanceConfig()
        super().__init__(load_model(self.config.model, device=device), self.config.physics_steps_per_control_step)
        s = self.model.skel
        # actuator i drives joint trnid[i]; hinge joints: one qpos and one dof each
        jids = np.asarray(s.actuator_trnid)
        self._act_qadr = np.asarray(s.jnt_qposadr)[jids]
        self._act_dadr = np.asarray(s.jnt_dofadr)[jids]

    @property
    def default_pose(self) -> torch.Tensor:
        """The standing pose of the actuated joints, in actuator order."""
        return self._qpos0.to(self.device)[device_index(self._act_qadr, self.device)]

    def _up(self, qpos: torch.Tensor) -> torch.Tensor:
        """The torso's z axis in the world frame, (B, 3)."""
        return am.rotate(qpos.new_tensor([0.0, 0.0, 1.0]), qpos[:, 3:7])

    def compute_obs(self, data, info):
        quat = data.qpos[:, 3:7]
        gravity_body = am.rotate_inv(quat.new_tensor([0.0, 0.0, -1.0]), quat)
        lin_vel = am.rotate_inv(data.qvel[:, :3], quat)
        ang_vel = data.qvel[:, 3:6]  # free-joint rotation dofs are body-frame
        return torch.cat(
            [
                gravity_body,
                lin_vel,
                ang_vel,
                data.qpos[:, 2:3] - self.config.stand_height,
                data.qpos[:, 7:] - self.model.qpos0[..., 7:],
                data.qvel[:, 6:] * 0.1,
                info["last_action"],
            ],
            dim=-1,
        )

    def compute_reward(self, data, info):
        c = self.config
        upright_r = c.upright_weight * self._up(data.qpos)[:, 2]
        height_r = -c.height_weight * (data.qpos[:, 2] - c.stand_height) ** 2
        still_r = -c.still_weight * ((data.qvel[:, :3] ** 2).sum(-1) + 0.3 * (data.qvel[:, 3:6] ** 2).sum(-1))
        pose_r = -c.pose_weight * ((data.qpos[:, 7:] - self.model.qpos0[..., 7:]) ** 2).mean(-1)
        energy_r = -c.energy_weight * (data.actuator_force**2).sum(-1)
        rate_r = -c.action_rate_weight * ((info["last_action"] - info["prev_action"]) ** 2).mean(-1)
        return c.alive_bonus + upright_r + height_r + still_r + pose_r + energy_r + rate_r

    def _done(self, data):
        c = self.config
        fallen = (data.qpos[:, 2] < c.min_height) | (self._up(data.qpos)[:, 2] < 1.0 - c.max_tilt)
        return fallen.float()

    def draw_start(self, generator, batch_size):
        c, s, dev = self.config, self.model.skel, self.device
        qpos = self.model.qpos0.expand(batch_size, s.nq).clone()
        qpos[:, 7:] += c.joint_noise * draw_normal(generator, (batch_size, s.nq - 7), dev)
        qvel = torch.zeros(batch_size, s.nv, device=dev)
        qvel[:, :6] += c.vel_noise * draw_normal(generator, (batch_size, 6), dev)
        return qpos, qvel

    def reset_to(self, qpos, qvel, generator: Optional[torch.Generator] = None) -> State:
        data = self.pipeline_init(qpos, qvel)
        B, nu = qpos.shape[0], self.model.skel.nu
        zeros = torch.zeros(B, device=qpos.device)
        info = {"last_action": torch.zeros(B, nu, device=qpos.device),
                "prev_action": torch.zeros(B, nu, device=qpos.device)}
        obs = self.compute_obs(data, info)
        return State(data, obs, zeros, zeros, {"reward": zeros}, info)

    def step(self, state: State, action: torch.Tensor) -> State:
        c = self.config
        data = state.pipeline_state
        dev = data.qpos.device
        target = self.default_pose + c.action_scale * action
        qa, da = device_index(self._act_qadr, dev), device_index(self._act_dadr, dev)
        ctrl = c.kp * (target - data.qpos[:, qa]) - c.kd * data.qvel[:, da]
        data = self.pipeline_step(data, ctrl)
        info = {**state.info, "prev_action": state.info["last_action"], "last_action": action}
        obs = self.compute_obs(data, info)
        reward = self.compute_reward(data, info)
        return state.replace(
            pipeline_state=data, obs=obs, reward=reward, done=self._done(data),
            metrics={**state.metrics, "reward": reward}, info=info,
        )
