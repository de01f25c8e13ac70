"""Quadruped velocity-tracking locomotion task (port of
ambersim_tpu/rl/quadruped/locomotion.py): track a forward velocity command
on flat ground, stay upright, penalize energy and vertical/angular motion;
terminate on falls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.io.bridge import load_model
from ambersim_tpu_torch.rl.base import MjxEnv, State, draw_normal, draw_uniform

# PD mapping of the action (an offset from the standing pose) to motor torques
KP, KD = 24.0, 0.8


@dataclasses.dataclass(frozen=True)
class QuadrupedLocomotionConfig:
    """`model` names an exported asset (ambersim_tpu_torch/assets/<model>.npz)."""

    model: str = "quadruped"
    # commanded forward velocity (m/s)
    target_vel: float = 0.5
    # reward weights
    vel_weight: float = 2.0
    upright_weight: float = 0.5
    height_weight: float = 1.0
    energy_weight: float = 2e-4
    lateral_weight: float = 0.5
    angvel_weight: float = 0.05
    action_scale: float = 0.4
    # termination
    min_height: float = 0.12
    max_tilt: float = 0.6  # max |1 - quat_w-ish| tilt proxy
    # init noise
    joint_noise: float = 0.08
    physics_steps_per_control_step: int = 4


class QuadrupedLocomotionEnv(MjxEnv):
    """Track a forward velocity command on flat ground."""

    def __init__(self, config: QuadrupedLocomotionConfig | None = None, device="cuda"):
        self.config = config or QuadrupedLocomotionConfig()
        super().__init__(load_model(self.config.model, device=device), self.config.physics_steps_per_control_step)

    @property
    def default_pose(self) -> torch.Tensor:
        return self._qpos0.to(self.device)[7:]

    def _up(self, qpos: torch.Tensor) -> torch.Tensor:
        """The trunk's z axis in the world frame, (B, 3)."""
        return am.rotate(qpos.new_tensor([0.0, 0.0, 1.0]), qpos[:, 3:7])

    def compute_obs(self, data, info):
        # base orientation (gravity direction in body frame), base velocities,
        # joint positions (offset from stand), joint velocities, last action
        quat = data.qpos[:, 3:7]
        gravity_body = am.rotate_inv(quat.new_tensor([0.0, 0.0, -1.0]), quat)
        lin_vel = am.rotate_inv(data.qvel[:, :3], quat)  # translation dofs: world frame
        ang_vel = data.qvel[:, 3:6]  # free-joint rotation dofs are already body-frame
        return torch.cat(
            [
                gravity_body,
                lin_vel,
                ang_vel,
                data.qpos[:, 7:] - self.default_pose,
                data.qvel[:, 6:] * 0.1,
                info["last_action"],
            ],
            dim=-1,
        )

    def compute_reward(self, data, info):
        c = self.config
        vx = data.qvel[:, 0]
        vel_r = c.vel_weight * torch.exp(-4.0 * (vx - c.target_vel) ** 2)
        upright_r = c.upright_weight * self._up(data.qpos)[:, 2]
        height_pen = -c.height_weight * (data.qpos[:, 2] - 0.27) ** 2
        energy_pen = -c.energy_weight * (data.actuator_force**2).sum(-1)
        lateral_pen = -c.lateral_weight * (data.qvel[:, 1] ** 2 + 0.3 * data.qvel[:, 2] ** 2)
        angvel_pen = -c.angvel_weight * (data.qvel[:, 3:6] ** 2).sum(-1)
        return vel_r + upright_r + height_pen + energy_pen + lateral_pen + angvel_pen

    def _done(self, data):
        c = self.config
        fallen = (data.qpos[:, 2] < c.min_height) | (self._up(data.qpos)[:, 2] < 1.0 - c.max_tilt)
        return fallen.float()

    def draw_start(self, generator, batch_size):
        c, s, dev = self.config, self.model.skel, self.device
        qpos = self.model.qpos0.expand(batch_size, s.nq).clone()
        qpos[:, 7:] += c.joint_noise * draw_normal(generator, (batch_size, s.nu), dev)
        qvel = torch.zeros(batch_size, s.nv, device=dev)
        qvel[:, :6] += 0.05 * draw_normal(generator, (batch_size, 6), dev)
        return qpos, qvel

    def reset_to(self, qpos, qvel, generator: Optional[torch.Generator] = None) -> State:
        data = self.pipeline_init(qpos, qvel)
        zeros = torch.zeros(qpos.shape[0], device=qpos.device)
        info = {"last_action": torch.zeros(qpos.shape[0], self.model.skel.nu, device=qpos.device)}
        obs = self.compute_obs(data, info)
        return State(data, obs, zeros, zeros, {"reward": zeros}, info)

    def step(self, state: State, action: torch.Tensor) -> State:
        c = self.config
        data = state.pipeline_state
        target = self.default_pose + c.action_scale * action
        ctrl = KP * (target - data.qpos[:, 7:]) - KD * data.qvel[:, 6:]
        data = self.pipeline_step(data, ctrl)
        info = {**state.info, "last_action": action}
        obs = self.compute_obs(data, info)
        reward = self.compute_reward(data, info)
        return state.replace(
            pipeline_state=data, obs=obs, reward=reward, done=self._done(data),
            metrics={**state.metrics, "reward": reward}, info=info,
        )


FEET = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")


def randomize_quadruped(model, generator: torch.Generator, num_envs: int):
    """A `randomization_fn` for the quadruped (rl.wrappers.
    DomainRandomizationVmapWrapper, ppo.train): per env, the trunk's mass
    times U[0.8, 1.2], the 12 leg joints' damping U[0.5, 1.1], the feet's
    sliding friction U[0.5, 1.25] (the contact takes the larger of the
    foot's and the floor's 0.8) and each motor's gain times U[0.9, 1.1],
    drawn with `generator` on its own device (so a CPU generator gives the
    card and the CPU the same leaves). Returns (model, the four names)."""
    s, dev = model.skel, model.device
    trunk = s.body_names.index("trunk")
    feet = [s.geom_names.index(f) for f in FEET]
    legs = [int(s.jnt_dofadr[j]) for j in range(s.njnt) if int(s.jnt_type[j]) != 0]  # every joint but the free one
    mass = model.body_mass.expand(num_envs, -1).clone()
    mass[:, trunk] *= draw_uniform(generator, (num_envs,), 0.8, 1.2, dev)
    damping = model.dof_damping.expand(num_envs, -1).clone()
    damping[:, legs] = draw_uniform(generator, (num_envs, len(legs)), 0.5, 1.1, dev)
    friction = model.geom_friction.expand(num_envs, -1, -1).clone()
    friction[:, feet, 0] = draw_uniform(generator, (num_envs, len(feet)), 0.5, 1.25, dev)
    gain = model.actuator_gainprm.expand(num_envs, -1, -1).clone()
    gain[..., 0] *= draw_uniform(generator, (num_envs, s.nu), 0.9, 1.1, dev)
    names = ("body_mass", "dof_damping", "geom_friction", "actuator_gainprm")
    return model.replace(body_mass=mass, dof_damping=damping, geom_friction=friction, actuator_gainprm=gain), names


def randomize_quadruped_full(model, generator: torch.Generator, num_envs: int):
    """A `randomization_fn` for the quadruped with the usual sim-to-real
    draws (MuJoCo Playground's Go1 randomize.py): randomize_quadruped's four,
    then per env and in this order the 12 leg joints' friction loss times
    U[0.9, 1.1] and armature times U[1.0, 1.05], the trunk's com offset
    body_ipos + U[-0.05, 0.05] m per axis (its body_inertia scaled by the
    factor its mass took), the legs' joint zero offsets qpos0 + U[-0.05,
    0.05] rad, the feet's contact time constant geom_solref[0] times U[0.8,
    1.2], each motor's gear times U[0.95, 1.05] and its forcerange +-28
    times U[0.9, 1.0]. The quadruped's motors are not forcelimited, so the
    forcerange is carried and clamps nothing, in both packages. Draws are
    made with `generator` on its own device. Returns (model, the twelve
    names)."""
    s, dev, base = model.skel, model.device, model
    model, names = randomize_quadruped(model, generator, num_envs)
    trunk = s.body_names.index("trunk")
    feet = [s.geom_names.index(f) for f in FEET]
    legs = [int(s.jnt_dofadr[j]) for j in range(s.njnt) if int(s.jnt_type[j]) != 0]
    leg_q = [int(s.jnt_qposadr[j]) for j in range(s.njnt) if int(s.jnt_type[j]) != 0]

    def per_env(leaf):
        return leaf.expand(num_envs, *leaf.shape).clone()

    frictionloss, armature = per_env(model.dof_frictionloss), per_env(model.dof_armature)
    frictionloss[:, legs] *= draw_uniform(generator, (num_envs, len(legs)), 0.9, 1.1, dev)
    armature[:, legs] *= draw_uniform(generator, (num_envs, len(legs)), 1.0, 1.05, dev)
    ipos, inertia = per_env(model.body_ipos), per_env(model.body_inertia)
    ipos[:, trunk] += draw_uniform(generator, (num_envs, 3), -0.05, 0.05, dev)
    inertia[:, trunk] *= (model.body_mass[:, trunk] / base.body_mass[trunk])[:, None]
    qpos0 = per_env(model.qpos0)
    qpos0[:, leg_q] += draw_uniform(generator, (num_envs, len(leg_q)), -0.05, 0.05, dev)
    solref = per_env(model.geom_solref)
    solref[:, feet, 0] *= draw_uniform(generator, (num_envs, len(feet)), 0.8, 1.2, dev)
    gear = per_env(model.actuator_gear)
    gear[..., 0] *= draw_uniform(generator, (num_envs, s.nu), 0.95, 1.05, dev)
    limit = 28.0 * draw_uniform(generator, (num_envs, s.nu), 0.9, 1.0, dev)
    forcerange = torch.stack([-limit, limit], -1)
    leaves = dict(dof_frictionloss=frictionloss, dof_armature=armature, body_ipos=ipos, body_inertia=inertia,
                  qpos0=qpos0, geom_solref=solref, actuator_gear=gear, actuator_forcerange=forcerange)
    return model.replace(**leaves), names + tuple(leaves)
