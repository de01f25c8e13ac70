"""RL environment layer and the trainers of the PyTorch port (port of
ambersim_tpu/rl: env base, wrappers, registry, the pendulum, quadruped (on
flat ground and over height-field terrain) and humanoid balance tasks, and
the five trainers: PPO; APG, which differentiates the episode return
through the step; SAC, off-policy from an on-device replay buffer; ES and
ARS, gradient-free, each population member rolling out with its own
params). The trainers share the (make_policy, params, metrics) /
progress_fn contract of the JAX package: `rl.ppo.train`, `rl.apg.train`,
`rl.sac.train`, `rl.es.train` and `rl.ars.train`.
"""

from ambersim_tpu_torch.rl.base import MjxEnv, State  # noqa: F401
from ambersim_tpu_torch.rl.registry import get_environment, register_environment  # noqa: F401


def _register_packaged() -> None:
    def _pendulum(**kwargs):
        from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

        return PendulumSwingupEnv(**kwargs)

    def _quadruped(**kwargs):
        from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv

        return QuadrupedLocomotionEnv(**kwargs)

    def _quadruped_terrain(**kwargs):
        from ambersim_tpu_torch.rl.quadruped.terrain import QuadrupedTerrainEnv

        return QuadrupedTerrainEnv(**kwargs)

    def _humanoid_balance(**kwargs):
        from ambersim_tpu_torch.rl.humanoid import HumanoidBalanceEnv

        return HumanoidBalanceEnv(**kwargs)

    register_environment("pendulum_swingup", _pendulum)
    register_environment("quadruped_locomotion", _quadruped)
    register_environment("quadruped_terrain", _quadruped_terrain)
    register_environment("humanoid_balance", _humanoid_balance)


_register_packaged()
