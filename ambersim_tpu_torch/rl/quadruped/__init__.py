from ambersim_tpu_torch.rl.quadruped.locomotion import QuadrupedLocomotionConfig, QuadrupedLocomotionEnv  # noqa: F401
from ambersim_tpu_torch.rl.quadruped.terrain import QuadrupedTerrainConfig, QuadrupedTerrainEnv  # noqa: F401
