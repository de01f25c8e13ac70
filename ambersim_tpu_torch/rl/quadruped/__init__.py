from ambersim_tpu_torch.rl.quadruped.locomotion import (  # noqa: F401
    QuadrupedLocomotionConfig,
    QuadrupedLocomotionEnv,
    randomize_quadruped,
    randomize_quadruped_full,
)
from ambersim_tpu_torch.rl.quadruped.terrain import QuadrupedTerrainConfig, QuadrupedTerrainEnv  # noqa: F401
