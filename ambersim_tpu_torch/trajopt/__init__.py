"""Trajectory optimization of the PyTorch port (port of
ambersim_tpu/trajopt): the cost and optimizer API, predictive sampling and
the MPC driver. The gradient-based optimizers (GradientShootingOptimizer,
ILQR) need a differentiable step and are not ported yet."""

from ambersim_tpu_torch.trajopt.base import CostFunction, TrajectoryOptimizer, TrajectoryOptimizerParams  # noqa: F401
from ambersim_tpu_torch.trajopt.cost import StaticGoalQuadraticCost  # noqa: F401
from ambersim_tpu_torch.trajopt.mpc import run_mpc, run_mpc_batch  # noqa: F401
from ambersim_tpu_torch.trajopt.shooting import (  # noqa: F401
    ShootingParams,
    VanillaPredictiveSampler,
    VanillaPredictiveSamplerParams,
    shoot,
)
