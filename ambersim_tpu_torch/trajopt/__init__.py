"""Trajectory optimization of the PyTorch port (port of
ambersim_tpu/trajopt): the cost and optimizer API, the zeroth-order
predictive sampler, the first-order GradientShootingOptimizer (Adam
through the differentiable step), second-order ILQR with its manifold
state arithmetic (`state_add`, `state_diff`), and the MPC driver."""

from ambersim_tpu_torch.trajopt.base import CostFunction, TrajectoryOptimizer, TrajectoryOptimizerParams  # noqa: F401
from ambersim_tpu_torch.trajopt.cost import StaticGoalQuadraticCost  # noqa: F401
from ambersim_tpu_torch.trajopt.gradient import GradientShootingOptimizer  # noqa: F401
from ambersim_tpu_torch.trajopt.ilqr import ILQR, ILQRParams, state_add, state_diff  # noqa: F401
from ambersim_tpu_torch.trajopt.mpc import run_mpc, run_mpc_batch  # noqa: F401
from ambersim_tpu_torch.trajopt.shooting import (  # noqa: F401
    ShootingParams,
    VanillaPredictiveSampler,
    VanillaPredictiveSamplerParams,
    shoot,
)
