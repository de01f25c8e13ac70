"""Running mean/std normalization (port of
ambersim_tpu/rl/ppo/running_statistics.py): Welford-style accumulation over
every leading batch dim of an observation tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from ambersim_tpu_torch.core.types import _Tensors


@dataclasses.dataclass
class RunningStatisticsState(_Tensors):
    count: torch.Tensor  # float32 scalar, as in the JAX package
    mean: torch.Tensor
    summed_variance: torch.Tensor
    std: torch.Tensor


def init_state(specimen: torch.Tensor) -> RunningStatisticsState:
    """Initialize from a specimen (e.g. one observation)."""
    zeros = torch.zeros_like(specimen)
    return RunningStatisticsState(
        count=zeros.new_zeros(()), mean=zeros, summed_variance=zeros.clone(), std=torch.ones_like(specimen)
    )


def update(state: RunningStatisticsState, batch: torch.Tensor, std_min_value: float = 1e-6) -> RunningStatisticsState:
    """Accumulate statistics over all leading batch dims of `batch`."""
    batch_dims = batch.dim() - state.mean.dim()
    axes = tuple(range(batch_dims))
    count = state.count + batch.shape[:batch_dims].numel()
    diff_to_old = batch - state.mean
    mean = state.mean + diff_to_old.sum(axes) / count
    summed_variance = state.summed_variance + (diff_to_old * (batch - mean)).sum(axes)
    std = torch.clamp(torch.sqrt(torch.clamp(summed_variance / torch.clamp(count, min=1.0), min=0.0)), min=std_min_value)
    return RunningStatisticsState(count=count, mean=mean, summed_variance=summed_variance, std=std)


def normalize(batch: torch.Tensor, state: RunningStatisticsState) -> torch.Tensor:
    return (batch - state.mean) / state.std


def denormalize(batch: torch.Tensor, state: RunningStatisticsState) -> torch.Tensor:
    return batch * state.std + state.mean
