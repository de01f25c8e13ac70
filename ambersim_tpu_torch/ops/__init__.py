"""Hand-written CUDA kernels for Hopper (csrc/) and their launchers."""

from ambersim_tpu_torch.ops._build import LAUNCHES, reset_launch_counts  # noqa: F401
