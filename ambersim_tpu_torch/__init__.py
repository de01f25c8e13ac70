"""PyTorch/CUDA port of ambersim_tpu: the batched quadruped physics step,
with its TPU kernels rewritten as CUDA kernels for Hopper (sm_90a).

Imports torch and numpy only; never jax or ambersim_tpu."""

from ambersim_tpu_torch.io.bridge import load_model  # noqa: F401
