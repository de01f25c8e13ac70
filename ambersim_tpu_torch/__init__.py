"""PyTorch/CUDA port of ambersim_tpu: the batched physics engine, with its
TPU kernels rewritten as CUDA kernels for Hopper (sm_90a), the env layer
and the PPO trainer.

Imports torch and numpy only; never jax or ambersim_tpu."""

from ambersim_tpu_torch.io.bridge import load_model  # noqa: F401
