"""Batched physics engine of the PyTorch port (the main-path slice)."""

from ambersim_tpu_torch.engine.forward import forward, step  # noqa: F401
from ambersim_tpu_torch.engine.init import make_data  # noqa: F401
from ambersim_tpu_torch.engine.rollout import rollout  # noqa: F401
