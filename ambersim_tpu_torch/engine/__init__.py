"""Batched physics engine of the PyTorch port."""

from ambersim_tpu_torch.engine import support  # noqa: F401
from ambersim_tpu_torch.engine.forward import forward, step  # noqa: F401
from ambersim_tpu_torch.engine.init import make_data  # noqa: F401
from ambersim_tpu_torch.engine.inverse import inverse  # noqa: F401
from ambersim_tpu_torch.engine.rollout import rollout  # noqa: F401
