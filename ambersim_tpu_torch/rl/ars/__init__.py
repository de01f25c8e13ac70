"""Augmented Random Search training stack of the PyTorch port (port of
ambersim_tpu/rl/ars).

ARS-V2t: antithetic parameter directions scored by full-episode rollouts,
an update from only the top directions, scaled by the reward standard
deviation, with running obs normalization. Same (make_policy, params,
metrics) / progress_fn contract as `rl.ppo.train`.
"""

from ambersim_tpu_torch.rl.ars.train import train  # noqa: F401
