"""Evolution Strategies training stack of the PyTorch port (port of
ambersim_tpu/rl/es).

OpenAI-ES with mirrored sampling and centered-rank fitness shaping: every
population member rolls out in its own env with its own params, and the
update is one fitness-weighted sum handed to Adam. Same (make_policy,
params, metrics) / progress_fn contract as `rl.ppo.train`.
"""

from ambersim_tpu_torch.rl.es.train import centered_rank, train  # noqa: F401
