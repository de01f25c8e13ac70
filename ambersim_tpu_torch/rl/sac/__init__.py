"""SAC training stack of the PyTorch port (port of ambersim_tpu/rl/sac):
the on-device replay buffer, the policy and twin-Q networks, the three
losses and the trainer. Same (make_policy, params, metrics) / progress_fn
contract as `rl.ppo.train`.
"""

from ambersim_tpu_torch.rl.sac.networks import (  # noqa: F401
    SACNetworks,
    make_inference_fn,
    make_sac_networks,
)
from ambersim_tpu_torch.rl.sac.train import train  # noqa: F401
