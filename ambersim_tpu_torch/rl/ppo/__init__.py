"""PPO training stack of the PyTorch port (port of ambersim_tpu/rl/ppo)."""

from ambersim_tpu_torch.rl.ppo.networks import (  # noqa: F401
    FeedForwardNetwork,
    PPONetworks,
    make_inference_fn,
    make_ppo_networks,
)
from ambersim_tpu_torch.rl.ppo.train import train  # noqa: F401
