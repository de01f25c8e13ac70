"""APG training stack of the PyTorch port (port of ambersim_tpu/rl/apg).

Analytic policy gradients: backpropagate the episode return through the
differentiable physics step (engine.linalg.differentiable_dispatch: the
kernels in the forward pass, autograd through their plain versions in the
backward pass) instead of estimating gradients from sampled returns. Same
(make_policy, params, metrics) / progress_fn contract as `rl.ppo.train`.
"""

from ambersim_tpu_torch.rl.apg.train import make_apg_networks, make_deterministic_networks, train  # noqa: F401
