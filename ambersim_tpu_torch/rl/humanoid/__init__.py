from ambersim_tpu_torch.rl.humanoid.balance import HumanoidBalanceConfig, HumanoidBalanceEnv  # noqa: F401
