from ambersim_tpu_torch.rl.pendulum.swingup import PendulumSwingupConfig, PendulumSwingupEnv  # noqa: F401
