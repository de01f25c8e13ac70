from ambersim_tpu_torch.rl.quadruped.locomotion import QuadrupedLocomotionConfig, QuadrupedLocomotionEnv  # noqa: F401
