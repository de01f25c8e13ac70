from ambersim_tpu_torch.learning.architectures import MLP  # noqa: F401
