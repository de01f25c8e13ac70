"""PyTorch/CUDA port of ambersim_tpu: the batched physics engine, with its
TPU kernels rewritten as CUDA kernels for Hopper (sm_90a), the model
compiler (`mjcf`, `utils`), the env layer and the trainers.

Imports torch and numpy (and scipy for mesh hulls) only; never jax or
ambersim_tpu. `load_model(name)` loads an exported assets/<name>.npz;
`mjcf.load_model(path)` and `utils.load_model_from_file(path)` compile a
model file."""

from ambersim_tpu_torch.io.bridge import load_model  # noqa: F401
