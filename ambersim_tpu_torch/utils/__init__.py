from ambersim_tpu_torch.utils.io_utils import (  # noqa: F401
    load_model_and_data_from_file,
    load_model_from_file,
)
