"""Host-side model compiler of the port: MJCF/URDF -> Model, numpy only.

Plays the role MuJoCo's C compiler plays for the reference
(reference: ambersim/utils/io_utils.py:206 `mj.MjModel.from_xml_path`).

`load_model(path, device="cuda")` compiles an MJCF file; the package's
top-level `ambersim_tpu_torch.load_model(name)` loads an exported
``assets/<name>.npz`` instead.
"""

from ambersim_tpu_torch.mjcf.compiler import compile_spec, compile_spec_arrays, load_model  # noqa: F401
from ambersim_tpu_torch.mjcf.parser import parse_mjcf, parse_mjcf_string  # noqa: F401
from ambersim_tpu_torch.utils.io_utils import (  # noqa: F401
    load_model_and_data_from_file,
    load_model_from_file,
)
