"""Model I/O: MJCF/URDF loading with option overrides
(reference API: ambersim/utils/io_utils.py:139-249; port of
ambersim_tpu/utils/io_utils.py).

`load_model_from_file` resolves the path global/local/repo-relative
(`_internal_utils.ROOT`), dispatches URDF through the converter, compiles
with the port's own numpy compiler (`mjcf.compile_spec_arrays`), derives the
setconst fields on the CPU (`engine.setconst`), applies the solver and
iteration overrides and builds the Model on `device`: the card by default,
the CPU only when asked. `load_model_and_data_from_file` also allocates a
fresh batch of Data.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ambersim_tpu_torch.core.types import Data, Model
from ambersim_tpu_torch.utils._internal_utils import _check_filepath


def load_model_from_file(
    filepath: Union[str, Path],
    force_float: bool = False,
    solver: Optional[str] = None,
    iterations: Optional[int] = None,
    ls_iterations: Optional[int] = None,
    cone: Optional[str] = None,  # "pyramidal"/"elliptic"; pre-compile (layout!)
    broadphase_cap: int = 0,
    hessian_bf16: bool = False,  # opt-in bf16 Newton Hessian assembly (see Option)
    device="cuda",
) -> Model:
    """Load a URDF or MJCF file into a compiled Model on `device`.

    broadphase_cap > 0 bounds contact capacity for cluttered scenes: any
    geom-type pair group with more candidate pairs than the cap gets only
    `cap` contact slots, filled each step with the cap most-overlapping pairs.
    0 = exact all-pairs narrowphase. `io.bridge.check_slice` refuses, by name,
    a model outside the port's engine; without a card the default device
    raises, never falls back to the CPU."""
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.io.bridge import model_from_numpy
    from ambersim_tpu_torch.mjcf.compiler import compile_spec_arrays
    from ambersim_tpu_torch.mjcf.parser import parse_mjcf

    path = _check_filepath(filepath)
    if path.endswith(".urdf"):
        from ambersim_tpu_torch.mjcf.urdf import urdf_to_spec

        spec = urdf_to_spec(path)
    else:
        spec = parse_mjcf(path)

    if force_float:
        from ambersim_tpu_torch.mjcf.urdf import force_float_base

        force_float_base(spec)

    if cone is not None:
        # must be applied BEFORE compilation: the static efc layout encodes
        # the cone (k rows/contact elliptic vs 2(k-1) pyramidal)
        if cone.lower() not in ("pyramidal", "elliptic"):
            raise ValueError(f"cone must be 'pyramidal' or 'elliptic', got {cone!r}")
        spec.option["cone"] = cone.lower()

    skel_fields, leaves = compile_spec_arrays(spec, broadphase_cap=broadphase_cap)
    leaves = set_constants(skel_fields, leaves)

    if solver is not None:
        from ambersim_tpu_torch.core.types import SolverType

        leaves["opt.solver"] = np.asarray(int(SolverType[solver.upper()]))
    if iterations is not None:
        leaves["opt.iterations"] = np.asarray(int(iterations))
    if ls_iterations is not None:
        leaves["opt.ls_iterations"] = np.asarray(int(ls_iterations))
    if hessian_bf16:
        leaves["opt.hessian_bf16"] = np.asarray(True)
    return model_from_numpy(skel_fields, leaves, device=device)


def load_model_and_data_from_file(
    filepath: Union[str, Path], force_float: bool = False, batch_size: int = 1, **kwargs
) -> Tuple[Model, Data]:
    """Load a model and allocate `batch_size` fresh envs of Data
    (reference: io_utils.py:244-249)."""
    from ambersim_tpu_torch.engine import make_data

    model = load_model_from_file(filepath, force_float=force_float, **kwargs)
    return model, make_data(model, batch_size)
