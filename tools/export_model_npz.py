"""Export a model compiled by the JAX package to the PyTorch port's format.

    python tools/export_model_npz.py                      # the quadruped asset
    python tools/export_model_npz.py MODEL.xml OUT.npz    # any MJCF file

The port (ambersim_tpu_torch) has no MJCF compiler yet and must run where
JAX is not installed, so it loads models from these files
(ambersim_tpu_torch/io/bridge.py documents the layout). This script imports
the JAX package; the port never imports it.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
QUADRUPED_XML = "models/quadruped/quadruped.xml"
QUADRUPED_NPZ = REPO / "ambersim_tpu_torch" / "assets" / "quadruped.npz"


def _jsonable(v):
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def model_arrays(m) -> tuple[dict, dict]:
    """(skel_fields, leaves) of a JAX-package Model as plain numpy/Python."""
    leaves = {}
    for f in dataclasses.fields(m):
        if f.name not in ("skel", "opt"):
            leaves[f.name] = np.asarray(getattr(m, f.name))
    for f in dataclasses.fields(m.opt):
        v = getattr(m.opt, f.name)
        if v is not None:
            leaves["opt." + f.name] = np.asarray(v)
    return dict(m.skel._fields), leaves


def pack(skel_fields: dict, leaves: dict) -> dict:
    """The arrays of the .npz file for one model."""
    out = {"leaf." + k: v for k, v in leaves.items()}
    scalars = {}
    for k, v in skel_fields.items():
        if isinstance(v, np.ndarray):
            out["skel." + k] = v
        else:
            scalars[k] = _jsonable(v)
    out["skel_json"] = np.asarray(json.dumps(scalars, sort_keys=True))
    return out


def export(xml_path: str, out_path: Path) -> None:
    from ambersim_tpu.utils.io_utils import load_model_from_file

    m = load_model_from_file(xml_path)
    np.savez_compressed(out_path, **pack(*model_arrays(m)))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    if len(sys.argv) == 3:
        export(sys.argv[1], Path(sys.argv[2]))
    else:
        export(QUADRUPED_XML, QUADRUPED_NPZ)
