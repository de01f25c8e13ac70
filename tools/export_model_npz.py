"""Export a model compiled by the JAX package to the PyTorch port's format.

    python tools/export_model_npz.py                       # every committed asset
    python tools/export_model_npz.py arm3 cartpole         # the named assets
    python tools/export_model_npz.py MODEL.xml OUT.npz [--cone elliptic]   # any MJCF file

The port (ambersim_tpu_torch) has no MJCF compiler yet and must run where
JAX is not installed, so it loads models from these files
(ambersim_tpu_torch/io/bridge.py documents the layout). `--cone` is the
loader's cone override: it is applied before compiling, so the file holds
that cone's constraint-row layout. This script imports the JAX package; the
port never imports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ASSETS_DIR = REPO / "ambersim_tpu_torch" / "assets"
QUADRUPED_XML = "models/quadruped/quadruped.xml"
QUADRUPED_NPZ = ASSETS_DIR / "quadruped.npz"

# asset name -> (MJCF file, loader cone override)
ASSETS = {
    "quadruped": (QUADRUPED_XML, None),
    "quadruped_elliptic": (QUADRUPED_XML, "elliptic"),
    "cartpole": ("models/cartpole/cartpole.xml", None),
    "arm3": ("models/arm3/arm3.xml", None),
    "humanoid": ("models/humanoid/humanoid.xml", None),
    "pendulum": ("models/pendulum/pendulum.xml", None),
}


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


def load_jax_model(xml_path: str, cone: str | None = None):
    """The JAX package's compiled Model, with the loader's cone override."""
    from ambersim_tpu.utils.io_utils import load_model_from_file

    return load_model_from_file(xml_path, cone=cone)


def export(xml_path: str, out_path: Path, cone: str | None = None) -> None:
    np.savez_compressed(out_path, **pack(*model_arrays(load_jax_model(xml_path, cone))))


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="*", help="asset names, or MODEL.xml OUT.npz")
    ap.add_argument("--cone", choices=("pyramidal", "elliptic"), help="cone override for MODEL.xml")
    args = ap.parse_args(argv)
    if len(args.targets) == 2 and args.targets[0].endswith(".xml"):
        export(args.targets[0], Path(args.targets[1]), args.cone)
        return
    if args.cone:
        ap.error("--cone applies to MODEL.xml OUT.npz; the named assets carry their own")
    for name in args.targets or ASSETS:
        if name not in ASSETS:
            ap.error(f"unknown asset {name!r} (known: {', '.join(ASSETS)})")
        xml, cone = ASSETS[name]
        export(xml, ASSETS_DIR / f"{name}.npz", cone)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    main(sys.argv[1:])
