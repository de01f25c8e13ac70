"""Export a model compiled by the JAX package to the PyTorch port's format.

    python tools/export_model_npz.py                       # every committed asset
    python tools/export_model_npz.py arm3 cartpole         # the named assets
    python tools/export_model_npz.py MODEL.xml OUT.npz [--cone elliptic]
        [--broadphase-cap N] [--max-contact-points N]       # any MJCF file

The port (ambersim_tpu_torch) has no MJCF compiler yet and must run where
JAX is not installed, so it loads models from these files
(ambersim_tpu_torch/io/bridge.py documents the layout). `--cone` is the
loader's cone override: it is applied before compiling, so the file holds
that cone's constraint-row layout. `--broadphase-cap N` gives every geom-type
pair group of more than N candidate pairs N runtime-selected slots
(load_model_from_file's broadphase_cap); `--max-contact-points N` adds the
model's <custom><numeric name="max_contact_points" data="N"/> row cap, as
benchmarks/ladder.py:133-142 does. This script imports the JAX package; the
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

CLUTTER_XML = "models/objects/clutter32.xml"

# asset name -> (MJCF file, loader cone override, broadphase cap, max_contact_points)
ASSETS = {
    "quadruped": (QUADRUPED_XML, None, 0, 0),
    "quadruped_elliptic": (QUADRUPED_XML, "elliptic", 0, 0),
    "cartpole": ("models/cartpole/cartpole.xml", None, 0, 0),
    "arm3": ("models/arm3/arm3.xml", None, 0, 0),
    "humanoid": ("models/humanoid/humanoid.xml", None, 0, 0),
    "pendulum": ("models/pendulum/pendulum.xml", None, 0, 0),
    # BASELINE.md:13's predictive-sampling hand: joint equality rows and capsule pairs
    "hand": ("models/hand/hand.xml", None, 0, 0),
    # benchmarks/ladder.py rungs 3b (:120) and 3c (:133-142)
    "clutter32_cap48": (CLUTTER_XML, None, 48, 0),
    "clutter32_rowcap192": (CLUTTER_XML, None, 48, 192),
    # benchmarks/ladder.py rungs 3 (:104-106), 3a (:108-112) and 3b exact (:123-125)
    "drop_scene": ("models/objects/drop_scene.xml", None, 0, 0),
    "rock": ("models/rock/rock_scene.xml", None, 0, 0),
    "clutter32": (CLUTTER_XML, None, 0, 0),
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


def load_jax_model(xml_path: str, cone: str | None = None, broadphase_cap: int = 0, max_contact_points: int = 0):
    """The JAX package's compiled Model, with the loader's cone override and
    broadphase cap, and with a max_contact_points row cap added to the XML
    when it is > 0 (benchmarks/ladder.py:133-142)."""
    if not max_contact_points:
        from ambersim_tpu.utils.io_utils import load_model_from_file

        return load_model_from_file(xml_path, cone=cone, broadphase_cap=broadphase_cap)
    import os

    from ambersim_tpu.engine.setconst import set_constants
    from ambersim_tpu.mjcf import compile_spec
    from ambersim_tpu.mjcf.parser import parse_mjcf_string
    from ambersim_tpu.utils._internal_utils import _check_filepath

    path = _check_filepath(xml_path)
    with open(path) as f:
        xml = f.read().replace(
            "</mujoco>",
            f'<custom><numeric name="max_contact_points" data="{int(max_contact_points)}"/></custom></mujoco>',
        )
    spec = parse_mjcf_string(xml, base_dir=os.path.dirname(path))
    if cone is not None:
        spec.option["cone"] = cone.lower()
    return set_constants(compile_spec(spec, broadphase_cap=broadphase_cap))


def export(xml_path: str, out_path: Path, cone: str | None = None, broadphase_cap: int = 0,
           max_contact_points: int = 0) -> None:
    jm = load_jax_model(xml_path, cone, broadphase_cap, max_contact_points)
    np.savez_compressed(out_path, **pack(*model_arrays(jm)))


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="*", help="asset names, or MODEL.xml OUT.npz")
    ap.add_argument("--cone", choices=("pyramidal", "elliptic"), help="cone override for MODEL.xml")
    ap.add_argument("--broadphase-cap", type=int, default=0, metavar="N",
                    help="runtime-selected slots per pair group of more than N pairs (MODEL.xml)")
    ap.add_argument("--max-contact-points", type=int, default=0, metavar="N",
                    help="keep the N deepest contact candidates (MODEL.xml)")
    args = ap.parse_args(argv)
    if len(args.targets) == 2 and args.targets[0].endswith(".xml"):
        export(args.targets[0], Path(args.targets[1]), args.cone, args.broadphase_cap, args.max_contact_points)
        return
    if args.cone or args.broadphase_cap or args.max_contact_points:
        ap.error("--cone, --broadphase-cap and --max-contact-points apply to MODEL.xml OUT.npz; "
                 "the named assets carry their own")
    for name in args.targets or ASSETS:
        if name not in ASSETS:
            ap.error(f"unknown asset {name!r} (known: {', '.join(ASSETS)})")
        xml, *options = ASSETS[name]
        export(xml, ASSETS_DIR / f"{name}.npz", *options)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    main(sys.argv[1:])
