"""Carry compiled models and state from the JAX package into the port.

The port has no MJCF compiler yet. A model is compiled by the JAX package
and exported to ``ambersim_tpu_torch/assets/<name>.npz`` by
``tools/export_model_npz.py``; this module reads such a file without JAX.

File layout (all plain numpy, no pickles):
  * ``leaf.<field>``: every Model array leaf; ``leaf.opt.<field>``: Option
    fields (the integer/bool ones as 0-d arrays);
  * ``skel.<field>``: every ndarray field of the Skeleton;
  * ``skel_json``: the Skeleton's ints, bools, strings and tuples as JSON.

`check_slice` refuses, by name, every feature the port does not cover yet.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ambersim_tpu_torch.core.types import (
    OPTION_STATIC_FIELDS,
    BiasType,
    ConeType,
    Contact,
    Data,
    DynType,
    EnableBit,
    GainType,
    GeomType,
    IntegratorType,
    JointType,
    Model,
    Option,
    Skeleton,
    SolverType,
    TrnType,
)

ASSETS = Path(__file__).resolve().parent.parent / "assets"

_PLANE_PAIRS = {
    (int(GeomType.PLANE), int(GeomType.SPHERE)),
    (int(GeomType.PLANE), int(GeomType.CAPSULE)),
    (int(GeomType.PLANE), int(GeomType.BOX)),
}


def _tuplify(v):
    """JSON lists back to the tuples the Skeleton stores."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def unpack_npz(npz: Mapping[str, np.ndarray]) -> tuple[dict, dict]:
    """(skel_fields, leaves) from the arrays of an exported model file."""
    skel_fields = {k: _tuplify(v) for k, v in json.loads(str(npz["skel_json"])).items()}
    leaves = {}
    for k in npz.keys():
        if k.startswith("skel."):
            skel_fields[k[len("skel."):]] = np.asarray(npz[k])
        elif k.startswith("leaf."):
            leaves[k[len("leaf."):]] = np.asarray(npz[k])
    return skel_fields, leaves


def _f32(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def model_from_numpy(skel_fields: dict, leaves: dict, device="cpu") -> Model:
    """Build a Model on `device` from Skeleton fields and numpy leaves (see the
    module docstring for the leaf names). Raises NotImplementedError for a
    model outside the ported slice."""
    opt_kw, model_kw = {}, {}
    for k, v in leaves.items():
        if k.startswith("opt."):
            name = k[len("opt."):]
            if name == "hessian_bf16":
                opt_kw[name] = bool(v)
            elif name in OPTION_STATIC_FIELDS:
                opt_kw[name] = int(v)
            else:
                opt_kw[name] = _f32(v, device)
        else:
            model_kw[k] = _f32(v, device)
    m = Model(skel=Skeleton(**skel_fields), opt=Option(**opt_kw), **model_kw)
    check_slice(m)
    return m


def load_model(name: str, device="cpu") -> Model:
    """Load the exported model ``assets/<name>.npz`` onto `device`."""
    path = ASSETS / f"{name}.npz"
    if not path.is_file():
        raise FileNotFoundError(f"no exported model '{name}' at {path}")
    with np.load(path, allow_pickle=False) as npz:
        skel_fields, leaves = unpack_npz(npz)
    return model_from_numpy(skel_fields, leaves, device)


def data_from_numpy(m: Model, fields: Mapping[str, np.ndarray], device=None) -> Data:
    """Batch-first Data from numpy arrays keyed by Data field name (contact
    fields as ``contact.<name>``), e.g. a vmapped JAX Data converted leaf by
    leaf. Floats become f32, ints int32, bools stay bool."""
    device = m.device if device is None else device

    def conv(x):
        x = np.array(x)  # a writable copy
        if x.dtype == np.bool_:
            return torch.as_tensor(x, device=device)
        if np.issubdtype(x.dtype, np.integer):
            return torch.as_tensor(x.astype(np.int32), device=device)
        return _f32(x, device)

    contact = Contact(
        **{f.name: conv(fields["contact." + f.name]) for f in dataclasses.fields(Contact)}
    )
    kw = {}
    for f in dataclasses.fields(Data):
        if f.name == "contact":
            continue
        if f.name in fields and fields[f.name] is not None:
            kw[f.name] = conv(fields[f.name])
    return Data(contact=contact, **kw)


_CHECKED: set = set()


def check_slice(m: Model) -> None:
    """Raise NotImplementedError naming every feature of `m` that the port
    does not implement. Nothing outside the slice is silently skipped."""
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    s, o = m.skel, m.opt
    key = (s, o.integrator, o.solver, o.cone, o.noslip_iterations, o.enableflags,
           o.disableactuator, o.hessian_bf16)
    if key in _CHECKED:
        return
    missing = []
    for n, feature in (
        ("ntendon", "tendons"),
        ("nsensor", "sensors"),
        ("neq", "equality constraints"),
        ("nmocap", "mocap bodies"),
        ("na", "actuator activations (na > 0)"),
        ("ncam", "cameras (camlight)"),
        ("nlight", "lights (camlight)"),
    ):
        if getattr(s, n):
            missing.append(feature)
    if getattr(s, "has_fluid", False):
        missing.append("fluid forces")
    if getattr(s, "has_gravcomp", False):
        missing.append("gravity compensation")
    for u in range(s.nu):
        trn, j = int(s.actuator_trntype[u]), int(s.actuator_trnid[u])
        scalar_joint = trn in (int(TrnType.JOINT), int(TrnType.JOINTINPARENT)) and int(
            s.jnt_type[j]
        ) in (int(JointType.HINGE), int(JointType.SLIDE))
        if not scalar_joint:
            missing.append(f"actuator transmission {TrnType(trn).name} (only hinge/slide joints)")
        if (
            int(s.actuator_gaintype[u]) != int(GainType.FIXED)
            or int(s.actuator_biastype[u]) != int(BiasType.NONE)
            or int(s.actuator_dyntype[u]) != int(DynType.NONE)
        ):
            missing.append("non-motor actuators")
    if np.asarray(s.jnt_actfrclimited).any():
        missing.append("joint actuatorfrcrange clamps")
    if o.disableactuator:
        missing.append("actuator group disabling")
    if o.cone != int(ConeType.PYRAMIDAL):
        missing.append("elliptic cones")
    if len(s.con_dim) and not np.all(np.asarray(s.con_dim) == 3):
        missing.append("contact condim other than 3")
    for t1, t2 in set(zip(np.asarray(s.pair_ctype1).tolist(), np.asarray(s.pair_ctype2).tolist())):
        if (t1, t2) not in _PLANE_PAIRS:
            missing.append(f"{GeomType(t1).name.lower()}-{GeomType(t2).name.lower()} contact pairs")
    if len(s.bpg_adr) or s.ncon < s.ncand:
        missing.append("broadphase and contact caps")
    if (np.asarray(s.pair_explicit) >= 0).any():
        missing.append("explicit <pair> contact overrides")
    if any(int(s.jnt_type[j]) == int(JointType.BALL) for j in s.limit_jntid):
        missing.append("ball joint limits")
    if o.solver != int(SolverType.NEWTON):
        missing.append(f"the {SolverType(o.solver).name} solver")
    if o.integrator != int(IntegratorType.EULER):
        missing.append(f"the {IntegratorType(o.integrator).name} integrator")
    if o.noslip_iterations > 0:
        missing.append("noslip iterations")
    for bit in (EnableBit.ENERGY, EnableBit.FWDINV, EnableBit.OVERRIDE):
        if o.enableflags & bit:
            missing.append(f"the {bit.name} flag")
    if o.hessian_bf16:
        missing.append("Option.hessian_bf16 (bf16 Newton Hessian)")
    if s.nefc and _pyramid_structure(s) is None:
        missing.append("constraint rows without condim-3 contacts (dense Newton kernel)")
    if missing:
        raise NotImplementedError(
            "model uses features outside the ported slice: " + ", ".join(dict.fromkeys(missing))
        )
    _CHECKED.add(key)
