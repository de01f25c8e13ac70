"""Build the port's Model from numpy arrays, and carry state from the JAX
package into the port.

Arrays come from the port's own MJCF/URDF compiler
(``ambersim_tpu_torch.mjcf.compile_spec_arrays``) or from a model file the
JAX package compiled and ``tools/export_model_npz.py`` exported to
``ambersim_tpu_torch/assets/<name>.npz``; this module reads such a file
without JAX. Both give the same leaf names. Not to be mixed up:
`load_model(name)` loads an exported file, while
`ambersim_tpu_torch.mjcf.load_model(path)` compiles an MJCF file.

File layout (all plain numpy, no pickles):
  * ``leaf.<field>``: every Model array leaf; ``leaf.opt.<field>``: Option
    fields (the integer/bool ones as 0-d arrays);
  * ``skel.<field>``: every ndarray field of the Skeleton;
  * ``skel_json``: the Skeleton's ints, bools, strings and tuples as JSON.

`check_slice` refuses, by name, every feature the port does not cover yet.
`ppo_params_from_jax` carries the JAX package's network params (flax MLPs,
stacked ones included, and running statistics) into the port's trainers and
networks; `sac_state_from_jax` carries a SAC training state.
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
    ConeType,
    Contact,
    Data,
    GeomType,
    Model,
    Option,
    Skeleton,
    SolverType,
)

ASSETS = Path(__file__).resolve().parent.parent / "assets"


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


def model_from_numpy(skel_fields: dict, leaves: dict, device="cuda") -> Model:
    """Build a Model on `device` from Skeleton fields and numpy leaves (see the
    module docstring for the leaf names). Raises NotImplementedError for a
    model outside the ported slice."""
    m = build_model(skel_fields, leaves, device)
    check_slice(m)
    return m


def build_model(skel_fields: dict, leaves: dict, device="cuda") -> Model:
    """`model_from_numpy` without `check_slice`: for host code that runs only
    the parts of the engine a model outside the slice may still use
    (`engine.setconst`)."""
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
    return Model(skel=Skeleton(**skel_fields), opt=Option(**opt_kw), **model_kw)


def load_model(name: str, device="cuda") -> Model:
    """Load the exported model ``assets/<name>.npz`` onto `device`: the card
    by default (the kernels), "cpu" for the plain versions. Without a card
    the default raises; nothing falls back to the CPU. Takes an asset name,
    not a path: `ambersim_tpu_torch.mjcf.load_model(path)` and
    `utils.io_utils.load_model_from_file(path)` compile an MJCF/URDF file."""
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
    from ambersim_tpu_torch.engine.collision import _NARROWPHASE
    from ambersim_tpu_torch.engine.solver import _elliptic_meta
    from ambersim_tpu_torch.ops.newton import MAX_NV

    s, o = m.skel, m.opt
    key = (s, o.integrator, o.solver, o.cone, o.noslip_iterations, o.enableflags,
           o.disableactuator, o.hessian_bf16)
    if key in _CHECKED:
        return
    missing = []
    # _elliptic_meta raises ValueError when the rows were compiled for pyramidal cones
    if o.cone == int(ConeType.ELLIPTIC):
        _elliptic_meta(s)
    for t1, t2 in set(zip(np.asarray(s.pair_ctype1).tolist(), np.asarray(s.pair_ctype2).tolist())):
        if (t1, t2) not in _NARROWPHASE:
            missing.append(f"{GeomType(t1).name.lower()}-{GeomType(t2).name.lower()} contact pairs")
    # Newton and CG are ported; the JAX package runs a PGS model as Newton
    # without a word (solver.py:419-421), which the port does not copy
    if o.solver not in (int(SolverType.NEWTON), int(SolverType.CG)):
        missing.append(f"the {SolverType(o.solver).name} solver")
    # the bf16 Hessian lives on the batched-arrays route only (nv past the
    # Newton kernels, pyramidal cones), where the JAX package applies it
    if o.hessian_bf16 and s.nv <= MAX_NV:
        missing.append(f"Option.hessian_bf16 (bf16 Newton Hessian) at nv <= {MAX_NV}: kernels 4-6 take float32 only")
    elif o.hessian_bf16 and o.cone == int(ConeType.ELLIPTIC):
        missing.append("Option.hessian_bf16 (bf16 Newton Hessian) with elliptic cones")
    if missing:
        raise NotImplementedError(
            "model uses features outside the ported slice: " + ", ".join(dict.fromkeys(missing))
        )
    _CHECKED.add(key)


_NORMALIZER_FIELDS = ("count", "mean", "summed_variance", "std")


def _is_flax_mlp(tree) -> bool:
    return isinstance(tree, Mapping) and set(tree) == {"params"} and all(
        k.startswith("hidden_") for k in tree["params"]
    )


def ppo_params_from_jax(tree, device="cuda"):
    """The JAX package's network params (as numpy) in the port's form, on
    `device`.

    Converts, anywhere in a tree of dicts, lists and tuples:
      * a flax MLP's ``{"params": {"hidden_i": {"kernel", "bias"}}}`` into the
        port's ``{"hidden.i.weight", "hidden.i.bias"}`` (a flax kernel is
        (in, out), an ``nn.Linear`` weight (out, in)). Leading axes stay
        where they are: a kernel stacked as (S, in, out), SAC's twin critics
        or a population of policies, becomes a weight of (S, out, in);
      * a RunningStatisticsState (count, mean, summed_variance, std; an
        object with those attributes or a dict with those keys) into the
        port's RunningStatisticsState.
    """
    from ambersim_tpu_torch.rl.ppo.running_statistics import RunningStatisticsState

    if _is_flax_mlp(tree):
        out = {}
        for name, layer in tree["params"].items():
            i = int(name[len("hidden_"):])
            out[f"hidden.{i}.weight"] = _f32(np.swapaxes(np.asarray(layer["kernel"]), -1, -2), device)
            if "bias" in layer:
                out[f"hidden.{i}.bias"] = _f32(layer["bias"], device)
        return out
    if isinstance(tree, Mapping) and set(tree) == set(_NORMALIZER_FIELDS):
        return RunningStatisticsState(**{k: _f32(tree[k], device) for k in _NORMALIZER_FIELDS})
    if all(hasattr(tree, k) for k in _NORMALIZER_FIELDS):
        return RunningStatisticsState(**{k: _f32(getattr(tree, k), device) for k in _NORMALIZER_FIELDS})
    if isinstance(tree, Mapping):
        return {k: ppo_params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(ppo_params_from_jax(v, device) for v in tree)
    raise TypeError(f"not a PPO params tree of the JAX package: {type(tree).__name__}")


# A SAC training state's leaves that carry across (the JAX package's
# rl/sac/train.py TrainingState; the Adam moments and train_iters do not)
SAC_STATE_FIELDS = ("policy_params", "q_params", "target_q_params", "log_alpha", "normalizer_params")


def sac_state_from_jax(state, device="cuda") -> dict:
    """The JAX package's SAC TrainingState (as numpy, or an object or dict
    with its fields) as a dict of the port's leaves on `device`, one key per
    SAC_STATE_FIELDS name: the policy's MLP params, the twin critics' and
    their target's (stacked on a leading n_critics axis), `log_alpha` as a
    0-d tensor and the normalizer's RunningStatisticsState. The optimizer
    states are not carried: a port trainer starts fresh Adam moments."""

    def field(k):
        return state[k] if isinstance(state, Mapping) else getattr(state, k)

    out = {k: ppo_params_from_jax(field(k), device) for k in SAC_STATE_FIELDS if k != "log_alpha"}
    out["log_alpha"] = _f32(field("log_alpha"), device)
    return out


def ppo_params_to_numpy(tree):
    """The inverse of `ppo_params_from_jax`: the port's PPO params as the JAX
    package's numpy trees (a RunningStatisticsState becomes a dict of its
    four fields)."""
    from ambersim_tpu_torch.rl.ppo.running_statistics import RunningStatisticsState

    def host(x):
        return x.detach().cpu().numpy()

    if isinstance(tree, RunningStatisticsState):
        return {k: host(getattr(tree, k)) for k in _NORMALIZER_FIELDS}
    if isinstance(tree, Mapping) and tree and all(k.startswith("hidden.") for k in tree):
        layers: dict = {}
        for k, v in tree.items():
            _, i, kind = k.split(".")
            layers.setdefault(f"hidden_{i}", {})["kernel" if kind == "weight" else "bias"] = (
                np.swapaxes(host(v), -1, -2) if kind == "weight" else host(v)
            )
        return {"params": layers}
    if isinstance(tree, Mapping):
        return {k: ppo_params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(ppo_params_to_numpy(v) for v in tree)
    raise TypeError(f"not a PPO params tree of the port: {type(tree).__name__}")
