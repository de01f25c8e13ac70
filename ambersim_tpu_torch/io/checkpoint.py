"""Parameter checkpoint I/O (port of ambersim_tpu/io/checkpoint.py).

Trees are nested dicts, lists, tuples and the port's tensor dataclasses
(e.g. RunningStatisticsState). Tensors are stored as host numpy, so a
checkpoint does not depend on the device it was taken on.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Any, Callable, List, Union

import numpy as np
import torch

from ambersim_tpu_torch.core.types import _Tensors


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """`fn` on every leaf of a tree of dicts, lists, tuples and port
    dataclasses."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, _Tensors):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    leaves: List[Any] = []
    tree_map(leaves.append, tree)
    return leaves


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _to_tensor(device):
    def conv(x):
        return torch.as_tensor(x, device=device) if isinstance(x, np.ndarray) else x

    return conv


def save_params(path: Union[str, Path], params: Any) -> None:
    with open(path, "wb") as f:
        pickle.dump(tree_map(_to_numpy, params), f)


def load_params(path: Union[str, Path], device="cuda") -> Any:
    """Load a tree saved by save_params, its arrays as tensors on `device`.

    SECURITY: this is pickle (the JAX package's and brax's format):
    deserializing executes code from the file. Only load checkpoints you
    trust. For untrusted interchange of plain array trees, use
    save_arrays/load_arrays (npz, data-only) instead.
    """
    with open(path, "rb") as f:
        return tree_map(_to_tensor(device), pickle.load(f))


def save_arrays(path: Union[str, Path], tree: Any) -> None:
    """Data-only checkpoint (npz) of a tree's array leaves: safe to load from
    untrusted sources, but needs a structurally matching `like` tree at load
    time (the structure is not stored)."""
    leaves = [np.asarray(_to_numpy(x)) for x in tree_leaves(tree)]
    np.savez(path, **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_arrays(path: Union[str, Path], like: Any, device="cuda") -> Any:
    """Restore a tree saved by save_arrays into the structure of `like`."""
    with np.load(path, allow_pickle=False) as z:
        leaves = iter([torch.as_tensor(z[f"leaf_{i}"], device=device) for i in range(len(z.files))])
    return tree_map(lambda _: next(leaves), like)
