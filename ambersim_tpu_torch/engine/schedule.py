"""Host-side tree schedules for level-vectorized propagation.

`TreeSchedule` is a numpy copy of ambersim_tpu/engine/schedule.py: bodies are
grouped by depth level and joint signature, so each (level, signature) group
is one batched tensor operation and the op count scales with tree depth, not
body count. `device_index` turns the schedule's numpy index arrays into
cached device tensors: indexing a CUDA tensor with a numpy array would copy
the index to the device on every call.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ambersim_tpu_torch.core.types import JointType

_CACHE: dict = {}
_INDEX_CACHE: dict = {}


class TreeSchedule:
    def __init__(self, s):
        nbody = s.nbody
        depth = np.zeros(nbody, dtype=np.int32)
        for b in range(1, nbody):
            depth[b] = depth[s.body_parentid[b]] + 1
        maxdepth = int(depth.max()) if nbody > 1 else 0

        # levels[k]: list of (signature, body_ids, parent_ids, jnt_ids_per_slot)
        self.levels: List[List[Tuple[Tuple[int, ...], np.ndarray, np.ndarray, List[np.ndarray]]]] = []
        for k in range(1, maxdepth + 1):
            ids = np.nonzero(depth == k)[0].astype(np.int32)
            groups: Dict[Tuple[int, ...], List[int]] = {}
            for b in ids:
                jadr, jnum = int(s.body_jntadr[b]), int(s.body_jntnum[b])
                sig = tuple(int(s.jnt_type[j]) for j in range(jadr, jadr + jnum))
                groups.setdefault(sig, []).append(int(b))
            level = []
            for sig, blist in groups.items():
                barr = np.asarray(blist, dtype=np.int32)
                parents = s.body_parentid[barr]
                jnt_slots = [
                    np.asarray([int(s.body_jntadr[b]) + slot for b in blist], dtype=np.int32)
                    for slot in range(len(sig))
                ]
                level.append((sig, barr, parents, jnt_slots))
            self.levels.append(level)

        # bottom-up accumulation pairs: per level (child ids, parent ids), deepest first
        self.reverse_levels = [
            (np.concatenate([g[1] for g in level]), np.concatenate([g[2] for g in level]))
            for level in reversed(self.levels)
        ]

        # joints grouped by type (order-free computations like cdof)
        self.jnt_by_type: Dict[int, np.ndarray] = {}
        for t in (JointType.FREE, JointType.BALL, JointType.SLIDE, JointType.HINGE):
            jids = np.nonzero(s.jnt_type == int(t))[0].astype(np.int32)
            if len(jids):
                self.jnt_by_type[int(t)] = jids


def tree_schedule(s) -> TreeSchedule:
    # Skeleton is content-hashed, so it is its own safe cache key
    if s not in _CACHE:
        _CACHE[s] = TreeSchedule(s)
    return _CACHE[s]


def device_index(arr, device, dtype=None) -> torch.Tensor:
    """Cached device tensor for a small static numpy index or mask array
    (int arrays become int64, bool arrays stay bool, floats become f32,
    unless `dtype` says otherwise)."""
    arr = np.array(arr)  # a writable copy (skeleton arrays are read-only)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(device), dtype)
    t = _INDEX_CACHE.get(key)
    if t is None:
        if dtype is not None:
            t = torch.as_tensor(arr, dtype=dtype, device=device)
        elif arr.dtype == np.bool_:
            t = torch.as_tensor(arr, device=device)
        elif np.issubdtype(arr.dtype, np.integer):
            t = torch.as_tensor(arr.astype(np.int64), device=device)
        else:
            t = torch.as_tensor(arr.astype(np.float32), device=device)
        _INDEX_CACHE[key] = t
    return t
