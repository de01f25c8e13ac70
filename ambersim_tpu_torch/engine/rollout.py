"""Rollout helper (port of ambersim_tpu/engine/rollout.py): a Python loop
takes the place of lax.scan. Every step recomputes each derived field it
reads, so looping over full Data is the JAX rollout's minimal carry."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ambersim_tpu_torch.core.types import Data, Model
from ambersim_tpu_torch.engine.forward import step


def rollout(
    m: Model,
    d: Data,
    length: int,
    ctrl_fn: Optional[Callable[[Data], torch.Tensor]] = None,
) -> Data:
    """Step the batch `length` times; `ctrl_fn(d) -> (B, nu)` sets ctrl
    before each step. Returns the final Data."""
    for _ in range(length):
        if ctrl_fn is not None:
            d = d.replace(ctrl=ctrl_fn(d))
        d = step(m, d)
    return d
