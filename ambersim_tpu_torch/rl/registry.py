"""Environment registry (port of ambersim_tpu/rl/registry.py)."""

from __future__ import annotations

from typing import Callable, Dict

from ambersim_tpu_torch.rl.base import MjxEnv

_REGISTRY: Dict[str, Callable[..., MjxEnv]] = {}


def register_environment(name: str, env_class: Callable[..., MjxEnv]) -> None:
    _REGISTRY[name] = env_class


def get_environment(name: str, **kwargs) -> MjxEnv:
    if name not in _REGISTRY:
        raise KeyError(f"unknown environment '{name}'; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def registered_environments() -> list:
    return sorted(_REGISTRY)
