"""What the five trainers share: the deterministic eval (the JAX
package's `run_evaluation`, one function written once in each of its
trainers), the device check, the refusal of `mesh` and the synchronize
that ends each timed phase.
"""

from __future__ import annotations

import torch

from ambersim_tpu_torch.rl.base import MjxEnv


@torch.no_grad()
def episode_return(eval_env: MjxEnv, policy, generator: torch.Generator, num_envs: int, steps: int) -> torch.Tensor:
    """Mean over `num_envs` fresh envs of the reward summed until each env's
    first done, over `steps` control steps of `policy(obs) -> (action, _)`.
    Stays on the device (a 0-d tensor)."""
    state = eval_env.reset(generator, num_envs)
    device = state.obs.device
    active = torch.ones(num_envs, device=device)
    total = torch.zeros(num_envs, device=device)
    for _ in range(steps):
        act, _ = policy(state.obs)
        state = eval_env.step(state, act)
        total = total + state.reward * active
        active = active * (1 - state.done)
    return total.mean()


def check_device(device) -> torch.device:
    """`device` as a torch.device; raises for a card torch cannot see (no
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA card")
    return device


def refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh: multi-GPU data parallelism is not ported (ROADMAP, queue 1: multi-GPU and tooling)"
        )


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
