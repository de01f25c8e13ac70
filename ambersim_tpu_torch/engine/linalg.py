"""Batched small dense linear algebra for the engine.

`cholesky`, `cho_solve` and `solve_pd` take batch-first (B, n, n) / (B, n)
tensors. A CUDA tensor goes to the hand-written kernels in ops/linalg.py
(kernels 1-3); a CPU tensor goes to the plain versions below, which port
the unrolled jnp path of ambersim_tpu/engine/linalg.py:146-197 (including
the max(a_jj, 1e-12) clamp) and are what the kernels are held against.

The kernels have no backward, as the Pallas kernels have none:
`differentiable_dispatch` (JAX engine/linalg.py:273-292) wraps a kernel in
a `torch.autograd.Function` whose forward pass launches it and whose
backward pass runs autograd through its plain version. A call takes that
Function only when grad mode is on and an input requires grad; otherwise
it launches the kernel directly, so a forward-only path keeps its launches
and bits.
"""

from __future__ import annotations

from typing import Callable

import torch


def cholesky_unrolled(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (..., n, n) SPD matrices by column sweep. Reads only
    the lower triangle; the result is zero above the diagonal."""
    n = a.shape[-1]
    l = torch.zeros_like(a)
    for j in range(n):
        d = torch.sqrt(torch.clamp(a[..., j, j], min=1e-12))
        col = a[..., :, j] / d[..., None]
        col[..., :j] = 0.0  # col is a fresh tensor: zero its strictly-upper part
        l[..., :, j] = col
        a = a - col[..., :, None] * col[..., None, :]  # rank-1 trailing downdate
    return l


def solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b with L (..., n, n) lower-triangular, b (..., n)."""
    y = torch.zeros_like(b)
    for j in range(l.shape[-1]):
        # the product reads a clone: autograd saves it, and y is written below
        acc = (l[..., j, :] * y.clone()).sum(-1)
        y[..., j] = (b[..., j] - acc) / l[..., j, j]
    return y


def solve_upper_t(l: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y (backward substitution on the transpose)."""
    x = torch.zeros_like(y)
    for j in range(l.shape[-1] - 1, -1, -1):
        acc = (l[..., :, j] * x.clone()).sum(-1)
        x[..., j] = (y[..., j] - acc) / l[..., j, j]
    return x


def cho_solve_unrolled(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor of A: l (B, n, n) and b
    (B, n), or b (B, k, n), the k right-hand sides of env e against its
    factor (broadcast, never copied)."""
    if b.dim() == l.dim():
        l = l.unsqueeze(-3)
    return solve_upper_t(l, solve_lower(l, b))


def solve_pd_unrolled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system A x = b."""
    return cho_solve_unrolled(cholesky_unrolled(a), b)


def _detached(args) -> list:
    return [None if a is None else a.detach() for a in args]


def differentiable_dispatch(kernel_fn: Callable, plain_fn: Callable) -> Callable:
    """`call(*args, **statics)`: `kernel_fn(*args, **statics)`, with
    reverse-mode gradients from `plain_fn`, which takes the same arguments
    and computes the same function (JAX engine/linalg.py:273-292).

    When grad mode is on and a tensor of `args` requires grad, the call goes
    through a `torch.autograd.Function`: its forward pass
    runs `kernel_fn` on detached inputs and saves them; its backward pass
    re-runs `plain_fn` under `torch.enable_grad()` on detached copies that
    require grad where the caller's inputs do, and returns
    `torch.autograd.grad` of its outputs, so an input the plain version does
    not read gets None. Otherwise the call is `kernel_fn` itself, on
    detached inputs (under no_grad an input may still require grad). `args`
    are tensors or None; `statics` go to both functions unchanged."""

    class Dispatch(torch.autograd.Function):
        @staticmethod
        def forward(ctx, statics, *args):
            ctx.statics = statics
            ctx.save_for_backward(*args)
            ctx.set_materialize_grads(False)
            return kernel_fn(*_detached(args), **statics)

        @staticmethod
        def backward(ctx, *grads):
            needs = ctx.needs_input_grad[1:]
            with torch.enable_grad():
                inputs = [None if a is None else a.detach().requires_grad_(need)
                          for a, need in zip(ctx.saved_tensors, needs)]
                out = plain_fn(*inputs, **ctx.statics)
                outs = out if isinstance(out, tuple) else (out,)
                pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
                wrt = [x for x, need in zip(inputs, needs) if need]
                got = [None] * len(wrt)
                if pairs and wrt:
                    got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True)
            got = iter(got)
            return (None, *(next(got) if need else None for need in needs))

    def call(*args, **statics):
        if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
            return Dispatch.apply(statics, *args)
        return kernel_fn(*_detached(args), **statics)

    return call


def _launcher(name: str) -> Callable:
    """ops.linalg's launcher `name`, imported at the call."""

    def launch(*args):
        from ambersim_tpu_torch.ops import linalg as kernels

        return getattr(kernels, name)(*args)

    return launch


cholesky_kernel = differentiable_dispatch(_launcher("cholesky_batched"), cholesky_unrolled)
cho_solve_kernel = differentiable_dispatch(_launcher("cho_solve_batched"), cho_solve_unrolled)
solve_pd_kernel = differentiable_dispatch(_launcher("solve_pd_batched"), solve_pd_unrolled)


def _plain(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (B, n, n) SPD matrices (kernel 1 on CUDA)."""
    return cholesky_unrolled(a) if _plain(a) else cholesky_kernel(a)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b from A's lower factor, (B, n, n) and (B, n) or (B, k, n)
    (kernel 2 on CUDA)."""
    return cho_solve_unrolled(l, b) if _plain(l) else cho_solve_kernel(l, b)


def solve_pd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems A x = b, (B, n, n) and (B, n) (kernel 3 on CUDA)."""
    return solve_pd_unrolled(a, b) if _plain(a) else solve_pd_kernel(a, b)
