"""Batched small dense linear algebra for the engine.

`cholesky`, `cho_solve` and `solve_pd` take batch-first (B, n, n) / (B, n)
tensors. A CUDA tensor goes to the hand-written kernels in ops/linalg.py
(kernels 1-3); a CPU tensor goes to the plain versions below, which port
the unrolled jnp path of ambersim_tpu/engine/linalg.py:146-197 (including
the max(a_jj, 1e-12) clamp) and are what the kernels are held against.
"""

from __future__ import annotations

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
        acc = (l[..., j, :] * y).sum(-1)
        y[..., j] = (b[..., j] - acc) / l[..., j, j]
    return y


def solve_upper_t(l: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y (backward substitution on the transpose)."""
    x = torch.zeros_like(y)
    for j in range(l.shape[-1] - 1, -1, -1):
        acc = (l[..., :, j] * x).sum(-1)
        x[..., j] = (y[..., j] - acc) / l[..., j, j]
    return x


def cho_solve_unrolled(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor of A."""
    return solve_upper_t(l, solve_lower(l, b))


def solve_pd_unrolled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system A x = b."""
    return cho_solve_unrolled(cholesky_unrolled(a), b)


def _plain(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (B, n, n) SPD matrices (kernel 1 on CUDA)."""
    if _plain(a):
        return cholesky_unrolled(a)
    from ambersim_tpu_torch.ops import linalg as kernels

    return kernels.cholesky_batched(a)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b from A's lower factor, (B, n, n) and (B, n) (kernel 2 on CUDA)."""
    if _plain(l):
        return cho_solve_unrolled(l, b)
    from ambersim_tpu_torch.ops import linalg as kernels

    return kernels.cho_solve_batched(l, b)


def solve_pd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems A x = b, (B, n, n) and (B, n) (kernel 3 on CUDA)."""
    if _plain(a):
        return solve_pd_unrolled(a, b)
    from ambersim_tpu_torch.ops import linalg as kernels

    return kernels.solve_pd_batched(a, b)
