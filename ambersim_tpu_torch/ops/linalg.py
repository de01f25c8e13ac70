"""Launchers of kernels 1-3 (csrc/linalg.cu): batched Cholesky factor,
Cholesky solve and fused SPD solve on CUDA tensors.

They replace cholesky_batched, cho_solve_batched and solve_pd_batched of
ambersim_tpu/ops/linalg_pallas.py. Their plain PyTorch versions, which the
CPU path runs and the kernels are held against, are
`cholesky_unrolled`/`cho_solve_unrolled`/`solve_pd_unrolled` in
engine/linalg.py; `engine.linalg.cholesky` etc. choose by device.

Each launcher takes only what its kernel takes and raises on anything else
(no fallback): float32, contiguous, on a CUDA device, (B, n, n) with
1 <= n <= 32 and (B, n) right-hand sides, no autograd.
"""

from __future__ import annotations

import torch

from ambersim_tpu_torch.ops._build import LAUNCHES, check_launch, library, stream_handle

MAX_N = 32


def _check(name: str, mats: torch.Tensor, vecs: torch.Tensor | None = None) -> tuple[int, int]:
    for x in (mats,) if vecs is None else (mats, vecs):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{name}: the kernel has no backward; pass tensors without requires_grad")
    if mats.dim() != 3 or mats.shape[1] != mats.shape[2]:
        raise ValueError(f"{name}: matrices must be (B, n, n), got {tuple(mats.shape)}")
    B, n = mats.shape[0], mats.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: the kernel takes 1 <= n <= {MAX_N}, got n={n}")
    if vecs is not None:
        if tuple(vecs.shape) != (B, n):
            raise ValueError(f"{name}: right-hand side must be {(B, n)}, got {tuple(vecs.shape)}")
        if vecs.device != mats.device:
            raise ValueError(f"{name}: inputs on different devices")
    return B, n


def cholesky_batched(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of (B, n, n) SPD matrices (kernel 1). Reads
    only the lower triangle; the result is zero above the diagonal."""
    B, n = _check("cholesky_batched", a)
    out = torch.empty_like(a)
    if B:
        err = library().amb_cholesky(a.data_ptr(), out.data_ptr(), B, n, stream_handle(a.device))
        check_launch(err, "cholesky")
        LAUNCHES["cholesky"] += 1
    return out


def cho_solve_batched(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b from lower factors L (B, n, n), b (B, n) (kernel 2)."""
    B, n = _check("cho_solve_batched", l, b)
    out = torch.empty_like(b)
    if B:
        err = library().amb_cho_solve(l.data_ptr(), b.data_ptr(), out.data_ptr(), B, n, stream_handle(l.device))
        check_launch(err, "cho_solve")
        LAUNCHES["cho_solve"] += 1
    return out


def solve_pd_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD systems A (B, n, n) x = b (B, n), factor and solve fused (kernel 3)."""
    B, n = _check("solve_pd_batched", a, b)
    out = torch.empty_like(b)
    if B:
        err = library().amb_solve_pd(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, n, stream_handle(a.device))
        check_launch(err, "solve_pd")
        LAUNCHES["solve_pd"] += 1
    return out
