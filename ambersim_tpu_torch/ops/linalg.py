"""Launchers of kernels 1-3: batched Cholesky factor, Cholesky solve and
fused SPD solve on CUDA tensors, in two designs chosen by n:

  * 1 <= n <= 32: one warp per system (csrc/linalg.cu), counted as
    `cholesky`, `cho_solve` and `solve_pd`;
  * 32 < n <= 192: one thread block per system (csrc/linalg_block.cu),
    counted as `cholesky_block`, `cho_solve_block` and `solve_pd_block`.
    All three keep the lower triangle as 16 x 16 tiles in shared memory
    (two blocks an SM at n = 192); the factor and the fused solve factor it
    by panels, and both solves substitute a tile at a time.

They replace cholesky_batched, cho_solve_batched and solve_pd_batched of
ambersim_tpu/ops/linalg_pallas.py, which the JAX package runs up to n = 192
(engine/linalg.py:30) and past that sends to XLA's native path; that range is
still to port here (ROADMAP.md). Their plain PyTorch versions, which the CPU
path runs and the kernels are held against, are
`cholesky_unrolled`/`cho_solve_unrolled`/`solve_pd_unrolled` in
engine/linalg.py; `engine.linalg.cholesky` etc. choose by device.

Each launcher takes only what its kernels take and raises on anything else
(no fallback): float32, contiguous, on a CUDA device, (B, n, n) with
1 <= n <= 192 and (B, n) right-hand sides, no tensor that requires grad.
Kernel 2 also takes (B, k, n) right-hand sides, k >= 1, each solved against
its env's factor read in place (system (e, j) reads factor e); it counts
one launch whatever k.
The kernels have no backward: engine.linalg's Functions
(`differentiable_dispatch`) carry the gradient, handing the launchers
detached tensors and running autograd through the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ambersim_tpu_torch.ops._build import LAUNCHES, check_launch, library, stream_handle

MAX_N_WARP = 32  # one warp per system: lane i owns row i
MAX_N = 192  # one block per system: the lower triangle's 78 tiles of 16 x 16 in shared memory
_TILED_KERNELS = ("cholesky_block", "cho_solve_block", "solve_pd_block")


def _check(name: str, mats: torch.Tensor, vecs: torch.Tensor | None = None, rhs: bool = False) -> tuple[int, int]:
    """(B, n) of a launch's operands; raises on any shape, device, dtype or
    layout the kernels do not take (shapes first). `rhs`: the kernel also
    takes (B, k, n) right-hand sides, k >= 1."""
    if mats.dim() != 3 or mats.shape[1] != mats.shape[2]:
        raise ValueError(f"{name}: matrices must be (B, n, n), got {tuple(mats.shape)}")
    B, n = mats.shape[0], mats.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: the kernels take 1 <= n <= {MAX_N}, got n={n}")
    if vecs is not None and not (tuple(vecs.shape) == (B, n) or rhs and vecs.dim() == 3 and vecs.shape[1] >= 1
                                 and tuple(vecs.shape) == (B, vecs.shape[1], n)):
        want = f"({B}, {n}) or ({B}, k >= 1, {n})" if rhs else str((B, n))
        raise ValueError(f"{name}: right-hand side must be {want}, got {tuple(vecs.shape)}")
    for x in (mats,) if vecs is None else (mats, vecs):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{name}: the kernel has no backward; pass tensors without requires_grad")
    if vecs is not None and vecs.device != mats.device:
        raise ValueError(f"{name}: inputs on different devices")
    return B, n


def _launch(kernel: str, n: int, *args, entry: str = "") -> None:
    """Launch `kernel` (warp design) or `kernel`_block (block design) by n,
    through the C entry amb_<name><entry>; counted under its name."""
    name = kernel if n <= MAX_N_WARP else f"{kernel}_block"
    check_launch(getattr(library(), f"amb_{name}{entry}")(*args), name)
    LAUNCHES[name] += 1


def cholesky_batched(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of (B, n, n) SPD matrices (kernel 1). Reads
    only the lower triangle; the result is zero above the diagonal."""
    B, n = _check("cholesky_batched", a)
    out = torch.empty_like(a)
    if B:
        _launch("cholesky", n, a.data_ptr(), out.data_ptr(), B, n, stream_handle(a.device))
    return out


def cho_solve_batched(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b from lower factors L (B, n, n), b (B, n) or (B, k, n):
    the k right-hand sides of env e against its factor (kernel 2)."""
    B, n = _check("cho_solve_batched", l, b, rhs=True)
    out = torch.empty_like(b)
    if b.numel():
        k = b.shape[1] if b.dim() == 3 else 1
        _launch("cho_solve", n, l.data_ptr(), b.data_ptr(), out.data_ptr(), B, k, n, stream_handle(l.device),
                entry="_rhs")
    return out


def solve_pd_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD systems A (B, n, n) x = b (B, n), factor and solve fused (kernel 3)."""
    B, n = _check("solve_pd_batched", a, b)
    out = torch.empty_like(b)
    if B:
        _launch("solve_pd", n, a.data_ptr(), b.data_ptr(), out.data_ptr(), B, n, stream_handle(a.device))
    return out


def block_occupancy(name: str, n: int) -> int:
    """Resident blocks per SM of the block kernel `name` (`cholesky_block`,
    `cho_solve_block` or `solve_pd_block`) at size n, on the current card."""
    blocks = ctypes.c_int(0)
    check_launch(library().amb_linalg_block_occupancy(_TILED_KERNELS.index(name), n, ctypes.byref(blocks)), name)
    return blocks.value
