"""Launcher of kernel 4 (csrc/newton_structured.cu): the pyramidal Newton
constraint solve on the factored row layout, one thread block per env.

It replaces newton_solve_structured of ambersim_tpu/ops/newton_pallas.py.
Its plain PyTorch version, which the CPU path runs and the kernel is held
against, is `_newton_arrays` in engine/solver.py (a batched port of
_newton_arrays_jnp); `engine.solver.solve` chooses by device.
"""

from __future__ import annotations

import torch

from ambersim_tpu_torch.engine.schedule import device_index
from ambersim_tpu_torch.ops._build import LAUNCHES, check_launch, library, stream_handle

MAX_NV = 32
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper


def newton_solve_structured(
    J: torch.Tensor,  # (B, nefc, nv) MuJoCo row order; only the dense rows are read
    bJ: torch.Tensor,  # (B, 3*ncon3, nv) contact basis [N | mu1 T1 | mu2 T2] (Data.efc_bJ)
    dsc: torch.Tensor,  # (B, ndiag) signed one-hot values (Data.efc_dsc)
    qM: torch.Tensor,  # (B, nv, nv)
    aref: torch.Tensor,  # (B, nefc)
    D: torch.Tensor,  # (B, nefc)
    fl: torch.Tensor,  # (B, nefc) frictionloss
    active: torch.Tensor,  # (B, nefc) float32 0/1
    qacc_smooth: torch.Tensor,  # (B, nv)
    warmstart: torch.Tensor,  # (B, nv)
    tol: torch.Tensor,  # (1,) convergence tolerance on the cost decrease
    *,
    st,  # engine.constraint.PyramidStructure of the model
    iterations: int,
    ls_iterations: int,
    use_ws: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns qacc (B, nv), efc_force (B, nefc) in MuJoCo row order and
    qfrc_constraint = J^T efc_force (B, nv)."""
    B, nefc, nv = J.shape
    ncon, ndiag, nd = st.ncon3, st.ndiag, st.nd
    shapes = {
        "J": (J, (B, nefc, nv)),
        "bJ": (bJ, (B, 3 * ncon, nv)),
        "dsc": (dsc, (B, ndiag)),
        "qM": (qM, (B, nv, nv)),
        "aref": (aref, (B, nefc)),
        "D": (D, (B, nefc)),
        "fl": (fl, (B, nefc)),
        "active": (active, (B, nefc)),
        "qacc_smooth": (qacc_smooth, (B, nv)),
        "warmstart": (warmstart, (B, nv)),
        "tol": (tol, (1,)),
    }
    for name, (x, shape) in shapes.items():
        if x.device.type != "cuda" or x.device != J.device:
            raise ValueError(f"newton_solve_structured: {name} must be on {J.device} (CUDA), got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"newton_solve_structured: {name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"newton_solve_structured: {name} must be {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"newton_solve_structured: {name} must be contiguous")
        if x.requires_grad:
            raise ValueError("newton_solve_structured: the kernel has no backward; pass tensors without requires_grad")
    if nefc != nd + ndiag + 4 * ncon:
        raise ValueError(f"newton_solve_structured: nefc={nefc} does not match the row structure")
    if not 1 <= nv <= MAX_NV:
        raise ValueError(f"newton_solve_structured: the kernel takes 1 <= nv <= {MAX_NV}, got {nv}")
    if ncon < 1:
        raise ValueError("newton_solve_structured: needs at least one condim-3 contact")
    lib = library()
    smem = lib.amb_newton_smem_bytes(nv, nefc, nd, ndiag, ncon)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"newton_solve_structured: one env needs {smem} B of shared memory (> {MAX_SMEM_BYTES})")

    qacc = torch.empty_like(qacc_smooth)
    force = torch.empty_like(aref)
    qfrc = torch.empty_like(qacc_smooth)
    if B:
        perm = device_index(st.perm, J.device, torch.int32)
        diag_dofs = device_index(st.diag_dofs, J.device, torch.int32)
        ptrs = [x.data_ptr() for x in (J, bJ, dsc, qM, aref, D, fl, active, qacc_smooth, warmstart, tol,
                                      perm, diag_dofs, qacc, force, qfrc)]
        ints = [B, nv, nefc, nd, ndiag, ncon, st.nd_eq, st.nd_ft, st.nfd, iterations, ls_iterations, int(use_ws)]
        err = lib.amb_newton_structured(*ptrs, *ints, stream_handle(J.device))
        check_launch(err, "newton_structured")
        LAUNCHES["newton_structured"] += 1
    return qacc, force, qfrc
