"""Launchers of the Newton constraint-solve kernels:

  * kernel 4 (csrc/newton_structured.cu): pyramidal rows on the factored
    layout, replacing newton_solve_structured of
    ambersim_tpu/ops/newton_pallas.py;
  * kernel 5 (csrc/newton_dense.cu): pyramidal rows as a dense J,
    replacing newton_solve_batched;
  * kernel 6 (csrc/newton_elliptic.cu): elliptic cones on one contiguous
    condim tail, replacing newton_solve_elliptic.

All three run one warp per env, four envs a block (csrc/newton_warp.cuh).

Their plain PyTorch versions, which the CPU path runs and the kernels are
held against, are `_newton_arrays` (kernels 4 and 5) and
`_newton_arrays_elliptic` (kernel 6) in engine/solver.py; `solve` there
chooses the route. Each launcher takes only what its kernel takes and
raises on anything else (no fallback): float32, contiguous, on one CUDA
device, no tensor that requires grad, 1 <= nv <= 32, one block's envs
within the card's shared memory. The kernels have no backward: the
Functions of engine.solver (`newton_structured`, `newton_dense`,
`newton_elliptic`, built by engine.linalg.differentiable_dispatch) carry
the gradient through the plain versions and hand the launchers detached
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ambersim_tpu_torch.engine.schedule import device_index
from ambersim_tpu_torch.ops._build import LAUNCHES, check_launch, library, stream_handle

MAX_NV = 32
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper


def _check(name: str, device: torch.device, operands: dict) -> None:
    """Raise unless every operand is a contiguous float32 tensor of its
    shape on `device` (a CUDA device) without autograd."""
    for key, (x, shape) in operands.items():
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"{name}: {key} must be on {device} (CUDA), got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {key} must be {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{name}: the kernel has no backward; pass tensors without requires_grad")


def _check_limits(name: str, nv: int, smem: int) -> None:
    if not 1 <= nv <= MAX_NV:
        raise ValueError(f"{name}: the kernel takes 1 <= nv <= {MAX_NV}, got nv={nv}")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: one block needs {smem} B of shared memory (> {MAX_SMEM_BYTES})")


def _row_operands(J, qM, aref, D, fl, active, qacc_smooth, warmstart, tol) -> dict:
    B, nefc, nv = J.shape
    return {
        "J": (J, (B, nefc, nv)),
        "qM": (qM, (B, nv, nv)),
        "aref": (aref, (B, nefc)),
        "D": (D, (B, nefc)),
        "fl": (fl, (B, nefc)),
        "active": (active, (B, nefc)),
        "qacc_smooth": (qacc_smooth, (B, nv)),
        "warmstart": (warmstart, (B, nv)),
        "tol": (tol, (1,)),
    }


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
    """Kernel 4. Returns qacc (B, nv), efc_force (B, nefc) in MuJoCo row order
    and qfrc_constraint = J^T efc_force (B, nv)."""
    name = "newton_solve_structured"
    B, nefc, nv = J.shape
    ncon, ndiag, nd = st.ncon3, st.ndiag, st.nd
    operands = _row_operands(J, qM, aref, D, fl, active, qacc_smooth, warmstart, tol)
    operands.update(bJ=(bJ, (B, 3 * ncon, nv)), dsc=(dsc, (B, ndiag)))
    _check(name, J.device, operands)
    if nefc != nd + ndiag + 4 * ncon:
        raise ValueError(f"{name}: nefc={nefc} does not match the row structure")
    if ncon < 1:
        raise ValueError(f"{name}: needs at least one condim-3 contact")
    lib = library()
    _check_limits(name, nv, lib.amb_newton_smem_bytes(nv, nefc, nd, ndiag, ncon))

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


def _occupancy(fn, kernel: str, *shape: int) -> int:
    envs = ctypes.c_int(0)
    check_launch(fn(*shape, ctypes.byref(envs)), kernel)
    return envs.value


def structured_occupancy(nv: int, nefc: int, st) -> int:
    """Envs of kernel 4 resident on one SM of the current card at these
    shapes (its blocks per SM times the envs a block holds)."""
    return _occupancy(library().amb_newton_occupancy, "newton_structured", nv, nefc, st.nd, st.ndiag, st.ncon3)


def dense_occupancy(nv: int, nefc: int) -> int:
    """Envs of kernel 5 resident on one SM of the current card at these shapes."""
    return _occupancy(library().amb_newton_dense_occupancy, "newton_dense", nv, nefc)


def elliptic_occupancy(nv: int, nefc: int, ncon: int, cdim: int) -> int:
    """Envs of kernel 6 resident on one SM of the current card at these shapes."""
    return _occupancy(library().amb_newton_elliptic_occupancy, "newton_elliptic", nv, nefc, ncon, cdim)


def newton_solve_dense(
    J: torch.Tensor,  # (B, nefc, nv) MuJoCo row order: ne equality, nf friction, then one-sided rows
    qM: torch.Tensor,  # (B, nv, nv)
    aref: torch.Tensor,  # (B, nefc)
    D: torch.Tensor,  # (B, nefc)
    fl: torch.Tensor,  # (B, nefc) frictionloss
    active: torch.Tensor,  # (B, nefc) float32 0/1
    qacc_smooth: torch.Tensor,  # (B, nv)
    warmstart: torch.Tensor,  # (B, nv)
    tol: torch.Tensor,  # (1,) convergence tolerance on the cost decrease
    *,
    ne: int,
    nf: int,
    iterations: int,
    ls_iterations: int,
    use_ws: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 5. Returns qacc (B, nv), efc_force (B, nefc) and
    qfrc_constraint = J^T efc_force (B, nv)."""
    name = "newton_solve_dense"
    B, nefc, nv = J.shape
    _check(name, J.device, _row_operands(J, qM, aref, D, fl, active, qacc_smooth, warmstart, tol))
    if nefc < 1 or not 0 <= ne <= ne + nf <= nefc:
        raise ValueError(f"{name}: needs 0 <= ne <= ne + nf <= nefc and nefc >= 1, got ne={ne} nf={nf} nefc={nefc}")
    lib = library()
    _check_limits(name, nv, lib.amb_newton_dense_smem_bytes(nv, nefc))

    qacc = torch.empty_like(qacc_smooth)
    force = torch.empty_like(aref)
    qfrc = torch.empty_like(qacc_smooth)
    if B:
        ptrs = [x.data_ptr() for x in (J, qM, aref, D, fl, active, qacc_smooth, warmstart, tol, qacc, force, qfrc)]
        ints = [B, nv, nefc, ne, nf, iterations, ls_iterations, int(use_ws)]
        err = lib.amb_newton_dense(*ptrs, *ints, stream_handle(J.device))
        check_launch(err, "newton_dense")
        LAUNCHES["newton_dense"] += 1
    return qacc, force, qfrc


def newton_solve_elliptic(
    J: torch.Tensor,  # (B, nefc, nv) MuJoCo row order: nh head rows, then ncon blocks of cdim rows
    qM: torch.Tensor,  # (B, nv, nv)
    aref: torch.Tensor,  # (B, nefc)
    D: torch.Tensor,  # (B, nefc)
    fl: torch.Tensor,  # (B, nefc) frictionloss
    active: torch.Tensor,  # (B, nefc) float32 0/1
    qacc_smooth: torch.Tensor,  # (B, nv)
    warmstart: torch.Tensor,  # (B, nv)
    tol: torch.Tensor,  # (1,) convergence tolerance on the cost decrease
    friction: torch.Tensor,  # (B, ncon, >= cdim-1) the blocks' contact friction
    impratio,  # Option.impratio (a scalar)
    *,
    ne: int,
    nf: int,
    base: int,  # first contact row; head rows are [0, base)
    ncon: int,
    cdim: int,
    iterations: int,
    ls_iterations: int,
    use_ws: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 6. Returns qacc (B, nv), efc_force (B, nefc) in MuJoCo row
    order and qfrc_constraint = J^T efc_force (B, nv)."""
    from ambersim_tpu_torch.engine.solver import cone_params

    name = "newton_solve_elliptic"
    B, nefc, nv = J.shape
    S, nfr, nh = ncon, cdim - 1, base
    _check(name, J.device, _row_operands(J, qM, aref, D, fl, active, qacc_smooth, warmstart, tol))
    if not 2 <= cdim <= 6 or S < 1 or nh + S * cdim != nefc or not 0 <= ne <= ne + nf <= nh:
        raise ValueError(f"{name}: needs 2 <= cdim <= 6, ncon >= 1, nefc = base + ncon*cdim and ne + nf <= base")
    if friction.shape[:2] != (B, S) or friction.shape[2] < nfr or friction.device != J.device:
        raise ValueError(f"{name}: friction must be ({B}, {S}, >= {nfr}) on {J.device}, got {tuple(friction.shape)}")
    lib = library()
    _check_limits(name, nv, lib.amb_newton_elliptic_smem_bytes(nv, nefc, S, cdim))

    # the cone parameters ride the batch as (B, S) and dim-major (B, nfr*S) planes
    mu, scale = cone_params(friction.float(), impratio, cdim)
    mu = mu.contiguous()
    scale = scale.transpose(1, 2).reshape(B, nfr * S).contiguous()
    qacc = torch.empty_like(qacc_smooth)
    force = torch.empty_like(aref)
    qfrc = torch.empty_like(qacc_smooth)
    if B:
        ptrs = [x.data_ptr() for x in (J, qM, aref, D, fl, active, qacc_smooth, warmstart, tol, mu, scale, qacc,
                                      force, qfrc)]
        ints = [B, nv, nefc, ne, nf, nh, S, cdim, iterations, ls_iterations, int(use_ws)]
        err = lib.amb_newton_elliptic(*ptrs, *ints, stream_handle(J.device))
        check_launch(err, "newton_elliptic")
        LAUNCHES["newton_elliptic"] += 1
    return qacc, force, qfrc


def elliptic_ls_step(state: torch.Tensor) -> torch.Tensor:
    """Kernel 6's line-search step applied on the card to (n, 5) states
    (t, lo, hi, phi'(t), phi''(t)); returns (n, 3) (t, lo, hi). A probe for
    the checks of its non-finite handling, not a main-path kernel."""
    if state.device.type != "cuda" or state.dtype != torch.float32 or state.dim() != 2 or state.shape[1] != 5:
        raise ValueError("elliptic_ls_step: state must be a (n, 5) float32 CUDA tensor")
    state = state.contiguous()
    out = torch.empty((state.shape[0], 3), dtype=torch.float32, device=state.device)
    if state.shape[0]:
        err = library().amb_elliptic_ls_step(state.data_ptr(), out.data_ptr(), state.shape[0],
                                             stream_handle(state.device))
        check_launch(err, "elliptic_ls_step")
    return out
