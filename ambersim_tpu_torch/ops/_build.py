"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources are compiled with nvcc for Hopper (sm_90a) into one shared
library with a plain C interface under ``ambersim_tpu_torch/_build/`` and
loaded with ctypes. The library's file name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library never loads.
Nothing here runs at import: the CPU tests import every module.

Each launcher in ops/ adds one to its entry of `LAUNCHES` when it launches
its kernel, so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("linalg.cu", "linalg_block.cu", "newton_structured.cu", "newton_dense.cu", "newton_elliptic.cu")
HEADERS = ("linalg.cuh", "newton_warp.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "cholesky": 0, "cho_solve": 0, "solve_pd": 0, "cholesky_block": 0, "cho_solve_block": 0, "solve_pd_block": 0,
    "newton_structured": 0, "newton_dense": 0, "newton_elliptic": 0,
}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels cannot be built")


def build() -> tuple[Path, float]:
    """Compile the kernels if this source version is not built yet: one nvcc
    per source, all started together, then one link. Returns (library path,
    seconds spent compiling; 0.0 when cached). The compiler's
    register/shared-memory report goes to a .log beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    lib_path = BUILD / f"libambersim_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path, 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(CSRC / s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, log) for s, p, log in zip(SOURCES, procs, logs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(("link", link.returncode, link.stdout + link.stderr))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{s} ({rc}):\n{log}" for s, rc, log in failed))
    lib_path.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, lib_path)
    return lib_path, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int  # pointers and the stream as void*, sizes as int
        lib.amb_cholesky.argtypes = [P, P, I, I, P]
        lib.amb_cho_solve.argtypes = [P, P, P, I, I, P]
        lib.amb_solve_pd.argtypes = [P, P, P, I, I, P]
        lib.amb_cholesky_block.argtypes = [P, P, I, I, P]
        lib.amb_cho_solve_block.argtypes = [P, P, P, I, I, P]
        lib.amb_cho_solve_rhs.argtypes = [P, P, P, I, I, I, P]
        lib.amb_cho_solve_block_rhs.argtypes = [P, P, P, I, I, I, P]
        lib.amb_solve_pd_block.argtypes = [P, P, P, I, I, P]
        lib.amb_newton_structured.argtypes = [P] * 16 + [I] * 12 + [P]
        lib.amb_newton_dense.argtypes = [P] * 12 + [I] * 8 + [P]
        lib.amb_newton_elliptic.argtypes = [P] * 14 + [I] * 11 + [P]
        lib.amb_elliptic_ls_step.argtypes = [P, P, I, P]
        lib.amb_linalg_block_occupancy.argtypes = [I, I, P]
        lib.amb_newton_occupancy.argtypes = [I] * 5 + [P]
        lib.amb_newton_dense_occupancy.argtypes = [I] * 2 + [P]
        lib.amb_newton_elliptic_occupancy.argtypes = [I] * 4 + [P]
        for fn in (lib.amb_cholesky, lib.amb_cho_solve, lib.amb_solve_pd, lib.amb_cholesky_block,
                   lib.amb_cho_solve_block, lib.amb_solve_pd_block, lib.amb_cho_solve_rhs,
                   lib.amb_cho_solve_block_rhs, lib.amb_newton_structured,
                   lib.amb_newton_dense, lib.amb_newton_elliptic, lib.amb_elliptic_ls_step,
                   lib.amb_linalg_block_occupancy, lib.amb_newton_occupancy, lib.amb_newton_dense_occupancy,
                   lib.amb_newton_elliptic_occupancy):
            fn.restype = I
        for fn, nargs in ((lib.amb_newton_smem_bytes, 5), (lib.amb_newton_dense_smem_bytes, 2),
                          (lib.amb_newton_elliptic_smem_bytes, 4)):
            fn.argtypes = [I] * nargs
            fn.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def check_launch(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of the {kernel} kernel failed: cudaError {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
