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
SOURCES = ("linalg.cu", "newton_structured.cu")
HEADERS = ("linalg.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"cholesky": 0, "cho_solve": 0, "solve_pd": 0, "newton_structured": 0}

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
    """Compile the kernels if this source version is not built yet.
    Returns (library path, seconds spent compiling; 0.0 when cached). The
    compiler's register/shared-memory report goes to a .log beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    lib_path = BUILD / f"libambersim_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path, 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
        lib.amb_newton_structured.argtypes = [P] * 16 + [I] * 12 + [P]
        for fn in (lib.amb_cholesky, lib.amb_cho_solve, lib.amb_solve_pd, lib.amb_newton_structured):
            fn.restype = I
        lib.amb_newton_smem_bytes.argtypes = [I] * 5
        lib.amb_newton_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def check_launch(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of the {kernel} kernel failed: cudaError {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
