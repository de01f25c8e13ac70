#!/usr/bin/env python3
"""Split one system's clock cycles in the block Cholesky solve (kernel 2,
cho_solve_block in csrc/linalg_block.cu) by phase, on a card.

    python3 tools/linalg_block_clocks.py

Writes a copy of linalg_block.cu with clock64() marks taken by thread 0 of
block 0 into a __device__ array (read back with cudaMemcpyFromSymbol),
builds it with the port's nvcc flags into ambersim_tpu_torch/_build/probe/,
runs it at n = 192 on B = 1 and B = 256 systems (the third of three
launches) and prints, in cycles: issuing the first tile columns' copies,
waiting for columns 0 and 1, the first diagonal panel, each later panel
of the forward substitution (warp 0's work, then the wait and barrier),
and the backward substitution. The marks sit at fixed lines of the
kernel; the script stops if one is not found.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N = 192
# (line of cho_solve_block_kernel, mark index expression) : the mark goes right after the line
AFTER = (
    ("  const float* src = Lg + (size_t)blockIdx.x * n * n;\n", "0"),
    ("  load_tile_column(tiles, src, n, nt, 2, threadIdx.x, kThreads);  // nt >= 3 past n = 32\n", "1"),
    ("  cp_async_commit_wait_one();  // columns 0 and 1\n  __syncthreads();\n", "2"),
    ("  if (warp == 0) fwd_panel(tiles, ldinv, y, 0);\n", "3"),
    ("  if (warp == 0) fwd_panel(tiles, ldinv, y, 0);\n  MARK(3)\n  __syncthreads();\n", "4"),
    ("    cp_async_commit_wait_one();  // column p + 2\n    __syncthreads();\n", "6 + 2 * p"),
    ("  tiled_back_solve(tiles, ldinv, y, nt);  // L^T x = y\n", "40"),
)
BEFORE = (("    cp_async_commit_wait_one();  // column p + 2\n", "5 + 2 * p"),)


def marked_source() -> str:
    src = (REPO / "ambersim_tpu_torch/csrc/linalg_block.cu").read_text()
    src = src.replace("namespace {\n", "__device__ long long g_clk[64];\n"
                      "#define MARK(i) if (blockIdx.x == 0 && threadIdx.x == 0) g_clk[i] = clock64();\n"
                      "namespace {\n", 1)
    src = src.replace('extern "C" {\n', 'extern "C" {\nint amb_clk(long long* out) {\n'
                      '  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n', 1)
    k = src.index("cho_solve_block_kernel(const float* __restrict__ Lg")
    head, body = src[:k], src[k:]
    for line, i in BEFORE:
        if line not in body:
            raise SystemExit(f"mark {i}: line not found in cho_solve_block_kernel: {line!r}")
        indent = line[:len(line) - len(line.lstrip())]
        body = body.replace(line, f"{indent}MARK({i})\n{line}", 1)
    for line, i in AFTER:
        if line not in body:
            raise SystemExit(f"mark {i}: line not found in cho_solve_block_kernel: {line!r}")
        last = line.rstrip("\n").split("\n")[-1]
        indent = last[:len(last) - len(last.lstrip())]
        body = body.replace(line, f"{line}{indent}MARK({i})\n", 1)
    return head + body


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.ops import _build
    from ambersim_tpu_torch.ops._build import check_launch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    print(f"card: {cs.card_line()}")
    out = _build.BUILD / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "linalg_block_clocks.cu").write_text(marked_source())
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out / "linalg_block_clocks.so"),
                          str(out / "linalg_block_clocks.cu")], capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(out / "linalg_block_clocks.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.amb_cho_solve_block.argtypes = [P, P, P, I, I, P]
    lib.amb_clk.argtypes = [P]
    dev = torch.device("cuda", 0)
    for B in (1, cs.CLUTTER_ENVS):
        a, b = cs.random_spd(np.random.default_rng(0), B, N, dev)
        l = plain.cholesky_unrolled(a)
        x = torch.empty_like(b)
        for _ in range(3):
            check_launch(lib.amb_cho_solve_block(l.data_ptr(), b.data_ptr(), x.data_ptr(), B, N,
                                                 torch.cuda.current_stream().cuda_stream), "cho_solve_block")
        torch.cuda.synchronize()
        cs.max_err(x, plain.cho_solve_unrolled(l, b), cs.LARGE_LINALG_TOL, cs.LARGE_LINALG_TOL, f"B={B}")
        clk = (ctypes.c_longlong * 64)()
        check_launch(lib.amb_clk(clk), "clock read")
        c, nt = list(clk), N // 16
        last = 6 + 2 * (nt - 2)
        print(f"B={B} n={N}, block 0's cycles: issue columns 0-2 {c[1] - c[0]}, wait for columns 0-1 {c[2] - c[1]}, "
              f"panel 0 {c[3] - c[2]} + barrier {c[4] - c[3]}")
        print("  forward panels 1-11 (warp 0's work, wait + barrier): " + " ".join(
            f"({c[5 + 2 * p] - c[4 + 2 * p]}, {c[6 + 2 * p] - c[5 + 2 * p]})" for p in range(nt - 1)))
        print(f"  forward total {c[last] - c[0]}, backward {c[40] - c[last]}, all {c[40] - c[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
