#!/usr/bin/env python3
"""Split one system's clock cycles in a kernel of csrc/linalg*.cu by phase,
on a card, for the tree and for other versions of the kernel.

    python3 tools/linalg_clocks.py [--kernel solve_pd cho_solve_block]
                                   [--against OTHER/csrc [OTHER2/csrc ...]]

solve_pd: the fused SPD solve at n <= 32 (kernel 3, solve_pd_kernel in
linalg.cu) at n = 18 on B = 1 and 4096 systems: system 0's cycles by
phase and the factor's cycles a pivot. cho_solve_block: the block Cholesky
solve (kernel 2, cho_solve_block_kernel in linalg_block.cu) at n = 192 on
B = 1 and 256 systems: issuing the first tile columns' copies, waiting for
columns 0 and 1, the first diagonal panel, each later panel of the forward
substitution (warp 0's work, then the wait and barrier), and the backward
substitution.

For each kernel and each csrc/ (the tree's, then each OTHER, e.g. a parent
commit's ambersim_tpu_torch/csrc unpacked with git archive into a
git-ignored directory), writes a copy of the kernel's source with clock64()
marks taken by thread 0 of block 0 into a __device__ array (read back with
cudaMemcpyFromSymbol), builds the copies at once with the port's nvcc flags
into ambersim_tpu_torch/_build/probe/, and runs each (the third of three
launches, checked against the plain version). The marks go before or after
fixed lines of the source (MARKS); the script stops if a line is not
found.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# kernel -> (source file, the text that starts the kernel, n)
KERNELS = {
    "solve_pd": ("linalg.cu", "solve_pd_kernel(const float* __restrict__ A", 18),
    "cho_solve_block": ("linalg_block.cu", "cho_solve_block_kernel(const float* __restrict__ Lg", 192),
}
# kernel -> (phase names, marks); a mark is (text, index, before): MARK(index)
# goes after the text's last line, or before its first line, the text's
# first place from the kernel's start. solve_pd's phase k runs from mark k
# to mark k + 1;
# cho_solve_block's marks are read by report_block.
MARKS = {
    "solve_pd": (("copy + rows", "factor + forward", "backward"), (
        ("  if (sys >= B) return;", "0", False),
        ("  amb::load_rows", "1", False),
        ("  amb::warp_factor<true>(r, n, a, ld, y);", "2", False),
        ("  const float xi = amb::warp_back_solve(a, y, n, ld);", "3", False),
    )),
    "cho_solve_block": ((), (
        ("    cp_async_commit_wait_one();  // column p + 2\n", "5 + 2 * p", True),
        ("  const float* src = Lg + (size_t)blockIdx.x * n * n;\n", "0", False),
        ("  load_tile_column(tiles, src, n, nt, 2, threadIdx.x, kThreads);  // nt >= 3 past n = 32\n", "1", False),
        ("  cp_async_commit_wait_one();  // columns 0 and 1\n  __syncthreads();\n", "2", False),
        ("  if (warp == 0) fwd_panel(tiles, ldinv, y, 0);\n", "3", False),
        ("  if (warp == 0) fwd_panel(tiles, ldinv, y, 0);\n  MARK(3)\n  __syncthreads();\n", "4", False),
        ("    cp_async_commit_wait_one();  // column p + 2\n    __syncthreads();\n", "6 + 2 * p", False),
        ("  tiled_back_solve(tiles, ldinv, y, nt);  // L^T x = y\n", "40", False),
    )),
}
CLOCKS = 64


def marked_source(src: str, kernel: str) -> str:
    """The kernel's source with its marks, MARK and the clock array defined,
    and amb_clk to read the array."""
    k = src.index(KERNELS[kernel][1])
    for text, i, before in MARKS[kernel][1]:
        at = src.find(text, k)
        if at < 0:
            raise SystemExit(f"{kernel} mark {i}: line not found: {text!r}")
        if before:  # the text's first line
            pos = src.rindex("\n", 0, at) + 1
            line = src[pos:src.index("\n", at)]
        else:  # the text's last line
            pos = src.index("\n", at + len(text) - 1) + 1
            line = src[src.rindex("\n", 0, pos - 1) + 1:pos]
        mark = f"{line[:len(line) - len(line.lstrip())]}MARK({i})\n"
        src = src[:pos] + mark + src[pos:]
    src = src.replace("namespace {\n", f"__device__ long long g_clk[{CLOCKS}];\n"
                      "#define MARK(i) if (blockIdx.x == 0 && threadIdx.x == 0) g_clk[i] = clock64();\n"
                      "namespace {\n", 1)
    src = src.replace('extern "C" {\n', 'extern "C" {\nint amb_clk(long long* out) {\n'
                      '  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n', 1)
    return src


def report_solve_pd(c: list, phases: tuple, n: int) -> str:
    c = c[:len(phases) + 1]
    split = ", ".join(f"{p} {c[i + 1] - c[i]}" for i, p in enumerate(phases))
    return f"system 0's cycles: {split}; all {c[-1] - c[0]}; {phases[1]} a pivot {(c[2] - c[1]) / n:.1f}"


def report_block(c: list, phases: tuple, n: int) -> str:
    nt = n // 16
    last = 6 + 2 * (nt - 2)
    return (f"block 0's cycles: issue columns 0-2 {c[1] - c[0]}, wait for columns 0-1 {c[2] - c[1]}, panel 0 "
            f"{c[3] - c[2]} + barrier {c[4] - c[3]}\n  forward panels 1-{nt - 1} (warp 0's work, wait + barrier): "
            + " ".join(f"({c[5 + 2 * p] - c[4 + 2 * p]}, {c[6 + 2 * p] - c[5 + 2 * p]})" for p in range(nt - 1))
            + f"\n  forward total {c[last] - c[0]}, backward {c[40] - c[last]}, all {c[40] - c[0]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=tuple(KERNELS), default=list(KERNELS))
    ap.add_argument("--against", type=Path, nargs="+", default=[], help="other csrc/ directories to split beside "
                    "the tree's")
    args = ap.parse_args()

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
    builds = {"tree": REPO / "ambersim_tpu_torch/csrc"}
    builds.update({f"other{k + 1}": csrc for k, csrc in enumerate(args.against)})
    procs = {}
    for kernel in args.kernel:
        for name, csrc in builds.items():
            src = marked_source((csrc / KERNELS[kernel][0]).read_text(), kernel)
            print(f"{kernel} {name}: {csrc}")
            stem = out / f"linalg_clocks_{kernel}_{name}"
            stem.with_suffix(".cu").write_text(src)
            procs[kernel, name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o", str(stem.with_suffix(".so")),
                 str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {kernel} of {builds[name]}:\n{log}")
        lib = ctypes.CDLL(str(out / f"linalg_clocks_{kernel}_{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        getattr(lib, f"amb_{kernel}").argtypes = [P, P, P, I, I, P]
        lib.amb_clk.argtypes = [P]
        libs[kernel, name] = lib
    dev = torch.device("cuda", 0)
    for kernel in args.kernel:
        n = KERNELS[kernel][2]
        for B in ((1, cs.NUM_ENVS) if kernel == "solve_pd" else (1, cs.CLUTTER_ENVS)):
            a, b = cs.random_spd(np.random.default_rng(0), B, n, dev)
            if kernel == "solve_pd":
                first, want, tol, report = a, plain.solve_pd_unrolled(a, b), cs.LINALG_TOL, report_solve_pd
            else:
                first = plain.cholesky_unrolled(a)
                want, tol, report = plain.cho_solve_unrolled(first, b), cs.LARGE_LINALG_TOL, report_block
            for name in builds:
                lib, x = libs[kernel, name], torch.empty_like(b)
                for _ in range(3):
                    check_launch(getattr(lib, f"amb_{kernel}")(first.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
                                                               torch.cuda.current_stream().cuda_stream), kernel)
                torch.cuda.synchronize()
                cs.max_err(x, want, tol, tol, f"{kernel} {name} B={B}")
                clk = (ctypes.c_longlong * CLOCKS)()
                check_launch(lib.amb_clk(clk), "clock read")
                print(f"{kernel} B={B} n={n} {name}: {report(list(clk), MARKS[kernel][0], n)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
