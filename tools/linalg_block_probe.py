#!/usr/bin/env python3
"""Time the block kernels 1-3 (csrc/linalg_block.cu) at n = 192 on a card.

    python3 tools/linalg_block_probe.py [--against OTHER/linalg_block.cu]

Builds the tree's linalg_block.cu (and OTHER, e.g. a parent commit's copy
unpacked with git archive) with the port's nvcc flags into
ambersim_tpu_torch/_build/probe/, checks each against the plain versions at
B = 256, prints whether OTHER's factor and fused solve give the tree's
bits, then prints, CUDA events (chip_smoke.cuda_ms: ten back-to-back
calls, median of 20 runs):

  * tree and OTHER in turns (tree, other, other, tree) at the clutter
    shape B = 256, beside torch.linalg.cholesky and torch.cholesky_solve;
  * each at B = 1, 132, 264, 528, 1056: B = 1 is one system's latency, and
    the step from 264 to 528 shows when the systems no longer fit at once.

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

from ambersim_tpu_torch.engine.forward import full_f32_matmul  # noqa: E402

N = 192
KERNELS = ("cholesky_block", "cho_solve_block", "solve_pd_block")


def build(src: Path, name: str) -> ctypes.CDLL:
    from ambersim_tpu_torch.ops import _build

    out = _build.BUILD / "probe"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{name}.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
    print(name, "\n".join(line.strip() for line in (run.stdout + run.stderr).splitlines()
                          if "registers" in line or "spill" in line or "Compiling entry" in line))
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.amb_cholesky_block.argtypes = [P, P, I, I, P]
    lib.amb_cho_solve_block.argtypes = [P, P, P, I, I, P]
    lib.amb_solve_pd_block.argtypes = [P, P, P, I, I, P]
    return lib


@full_f32_matmul()
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another linalg_block.cu to time beside the tree's")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.ops._build import check_launch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    print(f"card: {cs.card_line()}")
    libs = {"tree": build(REPO / "ambersim_tpu_torch/csrc/linalg_block.cu", "tree")}
    if args.against:
        libs["other"] = build(args.against, "other")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def run(lib, name, a, b, l):
        """Kernel `name` of `lib` on the factor's input a, the solve's L l and b."""
        B = a.shape[0]
        if name == "cholesky_block":
            out = torch.empty_like(a)
            err = lib.amb_cholesky_block(a.data_ptr(), out.data_ptr(), B, N, stream())
        else:
            out = torch.empty_like(b)
            m = l if name == "cho_solve_block" else a
            err = getattr(lib, f"amb_{name}")(m.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, stream())
        check_launch(err, name)
        return out

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    a, b = cs.random_spd(rng, cs.CLUTTER_ENVS, N, dev)
    l = plain.cholesky_unrolled(a)
    want = {"cholesky_block": l, "cho_solve_block": plain.cho_solve_unrolled(l, b),
            "solve_pd_block": plain.solve_pd_unrolled(a, b)}
    outs = {name: {k: run(lib, k, a, b, l) for k in KERNELS} for name, lib in libs.items()}
    for name in libs:
        for k in KERNELS:
            err = cs.max_err(outs[name][k], want[k], cs.LARGE_LINALG_TOL, cs.LARGE_LINALG_TOL, f"{name} {k}")
            print(f"{name} {k}: max |kernel - plain| {err:.3e}")
    if args.against:
        print("other vs tree, B=256: " + ", ".join(
            f"{k} {'bit-identical' if torch.equal(outs['other'][k], outs['tree'][k]) else 'DIFFERS'}"
            for k in KERNELS))
    order = ("tree", "other", "other", "tree") if args.against else ("tree", "tree")
    for name in order:
        print(f"B={cs.CLUTTER_ENVS} n={N} {name}: " + ", ".join(
            f"{k} {cs.cuda_ms(lambda: run(libs[name], k, a, b, l), 20):.4f} ms" for k in KERNELS), flush=True)
    print(f"B={cs.CLUTTER_ENVS} n={N} torch.linalg.cholesky {cs.cuda_ms(lambda: torch.linalg.cholesky(a), 20):.4f} "
          f"ms, torch.cholesky_solve {cs.cuda_ms(lambda: torch.cholesky_solve(b[..., None], l), 20):.4f} ms")
    for B in (1, 132, 264, 528, 1056):
        a, b = cs.random_spd(rng, B, N, dev)
        l = plain.cholesky_unrolled(a)
        print(f"B={B} n={N} " + "; ".join(f"{name}: " + ", ".join(
            f"{k} {cs.cuda_ms(lambda: run(lib, k, a, b, l), 20):.4f} ms" for k in KERNELS)
            for name, lib in libs.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
