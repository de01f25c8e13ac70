#!/usr/bin/env python3
"""Where kernel 6 and its plain version part, on a card: one env's line
search step by step, and how often envs part converged.

    python3 tools/elliptic_trace.py [--seed 63 --nh 0 --cdim 3 --env 26] [--against OTHER/csrc ...]

On chip_smoke.synthetic_elliptic_problem(257, nv=12, nh, S=6, cdim, seed)
converged (15 x 15, the warmstart on; the problem and settings of
tests/test_torch_cuda.py::test_elliptic_newton_kernel_matches_plain,
whose seed is 60 + nh + cdim):

  * trace: each Newton iteration's line-search steps (t, lo, hi, phi'(t),
    phi''(t)) of env ENV, from the tree's kernel built with
    -DAMB_ELLIPTIC_TRACE=ENV (printf) and from the plain version in float32
    and float64 (engine.solver.ls_bracket_step wrapped), then each one's
    cost after every iteration (runs of 1 .. 15 iterations);
  * rate: on seeds 200-215 x (nh, cdim) in {0, 9} x {3, 6} (16,448 envs),
    the envs where the tree's kernel, each OTHER build (a parent's
    ambersim_tpu_torch/csrc unpacked with git archive) and the plain
    version in float64 differ from plain float32 by more than 5% and 1e-2
    of their largest component (the card test's bars).

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

CONVERGED = dict(iterations=15, ls_iterations=15, use_ws=True)


def env_rel(got, want):
    """Per-env max |got - want| / (max |want| + 1) over the three outputs."""
    import torch

    rel = torch.zeros(got[0].shape[0], dtype=torch.float64, device=got[0].device)
    for g, w in zip(got, want):
        rel = torch.maximum(rel, (g.double() - w.double()).abs().amax(1) / (w.double().abs().amax(1) + 1.0))
    return rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=63)
    ap.add_argument("--nh", type=int, default=0)
    ap.add_argument("--cdim", type=int, default=3)
    ap.add_argument("--env", type=int, default=26)
    ap.add_argument("--against", type=Path, nargs="+", default=[], help="other csrc/ directories for the rate")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    import newton_probe as npb
    from ambersim_tpu_torch.engine import solver
    from ambersim_tpu_torch.engine.forward import full_f32_matmul

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    print(f"card: {cs.card_line()}", flush=True)
    tree = REPO / "ambersim_tpu_torch/csrc"
    builds = {"tree": (tree,), "trace": (tree, f"-DAMB_ELLIPTIC_TRACE={args.env}")}
    builds.update({f"other{k + 1}": (c,) for k, c in enumerate(args.against)})
    libs = npb.build(builds)
    traced = libs.pop("trace")
    dev = torch.device("cuda", 0)
    libc = ctypes.CDLL(None)

    def problem(seed, nh, cdim):
        return cs.synthetic_elliptic_problem(257, nv=12, nh=nh, S=6, cdim=cdim, seed=seed, device=dev)

    with full_f32_matmul():
        sp = problem(args.seed, args.nh, args.cdim)
        print(f"== env {args.env} of seed {args.seed}, nh {args.nh}, cdim {args.cdim}, converged", flush=True)
        npb.launch_elliptic(traced, sp, CONVERGED)
        torch.cuda.synchronize()
        libc.fflush(None)  # the kernel's printf lines before what follows

        step = solver.ls_bracket_step
        state = {}

        def traced_step(t, lo, hi, g, h):
            e = args.env
            it, ls = divmod(state["n"], CONVERGED["ls_iterations"])
            print(f"{state['name']} it {it} ls {ls}: t {t[e].item():.9g} lo {lo[e].item():.9g} "
                  f"hi {hi[e].item():.9g} phi' {g[e].item():.9g} phi'' {h[e].item():.9g}")
            state["n"] += 1
            return step(t, lo, hi, g, h)

        solver.ls_bracket_step = traced_step
        try:
            for name, dtype in (("plain float32", torch.float32), ("plain float64", torch.float64)):
                state.update(name=name, n=0)
                solver._newton_arrays_elliptic(**cs.as_dtype(sp, dtype), **CONVERGED)
        finally:
            solver.ls_bracket_step = step
        one = cs.first_envs({k: v[args.env:] if torch.is_tensor(v) and v.dim() and v.shape[0] == 257 else v
                             for k, v in sp.items()}, 1)

        def cost(q):
            p = cs.as_dtype(one, torch.float64)
            mu, scale = solver.cone_params(p["fr"], p["impratio"], p["cdim"])
            jar = (p["J"] * q.double()[:, None, :]).sum(-1) - p["aref"]
            return solver.elliptic_total_cost(q.double(), jar, p["qM"], p["a_s"], p["D"], p["fl"], p["act"], mu,
                                              scale, ne=p["ne"], nf=p["nf"], nh=p["base"], S=p["ncon"],
                                              cdim=p["cdim"]).item()

        for it in range(1, CONVERGED["iterations"] + 1):
            kw = dict(CONVERGED, iterations=it)
            runs = {"kernel": npb.launch_elliptic(libs["tree"], one, kw)[0],
                    "plain float32": solver._newton_arrays_elliptic(**one, **kw)[0],
                    "plain float64": solver._newton_arrays_elliptic(**cs.as_dtype(one, torch.float64), **kw)[0]}
            print(f"cost after {it} iterations: " + ", ".join(f"{k} {cost(q):.9g}" for k, q in runs.items()))

        print("== envs past 5% / 1e-2 of plain float32, converged: seeds 200-215 x (nh, cdim) in {0, 9} x {3, 6}")
        counts = {k: [0, 0] for k in [*libs, "plain float64"]}
        n = 0
        for seed in range(200, 216):
            for nh, cdim in ((0, 3), (9, 3), (0, 6), (9, 6)):
                sp = problem(seed + nh + cdim, nh, cdim)
                want = solver._newton_arrays_elliptic(**sp, **CONVERGED)
                runs = {k: npb.launch_elliptic(lib, sp, CONVERGED) for k, lib in libs.items()}
                runs["plain float64"] = solver._newton_arrays_elliptic(**cs.as_dtype(sp, torch.float64), **CONVERGED)
                for k, got in runs.items():
                    rel = env_rel(got, want)
                    counts[k][0] += int((rel > 0.05).sum())
                    counts[k][1] += int((rel > 1e-2).sum())
                n += 257
        for k, (a, b) in counts.items():
            print(f"{k}: {a} of {n} envs past 5% of plain float32, {b} past 1e-2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
