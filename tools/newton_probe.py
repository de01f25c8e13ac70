#!/usr/bin/env python3
"""Time the warp-factor kernels of the tree against another version, on a
card: the Newton kernels 4-6 (csrc/newton_structured.cu, newton_dense.cu,
newton_elliptic.cu: one warp per env, csrc/newton_warp.cuh) and kernels 1-3
at n <= 32 (csrc/linalg.cu), which share their factor (csrc/linalg.cuh).

    python3 tools/newton_probe.py [--against OTHER/csrc [OTHER2/csrc ...]]

Builds those four sources of the tree (and of each OTHER, e.g. a parent
commit's ambersim_tpu_torch/csrc unpacked with git archive) with the
port's nvcc flags into ambersim_tpu_torch/_build/probe/, prints ptxas's
registers and spills, checks each build against the plain versions and
prints whether each other build gives the tree's bits (kernels 1 and 3-6;
kernel 2 too, where its code is the same), then prints, CUDA events
(chip_smoke.cuda_ms: ten back-to-back calls, median of 20 runs), the
others and the tree in turns (other, tree, tree, other; with
several others, other1 .. otherN, tree, tree, otherN .. other1):

  * kernel 4 on the quadruped's pre-solve operands at B = 4096 and the
    humanoid's at B = 1024 (chip_smoke.py's), and on one env of each
    (B = 1: one env's latency);
  * kernels 1, 2 and 3 at B = 4096, n = 18 (the main path's shapes) and
    kernel 1 at B = 1, and at the other shapes the paths launch them at:
    the humanoid's B = 1024, n = 25, the pendulum's B = 512, n = 1 and
    cartpole's and arm3's B = 1024, n = 2 and 3 (the launch floor);
  * kernel 5 on the operands of arm3 and cartpole after 100 steps and of
    the humanoid (the JAX package's route for it), each at B = 1024, and
    kernel 6 on the elliptic quadruped's at B = 4096
    (chip_smoke.check_newton_dense / check_newton_elliptic);
  * the split of env 0's clock cycles over each Newton kernel's phases
    (AMB_MARK), from a copy of the tree built with -DAMB_NEWTON_CLOCKS: kernel
    4 on the quadruped, kernel 5 on arm3 and kernel 6 on the elliptic
    quadruped, each at B = 1 and at its path's batch.

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

SOURCES = ("linalg.cu", "newton_structured.cu", "newton_dense.cu", "newton_elliptic.cu")
# each Newton kernel's AMB_MARK slots, in order
PHASES = {
    "newton_structured": ("load", "start", "forces at jar", "gradient + Hessian", "factor", "solve", "J p, p M p",
                          "line search", "trial cost + take", "outputs"),
    "newton_dense": ("load", "start", "M dacc, M row", "J^T f + Hessian", "factor", "solve", "J p, p M p",
                     "line search", "trial cost + take", "outputs"),
    "newton_elliptic": ("load", "start", "head rows: J^T f + Hessian", "cones: zones, W, J^T f + Hessian", "factor",
                        "solve", "J p, p M p, cone scalars", "line search", "trial cost + take", "outputs"),
}


def build(builds: dict) -> dict:
    """Compile every (csrc, *flags) of `builds` (name -> that) at once, one
    nvcc each; returns name -> the loaded library."""
    from ambersim_tpu_torch.ops import _build

    out = _build.BUILD / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(csrc), "-shared", "-o",
                                     str(out / f"{name}.so"), *(str(csrc / s) for s in SOURCES)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (csrc, *flags) in builds.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {builds[name][0]}:\n{log}")
        report = [line.strip() for line in log.splitlines()
                  if "registers" in line or "spill" in line or "Compiling entry" in line]
        print(f"{name}:", *report, sep="\n  ")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.amb_cholesky.argtypes = [P, P, I, I, P]
        lib.amb_cho_solve.argtypes = [P, P, P, I, I, P]
        lib.amb_solve_pd.argtypes = [P, P, P, I, I, P]
        lib.amb_newton_structured.argtypes = [P] * 16 + [I] * 12 + [P]
        lib.amb_newton_dense.argtypes = [P] * 12 + [I] * 8 + [P]
        # kernel 6 took its rows through a permutation before it kept them in
        # MuJoCo order; an older csrc/ has no occupancy entry for it
        lib.rows_permuted = not hasattr(lib, "amb_newton_elliptic_occupancy")
        lib.amb_newton_elliptic.argtypes = [P] * (15 if lib.rows_permuted else 14) + [I] * 11 + [P]
        if "-DAMB_NEWTON_CLOCKS" in builds[name][1:]:
            for fn in (lib.amb_newton_phase_clocks, lib.amb_newton_dense_phase_clocks,
                       lib.amb_newton_elliptic_phase_clocks):
                fn.argtypes = [P]
        libs[name] = lib
    return libs


def launch_elliptic(lib, pa: dict, kw: dict):
    """ops.newton.newton_solve_elliptic's launch on `lib` (a build()
    library) for a problem on the card; returns (qacc, efc_force, qfrc)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine.schedule import device_index
    from ambersim_tpu_torch.engine.solver import cone_params
    from ambersim_tpu_torch.ops._build import check_launch

    B, nefc, nv = pa["J"].shape
    S, cdim, nh = pa["ncon"], pa["cdim"], pa["base"]
    mu, scale = cone_params(pa["fr"].float(), pa["impratio"], cdim)
    scale = scale.transpose(1, 2).reshape(B, (cdim - 1) * S).contiguous()
    perm = []
    if lib.rows_permuted:  # [head | N(S) | T_1(S) ... T_{cdim-1}(S)] as MuJoCo rows
        order = np.concatenate([np.arange(nh)] + [nh + np.arange(S) * cdim + k for k in range(cdim)])
        perm = [device_index(order, pa["J"].device, torch.int32)]
    out = torch.empty_like(pa["a_s"]), torch.empty_like(pa["aref"]), torch.empty_like(pa["a_s"])
    ptrs = [x.data_ptr() for x in (pa["J"], pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"], pa["ws"],
                                  pa["tol"], mu.contiguous(), scale, *perm, *out)]
    ints = [B, nv, nefc, pa["ne"], pa["nf"], nh, S, cdim, kw["iterations"], kw["ls_iterations"], int(kw["use_ws"])]
    check_launch(lib.amb_newton_elliptic(*ptrs, *ints, torch.cuda.current_stream(pa["J"].device).cuda_stream),
                 "newton_elliptic")
    return out


@full_f32_matmul()
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=[], help="other csrc/ directories to time beside the "
                    "tree's")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.schedule import device_index
    from ambersim_tpu_torch.engine.solver import _newton_arrays, _newton_arrays_elliptic, elliptic_tail
    from ambersim_tpu_torch.ops._build import check_launch
    
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    print(f"card: {cs.card_line()}")
    tree = REPO / "ambersim_tpu_torch/csrc"
    others = ["other"] if len(args.against) == 1 else [f"other{k + 1}" for k in range(len(args.against))]
    builds = {"tree": (tree,), "clocks": (tree, "-DAMB_NEWTON_CLOCKS")}
    for name, csrc in zip(others, args.against):
        builds[name] = (csrc,)
        print(f"{name}: {csrc}")
    libs = build(builds)
    clocked = libs.pop("clocks")
    order = (*others, "tree", "tree", *reversed(others))
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def chol(lib, a):
        out = torch.empty_like(a)
        check_launch(lib.amb_cholesky(a.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1], stream()), "cholesky")
        return out

    def cho_solve(lib, l, b):
        out = torch.empty_like(b)
        check_launch(lib.amb_cho_solve(l.data_ptr(), b.data_ptr(), out.data_ptr(), l.shape[0], l.shape[1], stream()),
                     "cho_solve")
        return out

    def solve_pd(lib, a, b):
        out = torch.empty_like(b)
        check_launch(lib.amb_solve_pd(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1], stream()),
                     "solve_pd")
        return out

    def identical(what, outs):
        """Print whether each other build's outputs (name -> tensor or
        tuple) are the tree's bit for bit."""
        def flat(x):
            return x if isinstance(x, tuple) else (x,)

        for lname in others:
            same = all(torch.equal(g, t) for g, t in zip(flat(outs[lname]), flat(outs["tree"])))
            print(f"{what}: {lname} {'bit-identical to the tree' if same else 'DIFFERS from the tree'}", flush=True)

    def outputs(pa):
        return torch.empty_like(pa["a_s"]), torch.empty_like(pa["aref"]), torch.empty_like(pa["a_s"])

    def dense(lib, pa, kw):
        B, nefc, nv = pa["J"].shape
        out = outputs(pa)
        ptrs = [x.data_ptr() for x in (pa["J"], pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"],
                                      pa["ws"], pa["tol"], *out)]
        ints = [B, nv, nefc, pa["ne"], pa["nf"], kw["iterations"], kw["ls_iterations"], int(kw["use_ws"])]
        check_launch(lib.amb_newton_dense(*ptrs, *ints, stream()), "newton_dense")
        return out

    def structured(lib, case):
        pa, bJ, dsc, st, kw = case
        B, nefc, nv = pa["J"].shape
        qacc, force, qfrc = (torch.empty_like(pa["a_s"]), torch.empty_like(pa["aref"]),
                             torch.empty_like(pa["a_s"]))
        perm, ddof = (device_index(x, dev, torch.int32) for x in (st.perm, st.diag_dofs))
        ptrs = [x.data_ptr() for x in (pa["J"], bJ, dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"],
                                      pa["a_s"], pa["ws"], pa["tol"], perm, ddof, qacc, force, qfrc)]
        ints = [B, nv, nefc, st.nd, st.ndiag, st.ncon3, st.nd_eq, st.nd_ft, st.nfd, kw["iterations"],
                kw["ls_iterations"], int(kw["use_ws"])]
        check_launch(lib.amb_newton_structured(*ptrs, *ints, stream()), "newton_structured")
        return qacc, force, qfrc

    def case(name, B):
        m = load_model(name, device=dev)
        p = cs.PATHS[name]
        d = p["start"](m, B, dev)
        d = cs.pre_solve(m, d.replace(ctrl=p["ctrl"](d)) if p["ctrl"] else d)
        pa = cs.solver_operands(m, d, seed=2)
        kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
        return pa, d.efc_bJ, d.efc_dsc, _pyramid_structure(m.skel), kw

    def first(c, b):
        """The case's first b envs."""
        pa, bJ, dsc, st, kw = c
        B = bJ.shape[0]
        return ({k: v[:b].contiguous() if v.shape[0] == B else v for k, v in pa.items()},
                bJ[:b].contiguous(), dsc[:b].contiguous(), st, kw)

    for name, B in (("quadruped", cs.NUM_ENVS), ("humanoid", 1024)):
        c = case(name, B)
        pa, _, _, st, kw = c
        want = _newton_arrays(**pa, ne=st.nd_eq, nf=st.nfd + st.nd_ft, **kw)
        for lname, lib in libs.items():
            cs.newton_err(structured(lib, c), want, f"{lname} newton_structured {name} B={B}")
        identical(f"newton_structured {name} B={B}", {lname: structured(lib, c) for lname, lib in libs.items()})
        one = first(c, 1)
        for lname in order:
            ms = cs.cuda_ms(lambda: structured(libs[lname], c), 20)
            print(f"newton_structured {name} B={B} {lname}: {ms:.4f} ms;"
                  f" B=1 {cs.cuda_ms(lambda: structured(libs[lname], one), 20):.4f} ms", flush=True)
    rng = np.random.default_rng(0)
    tol = (cs.LINALG_TOL, cs.LINALG_TOL)
    for B, n in ((cs.NUM_ENVS, 18), (1024, 25), (512, 1), (1024, 2), (1024, 3)):
        a, b = cs.random_spd(rng, B, n, dev)
        l = plain.cholesky_unrolled(a)
        for lname, lib in libs.items():
            cs.max_err(chol(lib, a), l, *tol, f"{lname} cholesky n={n}")
            cs.max_err(cho_solve(lib, l, b), plain.cho_solve_unrolled(l, b), *tol, f"{lname} cho_solve n={n}")
            cs.max_err(solve_pd(lib, a, b), plain.solve_pd_unrolled(a, b), *tol, f"{lname} solve_pd n={n}")
        for what, fn in (("cholesky", lambda lib: chol(lib, a)), ("cho_solve", lambda lib: cho_solve(lib, l, b)),
                         ("solve_pd", lambda lib: solve_pd(lib, a, b))):
            identical(f"{what} B={B} n={n}", {lname: fn(lib) for lname, lib in libs.items()})
        a1 = a[:1].contiguous()
        for lname in order:
            lib = libs[lname]
            print(f"B={B} n={n} {lname}: cholesky {cs.cuda_ms(lambda: chol(lib, a), 20):.4f} ms "
                  f"(B=1 {cs.cuda_ms(lambda: chol(lib, a1), 20):.4f}), cho_solve "
                  f"{cs.cuda_ms(lambda: cho_solve(lib, l, b), 20):.4f} ms, solve_pd "
                  f"{cs.cuda_ms(lambda: solve_pd(lib, a, b), 20):.4f} ms", flush=True)

    # kernel 5 (chip_smoke.check_newton_dense's operands) and kernel 6
    # (check_newton_elliptic's), each build against the plain version
    k56, clock_cases = [], []
    for name, steps in (("arm3", 100), ("cartpole", 100), ("humanoid", 0)):
        m = load_model(name, device=dev)
        d = cs.pre_solve(m, rollout(m, cs.PATHS[name]["start"](m, 1024, dev), steps))
        pa = dict(cs.solver_operands(m, d, seed=4), ne=int(m.skel.ne), nf=int(m.skel.nf))
        kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
        for lname, lib in libs.items():
            cs.newton_err(dense(lib, pa, kw), _newton_arrays(**pa, **kw), f"{lname} newton_dense {name} B=1024")
        identical(f"newton_dense {name} B=1024", {lname: dense(lib, pa, kw) for lname, lib in libs.items()})
        k56.append((f"newton_dense {name} B=1024", dense, pa, kw))
        if name == "arm3":
            clock_cases.append(("newton_dense", "arm3", dense, clocked.amb_newton_dense_phase_clocks, pa, kw))
    m = load_model("quadruped_elliptic", device=dev)
    cdim, slots, base, _ = elliptic_tail(m.skel)
    d = cs.initial_batch(m, cs.NUM_ENVS, dev)
    d = cs.pre_solve(m, d.replace(ctrl=cs.pd_ctrl(d)))
    pa = dict(cs.solver_operands(m, d, seed=6), fr=d.contact.friction, impratio=m.opt.impratio, ne=int(m.skel.ne),
              nf=int(m.skel.nf), base=base, ncon=len(slots), cdim=cdim)
    kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
    want = _newton_arrays_elliptic(**pa, **kw)
    for lname, lib in libs.items():  # chaotic in float32 at these settings: printed, not held
        rel, _ = cs.env_rel_err(launch_elliptic(lib, pa, kw), want, f"{lname} newton_elliptic")
        print(f"{lname} newton_elliptic quadruped B={cs.NUM_ENVS}: env-relative |kernel - plain| median "
              f"{rel.median().item():.3e}, max {rel.max().item():.3e}")
    identical(f"newton_elliptic quadruped B={cs.NUM_ENVS}",
              {lname: launch_elliptic(lib, pa, kw) for lname, lib in libs.items()})
    k56.append((f"newton_elliptic quadruped B={cs.NUM_ENVS}", launch_elliptic, pa, kw))
    clock_cases.append(("newton_elliptic", "elliptic quadruped", launch_elliptic,
                        clocked.amb_newton_elliptic_phase_clocks, pa, kw))
    for what, fn, pa, kw in k56:
        for lname in order:
            print(f"{what} {lname}: {cs.cuda_ms(lambda: fn(libs[lname], pa, kw), 20):.4f} ms", flush=True)

    def split(kernel, model, run, read, batch):
        """Env 0's clock cycles by phase of one launch of the clocked build."""
        clocks = (ctypes.c_longlong * len(PHASES[kernel]))()
        run()  # warm-up
        check_launch(read(clocks), "phase clocks")  # zero them
        run()
        torch.cuda.synchronize()
        check_launch(read(clocks), "phase clocks")
        total = sum(clocks)
        print(f"{kernel} {model} B={batch}, env 0's clock cycles by phase (total {total}): " + ", ".join(
            f"{p} {v} ({100 * v / total:.1f}%)" for p, v in zip(PHASES[kernel], clocks)), flush=True)

    c = case("quadruped", cs.NUM_ENVS)
    for cc in (first(c, 1), c):
        split("newton_structured", "quadruped", lambda cc=cc: structured(clocked, cc),
              clocked.amb_newton_phase_clocks, cc[1].shape[0])
    for kernel, model, fn, read, pa, kw in clock_cases:
        B = pa["J"].shape[0]
        for b in (1, B):
            part = {k: v[:b].contiguous() if torch.is_tensor(v) and v.dim() and v.shape[0] == B else v
                    for k, v in pa.items()}
            split(kernel, model, lambda part=part: fn(clocked, part, kw), read, b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
