#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card (it
refuses to run without one). It builds the port's CUDA kernels from
ambersim_tpu_torch/csrc/, holds each against its plain PyTorch version on
the card, steps the 4096-env quadruped PD rollout (the workload of
bench.py:62-127) through the port's entry points, checks that every step
went through the kernels, and compares 8 envs of the rollout on the card
with the same rollout on the CPU (plain versions). It imports nothing of
JAX. Output: progress lines, a JSON line of per-kernel results, the card's
name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero without that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

NUM_ENVS = 4096
NUM_STEPS = 100
KP, KD = 60.0, 2.0
LINALG_TOL = 1e-5  # tests/test_linalg_pallas.py:31
# Kernel 4 against its plain version: the bar of tests/test_newton_pallas.py
# (rtol/atol 1e-4 elementwise) must hold on at least 99% of the envs, and
# every env must agree within 5% of its largest |component|. The tail is
# float32 rounding, not the kernel: the 3-iteration solve's take/keep and
# row-activity decisions flip on it, so on 4096 quadruped envs the plain
# version in float32 misses its own float64 run in as many envs as the
# kernel misses the plain version (check_newton prints both), while a
# layout or row-family fault breaks nearly every env.
NEWTON_TOL = 1e-4
NEWTON_MIN_SHARE = 0.99
NEWTON_ENV_RTOL = 0.05
# card (kernels) vs CPU (plain versions) after 20 steps: f32 reduction order
# plus discrete take/keep decisions inside the Newton solve
QPOS_TOL, QVEL_TOL = 1e-3, 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of `fn` on the card over `reps` runs (CUDA events)."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want|; fails unless every element is within atol + rtol * |want|."""
    import torch

    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{what}: max |kernel - plain| = {err.max().item():.3e} over rtol/atol {rtol}/{atol}")
    return float(err.max().item())


def newton_err(got: tuple, want: tuple, what: str) -> float:
    """Max |got - want| over (qacc, efc_force, qfrc_constraint); fails on the
    NEWTON_* bars above."""
    import torch

    within = torch.ones(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    err_max = 0.0
    for g, w, name in zip(got, want, ("qacc", "efc_force", "qfrc_constraint")):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{what} {name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite output")
        g, w = g.double(), w.double()
        err = (g - w).abs()
        within &= (err <= NEWTON_TOL + NEWTON_TOL * w.abs()).all(dim=1)
        env_rel = err.amax(dim=1) / (w.abs().amax(dim=1) + NEWTON_TOL)
        if env_rel.max().item() > NEWTON_ENV_RTOL:
            fail(f"{what} {name}: an env differs by {env_rel.max().item():.3e} of its largest component")
        err_max = max(err_max, err.max().item())
    share = within.float().mean().item()
    print(f"{what}: {share:.4f} of envs within rtol/atol {NEWTON_TOL}; max |difference| {err_max:.3e}")
    if share < NEWTON_MIN_SHARE:
        fail(f"{what}: only {share:.4f} of envs within rtol/atol {NEWTON_TOL}")
    return err_max


def random_spd(rng, B: int, n: int, device):
    import numpy as np
    import torch

    g = rng.standard_normal((B, n, n)).astype(np.float32)
    a = g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((B, n)).astype(np.float32)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


class _Skel:
    """Just the skeleton fields PyramidStructure reads (hashable by identity)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def synthetic_structured_problem(B: int, seed: int, device):
    """A numpy-seeded pyramidal Newton problem with every row family of the
    structured layout: 2 equality rows, 3 dof-friction and 2 tendon-friction
    rows, 2 scalar limits (one-hot) around 1 ball limit (dense), and 5
    condim-3 contacts (nv = 12, nefc = 30). Returns (structure, args of
    engine.solver._newton_arrays, kernel-only operands bJ and dsc)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.core.types import EqType, JointType
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    nv, ncon = 12, 5
    jnt_type = np.array([JointType.HINGE, JointType.BALL, JointType.HINGE], np.int32)
    s = _Skel(
        nefc=30, ncon=ncon, neq=2, eq_type=np.array([EqType.JOINT, EqType.JOINT], np.int32),
        friction_dofid=np.array([0, 4, 7], np.int32), friction_tenid=np.array([0, 1], np.int32),
        limit_jntid=np.array([0, 1, 2], np.int32), jnt_type=jnt_type, jnt_dofadr=np.array([2, 5, 9], np.int32),
        limit_tenid=np.array([], np.int32), con_dim=np.full(ncon, 3, np.int32),
        con_efcadr=(10 + 4 * np.arange(ncon)).astype(np.int32),
    )
    st = _pyramid_structure(s)
    assert st is not None and (st.nd, st.ndiag, st.ncon3, st.nd_eq, st.nd_ft, st.nfd) == (5, 5, 5, 2, 2, 3)

    rng = np.random.default_rng(seed)
    f32 = np.float32
    J = np.zeros((B, s.nefc, nv), f32)
    J[:, st.dense_rows] = rng.standard_normal((B, st.nd, nv))
    dsc = rng.choice([-1.0, 1.0], (B, st.ndiag)).astype(f32)
    dsc[:, : st.nfd] = 1.0
    J[:, st.diag_rows, st.diag_dofs] = dsc
    N, U1, U2 = (rng.standard_normal((B, ncon, nv)).astype(f32) for _ in range(3))
    for q, row in enumerate((N + U1, N - U1, N + U2, N - U2)):
        J[:, st.adr3 + q] = row
    bJ = np.concatenate([N, U1, U2], axis=1)
    g = rng.standard_normal((B, nv, nv)).astype(f32)
    qM = g @ np.swapaxes(g, -1, -2) / nv + np.eye(nv, dtype=f32)
    aref = rng.standard_normal((B, s.nefc)).astype(f32)
    D = rng.uniform(1.0, 10.0, (B, s.nefc)).astype(f32)
    fl = np.zeros((B, s.nefc), f32)
    fric_rows = np.concatenate([st.diag_rows[: st.nfd], st.dense_rows[st.nd_eq : st.nd_eq + st.nd_ft]])
    fl[:, fric_rows] = rng.uniform(0.1, 1.0, (B, len(fric_rows)))
    act = (rng.uniform(size=(B, s.nefc)) < 0.8).astype(f32)
    a_s = rng.standard_normal((B, nv)).astype(f32)
    ws = a_s + 0.3 * rng.standard_normal((B, nv)).astype(f32)

    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    plain_args = dict(
        J=t(J), qM=t(qM), aref=t(aref), D=t(D), fl=t(fl), act=t(act), a_s=t(a_s), ws=t(ws),
        tol=torch.full((1,), 1e-8, device=device), ne=st.nd_eq, nf=st.nfd + st.nd_ft,
    )
    return st, plain_args, t(bJ), t(dsc)


def check_linalg(device, results):
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import linalg as plain
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(1)
    errs = {"cholesky": 0.0, "cho_solve": 0.0, "solve_pd": 0.0}
    times = {}
    for B, n in ((NUM_ENVS, 18), (257, 1), (257, 7), (257, 25), (257, 32)):
        a, b = random_spd(rng, B, n, device)
        l_ref = plain.cholesky_unrolled(a)
        cases = {
            "cholesky": (lambda: kernels.cholesky_batched(a), lambda: plain.cholesky_unrolled(a)),
            "cho_solve": (lambda: kernels.cho_solve_batched(l_ref, b), lambda: plain.cho_solve_unrolled(l_ref, b)),
            "solve_pd": (lambda: kernels.solve_pd_batched(a, b), lambda: plain.solve_pd_unrolled(a, b)),
        }
        for name, (kern, ref) in cases.items():
            got, want = kern(), ref()
            torch.cuda.synchronize()
            errs[name] = max(errs[name], max_err(got, want, LINALG_TOL, LINALG_TOL, f"{name} B={B} n={n}"))
            if (B, n) == (NUM_ENVS, 18):
                times[name] = (cuda_ms(kern), cuda_ms(ref))
        # the kernels read only the lower triangle (the contract kernel 4 relies on)
        a_low = torch.tril(a) + torch.triu(torch.full_like(a, 1e6), diagonal=1)
        max_err(kernels.cholesky_batched(a_low), kernels.cholesky_batched(a), 0.0, 0.0, f"upper triangle n={n}")
    replaces = {
        "cholesky": "ambersim_tpu/ops/linalg_pallas.py:319",
        "cho_solve": "ambersim_tpu/ops/linalg_pallas.py:324",
        "solve_pd": "ambersim_tpu/ops/linalg_pallas.py:314",
    }
    for name in ("cholesky", "cho_solve", "solve_pd"):
        ms, plain_ms = times[name]
        print(f"kernel {name}: B={NUM_ENVS} n=18 {ms:.4f} ms, plain {plain_ms:.4f} ms, max |err| {errs[name]:.2e}")
        results[name] = dict(
            name=name, route="cuda", source="ambersim_tpu_torch/csrc/linalg.cu", replaces=replaces[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
        )


def check_newton(m, device, results):
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import collision, constraint, make_data, smooth
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    # real operands: a 4096-env quadruped pre-solve on the card
    d = initial_batch(m, NUM_ENVS, device)
    d = d.replace(ctrl=pd_ctrl(d))
    d = smooth.fwd_position_smooth(m, d)
    d = collision.collision(m, d)
    d = constraint.make_constraint(m, d)
    d = smooth.fwd_acceleration(m, smooth.fwd_actuation(m, smooth.fwd_velocity(m, d)))
    s = m.skel
    st = _pyramid_structure(s)
    tol = (m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(), min=1.0)).reshape(1)
    act = d.efc_active.float()
    it, ls = int(m.opt.iterations), int(m.opt.ls_iterations)
    ws = d.qacc_smooth + 0.1 * torch.as_tensor(
        np.random.default_rng(2).standard_normal((NUM_ENVS, s.nv)).astype(np.float32), device=device
    )
    print(f"quadruped pre-solve: active efc rows per env {act.sum(1).mean().item():.1f} of {s.nefc}")

    def kern():
        return newton_solve_structured(
            d.efc_J, d.efc_bJ, d.efc_dsc, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, act, d.qacc_smooth, ws,
            tol, st=st, iterations=it, ls_iterations=ls, use_ws=True,
        )

    def ref(dtype=torch.float32):
        args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, act, d.qacc_smooth, ws, tol)
        return _newton_arrays(
            *(x.to(dtype) for x in args),
            ne=int(s.ne), nf=int(s.nf), iterations=it, ls_iterations=ls, use_ws=True,
        )

    got = kern()
    err = newton_err(got, ref(), "newton quadruped")
    # the same solve in float64 shows how far float32 rounding alone moves
    # it: the kernel must stay as close to it as the NEWTON_* bars ask
    exact = ref(torch.float64)
    newton_err(ref(), exact, "newton quadruped, plain float32 vs float64")
    newton_err(got, exact, "newton quadruped, kernel vs plain float64")
    ms, plain_ms = cuda_ms(kern), cuda_ms(ref)

    # synthetic problem with dense, equality, tendon-friction and one-hot rows
    st2, pa, bJ, dsc = synthetic_structured_problem(257, seed=3, device=device)
    got = newton_solve_structured(
        pa["J"], bJ, dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"], pa["ws"], pa["tol"],
        st=st2, iterations=5, ls_iterations=8, use_ws=True,
    )
    want = _newton_arrays(**pa, iterations=5, ls_iterations=8, use_ws=True)
    err = max(err, newton_err(got, want, "newton synthetic"))
    print(f"kernel newton_structured: B={NUM_ENVS} {ms:.4f} ms, plain {plain_ms:.4f} ms, max |err| {err:.2e}")
    results["newton_structured"] = dict(
        name="newton_structured", route="cuda", source="ambersim_tpu_torch/csrc/newton_structured.cu",
        replaces="ambersim_tpu/ops/newton_pallas.py:582", max_abs_err=err, ms=ms, plain_ms=plain_ms,
    )


def initial_batch(m, batch: int, device):
    """make_data with qpos[7:] += 0.05 N(0, 1) drawn by numpy.random.default_rng(0)."""
    import numpy as np
    import torch

    from ambersim_tpu_torch.engine import make_data

    d = make_data(m, batch)
    noise = np.random.default_rng(0).standard_normal((NUM_ENVS, m.nq - 7)).astype(np.float32)[:batch]
    qpos = d.qpos.clone()
    qpos[:, 7:] += torch.as_tensor(0.05 * noise, device=device)
    return d.replace(qpos=qpos)


def pd_ctrl(d):
    return KP * (0.0 - d.qpos[:, 7:]) - KD * d.qvel[:, 6:]


def main() -> int:
    if not (REPO / "ambersim_tpu_torch").is_dir():
        fail(f"run from a checkout of the repository: no ambersim_tpu_torch/ beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs only on a CUDA card")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    from ambersim_tpu_torch.engine.forward import full_f32_matmul

    full_f32_matmul()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ----
    from ambersim_tpu_torch.ops import LAUNCHES, _build, reset_launch_counts

    lib_path, build_s = _build.build()
    print(f"build: {build_s:.1f} s ({lib_path.name})", flush=True)
    log = lib_path.with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())
    _build.library()

    # ---- 3. kernels against their plain versions ----
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import rollout

    m = load_model("quadruped", device=device)
    results: dict = {}
    check_linalg(device, results)
    check_newton(m, device, results)
    torch.cuda.synchronize()

    # ---- 4. main path: 4096-env PD rollout through the port ----
    d0 = initial_batch(m, NUM_ENVS, device)
    rollout(m, d0, 3, ctrl_fn=pd_ctrl)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    d = rollout(m, d0, NUM_STEPS, ctrl_fn=pd_ctrl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for field in ("qpos", "qvel", "qacc", "efc_force"):
        if not torch.isfinite(getattr(d, field)).all():
            fail(f"main path: non-finite {field}")
    z = d.qpos[:, 2]
    if not bool(((z >= 0.20) & (z <= 0.32)).all()):
        fail(f"main path: trunk z outside [0.20, 0.32]: min {z.min().item():.4f} max {z.max().item():.4f}")
    for name, n in launches.items():
        if n < NUM_STEPS:
            fail(f"main path: kernel {name} launched {n} times in {NUM_STEPS} steps")
        results[name]["launches"] = n
    rate = NUM_ENVS * NUM_STEPS / seconds
    print(
        f"main path: {NUM_ENVS} envs x {NUM_STEPS} steps in {seconds:.3f} s = {rate:.1f} env-steps/s "
        f"[{card}]; trunk z in [{z.min().item():.4f}, {z.max().item():.4f}]; launches {launches}",
        flush=True,
    )

    # ---- 5. card (kernels) against CPU (plain versions), 8 envs x 20 steps ----
    m_cpu = load_model("quadruped", device="cpu")
    d_gpu = rollout(m, initial_batch(m, 8, device), 20, ctrl_fn=pd_ctrl)
    d_cpu = rollout(m_cpu, initial_batch(m_cpu, 8, "cpu"), 20, ctrl_fn=pd_ctrl)
    dq = (d_gpu.qpos.cpu() - d_cpu.qpos).abs().max().item()
    dv = (d_gpu.qvel.cpu() - d_cpu.qvel).abs().max().item()
    print(f"card vs cpu after 20 steps: max |dqpos| {dq:.3e} (<= {QPOS_TOL}), max |dqvel| {dv:.3e} (<= {QVEL_TOL})")
    if not (dq <= QPOS_TOL and dv <= QVEL_TOL):
        fail("card rollout disagrees with the CPU rollout")

    order = ("cholesky", "cho_solve", "solve_pd", "newton_structured")
    print(json.dumps({"kernels": [results[k] for k in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
