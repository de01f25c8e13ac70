"""The port's plain pyramidal Newton (`engine.solver._newton_arrays`, kernel
4's reference) against the JAX package's `solver.solve` (CPU).

Pre-solve operands come from the JAX package, so the solver is held to the
reference on rows the port's own assembly does not build yet: the
quadruped (24 one-hot rows + 28 pyramids) and CONTACT_SCENE of
tests/test_newton_pallas.py (equality, dof-friction, limit and contact
rows). Bar: rtol/atol 1e-4, the Pallas kernel's bar against the same jnp
path (tests/test_newton_pallas.py:210-215).
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

RTOL = ATOL = 1e-4

def _pre_solve_and_solve(m, d):
    from ambersim_tpu.engine import collision, constraint, smooth, solver

    d = smooth.fwd_position_smooth(m, d)
    d = collision.collision(m, d)
    d = constraint.make_constraint(m, d)
    d = smooth.fwd_velocity(m, d)
    d = smooth.fwd_actuation(m, d)
    d = smooth.fwd_acceleration(m, d)
    return d, solver.solve(m, d)


def _case(jm, seed, qpos=None, qvel=None):
    torch.set_num_threads(1)
    B = 8
    if qpos is None:
        qpos, qvel = tp.random_state(jm, B, seed=seed)
    ws = 0.5 * np.random.default_rng(seed + 1).standard_normal((B, jm.skel.nv)).astype(np.float32)
    ws[: B // 2] = 0.0
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel, qacc_warmstart=ws)
    pre, ref = jax.jit(jax.vmap(lambda d: _pre_solve_and_solve(jm, d)))(jd)
    return jm, pre, ref


@pytest.fixture(scope="module")
def quadruped():
    return _case(tp.jax_model(), seed=21)


@pytest.fixture(scope="module")
def contact_scene():
    return _case(tp.jax_model_from_xml(tp.CONTACT_SCENE), seed=22)


# the rows of these three do not all factor as kernel 4's do (arm3 and
# cartpole) or, on the TPU, overflow its VMEM (the humanoid): the JAX package
# sends them to kernel 5, whose plain version is _newton_arrays as well


@pytest.fixture(scope="module")
def arm3():
    jm = tp.jax_asset_model("arm3")
    qvel = 0.5 * np.random.default_rng(23).standard_normal((8, jm.skel.nv)).astype(np.float32)
    return _case(jm, 23, tp.arm3_contact_qpos(jm, 8, seed=24), qvel)


@pytest.fixture(scope="module")
def cartpole():
    jm = tp.jax_asset_model("cartpole")
    qpos, qvel = tp.cartpole_limit_state(jm, 8, seed=25)
    qpos[:, 0] = np.sign(qpos[:, 0]) * 1.02  # just past the limit: the row is active
    return _case(jm, 25, qpos, qvel)


@pytest.fixture(scope="module")
def humanoid():
    return _case(tp.jax_asset_model("humanoid"), seed=26)


def _plain_newton(jm, pre):
    from ambersim_tpu_torch.engine.solver import _newton_arrays

    s = jm.skel
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    tol = torch.as_tensor(float(jm.opt.tolerance) * s.nv * max(float(np.sum(jm.body_mass)), 1.0))
    return _newton_arrays(
        t(pre.efc_J), t(pre.qM), t(pre.efc_aref), t(pre.efc_D), t(pre.efc_frictionloss),
        t(pre.efc_active).float(), t(pre.qacc_smooth), t(pre.qacc_warmstart), tol,
        ne=int(s.ne), nf=int(s.nf), iterations=int(jm.opt.iterations), ls_iterations=int(jm.opt.ls_iterations),
        use_ws=True,
    )


@pytest.mark.parametrize("scene", ["quadruped", "contact_scene", "arm3", "cartpole", "humanoid"])
def test_plain_newton_matches_jax(scene, request):
    jm, pre, ref = request.getfixturevalue(scene)
    s = jm.skel
    if scene == "contact_scene":
        assert s.ne > 0 and s.nf > 0 and s.nl > 0  # every row family
    assert np.asarray(pre.efc_active).sum() > 0
    qacc, force, qfrc = _plain_newton(jm, pre)
    tp.assert_close("qacc", qacc, ref.qacc, RTOL, ATOL)
    tp.assert_close("efc_force", force, ref.efc_force, RTOL, ATOL)
    tp.assert_close("qfrc_constraint", qfrc, ref.qfrc_constraint, RTOL, ATOL)


def test_solve_dispatches_to_plain_on_cpu(quadruped):
    """engine.solver.solve on CPU tensors runs the plain path (no kernel
    launch) and fills qacc, efc_force, qfrc_constraint and the warmstart."""
    from ambersim_tpu_torch.engine import solver
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    jm, pre, ref = quadruped
    tm = tp.torch_model(jm)
    reset_launch_counts()
    out = solver.solve(tm, tp.torch_batch(tm, pre))
    assert all(v == 0 for v in LAUNCHES.values())
    tp.assert_close("qacc", out.qacc, ref.qacc, RTOL, ATOL)
    tp.assert_close("efc_force", out.efc_force, ref.efc_force, RTOL, ATOL)
    tp.assert_close("qfrc_constraint", out.qfrc_constraint, ref.qfrc_constraint, RTOL, ATOL)
    tp.assert_close("qacc_warmstart", out.qacc_warmstart, ref.qacc_warmstart, RTOL, ATOL)


def test_kernel_launcher_refuses_cpu_tensors(quadruped):
    """Kernel 4's launcher takes CUDA tensors only: no fallback."""
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    jm, pre, _ = quadruped
    tm = tp.torch_model(jm)
    d = tp.torch_batch(tm, pre)
    with pytest.raises(ValueError, match="CUDA"):
        newton_solve_structured(
            d.efc_J, d.efc_bJ, d.efc_dsc, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, d.efc_active.float(),
            d.qacc_smooth, d.qacc_warmstart, torch.ones(1), st=_pyramid_structure(tm.skel),
            iterations=3, ls_iterations=6, use_ws=True,
        )


@pytest.mark.parametrize("scene", ["arm3", "cartpole", "humanoid"])
def test_solve_routes_to_plain_on_cpu(scene, request):
    """solve() on CPU tensors takes the plain version of the model's route
    (kernel 5's for arm3 and cartpole, kernel 4's for the humanoid) and
    launches nothing."""
    from ambersim_tpu_torch.engine import solver
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    jm, pre, ref = request.getfixturevalue(scene)
    tm = tp.torch_model(jm)
    assert (_pyramid_structure(tm.skel) is None) == (scene != "humanoid")
    reset_launch_counts()
    out = solver.solve(tm, tp.torch_batch(tm, pre))
    assert all(v == 0 for v in LAUNCHES.values())
    tp.assert_close("qacc", out.qacc, ref.qacc, RTOL, ATOL)
    tp.assert_close("efc_force", out.efc_force, ref.efc_force, RTOL, ATOL)


# ---------------- elliptic cones (kernel 6's plain version) ----------------
#
# Bars. The guarded bracketed line search replaces a Newton step that rounds
# onto an end of its bracket by the bracket's midpoint, so float32 reduction
# order (torch and XLA sum in different orders) moves the iterates of a
# half-converged solve far apart: at the quadruped's own 3 x 6 iterations
# the port and the jnp path agree within 1e-4 on 28% of 32 envs, and the
# port in float32 agrees with itself in float64 on 34%, with total costs
# 27% apart. So elementwise parity is held where the solve is not chaotic:
# with one line-search step (ENV_TOL of each env's largest |component|), and
# converged at 15 x 15 as tests/test_newton_pallas.py:255 converges both
# paths, at that test's rtol 1e-2 (CONVERGED_TOL: the converged iterates stop
# at different points of a flat valley, measured up to 1.06e-3) with total
# costs within COST_RTOL. At 3 x 6 the total costs are compared
# (MODEL_COST_RTOL per env; measured up to 2.8e-2).
ENV_TOL = 1e-4
CONVERGED_TOL = 1e-2
COST_RTOL = 1e-6
MODEL_COST_RTOL = 5e-2


def _elliptic_jnp(args: dict, **statics):
    """_newton_arrays_elliptic_jnp vmapped over numpy operands."""
    from ambersim_tpu.engine.solver import _newton_arrays_elliptic_jnp

    a = {k: np.asarray(v) for k, v in args.items() if k in _ELLIPTIC_ARRAYS}
    fn = jax.vmap(
        lambda J, qM, aref, D, fl, act, a_s, ws, fr: _newton_arrays_elliptic_jnp(
            J, qM, aref, D, fl, act, a_s, ws, np.float32(args["tol"]), fr, np.float32(args["impratio"]), **statics
        )
    )
    return [np.asarray(x) for x in jax.jit(fn)(*(a[k] for k in _ELLIPTIC_ARRAYS))]


_ELLIPTIC_ARRAYS = ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "fr")


def _elliptic_torch(args: dict, **statics):
    from ambersim_tpu_torch.engine.solver import _newton_arrays_elliptic

    t = {k: torch.as_tensor(np.array(args[k])) for k in _ELLIPTIC_ARRAYS}
    return _newton_arrays_elliptic(**t, tol=torch.tensor(float(args["tol"])),
                                   impratio=torch.tensor(float(args["impratio"])), **statics)


def _elliptic_cost(args: dict, qacc, statics) -> np.ndarray:
    """Total cost per env at qacc, in float64."""
    from ambersim_tpu_torch.engine.solver import cone_params, elliptic_total_cost

    a = {k: torch.as_tensor(np.array(args[k])).double() for k in _ELLIPTIC_ARRAYS}
    q = torch.as_tensor(np.array(qacc)).double()
    mu, scale = cone_params(a["fr"], float(args["impratio"]), statics["cdim"])
    jar = (a["J"] * q[:, None, :]).sum(-1) - a["aref"]
    return elliptic_total_cost(q, jar, a["qM"], a["a_s"], a["D"], a["fl"], a["act"], mu, scale, ne=statics["ne"],
                               nf=statics["nf"], nh=statics["base"], S=statics["ncon"], cdim=statics["cdim"]).numpy()


def _env_rel(got, want) -> np.ndarray:
    """Per-env max |got - want| / (max |want| + 1) over the three outputs."""
    rel = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        rel = np.maximum(rel, np.abs(g - w).max(1) / (np.abs(w).max(1) + 1.0))
    return rel


@pytest.fixture(scope="module")
def elliptic_quadruped():
    """Pre-solve operands of the elliptic quadruped: 32 numpy-seeded envs,
    half standing at the main path's start, half perturbed."""
    from ambersim_tpu_torch.engine.solver import elliptic_tail

    torch.set_num_threads(1)
    jm = tp.jax_asset_model("quadruped_elliptic")
    B = 32
    qpos, qvel = tp.random_state(jm, B, seed=31, qpos_scale=0.02)
    qpos[: B // 2] = tp.bench_qpos(jm, B // 2, seed=32)
    ws = np.zeros((B, jm.skel.nv), np.float32)
    ws[B // 2 :] = 0.5 * np.random.default_rng(33).standard_normal((B // 2, jm.skel.nv))
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel, qacc_warmstart=ws)
    pre, _ = jax.jit(jax.vmap(lambda d: _pre_solve_and_solve(jm, d)))(jd)
    s = jm.skel
    cdim, slots, base, full = elliptic_tail(tp.torch_model(jm).skel)
    assert full and (cdim, base, len(slots)) == (3, 24, 28)
    args = dict(
        J=pre.efc_J, qM=pre.qM, aref=pre.efc_aref, D=pre.efc_D, fl=pre.efc_frictionloss,
        act=np.asarray(pre.efc_active).astype(np.float32), a_s=pre.qacc_smooth, ws=pre.qacc_warmstart,
        fr=pre.contact.friction, impratio=float(jm.opt.impratio),
        tol=float(jm.opt.tolerance) * s.nv * max(float(np.sum(jm.body_mass)), 1.0),
    )
    assert args["act"][:, base:].sum() > 0
    return args, dict(ne=int(s.ne), nf=int(s.nf), base=base, ncon=len(slots), cdim=cdim, use_ws=True)


def _synthetic_elliptic(nh: int, cdim: int):
    from chip_smoke import synthetic_elliptic_problem

    sp = synthetic_elliptic_problem(16, nv=12, nh=nh, S=6, cdim=cdim, seed=40 + nh + cdim, device="cpu")
    statics = {k: sp.pop(k) for k in ("ne", "nf", "base", "ncon", "cdim")}
    args = {k: v.numpy() for k, v in sp.items() if k in _ELLIPTIC_ARRAYS}
    return dict(args, tol=float(sp["tol"]), impratio=float(sp["impratio"])), dict(statics, use_ws=True)


def _elliptic_problem(problem, request):
    if problem == "quadruped":
        return request.getfixturevalue("elliptic_quadruped")
    nh, cdim = (int(x) for x in problem.split("_")[1:])
    return _synthetic_elliptic(nh, cdim)


ELLIPTIC_PROBLEMS = ["quadruped", "synthetic_0_3", "synthetic_9_3", "synthetic_0_6", "synthetic_9_6"]


@pytest.mark.parametrize("problem", ELLIPTIC_PROBLEMS)
def test_plain_elliptic_one_step_matches_jax(problem, request):
    """3 Newton iterations with one line-search step each: every env within
    ENV_TOL of its largest component (nh = 0 and 9 head rows, cdim 3 and 6)."""
    args, statics = _elliptic_problem(problem, request)
    kw = dict(statics, iterations=3, ls_iterations=1)
    rel = _env_rel(_elliptic_torch(args, **kw), _elliptic_jnp(args, **kw))
    assert rel.max() <= ENV_TOL, rel


@pytest.mark.parametrize("problem", ELLIPTIC_PROBLEMS)
def test_plain_elliptic_converged_matches_jax(problem, request):
    """Converged (15 x 15): every env within CONVERGED_TOL, costs within COST_RTOL."""
    args, statics = _elliptic_problem(problem, request)
    kw = dict(statics, iterations=15, ls_iterations=15)
    got, want = _elliptic_torch(args, **kw), _elliptic_jnp(args, **kw)
    rel = _env_rel(got, want)
    assert rel.max() <= CONVERGED_TOL, rel
    c_got, c_want = _elliptic_cost(args, got[0], statics), _elliptic_cost(args, want[0], statics)
    np.testing.assert_allclose(c_got, c_want, rtol=COST_RTOL)


def test_plain_elliptic_model_settings_cost_matches_jax(elliptic_quadruped):
    """At the quadruped's own 3 x 6 iterations the total costs agree per env
    within MODEL_COST_RTOL and on the batch mean within 1e-2."""
    args, statics = elliptic_quadruped
    kw = dict(statics, iterations=3, ls_iterations=6)
    got, want = _elliptic_torch(args, **kw), _elliptic_jnp(args, **kw)
    assert all(np.isfinite(np.asarray(g)).all() for g in got)
    c_got, c_want = _elliptic_cost(args, got[0], statics), _elliptic_cost(args, want[0], statics)
    np.testing.assert_allclose(c_got, c_want, rtol=MODEL_COST_RTOL)
    assert abs(c_got.mean() / c_want.mean() - 1.0) <= 1e-2


def test_elliptic_line_search_step_selects_on_nonfinite():
    """A Newton step that overflows (g / max(h, 1e-12) beyond float32), or is
    NaN, gives the bracket's midpoint, never NaN: the select plus isfinite of
    JAX solver.py:777, not the Pallas kernel's blend (newton_pallas.py:1041)."""
    from ambersim_tpu_torch.engine.solver import ls_bracket_step

    state = torch.tensor([[0.5, 0.0, 4.0, 1e30, 0.0], [0.5, 0.0, 4.0, -1e30, 0.0],
                          [0.5, 0.0, 4.0, float("nan"), 1.0], [0.5, 0.0, 4.0, 1.0, float("inf")],
                          [0.5, 0.0, 4.0, -1.0, 1.0]])
    t, lo, hi = ls_bracket_step(*state.T)
    assert torch.isfinite(t).all()
    want = [[0.25, 0.0, 0.5], [2.25, 0.5, 4.0], [0.25, 0.0, 0.5], [0.25, 0.0, 0.5], [1.5, 0.5, 4.0]]
    assert torch.stack([t, lo, hi], 1).tolist() == want
    tn = state[:2, 0] - state[:2, 3] / torch.clamp(state[:2, 4], min=1e-12)
    assert torch.isinf(tn).all()  # the Newton steps of the first two states overflow
    blend = 0.0 * tn + 1.0 * 0.5 * (state[:2, 1] + torch.minimum(state[:2, 2], state[:2, 0]))
    assert torch.isnan(blend).all()  # what a blend would have returned


def test_solve_routes_elliptic_to_plain_on_cpu(elliptic_quadruped):
    """solve() on an elliptic model's CPU tensors runs _newton_arrays_elliptic
    and launches nothing; with the solver converged it matches the JAX
    package's solve."""
    from ambersim_tpu_torch.engine import solver
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    jm = tp.with_solver(tp.jax_asset_model("quadruped_elliptic"), iterations=15, ls_iterations=15)
    tm = tp.torch_model(jm)
    qpos, qvel = tp.random_state(jm, 4, seed=34, qpos_scale=0.02)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    pre, ref = jax.jit(jax.vmap(lambda d: _pre_solve_and_solve(jm, d)))(jd)
    reset_launch_counts()
    out = solver.solve(tm, tp.torch_batch(tm, pre))
    assert all(v == 0 for v in LAUNCHES.values())
    rel = _env_rel((out.qacc, out.efc_force, out.qfrc_constraint), (ref.qacc, ref.efc_force, ref.qfrc_constraint))
    assert rel.max() <= CONVERGED_TOL, rel


@pytest.mark.parametrize("kernel", ["dense", "elliptic"])
def test_kernel_5_and_6_launchers_refuse_cpu_tensors(kernel, elliptic_quadruped):
    """Kernels 5 and 6 take CUDA tensors only: no fallback."""
    from ambersim_tpu_torch.ops.newton import newton_solve_dense, newton_solve_elliptic

    args, statics = elliptic_quadruped
    t = {k: torch.as_tensor(np.array(args[k])) for k in _ELLIPTIC_ARRAYS}
    rows = [t[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws")] + [torch.ones(1)]
    kw = dict(iterations=3, ls_iterations=6, use_ws=True)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "dense":
            newton_solve_dense(*rows, ne=statics["ne"], nf=statics["nf"], **kw)
        else:
            newton_solve_elliptic(*rows, t["fr"], 1.0, **{k: statics[k] for k in ("ne", "nf", "base", "ncon", "cdim")},
                                  **kw)
