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


def _case(jm, seed):
    torch.set_num_threads(1)
    B = 8
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


@pytest.mark.parametrize("scene", ["quadruped", "contact_scene"])
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
