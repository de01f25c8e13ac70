"""The PyTorch port's elliptic Newton solve on layouts that no kernel takes
(engine.solver._newton_elliptic_general: condim blocks mixed, condim-1
contacts among them) against the JAX package's _solve_newton_elliptic and
its general _line_search (CPU).

Fixtures (tools/step_parity.py): tests/test_torch_bridge.py's
ELLIPTIC_MIXED_XML (condims 1 and 3) and the main path's quadruped with
condim-4 feet compiled with elliptic cones (condims 3 and 4,
chip_smoke.soft_feet_xml("elliptic")).

Bars (tests/test_torch_solver.py's for the elliptic solve, whose bracketed
line search turns float32 reduction order into other bracket states within
a few steps): converged (15 x 15 iterations) qacc and efc_force per env
within CONVERGED_TOL 1e-2 of each env's largest |component| + 1, total
costs within COST_RTOL 1e-6; at the models' own iterations ELLIPTIC_MIXED
(100 x 50, converged) at those bars. At the quadruped's own 3 x 6 both
packages' float32 solves part from a float64 run of the port's by up to
40% of an env's cost (32 envs: the port's mean |cost / float64's - 1|
5.2%, the JAX package's 6.1%), so the port is held by that distance: its
mean at most the JAX package's plus F64_SLACK 0.02, and its batch mean
cost within MODEL_COST_RTOL 5e-2 of the JAX package's. One line search
along the same direction from the same point: the step t within T_TOL
1e-5 with one line-search iteration and with LS_CONVERGED 30 (at the
quadruped's own 6 the bracket has not closed: float32 and float64 part
by 3% in t).
"""

import jax
import numpy as np
import pytest
import torch

from tools import step_parity as sp

CONVERGED_TOL = 1e-2
COST_RTOL = 1e-6
MODEL_COST_RTOL = 5e-2
MODEL_ENVS = 32
F64_SLACK = 0.02
T_TOL = 1e-5
LS_CONVERGED = 30
MIXED = ["elliptic_mixed", "soft_feet_elliptic"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _cost(name, d, qacc):
    """The port's total cost per env at qacc on d's pre-solve rows, in float64."""
    from ambersim_tpu_torch.engine.solver import elliptic_blocks, general_total_cost

    tm = sp.case(name)[1]
    q = torch.as_tensor(np.array(qacc)).double()
    J = d.efc_J.double()
    jar = (J * q[:, None, :]).sum(-1) - d.efc_aref.double()
    head, blocks = elliptic_blocks(tm.skel, d)
    blocks = [(rows, fr.double()) for rows, fr in blocks]
    return general_total_cost(q, jar, d.qM.double(), d.qacc_smooth.double(), d.efc_D.double(),
                              d.efc_frictionloss.double(), d.efc_active.double(), head, blocks, tm.opt.impratio,
                              ne=int(tm.skel.ne), nf=int(tm.skel.nf)).numpy()


@pytest.mark.parametrize("name", MIXED)
def test_layout_takes_the_general_solve(name):
    """No single contiguous condim tail: elliptic_tail is None, the CPU solve
    launches nothing."""
    from ambersim_tpu_torch.engine.solver import _elliptic_meta, elliptic_tail
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    tm = sp.case(name)[1]
    assert elliptic_tail(tm.skel) is None and len(_elliptic_meta(tm.skel)) >= 1
    reset_launch_counts()
    got, _ = sp.forward_pair(name)
    assert all(v == 0 for v in LAUNCHES.values())
    assert torch.isfinite(got.qacc).all() and got.efc_active.any()


@pytest.mark.parametrize("name", MIXED)
def test_converged_solve_matches_jax(name):
    opt = dict(sp.CONVERGED)
    got, ref = sp.forward_pair(name, opt)
    rel = sp.env_rel((got.qacc, got.efc_force), (ref.qacc, ref.efc_force))
    assert rel.max() <= CONVERGED_TOL, rel
    np.testing.assert_allclose(_cost(name, got, got.qacc), _cost(name, got, ref.qacc), rtol=COST_RTOL)


@pytest.mark.parametrize("name", MIXED)
def test_model_settings_solve_matches_jax(name):
    from ambersim_tpu_torch.engine.solver import _newton_elliptic_general, elliptic_blocks

    jm, tm, _ = sp.case(name, own=True)
    if name == "elliptic_mixed":
        assert (jm.opt.iterations, jm.opt.ls_iterations) == (100, 50)
        got, ref = sp.forward_pair(name, own=True)
        rel = sp.env_rel((got.qacc, got.efc_force), (ref.qacc, ref.efc_force))
        assert rel.max() <= CONVERGED_TOL, rel
        np.testing.assert_allclose(_cost(name, got, got.qacc), _cost(name, got, ref.qacc), rtol=COST_RTOL)
        return
    assert (jm.opt.iterations, jm.opt.ls_iterations) == (3, 6)
    got, ref = sp.forward_pair(name, own=True, batch=MODEL_ENVS)
    s = tm.skel
    ws = torch.as_tensor(np.array(sp.start(name, jm, MODEL_ENVS).qacc_warmstart)).double()
    head, blocks = elliptic_blocks(s, got)
    tol = tm.opt.tolerance * s.nv * torch.clamp(tm.body_mass.sum(), min=1.0)
    q64 = _newton_elliptic_general(
        got.efc_J.double(), got.qM.double(), got.efc_aref.double(), got.efc_D.double(),
        got.efc_frictionloss.double(), got.efc_active.double(), got.qacc_smooth.double(), ws, tol.double(),
        head, [(rows, fr.double()) for rows, fr in blocks], tm.opt.impratio, ne=int(s.ne), nf=int(s.nf),
        iterations=3, ls_iterations=6, use_ws=True)[0]
    c_got, c_ref, c_64 = (_cost(name, got, q) for q in (got.qacc, ref.qacc, q64))
    assert np.isfinite(c_got).all()
    off_got, off_ref = np.abs(c_got / c_64 - 1).mean(), np.abs(c_ref / c_64 - 1).mean()
    assert off_got <= off_ref + F64_SLACK, (off_got, off_ref)
    assert abs(c_got.mean() / c_ref.mean() - 1.0) <= MODEL_COST_RTOL


@pytest.mark.parametrize("ls_iterations", [1, LS_CONVERGED], ids=["one_step", "converged"])
@pytest.mark.parametrize("name", MIXED)
def test_line_search_matches_jax(name, ls_iterations):
    """One line search from qacc_smooth + 0.2 (qacc - qacc_smooth) toward the
    solved qacc, on the JAX package's post-forward rows: JAX _line_search
    (vmapped, at one and at LS_CONVERGED line-search iterations) against
    general_line_search."""
    from ambersim_tpu.engine.solver import _line_search
    from ambersim_tpu_torch.engine.solver import elliptic_blocks, general_line_search

    jm, tm, _ = sp.case(name)
    jm = sp.tp.with_solver(jm, ls_iterations=ls_iterations)
    _, ref = sp.forward_pair(name)
    a_s, solved = np.asarray(ref.qacc_smooth), np.asarray(ref.qacc)
    qacc = a_s + 0.2 * (solved - a_s)
    p = solved - qacc
    J, aref = np.asarray(ref.efc_J), np.asarray(ref.efc_aref)
    jar = np.einsum("brv,bv->br", J, qacc) - aref
    jp = np.einsum("brv,bv->br", J, p)
    want = np.asarray(jax.jit(jax.vmap(lambda d, q, r, pp, j: _line_search(jm, d, q, r, pp, j)))(
        ref, qacc, jar, p, jp))
    d = sp.tp.torch_batch(tm, ref)
    t = {k: torch.as_tensor(v) for k, v in dict(qacc=qacc, jar=jar, p=p, jp=jp).items()}
    mv = lambda A, x: (A * x[:, None, :]).sum(-1)  # noqa: E731
    pma = (t["p"] * mv(d.qM, t["qacc"] - d.qacc_smooth)).sum(-1)
    pmp = (t["p"] * mv(d.qM, t["p"])).sum(-1)
    got = general_line_search(t["jar"], t["jp"], pma, pmp, d.efc_D, d.efc_frictionloss, d.efc_active.float(),
                              *elliptic_blocks(tm.skel, d), tm.opt.impratio, ne=int(tm.skel.ne),
                              nf=int(tm.skel.nf), ls_iterations=int(jm.opt.ls_iterations))
    assert (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=T_TOL, atol=T_TOL)


def test_elliptic_mixed_rollout_matches_jax():
    """20 steps of ELLIPTIC_MIXED_XML at 15 x 15 iterations."""
    sp.assert_rollout("elliptic_mixed")
