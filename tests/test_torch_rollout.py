"""The PyTorch port's main path as a whole against the JAX package (CPU):
8 quadruped envs, 20 steps of the PD standing controller, from the main
path's numpy-seeded start (qpos[7:] += 0.05 N(0, 1)), through
ambersim_tpu.engine.rollout.rollout and ambersim_tpu_torch's rollout.
Bars: qpos atol 1e-4, qvel atol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

B, STEPS = 8, 20
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def case():
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import rollout

    torch.set_num_threads(1)
    jm = tp.jax_model()
    tm = tp.torch_model(jm)
    jd = tp.jax_batch(jm, qpos=tp.bench_qpos(jm, B, seed=0))
    ref = jax.jit(lambda d: jax_rollout(jm, d, STEPS, ctrl_fn=tp.pd_ctrl_jax, batched=True))(jd)
    got = rollout(tm, tp.torch_batch(tm, jd), STEPS, ctrl_fn=tp.pd_ctrl_torch)
    return ref, got


@pytest.mark.parametrize("field, atol", [("qpos", QPOS_ATOL), ("qvel", QVEL_ATOL), ("time", 1e-6)])
def test_rollout_state_matches_jax(case, field, atol):
    ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


def test_rollout_stands_in_contact(case):
    """The trunk stays up on loaded feet (the main path's steady state)."""
    ref, got = case
    assert torch.isfinite(got.qpos).all() and torch.isfinite(got.qvel).all()
    z = got.qpos[:, 2].numpy()
    assert np.all((z > 0.25) & (z < 0.28)), z
    assert np.all(got.efc_active.sum(-1).numpy() >= 16)
    np.testing.assert_array_equal(got.efc_active.numpy(), np.asarray(ref.efc_active))


# The models of the dense and elliptic Newton routes and the humanoid, 8 envs
# x 20 steps from numpy-seeded starts whose constraint rows turn on. The
# elliptic quadruped's solve is converged (15 x 15 iterations) for these
# bars: at its own 3 x 6 the guarded line search is chaotic in float32 (the
# JAX package's own rollout moves by 1.2e-2 in qpos and 0.23 in qvel when
# its start moves by 1e-6), so that run is held to ELLIPTIC_QPOS_ATOL /
# ELLIPTIC_QVEL_ATOL instead.
ELLIPTIC_QPOS_ATOL, ELLIPTIC_QVEL_ATOL = 5e-2, 1.0
MORE = ["cartpole", "arm3", "humanoid", "quadruped_elliptic_converged", "quadruped_elliptic"]


def _more_start(name, jm):
    if name == "cartpole":
        return tp.cartpole_limit_state(jm, B, seed=41)
    if name == "arm3":
        return tp.arm3_contact_qpos(jm, B, seed=42), np.zeros((B, jm.skel.nv), np.float32)
    return tp.bench_qpos(jm, B, seed=43), np.zeros((B, jm.skel.nv), np.float32)


@pytest.fixture(scope="module", params=MORE)
def more_case(request):
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import rollout

    torch.set_num_threads(1)
    name = request.param
    jm = tp.jax_asset_model(name.replace("_converged", ""))
    if name.endswith("_converged"):
        jm = tp.with_solver(jm, iterations=15, ls_iterations=15)
    tm = tp.torch_model(jm)
    pd = name.startswith("quadruped")
    qpos, qvel = _more_start(name, jm)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(
        lambda d: jax_rollout(jm, d, STEPS, ctrl_fn=tp.pd_ctrl_jax if pd else None, batched=True)
    )(jd)
    active = []

    def ctrl(d):
        active.append(d.efc_active.sum().item())
        return tp.pd_ctrl_torch(d) if pd else d.ctrl

    got = rollout(tm, tp.torch_batch(tm, jd), STEPS, ctrl_fn=ctrl)
    return name, ref, got, sum(active) + got.efc_active.sum().item()


@pytest.mark.parametrize("field", ["qpos", "qvel", "time"])
def test_more_rollouts_match_jax(more_case, field):
    name, ref, got, _ = more_case
    atol = {"qpos": QPOS_ATOL, "qvel": QVEL_ATOL, "time": 1e-6}[field]
    if name == "quadruped_elliptic" and field != "time":
        atol = ELLIPTIC_QPOS_ATOL if field == "qpos" else ELLIPTIC_QVEL_ATOL
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


def test_more_rollouts_reach_their_rows(more_case):
    """Constraint rows were active during the rollout, and the state stays
    finite (the quadrupeds on their feet)."""
    name, _, got, active = more_case
    assert active > 0
    assert torch.isfinite(got.qpos).all() and torch.isfinite(got.qvel).all()
    if name.startswith("quadruped"):
        z = got.qpos[:, 2].numpy()
        assert np.all((z > 0.25) & (z < 0.28)), z
