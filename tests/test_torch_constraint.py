"""Collision and constraint assembly of the PyTorch port against the JAX
package (CPU), plus the row-structure identities the structured Newton
kernel (kernel 4) relies on.

Numpy-seeded quadruped states (B=6, some standing, some perturbed) go
through the JAX package's smooth -> collision -> make_constraint (vmapped,
plain jnp path) and through the port's; contacts and efc rows agree at
rtol/atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

RTOL = ATOL = 1e-5
# aref = -b J qvel - k imp pos: on contact rows k*imp is ~2.6e3 (solref
# 0.02, dmax 0.95), so one f32 ulp of a ~0.27 m contact distance (3e-8,
# which geom positions accumulate in a different order on the two sides)
# moves aref by ~8e-5 (measured: |d dist| <= 4.5e-8, |d aref| <= 1.1e-4 on
# rows of magnitude ~1). The bar is 4 such ulps: 2.6e3 * 1.2e-7 = 3e-4.
AREF_ATOL = 3e-4
CONTACT_FIELDS = ("dist", "pos", "frame", "friction", "solref", "solimp", "includemargin", "geom1", "geom2")
EFC_FIELDS = (
    "efc_J", "efc_bJ", "efc_dsc", "efc_aref", "efc_D", "efc_pos", "efc_margin", "efc_frictionloss", "efc_active",
)


def _pre_solve_jax(m, d):
    from ambersim_tpu.engine import collision, constraint, smooth

    d = smooth.fwd_position_smooth(m, d)
    d = collision.collision(m, d)
    d = constraint.make_constraint(m, d)
    return smooth.fwd_velocity(m, d)


def _pre_solve_torch(m, d):
    from ambersim_tpu_torch.engine import collision, constraint, smooth

    d = smooth.fwd_position_smooth(m, d)
    d = collision.collision(m, d)
    d = constraint.make_constraint(m, d)
    return smooth.fwd_velocity(m, d)


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    jm = tp.jax_model()
    tm = tp.torch_model(jm)
    qpos, qvel = tp.random_state(jm, 6, seed=5, qpos_scale=0.02)
    qpos[:3] = tp.bench_qpos(jm, 3, seed=6)  # standing: all feet loaded
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(jax.vmap(lambda d: _pre_solve_jax(jm, d)))(jd)
    got = _pre_solve_torch(tm, tp.torch_batch(tm, jd))
    return tm, ref, got


@pytest.mark.parametrize("field", CONTACT_FIELDS)
def test_contact_field_matches_jax(case, field):
    _, ref, got = case
    tp.assert_close("contact." + field, getattr(got.contact, field), getattr(ref.contact, field), RTOL, ATOL)


@pytest.mark.parametrize("field", EFC_FIELDS)
def test_efc_field_matches_jax(case, field):
    _, ref, got = case
    atol = AREF_ATOL if field == "efc_aref" else ATOL
    tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, atol)


def test_rows_exercise_every_family(case):
    """The states reach active contact, friction and limit rows."""
    tm, _, got = case
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    st = _pyramid_structure(tm.skel)
    active = got.efc_active.numpy()
    assert active[:, : st.nfd].all()  # dof friction rows are always on
    assert active[:, st.adr3[0] :].sum() > 0  # contacts
    assert (got.efc_dsc[:, st.nfd :].abs() == 1).all()  # limit signs


def test_pyramid_identities(case):
    """One-hot rows have a single nonzero at the static dof; each contact's
    four rows are [N+U1, N-U1, N+U2, N-U2] with efc_bJ = [N | U1 | U2]
    recovered by half sums/differences (kernel 4's input contract)."""
    tm, _, got = case
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    st = _pyramid_structure(tm.skel)
    assert st.nd == 0 and st.ndiag == 24 and st.ncon3 == 28
    J = got.efc_J.numpy()
    for r, dof in zip(st.diag_rows, st.diag_dofs):
        assert np.all(np.delete(J[:, r, :], dof, axis=-1) == 0.0), f"row {r} not one-hot"
    np.testing.assert_array_equal(got.efc_dsc.numpy(), J[:, st.diag_rows, st.diag_dofs])
    R = J[:, st.adr3[:, None] + np.arange(4)[None]]
    np.testing.assert_allclose(R[:, :, 0] + R[:, :, 1], R[:, :, 2] + R[:, :, 3], rtol=1e-5, atol=1e-6)
    n = st.ncon3
    bJ = got.efc_bJ.numpy()
    np.testing.assert_allclose(bJ[:, :n], 0.5 * (R[:, :, 0] + R[:, :, 1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bJ[:, n : 2 * n], 0.5 * (R[:, :, 0] - R[:, :, 1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bJ[:, 2 * n :], 0.5 * (R[:, :, 2] - R[:, :, 3]), rtol=1e-5, atol=1e-6)
    assert np.array_equal(np.sort(st.perm), np.arange(tm.skel.nefc))
    assert np.array_equal(st.perm[st.inv_perm], np.arange(tm.skel.nefc))
