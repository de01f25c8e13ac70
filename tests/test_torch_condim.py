"""Contacts of condim 4 (torsional friction) and 6 (rolling friction) in
the PyTorch port against the JAX package (CPU), under pyramidal cones
(2 (cdim - 1) rows a contact, the dense Newton kernel's plain version) and
elliptic cones (cdim rows a contact, the elliptic kernel's plain version on
one contiguous condim tail, the general elliptic solve otherwise).

Fixtures (tools/step_parity.py): tests/test_elliptic.py's sphere on a plane
at (condim, impratio) = (3, 1), (4, 1) and (6, 2) under both cones, its
spin-down sphere (condim 4, elliptic), tests/test_torch_bridge.py's
CONDIM46_XML (a condim-4 and a condim-6 sphere) and WELDED_CONDIM4_XML (a
welded box with condim-4 contacts), and the main path's quadruped with
condim-4 feet (chip_smoke.soft_feet_xml).

Bars: efc rows of one forward from identical numpy-seeded Data at
tests/test_torch_constraint.py's rtol 1e-5 / atol 1e-5 (efc_aref atol
3e-4; the quadruped's efc_D at that file's D_RTOL 1e-4), efc_active
exactly; 4 envs x 20 steps at qpos atol 1e-4 and qvel
atol 1e-3 (the quadruped 4 x 10 at its own 3 x 6 Newton iterations, the
rest at chip_smoke.CONVERGED's 15 x 15 on both sides).
"""

import numpy as np
import pytest
import torch

from tools import step_parity as sp

PAIR_CASES = [f"pair{c}_{cone}" for c, _ in sp.PAIRS for cone in ("pyramidal", "elliptic")]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", PAIR_CASES)
def test_pair_rows_match_jax(name):
    """The sphere's contact rows: 2 (cdim - 1) pyramid rows or cdim elliptic
    rows, the torsional and rolling directions among them, all active."""
    got, _ = sp.assert_rows(name)
    cdim = int(name[4])
    cone = name.split("_")[1]
    assert got.efc_J.shape[1] == (cdim if cone == "elliptic" else 2 * (cdim - 1))
    assert got.efc_active.all()


@pytest.mark.parametrize("name", PAIR_CASES)
def test_pair_rollout_matches_jax(name):
    sp.assert_rollout(name)


def test_spin_down_matches_jax():
    """tests/test_elliptic.py's spin-down: the sphere spinning at 6 rad/s
    about the contact normal, elliptic condim 4, 40 steps; the torsional
    friction takes the spin down in both packages."""
    from ambersim_tpu_torch.engine import step

    jm, tm, jstep = sp.case("spin_down")
    jd = sp.np_batch(jm, qpos=np.tile(np.asarray(jm.qpos0, np.float32), (2, 1)),
                     qvel=np.array([[0, 0, 0, 0, 0, 6.0], [0.3, 0, 0, 0, 0, -4.0]], np.float32))
    d = sp.tp.torch_batch(tm, jd)
    for _ in range(40):
        jd = jstep(jd)
        d = step(tm, d)
    sp.tp.assert_close("qpos", d.qpos, jd.qpos, 0.0, sp.QPOS_ATOL)
    sp.tp.assert_close("qvel", d.qvel, jd.qvel, 0.0, sp.QVEL_ATOL)
    assert (d.qvel[:, 5].abs() < 1.0).all()


@pytest.mark.parametrize("name", ["condim46", "welded_condim4"])
def test_bridge_fixture_rows_and_rollout(name):
    """The bridge's condim-4/6 fixtures: rows from one forward, then 20 steps."""
    sp.assert_rows(name)
    sp.assert_rollout(name)


def test_soft_feet_rows_and_layout():
    """The quadruped with condim-4 feet: nefc 144 (24 head rows, 4 foot
    contacts x 6 rows, 24 other contacts x 4), no factored layout (the
    dense kernel's route), efc_bJ empty; rows as the JAX package's."""
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    got, _ = sp.assert_rows("soft_feet")
    s = sp.case("soft_feet")[1].skel
    assert s.nefc == 144 and np.bincount(s.con_dim).tolist() == [0, 0, 0, 24, 4]
    assert _pyramid_structure(s) is None and got.efc_bJ.shape[1] == 0


def test_soft_feet_rollout_matches_jax():
    sp.assert_rollout("soft_feet", sp.QUADRUPED_STEPS)
