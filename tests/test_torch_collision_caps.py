"""Broadphase-capped pair groups and the max_contact_points row cap of the
PyTorch port (engine/collision.py, engine/constraint.py) against the JAX
package, on the CPU.

The scene is the first 12 bodies of clutter32.xml (6 spheres, 6 boxes,
nv = 72) lowered into contact (tools/torch_parity.clutter_small_xml), so
that plane-sphere, plane-box, sphere-sphere, sphere-box and box-box
contacts are active at the start. It is exported through
tools/export_model_npz.py's CLI with --broadphase-cap 6, which caps every
object-object group (15, 36 and 15 pairs) and leaves the two plane groups
(6 pairs each) static, without a row cap and with --max-contact-points 84:
more slots than the real candidates, so the row cap also keeps empty slots
that tie at -1e10 and must break the tie as lax.top_k does. Four
numpy-seeded states go through the JAX package's smooth -> collision ->
make_constraint (vmapped) and the port's; contacts and rows agree field by
field at the bars of tests/test_torch_constraint.py.

A synthetic scene with 300 spheres (geom ids up to 300) checks that the
broadphase top-k and the row cap move geom ids and contact distances
bit for bit (chip_smoke.selection_case; on the card with TF32 on in
tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

CAP = 6
RTOL = ATOL = 1e-5
AREF_ATOL = 3e-4  # tests/test_torch_constraint.py: k*imp ~ 2.6e3 times one f32 ulp of distance
BIG = 1e10
CONTACT_FIELDS = ("dist", "pos", "frame", "friction", "solref", "solimp", "includemargin", "geom1", "geom2")
EFC_FIELDS = ("efc_J", "efc_bJ", "efc_aref", "efc_D", "efc_pos", "efc_margin", "efc_active")
PER_PAIR = {(2, 2): 1, (2, 6): 1, (6, 6): 8}  # contacts per sphere-sphere, sphere-box, box-box pair


def _pre_solve_jax(m, d):
    from ambersim_tpu.engine import collision, constraint, smooth

    d = collision.collision(m, smooth.fwd_position_smooth(m, d))
    return smooth.fwd_velocity(m, constraint.make_constraint(m, d))


def _pre_solve_torch(m, d):
    from ambersim_tpu_torch.engine import collision, constraint, smooth

    d = collision.collision(m, smooth.fwd_position_smooth(m, d))
    return smooth.fwd_velocity(m, constraint.make_constraint(m, d))


@pytest.fixture(scope="module", params=[0, 84], ids=["cap6", "cap6_rowcap84"])
def case(request, tmp_path_factory):
    torch.set_num_threads(1)
    jm, tm = tp.export_small_clutter(tmp_path_factory.mktemp("caps"), CAP, request.param)
    qpos, qvel = tp.free_body_state(jm, 4, seed=11)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(jax.vmap(lambda d: _pre_solve_jax(jm, d)))(jd)
    got = _pre_solve_torch(tm, tp.torch_batch(tm, jd))
    return request.param, jm, tm, ref, got


@pytest.mark.parametrize("field", CONTACT_FIELDS)
def test_contact_field_matches_jax(case, field):
    *_, ref, got = case
    tp.assert_close("contact." + field, getattr(got.contact, field), getattr(ref.contact, field), RTOL, ATOL)


@pytest.mark.parametrize("field", EFC_FIELDS)
def test_efc_field_matches_jax(case, field):
    *_, ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, AREF_ATOL if field == "efc_aref" else ATOL)


def test_capped_groups_are_exercised(case):
    """Every object-object group is capped and has an active contact in
    every env; the geom pairs differ between envs; the row cap keeps empty
    slots at the tie."""
    mcp, _, tm, _, got = case
    s = tm.skel
    assert sorted(zip(np.asarray(s.bpg_type1).tolist(), np.asarray(s.bpg_type2).tolist())) == sorted(PER_PAIR)
    assert (s.nv, s.ncand) == (72, 90) and s.ncon == (mcp or 90)
    c = got.contact
    active = (c.dist < c.includemargin).numpy()
    types = np.asarray(s.geom_type)
    t1, t2 = types[c.geom1.numpy()], types[c.geom2.numpy()]
    for pair in PER_PAIR:
        in_group = (t1 == pair[0]) & (t2 == pair[1])
        assert (active & in_group).any(axis=1).all(), pair
    pairs = c.geom1.numpy() * 100 + c.geom2.numpy()
    assert any(set(pairs[0]) != set(p) for p in pairs[1:])
    if mcp:
        assert (c.dist.numpy() >= BIG / 2).any(axis=1).all()  # tied empty slots kept


def test_pyramid_structure_mirrors_jax(case):
    """The factored row layout is structural (rows [N+U1, N-U1, N+U2, N-U2]
    per contact slot, whichever geoms fill it), and both packages build it
    for the capped skeletons."""
    from ambersim_tpu.engine.constraint import _pyramid_structure as jax_structure
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    _, jm, tm, _, got = case
    got_st, want = _pyramid_structure(tm.skel), jax_structure(jm.skel)
    assert want is not None and got_st._fields == want._fields
    for k in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got_st, k)), np.asarray(getattr(want, k)), k)
    assert got.efc_bJ.shape[1] == 3 * tm.skel.ncon


@pytest.mark.parametrize("row_cap", [False, True], ids=["broadphase", "broadphase_rowcap"])
def test_selection_is_exact_past_256_geoms(row_cap):
    """Geom ids above 256 and contact distances come through the broadphase
    top-k and the row cap bit for bit (the selections are gathers, not
    one-hot products)."""
    from chip_smoke import check_selection_exact

    torch.set_num_threads(1)
    check_selection_exact(torch.device("cpu"), row_cap)


def test_top_k_breaks_ties_as_lax_top_k():
    from ambersim_tpu_torch.engine.collision import _top_k

    rng = np.random.default_rng(12)
    x = rng.integers(-3, 3, (5, 40)).astype(np.float32)
    x[:, 20:] = -BIG
    want = np.asarray(jax.lax.top_k(x, 30)[1])
    np.testing.assert_array_equal(_top_k(torch.as_tensor(x), 30).numpy(), want)
