"""Joint equality rows of the PyTorch port against the JAX package (CPU), on
the Barrett-class hand (models/hand/hand.xml: four EqType.JOINT mimic
couplings, damped hinges, capsule and sphere fingers on a box palm).

Numpy-seeded hand states, fingers spread over their joint ranges so that
limits, equality rows and finger contacts turn on, go through both
packages' smooth -> collision -> make_constraint, with contacts on, with
DisableBit.CONTACT and with DisableBit.EQUALITY; the efc rows agree field by
field at tests/test_torch_constraint.py's bars. Then 20 steps of the hand
under a constant ctrl, at its own options and at the predictive-sampling
workload's (BASELINE.md:13: Newton 1 x 4 iterations, contacts disabled),
against the JAX package's rollout at the main path's rollout bars (qpos
atol 1e-4, qvel atol 1e-3). Connect and weld rows on a two-link chain
(once refused by name) against the JAX package's; the rest of them are
tests/test_torch_weld.py's, tendon equality rows tests/test_torch_tendon.py's.
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

RTOL = ATOL = 1e-5
# tests/test_torch_constraint.py's bars: aref, 4 f32 ulps of a contact
# distance times k*imp; D, one ulp of a contact distance through the
# impedance sigmoid (solimp width 1e-3) and 1 / (1 - imp)
AREF_ATOL, D_RTOL = 3e-4, 1e-4
B, STEPS = 8, 20
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
EFC_FIELDS = ("efc_J", "efc_pos", "efc_aref", "efc_D", "efc_active")
FLAGS = {"contacts_on": 0, "contacts_off": 1 << 4, "equality_off": 1 << 1}  # DisableBit.CONTACT, .EQUALITY
TRAJOPT = dict(iterations=1, ls_iterations=4)


def hand_state(jm, batch: int, seed: int):
    """qpos uniform over [-0.05, 0.9] of each joint's range (the lower
    limit is 0 for every joint: a joint below it starts on its limit row),
    qvel 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    hi = np.asarray(jm.jnt_range, np.float32)[:, 1]
    qpos = (rng.uniform(-0.05, 0.9, (batch, jm.skel.nq)) * hi).astype(np.float32)
    return qpos, (0.5 * rng.standard_normal((batch, jm.skel.nv))).astype(np.float32)


def _flagged(m, flags):
    return m.replace(opt=m.opt.replace(disableflags=m.opt.disableflags | flags))


@pytest.fixture(scope="module")
def hand():
    torch.set_num_threads(1)
    jm = tp.jax_asset_model("hand")
    return jm, tp.torch_model(jm)


@pytest.fixture(scope="module")
def rows(hand):
    from ambersim_tpu.engine.forward import fwd_position as jax_fwd_position
    from ambersim_tpu_torch.engine.forward import fwd_position

    jm, tm = hand
    qpos, qvel = hand_state(jm, B, seed=11)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    out = {}
    for name, flags in FLAGS.items():
        jmf = _flagged(jm, flags)
        ref = jax.jit(jax.vmap(lambda d, jmf=jmf: jax_fwd_position(jmf, d)))(jd)
        out[name] = ref, fwd_position(_flagged(tm, flags), tp.torch_batch(tm, jd))
    return out


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("field", EFC_FIELDS)
def test_hand_rows_match_jax(rows, flags, field):
    ref, got = rows[flags]
    atol = AREF_ATOL if field == "efc_aref" else ATOL
    rtol = D_RTOL if field == "efc_D" else RTOL
    tp.assert_close(f"{field} ({flags})", getattr(got, field), getattr(ref, field), rtol, atol)


def test_hand_rows_reach_every_family(hand, rows):
    """The four equality rows come first, carry J = e_dof1 - 0.344 e_dof2
    (1 and -1 for the spread mimic) at the start, are active unless
    DisableBit.EQUALITY is set, and the states reach limits and contacts."""
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    jm, tm = hand
    s = tm.skel
    st = _pyramid_structure(s)
    assert (s.neq, st.nd_eq, st.ndiag, st.ncon3, s.nefc) == (4, 4, 8, 48, 204)
    _, on = rows["contacts_on"]
    act = on.efc_active.numpy()
    assert act[:, :4].all() and not rows["equality_off"][1].efc_active[:, :4].any()
    assert act[:, 4:12].any() and act[:, 12:].any()  # limits, contacts
    assert not rows["contacts_off"][1].efc_active[:, 12:].any()
    J = on.efc_J.numpy()[:, :4]
    da1, da2 = s.jnt_dofadr[s.eq_obj1id], s.jnt_dofadr[s.eq_obj2id]
    np.testing.assert_array_equal(J[:, np.arange(4), da1], 1.0)
    np.testing.assert_allclose(J[:, np.arange(4), da2], np.broadcast_to(-np.asarray(jm.eq_data)[:, 1], (B, 4)), rtol=1e-6)


@pytest.fixture(scope="module", params=["own_options", "trajopt_options"])
def rollout_case(request, hand):
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import rollout

    jm, tm = hand
    if request.param == "trajopt_options":
        jm, tm = (_flagged(m.replace(opt=m.opt.replace(**TRAJOPT)), FLAGS["contacts_off"]) for m in (jm, tm))
    qpos, qvel = hand_state(jm, B, seed=12)
    ctrl = np.random.default_rng(13).uniform(-2.0, 2.0, (B, jm.skel.nu)).astype(np.float32)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl)
    ref = jax.jit(lambda d: jax_rollout(jm, d, STEPS, batched=True))(jd)
    got = rollout(tm, tp.torch_batch(tm, jd), STEPS)
    return ref, got


@pytest.mark.parametrize("field, atol", [("qpos", QPOS_ATOL), ("qvel", QVEL_ATOL)])
def test_hand_rollout_matches_jax(rollout_case, field, atol):
    ref, got = rollout_case
    assert torch.isfinite(getattr(got, field)).all()
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


EQ_XML = """
<mujoco><worldbody>
  <body name="a"><joint name="ja" axis="0 1 0"/><geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"/>
    <body name="b" pos="0 0 -0.3"><joint name="jb" axis="0 1 0"/><geom type="sphere" size="0.03"/></body>
  </body>
</worldbody>
{extra}
</mujoco>
"""
UNPORTED_EQ = {
    "connect": '<equality><connect body1="a" body2="b" anchor="0 0 -0.3"/></equality>',
    "weld": '<equality><weld body1="a" body2="b"/></equality>',
}


@pytest.mark.parametrize("kind", list(UNPORTED_EQ))
def test_unported_equality_types_are_refused(kind):
    """Connect and weld rows, once refused by name, now load through the
    bridge; their rows from the same Data match the JAX package's."""
    from ambersim_tpu.engine.forward import fwd_position as jax_fwd_position
    from ambersim_tpu_torch.engine.forward import fwd_position

    jm = tp.jax_model_from_xml(EQ_XML.format(extra=UNPORTED_EQ[kind]))
    tm = tp.torch_model(jm)
    qpos, qvel = tp.random_state(jm, 4, seed=11, qpos_scale=0.3, qvel_scale=0.5)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(jax.vmap(lambda d: jax_fwd_position(jm, d)))(jd)
    got = fwd_position(tm, tp.torch_batch(tm, jd))
    assert tm.skel.nefc == {"connect": 3, "weld": 6}[kind]
    for field in ("efc_J", "efc_pos", "efc_D", "efc_active"):
        tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, ATOL)
    tp.assert_close("efc_aref", got.efc_aref, ref.efc_aref, RTOL, AREF_ATOL)


# a one-joint row (obj2id < 0: pos = q - q0 - c0) and a two-joint row with
# every quartic coefficient set, which the hand's linear mimics leave at 0
QUARTIC_XML = EQ_XML.format(extra='<equality><joint joint1="jb" polycoef="0.1 0 0 0 0"/>'
                                  '<joint joint1="ja" joint2="jb" polycoef="0.05 0.5 0.3 -0.2 0.1"/></equality>')


def test_one_joint_and_quartic_rows_match_jax():
    from ambersim_tpu.engine.forward import fwd_position as jax_fwd_position
    from ambersim_tpu_torch.engine.forward import fwd_position

    jm = tp.jax_model_from_xml(QUARTIC_XML)
    tm = tp.torch_model(jm)
    assert list(np.asarray(jm.skel.eq_obj2id)) == [-1, 1]
    qpos, qvel = tp.random_state(jm, B, seed=14, qpos_scale=0.6)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(jax.vmap(lambda d: jax_fwd_position(jm, d)))(jd)
    got = fwd_position(tm, tp.torch_batch(tm, jd))
    for field in EFC_FIELDS:
        atol = AREF_ATOL if field == "efc_aref" else ATOL
        tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, atol)
    assert got.efc_active[:, :2].all()
