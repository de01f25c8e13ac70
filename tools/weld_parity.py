"""Fixtures, bars and checks shared by the tests that hold the port's welds,
connects, ball limits, actuator transmissions and explicit contact pairs
against the JAX package on the CPU.

Three families, each a dict of XML fixtures, a `*_case` function that
compiles both packages' models and the JAX reference once per process, and
the assertions its test files call:

- equality rows and ball limits (`WELD_XMLS`): tests/test_torch_weld.py,
  test_torch_mocap_weld.py and test_torch_hand_weld.py;
- explicit pairs and the OVERRIDE flag (`PAIR_XMLS`): test_torch_pairs.py,
  test_torch_override.py and test_torch_capped_pair.py;
- transmissions (`TRN_FIXTURES`): test_torch_transmissions.py and
  test_torch_refsite_adhesion.py.

Each family is split over files so that each file's fixtures (a JAX step
compile of 5-15 s apiece) stay one test worker's short job. Like
tools.torch_parity, this imports both frameworks; XML constants of the JAX
package's tests are read as text (chip_smoke.tests_xml).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

import chip_smoke
from tools import torch_parity as tp

# ---- bars ----
RTOL = ATOL = 1e-5  # efc rows (tests/test_torch_constraint.py)
AREF_ATOL = 3e-4
FORCE_TOL = (1e-4, 1e-4)  # qacc and qfrc_constraint; actuator forces and the moment matrix
EFC_FIELDS = ("efc_J", "efc_bJ", "efc_dsc", "efc_pos", "efc_margin", "efc_aref", "efc_D", "efc_active")
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
CONTACT_TOL = (1e-5, 1e-6)  # contact geometry; actuator lengths and velocities
QACC_REL = 1e-4  # the pairs' qacc, of each env's largest |qacc|
B, STEPS = 4, 20


def np_batch(jm, **fields):
    """tools.torch_parity.jax_batch with numpy leaves: make_data's Data
    broadcast to the (B, ...) fields' batch without an eager JAX op per
    leaf (the jitted steps take numpy)."""
    from ambersim_tpu.engine import make_data

    n = next(iter(fields.values())).shape[0]
    d = jax.tree.map(lambda x: np.broadcast_to(np.asarray(x), (n,) + np.shape(x)), make_data(jm))
    return d.replace(**fields)


def _rollout(tm, jstep, jd, steps: int) -> None:
    """`steps` steps of both packages from the same Data: finite, qpos
    within QPOS_ATOL and qvel within QVEL_ATOL."""
    from ambersim_tpu_torch.engine import step

    d = tp.torch_batch(tm, jd)
    for _ in range(steps):
        jd = jstep(jd)
        d = step(tm, d)
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
    tp.assert_close("qpos", d.qpos, jd.qpos, 0.0, QPOS_ATOL)
    tp.assert_close("qvel", d.qvel, jd.qvel, 0.0, QVEL_ATOL)


def _efc_rows(got, ref) -> None:
    for field in EFC_FIELDS:
        tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, AREF_ATOL if field == "efc_aref" else ATOL)


# ---- connect and weld rows, ball limits ----
MOCAP_WELD = chip_smoke.tests_xml("test_mocap.py", "MOCAP_WELD")
# the box starts resting on a floor 5 cm under its centre (chip_smoke's mocap_drag)
MOCAP_DRAG = MOCAP_WELD.replace("<worldbody>", '<worldbody>\n  <geom name="floor" type="plane" size="0 0 1" '
                                               'pos="0 0 0.45"/>', 1)
# the hand's four joint mimics plus a weld between two fingertips (test_torch_bridge.HAND_WELD_XML)
HAND_WELD_XML = (chip_smoke.REPO / "ambersim_tpu" / "models" / "hand" / "hand.xml").read_text().replace(
    "</equality>", '<weld body1="f1_dist_link" body2="f2_dist_link"/></equality>')
WELD_XMLS = {
    "connect_swing": chip_smoke.tests_xml("test_constraint_parity.py", "CONNECT_SWING"),
    "weld_pair": chip_smoke.tests_xml("test_constraint_parity.py", "WELD_PAIR"),
    "mocap_weld": MOCAP_WELD,
    "mocap_drag": MOCAP_DRAG,
    "ball_limited": chip_smoke.tests_xml("test_constraint_parity.py", "BALL_LIMITED"),
    "hand_weld": HAND_WELD_XML,
}
# (ne, nd_eq of the structured layout or None where the rows take the dense kernel, ncon3)
WELD_LAYOUT = {
    "connect_swing": (3, 3, 1), "weld_pair": (6, 6, 1), "mocap_weld": (6, None, 0), "mocap_drag": (6, 6, 4),
    "ball_limited": (0, None, 0), "hand_weld": (10, 10, None),
}
_WELD_CASES: dict = {}


def weld_case(name):
    """(JAX model, port model, the JAX package's jitted vmapped step) at
    chip_smoke.CONVERGED options, built once per process. A step's output
    Data holds the forward of its input."""
    from ambersim_tpu.engine import step

    if name not in _WELD_CASES:
        jm = tp.with_solver(tp.jax_model_from_xml(WELD_XMLS[name]), **chip_smoke.CONVERGED)
        _WELD_CASES[name] = jm, tp.torch_model(jm), jax.jit(jax.vmap(lambda d: step(jm, d)))
    return _WELD_CASES[name]


def weld_start(name, jm):
    """Seeded starts whose rows are active: qpos0 + 0.1 N(0, 1) (the hand's
    fingers over their ranges, the ball past its 30-degree limit on some
    envs), qvel 0.5 N(0, 1); the mocap targets (0.25, 0.1, 0.6) + 0.05
    N(0, I) for the weld, ((0.25, 0.1) + 0.05 N(0, I), 0.5) for the drag,
    whose box starts at rest on the floor."""
    rng = np.random.default_rng(list(WELD_XMLS).index(name))
    s = jm.skel
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    qvel = np.zeros((B, s.nv), np.float32)
    fields = {}
    if name.startswith("mocap"):
        target = np.array([0.25, 0.1, 0.6 if name == "mocap_weld" else 0.5], np.float32)
        noise = 0.05 * rng.standard_normal((B, 3)).astype(np.float32)
        if name == "mocap_drag":
            noise[:, 2] = 0.0
        fields["mocap_pos"] = (target + noise)[:, None, :]
    else:
        qpos += 0.1 * rng.standard_normal(qpos.shape).astype(np.float32)
        qvel += 0.5 * rng.standard_normal(qvel.shape).astype(np.float32)
    if name == "ball_limited":
        qpos[:, :4] = np.array([0.95, 0.25, 0.15, 0.1], np.float32) + 0.1 * rng.standard_normal((B, 4)).astype(
            np.float32)
        qpos[:, :4] /= np.linalg.norm(qpos[:, :4], axis=1, keepdims=True)
    return np_batch(jm, qpos=qpos, qvel=qvel, **fields)


def assert_weld_rows(name):
    """One forward from the same Data: the efc rows field by field, qacc and
    qfrc_constraint within FORCE_TOL, the structured layout of the contact
    models."""
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.forward import forward

    jm, tm, jstep = weld_case(name)
    jd = weld_start(name, jm)
    ref = jstep(jd)
    got = forward(tm, tp.torch_batch(tm, jd))
    _efc_rows(got, ref)
    for field in ("qacc", "qfrc_constraint"):
        tp.assert_close(field, getattr(got, field), getattr(ref, field), *FORCE_TOL)
    ne, nd_eq, ncon3 = WELD_LAYOUT[name]
    assert tm.skel.ne == ne
    st = _pyramid_structure(tm.skel)
    if nd_eq is None:
        assert st is None
    else:
        assert st is not None and st.nd_eq == nd_eq and (ncon3 is None or st.ncon3 == ncon3)
    assert got.efc_active[:, :ne].all()  # the equality rows
    if name == "ball_limited":
        assert got.efc_active[:, 0].any() and torch.isfinite(got.efc_J).all()


def assert_weld_rollout(name, steps=STEPS):
    jm, tm, jstep = weld_case(name)
    _rollout(tm, jstep, weld_start(name, jm), steps)


# ---- explicit pairs and the OVERRIDE flag ----
OVERRIDE_SCENE = chip_smoke.tests_xml("test_flags.py", "OVERRIDE_SCENE")
EXPLICIT_PAIR_XML = chip_smoke.tests_xml("test_torch_bridge.py", "EXPLICIT_PAIR_XML")
HFIELD_PAIR_XML = chip_smoke.tests_xml("test_torch_bridge.py", "HFIELD_SPHERE_XML").replace(
    "</mujoco>", '<contact><pair geom1="hf" geom2="s" friction="0.4 0.4 0.01 0.001 0.001" solref="0.01 0.8" '
                 'solimp="0.8 0.9 0.002 0.5 2" margin="0.01" gap="0.004"/></contact></mujoco>')
CAPPED_PAIR_XML = """
<mujoco><option timestep="0.002"/><worldbody>
  <geom name="floor" type="plane" size="0 0 1"/>
  <default><geom contype="2" conaffinity="1"/></default>
  <body pos="0 0 0.049"><freejoint/><geom type="sphere" size="0.05"/></body>
  <body pos="0.3 0 0.2"><freejoint/><geom type="sphere" size="0.05"/></body>
  <body pos="0.6 0 0.4"><freejoint/><geom name="high" type="sphere" size="0.05"/></body>
</worldbody>
<contact><pair geom1="floor" geom2="high" margin="0.5" friction="0.2 0.2 0.005 0.0001 0.0001"/></contact>
</mujoco>
"""
CAPPED_PAIR_CAP = 2
PAIR_XMLS = {
    "explicit_pair": EXPLICIT_PAIR_XML,
    "hfield_pair": HFIELD_PAIR_XML,
    "override_on": OVERRIDE_SCENE.format(flag='override="enable"'),
    "override_off": OVERRIDE_SCENE.format(flag='energy="enable"'),
    "capped_pair": CAPPED_PAIR_XML,
}
CONTACT_EXACT = ("friction", "solref", "solimp", "includemargin", "gap", "geom1", "geom2")
_PAIR_CASES: dict = {}


def _pair_jax_model(name):
    from ambersim_tpu.engine.setconst import set_constants
    from ambersim_tpu.mjcf import compile_spec
    from ambersim_tpu.mjcf.parser import parse_mjcf_string

    cap = CAPPED_PAIR_CAP if name == "capped_pair" else 0
    jm = set_constants(compile_spec(parse_mjcf_string(PAIR_XMLS[name]), broadphase_cap=cap))
    if name == "hfield_pair":
        jm = jm.replace(hfield_data=np.linspace(0.0, 1.0, 81, dtype=np.float32).reshape(1, 9, 9))
    return tp.with_solver(jm, **chip_smoke.CONVERGED)


def pair_case(name):
    """(JAX model, port model, the JAX package's jitted vmapped step, the
    start: qpos0 with the free bodies moved 2 mm sideways and tilted by
    seeded noise, qvel 0.1 N(0, 1)), built once per process."""
    from ambersim_tpu.engine import step

    if name not in _PAIR_CASES:
        jm = _pair_jax_model(name)
        s = jm.skel
        rng = np.random.default_rng(list(PAIR_XMLS).index(name))
        qpos = np.tile(np.asarray(jm.qpos0, np.float64), (B, 1))
        for a in range(0, s.nq, 7):  # every body is free: 3 positions, a quaternion
            qpos[:, a : a + 2] += 0.002 * rng.standard_normal((B, 2))
            qpos[:, a + 3 : a + 7] += 0.02 * rng.standard_normal((B, 4))
            qpos[:, a + 3 : a + 7] /= np.linalg.norm(qpos[:, a + 3 : a + 7], axis=1, keepdims=True)
        if name == "hfield_pair":
            qpos[:, 2] = 0.228  # the ball ~2 mm into the field, whose surface is at 0.15 under its centre
        qvel = 0.1 * rng.standard_normal((B, s.nv))
        jd = np_batch(jm, qpos=qpos.astype(np.float32), qvel=qvel.astype(np.float32))
        _PAIR_CASES[name] = jm, tp.torch_model(jm), jax.jit(jax.vmap(lambda d: step(jm, d))), jd
    return _PAIR_CASES[name]


def assert_pair_contacts(name):
    """One forward from the same Data: the contacts' parameters and geoms
    bit for bit, dist, pos and frame within CONTACT_TOL, the efc rows, qacc
    within QACC_REL of each env's largest |qacc|, some row active on every
    env."""
    from ambersim_tpu_torch.engine.forward import forward

    jm, tm, jstep, jd = pair_case(name)
    ref = jstep(jd)
    got = forward(tm, tp.torch_batch(tm, jd))
    for field in CONTACT_EXACT:
        tp.assert_close(f"contact.{field}", getattr(got.contact, field), getattr(ref.contact, field), 0.0, 0.0)
    for field in ("dist", "pos", "frame"):
        tp.assert_close(f"contact.{field}", getattr(got.contact, field), getattr(ref.contact, field), *CONTACT_TOL)
    _efc_rows(got, ref)
    # the solve's output, at 1e-4 of each env's largest |qacc|: the two
    # overlapping spheres and the deep capped contact give accelerations of
    # 40-160 whose smaller components carry that much float32 rounding
    want = np.asarray(ref.qacc)
    err = np.abs(got.qacc.numpy() - want) / np.abs(want).max(-1, keepdims=True)
    assert err.max() <= QACC_REL, f"qacc: {err.max():.3e} of the env's largest |qacc|"
    assert got.efc_active.any(-1).all()


def assert_pair_rollout(name):
    _, tm, jstep, jd = pair_case(name)
    _rollout(tm, jstep, jd, STEPS)


def assert_pair_parameters(name):
    """The pair's (or the Option's) parameters are the contact's: the
    explicit pair's friction on its slot, the height field's five
    parameters, o_* under the flag with gap 0 and the geoms' own without
    it, and the capped group's selection holding the high sphere."""
    from ambersim_tpu_torch.engine import smooth
    from ambersim_tpu_torch.engine.collision import collision

    _, tm, _, jd = pair_case(name)
    d = collision(tm, smooth.fwd_position_smooth(tm, tp.torch_batch(tm, jd)))
    c = d.contact
    o = tm.opt
    if name == "explicit_pair":
        # slots: floor-a, floor-b, then the pair a-b
        assert torch.allclose(c.friction[:, -1], torch.tensor([0.3, 0.3, 0.005, 0.0001, 0.0001]))
        assert (c.friction[:, 0, 0] == 1.0).all()
    elif name == "hfield_pair":
        assert torch.allclose(c.friction, torch.tensor([0.4, 0.4, 0.01, 0.001, 0.001]))
        assert torch.allclose(c.solref, torch.tensor([0.01, 0.8])) and torch.allclose(c.solimp[..., 0], torch.tensor(0.8))
        assert (c.includemargin == 0.01).all() and (c.gap == 0.004).all()
    elif name == "override_on":
        assert torch.equal(c.friction, o.o_friction.expand_as(c.friction))
        assert torch.equal(c.solref, o.o_solref.expand_as(c.solref))
        assert (c.includemargin == o.o_margin).all() and (c.gap == 0).all()
    elif name == "override_off":
        assert (c.friction[..., 0] == 1.0).all() and (c.includemargin == 0.001).all() and (c.gap == 0.0005).all()
    else:
        high = 3  # the floor is geom 0, the spheres 1-3
        assert (c.geom2 == high).any(1).all()  # selected on every env, by its pair margin
        slot = (c.geom2 == high).int().argmax(1)
        take = torch.arange(B)
        assert (c.includemargin[take, slot] == 0.5).all() and (c.friction[take, slot, 0] == 0.2).all()
        assert (c.dist[take, slot] < c.includemargin[take, slot]).all()


# ---- actuator transmissions ----
def _unit(q):
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


# tests/test_trn_extra.py's QPOS (ball quat, crank hinge, slider, free joint) and CTRL
TRN_QPOS = np.concatenate([_unit([0.9, 0.2, -0.3, 0.25]), [0.6, 0.1], [-1.1, 0.2, 1.4],
                           _unit([0.8, -0.1, 0.55, 0.2])])
TRN_CTRL = [0.3, -0.7, 0.9, 0.5, -0.2]
# name -> (XML, env 0's qpos (None: qpos0), qvel, ctrl, the quaternion blocks' qpos addresses);
# test_trn_extra's first rod shortened from 0.35 to 0.15, so that its broken-rod state breaks it
TRN_FIXTURES = {
    "trn_extra": (chip_smoke.tests_xml("test_trn_extra.py", "XML").replace('cranklength="0.35"', 'cranklength="0.15"'),
                  TRN_QPOS, None, TRN_CTRL, (0, 9)),
    "thruster": (chip_smoke.tests_xml("test_muscle.py", "THRUSTER_RIG"), [0, 0, 1, *_unit([0.9, 0.3, 0.2, 0.1])],
                 [0.2, -0.1, 0.3, 0.5, -0.2, 0.1], [5.0, 3.0], (3,)),
    "refsite_arm": (chip_smoke.tests_xml("test_refsite.py", "ARM_XML"), [0.5, -0.7, 0.9], [0.3, -0.2, 0.1],
                    [0.2, -0.1, 0.3], ()),
    "adhesion_box": (chip_smoke.tests_xml("test_adhesion.py", "BOX_XML"), None, None, [0.7], (3,)),
    "adhesion_gap": (chip_smoke.tests_xml("test_adhesion.py", "GAP_XML"), None, None, [1.0], (3,)),
    "ball_body": (chip_smoke.tests_xml("test_ilqr.py", "BALL_BODY", folder="tests/trajopt"), _unit([0.9, 0.3, 0.3, 0.1]),
                  [0.2, -0.1, 0.4], [0.5, -0.3, 0.8], (0,)),
}
_TRN_CASES: dict = {}


def _adhesive(m) -> bool:
    from ambersim_tpu_torch.core.types import TrnType

    return bool((np.asarray(m.skel.actuator_trntype) == int(TrnType.BODY)).any())


def _jax_stages(jm):
    """The JAX package's smooth position stage (and collision where an
    adhesion actuator reads the contacts), velocity and actuation stages
    and its moment matrix, jitted over a batch."""
    from ambersim_tpu.engine import smooth
    from ambersim_tpu.engine.collision import collision

    def run(d):
        d = smooth.fwd_position_smooth(jm, d)
        if _adhesive(jm):
            d = collision(jm, d)
        d = smooth.fwd_actuation(jm, smooth.fwd_velocity(jm, d))
        return d, smooth.actuator_moment(jm, d)

    return jax.jit(jax.vmap(run))


def _port_stages(tm, d):
    """The port's counterpart of `_jax_stages` (without the moment)."""
    from ambersim_tpu_torch.engine import smooth
    from ambersim_tpu_torch.engine.collision import collision

    d = smooth.fwd_position_smooth(tm, d)
    if _adhesive(tm):
        d = collision(tm, d)
    return smooth.fwd_actuation(tm, smooth.fwd_velocity(tm, d))


def trn_case(name):
    """(JAX model, port model, the JAX stages' outputs, the batch), built
    once per process. The fixture's own state is env 0 of B; the other envs
    move it by seeded noise (an adhesion box only sideways and by a few
    mrad of tilt, so that it stays in contact); env 1 of trn_extra has the
    crank at 2.2 rad (test_trn_extra.py's broken rod)."""
    if name not in _TRN_CASES:
        xml, qpos0, qvel0, ctrl0, quats = TRN_FIXTURES[name]
        jm = tp.jax_model_from_xml(xml)
        s = jm.skel
        rng = np.random.default_rng(list(TRN_FIXTURES).index(name))
        qpos = np.tile(np.asarray(jm.qpos0 if qpos0 is None else qpos0, np.float64), (B, 1))
        noise = 0.1 * rng.standard_normal((B - 1, s.nq))
        if name.startswith("adhesion"):
            noise[:, 2], noise[:, 3:] = 0.0, 0.05 * noise[:, 3:]  # the box's height kept, a tilt of ~5 mrad
        qpos[1:] += noise
        if name == "trn_extra":
            qpos[1, 4] = 2.2  # tests/test_trn_extra.py:test_slidercrank_broken_rod
        for a in quats:
            qpos[:, a : a + 4] /= np.linalg.norm(qpos[:, a : a + 4], axis=1, keepdims=True)
        qvel = np.tile(np.zeros(s.nv) if qvel0 is None else np.asarray(qvel0, np.float64), (B, 1))
        qvel[1:] += 0.3 * rng.standard_normal((B - 1, s.nv))
        ctrl = np.tile(np.asarray(ctrl0, np.float64), (B, 1))
        ctrl[1:] += 0.2 * rng.standard_normal((B - 1, s.nu))
        jd = np_batch(jm, qpos=qpos.astype(np.float32), qvel=qvel.astype(np.float32), ctrl=ctrl.astype(np.float32))
        _TRN_CASES[name] = jm, tp.torch_model(jm), _jax_stages(jm)(jd), jd
    return _TRN_CASES[name]


def assert_transmissions(name):
    """One pass of both packages' stages from the same Data: actuator
    lengths and velocities within CONTACT_TOL, actuator forces,
    qfrc_actuator and the moment matrix within FORCE_TOL; every actuator
    moves a dof."""
    from ambersim_tpu_torch.engine import smooth

    _, tm, (ref, ref_moment), jd = trn_case(name)
    d = _port_stages(tm, tp.torch_batch(tm, jd))
    for field in ("actuator_length", "actuator_velocity"):
        tp.assert_close(field, getattr(d, field), getattr(ref, field), *CONTACT_TOL)
    for field in ("actuator_force", "qfrc_actuator"):
        tp.assert_close(field, getattr(d, field), getattr(ref, field), *FORCE_TOL)
    moment = smooth.actuator_moment(tm, d)
    tp.assert_close("actuator_moment", moment, ref_moment, *FORCE_TOL)
    assert (moment.abs().sum(-1) > 0).all()
    if name.startswith("adhesion"):
        assert (d.qfrc_actuator[:, 2] < 0.0).all()  # pulls the box to the floor


def assert_acc0(name):
    """actuator_acc0 from the port's own compile and set_constants against
    the JAX package's, within chip_smoke.setconst_rtol (an adhesion
    actuator's is 0 in both: make_data's contact is empty at qpos0)."""
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.mjcf import compile_spec_arrays, parse_mjcf_string

    jm = trn_case(name)[0]
    skel, leaves = compile_spec_arrays(parse_mjcf_string(TRN_FIXTURES[name][0]))
    got = set_constants(skel, leaves)["actuator_acc0"]
    want = np.asarray(jm.actuator_acc0)
    np.testing.assert_allclose(got, want, rtol=chip_smoke.setconst_rtol(skel, leaves), atol=0.0)
    assert (got > 0).all() or name.startswith("adhesion")
