"""The port's contact-driven sensors and the geom-distance trio against the
JAX package's (CPU): touch, force, torque, accelerometer and the joint-limit
rows on tests/test_sensors.py's CONTACT_RIG (a brick resting on the floor,
a pendulum on its limit); the <contact> sensor's reduce modes (none,
mindist, maxforce, netforce), found counts, site filter, subtree and
one-sided matching on tests/test_contact_sensor.py's three fixtures
(SLIDE_RIG, a sliding and spinning sphere with condim-6 friction, BOX_RIG,
SUBTREE_RIG), with pyramidal and elliptic cones; the shared intermediates (cacc, the contact
wrenches and world forces, cfrc_int); and <distance>, <normal>, <fromto> on
tests/test_distance_sensors.py's pairs and cutoffs, with
collision.geom_pair_distance itself.

The JAX package steps each fixture to its contacts; the port then runs one
forward from that identical Data, and the JAX package's next step (whose
sensordata is that forward's) gives the reference. Each sensor row is
compared by its sensor_adr / sensor_dim slice, position and velocity rows
within rtol 1e-5 / atol 1e-6, acceleration and force rows within rtol
1e-4 / atol 1e-4 (tests/test_torch_sensors.py's assert_rows). The sensor
module alone, fed the JAX package's post-forward Data, is held at the same
bars. A sphere's normal in a pair is the direction between two points dd
apart whose world coordinates round at ~1.2e-7 in either package, so the
normal rows are held at max(atol, NORMAL_ULPS / dd).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from test_contact_sensor import BOX_RIG, SLIDE_RIG, SUBTREE_RIG
from test_distance_sensors import BOX_B, CAP_A, CAP_B, SPHERE_A, SPHERE_B, _pair_xml
from test_sensors import CONTACT_RIG
from test_torch_sensors import TOL, assert_rows
from tools import torch_parity as tp

B = 4
NORMAL_ULPS = 4 * 1.2e-7


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def stepped(xml: str, steps: int, qvel=None):
    """(jm, tm, jd, after): the JAX package's Data after `steps - 1` steps of
    the fixture and after one more step, whose sensordata is the forward at
    jd."""
    from ambersim_tpu.engine import step

    jm = tp.jax_model_from_xml(xml)
    fields = {} if qvel is None else dict(qvel=np.asarray(qvel, np.float32))
    jd = tp.jax_batch(jm, **fields) if fields else tp.jax_batch(jm, qpos=np.tile(np.asarray(jm.qpos0), (B, 1)))
    f = jax.jit(jax.vmap(lambda d: step(jm, d)))
    for _ in range(steps - 1):
        jd = f(jd)
    return jm, tp.torch_model(jm), jd, f(jd)


def post_forward(tm, jd, after):
    """The port's Data of the JAX package's forward at jd: `after`'s derived
    fields (efc, contacts, cacc, sensordata) with jd's state."""
    return tp.torch_batch(tm, after).replace(**{k: torch.as_tensor(np.array(getattr(jd, k)))
                                               for k in ("qpos", "qvel", "act", "time")})


def tied_maxforce(jm, jd, after, got):
    """Where a maxforce <contact> sensor's two strongest contacts lie within
    the force bar of each other, the solver's rounding picks the winner
    (tests/test_contact_sensor.py compares this sensor loosely for the same
    reason): there the port's row must be one of the tied contacts' (force
    and pos of a geom1-only sensor, as BOX_RIG's), and it is then set to the
    JAX package's so that assert_rows holds the rest."""
    from ambersim_tpu.engine import sensor as jsensor
    from ambersim_tpu_torch.core.types import ObjType, SensorType

    s = jm.skel
    want = np.asarray(after.sensordata)
    for i in range(s.nsensor):
        prm = np.asarray(s.sensor_intprm[i])
        if int(s.sensor_type[i]) != int(SensorType.CONTACT) or int(prm[1]) != 2:
            continue
        assert int(s.sensor_objtype[i]) == int(ObjType.GEOM) and int(s.sensor_refid[i]) < 0 and int(prm[0]) == 18
        g, adr = int(s.sensor_objid[i]), int(s.sensor_adr[i])
        post = after.replace(qpos=jd.qpos, qvel=jd.qvel)
        wrench = np.asarray(jax.vmap(lambda dd: jsensor._contact_wrench(jm, dd))(post))
        g1, g2 = np.asarray(after.contact.geom1), np.asarray(after.contact.geom2)
        active = np.asarray(after.efc_active)[:, np.asarray(s.con_efcadr)]
        inorder, swapped = g1 == g, (g2 == g) & (g1 != g)
        matched = (inorder | swapped) & active
        fn = np.where(matched, wrench[..., 0], -np.inf)
        best = fn.max(-1, keepdims=True)
        tied = matched & (fn >= best - (1e-4 + 1e-4 * np.abs(best)))
        force = wrench[..., :3] * np.stack([np.ones_like(fn), np.ones_like(fn), np.where(swapped, -1.0, 1.0)], -1)
        cands = np.concatenate([force, np.asarray(after.contact.pos)], -1)  # (B, ncon, 6)
        for e in np.nonzero(tied.sum(-1) > 1)[0]:
            assert any(np.allclose(got[e, adr:adr + 6], c, rtol=1e-4, atol=1e-4) for c in cands[e, tied[e]]), \
                f"sensor {i} env {e}: not one of the tied contacts"
            got[e, adr:adr + 6] = want[e, adr:adr + 6]


def check_fixture(jm, tm, jd, after):
    from ambersim_tpu_torch.engine import sensor
    from ambersim_tpu_torch.engine.forward import forward

    got = forward(tm, tp.torch_batch(tm, jd)).sensordata.numpy()
    tied_maxforce(jm, jd, after, got)
    assert_rows(jm, got, after.sensordata, what="forward")
    assert_rows(jm, sensor.sensors(tm, post_forward(tm, jd, after)).sensordata, after.sensordata,
                what="sensors alone")


# the box sliding at 0.8, 0.6, 0.4 and 0.2 m/s (tests/test_contact_sensor.py
# slides it at 0.8)
BOX_QVEL = [[v, 0, 0, 0, 0, 0] for v in (0.8, 0.6, 0.4, 0.2)]
# the sphere sliding and spinning (tests/test_contact_sensor.py's
# [1, 0.4, 0, 0, 0, 3], 4 steps) and three variations: its condim-6 contact's
# torsional and rolling rows carry force
SLIDE_QVEL = [[1.0, 0.4, 0, 0, 0, 3.0], [0.5, -0.2, 0, 1.0, 0, -2.0], [0.2, 0.6, 0, 0, 2.0, 1.0],
              [0, 0, 0, 0, 0, 4.0]]
FIXTURES = {
    "slide_rig": lambda: stepped(SLIDE_RIG, 4, SLIDE_QVEL),
    "contact_rig": lambda: stepped(CONTACT_RIG, 60),
    "box_rig": lambda: stepped(BOX_RIG, 60, BOX_QVEL),
    "box_rig_elliptic": lambda: stepped(BOX_RIG.replace('<option timestep="0.002"/>',
                                                        '<option timestep="0.002" cone="elliptic"/>'), 60, BOX_QVEL),
    "subtree_rig": lambda: stepped(SUBTREE_RIG, 5),
}


@pytest.fixture(scope="module", params=list(FIXTURES))
def fixture(request):
    return FIXTURES[request.param]()


def test_contact_fixture_sensors(fixture):
    """Every sensor row of the fixture on one forward from identical Data,
    and the sensor module on the JAX package's post-forward Data; the
    contacts are there (a found count or a touch reading above zero)."""
    jm, tm, jd, after = fixture
    check_fixture(jm, tm, jd, after)
    assert np.asarray(after.sensordata)[:, 0].min() > 0


@pytest.fixture(scope="module")
def intermediates(fixture):
    """The JAX package's cacc, contact wrenches, world forces and cfrc_int on
    its post-forward Data (one jit), and that Data in the port's form."""
    from ambersim_tpu.engine import sensor as jsensor

    jm, tm, jd, after = fixture

    def parts(dd):
        dd = jsensor.rne_postconstraint(jm, dd)
        normal, force = jsensor._contact_forces_world(jm, dd)
        return dict(cacc=dd.cacc, wrench=jsensor._contact_wrench(jm, dd), normal=normal, world_force=force,
                    cfrc_int=jsensor._cfrc_int(jm, dd, normal, force))

    return jax.jit(jax.vmap(parts))(after.replace(qpos=jd.qpos, qvel=jd.qvel)), post_forward(tm, jd, after)


@pytest.mark.parametrize("part", ["cacc", "wrench", "world_force", "cfrc_int"])
def test_intermediates(fixture, intermediates, part):
    """rne_postconstraint's cacc, _contact_wrench, _contact_forces_world and
    _cfrc_int against the JAX package's on its post-forward Data."""
    from ambersim_tpu_torch.engine import sensor

    _, tm, _, _ = fixture
    want, d = intermediates
    d = sensor.rne_postconstraint(tm, d)
    wrench = sensor._contact_wrench(tm, d)
    normal, force = sensor._contact_forces_world(wrench, d)
    got = dict(cacc=d.cacc, wrench=wrench, world_force=force, cfrc_int=sensor._cfrc_int(tm, d, force))[part]
    if part == "world_force":
        tp.assert_close("normal force", normal, want["normal"], 1e-4, 1e-4)
    tp.assert_close(part, got, want[part], 1e-4, 1e-4)


# tests/test_distance_sensors.py's cases: (geom1, geom2, body b's pos,
# cutoff, dd's offset R: the normal joins points |dist + R| apart, R the
# sum of the sphere and capsule radii, the sphere's alone against a box)
DISTANCE_CASES = {
    "sphere_sphere": (SPHERE_A, SPHERE_B, "0.5 0.2 1.2", 2.0, 0.25),
    "sphere_sphere_penetrating": (SPHERE_A, SPHERE_B, "0.15 0.1 1.05", 2.0, 0.25),
    "sphere_box": (SPHERE_A, BOX_B, "0.4 0.1 1.1", 2.0, 0.1),
    "sphere_box_penetrating": (SPHERE_A, BOX_B, "0.12 0.05 1.02", 2.0, 0.1),
    "capsule_capsule": (CAP_A, CAP_B, "0.3 0.1 1.1", 2.0, 0.12),
    "sphere_capsule": (SPHERE_A, CAP_B, "0.35 -0.1 0.9", 2.0, 0.17),
    "beyond_cutoff": (SPHERE_A, SPHERE_B, "3 0 1", 1.0, 0.25),
    "zero_cutoff": (SPHERE_A, SPHERE_B, "0.2 0 1", 0.0, 0.25),
}


def kinematics_sensors(jm, tm, qpos):
    """(port, JAX) sensordata from kinematics alone (what the trio reads)."""
    from ambersim_tpu.engine import sensor as jsensor
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu_torch.engine import sensor, smooth

    jd = tp.jax_batch(jm, qpos=qpos.astype(np.float32))
    want = jax.jit(jax.vmap(lambda d: jsensor.sensors(jm, jsmooth.kinematics(jm, d))))(jd).sensordata
    got = sensor.sensors(tm, smooth.kinematics(tm, tp.torch_batch(tm, jd))).sensordata
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", list(DISTANCE_CASES))
def test_distance_pairs(case):
    """<distance>, <normal>, <fromto> of one pair, each env's bodies moved
    by 0.02 N(0, 1) (free joints' positions and quaternions)."""
    g1, g2, pos2, cutoff, core = DISTANCE_CASES[case]
    jm = tp.jax_model_from_xml(_pair_xml(g1, g2, pos2, cutoff=cutoff))
    tm = tp.torch_model(jm)
    rng = np.random.default_rng(21)
    qpos = np.asarray(jm.qpos0, np.float32) + 0.02 * rng.standard_normal((B, jm.skel.nq)).astype(np.float32)
    got, want = kinematics_sensors(jm, tm, qpos)
    dd = np.abs(want[:, :1] + core)
    assert (np.abs(got[:, 1:4] - want[:, 1:4]) <= np.maximum(TOL[1] + TOL[0] * np.abs(want[:, 1:4]),
                                                                 NORMAL_ULPS / dd)).all(), f"{case} normal"
    got[:, 1:4] = want[:, 1:4]
    assert_rows(jm, got, want, what=case)
    if case == "beyond_cutoff":
        assert np.all(want[:, 0] == 1.0) and not want[:, 1:].any()
    if case == "zero_cutoff":
        assert (want[:, 0] < 0).all()


BODY_PAIR_XML = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="a" pos="0 0 1">
      <joint type="free"/>
      <geom type="sphere" size="0.1" mass="1"/>
      <geom type="sphere" size="0.05" pos="0.3 0 0" mass="1"/>
    </body>
    <body name="b" pos="0.8 0 1">
      <joint type="free"/>
      <geom name="gb" type="sphere" size="0.1" mass="1"/>
      <geom type="box" size="0.05 0.05 0.05" pos="-0.2 0 0" mass="1"/>
    </body>
  </worldbody>
  <sensor>
    <distance body1="a" body2="b" cutoff="3"/>
    <distance geom1="floor" geom2="gb" cutoff="5"/>
    <normal geom1="floor" geom2="gb" cutoff="5"/>
    <fromto geom1="gb" geom2="floor" cutoff="5"/>
    <fromto body1="a" body2="b" cutoff="3"/>
  </sensor>
</mujoco>
"""


def test_distance_body_pairs_and_plane():
    """tests/test_distance_sensors.py's two-body attachment (the least of
    four geom pairs: sphere-sphere and sphere-box) and its plane pair (the
    plane's normal, well conditioned), in both geom orders."""
    jm = tp.jax_model_from_xml(BODY_PAIR_XML)
    tm = tp.torch_model(jm)
    rng = np.random.default_rng(22)
    qpos = np.asarray(jm.qpos0, np.float32) + 0.05 * rng.standard_normal((8, jm.skel.nq)).astype(np.float32)
    assert_rows(jm, *kinematics_sensors(jm, tm, qpos))


def test_geom_pair_distance_matches_jax():
    """collision.geom_pair_distance, batched over envs and over every pair
    of chip_smoke.DISTANCE_RIG's geoms in both orders at once, against the
    JAX function pair by pair: the distance everywhere; the closest points
    where the narrowphase gives one point; else (plane-capsule, plane-box,
    capsule-box, box-box: several points, the deepest kept, ties to
    rounding) the same separation p2 - p1 from a point at the same depth."""
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu.engine.collision import _NARROWPHASE
    from ambersim_tpu.engine.collision import geom_pair_distance as jax_distance
    from ambersim_tpu_torch.engine import smooth
    from ambersim_tpu_torch.engine.collision import geom_pair_distance

    jm = tp.jax_model_from_xml(chip_smoke.DISTANCE_RIG)
    tm = tp.torch_model(jm)
    rng = np.random.default_rng(23)
    qpos = np.asarray(jm.qpos0, np.float32) + 0.05 * rng.standard_normal((8, jm.skel.nq)).astype(np.float32)
    jd = jax.jit(jax.vmap(lambda d: jsmooth.kinematics(jm, d)))(tp.jax_batch(jm, qpos=qpos))
    d = smooth.kinematics(tm, tp.torch_batch(tm, jd))
    g1, g2 = np.triu_indices(jm.skel.ngeom, 1)
    g1, g2 = np.concatenate([g1, g2[::5]]), np.concatenate([g2, g1[::5]])  # every pair, and some swapped
    pairs = list(zip(g1.tolist(), g2.tolist()))
    want = jax.jit(jax.vmap(lambda dd: [jax_distance(jm, dd, a, b) for a, b in pairs]))(jd)
    dist, p1, p2 = (x.numpy() for x in geom_pair_distance(tm, d, g1, g2))
    types = np.asarray(jm.skel.geom_type)
    one_point = 0
    for p, (a, b) in enumerate(pairs):
        wd, w1, w2 = (np.asarray(x) for x in want[p])
        np.testing.assert_allclose(dist[:, p], wd, rtol=TOL[0], atol=TOL[1], err_msg=f"dist of geoms {a}, {b}")
        if _NARROWPHASE[tuple(sorted((int(types[a]), int(types[b]))))][1] == 1:
            one_point += 1
            np.testing.assert_allclose(p1[:, p], w1, rtol=TOL[0], atol=TOL[1], err_msg=f"p1 of geoms {a}, {b}")
            np.testing.assert_allclose(p2[:, p], w2, rtol=TOL[0], atol=TOL[1], err_msg=f"p2 of geoms {a}, {b}")
            continue
        # several points: the same separation p2 - p1 (the normal times the
        # distance), from a point at JAX's depth along that normal (which
        # of equally deep points the narrowphase keeps, rounding decides)
        np.testing.assert_allclose(p2[:, p] - p1[:, p], w2 - w1, rtol=TOL[0], atol=TOL[1],
                                   err_msg=f"p2 - p1 of geoms {a}, {b}")
        n = (w2 - w1) / np.maximum(np.linalg.norm(w2 - w1, axis=-1, keepdims=True), 1e-12)
        depth = ((p1[:, p] - w1) * n).sum(-1)
        assert (np.abs(depth) <= 1e-5).all(), f"geoms {a}, {b}: a point off JAX's depth by {np.abs(depth).max()}"
    assert one_point >= 10
    one = geom_pair_distance(tm, d, int(g1[0]), int(g2[0]))
    assert one[0].shape == (8,) and one[1].shape == (8, 3)


def test_geom_pair_distance_refuses_height_fields():
    from ambersim_tpu_torch.engine import make_data, smooth
    from ambersim_tpu_torch.engine.collision import geom_pair_distance
    from test_torch_bridge import HFIELD_SPHERE_XML

    tm = tp.torch_model(tp.jax_model_from_xml(HFIELD_SPHERE_XML))
    d = smooth.kinematics(tm, make_data(tm, 2))
    with pytest.raises(NotImplementedError, match="between geom types HFIELD and SPHERE"):
        geom_pair_distance(tm, d, 0, 1)
