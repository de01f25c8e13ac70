"""The bridge that carries the JAX package's models and state into the
PyTorch port: the committed model file, Skeleton and Model equality,
make_data parity, the host schedules, the no-JAX import rule, and the
refusal of every feature outside the ported slice. The committed model
files (the quadruped, its elliptic-cone build, cartpole, arm3, the
humanoid, the pendulum, the three clutter32 builds, the hand, drop_scene
and the rock) must equal a fresh export.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tools import torch_parity as tp
from tools.export_model_npz import ASSETS_DIR, QUADRUPED_NPZ, model_arrays, pack

REPO = Path(__file__).resolve().parent.parent

TENDON_SENSOR_XML = """
<mujoco><worldbody>
  <body><joint name="a" axis="0 1 0"/><geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"/>
    <body pos="0 0 -0.3"><joint name="b" axis="0 1 0"/><geom type="sphere" size="0.03"/></body>
  </body>
</worldbody>
<tendon><fixed name="t"><joint joint="a" coef="1"/><joint joint="b" coef="-1"/></fixed></tendon>
<sensor><jointpos joint="a"/></sensor>
</mujoco>
"""


# a tendon's length sensor
TENDON_POS_SENSOR_XML = TENDON_SENSOR_XML.replace('<jointpos joint="a"/>', '<tendonpos tendon="t"/>')

# a camera projecting a site (CAMPROJECTION, read from the camera's frame)
CAMPROJECTION_XML = """
<mujoco><worldbody>
  <body pos="0 0 1"><joint axis="0 0 1"/><geom type="sphere" size="0.05"/>
    <camera name="cam" pos="0.3 0 0.2"/><site name="s" pos="0.1 0 0"/></body>
</worldbody>
<sensor><camprojection site="s" camera="cam"/></sensor>
</mujoco>
"""

# a muscle on a hinge joint
MUSCLE_XML = """
<mujoco><worldbody>
  <body><joint name="j" axis="0 1 0" range="-1 1"/><geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"/></body>
</worldbody>
<actuator><muscle joint="j" lengthrange="-1 1"/></actuator>
</mujoco>
"""

# a motor on a ball joint
BALL_MOTOR_XML = """
<mujoco><worldbody>
  <body><joint name="b" type="ball"/><geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"/></body>
</worldbody>
<actuator><motor joint="b" gear="1 0 0"/></actuator>
</mujoco>
"""

# contacts of condim 4 (torsional friction) and 6 (rolling friction)
CONDIM46_XML = """
<mujoco><worldbody>
  <geom type="plane" size="0 0 1"/>
  <body pos="0 0 0.1"><freejoint/><geom type="sphere" size="0.05" condim="4" conaffinity="0"/></body>
  <body pos="0.3 0 0.1"><freejoint/><geom type="sphere" size="0.05" condim="6" conaffinity="0"/></body>
</worldbody></mujoco>
"""

# elliptic cones over contacts of condim 1 and 3 (a pair takes the larger
# condim of its geoms): no single contiguous condim tail
ELLIPTIC_MIXED_XML = """
<mujoco><option cone="elliptic"/><worldbody>
  <geom type="plane" size="0 0 1" condim="1"/>
  <body pos="0 0 0.1"><freejoint/><geom type="sphere" size="0.05" condim="1" conaffinity="0"/></body>
  <body pos="0.3 0 0.1"><freejoint/><geom type="sphere" size="0.05" condim="3" conaffinity="0"/></body>
</worldbody></mujoco>
"""


# a ball over a height field (tests/test_hfield.py's scene), in the slice
# since the height-field narrowphase
HFIELD_SPHERE_XML = """
<mujoco><option timestep="0.002"/>
  <asset><hfield name="terrain" nrow="9" ncol="9" size="1 1 0.3 0.1"/></asset>
  <worldbody>
    <geom name="hf" type="hfield" hfield="terrain"/>
    <body name="ball" pos="0 0 0.5"><freejoint/><geom name="s" type="sphere" size="0.08"/></body>
  </worldbody>
</mujoco>
"""

# a ball on the floor stepped by the RK4 integrator
RK4_XML = """
<mujoco><option integrator="RK4"/><worldbody>
  <geom type="plane" size="0 0 1"/>
  <body pos="0 0 0.1"><freejoint/><geom type="sphere" size="0.05"/></body>
</worldbody></mujoco>
"""

# the hand with a weld between two fingertips (its four joint mimics, then
# the weld's six rows)
HAND_WELD_XML = (Path(__file__).resolve().parent.parent / "ambersim_tpu" / "models" / "hand" / "hand.xml").read_text(
).replace("</equality>", '<weld body1="f1_dist_link" body2="f2_dist_link"/></equality>')

# an explicit <pair> between two spheres (its friction overrides the mixed one)
EXPLICIT_PAIR_XML = """
<mujoco><worldbody>
  <geom type="plane" size="0 0 1"/>
  <body pos="0 0 0.1"><freejoint/><geom name="a" type="sphere" size="0.05"/></body>
  <body pos="0.08 0 0.1"><freejoint/><geom name="b" type="sphere" size="0.05"/></body>
</worldbody>
<contact><pair geom1="a" geom2="b" friction="0.3 0.3 0.005 0.0001 0.0001"/></contact>
</mujoco>
"""


@pytest.fixture(scope="module")
def quadruped():
    torch.set_num_threads(1)
    return tp.jax_model()


def test_asset_matches_fresh_export(quadruped):
    """assets/quadruped.npz is what the JAX compiler produces today."""
    fresh = pack(*model_arrays(quadruped))
    with np.load(QUADRUPED_NPZ, allow_pickle=False) as committed:
        assert set(committed.keys()) == set(fresh.keys())
        for k, v in fresh.items():
            assert committed[k].dtype == v.dtype and committed[k].shape == v.shape, k
            np.testing.assert_array_equal(committed[k], v, err_msg=k)


NEW_ASSETS = ["quadruped_elliptic", "cartpole", "arm3", "humanoid", "pendulum", "clutter32_cap48",
              "clutter32_rowcap192", "hand", "drop_scene", "rock", "clutter32"]


@pytest.mark.parametrize("name", NEW_ASSETS)
def test_new_asset_matches_fresh_export(name):
    """assets/<name>.npz is what the JAX compiler produces today, with the
    asset's cone override (tools/export_model_npz.ASSETS)."""
    fresh = pack(*model_arrays(tp.jax_asset_model(name)))
    with np.load(ASSETS_DIR / f"{name}.npz", allow_pickle=False) as committed:
        assert set(committed.keys()) == set(fresh.keys())
        for k, v in fresh.items():
            assert committed[k].dtype == v.dtype and committed[k].shape == v.shape, k
            np.testing.assert_array_equal(committed[k], v, err_msg=k)


@pytest.mark.parametrize("name", NEW_ASSETS)
def test_new_assets_load_and_step(name):
    """check_slice accepts every new asset; one CPU step stays finite."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core.types import ConeType
    from ambersim_tpu_torch.engine import make_data, step

    m = load_model(name, device="cpu")
    assert (m.opt.cone == int(ConeType.ELLIPTIC)) == (name == "quadruped_elliptic")
    d = step(m, make_data(m, 2))
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qacc).all()


def test_elliptic_cone_on_a_pyramidal_layout_is_refused(quadruped):
    """opt.cone flipped to elliptic on rows compiled for pyramids: the layout
    guard of JAX solver.py:62-75 names the fix."""
    from ambersim_tpu_torch.core.types import ConeType
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    skel_fields, leaves = model_arrays(quadruped)
    leaves = dict(leaves, **{"opt.cone": np.asarray(int(ConeType.ELLIPTIC))})
    with pytest.raises(ValueError, match="cone='elliptic'"):
        model_from_numpy(skel_fields, leaves, device="cpu")


def test_loaded_model_matches_jax(quadruped):
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core import types as tt

    m = load_model("quadruped", device="cpu")
    # the port's Skeleton class is a copy: compare contents and content hash
    assert m.skel == tt.Skeleton(**dict(quadruped.skel._fields))
    assert hash(m.skel) == hash(quadruped.skel)
    for cls_t, cls_j in ((tt.Model, type(quadruped)), (tt.Option, type(quadruped.opt))):
        assert {f.name for f in dataclasses.fields(cls_t)} == {f.name for f in dataclasses.fields(cls_j)}
    for f in dataclasses.fields(quadruped):
        if f.name not in ("skel", "opt"):
            np.testing.assert_array_equal(getattr(m, f.name).numpy(), np.asarray(getattr(quadruped, f.name)), f.name)
    for f in dataclasses.fields(quadruped.opt):
        want = getattr(quadruped.opt, f.name)
        got = getattr(m.opt, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), f.name)
        else:
            assert got == want, f.name


def test_data_fields_match_jax():
    from ambersim_tpu.core import types as jt
    from ambersim_tpu_torch.core import types as tt

    for cls_t, cls_j in ((tt.Data, jt.Data), (tt.Contact, jt.Contact)):
        assert [f.name for f in dataclasses.fields(cls_t)] == [f.name for f in dataclasses.fields(cls_j)]


@pytest.mark.parametrize("path", [tp.QUADRUPED_XML, "models/pendulum/scene.xml"])
def test_make_data_matches_jax(path):
    from ambersim_tpu.engine import make_data as jax_make_data
    from ambersim_tpu_torch.engine import make_data

    jm = tp.jax_model(path)
    d = make_data(tp.torch_model(jm), 3)
    ref = tp.data_to_numpy(jax_make_data(jm))
    for k, want in ref.items():
        g = getattr(d.contact, k[8:]) if k.startswith("contact.") else getattr(d, k)
        assert g.shape == (3,) + want.shape, k
        np.testing.assert_array_equal(g.numpy(), np.broadcast_to(want, (3,) + want.shape), k)


def test_data_from_numpy_roundtrip(quadruped):
    """A vmapped JAX Data arrives field for field, batch-first."""
    qpos, qvel = tp.random_state(quadruped, 4, seed=1)
    jd = tp.jax_batch(quadruped, qpos=qpos, qvel=qvel)
    d = tp.torch_batch(tp.torch_model(quadruped), jd)
    np.testing.assert_array_equal(d.qpos.numpy(), qpos)
    np.testing.assert_array_equal(d.contact.geom2.numpy(), np.asarray(jd.contact.geom2))
    assert d.efc_active.dtype == torch.bool and d.contact.geom1.dtype == torch.int32


def test_tree_schedule_matches_jax(quadruped):
    from ambersim_tpu.engine.schedule import tree_schedule as jax_schedule
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine.schedule import tree_schedule

    got, want = tree_schedule(load_model("quadruped", device="cpu").skel), jax_schedule(quadruped.skel)
    assert len(got.levels) == len(want.levels) == 4
    for lg, lw in zip(got.levels, want.levels):
        for (sg, ig, pg, jg), (sw, iw, pw, jw) in zip(lg, lw):
            assert sg == sw
            for a, b in zip((ig, pg, *jg), (iw, pw, *jw)):
                np.testing.assert_array_equal(a, b)
    for (cg, pg), (cw, pw) in zip(got.reverse_levels, want.reverse_levels):
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(pg, pw)
    assert got.jnt_by_type.keys() == want.jnt_by_type.keys()
    for k in want.jnt_by_type:
        np.testing.assert_array_equal(got.jnt_by_type[k], want.jnt_by_type[k])


@pytest.mark.parametrize("scene", ["quadruped", "contact_scene", "hand"])
def test_pyramid_structure_matches_jax(scene, quadruped):
    from ambersim_tpu.engine.constraint import _pyramid_structure as jax_structure
    from ambersim_tpu_torch.core.types import Skeleton
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    jm = {"quadruped": lambda: quadruped, "contact_scene": lambda: tp.jax_model_from_xml(tp.CONTACT_SCENE),
          "hand": lambda: tp.jax_asset_model("hand")}[scene]()
    got = _pyramid_structure(Skeleton(**dict(jm.skel._fields)))
    want = jax_structure(jm.skel)
    assert got._fields == want._fields
    for k in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)), k)


def test_port_never_imports_jax(tmp_path):
    """The port and chip_smoke import nothing of JAX: in a subprocess where
    importing jax, flax, optax or ambersim_tpu fails, they import (the five
    trainers among them), step the exported models, compile and step
    grasp_scene.xml, the gripper URDF and the terrain quadruped with the
    port's own compiler, and cast rays over the terrain."""
    from test_model_io import GRIPPER_URDF

    urdf = tmp_path / "gripper.urdf"
    urdf.write_text(GRIPPER_URDF)
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'optax', 'ambersim_tpu'):\n"
        "    sys.modules[n] = None  # import fails\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import ambersim_tpu_torch, ambersim_tpu_torch.engine, ambersim_tpu_torch.ops.linalg\n"
        "import ambersim_tpu_torch.ops.newton, ambersim_tpu_torch.engine.convex, chip_smoke\n"
        "import ambersim_tpu_torch.rl, ambersim_tpu_torch.rl.ppo, ambersim_tpu_torch.rl.helpers\n"
        "import ambersim_tpu_torch.rl.pendulum, ambersim_tpu_torch.rl.quadruped, ambersim_tpu_torch.io.checkpoint\n"
        "import ambersim_tpu_torch.rl.humanoid, ambersim_tpu_torch.trajopt\n"
        "import ambersim_tpu_torch.rl.apg, ambersim_tpu_torch.rl.es, ambersim_tpu_torch.rl.ars\n"
        "import ambersim_tpu_torch.rl.sac, ambersim_tpu_torch.rl.sac.replay, ambersim_tpu_torch.rl.sac.losses\n"
        "from ambersim_tpu_torch import load_model\n"
        "from ambersim_tpu_torch.engine import make_data, step\n"
        "m = load_model('quadruped', device='cpu'); step(m, make_data(m, 2))\n"
        "m = load_model('clutter32_rowcap192', device='cpu'); step(m, make_data(m, 2))\n"
        "m = load_model('hand', device='cpu'); step(m, make_data(m, 2))\n"
        "m = load_model('drop_scene', device='cpu'); step(m, make_data(m, 2))\n"
        "m = load_model('rock', device='cpu'); step(m, make_data(m, 2))\n"
        "import ambersim_tpu_torch.mjcf, ambersim_tpu_torch.utils.conversion_utils\n"
        "import ambersim_tpu_torch.utils.introspection_utils\n"
        "from ambersim_tpu_torch.utils import load_model_from_file\n"
        "m = load_model_from_file('models/hand/grasp_scene.xml', device='cpu'); step(m, make_data(m, 2))\n"
        f"m = load_model_from_file({str(urdf)!r}, force_float=True, device='cpu'); step(m, make_data(m, 2))\n"
        "assert m.skel.neq == 1\n"
        "from ambersim_tpu_torch.engine.ray import ray\n"
        "from ambersim_tpu_torch.rl import get_environment\n"
        "m = get_environment('quadruped_terrain', device='cpu').model; d = step(m, make_data(m, 2))\n"
        "assert (ray(m, d, d.qpos[:, :3], torch.tensor([0.0, 0.0, -1.0]))[1] >= 0).all()\n"
        "bad = [n for n, mod in sys.modules.items()\n"
        "       if mod is not None and n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'ambersim_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_stacked_mlp_params_carry_across():
    """A flax MLP whose leaves carry a leading axis (SAC's twin critics,
    kernels (2, in, out)) arrives as weights (2, out, in): only the last two
    axes swap. Both critics applied in the port give the JAX package's
    q_network.apply, and the round trip gives the same arrays back."""
    import jax
    import jax.numpy as jnp

    from ambersim_tpu.rl.sac import make_sac_networks as jax_sac_networks
    from ambersim_tpu_torch.io.bridge import ppo_params_from_jax, ppo_params_to_numpy
    from ambersim_tpu_torch.rl.sac import make_sac_networks

    jnets = jax_sac_networks(3, 2)
    jparams = jax.device_get(jnets.q_network.init(jax.random.PRNGKey(0)))
    assert jparams["params"]["hidden_0"]["kernel"].shape == (2, 5, 256)
    got = ppo_params_from_jax(jparams, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "hidden.0.weight": (2, 256, 5), "hidden.0.bias": (2, 256), "hidden.1.weight": (2, 256, 256),
        "hidden.1.bias": (2, 256), "hidden.2.weight": (2, 1, 256), "hidden.2.bias": (2, 1)}
    rng = np.random.default_rng(0)
    obs, act = rng.standard_normal((7, 3)).astype(np.float32), rng.uniform(-1, 1, (7, 2)).astype(np.float32)
    want = np.asarray(jnets.q_network.apply(None, jparams, jnp.asarray(obs), jnp.asarray(act)))
    q = make_sac_networks(3, 2).q_network.apply(None, got, torch.as_tensor(obs), torch.as_tensor(act))
    assert q.shape == (7, 2)
    np.testing.assert_allclose(q.numpy(), want, rtol=1e-5, atol=1e-5)
    back = ppo_params_to_numpy(got)
    for name, layer in jparams["params"].items():
        for kind, w in layer.items():
            np.testing.assert_array_equal(back["params"][name][kind], w, err_msg=f"{name} {kind}")


# condim-4 contacts on the welded box of tests/test_mocap.py over a floor:
# the weld is in the slice, the torsional friction is not
WELDED_CONDIM4_XML = """
<mujoco><option timestep="0.002"/><worldbody>
  <geom type="plane" size="0 0 1" pos="0 0 0.45" condim="4"/>
  <body name="target" mocap="true" pos="0.1 0 0.5"><geom type="sphere" size="0.02" contype="0" conaffinity="0"/></body>
  <body name="box" pos="0.1 0 0.5"><freejoint/><geom type="box" size="0.05 0.05 0.05" mass="0.1" condim="4"/></body>
</worldbody>
<equality><weld body1="target" body2="box"/></equality>
</mujoco>
"""


# the RK4 ball on the floor solved by CG, with noslip iterations and solved
# by PGS; the ball under Euler with the FWDINV flag
CG_XML = RK4_XML.replace('integrator="RK4"', 'solver="CG"')
NOSLIP_XML = RK4_XML.replace('integrator="RK4"', 'noslip_iterations="3"')
FWDINV_XML = RK4_XML.replace('<option integrator="RK4"/>', '<option><flag fwdinv="enable"/></option>')
PGS_XML = RK4_XML.replace('integrator="RK4"', 'solver="PGS"')


@pytest.mark.parametrize(
    "source, features",
    [
        (PGS_XML, ["the PGS solver"]),
    ],
    ids=["pgs_solver"],
)
def test_models_outside_the_slice_are_refused(source, features):
    """Each feature outside the slice is refused by name: the PGS solver
    (which the JAX package runs as Newton without a word)."""
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    jm = tp.jax_model(source) if source.endswith(".xml") else tp.jax_model_from_xml(source)
    with pytest.raises(NotImplementedError) as err:
        model_from_numpy(*model_arrays(jm), device="cpu")
    for feature in features:
        assert feature in str(err.value)
    assert "sensors" not in str(err.value).split(": ", 1)[1].split(", ")  # sensors as such are in the slice
    assert "integrator" not in str(err.value) and "condim" not in str(err.value)


@pytest.mark.parametrize("source", [HAND_WELD_XML, BALL_MOTOR_XML, "MOCAP_WELD", EXPLICIT_PAIR_XML, "SLIDE_RIG",
                                    CONDIM46_XML, ELLIPTIC_MIXED_XML, RK4_XML, WELDED_CONDIM4_XML, CG_XML,
                                    NOSLIP_XML, FWDINV_XML, CAMPROJECTION_XML],
                         ids=["hand_weld", "ball_motor", "mocap_weld", "explicit_pair", "contact_sensor_condim6",
                              "condim46", "elliptic_mixed", "rk4", "welded_condim4", "cg_solver", "noslip",
                              "fwdinv", "camprojection"])
def test_models_the_slice_now_admits(source):
    """The models that stood for weld equality, a motor on a ball joint, the
    mocap weld drag, an explicit <pair>, contacts of condim 4 and 6 (alone,
    on a welded box and under tests/test_contact_sensor.py's contact
    sensors), elliptic cones over condims 1 and 3, the RK4 integrator, the
    CG solver, noslip iterations, the FWDINV flag and a camera with a
    CAMPROJECTION sensor load through the bridge, and one step of 2 seeded
    envs matches the JAX package's (qpos atol 1e-4, qvel atol 1e-3, as the
    main path's rollout)."""
    import jax

    from ambersim_tpu.engine import step as jax_step
    from ambersim_tpu_torch.core.types import JointType
    from ambersim_tpu_torch.engine import step
    from ambersim_tpu_torch.io.bridge import model_from_numpy
    from test_contact_sensor import SLIDE_RIG
    from test_mocap import MOCAP_WELD

    source = {"MOCAP_WELD": MOCAP_WELD, "SLIDE_RIG": SLIDE_RIG}.get(source, source)
    jm = tp.jax_model_from_xml(source)
    m = model_from_numpy(*model_arrays(jm), device="cpu")
    qpos, qvel = tp.random_state(jm, 2, seed=5, qpos_scale=0.05, qvel_scale=0.3)
    for j, jtype in enumerate(np.asarray(jm.skel.jnt_type)):  # free and ball quaternions back to unit length
        if jtype in (JointType.FREE, JointType.BALL):
            qa = int(jm.skel.jnt_qposadr[j]) + (3 if jtype == JointType.FREE else 0)
            qpos[:, qa : qa + 4] /= np.linalg.norm(qpos[:, qa : qa + 4], axis=1, keepdims=True)
    ctrl = np.random.default_rng(5).uniform(-1, 1, (2, jm.skel.nu)).astype(np.float32)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl)
    want = jax.jit(jax.vmap(lambda d: jax_step(jm, d)))(jd)
    got = step(m, tp.torch_batch(m, jd))
    tp.assert_close("qpos", got.qpos, want.qpos, 0.0, 1e-4)
    tp.assert_close("qvel", got.qvel, want.qvel, 0.0, 1e-3)


def _lifted(name):
    """The XML of each feature lifted in the sensor and servo slice and in
    the tendon and muscle slice."""
    import chip_smoke
    from test_actgroup_user import XML as ACTGROUP_XML
    from test_actfrcrange import XML as ACTFRCRANGE_XML
    from test_contact_sensor import BOX_RIG
    from test_sensors import SENSOR_RIG

    return {"sensors": SENSOR_RIG, "contact_sensors": BOX_RIG, "mocap": chip_smoke.mocap_rig_xml(),
            "activations_and_servos": chip_smoke.ACTUATOR_RIG, "actuator_group_disabling": ACTGROUP_XML,
            "actuatorfrcrange": ACTFRCRANGE_XML, "tendon_sensor": TENDON_SENSOR_XML,
            "tendon_pos_sensor": TENDON_POS_SENSOR_XML, "muscle": MUSCLE_XML,
            "energy": chip_smoke.ACTUATOR_RIG.replace('actuatorgroupdisable="3"/>',
                                                      'actuatorgroupdisable="3"><flag energy="enable"/></option>')}[name]


@pytest.mark.parametrize("name", ["sensors", "contact_sensors", "mocap", "activations_and_servos",
                                  "actuator_group_disabling", "actuatorfrcrange", "energy", "tendon_sensor",
                                  "tendon_pos_sensor", "muscle"])
def test_lifted_features_are_accepted(name):
    """Sensors, tendons and their sensors, muscles,
    mocap bodies, filter / filterexact / integrator activations, affine
    servos, a joint's actuatorfrcrange, actuator group disabling and the
    ENERGY flag load through the bridge; two CPU steps stay finite."""
    from ambersim_tpu_torch.core.types import EnableBit
    from ambersim_tpu_torch.engine import make_data, step
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    m = model_from_numpy(*model_arrays(tp.jax_model_from_xml(_lifted(name))), device="cpu")
    assert bool(m.opt.enableflags & EnableBit.ENERGY) == (name == "energy")
    d = step(m, step(m, make_data(m, 2)))
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.sensordata).all() and torch.isfinite(d.act).all()


@pytest.mark.parametrize("other", ["sphere", "capsule", "box"])
def test_hfield_pairs_are_accepted(other):
    """A height field against a sphere, a capsule or a box is in the slice
    (engine/collision.py's height-field narrowphase): the bridge carries
    the field's size and grid and the Skeleton's hfield fields; an explicit
    <pair> on such a model sets its contacts' friction and margin."""
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    size = {"sphere": "0.08", "capsule": "0.05 0.15", "box": "0.1 0.08 0.05"}[other]
    xml = HFIELD_SPHERE_XML.replace('type="sphere" size="0.08"', f'type="{other}" size="{size}"')
    jm = tp.jax_model_from_xml(xml)
    data = np.linspace(0.0, 1.0, 81, dtype=np.float32).reshape(1, 9, 9)
    jm = jm.replace(hfield_data=data)
    m = model_from_numpy(*model_arrays(jm), device="cpu")
    np.testing.assert_array_equal(m.hfield_data.numpy(), data)
    np.testing.assert_array_equal(m.hfield_size.numpy(), np.asarray(jm.hfield_size))
    s = m.skel
    for k in ("geom_hfieldid", "hfield_nrow", "hfield_ncol", "pair_hfk"):
        np.testing.assert_array_equal(getattr(s, k), getattr(jm.skel, k), err_msg=k)
    assert s.pair_hfk.tolist() == [int(jm.skel.pair_hfk[0])] and s.pair_hfk[0] >= 2
    explicit = xml.replace("</mujoco>", '<contact><pair geom1="hf" geom2="s" friction="0.4 0.4 0.01 0.001 0.001" '
                                        'margin="0.01"/></contact></mujoco>')
    from ambersim_tpu_torch.engine import make_data, smooth
    from ambersim_tpu_torch.engine.collision import collision

    m = model_from_numpy(*model_arrays(tp.jax_model_from_xml(explicit).replace(hfield_data=data)), device="cpu")
    c = collision(m, smooth.fwd_position_smooth(m, make_data(m, 2))).contact
    assert torch.equal(c.friction, torch.tensor([0.4, 0.4, 0.01, 0.001, 0.001]).expand_as(c.friction))
    assert (c.includemargin == 0.01).all()


def test_hessian_bf16_is_accepted_past_the_newton_kernels(tmp_path):
    """At nv > 32 (the batched-arrays route, where the JAX package applies
    it) Option.hessian_bf16 loads and steps; with elliptic cones (10 clutter
    bodies compiled elliptic, nv = 60), whose route the JAX package runs
    without it, it is refused by name."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, step
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    m = load_model("clutter32_rowcap192", device="cpu")
    m = m.replace(opt=m.opt.replace(hessian_bf16=True))
    assert torch.isfinite(step(m, make_data(m, 1)).qacc).all()
    xml = tmp_path / "clutter10.xml"
    xml.write_text(tp.clutter_small_xml(10))
    skel_fields, leaves = model_arrays(tp.jax_model(str(xml), "elliptic"))
    with pytest.raises(NotImplementedError, match="hessian_bf16.*elliptic"):
        model_from_numpy(skel_fields, dict(leaves, **{"opt.hessian_bf16": np.asarray(True)}), device="cpu")


def test_hessian_bf16_is_refused(quadruped):
    """The JAX kernel dispatch drops Option.hessian_bf16 silently; the port
    refuses it at load and at step."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, step
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    skel_fields, leaves = model_arrays(quadruped)
    with pytest.raises(NotImplementedError, match="hessian_bf16"):
        model_from_numpy(skel_fields, dict(leaves, **{"opt.hessian_bf16": np.asarray(True)}), device="cpu")
    m = load_model("quadruped", device="cpu")
    m = m.replace(opt=m.opt.replace(hessian_bf16=True))
    with pytest.raises(NotImplementedError, match="hessian_bf16"):
        step(m, make_data(m, 1))
