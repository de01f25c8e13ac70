"""The bridge that carries the JAX package's models and state into the
PyTorch port: the committed model file, Skeleton and Model equality,
make_data parity, the host schedules, the no-JAX import rule, and the
refusal of every feature outside the ported slice.
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
from tools.export_model_npz import QUADRUPED_NPZ, model_arrays, pack

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


def test_loaded_model_matches_jax(quadruped):
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core import types as tt

    m = load_model("quadruped").to("cpu")
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

    got, want = tree_schedule(load_model("quadruped").skel), jax_schedule(quadruped.skel)
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


@pytest.mark.parametrize("scene", ["quadruped", "contact_scene"])
def test_pyramid_structure_matches_jax(scene, quadruped):
    from ambersim_tpu.engine.constraint import _pyramid_structure as jax_structure
    from ambersim_tpu_torch.core.types import Skeleton
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    jm = quadruped if scene == "quadruped" else tp.jax_model_from_xml(tp.CONTACT_SCENE)
    got = _pyramid_structure(Skeleton(**dict(jm.skel._fields)))
    want = jax_structure(jm.skel)
    assert got._fields == want._fields
    for k in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)), k)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import ambersim_tpu_torch, ambersim_tpu_torch.engine, ambersim_tpu_torch.ops.linalg\n"
        "import ambersim_tpu_torch.ops.newton, chip_smoke\n"
        "from ambersim_tpu_torch import load_model\n"
        "from ambersim_tpu_torch.engine import make_data, step\n"
        "m = load_model('quadruped'); step(m, make_data(m, 2))\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ambersim_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize(
    "source, features",
    [
        ("models/hand/hand.xml", ["equality constraints"]),
        (TENDON_SENSOR_XML, ["tendons", "sensors"]),
    ],
    ids=["hand", "tendon_sensor"],
)
def test_models_outside_the_slice_are_refused(source, features):
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    jm = tp.jax_model(source) if source.endswith(".xml") else tp.jax_model_from_xml(source)
    with pytest.raises(NotImplementedError) as err:
        model_from_numpy(*model_arrays(jm))
    for feature in features:
        assert feature in str(err.value)


def test_hessian_bf16_is_refused(quadruped):
    """The JAX kernel dispatch drops Option.hessian_bf16 silently; the port
    refuses it at load and at step."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, step
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    skel_fields, leaves = model_arrays(quadruped)
    with pytest.raises(NotImplementedError, match="hessian_bf16"):
        model_from_numpy(skel_fields, dict(leaves, **{"opt.hessian_bf16": np.asarray(True)}))
    m = load_model("quadruped")
    m = m.replace(opt=m.opt.replace(hessian_bf16=True))
    with pytest.raises(NotImplementedError, match="hessian_bf16"):
        step(m, make_data(m, 1))
