"""The mesh Barrett-class hand's grasp scene (models/hand/grasp_scene.xml:
seven convex-decomposed mesh parts, 12 mesh-mesh pairs closing on a free
mesh object, four joint-equality mimic rows, damped joints) compiled by the
port's own compiler and stepped by the port on the CPU, against the JAX
package's compiler and step, at tests/test_models_parity.py:166-196's
settings: ctrl (0, 1.2, 1.2, 1.2), 300 steps from qpos0.

Bars: qpos atol 1e-3 (the JAX test's is 2e-2 against the C engine);
measured on a CPU: max |dqpos| 6.0e-5, on the object's orientation, after
300 steps of sustained mesh contact. The object stays held in the palm
channel and the f1 mimic ratio stays within the JAX test's 5e-3.
"""

import numpy as np
import pytest
import torch

from tools import torch_parity as tp

XML = "models/hand/grasp_scene.xml"
CTRL = (0.0, 1.2, 1.2, 1.2)
STEPS = 300
QPOS_ATOL = 1e-3


@pytest.fixture(scope="module")
def case():
    import jax

    from ambersim_tpu.engine import step as jax_step
    from ambersim_tpu.utils.io_utils import load_model_from_file as jax_load
    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    torch.set_num_threads(1)
    jm = jax_load(XML)
    tm = load_model_from_file(XML, device="cpu")
    jd = tp.jax_batch(jm, qpos=np.asarray(jm.qpos0, np.float32)[None], ctrl=np.array([CTRL], np.float32))
    got = rollout(tm, tp.torch_batch(tm, jd), STEPS)
    step = jax.jit(jax.vmap(lambda d: jax_step(jm, d)))
    for _ in range(STEPS):
        jd = step(jd)
    return tm, jd, got


def test_grasp_scene_compiles_as_the_jax_package_does(case):
    tm, _, _ = case
    s = tm.skel
    assert (s.nv, s.nefc, s.ncon, s.neq, s.nmesh) == (14, 348, 84, 4, 7)


def test_grasp_rollout_matches_jax(case):
    _, ref, got = case
    assert torch.isfinite(got.qpos).all() and torch.isfinite(got.qvel).all()
    tp.assert_close("qpos", got.qpos, ref.qpos, rtol=0.0, atol=QPOS_ATOL)


def test_grasp_holds_the_object_and_the_mimic(case):
    tm, ref, got = case
    q, qj = got.qpos[0].numpy(), np.asarray(ref.qpos)[0]
    assert 0.08 < float(q[10]) < 0.15
    assert got.efc_active[0, int(min(tm.skel.con_efcadr)):].any()
    names = list(tm.skel.jnt_names)
    f1_prox, f1_dist = names.index("f1_prox"), names.index("f1_dist")
    np.testing.assert_allclose(q[f1_dist] / q[f1_prox], qj[f1_dist] / qj[f1_prox], atol=5e-3)
