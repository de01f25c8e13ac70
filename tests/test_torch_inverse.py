"""The port's inverse dynamics (engine/inverse.py) and the FWDINV flag
against the JAX package's on the CPU: tests/test_inverse.py's pendulum
(limit and frictionloss rows, in the friction's quadratic and saturated
zones) and ball on a plane under both cones (the elliptic one sliding, in
the cone's middle zone), the forward/inverse identity, and Data.
solver_fwdinv on tests/test_flags.py's OVERRIDE_SCENE.

Bars: qfrc_inverse, qfrc_constraint and efc_force within 1e-4 of the JAX
package's plus 1e-4 relative; the identity qfrc_inverse = qfrc_actuator +
qfrc_applied within 1e-3 (tests/test_inverse.py's bar); solver_fwdinv
within 1e-4 plus 1e-2 relative (a difference of two solves' results).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tools import solver_parity as sp
from tools import torch_parity as tp
from tools.weld_parity import np_batch

PENDULUM = chip_smoke.tests_xml("test_inverse.py", "PENDULUM")
BALL_ON_PLANE = chip_smoke.tests_xml("test_inverse.py", "BALL_ON_PLANE")
OVERRIDE_SCENE = chip_smoke.tests_xml("test_flags.py", "OVERRIDE_SCENE")
TOL = 1e-4
# tests/test_inverse.py's states, one env each
PENDULUM_STATES = [([0.3], [1.2], [4.0]), ([2.49], [0.5], [-3.0]), ([0.0], [0.0], [0.001]), ([-1.0], [-2.0], [30.0])]
BALL_STATES = {
    "pyramidal": [([0.0, 0.0, 0.098, 1.0, 0.0, 0.0, 0.0], [0.05, -0.02, -0.1, 0.3, 0.0, 0.1],
                   [0.2, 0.1, -1.0, 0.0, 0.5, 0.0])],
    "elliptic": [([0.0, 0.0, 0.098, 1.0, 0.0, 0.0, 0.0], [0.3, -0.02, -0.1, 0.3, 0.0, 0.1],
                  [0.2, 0.1, -1.0, 0.0, 0.5, 0.0])],
}


def _inverse_pair(jm, states):
    """(port Data, JAX Data) of `inverse` on a batch of (qpos, qvel, qacc)."""
    from ambersim_tpu.engine import inverse as jax_inverse
    from ambersim_tpu_torch.engine import inverse

    qpos, qvel, qacc = (np.asarray([s[i] for s in states], np.float32) for i in range(3))
    jd = np_batch(jm, qpos=qpos, qvel=qvel, qacc=qacc)
    tm = tp.torch_model(jm)
    jd = jax.tree.map(jnp.asarray, jd)
    return inverse(tm, tp.torch_batch(tm, jd)), sp.compiled(jax.vmap(lambda d: jax_inverse(jm, d)), jd)(jd)


@pytest.mark.parametrize("case", ["pendulum", "ball_pyramidal", "ball_elliptic"])
def test_inverse_matches_jax(case):
    if case == "pendulum":
        jm, states = sp.quick_jax_model(PENDULUM), PENDULUM_STATES
    else:
        cone = case.split("_")[1]
        jm, states = sp.quick_jax_model(BALL_ON_PLANE.replace("{cone}", cone)), BALL_STATES[cone]
    got, want = _inverse_pair(jm, states)
    assert bool(got.efc_active.any())
    for field in ("qfrc_inverse", "qfrc_constraint", "efc_force"):
        tp.assert_close(field, getattr(got, field), getattr(want, field), TOL, TOL)


def test_forward_inverse_consistency():
    """inverse(forward(d).qacc) gives back qfrc_actuator + qfrc_applied, on
    tests/test_inverse.py's pyramidal ball and three seeded variations."""
    from ambersim_tpu_torch.engine import forward, inverse

    jm = sp.quick_jax_model(BALL_ON_PLANE.replace("{cone}", "pyramidal"))
    tm = tp.torch_model(jm)
    rng = np.random.default_rng(11)
    qvel = np.asarray([0.1, 0.0, -0.2, 0.2, 0.0, 0.0], np.float32) + 0.05 * rng.standard_normal((4, 6)).astype(
        np.float32)
    applied = np.asarray([0.3, 0.0, 0.1, 0.0, 0.05, 0.0], np.float32) + 0.05 * rng.standard_normal((4, 6)).astype(
        np.float32)
    d = tp.torch_batch(tm, np_batch(jm, qpos=np.tile(np.asarray(jm.qpos0, np.float32), (4, 1)), qvel=qvel,
                                    qfrc_applied=applied))
    df = forward(tm, d)
    di = inverse(tm, df)
    assert bool(df.efc_active.any())
    tp.assert_close("qfrc_inverse", di.qfrc_inverse, (df.qfrc_actuator + d.qfrc_applied).numpy(), 1e-3, 1e-3)


def test_fwdinv_flag():
    """With FWDINV the forward reports the forward/inverse discrepancy norms
    as the JAX package does; without it they stay at make_data's zeros."""
    jm = sp.quick_jax_model(OVERRIDE_SCENE.format(flag='fwdinv="enable"'))
    rng = np.random.default_rng(12)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (4, 1))
    qvel = 0.2 * rng.standard_normal((4, jm.skel.nv)).astype(np.float32)
    got, want = sp.forward_pair(jm, np_batch(jm, qpos=qpos, qvel=qvel))
    assert got.solver_fwdinv.shape == (4, 2) and bool(torch.isfinite(got.solver_fwdinv).all())
    tp.assert_close("solver_fwdinv", got.solver_fwdinv, want.solver_fwdinv, 1e-2, TOL)
    from ambersim_tpu_torch.engine import forward, make_data

    tm_off = tp.torch_model(sp.quick_jax_model(OVERRIDE_SCENE.format(flag='energy="enable"')))
    assert torch.equal(forward(tm_off, make_data(tm_off, 4)).solver_fwdinv, torch.zeros(4, 2))
