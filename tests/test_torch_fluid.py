"""The port's fluid forces, gravity compensation and the fluid part of the
implicit integrators' velocity derivative against the JAX package (CPU).

Fixtures: tests/test_fluid.py's FLUID_RIG (a free box with a hinged capsule
in a medium of density 1.2, viscosity 0.3 and wind (0.5, -0.2, 0.1)) and
GRAVCOMP_RIG (gravcomp 0.7 and 1.0 on the two bodies); tests/test_flags.py's
PASSIVE_RICH (springs, dampers, a tendon, fluid drag in a wind and gravcomp
0.5) under each combination of the SPRING and DAMPER disable flags: with
both disabled mj_passive returns early, so fluid drag and gravity
compensation go too; and tests/test_implicit.py's FLUID_XML (a box
spinning and falling through a dense viscous medium) under implicitfast
and under implicit.

Bars: the passive forces within atol 1e-5 (tests/test_fluid.py's own bar
against the MuJoCo oracle), qacc within rtol 1e-4 / atol 1e-3 (its bar
too); rollouts of 4 envs x 20 steps at the repo's rollout bars, qpos atol
1e-4 and qvel atol 1e-3; the implicit solve's system matrix qM - h D within
DERIV_RTOL 1e-4 of each env's largest |entry| (tests/test_torch_
integrators.py's bar on the derivatives).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tools import solver_parity as sp
from tools import torch_parity as tp
from tools.weld_parity import np_batch

PASSIVE_ATOL = 1e-5
QACC_TOL = (1e-4, 1e-3)
DERIV_RTOL = 1e-4
B, STEPS = 4, 20
FLUID_RIG = chip_smoke.tests_xml("test_fluid.py", "FLUID_RIG")
GRAVCOMP_RIG = chip_smoke.tests_xml("test_fluid.py", "GRAVCOMP_RIG")
PASSIVE_RICH = chip_smoke.tests_xml("test_flags.py", "PASSIVE_RICH")
FLUID_XML = chip_smoke.tests_xml("test_implicit.py", "FLUID_XML")
FLAGS = {"none": 'energy="enable"', "spring": 'spring="disable"', "damper": 'damper="disable"',
         "both": 'spring="disable" damper="disable"'}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _free_state(jm, seed: int, qvel_scale: float = 1.0):
    """qpos0 with the free body moved 0.2 N(0, 1), turned to a random unit
    quaternion, the other joints 1.0 N(0, 1); velocities qvel_scale N(0, 1)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    qpos[:, :3] += 0.2 * rng.standard_normal((B, 3)).astype(np.float32)
    q = rng.standard_normal((B, 4))
    qpos[:, 3:7] = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    qpos[:, 7:] += rng.standard_normal((B, jm.skel.nq - 7)).astype(np.float32)
    qvel = qvel_scale * rng.standard_normal((B, jm.skel.nv)).astype(np.float32)
    return np_batch(jm, qpos=qpos, qvel=qvel)


def _forward_pair(jm, jd):
    from ambersim_tpu.engine import forward as jax_forward
    from ambersim_tpu_torch.engine.forward import forward

    tm = tp.torch_model(jm)
    return forward(tm, tp.torch_batch(tm, jd)), sp.compiled(jax.vmap(lambda d: jax_forward(jm, d)), jd)(jd)


def test_fluid_passive_matches_jax():
    """FLUID_RIG's passive force (the hinge's damper and the fluid wrench
    of both bodies) and qacc at random states."""
    jm = sp.quick_jax_model(FLUID_RIG)
    got, want = _forward_pair(jm, _free_state(jm, seed=9))
    assert jm.skel.has_fluid and float(np.abs(np.asarray(want.qfrc_passive)).max()) > 0.1
    tp.assert_close("qfrc_passive", got.qfrc_passive, want.qfrc_passive, 0.0, PASSIVE_ATOL)
    tp.assert_close("qacc", got.qacc, want.qacc, *QACC_TOL)


def test_fluid_rollout_matches_jax():
    """FLUID_RIG tumbling through its medium, 4 envs x 20 steps."""
    jm = sp.quick_jax_model(FLUID_RIG)
    sp.rollout(jm, _free_state(jm, seed=4), STEPS, pd=False)


def test_gravcomp_matches_jax():
    """GRAVCOMP_RIG's passive force at qvel 0.3 (tests/test_fluid.py:89),
    then its partly compensated fall, 4 envs x 20 steps from seeded states."""
    jm = sp.quick_jax_model(GRAVCOMP_RIG)
    jd = np_batch(jm, qpos=np.tile(np.asarray(jm.qpos0, np.float32), (B, 1)),
                  qvel=np.full((B, jm.skel.nv), 0.3, np.float32))
    got, want = _forward_pair(jm, jd)
    assert jm.skel.has_gravcomp and not jm.skel.has_fluid
    tp.assert_close("qfrc_passive", got.qfrc_passive, want.qfrc_passive, 0.0, PASSIVE_ATOL)
    sp.rollout(jm, _free_state(jm, seed=6, qvel_scale=0.3), STEPS, pd=False)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_passive_flags_match_jax(flags):
    """PASSIVE_RICH under each SPRING / DAMPER flag: the spring and damper
    forces each zeroed by its own flag, fluid drag and gravity
    compensation kept unless both are set; the passive forces after one
    forward at seeded states."""
    jm = sp.quick_jax_model(PASSIVE_RICH.format(integrator="Euler", flags=FLAGS[flags]))
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    rng = np.random.default_rng(11)
    qpos[:, 0] += 0.5 * rng.standard_normal(B).astype(np.float32)
    q = qpos[:, 1:5] + 0.2 * rng.standard_normal((B, 4)).astype(np.float32)
    qpos[:, 1:5] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel = rng.standard_normal((B, jm.skel.nv)).astype(np.float32)
    got, want = _forward_pair(jm, np_batch(jm, qpos=qpos, qvel=qvel))
    for f in ("qfrc_spring", "qfrc_damper", "qfrc_passive"):
        tp.assert_close(f, getattr(got, f), getattr(want, f), 0.0, PASSIVE_ATOL)
    extras = got.qfrc_passive - got.qfrc_spring - got.qfrc_damper
    assert (float(extras.abs().max()) == 0.0) == (flags == "both")


def _implicit_case(integrator: str):
    """(JAX model, JAX Data after forward, port Data after forward) of
    FLUID_XML under `integrator`, its box at tests/test_implicit.py's
    velocity (0.4, -0.2, 0, 3, 2, 1) plus 0.5 N(0, 1) per env."""
    jm = sp.quick_jax_model(FLUID_XML.format(integrator=integrator))
    qvel = np.array([0.4, -0.2, 0.0, 3.0, 2.0, 1.0], np.float32)
    qvel = qvel + 0.5 * np.random.default_rng(7).standard_normal((B, 6)).astype(np.float32)
    jd = np_batch(jm, qpos=np.tile(np.asarray(jm.qpos0, np.float32), (B, 1)), qvel=qvel)
    got, want = _forward_pair(jm, jd)
    return jm, jd, want, got


@pytest.mark.parametrize("integrator", ["implicitfast", "implicit"])
def test_fluid_derivative_system_matches_jax(integrator):
    """qM - h D of the implicit solve with the fluid drag's derivative, the
    closed form against the JAX package's forward-mode AD: symmetrized
    under implicitfast (with its 1e-10 ridge), as it is and beside the
    Coriolis derivative under implicit; then one step of each package."""
    from ambersim_tpu.engine import integrate as jint
    from ambersim_tpu_torch.engine import integrate

    jm, jd, want, got = _implicit_case(integrator)
    full = integrator == "implicit"
    h = float(jm.opt.timestep)

    def jax_system(d):
        D = jint._qderiv_vel(jm, d)
        Dad = jint._qderiv_vel_ad(jm, d, include_bias=full)
        if full:
            return d.qM - h * (D + Dad)
        return d.qM - h * (D + 0.5 * (Dad + Dad.T)) + 1e-10 * jax.numpy.eye(jm.skel.nv)

    A_want = np.asarray(jax.jit(jax.vmap(jax_system))(want))
    A, _ = integrate.implicit_system(tp.torch_model(jm), got, full)
    scale = np.abs(A_want).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(A.numpy() / scale, A_want / scale, rtol=0.0, atol=DERIV_RTOL)
    fluid = np.abs(A_want - np.asarray(want.qM)).max()
    assert fluid > 1e-3  # the drag's derivative is in the system, not only the mass matrix
    sp.rollout(jm, jd, 1, pd=False)
