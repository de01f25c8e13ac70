"""Fixed tendons of the PyTorch port against the JAX package (CPU): lengths,
Jacobians and velocities, the deadband springs and dampers in the passive
force and in the potential energy, tendon transmissions, the tendon
equality, friction and limit rows, the tendon sensors and setconst's tendon
fields.

Fixtures: tests/test_tendon_parity.py's TENDON_RIG (two fixed tendons, one
with range, stiffness, damping and frictionloss, one with a springlength
range; a motor on a tendon; a tendon equality; tendonpos and tendonvel
sensors), with a tendonactuatorfrc sensor added, its TENDON_LIMIT_SENSOR_RIG
(the three tendon limit sensors) and tests/test_flags.py's PASSIVE_RICH (a
tendon spring over a springlength range, with fluid drag and gravity
compensation: its potential energy and its passive force are compared,
through the stages that compute them; tests/test_torch_fluid.py holds its
fluid and gravity compensation under each disable flag).

Numpy-seeded states go through both packages. One forward from identical
Data: lengths, Jacobians, velocities and the position and velocity sensor
rows within rtol 1e-5 / atol 1e-6; passive and actuator forces, the moment
matrix and the acceleration and force sensor rows within 1e-4 / 1e-4; efc
rows at tests/test_torch_constraint.py's bars. The Data carries the
tendon velocities of a step before, which the tendon friction row's aref
reads (the JAX package sets ten_velocity after the rows are made). 4 envs
x 20 steps hold qpos at atol 1e-4 and qvel at 1e-3. The solver runs at
chip_smoke.CONVERGED's 15 x 15 iterations on both sides.
"""

import jax
import numpy as np
import pytest
import torch

from test_flags import PASSIVE_RICH
from test_tendon_parity import TENDON_LIMIT_SENSOR_RIG, TENDON_RIG
from test_torch_sensors import assert_rows
from tools import torch_parity as tp

TOL = (1e-5, 1e-6)  # lengths, Jacobians, velocities
FORCE_TOL = (1e-4, 1e-4)  # forces and the moment matrix
RTOL = ATOL = 1e-5  # efc rows (tests/test_torch_constraint.py)
AREF_ATOL = 3e-4
EFC_FIELDS = ("efc_J", "efc_bJ", "efc_dsc", "efc_pos", "efc_margin", "efc_aref", "efc_D", "efc_frictionloss",
              "efc_active")
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
B, STEPS = 4, 20
CONVERGED = dict(iterations=15, ls_iterations=15)  # chip_smoke.CONVERGED

TENDON_RIG_SENSED = TENDON_RIG.replace('<tendonvel name="tv" tendon="couple"/>',
                                       '<tendonvel name="tv" tendon="couple"/>\n'
                                       '    <tendonactuatorfrc name="taf" tendon="flex"/>')
# a one-tendon equality row (pos = L - L0 - c0) and the two-tendon row with
# every quartic coefficient set
TENDON_EQ_RIG = TENDON_RIG.replace(
    '<tendon tendon1="flex" tendon2="couple" polycoef="0 0.5 0 0 0"/>',
    '<tendon tendon1="flex" tendon2="couple" polycoef="0.01 0.5 0.3 -0.2 0.1"/>'
    '<tendon tendon1="couple" polycoef="0.02 0 0 0 0"/>')


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _case(xml):
    """(JAX model, port model, the JAX package's jitted vmapped step), both
    at CONVERGED solver options (the port's plain Newton arrays run every
    iteration: ~1 s a step on the CPU at the rigs' default 100 x 50). A
    step's output Data holds the forward of its input, so one compile
    serves both the one-forward checks and the rollouts."""
    from ambersim_tpu.engine import step

    jm = tp.with_solver(tp.jax_model_from_xml(xml), **CONVERGED)
    return jm, tp.torch_model(jm), jax.jit(jax.vmap(lambda d: step(jm, d)))


@pytest.fixture(scope="module")
def tendon_rig():
    return _case(TENDON_RIG_SENSED)


@pytest.fixture(scope="module")
def limit_rig():
    return _case(TENDON_LIMIT_SENSOR_RIG)


def rig_state(jm, seed: int, qpos_scale=0.6, qvel_scale=0.8):
    """tests/test_tendon_parity.py:test_tendon_forward_parity's draw, B envs."""
    rng = np.random.default_rng(seed)
    s = jm.skel
    qpos = (qpos_scale * rng.standard_normal((B, s.nq))).astype(np.float32)
    qvel = (qvel_scale * rng.standard_normal((B, s.nv))).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (B, s.nu)).astype(np.float32)
    return tp.jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl)


def jax_moment(jm, jd):
    from ambersim_tpu.engine import smooth

    return jax.jit(jax.vmap(lambda d: smooth.actuator_moment(jm, d)))(jd)


def assert_forward(jm, tm, jd, ref):
    """The port's forward of `jd` against `ref`, the JAX package's."""
    from ambersim_tpu_torch.engine import smooth
    from ambersim_tpu_torch.engine.forward import forward

    got = forward(tm, tp.torch_batch(tm, jd))
    for field in ("ten_length", "ten_J", "ten_velocity", "actuator_length", "actuator_velocity"):
        tp.assert_close(field, getattr(got, field), getattr(ref, field), *TOL)
    for field in ("qfrc_spring", "qfrc_damper", "qfrc_passive", "actuator_force", "qfrc_actuator"):
        tp.assert_close(field, getattr(got, field), getattr(ref, field), *FORCE_TOL)
    if jm.skel.nu:
        tp.assert_close("actuator_moment", smooth.actuator_moment(tm, got), jax_moment(jm, ref), *FORCE_TOL)
    for field in EFC_FIELDS:
        atol = AREF_ATOL if field == "efc_aref" else ATOL
        tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, atol)
    if jm.skel.nsensor:
        assert_rows(jm, got.sensordata, ref.sensordata, tol=TOL, force_tol=FORCE_TOL)
    return got


def assert_rollout(tm, jstep, jd, steps=STEPS):
    from ambersim_tpu_torch.engine import step

    d = tp.torch_batch(tm, jd)
    for _ in range(steps):
        jd = jstep(jd)
        d = step(tm, d)
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
    tp.assert_close("qpos", d.qpos, jd.qpos, 0.0, QPOS_ATOL)
    tp.assert_close("qvel", d.qvel, jd.qvel, 0.0, QVEL_ATOL)


def test_tendon_rig_rows_go_to_kernel_4(tendon_rig):
    """TENDON_RIG's rows: one tendon equality, one tendon friction, one
    tendon limit (dense rows) and one condim-3 contact, laid out for the
    structured Newton kernel with nd_eq = nd_ft = 1."""
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure

    jm, tm, _ = tendon_rig
    st = _pyramid_structure(tm.skel)
    assert (tm.skel.ne, tm.skel.nf, tm.skel.nl) == (1, 1, 1)
    assert st is not None and (st.nd_eq, st.nd_ft, st.nd, st.ncon3) == (1, 1, 3, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tendon_rig_forward(tendon_rig, seed):
    jm, tm, jstep = tendon_rig
    jd = jstep(rig_state(jm, seed))  # a state whose ten_velocity is a step old
    got = assert_forward(jm, tm, jd, jstep(jd))
    assert got.efc_active[:, 0].all()  # the tendon equality row


def test_tendon_rig_rollout(tendon_rig):
    jm, tm, jstep = tendon_rig
    assert_rollout(tm, jstep, rig_state(jm, 3, qpos_scale=0.05, qvel_scale=0.5))


def test_tendon_equality_rows():
    """A one-tendon row and a quartic two-tendon row, through the stages
    that make them."""
    from ambersim_tpu.engine.forward import fwd_position as jax_fwd_position
    from ambersim_tpu_torch.engine.forward import fwd_position

    jm = tp.jax_model_from_xml(TENDON_EQ_RIG)
    tm = tp.torch_model(jm)
    assert list(np.asarray(jm.skel.eq_obj2id)) == [1, -1]
    jd = rig_state(jm, 4)
    ref = jax.jit(jax.vmap(lambda d: jax_fwd_position(jm, d)))(jd)
    got = fwd_position(tm, tp.torch_batch(tm, jd))
    for field in EFC_FIELDS:
        atol = AREF_ATOL if field == "efc_aref" else ATOL
        tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, atol)
    assert got.efc_active[:, :2].all()


def limit_state(jm):
    """tests/test_tendon_parity.py:test_tendon_limit_sensors's four states
    (the limit row inactive, near and past either end)."""
    qpos = np.array([[q1, 0.3] for q1 in (0.2, 0.6, 1.2, -1.0)], np.float32)
    qvel = np.tile(np.array([0.5, -0.2], np.float32), (4, 1))
    return tp.jax_batch(jm, qpos=qpos, qvel=qvel)


def test_tendon_limit_sensors(limit_rig):
    """tendonlimitpos / vel / frc read the tendon's limit row (0 where it is
    inactive), on both sides of the range."""
    jm, tm, jstep = limit_rig
    jd = limit_state(jm)
    ref = jstep(jd)
    got = assert_forward(jm, tm, jd, ref)
    active = got.efc_active[:, -1]
    assert active.any() and not active.all()
    assert (got.sensordata[~active] == 0).all()


def test_tendon_limit_rollout(limit_rig):
    jm, tm, jstep = limit_rig
    assert_rollout(tm, jstep, limit_state(jm))


@pytest.mark.parametrize("flags", ['energy="enable"', 'energy="enable" spring="disable"'])
def test_tendon_spring_energy(flags):
    """PASSIVE_RICH's tendon spring over its springlength range [0.1, 0.2]
    (the hinge below, inside and past it): potential energy and the
    tendon's length, after the position stages, and the passive force
    (springs, dampers, fluid drag in its wind, gravity compensation) after
    the velocity stage, at seeded velocities."""
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu_torch.engine import smooth
    from ambersim_tpu_torch.io.bridge import model_from_numpy
    from tools.export_model_npz import model_arrays

    jm = tp.jax_model_from_xml(PASSIVE_RICH.format(integrator="Euler", flags=flags))
    tm = model_from_numpy(*model_arrays(jm), device="cpu")
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    qpos[:, 0] = (-0.3, 0.15, 0.25, 0.9)
    qvel = 0.5 * np.random.default_rng(2).standard_normal((B, jm.skel.nv)).astype(np.float32)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)

    def jax_energy(d):
        d = jsmooth.tendon(jm, jsmooth.com_pos(jm, jsmooth.kinematics(jm, d)))
        return jsmooth.energy_pos(jm, d), d.ten_length, jsmooth.fwd_velocity(jm, d).qfrc_passive

    want_e, want_l, want_p = jax.jit(jax.vmap(jax_energy))(jd)
    d = tp.torch_batch(tm, jd)
    d = smooth.tendon(tm, smooth.com_pos(tm, smooth.kinematics(tm, d)))
    tp.assert_close("ten_length", d.ten_length, want_l, *TOL)
    tp.assert_close("energy_pos", smooth.energy_pos(tm, d), want_e, *FORCE_TOL)
    tp.assert_close("qfrc_passive", smooth.fwd_velocity(tm, d).qfrc_passive, want_p, *FORCE_TOL)


def test_set_constants_tendon_fields():
    """The port's set_constants on its own compile of TENDON_RIG against the
    JAX package's: every field bit for bit (tendon_length0 and the
    springlength range are linear in qpos0) but the setconst fields,
    tendon_invweight0 and actuator_acc0 (over the tendon transmission's
    moment gear * ten_J) among them, within cond(qM) x 2^-24 (the port's
    float32 smooth pass)."""
    from test_torch_mjcf import check_against_jax

    check_against_jax(TENDON_RIG)
