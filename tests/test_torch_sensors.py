"""The port's sensors (ambersim_tpu_torch/engine/sensor.py) against the JAX
package's (CPU), on tests/test_sensors.py's contact-free SENSOR_RIG (every
position, velocity and acceleration type but the contact-driven ones, which
tests/test_torch_sensor_contacts.py covers with the geom-distance trio),
the rangefinders of tests/test_ray.py's rig, the ENERGY flag, and
chip_smoke.py's
quadruped_sensors model (the main path's quadruped with an IMU, encoders,
foot touch and contact sensors and position servos).

Numpy-seeded states go through both packages. Each sensor row is compared
by its sensor_adr / sensor_dim slice: on one forward from identical Data,
position and velocity rows within rtol 1e-5 / atol 1e-6, acceleration and
force rows within rtol 1e-4 / atol 1e-4. The quadruped's 4 envs x 20 steps
rollout holds qpos at atol 1e-4 and qvel at 1e-3 (the main path's rollout
bars), the position and velocity rows likewise, and the acceleration and
force rows within 1e-3 of each env's largest |value| there: the two
rollouts' states part by float32 rounding, which reaches the Newton solve's
forces (chip_smoke.py holds the card's at kernel 4's own bar). The servo
quadruped's rollout equals the PD quadruped's bit for bit: with ctrl at
zero its position servos compute pd_ctrl. The sensor stage issues as many
aten ops for 8 touch sensors as for 4 (its plan groups them).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from test_ray import RAY_RIG
from test_sensors import SENSOR_RIG
from tools import torch_parity as tp

TOL = (1e-5, 1e-6)  # rtol, atol: position and velocity rows
FORCE_TOL = (1e-4, 1e-4)  # acceleration and force rows
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
ROLLOUT_FORCE_RTOL = 1e-3
B, STEPS = 4, 20


def assert_rows(jm, got, want, tol=TOL, force_tol=FORCE_TOL, what=""):
    """Every sensor's sensordata slice within its stage's (rtol, atol)."""
    from ambersim_tpu_torch.core.types import SensorType
    from ambersim_tpu_torch.engine.sensor import ACC_STAGE

    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    s = jm.skel
    assert got.shape == want.shape == (want.shape[0], s.nsensordata)
    for i in range(s.nsensor):
        a, n, t = int(s.sensor_adr[i]), int(s.sensor_dim[i]), SensorType(int(s.sensor_type[i]))
        rtol, atol = force_tol if t in ACC_STAGE else tol
        np.testing.assert_allclose(got[:, a:a + n], want[:, a:a + n], rtol=rtol, atol=atol,
                                   err_msg=f"{what} sensor {i} ({t.name})")


def jax_forward(jm):
    from ambersim_tpu.engine import forward

    return jax.jit(jax.vmap(lambda d: forward(jm, d)))


def jax_steps(jm, jd, steps):
    from ambersim_tpu.engine import step

    f = jax.jit(jax.vmap(lambda d: step(jm, d)))
    for _ in range(steps):
        jd = f(jd)
    return jd


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sensor_rig():
    """SENSOR_RIG with EnableBit.ENERGY on (d.energy beside its e_potential
    and e_kinetic sensors), and the JAX package's jitted forward of it."""
    from ambersim_tpu_torch.core.types import EnableBit

    jm = tp.jax_model_from_xml(SENSOR_RIG)
    jm = jm.replace(opt=jm.opt.replace(enableflags=jm.opt.enableflags | int(EnableBit.ENERGY)))
    return jm, tp.torch_model(jm), jax_forward(jm)


def sensor_rig_state(jm, seed: int):
    """tests/test_sensors.py:test_sensor_parity_smooth's draw, B envs."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    qpos[:, 0] += 0.4 * rng.standard_normal(B)
    qpos[:, 1] += 0.5 * rng.standard_normal(B)
    q = rng.standard_normal((B, 4))
    qpos[:, 2:6] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qvel = 0.6 * rng.standard_normal((B, jm.skel.nv))
    ctrl = 0.5 * rng.standard_normal((B, jm.skel.nu))
    return tp.jax_batch(jm, qpos=qpos.astype(np.float32), qvel=qvel.astype(np.float32),
                        ctrl=ctrl.astype(np.float32), time=np.full(B, 1.25, np.float32))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_sensor_rig_forward(sensor_rig, seed):
    """Every sensor of SENSOR_RIG (clock, joint, ball, actuator, frame with
    and without a reference, subtree, energy, magnetometer, velocimeter,
    gyro, accelerometer, frame accelerations) on one forward from identical
    Data, and the sensor module alone on the JAX package's forward."""
    from ambersim_tpu_torch.engine import sensor
    from ambersim_tpu_torch.engine.forward import forward

    jm, tm, fwd = sensor_rig
    jd = sensor_rig_state(jm, seed)
    want = fwd(jd)
    assert_rows(jm, forward(tm, tp.torch_batch(tm, jd)).sensordata, want.sensordata, what="forward")
    assert_rows(jm, sensor.sensors(tm, tp.torch_batch(tm, want)).sensordata, want.sensordata, what="sensors")


def test_energy_flag(sensor_rig):
    """EnableBit.ENERGY: d.energy (potential after the position stage,
    kinetic after the velocity stage) against the JAX package's, and equal
    to the e_potential / e_kinetic sensors; without the flag it stays as it
    was."""
    from ambersim_tpu_torch.core.types import EnableBit, SensorType
    from ambersim_tpu_torch.engine.forward import forward

    jm, tm, fwd = sensor_rig
    jd = sensor_rig_state(jm, 7)
    want = fwd(jd)
    got = forward(tm, tp.torch_batch(tm, jd))
    off = tm.replace(opt=tm.opt.replace(enableflags=tm.opt.enableflags & ~int(EnableBit.ENERGY)))
    assert not forward(off, tp.torch_batch(tm, jd)).energy.any()
    tp.assert_close("energy", got.energy, want.energy, *TOL)
    s = tm.skel
    for k, t in enumerate((SensorType.E_POTENTIAL, SensorType.E_KINETIC)):
        adr = int(s.sensor_adr[list(s.sensor_type).index(int(t))])
        torch.testing.assert_close(got.sensordata[:, adr], got.energy[:, k], rtol=0, atol=0)


def test_stage_sets_match_jax():
    """The port's stage sets (the checks' tolerance classes) are the JAX
    package's velocity and acceleration stages (and the contact sensor)."""
    from ambersim_tpu.core.types import SensorType as JS
    from ambersim_tpu.engine import sensor as jsensor
    from ambersim_tpu_torch.engine.sensor import ACC_STAGE, VEL_STAGE

    assert {int(t) for t in VEL_STAGE} == {int(t) for t in jsensor._VEL}
    assert {int(t) for t in ACC_STAGE} == {int(t) for t in jsensor._ACC} | {int(JS.CONTACT)}


def test_rangefinders():
    """tests/test_ray.py's rangefinders (down, tilted, up; -1 on a miss)
    from kinematics alone, 64 envs at random hinge angles, as
    tests/test_ray.py:_pos_and_sensors runs them."""
    from ambersim_tpu.engine import sensor as jsensor
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu_torch.engine import sensor, smooth

    jm = tp.jax_model_from_xml(RAY_RIG)
    tm = tp.torch_model(jm)
    qpos = np.random.default_rng(24).uniform(-1.2, 1.2, (64, jm.skel.nq)).astype(np.float32)
    jd = tp.jax_batch(jm, qpos=qpos)
    want = jax.jit(jax.vmap(lambda d: jsensor.sensors(jm, jsmooth.kinematics(jm, d))))(jd).sensordata
    got = sensor.sensors(tm, smooth.kinematics(tm, tp.torch_batch(tm, jd))).sensordata
    assert_rows(jm, got, want)
    assert (np.asarray(want) == -1.0).any() and (np.asarray(want) > 0).any()


@pytest.fixture(scope="module")
def quadruped_sensors():
    jm = tp.jax_model_from_xml(chip_smoke.quadruped_sensors_xml())
    return jm, tp.torch_model(jm)


def test_quadruped_sensors_model(quadruped_sensors):
    """52 sensors, 81 sensordata columns; the port's own compiler gives the
    same skeleton; the plan groups them by type and attachment kind."""
    from ambersim_tpu_torch.engine.sensor import sensor_plan

    jm, tm = quadruped_sensors
    assert (jm.skel.nsensor, jm.skel.nsensordata, jm.skel.nu, jm.skel.na) == (52, 81, 12, 0)
    assert chip_smoke.xml_model(chip_smoke.quadruped_sensors_xml(), "cpu").skel == tm.skel
    groups = sensor_plan(tm.skel).groups
    assert len(groups) == 13 and sum(len(g.ids) for g in groups) == 52


def test_quadruped_sensors_rollout(quadruped_sensors):
    """4 envs x 20 steps of the sensed servo quadruped from the main path's
    start (ctrl zero) against the JAX package's rollout (sensordata: the
    last step's forward, in both); a forward at the final state gives
    encoders equal to qpos, qvel and actuator_force."""
    from ambersim_tpu_torch.core.types import SensorType
    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.engine.forward import forward

    jm, tm = quadruped_sensors
    jd = tp.jax_batch(jm, qpos=tp.bench_qpos(jm, B))
    want = jax_steps(jm, jd, STEPS)
    got = rollout(tm, tp.torch_batch(tm, jd), STEPS)
    tp.assert_close("qpos", got.qpos, want.qpos, 0.0, QPOS_ATOL)
    tp.assert_close("qvel", got.qvel, want.qvel, 0.0, QVEL_ATOL)
    g, w = got.sensordata.numpy(), np.asarray(want.sensordata)
    pos, vel, force = chip_smoke.sensor_columns(tm)
    np.testing.assert_allclose(g[:, pos], w[:, pos], rtol=0, atol=QPOS_ATOL, err_msg="position rows")
    np.testing.assert_allclose(g[:, vel], w[:, vel], rtol=0, atol=QVEL_ATOL, err_msg="velocity rows")
    scale = np.abs(w[:, force]).max(1, keepdims=True)
    assert (np.abs(g[:, force] - w[:, force]) <= ROLLOUT_FORCE_RTOL * scale).all(), "force rows"
    # the card's exact checks (chip_smoke.quadruped_sensors_checks), here
    got = forward(tm, got)
    sd = got.sensordata
    assert torch.equal(sd[:, chip_smoke.sensor_cols(tm, SensorType.JOINTPOS)], got.qpos[:, 7:])
    assert torch.equal(sd[:, chip_smoke.sensor_cols(tm, SensorType.JOINTVEL)], got.qvel[:, 6:])
    assert torch.equal(sd[:, chip_smoke.sensor_cols(tm, SensorType.ACTUATORFRC)], got.actuator_force)
    assert torch.equal(sd[:, chip_smoke.sensor_cols(tm, SensorType.SUBTREECOM)], got.subtree_com[:, 1])
    touch = sd[:, chip_smoke.sensor_cols(tm, SensorType.TOUCH)]
    assert (touch >= 0).all() and (touch.sum(1) > 0).all()


def test_servo_quadruped_equals_pd(quadruped_sensors):
    """The position servos (kp 60, kv 2, forcerange +-28, ctrl 0) against
    the motor quadruped under chip_smoke.pd_ctrl from the same start: the
    same qpos and qvel bit for bit after 20 steps (the servo's bias
    -60 q - 2 qdot is pd_ctrl's arithmetic, its forcerange the motors'
    ctrlrange)."""
    from ambersim_tpu_torch.engine import make_data, rollout

    jm, tm = quadruped_sensors
    qm = tp.torch_model(tp.jax_model())
    qpos = torch.as_tensor(tp.bench_qpos(jm, B))
    servo = rollout(tm, make_data(tm, B).replace(qpos=qpos), STEPS)
    pd = rollout(qm, make_data(qm, B).replace(qpos=qpos), STEPS, ctrl_fn=chip_smoke.pd_ctrl)
    assert torch.equal(servo.qpos, pd.qpos) and torch.equal(servo.qvel, pd.qvel)
    assert torch.equal(servo.actuator_force, pd.actuator_force)


def _touch_model(copies: int):
    """The quadruped with a sphere site at each foot and `copies` x 4 touch
    sensors on them."""
    xml = chip_smoke.quadruped_sensors_xml()
    start, end = xml.index("<sensor>"), xml.index("</sensor>")
    touch = "".join(f'<touch site="{f}_foot"/>' for f in chip_smoke.FEET) * copies
    return chip_smoke.xml_model(xml[:start] + "<sensor>" + touch + xml[end:], "cpu")


def _aten_ops(m, d) -> int:
    from ambersim_tpu_torch.engine import sensor

    sensor.sensors(m, d)  # the plan and its index tensors, built once
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sensor.sensors(m, d)
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


def test_sensor_stage_ops_do_not_grow_with_sensors():
    """The sensor stage's aten ops for 4 touch sensors and for 8 (the second
    four on the same sites): equal, since one group holds them all."""
    from ambersim_tpu_torch.engine import make_data, rollout

    counts = []
    for copies in (1, 2):
        m = _touch_model(copies)
        assert m.skel.nsensor == 4 * copies
        d = rollout(m, make_data(m, 2), 2)
        counts.append(_aten_ops(m, d))
    assert counts[0] == counts[1] > 0, counts
