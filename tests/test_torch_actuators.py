"""The port's actuator breadth and mocap bodies against the JAX package's
(CPU): chip_smoke.ACTUATOR_RIG's position, velocity and intvelocity servos
(affine gain and bias; intvelocity's integrator dynamics with an actrange),
filter, filterexact (with an affine bias) and integrator activations, a
joint actuatorfrcrange clamp and a motor in a disabled group, started from
its keyframe (make_data's keyframe argument); tests/test_actgroup_user.py's
group-disable fixture and its USER sensor; tests/test_actfrcrange.py's
clamp fixture; and tests/test_mocap.py's target rig without its weld (the
mocap bodies' frames from d.mocap_pos / mocap_quat).

Numpy-seeded states and ctrl go through both packages. One forward from
identical Data: actuator_length, actuator_velocity, actuator_force, act_dot,
qfrc_actuator and sensordata within rtol 1e-5 / atol 1e-6. Rollouts under
a seeded ctrl schedule: qpos and act within atol 1e-4, qvel within 1e-3
(the main path's rollout bars), forces and act_dot step by step within
rtol / atol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from test_actfrcrange import XML as ACTFRCRANGE_XML
from test_actgroup_user import XML as ACTGROUP_XML
from tools import torch_parity as tp

TOL = (1e-5, 1e-6)
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
B, STEPS = 8, 30
FIELDS = ("actuator_length", "actuator_velocity", "actuator_force", "act_dot", "qfrc_actuator", "sensordata")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def jax_fns(jm):
    from ambersim_tpu.engine import forward, step

    return jax.jit(jax.vmap(lambda d: forward(jm, d))), jax.jit(jax.vmap(lambda d: step(jm, d)))


def compare_forward(jm, tm, jfwd, jd, fields=FIELDS):
    from ambersim_tpu_torch.engine.forward import forward

    want = jfwd(jd)
    got = forward(tm, tp.torch_batch(tm, jd))
    for f in fields:
        tp.assert_close(f, getattr(got, f), getattr(want, f), *TOL)
    return got, want


def compare_rollout(jm, tm, jstep, jd, ctrls):
    """Both packages stepped under the (T, B, nu) ctrl schedule."""
    from ambersim_tpu_torch.engine import step

    d = tp.torch_batch(tm, jd)
    for c in ctrls:
        jd = jstep(jd.replace(ctrl=c))
        d = step(tm, d.replace(ctrl=torch.as_tensor(c)))
    tp.assert_close("qpos", d.qpos, jd.qpos, 0.0, QPOS_ATOL)
    tp.assert_close("qvel", d.qvel, jd.qvel, 0.0, QVEL_ATOL)
    tp.assert_close("act", d.act, jd.act, 0.0, QPOS_ATOL)
    return d, jd


@pytest.fixture(scope="module")
def rig():
    from ambersim_tpu.engine import make_data as jax_make_data

    jm = tp.jax_model_from_xml(chip_smoke.ACTUATOR_RIG)
    tm = tp.torch_model(jm)
    key = jax_make_data(jm, keyframe=0)
    jd = jax.tree.map(lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)), key)
    rng = np.random.default_rng(31)
    jd = jd.replace(qpos=np.asarray(jd.qpos) + 0.1 * rng.standard_normal((B, jm.skel.nq)).astype(np.float32),
                    qvel=rng.standard_normal((B, jm.skel.nv)).astype(np.float32),
                    act=np.asarray(jd.act) + 0.2 * rng.standard_normal((B, jm.skel.na)).astype(np.float32),
                    ctrl=rng.uniform(-2.5, 2.5, (B, jm.skel.nu)).astype(np.float32))
    return jm, tm, jd, *jax_fns(jm)


def test_make_data_keyframe(rig):
    """make_data(m, B, keyframe=0): the keyframe's qpos, act (and zero
    qvel, ctrl, time) in every env, as the JAX package's make_data."""
    from ambersim_tpu.engine import make_data as jax_make_data
    from ambersim_tpu_torch.engine import make_data

    jm, tm, *_ = rig
    want = tp.data_to_numpy(jax_make_data(jm, keyframe=0))
    d = make_data(tm, 3, keyframe=0)
    for k in ("time", "qpos", "qvel", "act", "ctrl", "mocap_pos", "mocap_quat"):
        np.testing.assert_array_equal(getattr(d, k).numpy(), np.broadcast_to(want[k], (3,) + want[k].shape), k)
    assert (d.act[0] != 0).all()


def test_actuator_rig_forward(rig):
    jm, tm, jd, jfwd, _ = rig
    got, want = compare_forward(jm, tm, jfwd, jd)
    # the actrange clamps and the disabled group reach the output
    assert float(got.actuator_force[:, 6].abs().max()) == 0.0  # the motor in group 3
    assert (np.asarray(want.qfrc_actuator)[:, 0] >= -0.8 - 1e-6).all()  # j1's actuatorfrcrange
    assert (np.asarray(want.qfrc_actuator)[:, 0] <= 0.5 + 1e-6).all()


# each actuator of the rig, its index and (for dynamics) its activation's
KINDS = {"position": (0, None), "velocity": (1, None), "intvelocity": (2, 0), "filter": (3, 1),
         "filterexact": (4, 2), "integrator": (5, 3)}
# the schedule's ctrl magnitude per actuator: the integrators' act moves
# h x ctrl a step, past their actranges (+-0.3, +-1) within half of STEPS
CTRL_SCALE = np.array([3.0, 3.0, 40.0, 3.0, 3.0, 40.0, 3.0], np.float32)


@pytest.fixture(scope="module")
def rig_rollout(rig):
    """STEPS steps of the rig in both packages under a seeded ctrl schedule
    (CTRL_SCALE for the first half, -CTRL_SCALE after, plus 0.5 N(0, 1):
    past the filter's ctrlrange and into both ends of the act-limited
    actuators' actranges), each step's actuator_force, act and act_dot."""
    from ambersim_tpu_torch.engine import step

    jm, tm, jd, _, jstep = rig
    rng = np.random.default_rng(32)
    sign = np.where(np.arange(STEPS) < STEPS // 2, 1.0, -1.0)[:, None, None]
    ctrls = (sign * CTRL_SCALE + 0.5 * rng.standard_normal((STEPS, B, jm.skel.nu))).astype(np.float32)
    d = tp.torch_batch(tm, jd)
    got, want = [], []
    for c in ctrls:
        jd = jstep(jd.replace(ctrl=c))
        d = step(tm, d.replace(ctrl=torch.as_tensor(c)))
        got.append([d.actuator_force.numpy(), d.act.numpy(), d.act_dot.numpy()])
        want.append([np.asarray(x) for x in (jd.actuator_force, jd.act, jd.act_dot)])
    tp.assert_close("qpos", d.qpos, jd.qpos, 0.0, QPOS_ATOL)
    tp.assert_close("qvel", d.qvel, jd.qvel, 0.0, QVEL_ATOL)
    return [np.stack(x) for x in zip(*got)], [np.stack(x) for x in zip(*want)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_actuator_kind_rollout(rig, rig_rollout, kind):
    """Each actuator's force, and its activation and act_dot where it has
    dynamics, against the JAX package's at every step of the rollout."""
    jm = rig[0]
    u, a = KINDS[kind]
    (force, act, act_dot), (w_force, w_act, w_act_dot) = rig_rollout
    np.testing.assert_allclose(force[..., u], w_force[..., u], rtol=1e-4, atol=1e-4, err_msg=f"{kind} force")
    if a is None:
        return
    np.testing.assert_allclose(act[..., a], w_act[..., a], rtol=0, atol=QPOS_ATOL, err_msg=f"{kind} act")
    np.testing.assert_allclose(act_dot[..., a], w_act_dot[..., a], rtol=1e-4, atol=1e-4, err_msg=f"{kind} act_dot")
    if kind in ("intvelocity", "integrator"):  # act-limited: the clamp holds, and is reached
        lo, hi = np.asarray(jm.actuator_actrange)[u]
        assert (act[..., a] >= lo).all() and (act[..., a] <= hi).all()
        assert (act[..., a] == lo).any() and (act[..., a] == hi).any(), "the schedule reaches both ends"


def test_group_disable_and_user_sensor():
    """tests/test_actgroup_user.py: groups 1 and 3 disabled (their forces 0,
    the filter actuator's activation still advancing), a USER sensor reading
    0, ctrl 1 at qpos 0.3, and a few steps."""
    jm = tp.jax_model_from_xml(ACTGROUP_XML)
    tm = tp.torch_model(jm)
    assert tm.opt.disableactuator == 0b1010
    jfwd, jstep = jax_fns(jm)
    jd = tp.jax_batch(jm, qpos=np.full((B, 1), 0.3, np.float32), ctrl=np.ones((B, 4), np.float32))
    got, _ = compare_forward(jm, tm, jfwd, jd)
    assert not got.actuator_force[:, 1:3].any() and not got.sensordata[:, :3].any()
    assert (got.act_dot != 0).all()
    compare_rollout(jm, tm, jstep, jd, np.ones((10, B, 4), np.float32))


def test_actfrcrange_clamp():
    """tests/test_actfrcrange.py: gear-10 motors against a tight
    actuatorfrcrange on j1 (clamped both ways), j2 unclamped; forward and 50
    steps of its ctrl schedule."""
    jm = tp.jax_model_from_xml(ACTFRCRANGE_XML)
    tm = tp.torch_model(jm)
    jfwd, jstep = jax_fns(jm)
    ctrl = np.tile(np.array([1.0, -0.3], np.float32), (B, 1)) * np.linspace(0.5, 1.5, B, dtype=np.float32)[:, None]
    jd = tp.jax_batch(jm, ctrl=ctrl)
    got, _ = compare_forward(jm, tm, jfwd, jd, ("actuator_force", "qfrc_actuator"))
    assert torch.allclose(got.qfrc_actuator[:, 0], torch.tensor(0.5))
    ctrls = np.stack([np.tile([np.sin(0.3 * i) * 2, np.cos(0.2 * i)], (B, 1)) for i in range(50)]).astype(np.float32)
    d, _ = compare_rollout(jm, tm, jstep, jd, ctrls)


@pytest.fixture(scope="module")
def mocap():
    jm = tp.jax_model_from_xml(chip_smoke.mocap_rig_xml())
    return jm, tp.torch_model(jm)


def test_mocap_kinematics(mocap):
    """tests/test_mocap.py's target moved and turned per env: every body's
    and geom's frame against the JAX package's kinematics; the mocap body's
    position is its mocap_pos bit for bit."""
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu_torch.engine import smooth

    jm, tm = mocap
    assert tm.skel.nmocap == 1
    rng = np.random.default_rng(33)
    pos = (np.asarray(jm.body_pos)[np.asarray(jm.skel.mocap_bodyid)] + 0.2 * rng.standard_normal((B, 1, 3)))
    quat = rng.standard_normal((B, 1, 4))  # unnormalized: kinematics normalizes it
    jd = tp.jax_batch(jm, mocap_pos=pos.astype(np.float32), mocap_quat=quat.astype(np.float32))
    want = jax.jit(jax.vmap(lambda d: jsmooth.kinematics(jm, d)))(jd)
    got = smooth.kinematics(tm, tp.torch_batch(tm, jd))
    for f in ("xpos", "xquat", "geom_xpos", "geom_xmat", "xipos"):
        tp.assert_close(f, getattr(got, f), getattr(want, f), *TOL)
    body = int(tm.skel.mocap_bodyid[0])
    assert torch.equal(got.xpos[:, body], torch.as_tensor(pos[:, 0].astype(np.float32)))


def test_mocap_rollout(mocap):
    """20 steps with the target moved: the free box falls as in the JAX
    package, the target stays where mocap_pos puts it."""
    from ambersim_tpu.engine import make_data as jax_make_data
    from ambersim_tpu_torch.engine import make_data

    jm, tm = mocap
    d0 = make_data(tm, 2)
    np.testing.assert_array_equal(d0.mocap_pos[0].numpy(), np.asarray(jax_make_data(jm).mocap_pos))
    _, jstep = jax_fns(jm)
    pos = np.tile([[[0.25, 0.1, 0.6]]], (B, 1, 1)).astype(np.float32)
    jd = tp.jax_batch(jm, mocap_pos=pos)
    d, _ = compare_rollout(jm, tm, jstep, jd, np.zeros((20, B, 0), np.float32))
    body = int(tm.skel.mocap_bodyid[0])
    assert torch.equal(d.xpos[:, body], torch.as_tensor(pos[:, 0]))
