"""Muscles of the PyTorch port against the JAX package (CPU): the FLV curves
(`smooth.muscle_gain_bias`) and the activation ODE (`muscle_dynamics`) over
grids, muscles on joint and on tendon transmissions in `fwd_actuation`,
and the muscle arm of examples/ex_muscle_tendon.py (a spatial tendon
wrapped on a cylinder, a tendonpos sensor), forward, rollout and the
gradient of its rollout.

Fixtures: tests/test_muscle.py's MUSCLE_RIG (muscles with default and with
every parameter set, tausmooth among them, on two joints and on a fixed
tendon with a range, beside intvelocity, damper and cylinder actuators) and
the example's ARM, read from its file as text. The curves: lengths x
velocities over the muscles' whole range and past it, ctrl x act over
[-0.2, 1.2] x [0, 1], within 1e-4 / 1e-4. Forwards, rollouts and bars as
tests/test_torch_tendon.py's; the gradient d(sum qpos_T)/d(ctrl) through 5
of the arm's steps, port autograd against jax.grad, within rtol 1e-3 and
finite.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_muscle import MUSCLE_RIG
from test_torch_tendon import CONVERGED, FORCE_TOL, _case, assert_forward, assert_rollout
from tools import torch_parity as tp

ARM = re.search(r'^ARM = """(.*?)"""', (Path(__file__).resolve().parent.parent / "examples" / "ex_muscle_tendon.py")
                .read_text(), re.S | re.M).group(1)
B = 4
GRAD_RTOL = 1e-3
GRAD_STEPS = 5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def muscle_rig():
    return _case(MUSCLE_RIG)


@pytest.fixture(scope="module")
def arm():
    return _case(ARM)


def muscle_state(jm, seed: int, qpos_scale=0.5):
    """qpos and qvel around qpos0, ctrl over [-0.2, 1.2] (the muscles'
    ctrlrange [0, 1] and past it), act over [0, 1]."""
    rng = np.random.default_rng(seed)
    s = jm.skel
    qpos, qvel = tp.random_state(jm, B, seed, qpos_scale=qpos_scale)
    ctrl = rng.uniform(-0.2, 1.2, (B, s.nu)).astype(np.float32)
    act = rng.uniform(0.0, 1.0, (B, s.na)).astype(np.float32)
    return tp.jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl, act=act)


def test_muscle_curves(muscle_rig):
    """gain and bias of the three muscles over a 25 x 25 length x velocity
    grid, and act_dot of their activations over a 15 x 15 ctrl x act grid."""
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu_torch.core.types import DynType, GainType
    from ambersim_tpu_torch.engine import smooth

    jm, tm, _ = muscle_rig
    s = jm.skel
    mu = np.nonzero(np.asarray(s.actuator_gaintype) == int(GainType.MUSCLE))[0]
    assert len(mu) == 3
    L, V = np.meshgrid(np.linspace(-4.0, 2.0, 25), np.linspace(-6.0, 6.0, 25))
    L = np.repeat(L.reshape(-1, 1), s.nu, 1).astype(np.float32)
    V = np.repeat(V.reshape(-1, 1), s.nu, 1).astype(np.float32)
    want = jax.jit(lambda a, b: jsmooth.muscle_gain_bias(jm, a, b))(L, V)
    got = smooth.muscle_gain_bias(tm, torch.tensor(L[:, mu]), torch.tensor(V[:, mu]), mu)
    for name, g, w in zip(("gain", "bias"), got, want):
        tp.assert_close(name, g, np.asarray(w)[:, mu], *FORCE_TOL)

    dyn_u = np.nonzero(np.asarray(s.actuator_dyntype) != int(DynType.NONE))[0]
    k = np.nonzero(np.asarray(s.actuator_dyntype)[dyn_u] == int(DynType.MUSCLE))[0]
    C, A = np.meshgrid(np.linspace(-0.2, 1.2, 15), np.linspace(0.0, 1.0, 15))
    C = np.repeat(C.reshape(-1, 1), len(dyn_u), 1).astype(np.float32)
    A = np.repeat(A.reshape(-1, 1), len(dyn_u), 1).astype(np.float32)
    want = jsmooth.muscle_dynamics(jm, jnp.asarray(C), jnp.asarray(A), dyn_u)
    got = smooth.muscle_dynamics(tm, torch.tensor(C[:, k]), torch.tensor(A[:, k]), dyn_u[k])
    tp.assert_close("act_dot", got, np.asarray(want)[:, k], *FORCE_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_muscle_rig_forward(muscle_rig, seed):
    """Lengths, velocities, gains, biases, forces and act_dot of every
    actuator kind (muscles on joints and on the tendon), and the joint and
    tendon limit rows."""
    jm, tm, jstep = muscle_rig
    jd = muscle_state(jm, seed)
    ref = jstep(jd)
    got = assert_forward(jm, tm, jd, ref)
    tp.assert_close("act_dot", got.act_dot, ref.act_dot, *FORCE_TOL)
    assert got.efc_active.any()


def test_muscle_rig_rollout(muscle_rig):
    jm, tm, jstep = muscle_rig
    assert_rollout(tm, jstep, muscle_state(jm, 2, qpos_scale=0.05))


def arm_state(jm, seed: int):
    """The arm around qpos0 (0.05 N(0, 1)), under the example's excitation
    (biceps 0.8, shoulder 0.3), activations over [0, 1]."""
    rng = np.random.default_rng(seed)
    qpos, qvel = tp.random_state(jm, B, seed, qpos_scale=0.05)
    ctrl = np.tile(np.array([0.8, 0.3], np.float32), (B, 1))
    act = rng.uniform(0.0, 1.0, (B, jm.skel.na)).astype(np.float32)
    return tp.jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl, act=act)


def test_muscle_arm_forward(arm):
    """The example's arm: the biceps tendon wrapped on the elbow cylinder
    in every one of these states, its length sensor and the hand's
    framepos."""
    from test_torch_spatial_tendon import straight_length

    jm, tm, jstep = arm
    jd = arm_state(jm, 0)
    ref = jstep(jd)
    got = assert_forward(jm, tm, jd, ref)
    assert (got.ten_length[:, 0] > straight_length(tm, got, 0) + 1e-6).all()
    tp.assert_close("act_dot", got.act_dot, ref.act_dot, *FORCE_TOL)
    tp.assert_close("biceps_len", got.sensordata[:, 0], got.ten_length[:, 0], 0.0, 0.0)


def test_muscle_arm_rollout(arm):
    from ambersim_tpu_torch.engine import step

    jm, tm, jstep = arm
    jd = arm_state(jm, 1)
    assert_rollout(tm, jstep, jd)
    d = tp.torch_batch(tm, jd)
    for _ in range(5):
        d = step(tm, d)
    assert ((d.act >= 0) & (d.act <= 1)).all()
    tp.assert_close("biceps_len", d.sensordata[:, 0], d.ten_length[:, 0], 0.0, 0.0)


def test_muscle_arm_gradient():
    """d(sum qpos_T)/d(ctrl) through 5 of the arm's steps from seeded
    states: through the activations, the FLV curves and the wrapped
    tendon's length and Jacobian (at CONVERGED solver options, as the other
    rollouts here)."""
    from ambersim_tpu.engine import step as jstep
    from ambersim_tpu_torch.engine import make_data, step

    jm = tp.with_solver(tp.jax_model_from_xml(ARM), **CONVERGED)
    tm = tp.torch_model(jm)
    rng = np.random.default_rng(3)
    qpos, qvel = tp.random_state(jm, B, 3, qpos_scale=0.05, qvel_scale=0.1)
    ctrl = rng.uniform(0.1, 0.9, (GRAD_STEPS, B, jm.skel.nu)).astype(np.float32)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)

    def loss(u):
        def body(d, uk):
            return jax.vmap(jstep, (None, 0))(jm, d.replace(ctrl=uk)), None

        d, _ = jax.lax.scan(body, jd, u)
        return d.qpos.sum()

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(ctrl)))
    u = torch.tensor(ctrl, requires_grad=True)
    d = make_data(tm, B).replace(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    for k in range(GRAD_STEPS):
        d = step(tm, d.replace(ctrl=u[k]))
    d.qpos.sum().backward()
    got = u.grad.numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(want).max())
