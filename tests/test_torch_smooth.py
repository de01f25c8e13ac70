"""Smooth dynamics of the PyTorch port against the JAX package (CPU).

The same numpy-seeded quadruped states (B=6) go through the JAX package's
fwd_position_smooth -> fwd_velocity -> fwd_actuation -> fwd_acceleration
(vmapped, plain jnp path) and through the port's; every stage's outputs
agree at rtol/atol 1e-5. This covers kernels 1 and 2's plain versions as
the engine calls them (factor_m -> qLD, solve_m -> qacc_smooth).
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

RTOL = ATOL = 1e-5
FIELDS = (
    "xpos", "xquat", "xanchor", "xaxis", "xipos", "geom_xpos", "geom_xmat", "subtree_com", "cinert", "cdof",
    "cvel", "cdof_dot", "qM", "qLD", "qfrc_bias", "qfrc_passive", "qfrc_actuator", "actuator_force",
    "qfrc_smooth", "qacc_smooth",
)


def _smooth_jax(m, d):
    from ambersim_tpu.engine import smooth

    d = smooth.fwd_position_smooth(m, d)
    d = smooth.fwd_velocity(m, d)
    d = smooth.fwd_actuation(m, d)
    return smooth.fwd_acceleration(m, d)


def _smooth_torch(m, d):
    from ambersim_tpu_torch.engine import smooth

    d = smooth.fwd_position_smooth(m, d)
    d = smooth.fwd_velocity(m, d)
    d = smooth.fwd_actuation(m, d)
    return smooth.fwd_acceleration(m, d)


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    jm = tp.jax_model()
    tm = tp.torch_model(jm)
    qpos, qvel = tp.random_state(jm, 6, seed=11)
    ctrl = np.random.default_rng(12).uniform(-30, 30, (6, jm.skel.nu)).astype(np.float32)  # exercises the clamp
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl)
    ref = jax.jit(jax.vmap(lambda d: _smooth_jax(jm, d)))(jd)
    got = _smooth_torch(tm, tp.torch_batch(tm, jd))
    return ref, got


@pytest.mark.parametrize("field", FIELDS)
def test_smooth_field_matches_jax(case, field):
    ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), RTOL, ATOL)


def test_qLD_is_the_factor_of_qM(case):
    """factor_m's plain path (kernel 1's reference) factors qM exactly."""
    _, got = case
    L = got.qLD.double()
    np.testing.assert_allclose((L @ L.transpose(-1, -2)).numpy(), got.qM.double().numpy(), rtol=1e-5, atol=1e-5)
    assert torch.all(torch.triu(got.qLD, diagonal=1) == 0)
