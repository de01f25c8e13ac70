"""benchmarks/ladder.py rung 3's drop_scene (BASELINE config 3: a box, two
spheres and a capsule dropped on the floor and on each other; nv = 24,
16 contact slots, 64 pyramidal rows) through the port's rollout against
the JAX package's step (tools/torch_parity.drop_rollouts) on the CPU: 4
numpy-seeded envs x 170 steps, through the first contacts (box-floor at
~97 steps, sphere-box at ~128, sphere-capsule at ~153, capsule-box at
~164 from qpos0) and before the stack turns chaotic.

Bars: qpos atol 1e-4, qvel atol 2e-3. Measured on a CPU: max |dqpos|
4.4e-6 and max |dqvel| 2.2e-4 at 170 steps (the float32 summation orders
of the two packages, grown by the impacts).
"""

import numpy as np
import pytest
import torch

from tools import torch_parity as tp

B, STEPS = 4, 170
QPOS_ATOL, QVEL_ATOL = 1e-4, 2e-3


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    return tp.drop_rollouts("drop_scene", B, STEPS, seed=5)


@pytest.mark.parametrize("field, atol", [("qpos", QPOS_ATOL), ("qvel", QVEL_ATOL), ("time", 1e-6)])
def test_rollout_state_matches_jax(case, field, atol):
    _, ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


def test_rollout_reaches_its_contacts(case):
    """Finite state; every env has contacts active at the end, the same
    rows as the JAX package's."""
    _, ref, got = case
    assert torch.isfinite(got.qpos).all() and torch.isfinite(got.qvel).all()
    assert (got.efc_active.sum(1) >= 4).all()
    np.testing.assert_array_equal(got.efc_active.numpy(), np.asarray(ref.efc_active))
