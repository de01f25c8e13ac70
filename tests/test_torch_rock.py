"""benchmarks/ladder.py rung 3a's rock drop (a scanned-rock stand-in whose
collision hull the compiler budgets to 64 vertices; one plane-mesh pair,
4 contact slots, Newton 12 x 12) through the port's rollout against the
JAX package's step (tools/torch_parity.drop_rollouts) on the CPU: 4
numpy-seeded envs x 150 steps, through the first floor contact (~90 steps
from qpos0) and the settling that follows.

Bars: qpos atol 1e-5, qvel atol 1e-4. Measured on a CPU: max |dqpos|
2.8e-7 and max |dqvel| 4.2e-6 after 150 steps.
"""

import numpy as np
import pytest
import torch

from tools import torch_parity as tp

B, STEPS = 4, 150
QPOS_ATOL, QVEL_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(1)
    return tp.drop_rollouts("rock", B, STEPS, seed=5)


@pytest.mark.parametrize("field, atol", [("qpos", QPOS_ATOL), ("qvel", QVEL_ATOL), ("time", 1e-6)])
def test_rollout_state_matches_jax(case, field, atol):
    _, ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


def test_rollout_reaches_its_contacts(case):
    """Finite state; the rock rests on the floor in every env (a contact
    active), with the JAX package's contact points."""
    _, ref, got = case
    assert torch.isfinite(got.qpos).all() and torch.isfinite(got.qvel).all()
    assert got.efc_active.any(1).all()
    np.testing.assert_array_equal(got.efc_active.numpy(), np.asarray(ref.efc_active))
    tp.assert_close("contact.pos", got.contact.pos, ref.contact.pos, rtol=0.0, atol=1e-5)
