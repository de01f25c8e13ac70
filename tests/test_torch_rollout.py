"""The PyTorch port's main path as a whole against the JAX package (CPU):
8 quadruped envs, 20 steps of the PD standing controller, from the main
path's numpy-seeded start (qpos[7:] += 0.05 N(0, 1)), through
ambersim_tpu.engine.rollout.rollout and ambersim_tpu_torch's rollout.
Bars: qpos atol 1e-4, qvel atol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

B, STEPS = 8, 20
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def case():
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import rollout

    torch.set_num_threads(1)
    jm = tp.jax_model()
    tm = tp.torch_model(jm)
    jd = tp.jax_batch(jm, qpos=tp.bench_qpos(jm, B, seed=0))
    ref = jax.jit(lambda d: jax_rollout(jm, d, STEPS, ctrl_fn=tp.pd_ctrl_jax, batched=True))(jd)
    got = rollout(tm, tp.torch_batch(tm, jd), STEPS, ctrl_fn=tp.pd_ctrl_torch)
    return ref, got


@pytest.mark.parametrize("field, atol", [("qpos", QPOS_ATOL), ("qvel", QVEL_ATOL), ("time", 1e-6)])
def test_rollout_state_matches_jax(case, field, atol):
    ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


def test_rollout_stands_in_contact(case):
    """The trunk stays up on loaded feet (the main path's steady state)."""
    ref, got = case
    assert torch.isfinite(got.qpos).all() and torch.isfinite(got.qvel).all()
    z = got.qpos[:, 2].numpy()
    assert np.all((z > 0.25) & (z < 0.28)), z
    assert np.all(got.efc_active.sum(-1).numpy() >= 16)
    np.testing.assert_array_equal(got.efc_active.numpy(), np.asarray(ref.efc_active))
