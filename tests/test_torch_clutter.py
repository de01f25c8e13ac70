"""The clutter slice as a whole against the JAX package (CPU): the first
12 bodies of clutter32.xml lowered into contact (nv = 72, so the linalg
runs past n = 64), exported with --broadphase-cap 6 and
--max-contact-points 24 (the shape of the clutter32_rowcap192 path: every
object-object group capped, then the row cap), 4 numpy-seeded envs x 5
steps through ambersim_tpu.engine.rollout and the port's rollout, whose
Newton solve takes the large-nv route on the card.

Bars: qpos atol 1e-4, qvel atol 3e-3. The scene starts with rotated box
corners up to 5 cm deep in their neighbours, which fly apart at up to
14.5 m/s within the 5 steps (accelerations ~1e3 m/s^2 per step), so the
float32 summation-order differences of the two packages grow with them.
Measured on a CPU: max |dqpos| 1.8e-6 and max |dqvel| 9.2e-4, i.e. 6e-5
of the largest |qvel|.
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

B, STEPS = 4, 5
QPOS_ATOL, QVEL_ATOL = 1e-4, 3e-3


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import rollout

    torch.set_num_threads(1)
    jm, tm = tp.export_small_clutter(tmp_path_factory.mktemp("clutter"), 6, 24)
    qpos, qvel = tp.free_body_state(jm, B, seed=13)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(lambda d: jax_rollout(jm, d, STEPS, batched=True))(jd)
    got = rollout(tm, tp.torch_batch(tm, jd), STEPS)
    return tm, ref, got


@pytest.mark.parametrize("field, atol", [("qpos", QPOS_ATOL), ("qvel", QVEL_ATOL), ("time", 1e-6)])
def test_rollout_state_matches_jax(case, field, atol):
    _, ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


def test_rollout_keeps_its_contacts(case):
    """Finite state; the row cap keeps active rows of every contact type."""
    tm, ref, got = case
    assert torch.isfinite(got.qpos).all() and torch.isfinite(got.qvel).all()
    assert (got.efc_active.sum(1) >= 8).all()
    np.testing.assert_array_equal(got.contact.geom1.numpy(), np.asarray(ref.contact.geom1))
    np.testing.assert_array_equal(got.contact.geom2.numpy(), np.asarray(ref.contact.geom2))
