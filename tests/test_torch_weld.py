"""Connect and weld equality rows and ball joint limits of the PyTorch port
against the JAX package (CPU).

Fixtures (tools/weld_parity.py, which the mocap weld and welded hand files
share): tests/test_constraint_parity.py's CONNECT_SWING (3 rows and a
contact between the capsules), WELD_PAIR (6 rows and a contact) and
BALL_LIMITED (one dense ball-limit row).

One forward from identical numpy-seeded Data in both packages: the efc
rows at tests/test_torch_constraint.py's bars (rtol 1e-5 / atol 1e-5,
efc_aref atol 3e-4), qacc and qfrc_constraint within 1e-4 / 1e-4, and the
PyramidStructure layout of the contact models. Then 4 envs x 20 steps of
both packages' steps: qpos atol 1e-4, qvel atol 1e-3. The solver runs at
chip_smoke.CONVERGED's 15 x 15 Newton iterations on both sides (the CPU's
plain Newton arrays run every iteration). A step's gradient at
BALL_LIMITED's qpos0 (the identity quaternion, where the limit row's norm
and axis divide by zero) is finite.
"""

import pytest
import torch

from tools import weld_parity as wp

HERE = ("connect_swing", "weld_pair", "ball_limited")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", HERE)
def test_rows_and_layout_match_jax(name):
    wp.assert_weld_rows(name)


@pytest.mark.parametrize("name", HERE)
def test_rollout_matches_jax(name):
    wp.assert_weld_rollout(name)


def test_ball_limit_gradient_is_finite_at_qpos0():
    """d(sum qpos + sum qvel)/d(qpos, qvel) of one step at the identity
    quaternion: the limit row's norm and axis are in safe forms."""
    from ambersim_tpu_torch.engine import make_data, step

    _, tm, _ = wp.weld_case("ball_limited")
    d = make_data(tm, 2)
    qpos, qvel = d.qpos.clone().requires_grad_(True), d.qvel.clone().requires_grad_(True)
    out = step(tm, d.replace(qpos=qpos, qvel=qvel))
    (out.qpos.sum() + out.qvel.sum()).backward()
    assert torch.isfinite(qpos.grad).all() and torch.isfinite(qvel.grad).all()
    assert qvel.grad.abs().sum() > 0
