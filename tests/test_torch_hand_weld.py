"""The hand with a weld between two fingertips (tools/weld_parity.py's
HAND_WELD_XML, as test_torch_bridge's) of the PyTorch port against the JAX
package (CPU), with tests/test_torch_weld.py's bars: its four joint
mimics, then the weld's six rows (nd_eq 10) among the hand's limits and
contacts, laid out for the structured Newton kernel; one forward from the
same Data and a rollout of 4 envs x 20 steps.
"""

import pytest
import torch

from tools import weld_parity as wp


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def test_rows_and_layout_match_jax():
    wp.assert_weld_rows("hand_weld")


def test_rollout_matches_jax():
    wp.assert_weld_rollout("hand_weld")


def test_weld_rows_follow_the_hand_mimics():
    """The weld comes after the four joint mimics in model order: rows 4-9,
    three translational and three rotational."""
    from ambersim_tpu_torch.engine.constraint import _eq_plan

    _, tm, _ = wp.weld_case("hand_weld")
    adr, nrows, _ = _eq_plan(tm.skel)
    assert adr.tolist() == [0, 1, 2, 3, 4] and nrows == 10
