"""The mocap weld and its drag over a floor of the PyTorch port against the
JAX package (CPU), with tests/test_torch_weld.py's bars (tools/weld_parity.py).

Fixtures: tests/test_mocap.py's MOCAP_WELD (a free box welded to a mocap
target: six equality rows, no contacts, so the dense Newton kernel's
rows) and the same with a floor plane under the box (MOCAP_DRAG: the box
rests on the floor; six equality rows and four condim-3 contacts, laid out
for the structured Newton kernel with nd_eq 6).

The drag's rollout is held over its first DRAG_STEPS steps: the box hops
on its first contact and lands again at steps 17-18, where the JAX
package's own rollout moves by 3e-3 in qvel when its start moves by 1e-6
(1.5e-4 at step 17), so past that step float32 rounding, not the port,
sets the difference.
"""

import pytest
import torch

from tools import weld_parity as wp

HERE = ("mocap_weld", "mocap_drag")
DRAG_STEPS = 15


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", HERE)
def test_rows_and_layout_match_jax(name):
    wp.assert_weld_rows(name)


@pytest.mark.parametrize("name", HERE)
def test_rollout_matches_jax(name):
    wp.assert_weld_rollout(name, DRAG_STEPS if name == "mocap_drag" else wp.STEPS)
