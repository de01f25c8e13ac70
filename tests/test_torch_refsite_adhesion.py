"""The refsite and adhesion (BODY) transmissions of the PyTorch port
against the JAX package (CPU), with tests/test_torch_transmissions.py's
bars (tools/weld_parity.py): tests/test_refsite.py's ARM_XML (three
refsite servos on a 3-dof arm) and tests/test_adhesion.py's BOX_XML (a box
resting on the floor, four contacts) and GAP_XML (hovering within the
margins); an adhesion actuator's moment reads the contacts, after
collision. Lengths and velocities within rtol 1e-5 / atol 1e-6, forces,
qfrc_actuator and the moment matrix within 1e-4 / 1e-4 from the same
Data, and actuator_acc0 from the port's own compile and set_constants.
"""

import pytest
import torch

from tools import weld_parity as wp

HERE = ("refsite_arm", "adhesion_box", "adhesion_gap")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", HERE)
def test_transmissions_match_jax(name):
    wp.assert_transmissions(name)


@pytest.mark.parametrize("name", HERE)
def test_acc0_matches_jax(name):
    wp.assert_acc0(name)
