"""The OVERRIDE flag of the PyTorch port against the JAX package (CPU),
with tests/test_torch_pairs.py's bars (tools/weld_parity.py):
tests/test_flags.py's OVERRIDE_SCENE (a sphere resting on a floor, with
o_margin, o_solref, o_solimp and o_friction given) with the flag on, where
every contact takes the Option's o_* values, includemargin o_margin and
gap 0, and off, where the geoms' own parameters stand.
"""

import pytest
import torch

from tools import weld_parity as wp

HERE = ("override_on", "override_off")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", HERE)
def test_contacts_and_rows_match_jax(name):
    wp.assert_pair_contacts(name)


@pytest.mark.parametrize("name", HERE)
def test_rollout_matches_jax(name):
    wp.assert_pair_rollout(name)


@pytest.mark.parametrize("name", HERE)
def test_parameters_reach_the_contact(name):
    wp.assert_pair_parameters(name)
