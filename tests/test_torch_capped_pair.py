"""An explicit <pair>'s margin in a broadphase-capped group's selection,
in the PyTorch port against the JAX package (CPU), with
tests/test_torch_pairs.py's bars (tools/weld_parity.py): CAPPED_PAIR's
three spheres over a floor (not against each other), compiled with a
broadphase cap of 2, whose highest sphere's <pair> with the floor (margin
0.5) brings it into the selection in the middle one's place. The contact
fields (the selected geoms among them) and the efc rows from one forward
of the same Data, and the pair's parameters on the selected slot.
"""

import pytest
import torch

from tools import weld_parity as wp


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def test_contacts_and_rows_match_jax():
    wp.assert_pair_contacts("capped_pair")


def test_parameters_reach_the_contact():
    wp.assert_pair_parameters("capped_pair")
