"""Explicit <pair> overrides of the PyTorch port against the JAX package
(CPU).

Fixtures (tools/weld_parity.py, which the OVERRIDE flag and capped-pair
files share): test_torch_bridge.EXPLICIT_PAIR_XML (two spheres on a floor,
a <pair> between them with its own friction) and the same <pair> idea on
the height-field model of test_torch_bridge.test_hfield_pairs_are_accepted
(a ball over tests/test_hfield.py's 9 x 9 field; the pair sets friction,
solref, solimp, margin and gap).

One forward from the same numpy-seeded Data: every contact field bit for
bit but dist, pos and frame (rtol 1e-5 / atol 1e-6), the efc rows at
tests/test_torch_constraint.py's bars (rtol 1e-5 / atol 1e-5, efc_aref
atol 3e-4), qacc within 1e-4 of each env's largest |qacc|. Then 4 envs x
20 steps: qpos atol 1e-4, qvel atol 1e-3, at chip_smoke.CONVERGED's
15 x 15 Newton iterations on both sides. The pair's parameters reach the
contact.
"""

import pytest
import torch

from tools import weld_parity as wp

HERE = ("explicit_pair", "hfield_pair")


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
