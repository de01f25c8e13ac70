"""The committed settled clutter state (assets/clutter32_rowcap192_settled.npz,
tools/settle_clutter.py) that chip_smoke.py's Newton spread check starts
from on both clutter models: their shapes, finite, every geom above the
floor within chip_smoke.FLOOR_TOL, and rows active at that state (CPU)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs


@pytest.mark.parametrize("model", sorted(cs.CLUTTER_SPREAD_BARS))
def test_settled_clutter_state(model):
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data

    z = np.load(cs.CLUTTER_SETTLED)
    m = load_model(model, device="cpu")
    assert z["qpos"].shape == (m.nq,) and z["qvel"].shape == (m.skel.nv,)
    assert z["qpos"].dtype == z["qvel"].dtype == np.float32
    assert np.isfinite(z["qpos"]).all() and np.isfinite(z["qvel"]).all()
    d = make_data(m, 1).replace(qpos=torch.as_tensor(z["qpos"])[None], qvel=torch.as_tensor(z["qvel"])[None])
    d = cs.pre_solve(m, d)
    assert cs.lowest_geom_point(m, d).item() >= -cs.FLOOR_TOL
    assert d.efc_active.sum().item() > 0
