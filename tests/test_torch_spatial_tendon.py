"""Spatial tendons of the PyTorch port against the JAX package (CPU): site
via points, pulley divisors, sphere and cylinder wraps with and without a
sidesite, and the interior wrap (a sidesite inside the geom), through
lengths, run-time Jacobians, velocities, passive forces, the tendon
transmission, the tendon limit row and setconst's length0 (smooth.py's
tendon plan against the JAX package's _wrap_seg / _spatial_tendon).

Fixtures: tests/test_spatial_tendon.py's SPATIAL_RIG (a cylinder wrap with
a sidesite, a sphere wrap and a cylinder wrap without, and a pulleyed
tendon; springs, dampers, a range and a motor on a tendon) and PULLEY_RING
(a cylinder wrap whose sidesite is inside the geom). The forward sweeps are
the JAX tests' own, batched as envs, and must meet both the wrapped and the
straight branch. Bars as tests/test_torch_tendon.py's. The tendon stage's
aten ops do not grow with the number of spatial tendons of the kinds
present (its plan groups their segments).
"""

import re

import jax
import numpy as np
import pytest
import torch

from test_spatial_tendon import PULLEY_RING, SPATIAL_RIG
from test_torch_tendon import TOL, _case, assert_forward, assert_rollout
from tools import torch_parity as tp


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def spatial_rig():
    return _case(SPATIAL_RIG)


@pytest.fixture(scope="module")
def pulley_ring():
    return _case(PULLEY_RING)


def straight_length(m, d, t: int) -> torch.Tensor:
    """(B,) the distance between spatial tendon t's first two sites."""
    sites = [el[1] for el in m.skel.tendon_path[t] if el[0] == "site"]
    return torch.linalg.vector_norm(d.site_xpos[:, sites[1]] - d.site_xpos[:, sites[0]], dim=-1)


def test_spatial_rig_forward(spatial_rig):
    """tests/test_spatial_tendon.py:test_spatial_forward_parity's 12-state
    sweep: each wrapping tendon both wrapped and straight somewhere."""
    jm, tm, jstep = spatial_rig
    rng = np.random.default_rng(2)
    qpos = np.stack([np.array([-1.5 + 0.25 * k, 1.5 - 0.25 * k]) + 0.1 * rng.standard_normal(2)
                     for k in range(12)]).astype(np.float32)
    qvel = rng.standard_normal((12, 2)).astype(np.float32)
    ctrl = rng.uniform(-5, 5, (12, 1)).astype(np.float32)
    jd = jstep(tp.jax_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl))
    got = assert_forward(jm, tm, jd, jstep(jd))
    for t in range(3):  # the three wrapping tendons
        wrapped = got.ten_length[:, t] > straight_length(tm, got, t) + 1e-6
        assert wrapped.any() and not wrapped.all(), t


def test_spatial_rig_rollout(spatial_rig):
    """20 steps under tests/test_spatial_tendon.py's rollout ctrl."""
    from ambersim_tpu_torch.engine import step

    jm, tm, jstep = spatial_rig
    qpos, qvel = tp.random_state(jm, 4, seed=5, qpos_scale=0.3)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    d = tp.torch_batch(tm, jd)
    for i in range(20):
        ctrl = np.full((4, 1), 2.0 * np.sin(0.01 * i), np.float32)
        jd = jstep(jd.replace(ctrl=jax.numpy.asarray(ctrl)))
        d = step(tm, d.replace(ctrl=torch.tensor(ctrl)))
    tp.assert_close("qpos", d.qpos, jd.qpos, 0.0, 1e-4)
    tp.assert_close("qvel", d.qvel, jd.qvel, 0.0, 1e-3)


def ring_state(jm):
    """tests/test_spatial_tendon.py:test_interior_wrap_parity's states."""
    qpos = np.array([[-1.2], [-0.6], [0.0], [0.6], [1.2]], np.float32)
    return tp.jax_batch(jm, qpos=qpos, qvel=np.full((5, 1), 0.7, np.float32))


def test_pulley_ring_forward(pulley_ring):
    """The interior wrap: bent at one circle point where the straight
    segment misses the disk, straight where it crosses it."""
    jm, tm, jstep = pulley_ring
    jd = ring_state(jm)
    got = assert_forward(jm, tm, jd, jstep(jd))
    bent = got.ten_length[:, 0] > straight_length(tm, got, 0) + 1e-6
    assert bent.any() and not bent.all()


def test_pulley_ring_rollout(pulley_ring):
    jm, tm, jstep = pulley_ring
    jd = tp.jax_batch(jm, qpos=np.zeros((4, 1), np.float32),
                      qvel=np.array([[2.0], [1.0], [-1.0], [-2.0]], np.float32))
    assert_rollout(tm, jstep, jd)


def test_set_constants_spatial_fields(spatial_rig):
    """The port's set_constants on its own compile of SPATIAL_RIG: length0
    and the springlength rows it fills (the spatial tendons' default) from
    the port's float32 geometry at qpos0 within TOL of the JAX package's,
    tendon_invweight0 within cond(qM) x 2^-24 of it."""
    import chip_smoke
    from test_torch_mjcf import port_spec

    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.mjcf import compile_spec_arrays
    from tools.export_model_npz import model_arrays

    skel, leaves = compile_spec_arrays(port_spec(SPATIAL_RIG))
    assert np.isnan(leaves["tendon_lengthspring"]).any()
    got = set_constants(skel, leaves)
    _, want = model_arrays(spatial_rig[0])
    for field in ("tendon_length0", "tendon_lengthspring"):
        np.testing.assert_allclose(got[field], want[field], *TOL, err_msg=field)
    rtol = chip_smoke.setconst_rtol(skel, got)
    np.testing.assert_allclose(got["tendon_invweight0"], want["tendon_invweight0"], rtol=rtol, atol=0.0)


def _repeated(xml: str, copies: int, only: str | None = None) -> str:
    """`xml` with its spatial tendons (or tendon `only`) repeated `copies`
    times under new names."""
    start, end = xml.index("<tendon>") + len("<tendon>"), xml.index("</tendon>")
    block = xml[start:end]
    if only:
        block = re.search(rf'<spatial name="{only}".*?</spatial>', block, re.S).group(0)
    copies_xml = "".join(block.replace('name="', f'name="c{k}_') for k in range(copies))
    return xml[:start] + copies_xml + xml[end:].replace('tendon="cyl_side"', 'tendon="c0_cyl_side"')


def _aten_ops(m, d) -> int:
    from ambersim_tpu_torch.engine import smooth

    smooth.tendon(m, d)  # the plan and its index tensors, built once
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        smooth.tendon(m, d)
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


@pytest.mark.parametrize("only, copies", [("cyl_side", (1, 3)), (None, (1, 2))], ids=["one_kind", "every_kind"])
def test_tendon_stage_ops_do_not_grow_with_tendons(only, copies):
    """The tendon stage's aten ops for one cylinder-with-sidesite tendon and
    for three, and for SPATIAL_RIG's four tendons (every segment kind) and
    for eight: equal, since one group holds each kind's segments."""
    import chip_smoke
    from ambersim_tpu_torch.engine import make_data, smooth

    counts = []
    for n in copies:
        m = chip_smoke.xml_model(_repeated(SPATIAL_RIG, n, only), "cpu")
        assert m.skel.ntendon == n * (1 if only else 4)
        d = smooth.com_pos(m, smooth.kinematics(m, make_data(m, 2)))
        counts.append(_aten_ops(m, d))
    assert counts[0] == counts[1] > 0, counts
