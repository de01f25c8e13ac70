"""Every actuator transmission of the PyTorch port against the JAX package
(CPU): ball JOINT and ball/free JOINTINPARENT, site, refsite, slider-crank
(both branches) and body (adhesion), besides the hinge/slide and tendon
ones of earlier tests.

Fixtures (tools/weld_parity.py, which the refsite and adhesion file
shares): tests/test_trn_extra.py's XML (a ball motor, a ball and a free
JOINTINPARENT, two slider-cranks) at its QPOS and in its broken-rod case
(the crank at 2.2 rad), with its first rod shortened from 0.35 to 0.15: the
crank site, 0.2 from its hinge, is never farther than 0.35 from the slider's
axis, so at 0.35 the broken-rod case keeps the rod whole; at 0.15 it breaks
there and not at QPOS. Then tests/test_muscle.py's THRUSTER_RIG (two site
thrusters on a free box) and tests/trajopt/test_ilqr.py's BALL_BODY (three
motors on a ball joint).

Each fixture's own state is env 0 of a batch of 4; the other envs move it
by seeded noise. One pass of both packages' smooth position, velocity and
actuation stages from the same Data: actuator lengths and velocities
within rtol 1e-5 / atol 1e-6, actuator forces, qfrc_actuator and the
moment matrix within 1e-4 / 1e-4 (tests/test_torch_tendon.py's bars). The
port's own compile and set_constants give the JAX package's actuator_acc0
within chip_smoke.setconst_rtol (cond(qM) x 2^-24). The actuation stage's
aten ops do not grow with the number of actuators of one kind.
"""

import pytest
import torch

import chip_smoke
from tools import torch_parity as tp
from tools import weld_parity as wp

HERE = ("trn_extra", "thruster", "ball_body")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", HERE)
def test_transmissions_match_jax(name):
    wp.assert_transmissions(name)


def test_slidercrank_branches():
    """The broken rod (env 1, the crank at 2.2 rad) takes the discriminant's
    other branch for the first crank, where the length is the slider axis'
    projection a.v, and env 0 (QPOS) does not."""
    from ambersim_tpu_torch.engine import smooth

    _, tm, _, jd = wp.trn_case("trn_extra")
    d = smooth.kinematics(tm, tp.torch_batch(tm, jd))
    d = smooth.com_pos(tm, d)
    plan = smooth.trn_plan(tm.skel)
    length, _ = smooth._slidercrank(tm, d, plan.crank, plan.crank_slider, plan.crank_site)
    s_id, c_id = plan.crank_slider[0], plan.crank_site[0]
    a = d.site_xmat[:, s_id, :, 2]
    v = d.site_xpos[:, c_id] - d.site_xpos[:, s_id]
    av = (a * v).sum(-1)
    sdet = av * av - (v * v).sum(-1) + tm.actuator_cranklength[plan.crank[0]] ** 2
    assert sdet[0] > 0 and sdet[1] <= 0
    torch.testing.assert_close(length[1, 0], av[1], rtol=0, atol=0)


@pytest.mark.parametrize("name", HERE)
def test_acc0_matches_jax(name):
    wp.assert_acc0(name)


def _doubled(xml: str) -> str:
    """`xml` with its <actuator> block written twice, the copies renamed."""
    start, end = xml.index("<actuator>") + len("<actuator>"), xml.index("</actuator>")
    block = xml[start:end]
    return xml[:start] + block + block.replace('name="', 'name="c1_') + xml[end:]


def _aten_ops(m, d) -> int:
    from ambersim_tpu_torch.engine import smooth

    smooth.fwd_actuation(m, d)  # the plan and its index tensors, built once
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        smooth.fwd_actuation(m, d)
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


@pytest.mark.parametrize("name", ["trn_extra", "thruster", "refsite_arm", "adhesion_box"])
def test_actuation_ops_do_not_grow_with_actuators(name):
    """The actuation stage's aten ops with each fixture's actuators and with
    twice as many of each kind: equal, since one batch holds each kind's
    actuators (`smooth.trn_plan`)."""
    from ambersim_tpu_torch.engine import make_data, smooth
    from ambersim_tpu_torch.engine.forward import fwd_position

    xml = wp.TRN_FIXTURES[name][0]
    counts = []
    for text in (xml, _doubled(xml)):
        m = chip_smoke.xml_model(text, "cpu")
        d = smooth.fwd_velocity(m, fwd_position(m, make_data(m, 2)))
        counts.append(_aten_ops(m, d))
    assert chip_smoke.xml_model(_doubled(xml), "cpu").skel.nu == 2 * chip_smoke.xml_model(xml, "cpu").skel.nu
    assert counts[0] == counts[1] > 0, counts
