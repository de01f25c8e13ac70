"""The port's camera and light frames (engine/smooth.camlight) and its
CAMPROJECTION sensor against the JAX package (CPU).

Fixtures: tests/test_camlight.py's CAM_XML (cameras and lights in all five
modes, FIXED, TRACK, TRACKCOM, TARGETBODY and TARGETBODYCOM, on a hinged
body, two of them aimed at a slid body and its child) at uniform random
qpos in [-2, 2) on 4 envs; its test_camlight_in_frame scene (a camera and a
light inside a rotated <frame>) at seeded hinge angles; and
tests/test_torch_bridge.py's CAMPROJECTION_XML (a site projected into a
camera on a turning body). One forward of each package from the same Data.

Bars: the frames within atol 1e-5 (tests/test_camlight.py's own bar
against the MuJoCo oracle); the pixel coordinates, hundreds of pixels,
within rtol 1e-5 and atol 1e-4 (float32's rounding of the focal length
times a ratio of distances).
"""

import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tools import solver_parity as sp
from tools import torch_parity as tp
from tools.weld_parity import np_batch

FRAME_ATOL = 1e-5
PIXEL_TOL = (1e-5, 1e-4)
CAM_FIELDS = ("cam_xpos", "cam_xmat", "light_xpos", "light_xdir")
B = 4


def _in_frame_xml() -> str:
    """test_camlight_in_frame's scene, read as text."""
    text = (chip_smoke.REPO / "tests" / "test_camlight.py").read_text()
    body = text[text.index("def test_camlight_in_frame"):]
    return re.search(r'xml = """(.*?)"""', body, re.S).group(1)


XMLS = {
    "cam_xml": chip_smoke.tests_xml("test_camlight.py", "CAM_XML"),
    "in_frame": _in_frame_xml(),
    "camprojection": chip_smoke.tests_xml("test_torch_bridge.py", "CAMPROJECTION_XML"),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


_CASES: dict = {}


def _forward_pair(name: str, seed: int):
    """(port Data, JAX Data, JAX model) after one forward of each package
    from B envs at uniform random qpos in [-2, 2); the models and the JAX
    package's compiled forward built once a fixture."""
    from ambersim_tpu.engine import forward as jax_forward
    from ambersim_tpu_torch.engine.forward import forward

    jm = _CASES[name][0] if name in _CASES else sp.quick_jax_model(XMLS[name])
    qpos = np.random.default_rng(seed).uniform(-2.0, 2.0, (B, jm.skel.nq)).astype(np.float32)
    jd = np_batch(jm, qpos=qpos)
    if name not in _CASES:
        _CASES[name] = jm, tp.torch_model(jm), sp.compiled(jax.vmap(lambda d: jax_forward(jm, d)), jd)
    _, tm, jfwd = _CASES[name]
    return forward(tm, tp.torch_batch(tm, jd)), jfwd(jd), jm


@pytest.mark.parametrize("name, seed", [("cam_xml", 0), ("cam_xml", 1), ("in_frame", 2)])
def test_camlight_matches_jax(name, seed):
    """Every camera's and light's position and frame or direction, batched
    over the envs, against the JAX package's per-object loop."""
    got, want, jm = _forward_pair(name, seed)
    assert jm.skel.ncam and jm.skel.nlight
    for f in CAM_FIELDS:
        tp.assert_close(f, getattr(got, f), getattr(want, f), 0.0, FRAME_ATOL)


def test_camlight_modes_all_present():
    """CAM_XML holds each of the five modes for cameras and for lights, so
    test_camlight_matches_jax meets every branch."""
    from ambersim_tpu_torch.core.types import CamLightMode

    m = tp.torch_model(sp.quick_jax_model(XMLS["cam_xml"]))
    every = {int(c) for c in CamLightMode}
    assert set(np.asarray(m.skel.cam_mode).tolist()) == every
    assert set(np.asarray(m.skel.light_mode).tolist()) == every


def test_camprojection_matches_jax():
    """The site's pixel coordinates in the camera, through the sensor stage,
    and the camera's frame they are read from."""
    got, want, jm = _forward_pair("camprojection", 3)
    assert jm.skel.nsensordata == 2
    tp.assert_close("cam_xpos", got.cam_xpos, want.cam_xpos, 0.0, FRAME_ATOL)
    tp.assert_close("sensordata", got.sensordata, want.sensordata, *PIXEL_TOL)
    assert torch.isfinite(got.sensordata).all()
