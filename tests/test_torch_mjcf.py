"""The port's MJCF/URDF compiler (ambersim_tpu_torch.mjcf, a numpy-only
copy of the JAX package's) against the JAX package's compiler.

`compile_spec_arrays` must give the JAX package's `compile_spec` run through
`tools/export_model_npz.model_arrays` bit for bit, on every Skeleton field
and every leaf, for every model file under ambersim_tpu/models/, the
parser-feature fixtures of tests/test_frame.py, test_composite.py and
test_keyframes.py, and the bridge's out-of-slice fixtures. The three fields
`set_constants` derives come from the port's own float32 smooth pass
(eager torch on the CPU, where the JAX package's is XLA's): qM differs in
its last bits, and its inverse carries that by qM's condition number. So
they are held at `chip_smoke.setconst_rtol`, cond(qM at qpos0) x 2^-24
(float32's unit roundoff), floored at 1e-6. Measured: 4.1e-5 of a bar of 5.3e-4 on
the floating URDF pendulum (cond 8.9e3), 2.8e-6 of 1.9e-4 on the humanoid
(cond 3.2e3), 1.5e-7 of 3.2e-5 on the quadruped (cond 545). The full
loader must also give the committed asset files, with the exporter's
options.
"""

import glob
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from test_composite import CABLE_CURVE_XML, REPLICATE_XML
from test_frame import FRAME_XML
from test_keyframes import KEYED
from test_torch_bridge import (
    CONDIM46_XML,
    EXPLICIT_PAIR_XML,
    HAND_WELD_XML,
    HFIELD_SPHERE_XML,
    RK4_XML,
    TENDON_SENSOR_XML,
)
from tools.export_model_npz import ASSETS, ASSETS_DIR, model_arrays

REPO = Path(__file__).resolve().parent.parent
MODELS = REPO / "ambersim_tpu" / "models"
MODEL_FILES = sorted(str(Path(f).relative_to(MODELS)) for f in glob.glob(str(MODELS / "**" / "*.xml"), recursive=True))
SETCONST = ("dof_invweight0", "body_invweight0", "actuator_acc0", "tendon_invweight0")

FIXTURES = {
    "frame": FRAME_XML,
    "replicate": REPLICATE_XML,
    "cable_curve": CABLE_CURVE_XML,
    "keyframes": KEYED,
    "hand_weld": HAND_WELD_XML,
    "condim46": CONDIM46_XML,
    "hfield_sphere": HFIELD_SPHERE_XML,
    "explicit_pair": EXPLICIT_PAIR_XML,
    "rk4": RK4_XML,
}


def assert_fields_equal(got: dict, want: dict, skip=()) -> None:
    """Same keys; arrays equal bit for bit with the same dtype and shape,
    other values equal with the same type."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert type(g) is type(w) and g == w, k


def assert_setconst_close(got_skel: dict, got: dict, want: dict) -> None:
    rtol = chip_smoke.setconst_rtol(got_skel, got)
    for k in SETCONST:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0.0, err_msg=k)


def jax_spec(source):
    from ambersim_tpu.mjcf.parser import parse_mjcf, parse_mjcf_string

    return parse_mjcf(source) if source.endswith(".xml") else parse_mjcf_string(source)


def port_spec(source):
    from ambersim_tpu_torch.mjcf import parse_mjcf, parse_mjcf_string

    return parse_mjcf(source) if source.endswith(".xml") else parse_mjcf_string(source)


def check_against_jax(source, setconst: bool = True) -> None:
    """Both compilers on `source` (a path or an XML string): the arrays bit
    for bit, then with set_constants on both, the setconst fields within
    chip_smoke.setconst_rtol and every other field still bit for bit."""
    from ambersim_tpu.engine.setconst import set_constants as jax_set_constants
    from ambersim_tpu.mjcf import compile_spec
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.mjcf import compile_spec_arrays

    jm = compile_spec(jax_spec(source))
    want_skel, want = model_arrays(jm)
    got_skel, got = compile_spec_arrays(port_spec(source))
    assert_fields_equal(got_skel, want_skel)
    assert_fields_equal(got, want)
    if setconst:
        _, want_c = model_arrays(jax_set_constants(jm))
        got_c = set_constants(got_skel, got)
        assert_fields_equal(got_c, want_c, skip=SETCONST)
        assert_setconst_close(got_skel, got_c, want_c)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("path", MODEL_FILES)
def test_compile_spec_arrays_matches_jax_on_every_model_file(path):
    check_against_jax(str(MODELS / path))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_compile_spec_arrays_matches_jax_on_parser_fixtures(name):
    check_against_jax(FIXTURES[name])


def test_tendon_model_compiles_and_set_constants_matches_jax():
    """A fixed tendon compiles to the JAX package's arrays, and
    set_constants gives the JAX package's tendon fields: tendon_length0 and
    the springlength range bit for bit, tendon_invweight0 within
    cond(qM) x 2^-24 (the port's float32 smooth pass gives ten_J)."""
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.mjcf import compile_spec_arrays

    check_against_jax(TENDON_SENSOR_XML)
    skel, leaves = compile_spec_arrays(port_spec(TENDON_SENSOR_XML))
    assert skel["ntendon"] == 1
    assert set_constants(skel, leaves)["tendon_invweight0"].all()


SITE_TRANSMISSION_XML = """
<mujoco><worldbody>
  <body><joint name="a" axis="0 1 0"/><geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"/>
    <site name="tip" pos="0 0 -0.3"/></body>
</worldbody>
<actuator><general site="tip" gear="1 0 0 0 0 0"/></actuator>
</mujoco>
"""

# motors on a free joint (six gear components) and a ball joint (three)
FREE_BALL_MOTORS_XML = """
<mujoco><worldbody>
  <body pos="0 0 1"><freejoint name="f"/><geom type="box" size="0.1 0.05 0.02" mass="1"/>
    <body pos="0.2 0 0"><joint name="b" type="ball"/><geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/></body>
  </body>
</worldbody>
<actuator>
  <motor joint="f" gear="1 0.5 0 0.2 0 0.3"/>
  <motor joint="b" gear="0.4 1 0.7"/>
</actuator>
</mujoco>
"""


def test_site_transmission_is_refused_by_name():
    """A site transmission, once refused by name, compiles, and
    set_constants gives the JAX package's actuator_acc0 over its moment."""
    check_against_jax(SITE_TRANSMISSION_XML)


def test_free_and_ball_joint_transmissions_match_jax():
    """actuator_moment's free and ball JOINT transmissions (gear vectors on
    the joint's dofs) against the JAX package's at qpos0, and acc0 from
    them; the bridge admits the model."""
    import jax

    from ambersim_tpu.engine import make_data as jax_make_data
    from ambersim_tpu.engine import smooth as jax_smooth
    from ambersim_tpu.mjcf import compile_spec
    from ambersim_tpu_torch.engine import make_data, smooth
    from ambersim_tpu_torch.io.bridge import build_model, model_from_numpy
    from ambersim_tpu_torch.mjcf import compile_spec_arrays

    check_against_jax(FREE_BALL_MOTORS_XML)
    jm = compile_spec(jax_spec(FREE_BALL_MOTORS_XML))
    jd = jax.jit(jax_smooth.fwd_position_smooth)(jm, jax_make_data(jm))
    want = np.asarray(jax.jit(jax_smooth.actuator_moment)(jm, jd))
    skel, leaves = compile_spec_arrays(port_spec(FREE_BALL_MOTORS_XML))
    m = build_model(skel, leaves, device="cpu")
    got = smooth.actuator_moment(m, smooth.fwd_position_smooth(m, make_data(m, 2)))
    assert got.shape == (2, 2, 9)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), want)
    assert model_from_numpy(skel, leaves, device="cpu").skel.nu == 2


@pytest.mark.parametrize("name", list(ASSETS))
def test_loader_matches_committed_asset(name):
    """The port's full loader (compile, set_constants, build) with the
    exporter's options (chip_smoke.compile_asset, which splices the row cap
    into the XML as benchmarks/ladder.py:133-142 and the exporter do) gives
    the committed assets/<name>.npz: every field bit for bit but the
    setconst ones, those within chip_smoke.setconst_rtol."""
    from ambersim_tpu_torch.io.bridge import unpack_npz

    with np.load(ASSETS_DIR / f"{name}.npz", allow_pickle=False) as npz:
        want_skel, want = unpack_npz(npz)
    got_skel, got = chip_smoke.model_numpy(chip_smoke.compile_asset(name, "cpu"))
    # the npz's JSON gives back tuples where the Skeleton held lists of tuples
    for k, v in want_skel.items():
        if not isinstance(v, np.ndarray):
            assert got_skel[k] == v, k
    assert_fields_equal({k: v for k, v in got_skel.items() if isinstance(v, np.ndarray)},
                        {k: v for k, v in want_skel.items() if isinstance(v, np.ndarray)})
    assert set(got_skel) == set(want_skel)
    assert_fields_equal(got, want, skip=SETCONST)
    assert_setconst_close(got_skel, got, want)


def test_compile_spec_and_load_model():
    """compile_spec builds a Model without the setconst fields (as the JAX
    package's); mjcf.load_model adds them and equals load_model_from_file;
    the package's top-level load_model still takes an asset name."""
    import ambersim_tpu_torch
    from ambersim_tpu_torch import mjcf
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    path = str(MODELS / "arm3" / "arm3.xml")
    bare = mjcf.compile_spec(mjcf.parse_mjcf(path), device="cpu")
    assert bare.device.type == "cpu" and not bare.dof_invweight0.any() and not bare.actuator_acc0.any()
    full = mjcf.load_model(path, device="cpu")
    ref = load_model_from_file(path, device="cpu")
    assert full.skel == ref.skel == bare.skel
    assert_fields_equal(chip_smoke.model_numpy(full)[1], chip_smoke.model_numpy(ref)[1])
    assert full.dof_invweight0.all()
    asset = ambersim_tpu_torch.load_model("arm3", device="cpu")
    assert asset.skel == full.skel
    assert mjcf.compile_spec(port_spec(SITE_TRANSMISSION_XML), device="cpu").skel.nu == 1


def test_chip_smoke_copies_match_their_sources():
    """chip_smoke.py imports nothing of tools/ or tests/: its copies of the
    exporter's asset table and of the gripper URDF fixture must match."""
    from test_model_io import GRIPPER_URDF

    assert chip_smoke.COMPILED_ASSETS == ASSETS
    assert chip_smoke.GRIPPER_URDF == GRIPPER_URDF


def test_compare_compiled_holds_mesh_fields_up_to_qhull_order():
    """chip_smoke's comparison of a compiled model against its committed
    file: the rock passes as compiled; with its hull's vertices, faces and
    edges (and each edge's endpoints) permuted, its canonical form is
    unchanged; a moved vertex fails."""
    m = chip_smoke.compile_asset("rock", "cpu")
    assert "qhull's order of the committed file" in chip_smoke.compare_compiled("rock", m)
    skel, leaves = chip_smoke.model_numpy(m)
    rng = np.random.default_rng(0)
    nv, nf, ne = (int(skel[k][0]) for k in ("mesh_vertnum", "mesh_facenum", "mesh_edgenum"))
    perm = dict(leaves)
    perm_skel = dict(skel)
    pv, pf, pe = rng.permutation(nv), rng.permutation(nf), rng.permutation(ne)
    perm["mesh_vert"] = leaves["mesh_vert"].copy()
    perm["mesh_vert"][0, :nv] = leaves["mesh_vert"][0, pv]
    for k in ("mesh_face_normal", "mesh_face_dist", "mesh_face_vert"):
        perm[k] = leaves[k].copy()
        perm[k][0, :nf] = leaves[k][0, pf]
    perm_skel["mesh_face_nvert"] = skel["mesh_face_nvert"].copy()
    perm_skel["mesh_face_nvert"][0, :nf] = skel["mesh_face_nvert"][0, pf]
    perm["mesh_edge"] = leaves["mesh_edge"].copy()
    perm["mesh_edge"][0, :ne] = leaves["mesh_edge"][0, pe][:, ::-1]
    want = chip_smoke.mesh_canonical(skel, leaves, 0)
    for g, w in zip(chip_smoke.mesh_canonical(perm_skel, perm, 0), want):
        np.testing.assert_array_equal(g, w)
    perm["mesh_vert"][0, 0] += 1e-3
    assert not np.allclose(chip_smoke.mesh_canonical(perm_skel, perm, 0)[0], want[0])
