"""The port's model-I/O utilities (ambersim_tpu_torch.utils) against the
JAX package's (ambersim_tpu.utils): path resolution, URDF loading with and
without force_float, the loader's options, XML export, convex
decomposition and the name tables. Models are built on the CPU; every
field but the three setconst ones must equal the JAX package's loader bit
for bit (those within chip_smoke.setconst_rtol).
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from test_model_io import GRIPPER_URDF
from test_torch_mjcf import SETCONST, assert_fields_equal, assert_setconst_close
from tools.export_model_npz import model_arrays

REPO = Path(__file__).resolve().parent.parent
MODELS = REPO / "ambersim_tpu" / "models"
PENDULUM_XML = MODELS / "pendulum" / "pendulum.xml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def gripper(tmp_path):
    p = tmp_path / "gripper.urdf"
    p.write_text(GRIPPER_URDF)
    return str(p)


def assert_model_matches(got, want_jax) -> None:
    got_skel, got = chip_smoke.model_numpy(got)
    want_skel, want = model_arrays(want_jax)
    assert_fields_equal(got_skel, want_skel)
    assert_fields_equal(got, want, skip=SETCONST)
    assert_setconst_close(got_skel, got, want)


@pytest.mark.parametrize("style", ["absolute", "path", "repo_relative", "cwd_relative"])
def test_path_resolution(style, tmp_path, monkeypatch):
    """str/Path x absolute, ROOT-relative and cwd-relative paths all load the
    pendulum (cf. tests/test_model_io.py:52-68)."""
    from ambersim_tpu_torch.utils._internal_utils import ROOT, _check_filepath
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    assert Path(ROOT) == MODELS.parent
    arg = {"absolute": str(PENDULUM_XML), "path": PENDULUM_XML, "repo_relative": "models/pendulum/pendulum.xml",
           "cwd_relative": "pendulum_copy.xml"}[style]
    if style == "cwd_relative":
        shutil.copy(PENDULUM_XML, tmp_path / "pendulum_copy.xml")
        monkeypatch.chdir(tmp_path)
    m = load_model_from_file(arg, device="cpu")
    assert m.skel.nq == 1 and m.skel.nu == 1 and m.device.type == "cpu"
    assert os.path.isabs(_check_filepath(arg))
    with pytest.raises(FileNotFoundError):
        _check_filepath("models/pendulum/no_such_file.xml")


@pytest.mark.parametrize("force_float", [False, True])
@pytest.mark.parametrize("which", ["pendulum_urdf", "gripper_urdf"])
def test_urdf_matches_jax(which, force_float, gripper):
    """URDF -> spec -> model with actuator and mimic synthesis, with and
    without the forced floating base, against the JAX package's loader."""
    from ambersim_tpu.utils.io_utils import load_model_from_file as jax_load
    from ambersim_tpu_torch.utils.introspection_utils import get_equality_names, get_joint_names
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    path = str(MODELS / "pendulum" / "pendulum.urdf") if which == "pendulum_urdf" else gripper
    got = load_model_from_file(path, force_float=force_float, device="cpu")
    assert_model_matches(got, jax_load(path, force_float=force_float))
    assert (got.skel.nq == 8 if which == "pendulum_urdf" else got.skel.nq == 9) == force_float
    if which == "gripper_urdf":
        assert get_equality_names(got) == ["finger2_joint_mimic"]
        np.testing.assert_allclose(got.eq_data[0, :2].numpy(), [0.1, 0.5])
        assert get_joint_names(got)[-2:] == ["finger1_joint", "finger2_joint"]


OPTION_CASES = {
    "cone": ("models/quadruped/quadruped.xml", dict(cone="elliptic")),
    "broadphase_cap": ("models/objects/clutter32.xml", dict(broadphase_cap=48)),
    "solver_iterations": ("models/arm3/arm3.xml", dict(solver="newton", iterations=7, ls_iterations=3)),
    "hessian_bf16": ("models/objects/clutter32.xml", dict(broadphase_cap=48, hessian_bf16=True)),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_loader_options_match_jax(case):
    from ambersim_tpu.utils.io_utils import load_model_from_file as jax_load
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    path, opt = OPTION_CASES[case]
    got = load_model_from_file(path, device="cpu", **opt)
    assert_model_matches(got, jax_load(path, **opt))


@pytest.mark.parametrize("opt, refused", [
    (dict(solver="pgs"), "the PGS solver"),
    (dict(hessian_bf16=True), "Option.hessian_bf16"),
])
def test_loader_options_outside_the_slice_are_refused(opt, refused):
    """Options the engine lacks are refused by name when the model is built."""
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    with pytest.raises(NotImplementedError, match=refused):
        load_model_from_file("models/quadruped/quadruped.xml", device="cpu", **opt)
    with pytest.raises(ValueError, match="cone must be"):
        load_model_from_file("models/quadruped/quadruped.xml", cone="banana", device="cpu")


def test_load_model_and_data_from_file():
    from ambersim_tpu_torch.utils.io_utils import load_model_and_data_from_file

    m, d = load_model_and_data_from_file("models/pendulum/pendulum.urdf", force_float=True, batch_size=3,
                                         device="cpu")
    assert m.skel.nq == 8 and d.qpos.shape == (3, 8)
    np.testing.assert_array_equal(d.qpos[:, 3:7].numpy(), np.tile([1.0, 0, 0, 0], (3, 1)))


@pytest.mark.parametrize("which", ["gripper_urdf", "pendulum_urdf", "grasp_scene"])
def test_save_model_xml_matches_jax(which, gripper, tmp_path, monkeypatch):
    """save_model_xml writes the JAX package's text, byte for byte."""
    from ambersim_tpu.utils.conversion_utils import save_model_xml as jax_save
    from ambersim_tpu_torch.utils.conversion_utils import save_model_xml

    path = {"gripper_urdf": gripper, "pendulum_urdf": str(MODELS / "pendulum" / "pendulum.urdf"),
            "grasp_scene": str(MODELS / "hand" / "grasp_scene.xml")}[which]
    monkeypatch.chdir(tmp_path)
    got = save_model_xml(path, "port")
    want = jax_save(path, "jax")
    assert got == "port.xml" and want == "jax.xml"
    assert Path(got).read_text() == Path(want).read_text()


def _same_parts(got, want) -> None:
    assert len(got) == len(want)
    for (gv, gf), (wv, wf) in zip(got, want):
        assert gv.dtype == wv.dtype and gf.dtype == wf.dtype
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("mesh", ["rock/rock.obj", "hand/meshes/dist_link.obj"])
def test_convex_decomposition_matches_jax(mesh, tmp_path):
    """convex_decomposition_file against the JAX package's: the same parts,
    bit for bit, and the same files. The rock is one convex part; the
    finger link is concave, so it runs approximate_convex_decomposition's
    seeded plane splitting. Then decomposition_quality on those parts."""
    from ambersim_tpu.utils.conversion_utils import convex_decomposition_file as jax_decompose
    from ambersim_tpu.utils.conversion_utils import decomposition_quality as jax_quality
    from ambersim_tpu_torch.mjcf.mesh import load_obj
    from ambersim_tpu_torch.utils.conversion_utils import convex_decomposition_file, decomposition_quality

    path = str(MODELS / mesh)
    got = convex_decomposition_file(path, savedir=tmp_path / "port")
    want = jax_decompose(path, savedir=tmp_path / "jax")
    _same_parts(got, want)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    verts, faces = load_obj(path)
    assert decomposition_quality(verts, faces, got, n_samples=2000) == jax_quality(verts, faces, want, n_samples=2000)


def test_approximate_convex_decomposition_matches_jax():
    """The approximate decomposition itself on an L-shaped solid (two boxes
    fused), where a single hull overshoots by a third."""
    from ambersim_tpu.mjcf.decompose import approximate_convex_decomposition as jax_acd
    from ambersim_tpu_torch.mjcf.decompose import approximate_convex_decomposition

    verts = np.array([[0, 0, 0], [2, 0, 0], [2, 1, 0], [1, 1, 0], [1, 2, 0], [0, 2, 0],
                      [0, 0, 1], [2, 0, 1], [2, 1, 1], [1, 1, 1], [1, 2, 1], [0, 2, 1]], float)
    bottom = [[0, 2, 1], [0, 3, 2], [0, 4, 3], [0, 5, 4]]
    top = [[6, 7, 8], [6, 8, 9], [6, 9, 10], [6, 10, 11]]
    sides = []
    for i in range(6):
        j = (i + 1) % 6
        sides += [[i, j, j + 6], [i, j + 6, i + 6]]
    faces = np.array(bottom + top + sides)
    got = approximate_convex_decomposition(verts, faces, threshold=0.05, max_convex_hull=4)
    want = jax_acd(verts, faces, threshold=0.05, max_convex_hull=4)
    assert len(got) >= 2
    _same_parts(got, want)


def test_convex_decomposition_dir(tmp_path):
    """convex_decomposition_dir writes every mesh's parts beside it (or to
    savedir), skipping files that are parts already."""
    from ambersim_tpu_torch.utils.conversion_utils import convex_decomposition_dir

    src = tmp_path / "meshes"
    (src / "sub").mkdir(parents=True)
    shutil.copy(MODELS / "rock" / "rock.obj", src / "rock.obj")
    shutil.copy(MODELS / "rock" / "rock.obj", src / "sub" / "stone.obj")
    shutil.copy(MODELS / "rock" / "rock.obj", src / "sub" / "old_col_0.obj")
    convex_decomposition_dir(src)
    assert (src / "rock_col_0.obj").is_file() and (src / "sub" / "stone_col_0.obj").is_file()
    assert not (src / "sub" / "old_col_0_col_0.obj").exists()
    convex_decomposition_dir(src, recursive=False, savedir=tmp_path / "out")
    assert sorted(os.listdir(tmp_path / "out")) == ["rock_col_0.obj"]


def test_introspection_names_match_jax():
    from ambersim_tpu.utils import introspection_utils as J
    from ambersim_tpu.utils.io_utils import load_model_from_file as jax_load
    from ambersim_tpu_torch.utils import introspection_utils as T
    from ambersim_tpu_torch.utils.io_utils import load_model_from_file

    path = "models/hand/grasp_scene.xml"
    got, want = load_model_from_file(path, device="cpu"), jax_load(path)
    for name in ("actuator", "equality", "geom", "joint", "body", "site", "sensor", "tendon", "hfield"):
        g, w = getattr(T, f"get_{name}_names")(got), getattr(J, f"get_{name}_names")(want)
        assert isinstance(g, list) and g == w, name
    assert T.get_joint_names(got)[:3] == ["f1_spread", "f1_prox", "f1_dist"]
