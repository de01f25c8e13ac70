"""The port's mesh narrowphases (engine/collision.py: plane_mesh,
sphere_mesh, capsule_mesh, box_mesh, mesh_mesh), plane_cylinder,
plane_ellipsoid and convex.mesh_hull against the JAX package's functions
(CPU, jitted), on numpy-seeded poses against the rock's compiled hull
(64 vertices, 124 triangles, 186 edges) and the compiler's synthesized
cylinder hull (40 of 74 vertex slots real, 20-vertex cap rings), plus the
hand-built edge cases: a cylinder's cap resting flat on the plane (its 20
rim vertices tie exactly: the stable sort takes the lowest indices), a rock
face flat on the plane, a sphere centered inside the hull, a capsule
through the hull, a box face-on against a hull face and a box against the
cylinder hull (rings of 4 and 20 vertices, padded to one width), and an
upright cylinder on the plane (its axis along the normal). Then the whole
collision of a scene with every mesh pair type (cylinder and ellipsoid
hulls met by a capsule, a box and each other), without and with a
broadphase cap (mesh ids gathered from the selected pairs), field by field.

Bars: dist, pos and frame (and the hull arrays) at rtol/atol 1e-5, as
tests/test_torch_capsule_pairs.py, and every output finite. A rock face
turned flat has its three vertices at one depth only up to the float32
rounding of the rotation, which the two packages sum in different orders,
so there the 4 contacts are compared as a set (each pair's slots ordered
by position).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

TOL = 1e-5
P = 64  # random pairs per case
# mesh_mesh's pairs: the rock against the cylinder hull has 186 x 156 edge
# axes, each projected on 64 + 74 vertices (~50 MB of temporaries a pair)
MESH_MESH_P = 4

# a cylinder and an ellipsoid that the compiler turns into hulls for their
# non-plane pairs, a capsule and a box among them
MESH_SCENE = """
<mujoco><worldbody>
  <geom type="plane" size="0 0 1"/>
  <body pos="0 0 0.05"><freejoint/><geom type="cylinder" size="0.1 0.05"/></body>
  <body pos="0.02 0 0.125"><freejoint/><geom type="capsule" size="0.03 0.1" euler="0 1.5 0"/></body>
  <body pos="0.16 0 0.05"><freejoint/><geom type="ellipsoid" size="0.06 0.04 0.05"/></body>
  <body pos="0.08 0.12 0.05"><freejoint/><geom type="box" size="0.05 0.04 0.05"/></body>
</worldbody></mujoco>
"""


def _rot(q: np.ndarray) -> np.ndarray:
    """(P, 4) unnormalized quaternions -> (P, 3, 3) rotation matrices."""
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def _align(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P, 3, 3) rotations taking unit vectors a (P, 3) onto b (P, 3)."""
    v, c = np.cross(a, b), np.einsum("pi,pi->p", a, b)
    k = np.zeros((len(a), 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -v[:, 2], v[:, 1], -v[:, 0]
    k -= np.swapaxes(k, 1, 2)
    return (np.eye(3) + k + k @ k / (1.0 + c)[:, None, None]).astype(np.float32)


@pytest.fixture(scope="module")
def hulls():
    """name -> the JAX package's mesh tuple of one hull (numpy): the rock's
    and the MESH_SCENE cylinder's."""
    rock = tp.jax_asset_model("rock")
    scene = tp.jax_model_from_xml(MESH_SCENE)

    def tuple_of(jm, mid):
        s = jm.skel
        mask = np.arange(jm.mesh_vert.shape[1]) < int(s.mesh_vertnum[mid])
        return tuple(np.asarray(x) for x in (jm.mesh_vert[mid], mask, jm.mesh_face_normal[mid],
                                             jm.mesh_face_dist[mid], jm.mesh_face_vert[mid], jm.mesh_edge[mid]))

    return {"rock": tuple_of(rock, 0), "cylinder": tuple_of(scene, int(scene.skel.geom_meshid[1]))}


def _tile(mesh):
    return tuple(np.broadcast_to(x, (P,) + x.shape).copy() for x in mesh)


def _sizes(rng, kind: str) -> np.ndarray:
    if kind == "sphere":
        return np.stack([rng.uniform(0.02, 0.08, P), np.zeros(P), np.zeros(P)], -1).astype(np.float32)
    if kind == "capsule":
        return np.stack([rng.uniform(0.01, 0.05, P), rng.uniform(0.03, 0.15, P), np.zeros(P)], -1).astype(np.float32)
    if kind == "cylinder":
        return np.stack([rng.uniform(0.02, 0.1, P), rng.uniform(0.02, 0.1, P), np.zeros(P)], -1).astype(np.float32)
    return rng.uniform(0.02, 0.1, (P, 3)).astype(np.float32)  # box half-sizes, ellipsoid radii


def _case(name: str, hulls):
    """(pair function, args as numpy) for the functions of
    engine/collision.py: poses and sizes, then the mesh tuples."""
    rng = np.random.default_rng(sum(map(ord, name)))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (P, 3, 3)).copy()
    zeros = np.zeros((P, 3), np.float32)

    def pose(spread=0.08):
        return (spread * rng.standard_normal((P, 3))).astype(np.float32), _rot(rng.standard_normal((P, 4)))

    plane = (zeros, _rot(rng.standard_normal((P, 4))), zeros)  # a plane through the origin, tilted
    rock, cyl = _tile(hulls["rock"]), _tile(hulls["cylinder"])
    if name == "plane_mesh_random":
        return "plane_mesh", (*plane, *pose(0.05), zeros, rock)
    if name == "plane_mesh_cylinder_cap_flat":
        # the cylinder hull upright on the level floor, its lower cap 0-5 mm
        # deep: 20 rim vertices at exactly one depth (identity rotation)
        xp = np.zeros((P, 3), np.float32)
        xp[:, 2] = (0.05 - rng.uniform(0.0, 0.005, P)).astype(np.float32)
        return "plane_mesh", (zeros, eye, zeros, xp, eye, zeros, cyl)
    if name == "plane_mesh_rock_face_flat":
        # a rock face turned to face straight down onto the level floor
        f = rng.integers(0, 124, P)
        xm = _align(hulls["rock"][2][f], np.broadcast_to([0.0, 0.0, -1.0], (P, 3)))
        xp = np.zeros((P, 3), np.float32)
        xp[:, 2] = hulls["rock"][3][f] - rng.uniform(0.0, 0.005, P)
        return "plane_mesh", (zeros, eye, zeros, xp, xm, zeros, rock)
    if name == "sphere_mesh_random":
        return "sphere_mesh", (*pose(), _sizes(rng, "sphere"), *pose(), zeros, rock)
    if name == "sphere_mesh_inside":
        # centers at random convex combinations of the hull's vertices
        xp2, xm2 = pose()
        w = rng.dirichlet(np.ones(64), P)
        local = w @ hulls["rock"][0]
        xp1 = (xp2 + np.einsum("pij,pj->pi", xm2, local)).astype(np.float32)
        return "sphere_mesh", (xp1, eye, _sizes(rng, "sphere"), xp2, xm2, zeros, rock)
    if name == "capsule_mesh_random":
        return "capsule_mesh", (*pose(), _sizes(rng, "capsule"), *pose(), zeros, rock)
    if name == "capsule_mesh_through":
        # capsules centered within 2 cm of the hull's center, longer than it
        xp2, xm2 = pose()
        s1 = np.stack([rng.uniform(0.01, 0.03, P), rng.uniform(0.15, 0.25, P), np.zeros(P)], -1).astype(np.float32)
        xp1 = (xp2 + 0.02 * rng.standard_normal((P, 3))).astype(np.float32)
        return "capsule_mesh", (xp1, _rot(rng.standard_normal((P, 4))), s1, xp2, xm2, zeros, rock)
    if name == "box_mesh_random":
        return "box_mesh", (*pose(), _sizes(rng, "box"), *pose(), zeros, rock)
    if name == "box_mesh_face_on":
        # a box's -z face on a rock face, 0-3 mm deep, turned about the
        # normal and tilted by 2-6 degrees: exactly parallel faces would tie
        # the two face axes to the rounding of the SAT, and either face may
        # then be the reference
        xp2, xm2 = pose(0.02)
        f = rng.integers(0, 124, P)
        n_w = np.einsum("pij,pj->pi", xm2, hulls["rock"][2][f])
        spin, tilt, about = rng.uniform(0, 2 * np.pi, P), rng.uniform(0.035, 0.1, P), rng.uniform(0, 2 * np.pi, P)
        twist = np.stack([np.cos(spin / 2), 0 * spin, 0 * spin, np.sin(spin / 2)], -1)
        lean = np.stack([np.cos(tilt / 2), np.sin(tilt / 2) * np.cos(about), np.sin(tilt / 2) * np.sin(about),
                         0 * tilt], -1)
        xm1 = _align(np.broadcast_to([0.0, 0.0, -1.0], (P, 3)), -n_w) @ _rot(lean) @ _rot(twist)
        s1 = _sizes(rng, "box") * np.array([1.0, 1.0, 0.5], np.float32)
        foot = xp2 + np.einsum("pij,pj->pi", xm2, hulls["rock"][2][f] * hulls["rock"][3][f][:, None])
        xp1 = (foot + n_w * (s1[:, 2] - rng.uniform(0.0, 0.003, P))[:, None]).astype(np.float32)
        return "box_mesh", (xp1, xm1.astype(np.float32), s1, xp2, xm2, zeros, rock)
    if name == "box_mesh_cylinder":
        return "box_mesh", (*pose(0.06), _sizes(rng, "box"), *pose(0.06), zeros, cyl)
    if name == "mesh_mesh_rock_cylinder":
        return "mesh_mesh", (*pose(0.06), zeros, *pose(0.06), zeros, rock, cyl)
    if name == "plane_cylinder_random":
        return "plane_cylinder", (*plane, *pose(0.05), _sizes(rng, "cylinder"))
    if name == "plane_cylinder_upright":
        # the axis along the plane normal (the tangent fallback), either way up
        flip = np.where(np.arange(P) % 2 == 0, 1.0, -1.0).astype(np.float32)
        xm2 = eye * np.stack([np.ones(P), flip, flip], -1)[:, None, :]
        xp2 = (0.03 * rng.standard_normal((P, 3))).astype(np.float32)
        return "plane_cylinder", (zeros, eye, zeros, xp2, xm2.astype(np.float32), _sizes(rng, "cylinder"))
    if name == "plane_ellipsoid_random":
        return "plane_ellipsoid", (*plane, *pose(0.05), _sizes(rng, "box"))
    raise KeyError(name)


CASES = ["plane_mesh_random", "plane_mesh_cylinder_cap_flat", "plane_mesh_rock_face_flat", "sphere_mesh_random",
         "sphere_mesh_inside", "capsule_mesh_random", "capsule_mesh_through", "box_mesh_random", "box_mesh_face_on",
         "box_mesh_cylinder", "mesh_mesh_rock_cylinder", "plane_cylinder_random", "plane_cylinder_upright",
         "plane_ellipsoid_random"]
K = {"plane_mesh": 4, "sphere_mesh": 1, "capsule_mesh": 3, "box_mesh": 4, "mesh_mesh": 4, "plane_cylinder": 4,
     "plane_ellipsoid": 1}


def _as(args, convert):
    return [tuple(convert(y) for y in a) if isinstance(a, tuple) else convert(a) for a in args]


def _by_position(dist, pos, frame):
    """Each pair's contact slots ordered by their x position."""
    order = np.argsort(pos[..., 0], axis=-1)
    return (np.take_along_axis(dist, order, -1), np.take_along_axis(pos, order[..., None], -2),
            np.take_along_axis(frame, order[..., None, None], -3))


@pytest.mark.parametrize("name", CASES)
def test_mesh_pair_matches_jax(name, hulls):
    from ambersim_tpu.engine import collision as jcol
    from ambersim_tpu_torch.engine import collision

    fn, args = _case(name, hulls)
    if fn == "mesh_mesh":
        args = _as(args, lambda x: x[:MESH_MESH_P])
    want = [np.asarray(x) for x in jax.jit(getattr(jcol, fn))(*_as(args, jnp.asarray))]
    got = [g.numpy() for g in getattr(collision, fn)(*_as(args, torch.as_tensor))]
    if name == "plane_mesh_rock_face_flat":
        got, want = (_by_position(*x) for x in (got, want))
    for what, g, w in zip(("dist", "pos", "frame"), got, want):
        assert g.shape == (len(args[0]), K[fn]) + w.shape[2:] and np.isfinite(g).all(), (what, g.shape)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=f"{name} {what}")


def test_mesh_hull_matches_jax(hulls):
    from ambersim_tpu.engine import convex as jconvex
    from ambersim_tpu_torch.engine import convex

    rng = np.random.default_rng(40)
    xp = (0.1 * rng.standard_normal((P, 3))).astype(np.float32)
    xm = _rot(rng.standard_normal((P, 4)))
    mesh = _tile(hulls["rock"])
    parts = (mesh[0], mesh[2], mesh[4], mesh[5])
    want = jconvex.mesh_hull(jnp.asarray(xp), jnp.asarray(xm), *(jnp.asarray(x) for x in parts))
    got = convex.mesh_hull(torch.as_tensor(xp), torch.as_tensor(xm), *(torch.as_tensor(x) for x in parts))
    for what, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=what)


def test_edge_cases_reach_their_geometry(hulls):
    """The cap resting flat ties exactly and keeps 4 of its rim vertices
    (none of the padding); the face-flat rock touches with its face; a
    sphere inside the hull is deeper than its radius; a capsule through the
    hull has its segment point (slot 2) inside; a face-on box touches the
    hull in nearly every pair."""
    from ambersim_tpu_torch.engine import collision

    def run(name):
        fn, args = _case(name, hulls)
        return args, getattr(collision, fn)(*_as(args, torch.as_tensor))

    (*_, xp, _, _, cyl), (dist, pos, _) = run("plane_mesh_cylinder_cap_flat")
    assert (dist == dist[:, :1]).all() and (dist < 0).all()
    np.testing.assert_array_equal(pos[:, :, :2].numpy(), cyl[0][:, :4, :2] + xp[:, None, :2])
    _, (dist, _, _) = run("plane_mesh_rock_face_flat")
    assert (dist[:, 2] <= 1e-6).all()
    (_, _, s1, *_), (dist, _, _) = run("sphere_mesh_inside")
    assert (dist[:, 0].numpy() < -s1[:, 0]).all()
    _, (dist, _, _) = run("capsule_mesh_through")
    assert (dist[:, 2] < 0).all()
    _, (dist, _, _) = run("box_mesh_face_on")
    assert (dist[:, 0] < 0).float().mean() > 0.9


def _collision_pair(tmp_path, cap: int):
    """(JAX model, the port's model) of MESH_SCENE with a broadphase cap."""
    xml = tmp_path / "mesh_scene.xml"
    xml.write_text(MESH_SCENE)
    jm = tp.jax_model(str(xml), None, cap)
    return jm, tp.torch_model(jm)


@pytest.mark.parametrize("cap", [0, 1], ids=["static", "capped"])
def test_mesh_scene_collision_matches_jax(tmp_path, cap):
    """collision() over MESH_SCENE's 10 pair groups (capsule-mesh, box-mesh,
    mesh-mesh, plane-cylinder, plane-ellipsoid among them) on 4 seeded
    states, without a cap and with every group of 2 or more pairs capped to
    1 (its mesh ids gathered from the pair each env selects)."""
    from ambersim_tpu.core.types import GeomType
    from ambersim_tpu.engine import collision as jcol
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu_torch.engine import collision, smooth

    torch.set_num_threads(1)
    jm, tm = _collision_pair(tmp_path, cap)
    s = jm.skel
    types = {(GeomType(a).name, GeomType(b).name) for a, b in zip(s.pair_ctype1, s.pair_ctype2)}
    assert {("CAPSULE", "MESH"), ("BOX", "MESH"), ("MESH", "MESH"), ("PLANE", "CYLINDER"),
            ("PLANE", "ELLIPSOID")} <= types
    assert (len(s.bpg_nsel) > 0) == bool(cap)
    qpos, qvel = tp.free_body_state(jm, 4, seed=17, pos_scale=1e-2, rot_scale=0.3)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(jax.vmap(lambda d: jcol.collision(jm, jsmooth.fwd_position_smooth(jm, d))))(jd)
    d = tp.torch_batch(tm, jd)
    got = collision.collision(tm, smooth.fwd_position_smooth(tm, d))
    assert (got.contact.dist < 0).any(-1).all()
    for f in ("dist", "pos", "frame", "friction", "solref", "solimp", "includemargin", "geom1", "geom2"):
        g = getattr(got.contact, f)
        assert torch.isfinite(g.float()).all(), f
        tp.assert_close("contact." + f, g, getattr(ref.contact, f), TOL, TOL)
