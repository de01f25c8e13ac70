"""The port's three capsule narrowphases (sphere-capsule, capsule-capsule,
capsule-box) against the JAX package's functions (CPU, eager jnp), on
numpy-seeded poses plus the hand-built edge cases: parallel and crossing
capsules, a capsule endpoint inside a box, a capsule lying across a box
face (its segment point on the face) and a sphere centered on a capsule's
axis. Bars: dist, pos and frame at rtol/atol 1e-5, and every output finite
(the parallel-segment guard must not leak an inf or a NaN through the
branch it does not take). A capsule-box contact's normal is the
direction from its point to the box surface, dd = |dist + r| away: float32
rounding of the points (~3e-8) turns it by ~3e-8 / dd, past 1e-5 below
dd = 3e-3, and at dd = 0 (a segment that meets the box, where the
alternating projection converges onto the surface) it is undefined in both
packages (the JAX package returns a zero normal). So pos and frame are
compared at the contacts with dd >= 3e-3, dist at all.
"""

import numpy as np
import pytest
import torch

TOL = 1e-5
P = 64  # random pairs per case


def _rot(q: np.ndarray) -> np.ndarray:
    """(P, 4) unnormalized quaternions -> (P, 3, 3) rotation matrices."""
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def _axis_z_to(a: np.ndarray) -> np.ndarray:
    """(P, 3) unit axes -> (P, 3, 3) rotations whose z column is the axis."""
    t = np.where(np.abs(a[:, :1]) < 0.9, [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]])
    x = np.cross(t, a)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return np.stack([x, np.cross(a, x), a], -1).astype(np.float32)


def _random(rng, spread: float):
    xp = (spread * rng.standard_normal((P, 3))).astype(np.float32)
    return xp, _rot(rng.standard_normal((P, 4)))


def _sizes(rng, kind: str) -> np.ndarray:
    if kind == "sphere":
        return np.stack([rng.uniform(0.02, 0.1, P), np.zeros(P), np.zeros(P)], -1).astype(np.float32)
    if kind == "capsule":
        return np.stack([rng.uniform(0.01, 0.05, P), rng.uniform(0.03, 0.15, P), np.zeros(P)], -1).astype(np.float32)
    return rng.uniform(0.03, 0.12, (P, 3)).astype(np.float32)


def _case(name: str):
    """(pair function name, xp1, xm1, s1, xp2, xm2, s2) numpy arrays."""
    rng = np.random.default_rng(sum(map(ord, name)))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (P, 3, 3)).copy()
    if name == "sphere_capsule_random":
        (xp1, xm1), (xp2, xm2) = _random(rng, 0.08), _random(rng, 0.08)
        return "sphere_capsule", xp1, xm1, _sizes(rng, "sphere"), xp2, xm2, _sizes(rng, "capsule")
    if name == "sphere_capsule_on_axis":
        # centers on the capsule's axis, inside and past its segment (the
        # concentric fallback normal at t inside the segment)
        (xp2, xm2), s2 = _random(rng, 0.05), _sizes(rng, "capsule")
        t = rng.uniform(-1.5, 1.5, P).astype(np.float32) * s2[:, 1]
        xp1 = xp2 + t[:, None] * xm2[:, :, 2]
        return "sphere_capsule", xp1, eye, _sizes(rng, "sphere"), xp2, xm2, s2
    if name == "capsule_capsule_random":
        (xp1, xm1), (xp2, xm2) = _random(rng, 0.08), _random(rng, 0.08)
        return "capsule_capsule", xp1, xm1, _sizes(rng, "capsule"), xp2, xm2, _sizes(rng, "capsule")
    if name == "capsule_capsule_parallel":
        # the same axis (half of them flipped), offset sideways and along it
        (xp1, xm1) = _random(rng, 0.05)
        flip = np.where(np.arange(P) % 2 == 0, 1.0, -1.0).astype(np.float32)
        xm2 = np.stack([xm1[:, :, 0], flip[:, None] * xm1[:, :, 1], flip[:, None] * xm1[:, :, 2]], -1)
        side = rng.uniform(0.0, 0.08, P).astype(np.float32)[:, None] * xm1[:, :, 0]
        along = rng.uniform(-0.2, 0.2, P).astype(np.float32)[:, None] * xm1[:, :, 2]
        return "capsule_capsule", xp1, xm1, _sizes(rng, "capsule"), xp1 + side + along, xm2, _sizes(rng, "capsule")
    if name == "capsule_capsule_crossing":
        # perpendicular axes crossing at (or 0-5 cm off) each other's midpoints
        (xp1, xm1) = _random(rng, 0.05)
        a2 = np.cross(xm1[:, :, 2], rng.standard_normal((P, 3)))
        xm2 = _axis_z_to(a2 / np.linalg.norm(a2, axis=-1, keepdims=True))
        off = np.where(np.arange(P)[:, None] < 8, 0.0, rng.uniform(0.0, 0.05, (P, 1)))
        n = np.cross(xm1[:, :, 2], xm2[:, :, 2])
        xp2 = (xp1 + off * n).astype(np.float32)
        return "capsule_capsule", xp1, xm1, _sizes(rng, "capsule"), xp2, xm2, _sizes(rng, "capsule")
    if name == "capsule_box_random":
        (xp1, xm1), (xp2, xm2) = _random(rng, 0.08), _random(rng, 0.08)
        return "capsule_box", xp1, xm1, _sizes(rng, "capsule"), xp2, xm2, _sizes(rng, "box")
    if name == "capsule_box_endpoint_inside":
        # the capsule's +axis endpoint at a random point inside the box
        (xp2, xm2), s2, s1 = _random(rng, 0.05), _sizes(rng, "box"), _sizes(rng, "capsule")
        xm1 = _rot(rng.standard_normal((P, 4)))
        inside = xp2 + np.einsum("pij,pj->pi", xm2, rng.uniform(-0.8, 0.8, (P, 3)) * s2)
        xp1 = (inside - s1[:, 1:2] * xm1[:, :, 2]).astype(np.float32)
        return "capsule_box", xp1, xm1, s1, xp2, xm2, s2
    if name == "capsule_box_across_face":
        # a capsule lying across the box's +z face, its endpoints past the
        # face's edges, so the contact is the segment point on the face
        (xp2, xm2), s2 = _random(rng, 0.05), _sizes(rng, "box")
        s1 = np.stack([np.full(P, 0.01), 2.0 * s2.max(-1), np.zeros(P)], -1).astype(np.float32)
        lift = rng.uniform(-0.005, 0.02, P).astype(np.float32)
        xp1 = xp2 + (s2[:, 2] + s1[:, 0] + lift)[:, None] * xm2[:, :, 2]
        ang = rng.uniform(0, np.pi, P)
        a = np.cos(ang)[:, None] * xm2[:, :, 0] + np.sin(ang)[:, None] * xm2[:, :, 1]
        return "capsule_box", xp1.astype(np.float32), _axis_z_to(a), s1, xp2, xm2, s2
    raise KeyError(name)


CASES = ["sphere_capsule_random", "sphere_capsule_on_axis", "capsule_capsule_random", "capsule_capsule_parallel",
         "capsule_capsule_crossing", "capsule_box_random", "capsule_box_endpoint_inside", "capsule_box_across_face"]


@pytest.mark.parametrize("name", CASES)
def test_capsule_pair_matches_jax(name):
    import jax.numpy as jnp

    from ambersim_tpu.engine import collision as jcol
    from ambersim_tpu_torch.engine import collision

    fn, *args = _case(name)
    want = [np.asarray(x) for x in getattr(jcol, fn)(*(jnp.asarray(a) for a in args))]
    got = getattr(collision, fn)(*(torch.as_tensor(a) for a in args))
    k = {"sphere_capsule": 1, "capsule_capsule": 1, "capsule_box": 3}[fn]
    defined = np.ones((P, k), bool)
    if fn == "capsule_box":
        defined = np.abs(want[0] + args[2][:, :1]) >= 3e-3
        assert defined.mean() > 0.6
    for what, g, w in zip(("dist", "pos", "frame"), got, want):
        assert g.shape == (P, k) + w.shape[2:] and torch.isfinite(g).all(), (what, g.shape)
        keep = np.ones((P, k), bool) if what == "dist" else defined
        np.testing.assert_allclose(g.numpy()[keep], w[keep], rtol=TOL, atol=TOL, err_msg=f"{name} {what}")


def test_edge_cases_reach_their_geometry():
    """The hand-built cases are what they say: parallel capsules take the
    guarded branch, crossing capsules touch or overlap, an endpoint inside
    the box gives a negative distance in slot 0 (the +axis endpoint), and
    across a face the segment point (slot 2) is the deepest contact with a
    normal along the face's axis."""
    from ambersim_tpu_torch.engine import collision

    def run(name):
        fn, *args = _case(name)
        return args, getattr(collision, fn)(*(torch.as_tensor(a) for a in args))

    (_, xm1, _, _, xm2, _), _ = run("capsule_capsule_parallel")
    d12 = np.einsum("pi,pi->p", xm1[:, :, 2], xm2[:, :, 2])
    assert (np.abs(1.0 - d12 * d12) <= 1e-9).mean() > 0.5
    (_, _, s1, _, _, s2), (dist, _, _) = run("capsule_capsule_crossing")
    assert (dist[:8, 0].numpy() <= -(s1[:8, 0] + s2[:8, 0]) + 1e-6).all()
    _, (dist, _, _) = run("capsule_box_endpoint_inside")
    assert (dist[:, 0] < 0).all()
    (_, _, _, _, xm2, _), (dist, _, frame) = run("capsule_box_across_face")
    assert (dist[:, 2] <= dist[:, :2].min(-1).values + 1e-7).all()
    np.testing.assert_allclose(np.abs(np.einsum("pi,pi->p", frame[:, 2, 0].numpy(), xm2[:, :, 2])), 1.0, atol=1e-5)
