"""The port's box-box narrowphase (engine/convex.py, collision.box_box)
against the JAX package's collision.box_box on numpy-seeded box pairs:
faces pressed together, crossed edges, separated boxes and random poses
near contact. dist, pos and frame are compared slot by slot over the 8
manifold slots; unused slots must be +_BIG in both. Bars: atol 2e-5 on
positions and distances (float32 sums in another order), 1e-5 on frames.

One exception, in the reference's own definition: where no clipped
candidate exists (separated boxes), pos is the midpoint of the two hulls'
support vertices along the normal, and when a hull's support there is a
whole face or edge, its vertices tie and float32 rounding picks any of
them. A pair whose pos differs must be such a pair, must agree along the
normal, where every choice does, and such pairs must be under a tenth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambersim_tpu.engine import collision as jax_collision
from ambersim_tpu_torch.engine import collision, convex

P = 64
ATOL, FRAME_ATOL = 2e-5, 1e-5
BIG = 1e10


def _rot(axis_angle: np.ndarray) -> np.ndarray:
    """(P, 3) rotation vectors -> (P, 3, 3) matrices (Rodrigues)."""
    th = np.linalg.norm(axis_angle, axis=-1, keepdims=True)
    k = axis_angle / np.maximum(th, 1e-12)
    K = np.zeros(axis_angle.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    th = th[..., None]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _pairs(kind: str, seed: int):
    """(xp1, xm1, s1, xp2, xm2, s2) float32 arrays of P box pairs."""
    rng = np.random.default_rng(seed)
    s1 = rng.uniform(0.03, 0.06, (P, 3))
    s2 = rng.uniform(0.03, 0.06, (P, 3))
    xp1 = rng.uniform(-0.2, 0.2, (P, 3))
    if kind == "face":
        # box2 flat on top of box1, turned about z, 1-5 mm deep (with any
        # tilt the reference's SAT takes a near-vertical edge-cross axis)
        r1 = _rot(np.stack([np.zeros(P), np.zeros(P), rng.uniform(-1.0, 1.0, P)], -1))
        r2 = r1 @ _rot(np.stack([np.zeros(P), np.zeros(P), rng.uniform(0.1, 0.7, P)], -1))
        xp2 = xp1 + np.stack([rng.uniform(-0.01, 0.01, P), rng.uniform(-0.01, 0.01, P),
                              s1[:, 2] + s2[:, 2] - rng.uniform(0.001, 0.005, P)], -1)
    elif kind == "edge":
        # a ridge across a ridge: box1 turned 45 deg about x, box2 about y
        r1 = _rot(np.stack([np.full(P, np.pi / 4), np.zeros(P), rng.uniform(-0.05, 0.05, P)], -1))
        r2 = _rot(np.stack([np.zeros(P), np.full(P, np.pi / 4), rng.uniform(-0.05, 0.05, P)], -1))
        h1 = (s1[:, 1] + s1[:, 2]) / np.sqrt(2)  # ridge height above the centers
        h2 = (s2[:, 0] + s2[:, 2]) / np.sqrt(2)
        xp2 = xp1 + np.stack([rng.uniform(-0.005, 0.005, P), rng.uniform(-0.005, 0.005, P),
                              h1 + h2 - rng.uniform(0.001, 0.004, P)], -1)
    else:
        r1 = _rot(rng.standard_normal((P, 3)))
        r2 = _rot(rng.standard_normal((P, 3)))
        gap = rng.uniform(0.05, 0.1, P) if kind == "separated" else rng.uniform(-0.03, 0.0, P)
        direction = rng.standard_normal((P, 3))
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        reach = np.linalg.norm(s1, axis=-1) * 0.8 + np.linalg.norm(s2, axis=-1) * 0.8
        xp2 = xp1 + direction * (reach + gap)[:, None]
    return tuple(x.astype(np.float32) for x in (xp1, r1, s1, xp2, r2, s2))


@pytest.fixture(scope="module")
def jax_box_box():
    return jax.jit(jax_collision.box_box)


@pytest.mark.parametrize("kind, seed", [("face", 0), ("edge", 1), ("separated", 2), ("random", 3)])
def test_box_box_matches_jax(jax_box_box, kind, seed):
    torch.set_num_threads(1)
    args = _pairs(kind, seed)
    want = [np.asarray(x) for x in jax_box_box(*map(jnp.asarray, args))]
    got = [x.numpy() for x in collision.box_box(*map(torch.as_tensor, args))]
    dist, pos, frame = got
    assert dist.shape == (P, 8) and pos.shape == (P, 8, 3) and frame.shape == (P, 8, 3, 3)
    big = want[0] >= BIG / 2
    np.testing.assert_array_equal(dist >= BIG / 2, big)
    np.testing.assert_allclose(dist[~big], want[0][~big], rtol=0, atol=ATOL)
    np.testing.assert_allclose(frame, want[2], rtol=0, atol=FRAME_ATOL)
    n = want[2][:, 0, 0]  # (P, 3) contact normal
    differ = np.where(big[..., None], 0.0, np.abs(pos - want[1])).max((1, 2)) > ATOL
    assert not (differ & ~_support_tied(args, n)).any(), np.nonzero(differ)
    assert differ.mean() < 0.1, differ.mean()
    along = ((pos - want[1]) * n[:, None, :]).sum(-1)
    np.testing.assert_allclose(along[~big], 0.0, rtol=0, atol=ATOL)
    deepest = dist[:, 0]
    if kind == "face":
        # a face manifold of three or more points, a few mm deep
        assert (deepest < 0).all() and (deepest > -0.02).all()
        assert ((~big).sum(1) >= 3).all()
    elif kind == "edge":
        # one point where the crossed edges meet
        assert (deepest < 0).all() and big[:, 1:].all()
    elif kind == "separated":
        assert (deepest > 0).all()


def _support_tied(args, n: np.ndarray) -> np.ndarray:
    """(P,) whether hull1's highest or hull2's lowest vertices along n tie
    within 1e-6 (the support is an edge or a face)."""
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)
    xp1, xm1, s1, xp2, xm2, s2 = (np.asarray(x, np.float64) for x in args)
    tied = np.zeros(P, bool)
    for xp, xm, sz, sign in ((xp1, xm1, s1, 1.0), (xp2, xm2, s2, -1.0)):
        verts = xp[:, None, :] + np.einsum("pij,pkj->pki", xm, corners[None] * sz[:, None, :])
        sup = sign * np.einsum("pki,pi->pk", verts, n)
        tied |= (sup >= sup.max(1, keepdims=True) - 1e-6).sum(1) > 1
    return tied


def test_box_hull_matches_jax():
    from ambersim_tpu.engine import convex as jax_convex

    xp1, xm1, s1, *_ = _pairs("random", 4)
    want = jax_convex.box_hull(jnp.asarray(xp1), jnp.asarray(xm1), jnp.asarray(s1))
    got = convex.box_hull(*map(torch.as_tensor, (xp1, xm1, s1)))
    for g, w, name in zip(got, want, want._fields):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)


def test_seg_seg_closest_matches_jax():
    from ambersim_tpu.engine import convex as jax_convex

    rng = np.random.default_rng(5)
    segs = rng.standard_normal((4, 32, 3)).astype(np.float32)
    segs[3, :8] = segs[2, :8]  # degenerate second segments (a point)
    segs[1, 8:16] = segs[0, 8:16] + 0.3 * (segs[3, 8:16] - segs[2, 8:16])  # parallel segments
    want = jax_convex._seg_seg_closest(*map(jnp.asarray, segs))
    got = convex._seg_seg_closest(*map(torch.as_tensor, segs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
