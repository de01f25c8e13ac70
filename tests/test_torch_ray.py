"""The port's ray casting (ambersim_tpu_torch/engine/ray.py) against the
JAX package's `ray` (CPU, jitted and vmapped over rays), on
tests/test_ray.py's rigs: every geom type (plane, sphere, capsule,
cylinder, ellipsoid, box), a convex mesh (the octahedron), a height field
under a free body, and the terrain quadruped's 24 x 24 field. The rigs'
rangefinder sensors are left out: `ray` needs only the geoms' poses
(kinematics), and the port does not compute sensors yet.

One ray per env, each env with its own pose. Bars: distance within 1e-4
where both hit (tests/test_ray.py holds the JAX package to mj_ray at
1e-4), the same geom id, misses (-1, -1) on both.
"""

import re

import jax
import numpy as np
import pytest
import torch

from test_ray import HFIELD_RAY_RIG, MESH_RIG, OCTA_OBJ, RAY_RIG
from tools import torch_parity as tp

TOL = 1e-4


def _no_sensors(xml: str) -> str:
    return re.sub(r"<sensor>.*?</sensor>", "", xml, flags=re.S)


def _compare(jm, qpos, pnt, vec, bodyexclude=-1, min_hits=1):
    """Both packages' ray, env b casting (pnt[b], vec[b]) at qpos[b]."""
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu.engine.ray import ray as jray
    from ambersim_tpu_torch.engine import smooth
    from ambersim_tpu_torch.engine.ray import ray

    tm = tp.torch_model(jm)
    jd = tp.jax_batch(jm, qpos=qpos.astype(np.float32))
    want_t, want_g = jax.jit(jax.vmap(lambda d, p, v: jray(jm, jsmooth.kinematics(jm, d), p, v, bodyexclude)))(
        jd, pnt.astype(np.float32), vec.astype(np.float32))
    d = smooth.kinematics(tm, tp.torch_batch(tm, jd))
    got_t, got_g = ray(tm, d, torch.as_tensor(pnt, dtype=torch.float32), torch.as_tensor(vec, dtype=torch.float32),
                       bodyexclude)
    want_t, want_g = np.asarray(want_t), np.asarray(want_g)
    assert got_t.shape == got_g.shape == want_t.shape and got_g.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    tp.assert_close("ray distance", got_t, want_t, rtol=0.0, atol=TOL)
    hits = want_g >= 0
    assert np.all(want_t[~hits] == -1.0) and hits.sum() >= min_hits
    return want_g


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_ray_all_geom_types():
    """Random rays of tests/test_ray.py:test_ray_all_geom_types' kind, each
    env at its own random pose of the rig's hinges; every geom type hit."""
    jm = tp.jax_model_from_xml(_no_sensors(RAY_RIG))
    rng = np.random.default_rng(7)
    B = 256
    qpos = rng.uniform(-1.2, 1.2, (B, jm.skel.nq))
    pnt = rng.uniform(-2, 2, (B, 3))
    pnt[:, 2] = rng.uniform(0.2, 2, B)
    # half aimed at a random geom's center, half in random directions
    targets = np.array([[0, 0, 1], [1.2, 0, 1], [0, 1.2, 1], [-1.2, 0, 1], [0, -1.2, 1], [1.2, 1.2, 1], [0, 0, 0]])
    vec = _unit(targets[rng.integers(0, len(targets), B)] + 0.1 * rng.standard_normal((B, 3)) - pnt)
    vec[B // 2:] = _unit(rng.standard_normal((B - B // 2, 3)))
    hit = _compare(jm, qpos, pnt, vec, min_hits=B // 3)
    assert set(hit[hit >= 0].tolist()) == set(range(jm.skel.ngeom)), "every geom type hit"


def test_ray_excludes_a_body():
    """Rays from the host box's center outward with its body excluded reach
    the other geoms (or miss), and without the exclusion hit the box's
    exit surface first."""
    jm = tp.jax_model_from_xml(_no_sensors(RAY_RIG))
    host_body = int(jm.skel.geom_bodyid[1])
    rng = np.random.default_rng(9)
    B = 128
    qpos = rng.uniform(-0.5, 0.5, (B, jm.skel.nq))
    qpos[:, 0] = 0.0  # the host's hinge: its center stays at (0, 0, 1)
    pnt = np.tile([0.0, 0.0, 1.0], (B, 1))
    vec = _unit(rng.standard_normal((B, 3)))
    inside = _compare(jm, qpos, pnt, vec)
    assert np.all(inside == 1)  # the exit surface of the box the rays start in
    excluded = _compare(jm, qpos, pnt, vec, bodyexclude=host_body, min_hits=B // 4)
    assert not np.any(excluded == 1)


def test_ray_mesh_hull(tmp_path):
    """Rays aimed at the octahedron's neighbourhood from around it."""
    (tmp_path / "octa.obj").write_text(OCTA_OBJ)
    (tmp_path / "scene.xml").write_text(MESH_RIG)
    jm = tp.jax_model(str(tmp_path / "scene.xml"))
    rng = np.random.default_rng(8)
    B = 128
    target = np.array([0.0, 0.0, 0.8]) + 0.1 * rng.standard_normal((B, 3))
    d = rng.standard_normal((B, 3))
    d[:, 2] = np.abs(d[:, 2])
    origin = target + rng.uniform(0.8, 1.6, (B, 1)) * _unit(d)
    qpos = rng.uniform(-0.3, 0.3, (B, jm.skel.nq))
    hit = _compare(jm, qpos, origin, _unit(target - origin), min_hits=B // 4)
    assert (hit == 1).sum() >= B // 4  # the mesh itself


@pytest.mark.parametrize("direction", ["down", "random"])
def test_ray_hfield(direction):
    """Rays over tests/test_ray.py's wavy 9 x 9 field (the free ball moved
    about), straight down as its rangefinder casts, or in any direction."""
    data = (0.5 + 0.5 * np.sin(np.linspace(0, 6, 81))).astype(np.float32)
    jm = tp.jax_model_from_xml(_no_sensors(HFIELD_RAY_RIG)).replace(hfield_data=data.reshape(1, 9, 9))
    rng = np.random.default_rng(11 if direction == "down" else 12)
    B = 256
    qpos = np.tile(np.asarray(jm.qpos0), (B, 1))
    qpos[:, :3] = np.stack([rng.uniform(-0.7, 0.7, B), rng.uniform(-0.7, 0.7, B), rng.uniform(0.3, 0.8, B)], -1)
    pnt = np.stack([rng.uniform(-1.1, 1.1, B), rng.uniform(-1.1, 1.1, B), rng.uniform(0.35, 0.9, B)], -1)
    vec = np.tile([0.0, 0.0, -1.0], (B, 1)) if direction == "down" else _unit(rng.standard_normal((B, 3)))
    least = B // 4 if direction == "down" else B // 8  # half the random rays point up
    hit = _compare(jm, qpos, pnt, vec, min_hits=least)
    assert (hit == 0).sum() >= least  # the field itself


def test_ray_terrain():
    """Nine downward rays per env around each terrain quadruped (the JSON
    rays chip_smoke.py casts at 4096 envs), 16 envs over the field."""
    from ambersim_tpu.rl.quadruped.terrain import QuadrupedTerrainConfig, _build_terrain_model

    jm = _build_terrain_model(QuadrupedTerrainConfig(terrain_seed=3))
    rng = np.random.default_rng(14)
    B = 16
    qpos = np.tile(np.asarray(jm.qpos0), (B, 1))
    qpos[:, :2] += rng.uniform(-5.0, 5.0, (B, 2))
    offsets = np.stack(np.meshgrid([-0.3, 0.0, 0.3], [-0.3, 0.0, 0.3]), -1).reshape(9, 2)
    for off in offsets:
        pnt = np.concatenate([qpos[:, :2] + off, np.ones((B, 1))], -1)
        _compare(jm, qpos, pnt, np.tile([0.0, 0.0, -1.0], (B, 1)), min_hits=B)
