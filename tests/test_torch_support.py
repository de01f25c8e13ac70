"""The port's support functions (engine/support.py) against the JAX
package's (ambersim_tpu/engine/support.py) on the CPU, on tests/
test_support.py's rig (a free base, a hinge and a ball joint, two sites):
4 seeded envs forwarded by the JAX package, the same Data handed to both.
Every function, every body, site and geom; the transposed (nv, 3) layout.
Bar: within 1e-6 of the JAX package's plus 1e-6 relative (the same
products of the same Data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tools import solver_parity as sp
from tools import torch_parity as tp
from tools.weld_parity import np_batch

RIG = chip_smoke.tests_xml("test_support.py", "RIG")
TOL = 1e-6
B = 4


@pytest.fixture(scope="module")
def rig():
    """(JAX Model, port Model, JAX Data, port Data) after one forward of 4
    seeded envs (base moved 0.1 N(0, 1), elbow turned, velocities 0.3 N(0, 1))."""
    from ambersim_tpu.engine import forward

    jm = sp.quick_jax_model(RIG)
    rng = np.random.default_rng(3)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (B, 1))
    qpos[:, :3] += 0.1 * rng.standard_normal((B, 3)).astype(np.float32)
    qpos[:, 7] = rng.uniform(-1.0, 1.0, B)
    q = qpos[:, 8:12] + 0.2 * rng.standard_normal((B, 4)).astype(np.float32)
    qpos[:, 8:12] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel = 0.3 * rng.standard_normal((B, jm.skel.nv)).astype(np.float32)
    jd = jax.tree.map(jnp.asarray, np_batch(jm, qpos=qpos, qvel=qvel))
    jd = sp.compiled(jax.vmap(lambda d: forward(jm, d)), jd)(jd)
    tm = tp.torch_model(jm)
    return jm, tm, jd, tp.torch_batch(tm, jd)


def _close(name, got, want):
    if isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            tp.assert_close(f"{name}[{i}]", g, w, TOL, TOL)
    else:
        tp.assert_close(name, got, want, TOL, TOL)


def test_jacobians(rig):
    from ambersim_tpu.engine import support as jsup
    from ambersim_tpu_torch.engine import support

    jm, tm, jd, d = rig
    s = jm.skel
    point = np.asarray([0.1, -0.05, 1.1], np.float32) + 0.05 * np.random.default_rng(4).standard_normal(
        (B, 3)).astype(np.float32)
    for b in range(1, s.nbody):
        want = jax.vmap(lambda dd, p: jsup.jac(jm, dd, p, b))(jd, jnp.asarray(point))
        got = support.jac(tm, d, torch.tensor(point), b)
        assert got[0].shape == (B, s.nv, 3)
        _close(f"jac body {b}", got, want)
        _close(f"jac_body {b}", support.jac_body(tm, d, b), jax.vmap(lambda dd: jsup.jac_body(jm, dd, b))(jd))
        _close(f"jac_body_com {b}", support.jac_body_com(tm, d, b),
               jax.vmap(lambda dd: jsup.jac_body_com(jm, dd, b))(jd))
    for i in range(s.nsite):
        _close(f"jac_site {i}", support.jac_site(tm, d, i), jax.vmap(lambda dd: jsup.jac_site(jm, dd, i))(jd))
    for g in range(s.ngeom):
        _close(f"jac_geom {g}", support.jac_geom(tm, d, g), jax.vmap(lambda dd: jsup.jac_geom(jm, dd, g))(jd))


def test_mass_matrix_and_apply_ft(rig):
    from ambersim_tpu.engine import support as jsup
    from ambersim_tpu_torch.engine import support

    jm, tm, jd, d = rig
    rng = np.random.default_rng(5)
    vec = rng.standard_normal((B, jm.skel.nv)).astype(np.float32)
    _close("full_m", support.full_m(tm, d), jax.vmap(lambda dd: jsup.full_m(jm, dd))(jd))
    _close("mul_m", support.mul_m(tm, d, torch.tensor(vec)),
           jax.vmap(lambda dd, v: jsup.mul_m(jm, dd, v))(jd, jnp.asarray(vec)))
    force, torque = (rng.standard_normal((B, 3)).astype(np.float32) for _ in range(2))
    point = np.asarray([0.2, 0.0, 1.05], np.float32) + 0.05 * rng.standard_normal((B, 3)).astype(np.float32)
    for b in range(1, jm.skel.nbody):
        want = jax.vmap(lambda dd, f, t, p: jsup.apply_ft(jm, dd, f, t, p, b))(
            jd, jnp.asarray(force), jnp.asarray(torque), jnp.asarray(point))
        got = support.apply_ft(tm, d, torch.tensor(force), torch.tensor(torque), torch.tensor(point), b)
        _close(f"apply_ft body {b}", got, want)
