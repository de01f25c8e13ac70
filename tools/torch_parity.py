"""Helpers for the tests that hold the PyTorch port against the JAX package.

This module imports both frameworks (the port itself never imports JAX).
Inputs are drawn with numpy from a seed and handed to both sides; JAX runs
on the CPU through its plain jnp path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tools.export_model_npz import model_arrays

QUADRUPED_XML = "models/quadruped/quadruped.xml"

# tests/test_newton_pallas.py:15-29: dense equality, dof-friction, limit and
# contact rows in one scene
CONTACT_SCENE = """
<mujoco><option timestep="0.002"/><compiler angle="radian"/><worldbody>
  <geom name="floor" type="plane" size="0 0 1"/>
  <body pos="0 0 0.08" euler="0.1 0.05 0"><freejoint/>
    <geom type="box" size="0.1 0.08 0.05"/></body>
  <body pos="0.3 0 0.5">
    <joint name="h" axis="0 1 0" range="-0.5 0.5" frictionloss="0.3" damping="0.1"/>
    <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.03"/>
    <body pos="0 0 -0.4"><joint name="h2" axis="0 1 0"/>
      <geom type="sphere" size="0.05"/></body>
  </body>
</worldbody>
<equality><joint joint1="h" joint2="h2" polycoef="0 0.5 0 0 0"/></equality>
</mujoco>
"""

# the main path's PD standing controller (bench.py:62-127)
KP, KD = 60.0, 2.0


def jax_model(path: str = QUADRUPED_XML):
    from ambersim_tpu.utils.io_utils import load_model_from_file

    return load_model_from_file(path)


def jax_model_from_xml(xml: str):
    from ambersim_tpu.engine.setconst import set_constants
    from ambersim_tpu.mjcf import compile_spec
    from ambersim_tpu.mjcf.parser import parse_mjcf_string

    return set_constants(compile_spec(parse_mjcf_string(xml)))


def torch_model(jm, device="cpu"):
    """The port's Model for a JAX-package Model, through the bridge."""
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    return model_from_numpy(*model_arrays(jm), device=device)


def random_state(jm, batch: int, seed: int, qpos_scale=0.03, qvel_scale=0.5):
    """(qpos, qvel) numpy batches around qpos0."""
    rng = np.random.default_rng(seed)
    s = jm.skel
    qpos = np.asarray(jm.qpos0, np.float32) + qpos_scale * rng.standard_normal((batch, s.nq)).astype(np.float32)
    qvel = qvel_scale * rng.standard_normal((batch, s.nv)).astype(np.float32)
    return qpos, qvel


def bench_qpos(jm, batch: int, seed: int = 0) -> np.ndarray:
    """The main path's start: qpos0 with qpos[7:] += 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (batch, 1))
    qpos[:, 7:] += 0.05 * rng.standard_normal((batch, jm.skel.nq - 7)).astype(np.float32)
    return qpos


def jax_batch(jm, **fields):
    """Batched JAX Data from make_data with the given (B, ...) numpy fields."""
    import jax
    import jax.numpy as jnp

    from ambersim_tpu.engine import make_data

    d0 = make_data(jm)
    B = next(iter(fields.values())).shape[0]
    batch = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
    return batch.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def data_to_numpy(d) -> dict:
    """Field name -> numpy for a batched JAX Data (contact as contact.<f>)."""
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if f.name == "contact":
            for g in dataclasses.fields(v):
                out["contact." + g.name] = np.asarray(getattr(v, g.name))
        elif v is not None:
            out[f.name] = np.asarray(v)
    return out


def torch_batch(tm, jd):
    """The port's Data holding the same values as a batched JAX Data."""
    from ambersim_tpu_torch.io.bridge import data_from_numpy

    return data_from_numpy(tm, data_to_numpy(jd))


def pd_ctrl_jax(d):
    import jax.numpy as jnp

    return KP * (jnp.zeros(d.qpos.shape[-1] - 7) - d.qpos[7:]) - KD * d.qvel[6:]


def pd_ctrl_torch(d):
    return KP * (0.0 - d.qpos[:, 7:]) - KD * d.qvel[:, 6:]


def assert_close(name: str, got, want, rtol: float, atol: float) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
