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


def jax_model(path: str = QUADRUPED_XML, cone: str | None = None):
    from tools.export_model_npz import load_jax_model

    return load_jax_model(path, cone)


def jax_asset_model(name: str):
    """The JAX package's Model behind the port's asset `name`."""
    from tools.export_model_npz import ASSETS

    return jax_model(*ASSETS[name])


def with_solver(jm, **opt):
    """A JAX-package Model with solver options overridden (e.g. iterations)."""
    return jm.replace(opt=jm.opt.replace(**opt))


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


def arm3_contact_qpos(jm, batch: int, seed: int) -> np.ndarray:
    """arm3 starts whose rows are active: the shoulder turned 1.22 rad down so
    the fingertip presses into the table, the wrist past its 2.8 rad limit
    in the first half of the batch, plus 0.1 N(0, 1)."""
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (batch, 1))
    qpos += 0.1 * np.random.default_rng(seed).standard_normal(qpos.shape).astype(np.float32)
    qpos[:, 0] += 1.22
    qpos[: batch // 2, 2] = 2.9
    return qpos


def cartpole_limit_state(jm, batch: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """cartpole starts near the slider's +-1 limit, moving toward it at
    1-3 m/s, so its limit row turns on within a few steps."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (batch, 1))
    side = rng.choice([-1.0, 1.0], batch)
    qpos[:, 0] = side * rng.uniform(0.8, 0.95, batch)
    qvel = np.zeros((batch, jm.skel.nv), np.float32)
    qvel[:, 0] = side * rng.uniform(1.0, 3.0, batch)
    return qpos, qvel


def assert_close(name: str, got, want, rtol: float, atol: float) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


# ---- env layer: the JAX package's envs on numpy inputs ----


def _env_fields(state) -> dict:
    out = {k: getattr(state, k) for k in ("obs", "reward", "done")}
    out.update(qpos=state.pipeline_state.qpos, qvel=state.pipeline_state.qvel)
    out.update({k: state.info[k] for k in ("steps", "truncation") if k in state.info})
    return out


def uniform_actions(seed: int, T: int, B: int, nu: int) -> np.ndarray:
    """(T, B, nu) float32 actions uniform in [-1, 1]."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (T, B, nu)).astype(np.float32)


def jax_env_reset(env, batch: int, seed: int):
    """The JAX env's State of `batch` envs reset from PRNGKey(seed) split
    `batch` ways (a wrapped env batches itself; a bare env is vmapped)."""
    import jax

    from ambersim_tpu.rl.wrappers import Wrapper

    reset = env.reset if isinstance(env, Wrapper) else jax.vmap(env.reset)
    return jax.jit(reset)(jax.random.split(jax.random.PRNGKey(seed), batch))


def jax_quadruped_state(env, qpos: np.ndarray, qvel: np.ndarray, qacc_warmstart: np.ndarray):
    """A batched State of the JAX quadruped env at the given numpy carry,
    built without a forward pass: a step reads only qpos, qvel, act,
    qacc_warmstart and time of its Data and recomputes the rest."""
    import jax
    import jax.numpy as jnp

    from ambersim_tpu.rl.base import State

    B = qpos.shape[0]
    data = jax_batch(env.model, qpos=qpos, qvel=qvel, qacc_warmstart=qacc_warmstart)
    info = {"rng": jax.random.split(jax.random.PRNGKey(0), B), "last_action": jnp.zeros((B, env.model.nu))}
    obs = jax.vmap(env.compute_obs)(data, info)
    zeros = jnp.zeros(B)
    return State(data, obs, zeros, zeros, {"reward": zeros}, info)


def jax_env_run(env, state, actions: np.ndarray) -> list:
    """Step the JAX env's batched `state` through `actions` (T, B, nu) in one
    jit; returns the state after each step as env_state_to_numpy does."""
    import jax
    import jax.numpy as jnp

    from ambersim_tpu.rl.wrappers import Wrapper

    step = env.step if isinstance(env, Wrapper) else jax.vmap(env.step)

    def body(s, a):
        s = step(s, a)
        return s, _env_fields(s)

    steps = jax.jit(lambda s, acts: jax.lax.scan(body, s, acts)[1])(state, jnp.asarray(actions))
    return [{k: np.asarray(v[t]) for k, v in steps.items()} for t in range(len(actions))]


def env_state_to_numpy(state) -> dict:
    """obs, reward, done, qpos, qvel and the wrappers' steps/truncation of an
    env State of either package, as numpy."""

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)

    return {k: host(v) for k, v in _env_fields(state).items()}


# ---- PPO: a rollout buffer drawn from the JAX policy ----


def ppo_rollout_buffer(seed: int, jax_networks, jparams, jnorm, T: int, N: int, obs_size: int) -> dict:
    """A numpy Transition batch (T, N, ...) whose actions and log-probs come
    from the JAX policy (log-probs moved by 0.1 N(0, 1), so the importance
    ratios spread around 1), with terminations and truncations."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    obs = (2 * rng.standard_normal((T + 1, N, obs_size))).astype(np.float32)
    logits = jax_networks.policy_network.apply(jnorm, jparams["policy"], jnp.asarray(obs[:-1]))
    dist = jax_networks.parametric_action_distribution
    raw = np.asarray(dist.sample_no_postprocessing(logits, jax.random.PRNGKey(seed)))
    log_prob = np.asarray(dist.log_prob(logits, jnp.asarray(raw)))
    log_prob = log_prob + 0.1 * rng.standard_normal(log_prob.shape).astype(np.float32)
    truncation = (rng.uniform(size=(T, N)) < 0.1).astype(np.float32)
    done = np.maximum((rng.uniform(size=(T, N)) < 0.1).astype(np.float32), truncation)
    return dict(observation=obs[:-1], action=np.tanh(raw), raw_action=raw, log_prob=log_prob,
                reward=rng.standard_normal((T, N)).astype(np.float32), discount=1 - done, truncation=truncation,
                next_observation=obs[1:])
