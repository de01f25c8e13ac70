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


def jax_model(path: str = QUADRUPED_XML, cone: str | None = None, broadphase_cap: int = 0,
              max_contact_points: int = 0):
    from tools.export_model_npz import load_jax_model

    return load_jax_model(path, cone, broadphase_cap, max_contact_points)


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


def jax_env_state(env, qpos: np.ndarray, qvel: np.ndarray, qacc_warmstart: np.ndarray,
                  actions: tuple = ("last_action",)):
    """A batched State of a JAX env (the quadruped's, or the humanoid's with
    actions=("last_action", "prev_action")) at the given numpy carry, built
    without a forward pass: a step reads only qpos, qvel, act,
    qacc_warmstart and time of its Data and recomputes the rest. The info
    entries named in `actions` start at zero."""
    import jax
    import jax.numpy as jnp

    from ambersim_tpu.rl.base import State

    B = qpos.shape[0]
    data = jax_batch(env.model, qpos=qpos, qvel=qvel, qacc_warmstart=qacc_warmstart)
    info = {"rng": jax.random.split(jax.random.PRNGKey(0), B), **{k: jnp.zeros((B, env.model.nu)) for k in actions}}
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


# ---- the clutter scene, cut to a small size ----

CLUTTER_XML = "models/objects/clutter32.xml"


def _euler_xyz(a: float, b: float, c: float) -> np.ndarray:
    """Rotation matrix of MuJoCo's default intrinsic xyz Euler angles."""
    ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return rx @ ry @ rz


def clutter_small_xml(nbodies: int = 12, squeeze: float = 0.5, depth: float = 0.003) -> str:
    """The first `nbodies` bodies of clutter32.xml (columns of a sphere and a
    box) with their geoms and orientations, lowered into contact: the columns
    pulled toward their centroid by `squeeze` in x and y; in even columns the
    sphere stands `depth` deep in the floor and the box `depth` deep on it,
    in odd columns the box on the floor and the sphere on the box."""
    import re

    from tools.export_model_npz import REPO

    text = (REPO / "ambersim_tpu" / CLUTTER_XML).read_text()
    bodies = re.findall(r'(<body name="b\d+" pos="([^"]+)" euler="([^"]+)">.*?</body>)', text, re.S)[:nbodies]
    xy = np.array([[float(v) for v in pos.split()[:2]] for _, pos, _ in bodies])
    xy = xy.mean(0) + squeeze * (xy - xy.mean(0))

    def extents(body, euler):
        """(lowest point below the center, surface right above or below it)"""
        size = np.array([float(v) for v in re.search(r'size="([^"]+)"', body).group(1).split()])
        if 'type="sphere"' in body:
            return size[0], size[0]
        tilt = np.abs(_euler_xyz(*map(float, euler.split()))[2])  # |z components| of the box axes
        return tilt @ size, np.min(size / np.maximum(tilt, 1e-9))

    z, out = np.zeros(len(bodies)), []
    for col in range(0, len(bodies) - 1, 2):
        below, above = (col, col + 1) if col % 4 == 0 else (col + 1, col)
        corner, face_below = extents(*bodies[below][::2])
        z[below] = corner - depth
        z[above] = z[below] + face_below + extents(*bodies[above][::2])[1] - depth
    for (body, pos, _), (x, y), zk in zip(bodies, xy, z):
        out.append(body.replace(f'pos="{pos}"', f'pos="{x:.4f} {y:.4f} {zk:.4f}"'))
    head = text[: text.index("<body ")]
    return head + "\n    ".join(out) + "\n  </worldbody>\n</mujoco>\n"


def export_small_clutter(tmp_path, broadphase_cap: int, max_contact_points: int = 0, nbodies: int = 12):
    """(JAX model, the port's model) of clutter_small_xml(nbodies), the
    port's loaded from what tools/export_model_npz.py's command line writes."""
    from tools.export_model_npz import load_jax_model, main

    xml, npz = tmp_path / "clutter_small.xml", tmp_path / "clutter_small.npz"
    xml.write_text(clutter_small_xml(nbodies))
    cli = [str(xml), str(npz), "--broadphase-cap", str(broadphase_cap)]
    if max_contact_points:
        cli += ["--max-contact-points", str(max_contact_points)]
    main(cli)
    return load_jax_model(str(xml), None, broadphase_cap, max_contact_points), torch_model_file(npz)


def torch_model_file(path):
    """The port's Model from an exported .npz file, on the CPU."""
    from ambersim_tpu_torch.io.bridge import model_from_numpy, unpack_npz

    with np.load(path, allow_pickle=False) as npz:
        return model_from_numpy(*unpack_npz(npz), device="cpu")


def free_body_state(jm, batch: int, seed: int, pos_scale=1e-3, rot_scale=2e-2, qvel_scale=0.05):
    """(qpos, qvel) numpy batches around qpos0 of a model of free bodies:
    positions moved by pos_scale N(0, 1), orientations turned by about
    rot_scale, velocities qvel_scale N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(jm.qpos0, np.float32), (batch, 1)).reshape(batch, -1, 7)
    q[..., :3] += pos_scale * rng.standard_normal(q[..., :3].shape)
    q[..., 3:] += 0.5 * rot_scale * rng.standard_normal(q[..., 3:].shape)
    q[..., 3:] /= np.linalg.norm(q[..., 3:], axis=-1, keepdims=True)
    qvel = qvel_scale * rng.standard_normal((batch, jm.skel.nv))
    return q.reshape(batch, -1).astype(np.float32), qvel.astype(np.float32)


def drop_rollouts(name: str, batch: int, steps: int, seed: int):
    """(port model, JAX final Data, port final Data) of `batch` envs of the
    asset `name` (a scene of free bodies) stepped `steps` times by the JAX
    package's step (jit of vmap, one call a step: it compiles in about half
    the time of the scanned rollout) and by the port's rollout, from qpos0
    with positions moved by 1 cm, orientations turned by ~0.2 rad and
    velocities of 0.1 N(0, 1) (free_body_state, seeded)."""
    import jax

    from ambersim_tpu.engine import step as jax_step
    from ambersim_tpu_torch.engine import rollout

    jm = jax_asset_model(name)
    tm = torch_model(jm)
    qpos, qvel = free_body_state(jm, batch, seed, pos_scale=1e-2, rot_scale=0.2, qvel_scale=0.1)
    jd = jax_batch(jm, qpos=qpos, qvel=qvel)
    got = rollout(tm, torch_batch(tm, jd), steps)
    step = jax.jit(jax.vmap(lambda d: jax_step(jm, d)))
    for _ in range(steps):
        jd = step(jd)
    return tm, jd, got
