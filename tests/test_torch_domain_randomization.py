"""Per-env Model leaves (domain randomization) in the port against the JAX
package's vmap over a randomized Model (CPU).

The randomized leaves are drawn once with numpy from a seed and given to
both packages: to the JAX package's `randomization_fn` with in_axes 0 on
those leaves, and to the port's as a leading env axis. Cases: the
pendulum under each package's DomainRandomizationVmapWrapper with
tests/test_ppo_train.py:90-115's masses (x [1, 1.8)), 4 envs x 5 control
steps from the JAX wrapper's own reset; the quadruped locomotion env with
the first five per-env leaves (core.types.ENV_LEAVES; the other eleven are
held in tests/test_torch_env_leaves.py), 4 envs x 3 control
steps; the solver tolerance tolerance nv max(sum of masses, 1), which the
JAX package's Newton kernels take as its minimum over envs and its CG
keeps per env; each env of a batched-leaf rollout against the unbatched
model carrying that env's values, at tolerance 0 so no convergence test
enters; the refusals of a leaf outside ENV_LEAVES and of a wrong shape;
and PPO `train` with a `randomization_fn` at tests/test_ppo_train.py:
119-135's tiny size.

Bars: the repo's rollout bars, qpos atol 1e-4 and qvel atol 1e-3 (obs
columns by what they derive from, as tests/test_torch_env_quadruped.py);
a batched-leaf env against its own model's rollout within qpos 1e-6 and
qvel 1e-5 (the same arithmetic on other batch shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import solver_parity as sp
from tools import torch_parity as tp

QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
SAME_QPOS, SAME_QVEL = 1e-6, 1e-5
B = 4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def quadruped_leaves(leaves: dict, batch: int, seed: int) -> dict:
    """All five per-env leaves of the quadruped from numpy(seed): body masses
    x U[0.8, 1.2], the dofs' damping U[0.5, 1.1], the geoms' sliding
    friction U[0.5, 1.25], the motors' gain x U[0.9, 1.1] and bias
    parameters U[-0.1, 0.1] (a motor reads no bias: carried, not used)."""
    rng = np.random.default_rng(seed)

    def tile(k):
        return np.tile(np.asarray(leaves[k], np.float32), (batch,) + (1,) * np.ndim(leaves[k]))

    out = {k: tile(k) for k in ("body_mass", "dof_damping", "geom_friction", "actuator_gainprm", "actuator_biasprm")}
    out["body_mass"] *= rng.uniform(0.8, 1.2, out["body_mass"].shape).astype(np.float32)
    out["dof_damping"] = rng.uniform(0.5, 1.1, out["dof_damping"].shape).astype(np.float32)
    out["geom_friction"][..., 0] = rng.uniform(0.5, 1.25, out["geom_friction"].shape[:-1]).astype(np.float32)
    out["actuator_gainprm"][..., 0] *= rng.uniform(0.9, 1.1, out["actuator_gainprm"].shape[:-1]).astype(np.float32)
    out["actuator_biasprm"] = rng.uniform(-0.1, 0.1, out["actuator_biasprm"].shape).astype(np.float32)
    return out


def jax_randomization(leaves: dict):
    """The JAX package's randomization_fn for numpy `leaves`."""

    def fn(model):
        axes = jax.tree.map(lambda _: None, model).replace(**dict.fromkeys(leaves, 0))
        return model.replace(**{k: jnp.asarray(v) for k, v in leaves.items()}), axes

    return fn


def torch_randomization(leaves: dict):
    """The port's randomization_fn for numpy `leaves`."""

    def fn(model):
        return model.replace(**{k: torch.as_tensor(v, device=model.device) for k, v in leaves.items()}), tuple(leaves)

    return fn


def test_pendulum_wrapper_matches_jax():
    """Each package's wrapper over the pendulum with per-env masses: the
    same starts and actions, distinct trajectories per env, obs and qvel
    at the rollout bars."""
    from ambersim_tpu.rl.pendulum import PendulumSwingupEnv as JaxPendulum
    from ambersim_tpu.rl.wrappers import wrap_for_training as jax_wrap
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.wrappers import DomainRandomizationVmapWrapper, wrap_for_training

    jenv = JaxPendulum()
    base = np.asarray(jenv.model.body_mass, np.float32)
    scale = 1.0 + 0.8 * np.random.default_rng(3).uniform(size=B).astype(np.float32)
    leaves = {"body_mass": base * scale[:, None]}
    jwrapped = jax_wrap(jenv, episode_length=10, randomization_fn=jax_randomization(leaves))
    env = wrap_for_training(PendulumSwingupEnv(device="cpu"), episode_length=10,
                            randomization_fn=torch_randomization(leaves))
    assert isinstance(env.env, DomainRandomizationVmapWrapper) and env.env.num_envs == B
    jstate = jax.jit(jwrapped.reset)(jnp.stack([jax.random.PRNGKey(7)] * B))
    js = tp.env_state_to_numpy(jstate)
    s = env.reset_to(torch.as_tensor(js["qpos"]), torch.as_tensor(js["qvel"]))
    tp.assert_close("reset obs", s.obs, js["obs"], 0.0, 1e-6)
    acts = np.ones((5, B, 1), np.float32)
    want = tp.jax_env_run(jwrapped, jstate, acts)
    for t, a in enumerate(acts):
        s = env.step(s, torch.as_tensor(a))
        g = tp.env_state_to_numpy(s)
        tp.assert_close(f"obs step {t}", g["obs"], want[t]["obs"], 0.0, QVEL_ATOL)
        tp.assert_close(f"qvel step {t}", g["qvel"], want[t]["qvel"], 0.0, QVEL_ATOL)
    assert len(np.unique(g["qvel"][:, 0])) == B


def test_quadruped_env_matches_jax():
    """The quadruped locomotion env under each package's wrapper with all
    five per-env leaves, 4 envs x 3 control steps (12 physics steps), both
    from the port's reset state."""
    from ambersim_tpu.rl.quadruped import QuadrupedLocomotionEnv as JaxQuadruped
    from ambersim_tpu.rl.wrappers import wrap_for_training as jax_wrap
    from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv
    from ambersim_tpu_torch.rl.wrappers import wrap_for_training
    from tools.export_model_npz import model_arrays

    jenv = JaxQuadruped()
    leaves = quadruped_leaves(model_arrays(jenv.model)[1], B, seed=12)
    jwrapped = jax_wrap(jenv, episode_length=50, randomization_fn=jax_randomization(leaves))
    env = wrap_for_training(QuadrupedLocomotionEnv(device="cpu"), episode_length=50,
                            randomization_fn=torch_randomization(leaves))
    # the port's reset (the JAX env's draws: qpos0 + 0.08 N(0, 1) on the
    # joints, 0.05 N(0, 1) on the base velocity), then the JAX wrappers'
    # State at the same carry, built without a forward pass
    rng = np.random.default_rng(5)
    qpos = np.tile(np.asarray(jenv.model.qpos0, np.float32), (B, 1))
    qpos[:, 7:] += 0.08 * rng.standard_normal((B, 12)).astype(np.float32)
    qvel = np.zeros((B, 18), np.float32)
    qvel[:, :6] = 0.05 * rng.standard_normal((B, 6)).astype(np.float32)
    s = env.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel))
    jstate = tp.jax_env_state(jenv, qpos, qvel, s.pipeline_state.qacc_warmstart.numpy())
    zeros = jnp.zeros(B)
    jstate = jstate.replace(info={**jstate.info, "steps": zeros, "truncation": zeros,
                                  "first_pipeline_state": jstate.pipeline_state, "first_obs": jstate.obs})
    acts = tp.uniform_actions(6, 3, B, 12)

    def run(state, actions):
        return jax.lax.scan(lambda c, a: (jwrapped.step(c, a),) * 2, state, actions)[1]

    steps = sp.compiled(run, jstate, acts)(jstate, acts)
    want = [tp.env_state_to_numpy(jax.tree.map(lambda x: x[t], steps)) for t in range(len(acts))]
    bars = [(slice(0, 3), QPOS_ATOL), (slice(3, 9), QVEL_ATOL), (slice(9, 21), QPOS_ATOL),
            (slice(21, 33), 0.1 * QVEL_ATOL), (slice(33, 45), 0.0)]
    for t, a in enumerate(acts):
        s = env.step(s, torch.as_tensor(a))
        g = tp.env_state_to_numpy(s)
        for cols, atol in bars:
            tp.assert_close(f"obs[{cols}] step {t}", g["obs"][:, cols], want[t]["obs"][:, cols], 0.0, atol)
        tp.assert_close(f"qpos step {t}", g["qpos"], want[t]["qpos"], 0.0, QPOS_ATOL)
        tp.assert_close(f"qvel step {t}", g["qvel"], want[t]["qvel"], 0.0, QVEL_ATOL)
        tp.assert_close(f"reward step {t}", g["reward"], want[t]["reward"], 0.0, QVEL_ATOL)


def _masses_case(solver: int, tolerance: float, seed: int):
    """(JAX model, numpy per-env masses, JAX Data): the quadruped with its
    body masses x U[0.5, 2.0) per env and x U[0.9, 1.1) per body, at
    `solver` with `tolerance` and 15 x 15 iterations (at fewer the JAX
    package's CG is chaotic in its line search: tests/test_torch_cg.py)."""
    jm = sp.quick_jax_model(sp.quadruped_xml(), solver=solver, tolerance=tolerance, iterations=15, ls_iterations=15)
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 2.0, (B, 1)) * rng.uniform(0.9, 1.1, (B, jm.skel.nbody))
    mass = np.asarray(jm.body_mass, np.float32) * scale.astype(np.float32)
    return jm, {"body_mass": mass}, sp.quadruped_start(jm, seed=seed, batch=B)


def _jax_steps(jm, leaves: dict, jd, steps: int):
    from ambersim_tpu.engine import step as jax_step

    model_v, axes = jax_randomization(leaves)(jm)
    jstep = jax.jit(jax.vmap(lambda m, d: jax_step(m, d.replace(ctrl=tp.pd_ctrl_jax(d))), in_axes=(axes, 0)))
    for _ in range(steps):
        jd = jstep(model_v, jd)
    return jd


def _torch_steps(tm, jd, steps: int):
    from ambersim_tpu_torch.engine import step

    d = tp.torch_batch(tm, jd) if not isinstance(jd, torch.Tensor) else jd
    for _ in range(steps):
        d = step(tm, d.replace(ctrl=tp.pd_ctrl_torch(d)))
    return d


@pytest.mark.parametrize("solver", ["newton", "cg"])
def test_solver_tolerance_matches_jax(solver, monkeypatch):
    """tolerance 1e-3 nv max(sum of masses, 1) with per-env masses, 3 steps
    against the JAX package's vmapped step; the solve takes the minimum of
    the envs' tolerances under Newton (the JAX package's vmap rule for its
    kernels: one scalar) and each env's own under CG (the JAX package
    vmaps it), read off the solver's call."""
    from ambersim_tpu_torch.engine import solver as port_solver

    name = "_newton_arrays" if solver == "newton" else "_solve_cg"
    inner, seen = getattr(port_solver, name), []

    def spy(*args, **kw):
        seen.append(args[8] if solver == "newton" else args[2])
        return inner(*args, **kw)

    monkeypatch.setattr(port_solver, name, spy)
    jm, leaves, jd = _masses_case(2 if solver == "newton" else sp.CG, 1e-3, seed=21)
    want = _jax_steps(jm, leaves, jd, 3)
    got = _torch_steps(torch_randomization(leaves)(tp.torch_model(jm))[0], jd, 3)
    tp.assert_close("qpos", got.qpos, want.qpos, 0.0, QPOS_ATOL)
    tp.assert_close("qvel", got.qvel, want.qvel, 0.0, QVEL_ATOL)
    per_env = 1e-3 * jm.skel.nv * np.maximum(leaves["body_mass"].sum(-1), 1.0)
    assert len(seen) == 3 and per_env.max() > 1.5 * per_env.min()
    for tol in seen:
        want_tol = per_env.min() if solver == "newton" else per_env
        np.testing.assert_allclose(tol.numpy(), want_tol, rtol=1e-6)
        assert tol.shape == (() if solver == "newton" else (B,))


def test_env_matches_its_own_model():
    """Each env of a batched-leaf rollout (all five leaves, 4 envs x 5 steps,
    tolerance 0) against the unbatched model that carries that env's
    values, within SAME_QPOS / SAME_QVEL."""
    from ambersim_tpu_torch.core.types import env_leaf_names, env_slice
    from tools.export_model_npz import model_arrays

    jm = sp.quick_jax_model(sp.quadruped_xml(), tolerance=0.0)
    leaves = quadruped_leaves(model_arrays(jm)[1], B, seed=5)
    tm = torch_randomization(leaves)(tp.torch_model(jm))[0]
    assert env_leaf_names(tm) == tuple(leaves)
    jd = sp.quadruped_start(jm, seed=5, batch=B)
    got = _torch_steps(tm, jd, 5)
    for e in range(B):
        one = env_slice(tm, e)
        assert env_leaf_names(one) == ()
        d = _torch_steps(one, tp.torch_batch(one, jax.tree.map(lambda x: x[e:e + 1], jd)), 5)
        tp.assert_close(f"qpos env {e}", got.qpos[e:e + 1], d.qpos.numpy(), 0.0, SAME_QPOS)
        tp.assert_close(f"qvel env {e}", got.qvel[e:e + 1], d.qvel.numpy(), 0.0, SAME_QVEL)


@pytest.mark.parametrize("case, error, leaf", [
    ("unlisted", NotImplementedError, "geom_size"),
    ("unnamed", NotImplementedError, "geom_size"),
    ("wrong_width", ValueError, "body_mass"),
    ("engine_unlisted", NotImplementedError, "geom_size"),
    ("engine_batch", ValueError, "dof_damping"),
    ("engine_option", NotImplementedError, "gravity"),
    ("engine_pair", NotImplementedError, "pair_friction"),
])
def test_refusals_name_the_leaf(case, error, leaf):
    """A per-env leaf outside ENV_LEAVES, named or not, a named leaf of the
    wrong shape, and in the engine itself a batched leaf outside
    ENV_LEAVES (geom_size, a pair_* leaf, an Option float; ROADMAP item 5o)
    or an env axis of another size than the Data's batch: each raises and
    names the leaf."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, step
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.wrappers import DomainRandomizationVmapWrapper

    m = load_model("quadruped", device="cpu")
    size = m.geom_size.expand(B, -1, -1).clone()
    if case.startswith("engine"):
        bad = {"engine_unlisted": lambda: m.replace(geom_size=size),
               "engine_batch": lambda: m.replace(dof_damping=m.dof_damping.expand(B + 1, -1).clone()),
               "engine_option": lambda: m.replace(opt=m.opt.replace(gravity=m.opt.gravity.expand(B, -1).clone())),
               "engine_pair": lambda: m.replace(pair_friction=m.pair_friction.expand(B, -1, -1).clone())}[case]()
        with pytest.raises(error, match=leaf):
            step(bad, make_data(m, B))
        return
    fn = {"unlisted": lambda model: (model.replace(geom_size=size), ("geom_size",)),
          "unnamed": lambda model: (model.replace(geom_size=size, body_mass=model.body_mass.expand(B, -1)),
                                    ("body_mass",)),
          "wrong_width": lambda model: (model.replace(body_mass=torch.ones(B, model.skel.nbody + 1)), ("body_mass",))}
    env = PendulumSwingupEnv(device="cpu")
    env.model = m
    with pytest.raises(error, match=leaf):
        DomainRandomizationVmapWrapper(env, fn[case])


def test_ppo_train_with_randomization_fn():
    """PPO `train` at tests/test_ppo_train.py:119-135's tiny size with the
    pendulum's masses x U[1, 1.5): a finite eval reward; the training
    batch (8 envs) and the eval batch (4 envs) drawn from one seeded
    generator, distinct draws."""
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.base import draw_uniform
    from ambersim_tpu_torch.rl.ppo import train

    drawn = []

    def randomization_fn(model, generator, num_envs):
        scale = draw_uniform(generator, (num_envs, 1), 1.0, 1.5, model.device)
        drawn.append(scale[:, 0])
        return model.replace(body_mass=model.body_mass * scale), ("body_mass",)

    _, _, metrics = train(
        PendulumSwingupEnv(device="cpu"), num_timesteps=512, num_evals=1, episode_length=16, unroll_length=4,
        num_minibatches=2, num_updates_per_batch=1, num_envs=8, num_eval_envs=4, batch_size=8, seed=1,
        normalize_observations=True, randomization_fn=randomization_fn, device="cpu")
    assert np.isfinite(metrics["eval/episode_reward"])
    assert [len(x) for x in drawn] == [8, 4] and not torch.equal(drawn[0][:4], drawn[1])


def test_leaf_ranks_cover_every_asset():
    """core.types.LEAF_RANK, which the engine's check reads, names every
    Model leaf with the rank it has in each committed asset, and an
    unbatched model passes the check at any batch."""
    import dataclasses
    from pathlib import Path

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core.types import LEAF_RANK, Model, check_env_leaves, env_leaf_names

    assert set(LEAF_RANK) == {f.name for f in dataclasses.fields(Model)} - {"skel", "opt"}
    assets = sorted(p.stem for p in (Path(__file__).resolve().parent.parent / "ambersim_tpu_torch" / "assets").glob(
        "*.npz") if "settled" not in p.stem)
    assert len(assets) >= 12
    for name in assets:
        m = load_model(name, device="cpu")
        for k, rank in LEAF_RANK.items():
            assert getattr(m, k).dim() == rank, (name, k)
        check_env_leaves(m, 3)
        assert env_leaf_names(m) == ()
