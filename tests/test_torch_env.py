"""The PyTorch port's env layer against the JAX package's (CPU): the pendulum
task from the JAX env's own reset state, the training wrappers, the
registry (quadruped_terrain built on the CPU), and the refusals of what is
not ported or not admitted (a per-env leaf outside core.types.ENV_LEAVES). The quadruped task is in test_torch_env_quadruped.py, its
terrain variant in test_torch_terrain.py.
"""

import numpy as np
import pytest
import torch

from tools import torch_parity as tp

def _start(js: dict):
    """(qpos, qvel) tensors of a JAX env state."""
    return torch.as_tensor(js["qpos"]), torch.as_tensor(js["qvel"])


@pytest.fixture(scope="module")
def pendulum_case():
    from ambersim_tpu.rl.pendulum import PendulumSwingupEnv as JaxPendulum
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    torch.set_num_threads(1)
    jenv, env = JaxPendulum(), PendulumSwingupEnv(device="cpu")
    acts = tp.uniform_actions(4, 20, 16, 1)
    jstate = tp.jax_env_reset(jenv, 16, seed=3)
    js, want = tp.env_state_to_numpy(jstate), tp.jax_env_run(jenv, jstate, acts)
    s0 = s = env.reset_to(*_start(js))
    got = []
    for a in acts:
        s = env.step(s, torch.as_tensor(a))
        got.append(tp.env_state_to_numpy(s))
    return js, s0, want, got


def test_pendulum_reset_obs_matches_jax(pendulum_case):
    js, s, _, _ = pendulum_case
    tp.assert_close("obs", s.obs, js["obs"], rtol=0.0, atol=1e-6)
    assert s.reward.shape == s.done.shape == (16,)


@pytest.mark.parametrize("field", ["obs", "reward"])
def test_pendulum_steps_match_jax(pendulum_case, field):
    _, _, want, got = pendulum_case
    for t, (w, g) in enumerate(zip(want, got)):
        tp.assert_close(f"{field} step {t}", g[field], w[field], rtol=0.0, atol=1e-5)
        np.testing.assert_array_equal(g["done"], w["done"])


def test_wrappers_match_jax():
    """episode_length 5 over 12 steps: steps, truncation and done, and the
    auto-reset to the cached first state and obs, as the JAX wrappers do."""
    from ambersim_tpu.rl.pendulum import PendulumSwingupEnv as JaxPendulum
    from ambersim_tpu.rl.wrappers import wrap_for_training as jax_wrap
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.wrappers import wrap_for_training

    torch.set_num_threads(1)
    jenv = jax_wrap(JaxPendulum(), episode_length=5)
    env = wrap_for_training(PendulumSwingupEnv(device="cpu"), episode_length=5)
    acts = tp.uniform_actions(8, 12, 4, 1)
    jstate = tp.jax_env_reset(jenv, 4, seed=7)
    want = tp.jax_env_run(jenv, jstate, acts)
    s = env.reset_to(*_start(tp.env_state_to_numpy(jstate)))
    first = tp.env_state_to_numpy(s)
    for t, (a, w) in enumerate(zip(acts, want)):
        s = env.step(s, torch.as_tensor(a))
        g = tp.env_state_to_numpy(s)
        for k in ("steps", "truncation", "done"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} step {t}")
        tp.assert_close(f"obs step {t}", g["obs"], w["obs"], rtol=0.0, atol=1e-5)
        tp.assert_close(f"reward step {t}", g["reward"], w["reward"], rtol=0.0, atol=1e-5)
        if t % 5 == 4:  # the episode ended: every env is back at its first state and obs
            assert (g["done"] == 1).all() and (g["truncation"] == 1).all()
            for k in ("obs", "qpos", "qvel"):
                np.testing.assert_array_equal(g[k], first[k], err_msg=f"{k} after reset, step {t}")
    # the cached first state is never written by the steps after it
    np.testing.assert_array_equal(s.info["first_pipeline_state"].qpos.numpy(), first["qpos"])


def test_autoreset_selects_every_data_field():
    """Per env, the auto-reset takes every Data field (contact fields and
    bool/int ones included) from the cached state where done; None stays None."""
    import dataclasses

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core.types import _Tensors
    from ambersim_tpu_torch.engine import make_data
    from ambersim_tpu_torch.rl.wrappers import select_where

    first = make_data(load_model("quadruped", device="cpu"), 3).replace(energy=None)

    def bump(x):
        if isinstance(x, _Tensors):
            return dataclasses.replace(x, **{f.name: bump(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if x is None:
            return None
        return ~x if x.dtype == torch.bool else x + 1

    current = bump(first)
    out = select_where(torch.tensor([1.0, 0.0, 1.0]), first, current)

    def check(o, f, c, name):
        if isinstance(o, _Tensors):
            for fld in dataclasses.fields(o):
                check(getattr(o, fld.name), getattr(f, fld.name), getattr(c, fld.name), f"{name}.{fld.name}")
        elif f is None:
            assert o is None, name
        else:
            assert o.dtype == f.dtype and torch.equal(o[[0, 2]], f[[0, 2]]) and torch.equal(o[1], c[1]), name

    assert first.contact.dist.shape[1] > 0
    check(out, first, current, "Data")


def test_physics_runs_without_autograd():
    """Under torch.no_grad() (PPO's rollout and eval) an action that
    requires grad leaves no graph behind the env step; with grad on (APG)
    the step carries the graph back to the action."""
    from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv

    torch.set_num_threads(1)
    env = QuadrupedLocomotionEnv(device="cpu")
    s0 = env.reset(torch.Generator().manual_seed(0), 2)
    action = torch.zeros(2, 12, requires_grad=True)
    with torch.no_grad():
        s = env.step(s0, action)
    d = s.pipeline_state
    assert not (d.qpos.requires_grad or d.qvel.requires_grad or d.qacc.requires_grad or s.reward.requires_grad)
    s = env.step(s0, action)
    (g,) = torch.autograd.grad(s.reward.sum(), action)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_registry():
    from ambersim_tpu_torch.rl import get_environment
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupConfig, PendulumSwingupEnv
    from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv
    from ambersim_tpu_torch.rl.registry import registered_environments

    assert registered_environments() == ["humanoid_balance", "pendulum_swingup", "quadruped_locomotion",
                                         "quadruped_terrain"]
    env = get_environment("pendulum_swingup", config=PendulumSwingupConfig(physics_steps_per_control_step=2),
                          device="cpu")
    assert isinstance(env, PendulumSwingupEnv) and (env.observation_size, env.action_size) == (3, 1)
    assert float(env.dt) == pytest.approx(0.04)
    quad = get_environment("quadruped_locomotion", device="cpu")
    assert isinstance(quad, QuadrupedLocomotionEnv) and (quad.observation_size, quad.action_size) == (45, 12)
    with pytest.raises(KeyError, match="unknown environment"):
        get_environment("nope")


def _sized_pendulum(model, generator, num_envs):
    """A randomization_fn giving geom_size, outside ENV_LEAVES, an env axis."""
    return model.replace(geom_size=model.geom_size.expand(num_envs, -1, -1).clone()), ("geom_size",)


@pytest.mark.parametrize("what, match", [("randomization_fn", "geom_size"), ("mesh", "multi-GPU")])
def test_unported_parts_are_refused(what, match):
    """PPO refuses a mesh, and a randomization_fn that makes a leaf outside
    core.types.ENV_LEAVES per env, by name."""
    from ambersim_tpu_torch.rl import get_environment
    from ambersim_tpu_torch.rl.ppo import train

    value = _sized_pendulum if what == "randomization_fn" else object()
    with pytest.raises(NotImplementedError, match=match):
        train(get_environment("pendulum_swingup", device="cpu"), num_timesteps=1, num_envs=4, num_eval_envs=4,
              batch_size=4, num_minibatches=1, device="cpu", **{what: value})


def test_quadruped_terrain_builds_on_the_cpu():
    """The registry builds quadruped_terrain (the scene compiled by the
    port, its field generated from the seed) and it steps on the CPU."""
    from ambersim_tpu_torch.rl import get_environment
    from ambersim_tpu_torch.rl.quadruped import QuadrupedTerrainConfig, QuadrupedTerrainEnv

    env = get_environment("quadruped_terrain", config=QuadrupedTerrainConfig(terrain_seed=3), device="cpu")
    assert isinstance(env, QuadrupedTerrainEnv) and env.device == torch.device("cpu")
    assert (env.observation_size, env.action_size) == (45, 12)
    assert env.config.min_height == 0.10 and float(env.dt) == pytest.approx(0.016)
    s = env.step(env.reset(torch.Generator().manual_seed(0), 4), torch.zeros(4, 12))
    assert torch.isfinite(s.obs).all() and s.pipeline_state.efc_active.any(1).all()
