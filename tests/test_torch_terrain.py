"""The port's quadruped_terrain (ambersim_tpu_torch/rl/quadruped/terrain.py)
against the JAX package's (CPU).

The model: the port's compiler on the scene the env builds (the packaged
quadruped with its floor swapped for a 24 x 24 height field at
terrain_seed 3, ex_terrain.py's seed) against the JAX package's
`_build_terrain_model`: every Skeleton field and hfield_data bit for bit,
every leaf too but the three setconst fields, those within
chip_smoke.setconst_rtol (as tests/test_torch_mjcf.py). The env: 8 envs x
10 control steps (40 physics steps) with the same actions from the same
carry, at tests/test_torch_env_quadruped.py's bars (qpos-derived obs at
1e-4, qvel-derived at 1e-3, done exactly). Then one tiny PPO training
step on the env stays finite.
"""

import numpy as np
import pytest
import torch

from test_torch_env_quadruped import _QUAD_OBS_BARS, QPOS_ATOL, QVEL_ATOL
from test_torch_mjcf import SETCONST, assert_fields_equal, assert_setconst_close
from tools import torch_parity as tp

B, T = 8, 10
SEED = 3  # examples/rl/quadruped/ex_terrain.py:26


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("terrain_seed", [0, SEED])
def test_terrain_model_matches_jax(terrain_seed):
    from ambersim_tpu.rl.quadruped.terrain import QuadrupedTerrainConfig as JaxConfig
    from ambersim_tpu.rl.quadruped.terrain import _build_terrain_model
    from ambersim_tpu_torch.rl.quadruped.terrain import QuadrupedTerrainConfig, terrain_arrays
    from tools.export_model_npz import model_arrays

    want_skel, want = model_arrays(_build_terrain_model(JaxConfig(terrain_seed=terrain_seed)))
    got_skel, got = terrain_arrays(QuadrupedTerrainConfig(terrain_seed=terrain_seed))
    assert_fields_equal(got_skel, want_skel)
    assert_fields_equal(got, want, skip=SETCONST)
    assert_setconst_close(got_skel, got, want)
    assert got["hfield_data"].shape == (1, 24, 24) and 0.9 < got["hfield_data"].max() <= 1.0
    s = got_skel
    assert (s["nefc"], s["ncon"], len(s["pair_geom1"])) == (296, 68, 17)
    assert set(np.asarray(s["pair_hfk"]).tolist()) == {3}


def test_terrain_config_reads_only_the_packaged_quadruped():
    """The scene is built from the packaged MJCF; the `model` field the
    config inherits from the flat env (an asset's name) is refused rather
    than ignored."""
    from ambersim_tpu_torch.rl.quadruped.terrain import QUADRUPED_XML, QuadrupedTerrainConfig

    assert QUADRUPED_XML.endswith("models/quadruped/quadruped.xml")
    QuadrupedTerrainConfig(model="quadruped")
    with pytest.raises(ValueError, match="not read"):
        QuadrupedTerrainConfig(model="quadruped_elliptic")


@pytest.fixture(scope="module")
def terrain_case():
    from ambersim_tpu.rl.quadruped.terrain import QuadrupedTerrainConfig as JaxConfig
    from ambersim_tpu.rl.quadruped.terrain import QuadrupedTerrainEnv as JaxTerrain
    from ambersim_tpu_torch.rl.quadruped import QuadrupedTerrainConfig, QuadrupedTerrainEnv

    jenv = JaxTerrain(JaxConfig(terrain_seed=SEED, target_vel=0.4))
    env = QuadrupedTerrainEnv(QuadrupedTerrainConfig(terrain_seed=SEED, target_vel=0.4), device="cpu")
    # the env's reset draws: qpos0 + 0.08 N(0, 1) on the joints, 0.05 N(0, 1) on the base velocity
    rng = np.random.default_rng(15)
    qpos = np.tile(np.asarray(jenv.model.qpos0, np.float32), (B, 1))
    qpos[:, 7:] += 0.08 * rng.standard_normal((B, 12)).astype(np.float32)
    qvel = np.zeros((B, 18), np.float32)
    qvel[:, :6] = 0.05 * rng.standard_normal((B, 6)).astype(np.float32)
    s = env.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel))
    jstate = tp.jax_env_state(jenv, qpos, qvel, s.pipeline_state.qacc_warmstart.numpy())
    start = (tp.env_state_to_numpy(jstate), tp.env_state_to_numpy(s))
    acts = tp.uniform_actions(16, T, B, 12)
    want = tp.jax_env_run(jenv, jstate, acts)
    got = []
    for a in acts:
        s = env.step(s, torch.as_tensor(a))
        got.append(tp.env_state_to_numpy(s))
    return start, want, got


def test_terrain_reset_obs_matches_jax(terrain_case):
    (js, s), _, _ = terrain_case
    assert s["obs"].shape == (B, 45)
    tp.assert_close("reset obs", s["obs"], js["obs"], rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("t", range(T))
def test_terrain_steps_match_jax(terrain_case, t):
    _, want, got = terrain_case
    w, g = want[t], got[t]
    for cols, atol in _QUAD_OBS_BARS:
        tp.assert_close(f"obs[{cols}] step {t}", g["obs"][:, cols], w["obs"][:, cols], rtol=0.0, atol=atol)
    tp.assert_close(f"qpos step {t}", g["qpos"], w["qpos"], rtol=0.0, atol=QPOS_ATOL)
    tp.assert_close(f"qvel step {t}", g["qvel"], w["qvel"], rtol=0.0, atol=QVEL_ATOL)
    tp.assert_close(f"reward step {t}", g["reward"], w["reward"], rtol=0.0, atol=QVEL_ATOL)
    np.testing.assert_array_equal(g["done"], w["done"])


def test_terrain_ppo_step_stays_finite():
    """One PPO training step of ex_terrain.py's recipe at a tiny size: 8
    envs x 4 control steps x 2 unrolls, 2 evals of 4 envs x 5 steps."""
    from ambersim_tpu_torch.rl.quadruped import QuadrupedTerrainConfig, QuadrupedTerrainEnv
    from ambersim_tpu_torch.rl.ppo import train

    calls = []
    env = QuadrupedTerrainEnv(QuadrupedTerrainConfig(terrain_seed=SEED, target_vel=0.4), device="cpu")
    _, (normalizer, policy), metrics = train(
        env, num_timesteps=64, num_evals=2, episode_length=5, normalize_observations=True, unroll_length=4,
        num_minibatches=2, num_updates_per_batch=2, discounting=0.97, learning_rate=3e-4, entropy_cost=1e-2,
        num_envs=8, num_eval_envs=4, batch_size=8, seed=0, device="cpu",
        progress_fn=lambda step, m: calls.append(step),
    )
    assert calls == [0, 64]
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert float(normalizer.count) == 64.0
    assert all(torch.isfinite(v).all() for v in policy.values())
