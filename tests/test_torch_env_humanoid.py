"""The PyTorch port's humanoid balance env against the JAX package's (CPU):
8 envs x 5 control steps (25 physics steps) with the same actions, both
packages stepping from the same carry (the port's reset_to state), plus the
registry and the env's own draws. Bars: the main path's rollout bars
(tests/test_torch_rollout.py), qpos-derived quantities at 1e-4 and
qvel-derived ones at 1e-3; done exactly.
"""

import numpy as np
import pytest
import torch

from tools import torch_parity as tp

QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
B, T = 8, 5


@pytest.fixture(scope="module")
def humanoid_case():
    from ambersim_tpu.rl.humanoid import HumanoidBalanceEnv as JaxHumanoid
    from ambersim_tpu_torch.rl.humanoid import HumanoidBalanceEnv

    torch.set_num_threads(1)
    jenv, env = JaxHumanoid(), HumanoidBalanceEnv(device="cpu")
    # the JAX env's reset draws: qpos0 + 0.12 N(0, 1) on the joints, 0.25 N(0, 1) on the base velocity
    rng = np.random.default_rng(7)
    nq, nv, nu = env.model.skel.nq, env.model.skel.nv, env.model.skel.nu
    qpos = np.tile(np.asarray(jenv.model.qpos0, np.float32), (B, 1))
    qpos[:, 7:] += 0.12 * rng.standard_normal((B, nq - 7)).astype(np.float32)
    qvel = np.zeros((B, nv), np.float32)
    qvel[:, :6] = 0.25 * rng.standard_normal((B, 6)).astype(np.float32)
    s = env.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel))
    jstate = tp.jax_env_state(jenv, qpos, qvel, s.pipeline_state.qacc_warmstart.numpy(),
                              actions=("last_action", "prev_action"))
    start = (tp.env_state_to_numpy(jstate), tp.env_state_to_numpy(s))
    acts = tp.uniform_actions(8, T, B, nu)
    want = tp.jax_env_run(jenv, jstate, acts)
    got = []
    for a in acts:
        s = env.step(s, torch.as_tensor(a))
        got.append(tp.env_state_to_numpy(s))
    return env, start, want, got


def _obs_bars(nq: int, nv: int, nu: int):
    """obs columns: gravity, lin_vel, ang_vel, height, joint pos, 0.1 joint vel, last action."""
    j = nq - 7
    return [(slice(0, 3), QPOS_ATOL), (slice(3, 9), QVEL_ATOL), (slice(9, 10 + j), QPOS_ATOL),
            (slice(10 + j, 10 + j + nv - 6), 0.1 * QVEL_ATOL), (slice(10 + j + nv - 6, 10 + j + nv - 6 + nu), 0.0)]


def test_reset_obs_matches_jax(humanoid_case):
    env, (js, s), _, _ = humanoid_case
    assert s["obs"].shape == (B, env.observation_size)
    tp.assert_close("reset obs", s["obs"], js["obs"], rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("t", range(T))
def test_humanoid_steps_match_jax(humanoid_case, t):
    env, _, want, got = humanoid_case
    w, g = want[t], got[t]
    sk = env.model.skel
    for cols, atol in _obs_bars(sk.nq, sk.nv, sk.nu):
        tp.assert_close(f"obs[{cols}] step {t}", g["obs"][:, cols], w["obs"][:, cols], rtol=0.0, atol=atol)
    tp.assert_close(f"qpos step {t}", g["qpos"], w["qpos"], rtol=0.0, atol=QPOS_ATOL)
    tp.assert_close(f"qvel step {t}", g["qvel"], w["qvel"], rtol=0.0, atol=QVEL_ATOL)
    tp.assert_close(f"reward step {t}", g["reward"], w["reward"], rtol=0.0, atol=QVEL_ATOL)
    np.testing.assert_array_equal(g["done"], w["done"])


def test_pd_map_goes_through_trnid(humanoid_case):
    """Actuator order is not qpos order on the humanoid: the PD map reads
    each actuator's joint through trnid."""
    env = humanoid_case[0]
    s = env.model.skel
    qadr = np.asarray(s.jnt_qposadr)[np.asarray(s.actuator_trnid)]
    assert not np.array_equal(qadr, np.arange(7, 7 + s.nu))
    np.testing.assert_array_equal(env.default_pose.numpy(), env.model.qpos0.numpy()[qadr])


def test_registry_and_draws():
    """get_environment("humanoid_balance") is the ported env; its starts come
    from the generator (alike for a generator seeded alike)."""
    from ambersim_tpu_torch.rl import get_environment
    from ambersim_tpu_torch.rl.humanoid import HumanoidBalanceEnv

    torch.set_num_threads(1)
    env = get_environment("humanoid_balance", device="cpu")
    assert isinstance(env, HumanoidBalanceEnv) and env.action_size == env.model.skel.nu

    def start(seed):
        return env.draw_start(torch.Generator().manual_seed(seed), 4)

    (q0, v0), (q1, v1), (q2, _) = start(0), start(0), start(1)
    assert torch.equal(q0, q1) and torch.equal(v0, v1) and not torch.equal(q0, q2)
    torch.testing.assert_close(q0[:, :7], env.model.qpos0[:7].expand(4, 7), rtol=0, atol=0)
    assert (v0[:, 6:] == 0).all() and (v0[:, :6] != 0).all()
