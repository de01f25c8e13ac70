"""The PyTorch port's quadruped locomotion env against the JAX package's
(CPU): 8 envs x 5 control steps (20 physics steps) with the same actions,
both packages stepping from the same carry. Bars: the main path's rollout
bars (tests/test_torch_rollout.py), qpos-derived quantities at 1e-4 and
qvel-derived ones at 1e-3.
"""

import numpy as np
import pytest
import torch

from tools import torch_parity as tp

QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def quadruped_case():
    from ambersim_tpu.rl.quadruped import QuadrupedLocomotionEnv as JaxQuadruped
    from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv

    torch.set_num_threads(1)
    jenv, env = JaxQuadruped(), QuadrupedLocomotionEnv(device="cpu")
    # the JAX env's reset draws: qpos0 + 0.08 N(0, 1) on the joints, 0.05 N(0, 1) on the base velocity
    rng = np.random.default_rng(5)
    qpos = np.tile(np.asarray(jenv.model.qpos0, np.float32), (8, 1))
    qpos[:, 7:] += 0.08 * rng.standard_normal((8, 12)).astype(np.float32)
    qvel = np.zeros((8, 18), np.float32)
    qvel[:, :6] = 0.05 * rng.standard_normal((8, 6)).astype(np.float32)
    s = env.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel))
    # both packages step from the same carry: the port's reset state
    jstate = tp.jax_env_state(jenv, qpos, qvel, s.pipeline_state.qacc_warmstart.numpy())
    start = (tp.env_state_to_numpy(jstate), tp.env_state_to_numpy(s))
    acts = tp.uniform_actions(6, 5, 8, 12)
    want = tp.jax_env_run(jenv, jstate, acts)
    got = []
    for a in acts:
        s = env.step(s, torch.as_tensor(a))
        got.append(tp.env_state_to_numpy(s))
    return start, want, got


# obs columns of the quadruped: (gravity, lin_vel, ang_vel, joint pos, 0.1 joint vel, last action)
_QUAD_OBS_BARS = [(slice(0, 3), QPOS_ATOL), (slice(3, 9), QVEL_ATOL), (slice(9, 21), QPOS_ATOL),
                  (slice(21, 33), 0.1 * QVEL_ATOL), (slice(33, 45), 0.0)]


def test_quadruped_steps_match_jax(quadruped_case):
    (js, s), want, got = quadruped_case
    tp.assert_close("reset obs", s["obs"], js["obs"], rtol=0.0, atol=1e-6)
    for t, (w, g) in enumerate(zip(want, got)):
        assert g["obs"].shape == (8, 45)
        for cols, atol in _QUAD_OBS_BARS:
            tp.assert_close(f"obs[{cols}] step {t}", g["obs"][:, cols], w["obs"][:, cols], rtol=0.0, atol=atol)
        tp.assert_close(f"qpos step {t}", g["qpos"], w["qpos"], rtol=0.0, atol=QPOS_ATOL)
        tp.assert_close(f"qvel step {t}", g["qvel"], w["qvel"], rtol=0.0, atol=QVEL_ATOL)
        tp.assert_close(f"reward step {t}", g["reward"], w["reward"], rtol=0.0, atol=QVEL_ATOL)
        np.testing.assert_array_equal(g["done"], w["done"])
