"""benchmarks/ladder.py rung 1's single pendulum (:94-96: a batch of one,
1000 steps; no constraint rows, so a step is the factor and solve of
qM and Euler) through the port's rollout at B = 1 against
ambersim_tpu.engine.rollout on one unbatched Data (the ladder's form), on
the CPU: 200 steps from a numpy-seeded angle and velocity.

Bars: qpos atol 1e-5, qvel atol 1e-4 (a swinging pendulum, no contacts:
only the float32 summation orders part the packages). Measured on a CPU:
max |dqpos| 8.9e-8 and max |dqvel| 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tools import torch_parity as tp

STEPS = 200
QPOS_ATOL, QVEL_ATOL = 1e-5, 1e-4


def test_single_pendulum_matches_jax():
    from ambersim_tpu.engine import make_data as jax_make_data
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import make_data, rollout

    torch.set_num_threads(1)
    jm = tp.jax_asset_model("pendulum")
    tm = tp.torch_model(jm)
    assert tm.skel.nefc == 0
    rng = np.random.default_rng(31)
    qpos = (np.asarray(jm.qpos0) + rng.uniform(-1.0, 1.0, jm.skel.nq)).astype(np.float32)
    qvel = rng.standard_normal(jm.skel.nv).astype(np.float32)
    jd = jax_make_data(jm).replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    ref = jax.jit(lambda d: jax_rollout(jm, d, STEPS, batched=False))(jd)
    d = make_data(tm, 1).replace(qpos=torch.as_tensor(qpos)[None], qvel=torch.as_tensor(qvel)[None])
    got = rollout(tm, d, STEPS)
    assert got.qpos.shape == (1, jm.skel.nq) and torch.isfinite(got.qpos).all()
    tp.assert_close("qpos", got.qpos[0], ref.qpos, rtol=0.0, atol=QPOS_ATOL)
    tp.assert_close("qvel", got.qvel[0], ref.qvel, rtol=0.0, atol=QVEL_ATOL)
    tp.assert_close("time", got.time[0], ref.time, rtol=0.0, atol=1e-6)
    # it swings: the angle moved by more than the bars
    assert abs(float(got.qpos[0, 0]) - float(qpos[0])) > 1e-2
