"""`engine.forward.full_f32_matmul` scopes the TF32 switch: inside
`forward` (so `step`) and every trainer (`rl.ppo.train`, `rl.es.train`,
`rl.ars.train`, `rl.sac.train`) both flags read False, and the
caller's values come back on exit (CPU; the flags are process-wide)."""

import pytest
import torch

FLAGS = (torch.backends.cuda.matmul, torch.backends.cudnn)


@pytest.fixture
def tf32_on():
    saved = [f.allow_tf32 for f in FLAGS]
    for f in FLAGS:
        f.allow_tf32 = True
    yield
    for f, v in zip(FLAGS, saved):
        f.allow_tf32 = v


def _flags():
    return tuple(f.allow_tf32 for f in FLAGS)


def test_scope_restores_the_callers_flags(tf32_on):
    from ambersim_tpu_torch.engine.forward import full_f32_matmul

    with full_f32_matmul():
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(RuntimeError):
        with full_f32_matmul():
            raise RuntimeError
    assert _flags() == (True, True)


def test_step_scopes_tf32(tf32_on, monkeypatch):
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, solver, step

    seen = []
    solve = solver.solve

    def recording(m, d):
        seen.append(_flags())
        return solve(m, d)

    monkeypatch.setattr(solver, "solve", recording)
    m = load_model("quadruped", device="cpu")
    d = step(m, make_data(m, 2))
    assert torch.isfinite(d.qpos).all()
    assert seen == [(False, False)]
    assert _flags() == (True, True)


def test_train_scopes_tf32(tf32_on):
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo import train

    seen = []
    train(PendulumSwingupEnv(device="cpu"), device="cpu", num_timesteps=64, num_evals=2, episode_length=8,
          unroll_length=4, num_minibatches=2, num_updates_per_batch=1, num_envs=8, num_eval_envs=4, batch_size=8,
          seed=0, progress_fn=lambda step, metrics: seen.append(_flags()))
    assert seen and all(f == (False, False) for f in seen)
    assert _flags() == (True, True)


@pytest.mark.parametrize("trainer", ["es", "ars", "sac"])
def test_gradient_free_and_off_policy_trainers_scope_tf32(tf32_on, trainer):
    """ES, ARS and SAC train with both flags False, as PPO does."""
    from ambersim_tpu_torch.rl import ars, es, sac
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv

    settings = {
        "es": (es.train, dict(population_size=4, policy_updates=1)),
        "ars": (ars.train, dict(number_of_directions=2, top_directions=1, policy_updates=1)),
        "sac": (sac.train, dict(num_timesteps=32, num_envs=4, batch_size=8, min_replay_size=8, max_replay_size=64)),
    }
    train, kw = settings[trainer]
    seen = []
    train(PendulumSwingupEnv(device="cpu"), device="cpu", num_evals=2, episode_length=8, num_eval_envs=4, seed=0,
          progress_fn=lambda step, metrics: seen.append(_flags()), **kw)
    assert seen and all(f == (False, False) for f in seen)
    assert _flags() == (True, True)
