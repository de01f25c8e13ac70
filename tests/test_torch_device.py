"""The port's entry points run on the card unless the caller passes
device="cpu": by their signatures, and without a card, where a call with no
`device` raises and returns nothing on the CPU (no fallback).

The no-card cases run in one subprocess with CUDA_VISIBLE_DEVICES empty, so
they hold on a machine with a card too. Neither test imports JAX.
"""

import importlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

ENTRY_POINTS = [
    ("ambersim_tpu_torch.io.bridge", "load_model"),
    ("ambersim_tpu_torch.io.bridge", "model_from_numpy"),
    ("ambersim_tpu_torch.io.bridge", "ppo_params_from_jax"),
    ("ambersim_tpu_torch.io.checkpoint", "load_params"),
    ("ambersim_tpu_torch.io.checkpoint", "load_arrays"),
    ("ambersim_tpu_torch.rl.ppo.train", "train"),
    ("ambersim_tpu_torch.rl.pendulum.swingup", "PendulumSwingupEnv"),
    ("ambersim_tpu_torch.rl.quadruped.locomotion", "QuadrupedLocomotionEnv"),
]


@pytest.mark.parametrize("module, name", ENTRY_POINTS, ids=[name for _, name in ENTRY_POINTS])
def test_entry_point_defaults_to_the_card(module, name):
    fn = getattr(importlib.import_module(module), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


# Each case is called with no `device`; the script prints, as JSON, what each
# call did ("raised <type>" for torch's no-card error, "returned <type>";
# any other error fails the script), then whether the same loads work with
# device="cpu".
_NO_CARD = r"""
import json, sys, tempfile
from pathlib import Path
import numpy as np
import torch
from ambersim_tpu_torch import load_model
from ambersim_tpu_torch.io.bridge import ASSETS, model_from_numpy, ppo_params_from_jax, unpack_npz
from ambersim_tpu_torch.io.checkpoint import load_arrays, load_params, save_arrays, save_params, tree_leaves
from ambersim_tpu_torch.rl import get_environment
from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
from ambersim_tpu_torch.rl.ppo import train
from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv

assert not torch.cuda.is_available()
tmp = Path(tempfile.mkdtemp())
tree = {"w": np.ones((2, 3), np.float32), "b": [np.zeros(3, np.float32)]}
save_params(tmp / "p.pkl", tree)
save_arrays(tmp / "p.npz", tree)
with np.load(ASSETS / "pendulum.npz", allow_pickle=False) as npz:
    arrays = unpack_npz(npz)
mlp = {"params": {"hidden_0": {"kernel": np.ones((2, 3), np.float32), "bias": np.zeros(3, np.float32)}}}
cases = {
    "load_model": lambda: load_model("quadruped"),
    "model_from_numpy": lambda: model_from_numpy(*arrays),
    "ppo_params_from_jax": lambda: ppo_params_from_jax(mlp),
    "load_params": lambda: load_params(tmp / "p.pkl"),
    "load_arrays": lambda: load_arrays(tmp / "p.npz", tree),
    "train": lambda: train(PendulumSwingupEnv(device="cpu"), num_timesteps=1),
    "PendulumSwingupEnv": lambda: PendulumSwingupEnv(),
    "QuadrupedLocomotionEnv": lambda: QuadrupedLocomotionEnv(),
    "get_environment": lambda: get_environment("quadruped_locomotion"),
}
out = {}
for name, call in cases.items():
    try:
        got = call()
    except (AssertionError, RuntimeError) as err:  # torch's own: not compiled with / no CUDA
        out[name] = f"raised {type(err).__name__}"
    else:
        out[name] = f"returned {type(got).__name__}"
cpu = load_model("quadruped", device="cpu")
env = QuadrupedLocomotionEnv(device="cpu")
params = load_params(tmp / "p.pkl", device="cpu")
out["cpu"] = (cpu.qpos0.device.type == env.model.qpos0.device.type == "cpu"
              and all(x.device.type == "cpu" for x in tree_leaves(params)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def no_card_calls():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _NO_CARD], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [name for _, name in ENTRY_POINTS] + ["get_environment"])
def test_entry_point_without_a_card_raises(no_card_calls, name):
    assert no_card_calls[name].startswith("raised "), no_card_calls[name]


def test_entry_points_run_on_the_cpu_when_asked(no_card_calls):
    assert no_card_calls["cpu"] is True
