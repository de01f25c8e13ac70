"""The PyTorch port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA device (the kernels are CUDA C++ with no CPU mode)
and skip without one. They import neither JAX nor tests/conftest.py, so on
the machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LINALG_TOL = 1e-5  # tests/test_linalg_pallas.py:31
NEWTON_TOL = 1e-4  # tests/test_newton_pallas.py:210-215


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    from ambersim_tpu_torch.engine.forward import full_f32_matmul

    full_f32_matmul()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", (1, 7, 18, 25, 32))
def test_linalg_kernels_match_plain(cuda, n):
    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(30 + n)
    g = rng.standard_normal((257, n, n)).astype(np.float32)
    a = torch.as_tensor(g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32), device=cuda)
    b = torch.as_tensor(rng.standard_normal((257, n)).astype(np.float32), device=cuda)
    l = linalg.cholesky_unrolled(a)
    tol = dict(rtol=LINALG_TOL, atol=LINALG_TOL)
    torch.testing.assert_close(kernels.cholesky_batched(a), l, **tol)
    torch.testing.assert_close(kernels.cho_solve_batched(l, b), linalg.cho_solve_unrolled(l, b), **tol)
    torch.testing.assert_close(kernels.solve_pd_batched(a, b), linalg.solve_pd_unrolled(a, b), **tol)


def test_newton_kernel_matches_plain_on_every_row_family(cuda):
    from chip_smoke import synthetic_structured_problem

    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    st, pa, bJ, dsc = synthetic_structured_problem(257, seed=3, device=cuda)
    got = newton_solve_structured(
        pa["J"], bJ, dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"], pa["ws"], pa["tol"],
        st=st, iterations=5, ls_iterations=8, use_ws=True,
    )
    want = _newton_arrays(**pa, iterations=5, ls_iterations=8, use_ws=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=NEWTON_TOL, atol=NEWTON_TOL)


def test_card_rollout_matches_cpu(cuda):
    """The card rollout (kernels) follows the CPU rollout (plain versions)."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, rollout

    def ctrl(d):
        return 60.0 * (0.0 - d.qpos[:, 7:]) - 2.0 * d.qvel[:, 6:]

    runs = {}
    for device in (cuda, "cpu"):
        m = load_model("quadruped", device=device)
        d = make_data(m, 16)
        noise = np.random.default_rng(0).standard_normal((16, m.nq - 7)).astype(np.float32)
        d.qpos[:, 7:] += torch.as_tensor(0.05 * noise, device=device)
        runs[str(device)] = rollout(m, d, 10, ctrl_fn=ctrl)
    gpu, cpu = runs[str(cuda)], runs["cpu"]
    assert torch.isfinite(gpu.qpos).all()
    torch.testing.assert_close(gpu.qpos.cpu(), cpu.qpos, rtol=0, atol=1e-3)
    torch.testing.assert_close(gpu.qvel.cpu(), cpu.qvel, rtol=0, atol=1e-2)


def test_main_path_launch_counts(cuda):
    """Every step launches each of the four kernels once."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    m = load_model("quadruped", device=cuda)
    d = make_data(m, 32)
    reset_launch_counts()
    rollout(m, d, 7)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"cholesky": 7, "cho_solve": 7, "solve_pd": 7, "newton_structured": 7}
