"""Plain versions of kernels 1-3 (engine/linalg.py of the PyTorch port)
against the JAX package's unrolled jnp path (engine/linalg.py) and its
Pallas kernel bodies (_chol_columns/_solve_from_l, batch-last), for
n in {1, 7, 18, 25} and B=5 at rtol/atol 1e-5; and the dispatch by device.
The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambersim_tpu.engine import linalg as jax_linalg
from ambersim_tpu.ops.linalg_pallas import _chol_columns, _solve_from_l
from ambersim_tpu_torch.engine import linalg
from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
from ambersim_tpu_torch.ops import linalg as kernels

RTOL = ATOL = 1e-5
SIZES = (1, 7, 18, 25)
B = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _spd(n, seed, batch=B):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((batch, n, n)).astype(np.float32)
    a = g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((batch, n)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n", SIZES)
def test_cholesky_matches_jax(n):
    a, _ = _spd(n, seed=n)
    got = linalg.cholesky(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_linalg.cholesky_unrolled(jnp.asarray(a))), rtol=RTOL, atol=ATOL)
    kernel_body = np.moveaxis(np.asarray(_chol_columns(jnp.moveaxis(jnp.asarray(a), 0, -1), n)), -1, 0)
    np.testing.assert_allclose(got, kernel_body, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", SIZES)
def test_cho_solve_matches_jax(n):
    a, b = _spd(n, seed=10 + n)
    l = np.array(jax_linalg.cholesky_unrolled(jnp.asarray(a)))
    got = linalg.cho_solve(torch.as_tensor(l), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_linalg.cho_solve_unrolled(jnp.asarray(l), jnp.asarray(b))), rtol=RTOL, atol=ATOL
    )
    kernel_body = _solve_from_l(jnp.moveaxis(jnp.asarray(l), 0, -1), jnp.moveaxis(jnp.asarray(b), 0, -1), n)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(kernel_body), -1, 0), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", SIZES)
def test_solve_pd_matches_jax(n):
    a, b = _spd(n, seed=20 + n)
    got = linalg.solve_pd(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = jax_linalg.cho_solve_unrolled(jax_linalg.cholesky_unrolled(jnp.asarray(a)), jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.linalg.solve(a.astype(np.float64), b[..., None])[..., 0], rtol=1e-4, atol=1e-5)


def test_cholesky_ignores_upper_triangle():
    """The Newton kernel assembles only the lower triangle of its Hessian:
    the factor must never read above the diagonal."""
    a, _ = _spd(18, seed=3)
    tril = np.tril(np.ones((18, 18), np.float32))
    garbage = 1e6 * np.random.default_rng(4).standard_normal(a.shape).astype(np.float32)
    full = linalg.cholesky(torch.as_tensor(a))
    low = linalg.cholesky(torch.as_tensor(a * tril + garbage * (1 - tril)))
    np.testing.assert_allclose(low.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.all(torch.triu(full, diagonal=1) == 0)


def test_cpu_tensors_take_the_plain_path():
    a, b = _spd(7, seed=5)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    reset_launch_counts()
    torch.testing.assert_close(linalg.cholesky(a), linalg.cholesky_unrolled(a), rtol=0, atol=0)
    torch.testing.assert_close(linalg.solve_pd(a, b), linalg.solve_pd_unrolled(a, b), rtol=0, atol=0)
    torch.testing.assert_close(linalg.cho_solve(a, b), linalg.cho_solve_unrolled(a, b), rtol=0, atol=0)
    assert all(v == 0 for v in LAUNCHES.values())


@pytest.mark.parametrize("launcher", ["cholesky_batched", "cho_solve_batched", "solve_pd_batched"])
def test_cuda_launchers_refuse_cpu_tensors(launcher):
    a, b = _spd(7, seed=6)
    args = (torch.as_tensor(a),) if launcher == "cholesky_batched" else (torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, launcher)(*args)
