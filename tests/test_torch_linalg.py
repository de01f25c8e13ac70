"""Plain versions of kernels 1-3 (engine/linalg.py of the PyTorch port)
against the JAX package's unrolled jnp path (engine/linalg.py) and its
Pallas kernel bodies (_chol_columns/_solve_from_l, batch-last), for
n in {1, 7, 18, 25} and B=5 at rtol/atol 1e-5; the fused solve against
_chol_columns + _solve_from_l, zero pivots included, at n in
{1, 2, 3, 18, 25, 32}; and the dispatch by device.

Past n = 32 (the block-per-system kernels): n in {33, 65, 128, 192} against
the JAX package's own CPU path at those sizes (the unrolled sweep at
n <= 64, XLA's native factor and triangular solves past it,
engine/linalg.py:146-197) and float64 numpy, at the 2e-4 bars of
tests/test_linalg_pallas.py:76-98; and against the Pallas bodies at n = 33:
_chol_columns/_solve_from_l and the panel-blocked
_chol_columns_panel/_solve_from_l_panel with 16-wide panels (three panels,
the last one ragged). The panel bodies run past n = 64 on the TPU, but
eager jnp takes 36-97 s per call there and jit 27-108 s to compile
(n = 65-192, a CPU), so they are held at n = 33 where their logic is the
same. The kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ambersim_tpu.engine import linalg as jax_linalg
from ambersim_tpu.ops.linalg_pallas import _chol_columns, _chol_columns_panel, _solve_from_l, _solve_from_l_panel
from ambersim_tpu_torch.engine import linalg
from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
from ambersim_tpu_torch.ops import linalg as kernels

RTOL = ATOL = 1e-5
SIZES = (1, 7, 18, 25)
B = 5
LARGE = (33, 65, 128, 192)
LARGE_TOL = 2e-4  # tests/test_linalg_pallas.py:76-98


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


@pytest.mark.parametrize("n", (1, 2, 3, 18, 25, 32))
def test_solve_pd_matches_pallas_body(n):
    """The plain fused solve, which kernel 3 is held to on the card, against
    the TPU body it replaces (_solve_pd_kernel at n <= 64: the rsqrt-pivot
    _chol_columns, then _solve_from_l's multiply-only sweeps); with a zero
    row and column (j = 0 and n // 2), both are non-finite in the same
    entries."""
    a, b = _spd(n, seed=60 + n)
    x_k = _solve_from_l(_chol_columns(_batch_last(a), n), _batch_last(b), n)
    got = linalg.solve_pd(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, _batch_first(x_k), rtol=RTOL, atol=ATOL)
    for j in sorted({0, n // 2}):
        z = a.copy()
        z[:, j, :] = 0.0
        z[:, :, j] = 0.0
        x_k = _batch_first(_solve_from_l(_chol_columns(_batch_last(z), n), _batch_last(b), n))
        got = linalg.solve_pd(torch.as_tensor(z), torch.as_tensor(b)).numpy()
        assert not np.isfinite(got).all(), f"zero row {j}: the plain solve stayed finite"
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(x_k), err_msg=f"zero row {j}")


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


@pytest.mark.parametrize("n, k", [(1, 3), (18, 136), (33, 4), (192, 2)])
def test_cho_solve_k_right_hand_sides(n, k):
    """cho_solve with (B, k, n) right-hand sides (the noslip pass's M^-1 J^T)
    gives the bits of k separate (B, n) solves against the same factors,
    and agrees with the JAX package's vmap over the rows (noslip.py:69)
    within 1e-5 (2e-4 past n = 32, as the kernels' bars)."""
    a, _ = _spd(n, seed=70 + n, batch=3)
    rhs = np.random.default_rng(71 + n).standard_normal((3, k, n)).astype(np.float32)
    l = linalg.cholesky(torch.as_tensor(a))
    got = linalg.cho_solve(l, torch.as_tensor(rhs))
    assert got.shape == (3, k, n)
    sep = torch.stack([linalg.cho_solve(l, torch.as_tensor(rhs[:, j])) for j in range(k)], 1)
    assert torch.equal(got, sep)
    want = jax.vmap(lambda lj, bj: jax.vmap(lambda r: jax_linalg.cho_solve_unrolled(lj, r))(bj))(
        jnp.asarray(l.numpy()), jnp.asarray(rhs))
    tol = 1e-5 if n <= kernels.MAX_N_WARP else LARGE_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_cho_solve_launcher_checks_k_right_hand_sides():
    """Kernel 2's launcher takes (B, n) or (B, k >= 1, n) right-hand sides
    and refuses any other shape before it looks at the device; kernel 3's
    takes (B, n) only. Well-shaped CPU tensors are refused for the device."""
    a, _ = _spd(5, seed=72)
    a = torch.as_tensor(a)
    for bad in ((B, 0, 5), (B + 1, 2, 5), (B, 2, 4), (B, 2, 2, 5), (B, 4)):
        with pytest.raises(ValueError, match="right-hand side"):
            kernels.cho_solve_batched(a, torch.zeros(bad))
    with pytest.raises(ValueError, match="right-hand side"):
        kernels.solve_pd_batched(a, torch.zeros(B, 2, 5))
    for good in ((B, 5), (B, 1, 5), (B, 7, 5)):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.cho_solve_batched(a, torch.zeros(good))


@pytest.mark.parametrize("launcher", ["cholesky_batched", "cho_solve_batched", "solve_pd_batched"])
def test_cuda_launchers_refuse_cpu_tensors(launcher):
    a, b = _spd(7, seed=6)
    args = (torch.as_tensor(a),) if launcher == "cholesky_batched" else (torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, launcher)(*args)


def _batch_last(x):
    return jnp.moveaxis(jnp.asarray(x), 0, -1)


def _batch_first(x):
    return np.moveaxis(np.asarray(x), -1, 0)


@pytest.mark.parametrize("n", LARGE)
def test_large_n_matches_jax(n):
    """Factor, solve from the factor and fused solve past the warp kernels'
    n = 32, against the JAX package's CPU path and float64."""
    a, b = _spd(n, seed=40 + n, batch=3)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    l = linalg.cholesky(at)
    tol = dict(rtol=LARGE_TOL, atol=LARGE_TOL)
    l_jax = np.array(jax_linalg.cholesky_unrolled(jnp.asarray(a)))
    np.testing.assert_allclose(l.numpy(), l_jax, **tol)
    np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a.astype(np.float64)), **tol)
    assert torch.all(torch.triu(l, diagonal=1) == 0)
    want = np.asarray(jax_linalg.cho_solve_unrolled(jnp.asarray(l_jax), jnp.asarray(b)))
    np.testing.assert_allclose(linalg.cho_solve(torch.as_tensor(l_jax), bt).numpy(), want, **tol)
    x64 = np.linalg.solve(a.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(linalg.solve_pd(at, bt).numpy(), x64, **tol)


@pytest.mark.parametrize("panel", [None, 16], ids=["columns", "panels16"])
def test_n33_matches_pallas_bodies(panel):
    """n = 33 against the Pallas kernel bodies: the plain column sweep
    (n <= 64 on the TPU) and the panel-blocked factor and substitutions
    (n > 64) cut into 16-wide panels."""
    n = 33
    a, b = _spd(n, seed=73, batch=3)
    if panel is None:
        l_k = _chol_columns(_batch_last(a), n)
        x_k = _solve_from_l(l_k, _batch_last(b), n)
    else:
        l_k = _chol_columns_panel(_batch_last(a), n, panel)
        x_k = _solve_from_l_panel(l_k, _batch_last(b), n, panel)
    tol = dict(rtol=LARGE_TOL, atol=LARGE_TOL)
    np.testing.assert_allclose(linalg.cholesky(torch.as_tensor(a)).numpy(), _batch_first(l_k), **tol)
    got = linalg.cho_solve(torch.as_tensor(_batch_first(l_k).copy()), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, _batch_first(x_k), **tol)
    np.testing.assert_allclose(linalg.solve_pd(torch.as_tensor(a), torch.as_tensor(b)).numpy(), _batch_first(x_k), **tol)


@pytest.mark.parametrize("n", (65, 192))
def test_large_n_cholesky_ignores_upper_triangle(n):
    a, _ = _spd(n, seed=80 + n, batch=2)
    tril = np.tril(np.ones((n, n), np.float32))
    garbage = 1e6 * np.random.default_rng(n).standard_normal(a.shape).astype(np.float32)
    full = linalg.cholesky(torch.as_tensor(a))
    low = linalg.cholesky(torch.as_tensor(a * tril + garbage * (1 - tril)))
    np.testing.assert_allclose(low.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", (18, 192))
def test_cho_solve_ignores_upper_triangle(n):
    """The plain Cholesky solve, which kernel 2 is held against, reads only
    the lower triangle of L: 1e6-scale garbage above it changes no bit."""
    a, b = _spd(n, seed=90 + n, batch=2)
    l = linalg.cholesky(torch.as_tensor(a))
    garbage = 1e6 * torch.as_tensor(np.random.default_rng(n).standard_normal(a.shape).astype(np.float32))
    bt = torch.as_tensor(b)
    assert torch.equal(linalg.cho_solve(l + torch.triu(garbage, diagonal=1), bt), linalg.cho_solve(l, bt))


def test_launcher_names_by_n():
    """n <= 32 is counted under the warp kernels' names, 32 < n <= 192 under
    the block kernels'; the CUDA launchers refuse CPU tensors at any n."""
    assert {k for k in LAUNCHES if k.endswith("_block")} == {"cholesky_block", "cho_solve_block", "solve_pd_block"}
    assert (kernels.MAX_N_WARP, kernels.MAX_N) == (32, 192)
    a, b = _spd(65, seed=7, batch=2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.solve_pd_batched(torch.as_tensor(a), torch.as_tensor(b))
