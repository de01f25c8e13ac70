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
LARGE_LINALG_TOL = 2e-4  # tests/test_linalg_pallas.py:76-98 (n = 192)
NEWTON_TOL = 1e-4  # tests/test_newton_pallas.py:210-215


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    from ambersim_tpu_torch.engine.forward import full_f32_matmul

    with full_f32_matmul():
        yield torch.device("cuda", 0)


@pytest.mark.parametrize("n", range(1, 33))
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
    # the upper triangle is never read, and L is zero above the diagonal
    got = kernels.cholesky_batched(a)
    a_low = torch.tril(a) + torch.triu(torch.full_like(a, 1e6), diagonal=1)
    assert torch.equal(kernels.cholesky_batched(a_low), got)
    assert torch.equal(kernels.solve_pd_batched(a_low, b), kernels.solve_pd_batched(a, b))
    l_low = l + torch.triu(torch.full_like(l, 1e6), diagonal=1)
    assert torch.equal(kernels.cho_solve_batched(l_low, b), kernels.cho_solve_batched(l, b))
    assert torch.all(torch.triu(got, diagonal=1) == 0)


@pytest.mark.parametrize("n, k", [(1, 5), (18, 136), (31, 3), (33, 4), (192, 3)])
def test_cho_solve_kernel_k_right_hand_sides(cuda, n, k):
    """Kernel 2 with (B, k, n) right-hand sides (warp design n <= 32, block
    design past it) against the plain version, with the bits of k separate
    (B, n) launches on the same factors, and one launch counted."""
    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(80 + n)
    g = rng.standard_normal((33, n, n)).astype(np.float32)
    a = torch.as_tensor(g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32), device=cuda)
    b = torch.as_tensor(rng.standard_normal((33, k, n)).astype(np.float32), device=cuda)
    l = linalg.cholesky_unrolled(a)
    reset_launch_counts()
    got = kernels.cho_solve_batched(l, b)
    assert LAUNCHES["cho_solve" if n <= kernels.MAX_N_WARP else "cho_solve_block"] == 1
    tol = LINALG_TOL if n <= kernels.MAX_N_WARP else LARGE_LINALG_TOL
    torch.testing.assert_close(got, linalg.cho_solve_unrolled(l, b), rtol=tol, atol=tol)
    assert torch.equal(got, torch.stack([kernels.cho_solve_batched(l, b[:, j].contiguous()) for j in range(k)], 1))


@pytest.mark.parametrize("n", (3, 18, 25))
def test_solve_pd_kernel_at_storage_offset_one(cuda, n):
    """Kernel 3 on systems that do not start 16-byte aligned (a contiguous
    batch at storage offset 1: its window copy) against the plain version,
    with the bits of the same systems stored aligned."""
    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(60 + n)
    g = rng.standard_normal((257, n, n)).astype(np.float32)
    a = torch.as_tensor(g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32), device=cuda)
    b = torch.as_tensor(rng.standard_normal((257, n)).astype(np.float32), device=cuda)
    a_off = torch.empty(a.numel() + 1, device=cuda)[1:].view_as(a).copy_(a)
    assert a_off.is_contiguous() and a_off.data_ptr() % 16 == 4
    got = kernels.solve_pd_batched(a_off, b)
    torch.testing.assert_close(got, linalg.solve_pd_unrolled(a_off, b), rtol=LINALG_TOL, atol=LINALG_TOL)
    assert torch.equal(got, kernels.solve_pd_batched(a, b))


# n = 100 and 191 are not multiples of the 16-wide tiles; 1000 systems are
# more than fit on the card at once (two blocks an SM)
@pytest.mark.parametrize("B, n", [(37, 33), (37, 64), (37, 65), (37, 100), (37, 128), (37, 191), (37, 192),
                                  (1000, 192)])
def test_block_linalg_kernels_match_plain(cuda, B, n):
    """Kernels 1-3 past n = 32 (one block per system): against the plain
    versions, the upper triangle unread, zeros above the diagonal."""
    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(30 + n)
    g = rng.standard_normal((B, n, n)).astype(np.float32)
    a = torch.as_tensor(g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32), device=cuda)
    b = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32), device=cuda)
    l = linalg.cholesky_unrolled(a)
    tol = dict(rtol=LARGE_LINALG_TOL, atol=LARGE_LINALG_TOL)
    reset_launch_counts()
    got = kernels.cholesky_batched(a)
    torch.testing.assert_close(got, l, **tol)
    assert torch.all(torch.triu(got, diagonal=1) == 0)
    torch.testing.assert_close(kernels.cho_solve_batched(l, b), linalg.cho_solve_unrolled(l, b), **tol)
    torch.testing.assert_close(kernels.solve_pd_batched(a, b), linalg.solve_pd_unrolled(a, b), **tol)
    a_low = torch.tril(a) + torch.triu(torch.full_like(a, 1e6), diagonal=1)
    assert torch.equal(kernels.cholesky_batched(a_low), got)
    assert torch.equal(kernels.solve_pd_batched(a_low, b), kernels.solve_pd_batched(a, b))
    l_low = l + torch.triu(torch.full_like(l, 1e6), diagonal=1)
    assert torch.equal(kernels.cho_solve_batched(l_low, b), kernels.cho_solve_batched(l, b))
    torch.cuda.synchronize()
    assert (LAUNCHES["cholesky_block"], LAUNCHES["cho_solve_block"], LAUNCHES["solve_pd_block"]) == (2, 3, 3)
    assert LAUNCHES["cholesky"] == LAUNCHES["cho_solve"] == LAUNCHES["solve_pd"] == 0


@pytest.mark.parametrize("n", (18, 32, 100, 192))
def test_block_kernels_zero_pivot(cuda, n):
    """Row and column j zero: the 1e-12 clamp gives L_jj = 0 as in the plain
    version, and both solves are non-finite where the plain versions' are
    (the warp kernels at n <= 32, the block kernels past it)."""
    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import linalg as kernels

    rng = np.random.default_rng(40 + n)
    rows = (0, 17, n // 2, n - 1)
    g = rng.standard_normal((len(rows), n, n)).astype(np.float32)
    a = g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32)
    for s, j in enumerate(rows):
        a[s, j, :] = a[s, :, j] = 0.0
    a = torch.as_tensor(a, device=cuda)
    b = torch.as_tensor(rng.standard_normal((len(rows), n)).astype(np.float32), device=cuda)
    got = kernels.cholesky_batched(a)
    tol = LINALG_TOL if n <= 32 else LARGE_LINALG_TOL
    torch.testing.assert_close(got, linalg.cholesky_unrolled(a), rtol=tol, atol=tol)
    assert all(got[s, j, j].item() == 0.0 for s, j in enumerate(rows))
    x = kernels.solve_pd_batched(a, b)
    assert torch.equal(torch.isfinite(x), torch.isfinite(linalg.solve_pd_unrolled(a, b)))
    y = kernels.cho_solve_batched(got, b)
    assert torch.equal(torch.isfinite(y), torch.isfinite(linalg.cho_solve_unrolled(got, b)))


def test_block_kernels_two_blocks_per_sm(cuda):
    """The block kernels keep two systems on every SM at n = 192."""
    from ambersim_tpu_torch.ops import linalg as kernels

    assert kernels.block_occupancy("cholesky_block", 192) >= 2
    assert kernels.block_occupancy("cho_solve_block", 192) >= 2
    assert kernels.block_occupancy("solve_pd_block", 192) >= 2


def test_linalg_kernels_refuse_n_past_192(cuda):
    from ambersim_tpu_torch.ops import linalg as kernels

    a = torch.eye(193, device=cuda).expand(2, 193, 193).contiguous()
    with pytest.raises(ValueError, match="n=193"):
        kernels.cholesky_batched(a)


@pytest.mark.parametrize("row_cap", [False, True])
def test_selection_is_exact_with_tf32_on(cuda, row_cap):
    """The broadphase top-k and the row cap are gathers: geom ids above 256
    and contact distances survive them bit for bit with TF32 matmuls on."""
    from chip_smoke import check_selection_exact

    check_selection_exact(cuda, row_cap)


def test_top_k_ties_on_the_card(cuda):
    """Equal keys (empty slots at -1e10) come out lowest index first."""
    from ambersim_tpu_torch.engine.collision import _top_k

    x = torch.full((3, 600), -1e10, device=cuda)
    x[:, 5] = 1.0
    x[1, 400] = 2.0
    got = _top_k(x, 200).cpu()
    assert got[0].tolist() == [5] + list(range(5)) + list(range(6, 200))
    assert got[1].tolist() == [400, 5] + list(range(5)) + list(range(6, 199))


def test_clutter_launch_counts(cuda):
    """Each clutter step launches the block kernels 1 / 1 / 6 times (qM's
    factor, qacc_smooth's solve, one Hessian solve per Newton iteration) and
    no Newton kernel (nv = 192 takes the large-nv route)."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    for name in ("clutter32_rowcap192", "clutter32_cap48"):
        m = load_model(name, device=cuda)
        reset_launch_counts()
        d = rollout(m, make_data(m, 8), 3)
        torch.cuda.synchronize()
        assert torch.isfinite(d.qpos).all()
        want = {k: 0 for k in LAUNCHES}
        want.update(cholesky_block=3, cho_solve_block=3, solve_pd_block=3 * m.opt.iterations)
        assert dict(LAUNCHES) == want, name


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


@pytest.mark.parametrize("nv", (1, 7, 18, 25, 32))
def test_structured_newton_kernel_meets_float64_as_plain_does(cuda, nv):
    """Kernel 4 on synthetic_structured_problem's own problems (80% of rows
    active, D in [1, 10]) at one lane per dof up to a full warp, 4096 envs,
    where plain float32 misses float64 on more envs than the NEWTON_* bars
    allow: the kernel's share of envs within rtol/atol 1e-4 of float64 is at
    most chip_smoke.NEWTON_F64_SLACK below plain float32's
    (chip_smoke.newton_vs_float64)."""
    from chip_smoke import NEWTON_F64_SLACK, as_dtype, newton_within, synthetic_structured_problem

    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    st, pa, bJ, dsc = synthetic_structured_problem(4096, seed=80 + nv, device=cuda, nv=nv)
    kw = dict(iterations=5, ls_iterations=8, use_ws=True)
    got = newton_solve_structured(pa["J"], bJ, dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"],
                                  pa["ws"], pa["tol"], st=st, **kw)
    exact = _newton_arrays(**as_dtype(pa, torch.float64), **kw)
    assert all(torch.isfinite(g).all() for g in got)
    kernel = newton_within(got, exact).double().mean().item()
    plain = newton_within(_newton_arrays(**pa, **kw), exact).double().mean().item()
    assert kernel >= plain - NEWTON_F64_SLACK, (kernel, plain)


@pytest.mark.parametrize("nv", (1, 7, 18, 25, 32))
@pytest.mark.parametrize("use_ws", (True, False))
def test_structured_newton_kernel_nv_sweep(cuda, nv, use_ws):
    """Kernel 4 on every row family at one lane per dof up to a full warp
    (36 contacts at nv = 32), 4096 envs of chip_smoke.SYNTHETIC_EASED's
    problems, chip_smoke.py's NEWTON_* bars: rtol/atol 1e-4 on >= 99% of
    envs, 5% of each env's largest component on all. The env whose line
    search goes non-finite keeps its start, and the first 257 envs, and the
    first one, alone give the bits they give in the whole batch."""
    from chip_smoke import SYNTHETIC_EASED, nonfinite_line_search, synthetic_structured_problem

    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    B = 4096
    st, pa, bJ, dsc = synthetic_structured_problem(B, seed=70 + nv, device=cuda, nv=nv, **SYNTHETIC_EASED)
    if nv >= 12:
        nonfinite_line_search(st, pa, bJ, 5)
    kw = dict(iterations=5, ls_iterations=8, use_ws=use_ws)

    def kern(b):
        x = {k: v[:b].contiguous() if torch.is_tensor(v) and v.shape[0] == B else v for k, v in pa.items()}
        return newton_solve_structured(x["J"], bJ[:b].contiguous(), dsc[:b].contiguous(), x["qM"], x["aref"], x["D"],
                                       x["fl"], x["act"], x["a_s"], x["ws"], x["tol"], st=st, **kw)

    got, want = kern(B), _newton_arrays(**pa, **kw)
    within = torch.ones(B, dtype=torch.bool, device=cuda)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        err = (g - w).abs()
        within &= (err <= NEWTON_TOL + NEWTON_TOL * w.abs()).all(1)
        assert (err.amax(1) <= 0.05 * (w.abs().amax(1) + NEWTON_TOL)).all()
    assert within.float().mean().item() >= 0.99
    if nv >= 12:
        starts = (pa["a_s"][5], pa["ws"][5]) if use_ws else (pa["a_s"][5],)
        assert torch.equal(got[0][5], want[0][5]) and any(torch.equal(got[0][5], x) for x in starts)
    for b in (257, 1):
        assert all(torch.equal(x, y[:b]) for x, y in zip(kern(b), got))


def test_redesigned_kernels_do_not_spill(cuda):
    """ptxas reports no spill for kernels 1-3 (n <= 32) and kernels 4-6,
    which hold a row of a system in registers (chip_smoke.SPILL_FREE; each
    copy's instantiation of kernels 2 and 3, every register tier of
    kernels 5 and 6)."""
    from chip_smoke import SPILL_FREE

    from ambersim_tpu_torch.ops import _build

    path, _ = _build.build()
    name, seen = None, set()
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line
        if "spill" in line and name and any(k in name for k in SPILL_FREE):
            seen.update(k for k in SPILL_FREE if k in name)
            assert "0 bytes spill stores, 0 bytes spill loads" in line, (name, line)
    assert seen == set(SPILL_FREE)


def test_structured_kernel_fits_4096_envs_in_two_waves(cuda):
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.ops.newton import structured_occupancy

    m = load_model("quadruped", device=cuda)
    envs = structured_occupancy(m.skel.nv, m.skel.nefc, _pyramid_structure(m.skel))
    assert 2 * torch.cuda.get_device_properties(cuda).multi_processor_count * envs >= 4096


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
    want = {k: 0 for k in LAUNCHES}
    want.update(cholesky=7, cho_solve=7, solve_pd=7, newton_structured=7)
    assert dict(LAUNCHES) == want


def _within_newton_bars(got, want):
    """chip_smoke.py's NEWTON_* bars: rtol/atol 1e-4 on >= 99% of envs, 5% of
    each env's largest component on all."""
    within = torch.ones(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        err = (g - w).abs()
        within &= (err <= NEWTON_TOL + NEWTON_TOL * w.abs()).all(1)
        assert (err.amax(1) <= 0.05 * (w.abs().amax(1) + NEWTON_TOL)).all()
    assert within.float().mean().item() >= 0.99


@pytest.mark.parametrize("nv", (1, 7, 25, 32))
def test_dense_newton_kernel_matches_plain(cuda, nv):
    """Kernel 5 on equality, Huber friction and one-sided rows."""
    from chip_smoke import synthetic_dense_problem

    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_dense

    pa = synthetic_dense_problem(257, nv, seed=50 + nv, device=cuda)
    kw = dict(iterations=5, ls_iterations=8, use_ws=True)
    want = _newton_arrays(**pa, **kw)
    got = newton_solve_dense(pa["J"], pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"], pa["ws"],
                             pa["tol"], ne=pa["ne"], nf=pa["nf"], **kw)
    _within_newton_bars(got, want)


@pytest.mark.parametrize("nh, cdim", [(0, 3), (9, 3), (0, 6), (9, 6)])
def test_elliptic_newton_kernel_matches_plain(cuda, nh, cdim):
    """Kernel 6 converged (15 x 15): at least 99% of envs within 1e-2 of
    their largest component and all within 5%, and its total cost not above
    the plain version's by more than 1e-5 of max(|cost|, 1) on any env
    (chip_smoke.py's ELLIPTIC_* bars)."""
    from chip_smoke import synthetic_elliptic_problem

    from ambersim_tpu_torch.engine.solver import _newton_arrays_elliptic, cone_params, elliptic_total_cost
    from ambersim_tpu_torch.ops.newton import newton_solve_elliptic

    sp = synthetic_elliptic_problem(257, nv=12, nh=nh, S=6, cdim=cdim, seed=60 + nh + cdim, device=cuda)
    statics = {k: sp[k] for k in ("ne", "nf", "base", "ncon", "cdim")}
    kw = dict(statics, iterations=15, ls_iterations=15, use_ws=True)
    want = _newton_arrays_elliptic(*(sp[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol", "fr",
                                                    "impratio")), **kw)
    got = newton_solve_elliptic(*(sp[k] for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol", "fr",
                                                 "impratio")), **kw)
    rel = torch.zeros(257, dtype=torch.float32, device=cuda)
    for g, w in zip(got, want):
        rel = torch.maximum(rel, (g - w).abs().amax(1) / (w.abs().amax(1) + 1.0))
    assert (rel <= 1e-2).float().mean().item() >= 0.99 and rel.max().item() <= 0.05, rel.max().item()
    mu, scale = cone_params(sp["fr"].double(), sp["impratio"], cdim)

    def cost(q):
        q = q.double()
        jar = (sp["J"].double() * q[:, None, :]).sum(-1) - sp["aref"].double()
        return elliptic_total_cost(q, jar, sp["qM"].double(), sp["a_s"].double(), sp["D"].double(),
                                   sp["fl"].double(), sp["act"].double(), mu, scale, ne=statics["ne"],
                                   nf=statics["nf"], nh=nh, S=statics["ncon"], cdim=cdim)

    c_got, c_want = cost(got[0]), cost(want[0])
    excess = (c_got - c_want) / c_want.abs().clamp(min=1.0)
    assert (excess <= 1e-5).all(), (excess.max().item(), c_want[excess.argmax()].item())


# the edges of kernels 5 and 6's register tiers (8, 16 and 32 floats a lane)
TIER_NVS = (1, 8, 9, 16, 17, 25, 32)


def _dense(p, **kw):
    from ambersim_tpu_torch.ops.newton import newton_solve_dense

    return newton_solve_dense(p["J"], p["qM"], p["aref"], p["D"], p["fl"], p["act"], p["a_s"], p["ws"], p["tol"],
                              ne=p["ne"], nf=p["nf"], **kw)


@pytest.mark.parametrize("nv", TIER_NVS)
@pytest.mark.parametrize("use_ws", (True, False))
def test_dense_newton_kernel_register_tiers(cuda, nv, use_ws):
    """Kernel 5 at its register tiers' edges on equality, Huber and one-sided
    rows (4096 envs of chip_smoke.SYNTHETIC_EASED's problems): the NEWTON_*
    bars against plain float32; the env whose line search goes non-finite
    keeps its start; the first 257 envs, and the first one, alone give the
    bits they give in the batch."""
    from chip_smoke import SYNTHETIC_EASED, first_envs, kept_start, nonfinite_row_line_search, synthetic_dense_problem

    from ambersim_tpu_torch.engine.solver import _newton_arrays

    pa = synthetic_dense_problem(4096, nv, seed=110 + nv, device=cuda, **SYNTHETIC_EASED)
    nonfinite_row_line_search(pa, 5, pa["ne"])
    kw = dict(iterations=5, ls_iterations=8, use_ws=use_ws)
    got, want = _dense(pa, **kw), _newton_arrays(**pa, **kw)
    _within_newton_bars(got, want)
    assert kept_start(got, want, pa, 5, use_ws)
    for b in (257, 1):
        assert all(torch.equal(x, y[:b]) for x, y in zip(_dense(first_envs(pa, b), **kw), got))


@pytest.mark.parametrize("nv", TIER_NVS)
def test_dense_newton_kernel_meets_float64_as_plain_does(cuda, nv):
    """Kernel 5 on synthetic_dense_problem's own problems (80% of rows
    active, D in [1, 10]; 4096 envs), where plain float32 misses float64 on
    more envs than the NEWTON_* bars leave: the kernel's share of envs within
    rtol/atol 1e-4 of float64 is at most chip_smoke.NEWTON_F64_SLACK below
    plain float32's (chip_smoke.vs_float64)."""
    from chip_smoke import as_dtype, synthetic_dense_problem, vs_float64

    from ambersim_tpu_torch.engine.solver import _newton_arrays

    pa = synthetic_dense_problem(4096, nv, seed=130 + nv, device=cuda)
    kw = dict(iterations=5, ls_iterations=8, use_ws=True)
    vs_float64(_dense(pa, **kw), _newton_arrays(**pa, **kw), _newton_arrays(**as_dtype(pa, torch.float64), **kw),
               f"newton_dense nv={nv}")


@pytest.mark.parametrize("nv", TIER_NVS)
def test_elliptic_newton_kernel_register_tiers(cuda, nv):
    """Kernel 6 at its register tiers' edges (nh = 9 head rows, cdim 2-6 by
    nv), with the warmstart on and off. On 4096 envs, where plain float32
    itself misses float64 on more envs than the ELLIPTIC_* bars leave, as
    chip_smoke.vs_float64 holds it: the kernel's share of envs within 1e-4
    of float64's largest component (one line-search step) and within 1e-2
    (converged, 15 x 15) is at most ELLIPTIC_F64_SLACK below plain
    float32's, and converged, at most ELLIPTIC_COST_ENVS envs' cost exceeds
    the larger of plain float32's and float64's by more than
    ELLIPTIC_COST_RTOL of max(|cost|, 1). On 257 envs
    at the model's 3 x 6 the env whose line search goes non-finite keeps its
    start, and the first 37 envs, and the first one, alone give the bits
    they give in the batch."""
    from chip_smoke import (ELLIPTIC_F64_SLACK, as_dtype, env_rel_err, first_envs, kept_start,
                            nonfinite_row_line_search, synthetic_elliptic_problem, vs_float64)

    from ambersim_tpu_torch.engine.solver import _newton_arrays_elliptic, cone_params, elliptic_total_cost
    from ambersim_tpu_torch.ops.newton import newton_solve_elliptic

    cdim = 2 + nv % 5
    statics_keys = ("ne", "nf", "base", "ncon", "cdim")
    arrays = ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol", "fr", "impratio")

    def kern(p, **kw):
        return newton_solve_elliptic(*(p[k] for k in arrays), **{k: p[k] for k in statics_keys}, **kw)

    def cost(p, q):
        p = as_dtype(p, torch.float64)
        mu, scale = cone_params(p["fr"], p["impratio"], cdim)
        q = q.double()
        jar = (p["J"] * q[:, None, :]).sum(-1) - p["aref"]
        return elliptic_total_cost(q, jar, p["qM"], p["a_s"], p["D"], p["fl"], p["act"], mu, scale, ne=p["ne"],
                                   nf=p["nf"], nh=9, S=p["ncon"], cdim=cdim)

    sp = synthetic_elliptic_problem(4096, nv=nv, nh=9, S=6, cdim=cdim, seed=120 + nv, device=cuda)
    for use_ws in (True, False):
        for iterations, ls_iterations, tol in ((3, 1, 1e-4), (15, 15, 1e-2)):
            kw = dict(iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws)
            got, want = kern(sp, **kw), _newton_arrays_elliptic(**sp, **kw)
            exact = _newton_arrays_elliptic(**as_dtype(sp, torch.float64), **kw)
            what = f"newton_elliptic nv={nv} ws={use_ws} ({iterations} x {ls_iterations})"
            vs_float64(got, want, exact, what, within=lambda a, b: env_rel_err(a, b, what)[0] <= tol,
                       costs=tuple(cost(sp, x[0]) for x in (got, want, exact)) if iterations == 15 else None,
                       slack=ELLIPTIC_F64_SLACK)
    sp = synthetic_elliptic_problem(257, nv=nv, nh=9, S=6, cdim=cdim, seed=140 + nv, device=cuda)
    nonfinite_row_line_search(sp, 5, sp["ne"])
    for use_ws in (True, False):
        kw = dict(iterations=3, ls_iterations=6, use_ws=use_ws)
        got = kern(sp, **kw)
        assert kept_start(got, _newton_arrays_elliptic(**sp, **kw), sp, 5, use_ws)
        for b in (37, 1):
            assert all(torch.equal(x, y[:b]) for x, y in zip(kern(first_envs(sp, b), **kw), got))


def test_dense_and_elliptic_kernels_fit_their_paths_in_two_waves(cuda):
    """Kernel 5 holds cartpole's and arm3's 1024 envs, and kernel 6 the
    elliptic quadruped's 4096, in at most two waves of the card's SMs."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine.solver import elliptic_tail
    from ambersim_tpu_torch.ops.newton import dense_occupancy, elliptic_occupancy

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name in ("cartpole", "arm3"):
        s = load_model(name, device=cuda).skel
        assert 2 * sms * dense_occupancy(s.nv, s.nefc) >= 1024, name
    s = load_model("quadruped_elliptic", device=cuda).skel
    cdim, slots, _, _ = elliptic_tail(s)
    assert 2 * sms * elliptic_occupancy(s.nv, s.nefc, len(slots), cdim) >= 4096


def test_elliptic_line_search_step_selects_on_the_card(cuda):
    """Kernel 6's line-search step returns the bracket's midpoint for a
    Newton step that overflows or is NaN (a blend would return NaN)."""
    from ambersim_tpu_torch.ops.newton import elliptic_ls_step

    state = torch.tensor([[0.5, 0.0, 4.0, 1e30, 0.0], [0.5, 0.0, 4.0, -1e30, 0.0],
                          [0.5, 0.0, 4.0, float("nan"), 1.0], [0.5, 0.0, 4.0, -1.0, 1.0]], device=cuda)
    want = [[0.25, 0.0, 0.5], [2.25, 0.5, 4.0], [0.25, 0.0, 0.5], [1.5, 0.5, 4.0]]
    assert elliptic_ls_step(state).cpu().tolist() == want


@pytest.mark.parametrize("name, kernel", [("cartpole", "newton_dense"), ("arm3", "newton_dense"),
                                          ("quadruped_elliptic", "newton_elliptic"), ("humanoid", "newton_structured"),
                                          ("hand", "newton_structured")])
def test_path_launch_counts(cuda, name, kernel):
    """Every step of these models launches kernels 1-3 and its solver kernel once."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    m = load_model(name, device=cuda)
    d = make_data(m, 32)
    reset_launch_counts()
    rollout(m, d, 5)
    torch.cuda.synchronize()
    want = {k: 0 for k in LAUNCHES}
    want.update(cholesky=5, cho_solve=5, solve_pd=5, **{kernel: 5})
    assert dict(LAUNCHES) == want


def test_quadruped_env_launch_counts(cuda):
    """The env's reset runs one forward (kernels 1, 2 and 4) and each control
    step 4 physics steps (kernels 1-4 once each)."""
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv

    env = QuadrupedLocomotionEnv(device=cuda)
    reset_launch_counts()
    s = env.reset(torch.Generator(device=cuda).manual_seed(0), 32)
    for _ in range(2):
        s = env.step(s, torch.zeros(32, 12, device=cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(s.obs).all() and s.obs.shape == (32, 45)
    want = {k: 0 for k in LAUNCHES}
    want.update(cholesky=9, cho_solve=9, solve_pd=8, newton_structured=9)
    assert dict(LAUNCHES) == want


def test_pendulum_training_step_on_the_card(cuda):
    """One PPO training step and one eval of the pendulum on the card."""
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo import train

    reset_launch_counts()
    make_policy, (normalizer, policy_params), metrics = train(
        PendulumSwingupEnv(), device=cuda, num_timesteps=512, num_evals=1, episode_length=50,
        normalize_observations=True, unroll_length=8, num_minibatches=4, num_updates_per_batch=2, num_envs=16,
        num_eval_envs=8, batch_size=16, seed=0,
    )
    torch.cuda.synchronize()
    assert all(np.isfinite(v) for v in metrics.values())
    assert float(normalizer.count) == 512.0 and all(v.is_cuda for v in policy_params.values())
    # 4 unrolls x 8 steps + a 50-step eval, plus the resets' forwards
    assert LAUNCHES["cholesky"] >= 82 and LAUNCHES["cho_solve"] >= 82
    action, _ = make_policy((normalizer, policy_params), deterministic=True)(torch.zeros(4, 3, device=cuda))
    assert action.is_cuda and action.shape == (4, 1)


def test_structured_newton_kernel_on_hand_operands(cuda):
    """Kernel 4 on the hand's pre-solve operands at the predictive-sampling
    workload's options (chip_smoke.hand_model: Newton 1 x 4, contacts
    disabled), the first model path with equality rows: nd_eq = 4 and 192
    inactive contact rows, 100 envs after 20 steps of chip_smoke's closing
    ctrl, against the plain version at the NEWTON_* bars."""
    from chip_smoke import HAND_CLOSING_CTRL, hand_model, hand_start, pre_solve, solver_operands

    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops.newton import newton_solve_structured

    m = hand_model(cuda)
    s = m.skel
    st = _pyramid_structure(s)
    assert (st.nd_eq, st.ncon3) == (4, 48)
    d = make_data(m, 100).replace(qpos=hand_start(m, 100, seed=9, scale=0.5),
                                  ctrl=torch.tensor(HAND_CLOSING_CTRL, device=cuda).expand(100, -1).contiguous())
    d = pre_solve(m, rollout(m, d, 20))
    pa = solver_operands(m, d, seed=6)
    assert (pa["act"][:, :4] == 1).all() and not pa["act"][:, int(min(s.con_efcadr)):].any()
    kw = dict(iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations), use_ws=True)
    got = newton_solve_structured(pa["J"], d.efc_bJ, d.efc_dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"],
                                  pa["a_s"], pa["ws"], pa["tol"], st=st, **kw)
    want = _newton_arrays(**pa, ne=int(s.ne), nf=int(s.nf), **kw)
    _within_newton_bars(got, want)


def test_hand_sampler_launch_counts(cuda):
    """One optimize call of the sampler rolls its samples out as one batch:
    a forward (kernels 1, 2 and 4) and one launch of kernels 1-4 per knot."""
    from chip_smoke import hand_cost, hand_model

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.trajopt import VanillaPredictiveSampler, VanillaPredictiveSamplerParams

    m = hand_model(cuda)
    sampler = VanillaPredictiveSampler(model=m, cost_function=hand_cost(cuda), nsamples=100, stdev=0.3)
    params = VanillaPredictiveSamplerParams(x0=torch.zeros(16, device=cuda), us_guess=torch.zeros(10, 4, device=cuda))
    reset_launch_counts()
    xs, us = sampler.optimize(params)
    torch.cuda.synchronize()
    assert xs.is_cuda and xs.shape == (11, 16) and torch.isfinite(xs).all()
    want = {k: 0 for k in LAUNCHES}
    want.update(cholesky=11, cho_solve=11, solve_pd=10, newton_structured=11)
    assert dict(LAUNCHES) == want


@pytest.mark.parametrize("pair", ["sphere_capsule", "capsule_capsule", "capsule_box"])
def test_capsule_pairs_card_matches_cpu(cuda, pair):
    """The three capsule narrowphases on the card against the CPU on 4096
    seeded random poses, rtol/atol 1e-5 (pos and frame where a capsule-box
    contact's normal is conditioned, |dist + r| >= 3e-3, as
    tests/test_torch_capsule_pairs.py holds them against the JAX package)."""
    from ambersim_tpu_torch.core import math as am
    from ambersim_tpu_torch.engine import collision

    rng = np.random.default_rng(sum(map(ord, pair)))
    P = 4096

    def pose():
        q = torch.as_tensor(rng.standard_normal((P, 4)).astype(np.float32))
        return torch.as_tensor((0.08 * rng.standard_normal((P, 3))).astype(np.float32)), am.quat_to_mat(
            q / q.norm(dim=-1, keepdim=True))

    def size(kind):
        r = rng.uniform(0.01, 0.05, P)
        cols = {"sphere": (r, 0 * r, 0 * r), "capsule": (r, rng.uniform(0.03, 0.15, P), 0 * r),
                "box": tuple(rng.uniform(0.03, 0.12, (3, P)))}[kind]
        return torch.as_tensor(np.stack(cols, -1).astype(np.float32))

    kinds = pair.split("_")
    (xp1, xm1), (xp2, xm2) = pose(), pose()
    args = (xp1, xm1, size(kinds[0]), xp2, xm2, size(kinds[1]))
    fn = getattr(collision, pair)
    want = fn(*args)
    got = [x.cpu() for x in fn(*(a.to(cuda) for a in args))]
    defined = torch.ones(want[0].shape, dtype=torch.bool)
    if pair == "capsule_box":
        defined = (want[0] + args[2][:, :1]).abs() >= 3e-3
    for what, g, w in zip(("dist", "pos", "frame"), got, want):
        keep = torch.ones_like(defined) if what == "dist" else defined
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g[keep], w[keep], rtol=1e-5, atol=1e-5, msg=what)


@pytest.mark.parametrize("pair", ["plane_mesh", "sphere_mesh", "capsule_mesh", "box_mesh", "mesh_mesh",
                                  "plane_cylinder", "plane_ellipsoid"])
def test_mesh_and_round_pairs_card_match_cpu(cuda, pair):
    """The narrowphases this slice added, on the card against the CPU on
    seeded random poses against the rock's hull (4096 pairs; 1024 for
    box-mesh and 16 for mesh-mesh, whose SAT holds 2,232 and 34,596 edge
    axes a pair), rtol/atol 1e-5 as tests/test_torch_mesh_pairs.py holds
    them against the JAX package: dist on every slot, pos and frame on
    every slot but for the SAT pairs (box-mesh, mesh-mesh), there on every
    slot that touches (dist <= 0; over 40% of the box-rock pairs). Hulls
    centimetres apart get their one slot's point from the supporting edges
    or vertices along the separating axis, which tie to float32 rounding:
    another summation order can take another (the same box-rock pairs in
    float64 on a CPU: 12 of 1,024 points moved, all 1.5-19 cm apart, every
    dist alike). Such a slot is past every margin, masked downstream."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.core import math as am
    from ambersim_tpu_torch.engine import collision

    P = {"mesh_mesh": 16, "box_mesh": 1024}.get(pair, 4096)
    rng = np.random.default_rng(sum(map(ord, pair)))
    rock = load_model("rock", device="cpu")
    n = int(rock.skel.mesh_vertnum[0])
    mesh = tuple(x[0].expand((P,) + x.shape[1:]) for x in (
        rock.mesh_vert, (torch.arange(rock.mesh_vert.shape[1]) < n)[None], rock.mesh_face_normal,
        rock.mesh_face_dist, rock.mesh_face_vert, rock.mesh_edge))

    def pose(spread=0.08):
        q = torch.as_tensor(rng.standard_normal((P, 4)).astype(np.float32))
        return (torch.as_tensor((spread * rng.standard_normal((P, 3))).astype(np.float32)),
                am.quat_to_mat(q / q.norm(dim=-1, keepdim=True)))

    def size(lo, hi, cols):
        out = np.zeros((P, 3), np.float32)
        out[:, :cols] = rng.uniform(lo, hi, (P, cols))
        return torch.as_tensor(out)

    zeros = torch.zeros(P, 3)
    first = {"plane_mesh": zeros, "sphere_mesh": size(0.02, 0.08, 1), "capsule_mesh": size(0.01, 0.1, 2),
             "box_mesh": size(0.02, 0.1, 3), "mesh_mesh": zeros, "plane_cylinder": zeros,
             "plane_ellipsoid": zeros}[pair]
    second = {"plane_cylinder": size(0.02, 0.1, 2), "plane_ellipsoid": size(0.02, 0.1, 3)}.get(pair, zeros)
    args = (*pose(), first, *pose(), second)
    if pair.endswith("mesh"):
        args += (mesh, mesh) if pair == "mesh_mesh" else (mesh,)
    fn = getattr(collision, pair)
    want = fn(*args)
    on_card = [tuple(y.to(cuda) for y in a) if isinstance(a, tuple) else a.to(cuda) for a in args]
    got = [x.cpu() for x in fn(*on_card)]
    held = torch.ones_like(want[0], dtype=torch.bool)
    if pair in ("box_mesh", "mesh_mesh"):
        held = want[0] <= 0
        assert held.any(1).float().mean().item() > (0.4 if pair == "box_mesh" else 0.0)
    for what, g, w in zip(("dist", "pos", "frame"), got, want):
        assert torch.isfinite(g).all() and g.shape == w.shape
        keep = torch.ones_like(held) if what == "dist" else held
        torch.testing.assert_close(g[keep], w[keep], rtol=1e-5, atol=1e-5, msg=what)


@pytest.mark.parametrize("name", ["drop_scene", "rock"])
def test_drop_paths_launch_counts(cuda, name):
    """drop_scene and the rock launch kernels 1, 2 and 4 once a step, and no
    kernel 3 (no joint damping)."""
    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    m = load_model(name, device=cuda)
    reset_launch_counts()
    d = rollout(m, make_data(m, 16), 3)
    torch.cuda.synchronize()
    assert torch.isfinite(d.qpos).all()
    want = {k: 0 for k in LAUNCHES}
    want.update(cholesky=3, cho_solve=3, newton_structured=3)
    assert dict(LAUNCHES) == want


def test_bf16_route_card_matches_cpu(cuda):
    """Option.hessian_bf16 on the batched-arrays route (clutter32_rowcap192,
    nv = 192): the Newton solve on the card (kernel 3 inside) against the
    same solve on the CPU (plain versions), on the same operands: the CPU's
    pre-solve of 16 envs of the committed settled state with seeded
    warmstarts (the card's own pre-solve may take other contacts where the
    row cap's candidates tie at this state). Per env max |card - cpu| /
    (max |cpu| + 1) over qacc, efc_force and qfrc_constraint at most 2e-2
    (chip_smoke's CLUTTER_SPREAD_BARS max): the bf16 direction stops the
    solve where it no longer lowers the cost, and float32 rounding moves
    that point (the CPU's float32 solve ends 5.5e-3 from its float64 one in
    the median env, 8.1e-3 at most, on a CPU). The bf16 solve differs from
    the float32 one."""
    from pathlib import Path

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import collision, constraint, linalg, make_data, smooth
    from ambersim_tpu_torch.engine.solver import _newton_arrays

    z = np.load(Path(__file__).resolve().parent.parent / "ambersim_tpu_torch" / "assets"
                / "clutter32_rowcap192_settled.npz")
    ws_noise = 0.1 * np.random.default_rng(8).standard_normal((16, 192)).astype(np.float32)
    m = load_model("clutter32_rowcap192", device="cpu")
    s = m.skel
    d = make_data(m, 16).replace(**{k: torch.as_tensor(z[k]).expand(16, -1).contiguous() for k in ("qpos", "qvel")})
    d = constraint.make_constraint(m, collision.collision(m, smooth.fwd_position_smooth(m, d)))
    d = smooth.fwd_acceleration(m, smooth.fwd_actuation(m, smooth.fwd_velocity(m, d)))
    tol = (m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(), min=1.0)).reshape(1)
    ops = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss, d.efc_active.float(), d.qacc_smooth,
           d.qacc_smooth + torch.as_tensor(ws_noise), tol)
    kw = dict(ne=int(s.ne), nf=int(s.nf), iterations=int(m.opt.iterations), ls_iterations=int(m.opt.ls_iterations),
              use_ws=True, solve=linalg.solve_pd)
    cpu = _newton_arrays(*ops, **kw, hess_bf16=True)
    card, card_f32 = ([x.cpu() for x in _newton_arrays(*(o.to(cuda) for o in ops), **kw, hess_bf16=bf)]
                      for bf in (True, False))
    rel = torch.zeros(16, dtype=torch.float64)
    for g, w in zip(card, cpu):
        assert torch.isfinite(g).all()
        rel = torch.maximum(rel, (g.double() - w.double()).abs().amax(1) / (w.double().abs().amax(1) + 1.0))
    assert rel.max().item() <= 2e-2
    assert not torch.equal(card[0], card_f32[0])


# ---- gradients: each kernel's Function (kernel forward, plain backward) ----

GRAD_TOL = 1e-3  # of the largest |g|: chip_smoke.GRAD_TOL


def _grad_of_linear(call, inputs: dict, wrt, seed: int, **statics):
    """Gradients of a seeded linear functional of call(*inputs)'s outputs
    with respect to the inputs named in `wrt` (None where unused)."""
    leaves = {k: v.detach().clone().requires_grad_(k in wrt) for k, v in inputs.items()}
    outs = call(*leaves.values(), **statics)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(seed)
    loss = sum((torch.as_tensor(rng.standard_normal(o.shape).astype(np.float32), device=o.device) * o).sum()
               for o in outs)
    return dict(zip(wrt, torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)))


def _assert_grads_close(got: dict, want: dict):
    for k, w in want.items():
        assert got[k] is not None and torch.isfinite(got[k]).all(), k
        scale = w.abs().max().item()
        assert (got[k].cpu() - w).abs().max().item() <= GRAD_TOL * scale, k


@pytest.mark.parametrize("n", (5, 18, 64, 192))
@pytest.mark.parametrize("name", ("cholesky", "cho_solve", "solve_pd"))
def test_linalg_function_backward_matches_cpu(cuda, name, n):
    """Kernels 1-3's Functions: one launch forward, and the gradient on the
    card equals the plain version's on the CPU."""
    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    rng = np.random.default_rng(70 + n)
    g = rng.standard_normal((33, n, n)).astype(np.float32)
    a = torch.as_tensor(g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32))
    b = torch.as_tensor(rng.standard_normal((33, n)).astype(np.float32))
    inputs = dict(a=a) if name == "cholesky" else dict(a=linalg.cholesky_unrolled(a), b=b) if name == "cho_solve" \
        else dict(a=a, b=b)
    call = getattr(linalg, f"{name}_kernel")
    plain = getattr(linalg, f"{name}_unrolled")
    reset_launch_counts()
    got = _grad_of_linear(call, {k: v.to(cuda) for k, v in inputs.items()}, tuple(inputs), seed=n)
    torch.cuda.synchronize()
    assert LAUNCHES[name if n <= 32 else f"{name}_block"] == 1
    _assert_grads_close(got, _grad_of_linear(plain, inputs, tuple(inputs), seed=n))


@pytest.mark.parametrize("route", ("structured", "dense", "elliptic"))
def test_newton_function_backward_matches_cpu(cuda, route):
    """Kernels 4-6's Functions on synthetic problems (64 envs): one launch
    forward; the gradient on the card against the plain version's on the
    CPU by chip_smoke.grad_kernels' rule on every input the plain version
    reads (kernel 4's factored operands get none)."""
    from chip_smoke import GRAD_F64_SLACK, GRAD_MIN_SHARE, _grad_share
    from chip_smoke import synthetic_dense_problem, synthetic_elliptic_problem, synthetic_structured_problem

    from ambersim_tpu_torch.engine import solver
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    kw = dict(iterations=5, ls_iterations=8, use_ws=True)
    rows = ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws", "tol")
    if route == "structured":
        st, pa, bJ, dsc = synthetic_structured_problem(64, seed=3, device="cpu", active=0.15, d_range=(0.1, 1.0))
        inputs = dict(J=pa["J"], bJ=bJ, dsc=dsc, **{k: pa[k] for k in rows[1:]})
        call, plain = solver.newton_structured, solver._structured_plain
        kw.update(st=st, ne=pa["ne"], nf=pa["nf"])
        wrt = ("J", "bJ", "qM", "aref", "D", "a_s", "ws")
    elif route == "dense":
        pa = synthetic_dense_problem(64, 7, seed=12, device="cpu", active=0.15, d_range=(0.1, 1.0))
        inputs = {k: pa[k] for k in rows}
        call, plain = solver.newton_dense, solver._newton_arrays
        kw.update(ne=pa["ne"], nf=pa["nf"])
        wrt = ("J", "qM", "aref", "D", "fl", "a_s", "ws")
    else:
        pa = synthetic_elliptic_problem(64, 12, 9, 3, 3, seed=5, device="cpu")
        inputs = dict({k: pa[k] for k in rows}, fr=pa["fr"])
        call, plain = solver.newton_elliptic, solver._elliptic_plain
        kw.update(iterations=15, ls_iterations=15, **{k: pa[k] for k in ("ne", "nf", "base", "ncon", "cdim")})
        wrt = ("J", "qM", "aref", "D", "fl", "a_s", "ws")
    statics = dict(kw, impratio=pa["impratio"]) if route == "elliptic" else kw
    reset_launch_counts()
    card_statics = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in statics.items()}
    got = _grad_of_linear(call, {k: v.to(cuda) for k, v in inputs.items()}, wrt, seed=1, **card_statics)
    torch.cuda.synchronize()
    assert LAUNCHES[f"newton_{route}"] == 1
    want = _grad_of_linear(plain, inputs, wrt, seed=1, **statics)
    if route == "structured":
        assert got.pop("bJ") is None and want.pop("bJ") is None
    # chip_smoke.grad_kernels' rule: 99% of envs within GRAD_TOL, or the
    # card as close to the float64 gradient as plain float32 is
    exact = _grad_of_linear(plain, {k: v.double() for k, v in inputs.items()}, wrt, seed=1,
                            **{k: v.double() if isinstance(v, torch.Tensor) else v for k, v in statics.items()})
    for k, w in want.items():
        assert torch.isfinite(got[k]).all(), k
        _, share = _grad_share(got, {k: w}, 64)
        if share < GRAD_MIN_SHARE:
            _, plain_exact = _grad_share(want, {k: exact[k]}, 64)
            _, card_exact = _grad_share(got, {k: exact[k]}, 64)
            assert card_exact >= plain_exact - GRAD_F64_SLACK, (k, card_exact, plain_exact)


def test_launchers_refuse_requires_grad_and_dispatch_launches_directly(cuda):
    """The launchers raise on a tensor that requires grad; without grad the
    dispatch launches the kernel itself (no Function, no graph)."""
    from ambersim_tpu_torch.engine import linalg
    from ambersim_tpu_torch.ops import linalg as kernels

    a = torch.eye(4, device=cuda).expand(8, 4, 4).contiguous().requires_grad_(True)
    with pytest.raises(ValueError, match="requires_grad"):
        kernels.cholesky_batched(a)
    with torch.no_grad():
        assert linalg.cholesky(a).grad_fn is None
    assert linalg.cholesky(a).grad_fn is not None
    assert linalg.cholesky(a.detach()).grad_fn is None


def test_apg_update_launches_forward_and_recompute(cuda):
    """One APG update on the pendulum: every physics step's kernels launch
    twice (forward and the checkpoint's recompute), the gradient is finite
    and matches the CPU's."""
    from chip_smoke import _per_call_launches

    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from ambersim_tpu_torch.rl import wrappers
    from ambersim_tpu_torch.rl.apg import make_apg_networks
    from ambersim_tpu_torch.rl.apg.train import rollout_loss
    from ambersim_tpu_torch.rl.pendulum import PendulumSwingupEnv
    from ambersim_tpu_torch.rl.ppo.running_statistics import init_state

    grads = {}
    for device in (cuda, "cpu"):
        env = wrappers.wrap_for_training(PendulumSwingupEnv(device=device), 8)
        nets = make_apg_networks(3, 1, hidden_layer_sizes=(16,))
        params = {k: v.to(device).requires_grad_(True)
                  for k, v in nets.policy_network.init(torch.Generator().manual_seed(0)).items()}
        with torch.no_grad():
            state = env.reset(torch.Generator().manual_seed(1), 4)
        if device == cuda:
            _, per_step = _per_call_launches(env.unwrapped.model, cuda)
            reset_launch_counts()
        loss, _, _ = rollout_loss(env, nets, params, init_state(torch.zeros(3, device=device)), state, 8)
        grads[str(device)] = torch.autograd.grad(loss, list(params.values()))
        if device == cuda:
            torch.cuda.synchronize()
            assert {k: n for k, n in LAUNCHES.items() if n} == {k: 2 * 8 * n for k, n in per_step.items() if n}
    for g, w in zip(grads[str(cuda)], grads["cpu"]):
        assert torch.isfinite(g).all()
        assert (g.cpu() - w).abs().max().item() <= GRAD_TOL * w.abs().max().item()


def test_models_compiled_on_the_card_machine_match_the_assets(cuda):
    """The port's compiler on the card's machine, straight onto the card:
    each committed asset's MJCF, with the exporter's options, held against
    its assets/<name>.npz at chip_smoke's bars (compare_compiled)."""
    from chip_smoke import COMPILED_ASSETS, compare_compiled, compile_asset

    for name in COMPILED_ASSETS:
        m = compile_asset(name, cuda)
        assert m.device.type == "cuda"
        compare_compiled(name, m)


def test_gripper_urdf_on_the_card(cuda):
    """The gripper URDF with force_float: kernels 1, 2 and 4 once a step (no
    joint damping, so no kernel 3), its mimic row (nd_eq = 1) closing within
    20 steps toward q2 = 0.1 + 0.5 q1, and 8 envs x 5 steps card vs CPU."""
    from chip_smoke import QPOS_TOL, QVEL_TOL, gripper_model, gripper_start, mimic_residual

    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    m = gripper_model(cuda)
    reset_launch_counts()
    d = rollout(m, gripper_start(m, 64), 20)
    torch.cuda.synchronize()
    assert torch.isfinite(d.qpos).all()
    want = {k: 0 for k in LAUNCHES}
    want.update(cholesky=20, cho_solve=20, newton_structured=20)
    assert dict(LAUNCHES) == want
    assert mimic_residual(m, d).max().item() < 0.1  # 0.1 at the start
    runs = [rollout(mm, gripper_start(mm, 8), 5) for mm in (m, gripper_model("cpu"))]
    assert (runs[0].qpos.cpu() - runs[1].qpos).abs().max().item() <= QPOS_TOL
    assert (runs[0].qvel.cpu() - runs[1].qvel).abs().max().item() <= QVEL_TOL


def test_grasp_scene_on_the_card(cuda):
    """The mesh hand's grasp scene compiled by the port: kernels 1-4 once a
    step, the object in the palm channel, and 8 envs x 20 steps card vs CPU."""
    from chip_smoke import GRASP_Z, QPOS_TOL, QVEL_TOL, grasp_model, grasp_start

    from ambersim_tpu_torch.engine import rollout
    from ambersim_tpu_torch.ops import LAUNCHES, reset_launch_counts

    m = grasp_model(cuda)
    reset_launch_counts()
    d = rollout(m, grasp_start(m, 64), 20)
    torch.cuda.synchronize()
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.efc_force).all()
    want = {k: 0 for k in LAUNCHES}
    want.update(cholesky=20, cho_solve=20, solve_pd=20, newton_structured=20)
    assert dict(LAUNCHES) == want
    z = d.qpos[:, 10]
    assert bool(((z > GRASP_Z[0]) & (z < GRASP_Z[1])).all())
    runs = [rollout(mm, grasp_start(mm, 8), 20) for mm in (m, grasp_model("cpu"))]
    assert (runs[0].qpos.cpu() - runs[1].qpos).abs().max().item() <= QPOS_TOL
    assert (runs[0].qvel.cpu() - runs[1].qvel).abs().max().item() <= QVEL_TOL
