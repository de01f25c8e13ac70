"""Kernel 4's plain version on the eased synthetic structured problems
(chip_smoke.SYNTHETIC_EASED) that chip_smoke.py holds the kernel to on the
card against plain float32: every row family (equality,
dof and tendon friction, one-hot and dense limits, condim-3 contacts) at one
to 32 dofs, against the JAX package's `_newton_arrays_jnp`
(ambersim_tpu/engine/solver.py:424, the path its Pallas kernel is held to
in tests/test_newton_pallas.py), CPU.

Bar: 1e-4 (tests/test_newton_pallas.py:210-215) of each env's largest
|component| + 1, per output (chip_smoke.env_rel_err's measure): elementwise
it cannot hold on J^T f, a sum over ~30 rows with forces up to ~50 that
cancels to near 0 in some dofs, where float32 summation order alone moves
it by ~1e-4. The env that nonfinite_line_search builds must keep its start
in both: its Newton direction overflows float32, and the line search
selects t = 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs

TOL = 1e-4
B, BAD = 8, 3
KW = dict(iterations=3, ls_iterations=4)


def _problem(nv: int):
    st, pa, bJ, dsc = cs.synthetic_structured_problem(B, seed=40 + nv, device="cpu", nv=nv, **cs.SYNTHETIC_EASED)
    if nv >= 12:
        cs.nonfinite_line_search(st, pa, bJ, BAD)
    return st, pa, bJ, dsc


@pytest.mark.parametrize("nv, use_ws", [(1, True), (7, True), (18, True), (18, False), (25, True), (32, True)])
def test_plain_structured_newton_matches_jax(nv, use_ws):
    from ambersim_tpu.engine.solver import _newton_arrays_jnp

    from ambersim_tpu_torch.engine.solver import _newton_arrays

    torch.set_num_threads(1)
    st, pa, bJ, dsc = _problem(nv)
    kw = dict(KW, use_ws=use_ws)
    got = _newton_arrays(**pa, **kw)
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    tol = j(pa["tol"])[0]
    want = jax.jit(jax.vmap(lambda *a: _newton_arrays_jnp(*a, tol, ne=pa["ne"], nf=pa["nf"], **kw)))(
        *(j(x) for x in (pa["J"], bJ, dsc, pa["qM"], pa["aref"], pa["D"], pa["fl"], pa["act"], pa["a_s"], pa["ws"])))
    for name, g, w in zip(("qacc", "efc_force", "qfrc_constraint"), got, want):
        g, w = g.double().numpy(), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), name
        rel = np.abs(g - w).max(1) / (np.abs(w).max(1) + 1.0)
        assert rel.max() <= TOL, f"{name}: env {rel.argmax()} differs by {rel.max():.3e} of its largest component"
    if nv >= 12:
        starts = [pa["a_s"][BAD]] + ([pa["ws"][BAD]] if use_ws else [])
        assert any(torch.equal(got[0][BAD], x) for x in starts)
        assert np.array_equal(np.asarray(want[0][BAD]), got[0][BAD].numpy())


@pytest.mark.parametrize("nv", cs.NEWTON_NVS)
def test_synthetic_structured_problems_fit_kernel_4(nv):
    """The layouts chip_smoke.py sends to kernel 4: one lane per dof, rows
    that factor (nefc = dense + one-hot + 4 per contact), every family."""
    st, pa, bJ, dsc = _problem(nv)
    nefc = pa["J"].shape[1]
    assert pa["J"].shape == (B, nefc, nv) and bJ.shape == (B, 3 * st.ncon3, nv) and dsc.shape == (B, st.ndiag)
    assert nefc == st.nd + st.ndiag + 4 * st.ncon3 and st.ncon3 >= 1
    assert st.nd_eq == 2 and st.nd_ft == 2 and st.nfd >= 1 and st.ndiag > st.nfd
    assert (st.ncon3 > 32) == (nv == 32)  # the widest also walks contacts past one warp's lanes
    # the basis rebuilds J's contact rows: N +- U1, N +- U2
    N, U1, U2 = bJ[:, : st.ncon3], bJ[:, st.ncon3 : 2 * st.ncon3], bJ[:, 2 * st.ncon3 :]
    for q, row in enumerate((N + U1, N - U1, N + U2, N - U2)):
        want = row.clone()
        if nv >= 12:
            want[BAD, :, nv - 1] = 0.0
        assert torch.equal(pa["J"][:, st.adr3 + q], want)
