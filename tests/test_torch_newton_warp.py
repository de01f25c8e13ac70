"""Kernels 5 and 6's plain versions against the JAX package, CPU.

`engine.solver._newton_arrays` (kernel 5's plain version) against
`_newton_arrays_jnp` (ambersim_tpu/engine/solver.py:424) on
chip_smoke.synthetic_dense_problem, and `_newton_arrays_elliptic` (kernel
6's) against `_newton_arrays_elliptic_jnp` (:624) on
chip_smoke.synthetic_elliptic_problem, built on the CPU at the edges of the
kernels' register tiers (nv 1, 8, 9, 16, 17, 25, 32), with cdim 2-6, head
rows and none, the warmstart on and off, and one env whose line search goes
non-finite (chip_smoke.nonfinite_row_line_search), which must keep its start
in both. chip_smoke.py and tests/test_torch_cuda.py hold the kernels to these
plain versions on the card at those sizes. Also the per-contact Hessian form
kernel 6 assembles, against the JAX package's `_elliptic_W` (:158) on the
elliptic quadruped.

Bars. Dense: 1e-4 of each env's largest |component| + 1, per output
(tests/test_newton_pallas.py:210-215's 1e-4, measured as
tests/test_torch_newton_structured.py does: J^T f cancels terms of ~10).
Elliptic: tests/test_torch_solver.py's, 1e-4 with one line-search step and
1e-2 converged (15 x 15) with total costs within 1e-6: the bracketed line
search is chaotic in float32 in between. With one step, an env that
misses JAX's by more than 1e-4 is held to float64 (the port's plain version
in float64) instead: within twice the larger of 1e-4 and the JAX float32
run's own distance from it. At nv = 32 and cdim 5 float32 rounding alone
moves both runs that far: 1.1e-4 (port) and 1.3e-5 (JAX) from float64 on
one env of 8, 4.2e-4 and 6.9e-4 on another. The Hessian form: 1e-5 of each
env's largest |H| entry (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tools import torch_parity as tp

B, BAD = 8, 3
TIER_NVS = (1, 8, 9, 16, 17, 25, 32)
DENSE_TOL = 1e-4
ENV_TOL, CONVERGED_TOL, COST_RTOL = 1e-4, 1e-2, 1e-6
HESSIAN_RTOL = 1e-5
ARRAYS = ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws")


def _env_rel(got, want) -> np.ndarray:
    """Per-env max |got - want| / (max |want| + 1) over the three outputs."""
    rel = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all() and np.isfinite(w).all()
        rel = np.maximum(rel, np.abs(g - w).max(1) / (np.abs(w).max(1) + 1.0))
    return rel


@pytest.mark.parametrize("nv, use_ws", [(nv, True) for nv in TIER_NVS] + [(17, False)])
def test_plain_dense_newton_matches_jax(nv, use_ws):
    """chip_smoke.check_newton_dense's synthetic problem and settings (5 x 8
    iterations): equality, Huber and one-sided rows, 80% of them active."""
    from ambersim_tpu.engine.solver import _newton_arrays_jnp

    from ambersim_tpu_torch.engine.solver import _newton_arrays

    torch.set_num_threads(1)
    pa = cs.synthetic_dense_problem(B, nv, seed=60 + nv, device="cpu")
    cs.nonfinite_row_line_search(pa, BAD, pa["ne"])
    kw = dict(iterations=5, ls_iterations=8, use_ws=use_ws)
    got = _newton_arrays(**pa, **kw)
    tol = jnp.float32(pa["tol"][0].item())
    want = jax.jit(jax.vmap(lambda J, *a: _newton_arrays_jnp(J, None, None, *a, tol, ne=pa["ne"], nf=pa["nf"], **kw)))(
        *(jnp.asarray(pa[k].numpy()) for k in ARRAYS))
    rel = _env_rel(got, want)
    assert rel.max() <= DENSE_TOL, f"env {rel.argmax()} differs by {rel.max():.3e} of its largest component"
    assert cs.kept_start(got, (torch.from_numpy(np.asarray(want[0])),), pa, BAD, use_ws)  # port and JAX


def _elliptic_args(sp: dict) -> dict:
    return {k: sp[k] for k in ARRAYS + ("fr", "tol", "impratio")}


def _elliptic_jnp(sp: dict, **kw):
    from ambersim_tpu.engine.solver import _newton_arrays_elliptic_jnp

    tol, impratio = jnp.float32(sp["tol"][0].item()), jnp.float32(sp["impratio"].item())
    statics = {k: sp[k] for k in ("ne", "nf", "base", "ncon", "cdim")}
    fn = jax.vmap(lambda J, qM, aref, D, fl, act, a_s, ws, fr: _newton_arrays_elliptic_jnp(
        J, qM, aref, D, fl, act, a_s, ws, tol, fr, impratio, **statics, **kw))
    return [np.asarray(x) for x in jax.jit(fn)(*(jnp.asarray(sp[k].numpy()) for k in ARRAYS + ("fr",)))]


def _elliptic_cost(sp: dict, qacc) -> np.ndarray:
    """Total cost per env at qacc, in float64."""
    from ambersim_tpu_torch.engine.solver import cone_params, elliptic_total_cost

    p = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v for k, v in sp.items()}
    q = torch.as_tensor(np.asarray(qacc)).double()
    mu, scale = cone_params(p["fr"], p["impratio"], p["cdim"])
    jar = (p["J"] * q[:, None, :]).sum(-1) - p["aref"]
    return elliptic_total_cost(q, jar, p["qM"], p["a_s"], p["D"], p["fl"], p["act"], mu, scale, ne=p["ne"],
                               nf=p["nf"], nh=p["base"], S=p["ncon"], cdim=p["cdim"]).numpy()


# (nv, cdim, head rows, warmstart): every tier edge, every cdim, nh 0 and 9
ELLIPTIC_CASES = [(1, 2, 9, True), (8, 3, 0, False), (9, 4, 9, True), (16, 5, 0, True), (17, 6, 9, False),
                  (25, 3, 9, True), (32, 5, 9, True)]


@pytest.mark.parametrize("nv, cdim, nh, use_ws", ELLIPTIC_CASES)
@pytest.mark.parametrize("iterations, ls_iterations", [(3, 1), (15, 15)])
def test_plain_elliptic_newton_matches_jax(nv, cdim, nh, use_ws, iterations, ls_iterations):
    """chip_smoke.check_newton_elliptic's synthetic problem (6 cones, impratio
    2, all three zones) with one line-search step and converged."""
    from ambersim_tpu_torch.engine.solver import _newton_arrays_elliptic

    torch.set_num_threads(1)
    sp = cs.synthetic_elliptic_problem(B, nv=nv, nh=nh, S=6, cdim=cdim, seed=70 + nv + cdim, device="cpu")
    if nh:
        cs.nonfinite_row_line_search(sp, BAD, sp["ne"])
    kw = dict(iterations=iterations, ls_iterations=ls_iterations, use_ws=use_ws)
    statics = {k: sp[k] for k in ("ne", "nf", "base", "ncon", "cdim")}
    got = _newton_arrays_elliptic(**_elliptic_args(sp), **statics, **kw)
    want = _elliptic_jnp(sp, **kw)
    rel = _env_rel(got, want)
    if iterations == 15:
        assert rel.max() <= CONVERGED_TOL, rel
        np.testing.assert_allclose(_elliptic_cost(sp, got[0]), _elliptic_cost(sp, want[0]), rtol=COST_RTOL)
    else:
        exact = [x.numpy() for x in _newton_arrays_elliptic(**_elliptic_args(cs.as_dtype(sp, torch.float64)),
                                                            **statics, **kw)]
        jax_f64, port_f64 = _env_rel(want, exact), _env_rel(got, exact)
        ok = (rel <= ENV_TOL) | (port_f64 <= 2.0 * np.maximum(ENV_TOL, jax_f64))
        assert ok.all(), (rel, jax_f64, port_f64)
    if nh:
        assert cs.kept_start(got, (torch.from_numpy(np.asarray(want[0])),), sp, BAD, use_ws)  # port and JAX


@pytest.fixture(scope="module")
def elliptic_quadruped_state():
    """The elliptic quadruped's pre-solve state from the JAX package: 16
    numpy-seeded envs, half at the main path's start, and jar at
    qacc_smooth + 0.5 N(0, 1), which puts contacts in all three zones."""
    from ambersim_tpu.engine import collision, constraint, smooth

    jm = tp.jax_asset_model("quadruped_elliptic")
    n = 16
    qpos, qvel = tp.random_state(jm, n, seed=41, qpos_scale=0.02)
    qpos[: n // 2] = tp.bench_qpos(jm, n // 2, seed=42)

    def pre_solve(d):
        d = constraint.make_constraint(jm, collision.collision(jm, smooth.fwd_position_smooth(jm, d)))
        return smooth.fwd_acceleration(jm, smooth.fwd_actuation(jm, smooth.fwd_velocity(jm, d)))

    pre = jax.jit(jax.vmap(pre_solve))(tp.jax_batch(jm, qpos=qpos, qvel=qvel))
    noise = 0.5 * np.random.default_rng(43).standard_normal((n, jm.skel.nv)).astype(np.float32)
    qacc = np.asarray(pre.qacc_smooth) + noise
    jar = np.einsum("brv,bv->br", np.asarray(pre.efc_J), qacc) - np.asarray(pre.efc_aref)
    return jm, pre, jar.astype(np.float32)


def test_kernel_6_contact_hessian_matches_jax_elliptic_W(elliptic_quadruped_state):
    """H = M + 1e-8 I + J_h^T diag(h) J_h + sum_s R_s^T W_s R_s with W_s in
    kernel 6's form (csrc/newton_elliptic.cu cone_weight: an inactive
    contact's D zeroed at the load and its W skipped; g_mid v v^T +
    curv (I - yh yh^T)(scale scale^T) on the friction dims in the middle
    zone, diag(D) in the bottom zone), in plain torch, against the same sum
    over the JAX package's `_elliptic_W` blocks, per env."""
    from ambersim_tpu.engine.solver import _elliptic_W

    from ambersim_tpu_torch.engine.solver import _row_costs_pure, cone_params, elliptic_tail

    jm, pre, jar_np = elliptic_quadruped_state
    s = jm.skel
    cdim, slots, nh, full = elliptic_tail(tp.torch_model(jm).skel)
    assert full
    S, n = len(slots), jar_np.shape[0]
    W_jax = np.asarray(jax.jit(jax.vmap(lambda d, jar: _elliptic_W(jm, d, jar)[0][2]))(pre, jnp.asarray(jar_np)))

    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    J, qM, D, fl, act = t(pre.efc_J), t(pre.qM), t(pre.efc_D), t(pre.efc_frictionloss), t(pre.efc_active).float()
    jar = t(jar_np)
    mu, scale = cone_params(t(pre.contact.friction), float(jm.opt.impratio), cdim)
    x = jar[:, nh:].reshape(n, S, cdim)
    on_c = act[:, nh:].reshape(n, S, cdim)[..., 0] > 0.5
    D_c = torch.where(on_c[..., None], D[:, nh:].reshape(n, S, cdim), 0.0)
    Dn, N, y = D_c[..., 0], x[..., 0], x[..., 1:] * scale
    T = torch.sqrt(torch.clamp((y * y).sum(-1), min=1e-24))
    bottom = mu * N <= -T
    middle = ~(bottom | (N >= mu * T))
    cfac = (mu * T - N) / (1.0 + mu * mu)
    g_mid = Dn / (1.0 + mu * mu) * middle
    curv = torch.where(middle, Dn * mu * cfac / T, 0.0)
    yh = y / T[..., None]
    v = torch.cat([-torch.ones_like(mu)[..., None], mu[..., None] * yh * scale], dim=-1)
    W = g_mid[..., None, None] * v[..., :, None] * v[..., None, :]
    eye_f = torch.eye(cdim - 1)
    W[..., 1:, 1:] += curv[..., None, None] * (eye_f - yh[..., :, None] * yh[..., None, :]) * (
        scale[..., :, None] * scale[..., None, :])
    W = W + torch.where(bottom[..., None, None], torch.diag_embed(D_c), 0.0)
    W = torch.where((on_c & (bottom | middle))[..., None, None], W, 0.0)
    assert bool(bottom.any()) and bool(middle.any()) and bool((on_c & ~(bottom | middle)).any())

    _, _, quad = _row_costs_pure(jar[:, :nh], D[:, :nh], fl[:, :nh], act[:, :nh], int(s.ne), int(s.nf))
    J_h, Rc = J[:, :nh], J[:, nh:].reshape(n, S, cdim, -1)
    base = qM + (J_h * torch.where(quad, D[:, :nh], 0.0)[..., None]).transpose(1, 2) @ J_h + 1e-8 * torch.eye(s.nv)
    H = base + torch.einsum("bscv,bscd,bsdw->bvw", Rc, W, Rc)
    H_jax = base + torch.einsum("bscv,bscd,bsdw->bvw", Rc, t(W_jax), Rc)
    scale_H = H_jax.abs().amax((1, 2), keepdim=True)
    assert ((H - H_jax).abs() <= HESSIAN_RTOL * scale_H).all(), ((H - H_jax).abs() / scale_H).max().item()
    assert ((W - t(W_jax)).abs() <= HESSIAN_RTOL * scale_H[..., None]).all()
