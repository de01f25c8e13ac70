"""benchmarks/ladder.py rungs 3b exact and 3d at a small size, against the
JAX package on the CPU, on the first 12 bodies of clutter32.xml lowered
into contact (tools/torch_parity.clutter_small_xml, nv = 72 > 32, so the
Newton solve takes the batched-arrays route on the card):

  * exact clutter: exported with no broadphase cap and no row cap (every
    pair its own slots), 4 numpy-seeded envs x 5 steps through
    ambersim_tpu.engine.rollout and the port's rollout, at
    tests/test_torch_clutter.py's bars (qpos atol 1e-4, qvel atol 3e-3);
    measured on a CPU: max |dqpos| 4.7e-7 and max |dqvel| 1.2e-4 (of
    14 m/s);
  * Option.hessian_bf16 on the first 10 of those bodies (nv = 60): the
    port's `_newton_arrays(..., hess_bf16=True)` against the JAX package's
    vmapped `_newton_arrays_jnp(..., hess_bf16=True)` on the same pre-solve
    operands (the port's, as numpy), qacc, efc_force and qfrc_constraint
    at atol 1e-4 of each field's largest |value| (both round the product's
    operands to bfloat16 and sum in float32, in different orders), over
    BF16_ITERATIONS Newton iterations; measured on a CPU: 2.9e-6 of it. The
    bf16 solve must differ from the float32 one by more than that bar
    (measured: 1.9-3.6e-2 of it, the flag is live), and the loaded model
    with the flag set steps through it.

The bf16 product J_w^T J (J_w = J diag(h)) is not symmetric: its two
operands round to bfloat16 apart. The TPU kernels and the port's factor
read its lower triangle; the JAX package's CPU factor does too up to
n = 64 (engine/linalg.py:36), but past that it is XLA's native Cholesky,
which factors (H + H^T) / 2, a different matrix. Hence nv = 60 for the
parity bar; at nv = 72 the port's solve with (H + H^T) / 2 meets the JAX
package's at that bar and its own (lower-triangle) solve parts from it
by more (measured on a CPU, printed with -s: 2.6e-6 and 9.7e-2 of the
largest |qacc|).
"""

import jax
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

B, STEPS = 4, 5
QPOS_ATOL, QVEL_ATOL = 1e-4, 3e-3
BF16_TOL = 1e-4
# Newton iterations of the bf16 comparison: the JAX package's solve unrolls
# its 60-column factor in every iteration, and its compile grows with them
# (~37 s on a CPU at the model's 6)
BF16_ITERATIONS = 2


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    torch.set_num_threads(1)
    return tp.export_small_clutter(tmp_path_factory.mktemp("clutter_exact"), 0)


@pytest.fixture(scope="module")
def case(models):
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import rollout

    jm, tm = models
    qpos, qvel = tp.free_body_state(jm, B, seed=13)
    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)
    ref = jax.jit(lambda d: jax_rollout(jm, d, STEPS, batched=True))(jd)
    return jm, tm, ref, rollout(tm, tp.torch_batch(tm, jd), STEPS)


@pytest.mark.parametrize("field, atol", [("qpos", QPOS_ATOL), ("qvel", QVEL_ATOL), ("time", 1e-6)])
def test_exact_rollout_state_matches_jax(case, field, atol):
    *_, ref, got = case
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)


def test_exact_rollout_has_every_pair(case):
    """No cap: every candidate has its own slot (ncon = ncand), the contacts'
    geoms are the static pairs', and every env keeps active rows."""
    jm, tm, ref, got = case
    s = tm.skel
    assert s.ncon == s.ncand and len(s.bpg_nsel) == 0
    assert torch.isfinite(got.qpos).all() and (got.efc_active.sum(1) >= 8).all()
    np.testing.assert_array_equal(got.contact.geom1.numpy(), np.broadcast_to(s.con_geom1, (B, s.ncon)))
    np.testing.assert_array_equal(got.contact.geom1.numpy(), np.asarray(ref.contact.geom1))
    np.testing.assert_array_equal(got.contact.geom2.numpy(), np.asarray(ref.contact.geom2))


@pytest.fixture(scope="module")
def bf16_models(tmp_path_factory):
    torch.set_num_threads(1)
    return tp.export_small_clutter(tmp_path_factory.mktemp("clutter_bf16"), 0, nbodies=10)


@pytest.fixture(scope="module")
def operands(bf16_models):
    return _presolve_operands(*bf16_models)


def _presolve_operands(jm, tm):
    """Pre-solve operands of the port (CPU) on 4 seeded states, as numpy."""
    from ambersim_tpu_torch.engine import collision, constraint, make_data, smooth

    qpos, qvel = tp.free_body_state(jm, B, seed=14)
    d = make_data(tm, B).replace(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
    d = constraint.make_constraint(tm, collision.collision(tm, smooth.fwd_position_smooth(tm, d)))
    d = smooth.fwd_acceleration(tm, smooth.fwd_actuation(tm, smooth.fwd_velocity(tm, d)))
    s = tm.skel
    tol = float(tm.opt.tolerance) * s.nv * max(float(tm.body_mass.sum()), 1.0)
    pa = dict(J=d.efc_J, qM=d.qM, aref=d.efc_aref, D=d.efc_D, fl=d.efc_frictionloss, act=d.efc_active.float(),
              a_s=d.qacc_smooth, ws=d.qacc_smooth)
    statics = dict(ne=int(s.ne), nf=int(s.nf), iterations=BF16_ITERATIONS, ls_iterations=int(tm.opt.ls_iterations),
                   use_ws=True)
    return {k: v.numpy() for k, v in pa.items()}, np.float32(tol), statics


def _port(pa, tol, statics, hess_bf16):
    from ambersim_tpu_torch.engine.solver import _newton_arrays

    out = _newton_arrays(**{k: torch.as_tensor(v) for k, v in pa.items()}, tol=torch.tensor(tol), **statics,
                         hess_bf16=hess_bf16)
    return [x.numpy() for x in out]


def test_bf16_newton_matches_jax(operands):
    import jax.numpy as jnp

    from ambersim_tpu.engine.solver import _newton_arrays_jnp

    pa, tol, statics = operands
    assert pa["J"].shape[-1] == 60 and pa["act"].sum(1).min() >= 8
    fn = jax.jit(jax.vmap(lambda J, *a: _newton_arrays_jnp(J, None, None, *a, jnp.asarray(tol), **statics,
                                                           hess_bf16=True)))
    want = [np.asarray(x) for x in fn(*(jnp.asarray(pa[k]) for k in ("J", "qM", "aref", "D", "fl", "act", "a_s",
                                                                      "ws")))]
    got = _port(pa, tol, statics, hess_bf16=True)
    for what, g, w in zip(("qacc", "efc_force", "qfrc_constraint"), got, want):
        assert np.isfinite(g).all(), what
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0.0, atol=BF16_TOL * scale, err_msg=what)


def test_bf16_flag_is_live(operands, bf16_models):
    """The bf16 solve moves qacc by more than the parity bar above, and a
    loaded model with the flag set (nv = 60: accepted) steps through it."""
    from ambersim_tpu_torch.engine import make_data, step

    pa, tol, statics = operands
    q16, q32 = _port(pa, tol, statics, True)[0], _port(pa, tol, statics, False)[0]
    assert np.abs(q16 - q32).max() > BF16_TOL * np.abs(q32).max()
    _, tm = bf16_models
    d = make_data(tm, 2)
    got = [step(m, d).qacc for m in (tm.replace(opt=tm.opt.replace(hessian_bf16=True)), tm)]
    assert torch.isfinite(got[0]).all() and not torch.equal(got[0], got[1])


def test_bf16_past_n64_jax_cpu_factors_the_symmetric_part(models):
    """At nv = 72 the JAX package's CPU route factors (H + H^T) / 2 of the
    bf16 product: the port meets it there only when it does the same."""
    import jax.numpy as jnp

    from ambersim_tpu.engine.solver import _newton_arrays_jnp
    from ambersim_tpu_torch.engine.linalg import solve_pd_unrolled
    from ambersim_tpu_torch.engine.solver import _newton_arrays

    pa, tol, statics = _presolve_operands(*models)
    assert pa["J"].shape[-1] == 72
    fn = jax.jit(jax.vmap(lambda J, *a: _newton_arrays_jnp(J, None, None, *a, jnp.asarray(tol), **statics,
                                                           hess_bf16=True)))
    want = np.asarray(fn(*(jnp.asarray(pa[k]) for k in ("J", "qM", "aref", "D", "fl", "act", "a_s", "ws")))[0])
    args = {k: torch.as_tensor(v) for k, v in pa.items()}

    def sym(H, g):
        return solve_pd_unrolled(0.5 * (H + H.transpose(-1, -2)), g)

    got_sym, got_low = (_newton_arrays(**args, tol=torch.tensor(tol), **statics, hess_bf16=True, **kw)[0].numpy()
                        for kw in (dict(solve=sym), {}))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got_sym, want, rtol=0.0, atol=BF16_TOL * scale)
    print(f"bf16 at nv = 72: port (lower triangle) vs JAX {np.abs(got_low - want).max() / scale:.2e}, "
          f"symmetrized {np.abs(got_sym - want).max() / scale:.2e} of the largest |qacc|")
    assert np.abs(got_low - want).max() > BF16_TOL * scale
