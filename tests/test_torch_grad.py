"""Reverse-mode gradients through the PyTorch port's step against the JAX
package's, on the CPU.

  * engine.linalg's two triangular solves read a clone of the vector they
    write, so autograd can pass through them: the same bits as the loop
    before the repair (a copy of it lives here) on seeded inputs, and
    `backward` succeeds;
  * d(sum qpos + sum qvel after T steps)/d(ctrl tape) of the port against
    jax.grad of the JAX package's vmapped step, for pendulum, cartpole,
    arm3 (T = 20), quadruped and hand (T = 10), 4 envs from seeded starts,
    within GRAD_TOL of the largest |g|;
  * `differentiable_dispatch` on the CPU with a plain stand-in for the
    kernel gives the gradients of autograd straight through the plain
    version, for kernels 1-3 (kernel 2 also at (B, k, n)) and for the
    three Newton routes on a step's
    operands (kernel 4's efc_bJ and efc_dsc get None, the gradient reaches
    efc_J), takes no Function without grad, and nests inside
    torch.utils.checkpoint (the stand-in then runs twice: forward and the
    recompute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import torch_parity as tp

GRAD_TOL = 1e-4  # of the largest |g|; the port meets jax.grad to <= 3.5e-5 here


def _solve_lower_loop(l, b):
    """engine.linalg.solve_lower before the repair (its product read y itself)."""
    y = torch.zeros_like(b)
    for j in range(l.shape[-1]):
        acc = (l[..., j, :] * y).sum(-1)
        y[..., j] = (b[..., j] - acc) / l[..., j, j]
    return y


def _solve_upper_t_loop(l, y):
    x = torch.zeros_like(y)
    for j in range(l.shape[-1] - 1, -1, -1):
        acc = (l[..., :, j] * x).sum(-1)
        x[..., j] = (y[..., j] - acc) / l[..., j, j]
    return x


def _spd(rng, B, n):
    g = rng.standard_normal((B, n, n)).astype(np.float32)
    a = torch.as_tensor(g @ np.swapaxes(g, -1, -2) + n * np.eye(n, dtype=np.float32))
    return a, torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32))


@pytest.mark.parametrize("n", (1, 7, 18, 33))
def test_repaired_solves_keep_the_bits_and_differentiate(n):
    from ambersim_tpu_torch.engine import linalg

    a, b = _spd(np.random.default_rng(n), 9, n)
    l = linalg.cholesky_unrolled(a)
    assert torch.equal(linalg.solve_lower(l, b), _solve_lower_loop(l, b))
    assert torch.equal(linalg.solve_upper_t(l, b), _solve_upper_t_loop(l, b))
    a.requires_grad_(True)
    b.requires_grad_(True)
    linalg.solve_pd_unrolled(a, b).sum().backward()
    assert torch.isfinite(a.grad).all() and torch.isfinite(b.grad).all()
    if n > 1:  # the loop before the repair could not be differentiated
        with pytest.raises(RuntimeError, match="inplace"):
            _solve_lower_loop(linalg.cholesky_unrolled(a), b).sum().backward()


def _jax_grad(jm, qpos, qvel, ctrl):
    from ambersim_tpu.engine import step

    jd = tp.jax_batch(jm, qpos=qpos, qvel=qvel)

    def loss(u):
        def body(d, uk):
            return jax.vmap(step, (None, 0))(jm, d.replace(ctrl=uk)), None

        d, _ = jax.lax.scan(body, jd, u)
        return d.qpos.sum() + d.qvel.sum()

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(ctrl)))


@pytest.mark.parametrize("name, T", [("pendulum", 20), ("cartpole", 20), ("arm3", 20), ("quadruped", 10),
                                     ("hand", 10)])
def test_step_gradient_matches_jax(name, T):
    from ambersim_tpu_torch.engine import make_data, step

    jm = tp.jax_asset_model(name)
    tm = tp.torch_model(jm)
    s, B = jm.skel, 4
    rng = np.random.default_rng(0)
    if name == "quadruped":
        qpos = tp.bench_qpos(jm, B, 0)
    else:
        qpos = np.asarray(jm.qpos0, np.float32) + 0.1 * rng.standard_normal((B, s.nq)).astype(np.float32)
    qvel = 0.1 * rng.standard_normal((B, s.nv)).astype(np.float32)
    ctrl = 0.3 * rng.standard_normal((T, B, s.nu)).astype(np.float32)
    want = _jax_grad(jm, qpos, qvel, ctrl)

    u = torch.tensor(ctrl, requires_grad=True)
    d = make_data(tm, B).replace(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    for k in range(T):
        d = step(tm, d.replace(ctrl=u[k]))
    (d.qpos.sum() + d.qvel.sum()).backward()
    got = u.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= GRAD_TOL * scale, np.abs(got - want).max() / scale


def _grads(fn, inputs: dict, wrt, seed: int, **statics):
    leaves = {k: v.detach().clone().requires_grad_(k in wrt) for k, v in inputs.items()}
    outs = fn(*leaves.values(), **statics)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(seed)
    loss = sum((torch.as_tensor(rng.standard_normal(o.shape).astype(np.float32)) * o).sum() for o in outs)
    return dict(zip(wrt, torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)))


def _counting(fn, calls: list):
    def kernel(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    return kernel


@pytest.mark.parametrize("name", ("cholesky", "cho_solve", "solve_pd", "cho_solve_rhs"))
def test_dispatch_gives_the_plain_gradient(name):
    """Kernels 1-3's Functions, kernel 2 also with k = 5 right-hand sides
    per factor ((B, k, n), the noslip pass's M^-1 J^T operand)."""
    from ambersim_tpu_torch.engine import linalg

    a, b = _spd(np.random.default_rng(5), 6, 11)
    rhs = torch.as_tensor(np.random.default_rng(6).standard_normal((6, 5, 11)).astype(np.float32))
    inputs = {"cholesky": dict(a=a), "cho_solve": dict(l=linalg.cholesky_unrolled(a), b=b),
              "cho_solve_rhs": dict(l=linalg.cholesky_unrolled(a), b=rhs), "solve_pd": dict(a=a, b=b)}[name]
    plain = getattr(linalg, f"{name.removesuffix('_rhs')}_unrolled")
    calls = []
    call = linalg.differentiable_dispatch(_counting(plain, calls), plain)
    got = _grads(call, inputs, tuple(inputs), seed=1)
    want = _grads(plain, inputs, tuple(inputs), seed=1)
    assert len(calls) == 1
    for k in inputs:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # without grad the call is the kernel itself: no Function, no graph
    with torch.no_grad():
        assert call(*(v.requires_grad_(True) for v in inputs.values())).grad_fn is None
    assert call(*(v.detach() for v in inputs.values())).grad_fn is None


def _step_operands(name: str, B: int = 6):
    """The Newton operands of a CPU pre-solve of asset `name`, from a state
    perturbed around qpos0 so contacts and limits are active."""
    from ambersim_tpu_torch.engine import collision, constraint, make_data, smooth

    jm = tp.jax_asset_model(name)
    m = tp.torch_model(jm)
    qpos = tp.bench_qpos(jm, B, 1) if name.startswith("quadruped") else tp.arm3_contact_qpos(jm, B, 1)
    d = make_data(m, B).replace(qpos=torch.as_tensor(qpos))
    d = constraint.make_constraint(m, collision.collision(m, smooth.fwd_position_smooth(m, d)))
    d = smooth.fwd_acceleration(m, smooth.fwd_actuation(m, smooth.fwd_velocity(m, d)))
    s = m.skel
    tol = (m.opt.tolerance * s.nv * torch.clamp(m.body_mass.sum(), min=1.0)).reshape(1)
    rows = dict(J=d.efc_J, qM=d.qM, aref=d.efc_aref, D=d.efc_D, fl=d.efc_frictionloss, act=d.efc_active.float(),
                a_s=d.qacc_smooth, ws=d.qacc_smooth + 0.1, tol=tol)
    statics = dict(ne=int(s.ne), nf=int(s.nf), iterations=int(m.opt.iterations),
                   ls_iterations=int(m.opt.ls_iterations), use_ws=True)
    return m, d, rows, statics


@pytest.mark.parametrize("route", ("structured", "dense", "elliptic"))
def test_newton_dispatch_gives_the_plain_gradient(route):
    """The Newton routes' Functions, a plain stand-in as the kernel: the
    gradient equals autograd through the plain version on every input it
    reads; kernel 4's factored operands (built from J's rows) get None."""
    from ambersim_tpu_torch.engine import solver
    from ambersim_tpu_torch.engine.constraint import _pyramid_structure
    from ambersim_tpu_torch.engine.linalg import differentiable_dispatch

    name = {"structured": "quadruped", "dense": "arm3", "elliptic": "quadruped_elliptic"}[route]
    m, d, rows, statics = _step_operands(name)
    wrt = ("J", "qM", "aref", "D", "fl", "a_s", "ws")
    if route == "structured":
        inputs = dict(J=rows["J"], bJ=d.efc_bJ, dsc=d.efc_dsc, **{k: v for k, v in rows.items() if k != "J"})
        plain = solver._structured_plain
        statics["st"] = _pyramid_structure(m.skel)
        wrt = wrt + ("bJ", "dsc")
    elif route == "dense":
        inputs, plain = rows, solver._newton_arrays
    else:
        cdim, slots, base, _ = solver.elliptic_tail(m.skel)
        inputs, plain = dict(rows, fr=d.contact.friction), solver._elliptic_plain
        statics.update(impratio=m.opt.impratio, base=base, ncon=len(slots), cdim=cdim)
    assert float(rows["act"].sum()) > 0
    calls = []
    got = _grads(differentiable_dispatch(_counting(plain, calls), plain), inputs, wrt, seed=2, **statics)
    want = _grads(plain, inputs, wrt, seed=2, **statics)
    assert len(calls) == 1
    if route == "structured":
        assert got.pop("bJ") is None and got.pop("dsc") is None
        want.pop("bJ"), want.pop("dsc")
        assert got["J"].abs().max() > 0
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=0, atol=0)


def test_dispatch_nests_in_checkpoint():
    """Inside torch.utils.checkpoint (APG's rematerialized step) the
    Function's forward runs twice (the recompute), its backward nests an
    autograd.grad in the checkpoint's backward, and the gradient is that
    of autograd straight through the plain version."""
    from torch.utils.checkpoint import checkpoint

    from ambersim_tpu_torch.engine import linalg

    a, b = _spd(np.random.default_rng(7), 5, 9)
    calls = []
    call = linalg.differentiable_dispatch(_counting(linalg.solve_pd_unrolled, calls), linalg.solve_pd_unrolled)
    got, want = [], []
    for fn, out in ((lambda a, b: checkpoint(lambda x, y: call(x * 2.0, y).sin(), a, b, use_reentrant=False), got),
                    (lambda a, b: linalg.solve_pd_unrolled(a * 2.0, b).sin(), want)):
        aa, bb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out.extend(torch.autograd.grad(fn(aa, bb).sum(), (aa, bb)))
    assert len(calls) == 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
