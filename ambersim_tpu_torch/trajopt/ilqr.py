"""iLQR: second-order shooting through the differentiable step (port of
ambersim_tpu/trajopt/ilqr.py).

  * The dynamics' tangent-space Jacobians at all N knots come from one
    batched step and one backward pass: the N knots repeated 2 nv times
    are one batch of N * 2 nv envs, and one-hot cotangents pull row r of
    A_k and B_k out of copy r of knot k (the JAX package's jacrev pulling
    2 nv cotangent rows through one batched step). On the card the step's
    kernels run forward, their Functions' plain versions backward.
  * The cost expansion runs on the user's plain costs (torch.func.jacfwd of
    torch.func.grad, vmapped over knots); the Riccati recursion is a reverse Python
    loop with torch.linalg.solve on (..., nu, nu), as the JAX package uses
    jnp.linalg.solve there.
  * The forward line search evaluates every step size as one batch of envs
    (alpha = 0, the nominal, always among them), so the accepted cost never
    increases; each problem takes its own argmin.
  * States live on the joint manifolds: the local state z in R^{2 nv} is a
    tangent increment applied by `state_add` (engine.integrate.integrate_pos)
    and measured by `state_diff` (the mju_differentiatePos analog), so ball
    and free joints linearize correctly (nq != nv).

`optimize` takes one problem (x0 (nq+nv,), us_guess (N, nu)) or a batch of
P problems (x0 (P, nq+nv), us_guess (P, N, nu)), the JAX package's
vmap(optimize): every stage runs the batch at once, the linearization as one
step of P x N x 2 nv envs and the line search as one rollout of P x
len(alphas) envs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import JointType, Model
from ambersim_tpu_torch.engine import make_data, step
from ambersim_tpu_torch.engine.integrate import integrate_pos
from ambersim_tpu_torch.engine.schedule import device_index, tree_schedule
from ambersim_tpu_torch.trajopt.shooting import ShootingAlgorithm, ShootingParams, shoot


def state_add(m: Model, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Apply tangent increments z (B, 2 nv) to states x = [qpos, qvel]
    (B, nq+nv): qpos advances along the joint manifolds (quaternion exp for
    ball and free joints), qvel adds linearly. Inverse of state_diff to
    first order."""
    nq, nv = m.skel.nq, m.skel.nv
    qpos = integrate_pos(m, x[:, :nq], z[:, :nv], 1.0)
    return torch.cat([qpos, x[:, nq:] + z[:, nv:]], dim=-1)


def state_diff(m: Model, x2: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Tangent differences z (B, 2 nv) with x2 ~ state_add(m, x1, z): the
    mju_differentiatePos analog per joint-type group, plus the qvel
    difference."""
    s = m.skel
    nq, nv = s.nq, s.nv
    q2, q1 = x2[:, :nq], x1[:, :nq]
    dev = x1.device
    cols = [None] * nv  # dof -> (B,) column
    for jtype_int, jids in tree_schedule(s).jnt_by_type.items():
        jtype = JointType(jtype_int)
        qa, da = np.asarray(s.jnt_qposadr)[jids], np.asarray(s.jnt_dofadr)[jids]
        if jtype in (JointType.FREE, JointType.BALL):
            q0 = qa + (3 if jtype == JointType.FREE else 0)
            d0 = da + (3 if jtype == JointType.FREE else 0)
            if jtype == JointType.FREE:
                lin = device_index(qa[:, None] + np.arange(3), dev)
                for j, dofs in enumerate(da[:, None] + np.arange(3)):
                    for c, dof in enumerate(dofs):
                        cols[dof] = q2[:, lin[j, c]] - q1[:, lin[j, c]]
            q4 = device_index(q0[:, None] + np.arange(4), dev)
            rot = am.quat_sub(q2[:, q4], q1[:, q4])  # (B, joints, 3)
            for j, dofs in enumerate(d0[:, None] + np.arange(3)):
                for c, dof in enumerate(dofs):
                    cols[dof] = rot[:, j, c]
        else:
            for a, dof in zip(qa, da):
                cols[dof] = q2[:, a] - q1[:, a]
    return torch.cat([torch.stack(cols, dim=-1), x2[:, nq:] - x1[:, nq:]], dim=-1)


@dataclasses.dataclass
class ILQRParams(ShootingParams):
    """x0 (nq+nv,) and the control tape guess us_guess (N, nu), or a batch
    of problems, x0 (P, nq+nv) and us_guess (P, N, nu)."""


@dataclasses.dataclass
class ILQR(ShootingAlgorithm):
    """Iterative LQR over the engine step.

    Attributes:
      model: the port's Model.
      running_cost: (x (nq+nv,), u (nu,)) -> scalar, x = [qpos, qvel]; plain
        torch, vmapped over knots by torch.func.
      terminal_cost: (x,) -> scalar.
      iterations: outer iLQR iterations.
      alphas: line-search step sizes evaluated as one batch; 0.0 is always
        appended so the accepted cost never increases.
      reg: Levenberg regularization added to Q_uu's diagonal.
    """

    model: Model
    running_cost: Callable
    terminal_cost: Callable
    iterations: int = 10
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.2, 0.05, 0.01)
    reg: float = 1e-6

    def _step_x(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One engine step of packed states x (B, nq+nv) at controls u (B, nu)."""
        m, nq = self.model, self.model.skel.nq
        d = make_data(m, x.shape[0]).replace(qpos=x[:, :nq].contiguous(), qvel=x[:, nq:].contiguous(),
                                             ctrl=u.contiguous())
        d = step(m, d)
        return torch.cat([d.qpos, d.qvel], dim=-1)

    def _clip(self, us: torch.Tensor) -> torch.Tensor:
        m = self.model
        limited = device_index(np.asarray(m.skel.actuator_ctrllimited, bool), us.device)
        inf = torch.full_like(m.actuator_ctrlrange[:, 0], float("inf"))
        lo = torch.where(limited, m.actuator_ctrlrange[:, 0], -inf)
        hi = torch.where(limited, m.actuator_ctrlrange[:, 1], inf)
        return torch.clamp(us, lo, hi)

    def _traj_cost(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """Cost of trajectories xs (..., N+1, nx), us (..., N, nu) -> (...)."""
        *batch, N, nu = us.shape
        run = torch.func.vmap(self.running_cost)(xs[..., :-1, :].reshape(-1, xs.shape[-1]), us.reshape(-1, nu))
        term = torch.func.vmap(self.terminal_cost)(xs[..., -1, :].reshape(-1, xs.shape[-1]))
        return run.reshape(*batch, N).sum(-1) + term.reshape(batch)

    def _linearize(self, xs: torch.Tensor, us: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A_k (..., N, 2nv, 2nv) and B_k (..., N, 2nv, nu) of trajectories xs
        (..., N+1, nx), us (..., N, nu): the Jacobians of f(z, du) =
        diff(step(x_k (+) z, u_k + du), x_{k+1}) at (0, 0), from one step of
        every problem's N knots repeated 2 nv times and one backward pass
        with one-hot cotangents (row r of knot k from copy r)."""
        m = self.model
        *batch, N, nu = us.shape
        R, nx = 2 * m.skel.nv, xs.shape[-1]
        knots = (xs[..., :-1, :].reshape(-1, nx), us.reshape(-1, nu), xs[..., 1:, :].reshape(-1, nx))
        xk, uk, xk1 = (t.repeat_interleave(R, dim=0) for t in knots)
        K = knots[0].shape[0]
        with torch.enable_grad():
            z = xs.new_zeros((K * R, R), requires_grad=True)
            du = xs.new_zeros((K * R, nu), requires_grad=True)
            f = state_diff(m, self._step_x(state_add(m, xk, z), uk + du), xk1)
            onehot = torch.eye(R, dtype=xs.dtype, device=xs.device).repeat(K, 1)
            gz, gu = torch.autograd.grad(f, (z, du), onehot)
        return gz.reshape(*batch, N, R, R), gu.reshape(*batch, N, R, nu)

    def _expand_cost(self, xs: torch.Tensor, us: torch.Tensor):
        """Per-knot tangent-space cost expansion of trajectories xs (..., N+1,
        nx), us (..., N, nu): gradients and Hessians of running_cost(x_k (+)
        z, u_k + du) at (0, 0), vmapped over every problem's knots, plus the
        terminal pair of each problem, each from one forward-over-reverse
        transform in w = (z, du) whose Hessian holds the zz, uu and zu
        blocks."""
        m = self.model
        *batch, N, nu = us.shape
        R, nx = 2 * m.skel.nv, xs.shape[-1]
        fn = torch.func

        def expand(cost):
            def grad_aux(x, u, w):
                g = fn.grad(cost, argnums=2)(x, u, w)
                return g, g

            return fn.vmap(fn.jacfwd(grad_aux, argnums=2, has_aux=True))

        def cw(xk, uk, w):
            return self.running_cost(state_add(m, xk[None], w[None, :R])[0], uk + w[R:])

        def ct(xt, _, z):  # expand's (x, u, w) signature; the terminal cost reads no u
            return self.terminal_cost(state_add(m, xt[None], z[None])[0])

        xk, uk = xs[..., :-1, :].reshape(-1, nx), us.reshape(-1, nu)
        h, g = expand(cw)(xk, uk, xk.new_zeros((xk.shape[0], R + nu)))
        running = (g[:, :R], g[:, R:], h[:, :R, :R], h[:, R:, R:], h[:, :R, R:])
        xt = xs[..., -1, :].reshape(-1, nx)
        ht, gt = expand(ct)(xt, xt, xt.new_zeros((xt.shape[0], R)))
        return (tuple(e.reshape(*batch, N, *e.shape[1:]) for e in running),
                gt.reshape(*batch, R), ht.reshape(*batch, R, R))

    def _backward(self, A, B, expansions, terminal):
        """Riccati recursion, last knot first, over a leading batch of
        problems: feedforward k (..., N, nu) and feedback K (..., N, nu,
        2nv) per knot, with Levenberg regularization on Q_uu."""
        lz, lu, lzz, luu, lzu = expansions
        Vz, Vzz = terminal
        eye_u = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
        N = A.shape[-3]
        ks, Ks = [None] * N, [None] * N

        def mv(a, v):
            return (a @ v[..., None])[..., 0]

        for k in range(N - 1, -1, -1):
            Ak, Bk = A[..., k, :, :], B[..., k, :, :]
            Qz = lz[..., k, :] + mv(Ak.mT, Vz)
            Qu = lu[..., k, :] + mv(Bk.mT, Vz)
            Qzz = lzz[..., k, :, :] + Ak.mT @ Vzz @ Ak
            Quu = luu[..., k, :, :] + Bk.mT @ Vzz @ Bk + self.reg * eye_u
            Qzu = lzu[..., k, :, :] + Ak.mT @ Vzz @ Bk
            kk = -torch.linalg.solve(Quu, Qu[..., None])[..., 0]
            Kk = -torch.linalg.solve(Quu, Qzu.mT)
            Vz = Qz + mv(Kk.mT @ Quu, kk) + mv(Kk.mT, Qu) + mv(Qzu, kk)
            Vzz = Qzz + Kk.mT @ Quu @ Kk + Kk.mT @ Qzu.mT + Qzu @ Kk
            Vzz = 0.5 * (Vzz + Vzz.mT)
            ks[k], Ks[k] = kk, Kk
        return torch.stack(ks, -2), torch.stack(Ks, -3)

    def _forward(self, xs, us, ks, Ks, alphas: torch.Tensor):
        """Closed-loop rollouts of problems xs (P, N+1, nx), us (P, N, nu), one
        env per problem and step size in `alphas` (L,), P x L envs in one
        batch; feedback acts on the tangent deviation from each problem's
        nominal trajectory. Returns xs (P, L, N+1, nx) and us (P, L, N, nu)."""
        m = self.model
        P, L, nx = xs.shape[0], len(alphas), xs.shape[-1]
        x = xs[:, None, 0].expand(P, L, nx).reshape(P * L, nx)
        xs_new, us_new = [x], []
        for k in range(us.shape[1]):
            z = state_diff(m, x, xs[:, None, k].expand(P, L, nx).reshape(P * L, nx)).reshape(P, L, -1)
            u = self._clip(us[:, None, k] + alphas[:, None] * ks[:, None, k] + z @ Ks[:, k].mT).reshape(P * L, -1)
            x = self._step_x(x, u)
            xs_new.append(x)
            us_new.append(u)
        return (torch.stack(xs_new, dim=1).reshape(P, L, -1, nx),
                torch.stack(us_new, dim=1).reshape(P, L, -1, us.shape[-1]))

    @torch.no_grad()
    def optimize(self, params: ILQRParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (xs_star, us_star) of one problem, x0 (nx,) and us_guess
        (N, nu), or of a batch of problems, x0 (P, nx) and us_guess (P, N,
        nu), solved as one batch all the way down: each problem's cost is at
        most that of its rolled-out guess (alpha = 0 keeps its nominal every
        iteration), and each takes its own step size."""
        if params.us_guess.dim() == 2:
            xs, us = self.optimize(params.replace(x0=params.x0[None], us_guess=params.us_guess[None]))
            return xs[0], us[0]
        us = self._clip(params.us_guess)
        xs = shoot(self.model, params.x0, us)
        alphas = torch.tensor(tuple(self.alphas) + (0.0,), dtype=xs.dtype, device=xs.device)
        for _ in range(self.iterations):
            A, B = self._linearize(xs, us)
            running, *terminal = self._expand_cost(xs, us)
            ks, Ks = self._backward(A, B, running, terminal)
            xs_c, us_c = self._forward(xs, us, ks, Ks, alphas)
            best = torch.argmin(self._traj_cost(xs_c, us_c), dim=-1)[:, None, None, None]
            xs = torch.take_along_dim(xs_c, best, dim=1)[:, 0]
            us = torch.take_along_dim(us_c, best, dim=1)[:, 0]
        return xs, us
