"""iLQR: second-order shooting through the differentiable step (port of
ambersim_tpu/trajopt/ilqr.py).

  * The dynamics' tangent-space Jacobians at all N knots come from one
    batched step and one backward pass: the N knots repeated 2 nv times
    are one batch of N * 2 nv envs, and one-hot cotangents pull row r of
    A_k and B_k out of copy r of knot k (the JAX package's jacrev pulling
    2 nv cotangent rows through one batched step). On the card the step's
    kernels run forward, their Functions' plain versions backward.
  * The cost expansion runs on the user's plain costs (torch.func.grad and
    hessian, vmapped over knots); the Riccati recursion is a reverse Python
    loop with torch.linalg.solve on (nu, nu), as the JAX package uses
    jnp.linalg.solve there.
  * The forward line search evaluates every step size as one batch of envs
    (alpha = 0, the nominal, always among them), so the accepted cost never
    increases.
  * States live on the joint manifolds: the local state z in R^{2 nv} is a
    tangent increment applied by `state_add` (engine.integrate.integrate_pos)
    and measured by `state_diff` (the mju_differentiatePos analog), so ball
    and free joints linearize correctly (nq != nv).

`optimize` takes one problem (x0 (nq+nv,), us_guess (N, nu)); the JAX
package's vmap(optimize) over a batch of problems is not ported.
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
    """x0 (nq+nv,) and the control tape guess us_guess (N, nu)."""


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
        """A_k (N, 2nv, 2nv) and B_k (N, 2nv, nu): the Jacobians of
        f(z, du) = diff(step(x_k (+) z, u_k + du), x_{k+1}) at (0, 0), from one
        step of the N knots repeated 2 nv times and one backward pass with
        one-hot cotangents (row r of knot k from copy r)."""
        m = self.model
        R, (N, nu) = 2 * m.skel.nv, us.shape
        xk, uk, xk1 = (t.repeat_interleave(R, dim=0) for t in (xs[:-1], us, xs[1:]))
        with torch.enable_grad():
            z = xs.new_zeros((N * R, R), requires_grad=True)
            du = xs.new_zeros((N * R, nu), requires_grad=True)
            f = state_diff(m, self._step_x(state_add(m, xk, z), uk + du), xk1)
            onehot = torch.eye(R, dtype=xs.dtype, device=xs.device).repeat(N, 1)
            gz, gu = torch.autograd.grad(f, (z, du), onehot)
        return gz.reshape(N, R, R), gu.reshape(N, R, nu)

    def _expand_cost(self, xs: torch.Tensor, us: torch.Tensor):
        """Per-knot tangent-space cost expansion: gradients and Hessians of
        running_cost(x_k (+) z, u_k + du) at (0, 0), plus the terminal pair."""
        m = self.model
        R = 2 * m.skel.nv

        def cz(xk, uk, z, du):
            return self.running_cost(state_add(m, xk[None], z[None])[0], uk + du)

        z0 = xs.new_zeros((us.shape[0], R))
        du0 = torch.zeros_like(us)
        args = (xs[:-1], us, z0, du0)
        fn = torch.func
        lz = fn.vmap(fn.grad(cz, argnums=2))(*args)
        lu = fn.vmap(fn.grad(cz, argnums=3))(*args)
        lzz = fn.vmap(fn.hessian(cz, argnums=2))(*args)
        luu = fn.vmap(fn.hessian(cz, argnums=3))(*args)
        lzu = fn.vmap(fn.jacfwd(fn.grad(cz, argnums=2), argnums=3))(*args)

        def ct(z):
            return self.terminal_cost(state_add(m, xs[-1:], z[None])[0])

        zt = xs.new_zeros(R)
        return (lz, lu, lzz, luu, lzu), (fn.grad(ct)(zt), fn.hessian(ct)(zt))

    def _backward(self, A, B, expansions, terminal):
        """Riccati recursion, last knot first: feedforward k and feedback K
        per knot, with Levenberg regularization on Q_uu."""
        lz, lu, lzz, luu, lzu = expansions
        Vz, Vzz = terminal
        eye_u = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
        ks, Ks = [None] * len(A), [None] * len(A)
        for k in range(len(A) - 1, -1, -1):
            Ak, Bk = A[k], B[k]
            Qz = lz[k] + Ak.T @ Vz
            Qu = lu[k] + Bk.T @ Vz
            Qzz = lzz[k] + Ak.T @ Vzz @ Ak
            Quu = luu[k] + Bk.T @ Vzz @ Bk + self.reg * eye_u
            Qzu = lzu[k] + Ak.T @ Vzz @ Bk
            kk = -torch.linalg.solve(Quu, Qu)
            Kk = -torch.linalg.solve(Quu, Qzu.T)
            Vz = Qz + Kk.T @ Quu @ kk + Kk.T @ Qu + Qzu @ kk
            Vzz = Qzz + Kk.T @ Quu @ Kk + Kk.T @ Qzu.T + Qzu @ Kk
            Vzz = 0.5 * (Vzz + Vzz.T)
            ks[k], Ks[k] = kk, Kk
        return torch.stack(ks), torch.stack(Ks)

    def _forward(self, xs, us, ks, Ks, alphas: torch.Tensor):
        """Closed-loop rollouts, one env per step size in `alphas` (A,);
        feedback acts on the tangent deviation from the nominal trajectory.
        Returns xs (A, N+1, nx) and us (A, N, nu)."""
        m = self.model
        x = xs[0].expand(len(alphas), -1)
        xs_new, us_new = [x], []
        for k in range(us.shape[0]):
            z = state_diff(m, x, xs[k].expand_as(x))
            u = self._clip(us[k] + alphas[:, None] * ks[k] + z @ Ks[k].T)
            x = self._step_x(x, u)
            xs_new.append(x)
            us_new.append(u)
        return torch.stack(xs_new, dim=1), torch.stack(us_new, dim=1)

    @torch.no_grad()
    def optimize(self, params: ILQRParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (xs_star, us_star); their cost is at most that of the
        rolled-out guess (alpha = 0 keeps the nominal every iteration)."""
        if params.us_guess.dim() != 2:
            raise NotImplementedError("ILQR.optimize takes one problem: x0 (nq+nv,), us_guess (N, nu)")
        us = self._clip(params.us_guess)
        xs = shoot(self.model, params.x0, us)
        alphas = torch.tensor(tuple(self.alphas) + (0.0,), dtype=xs.dtype, device=xs.device)
        for _ in range(self.iterations):
            A, B = self._linearize(xs, us)
            ks, Ks = self._backward(A, B, *self._expand_cost(xs, us))
            xs_c, us_c = self._forward(xs, us, ks, Ks, alphas)
            best = int(torch.argmin(self._traj_cost(xs_c, us_c)))
            xs, us = xs_c[best], us_c[best]
        return xs, us
