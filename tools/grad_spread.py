"""How well defined the quadruped's CG gradient is, in the port and in the
JAX package, on the CPU.

For the quadruped under CG at given solver iterations x line-search
steps: d(sum qpos + sum qvel after T steps)/d(ctrl tape, initial qvel) as
chip_smoke.grad_path takes it (the main path's start,
tools/torch_parity.bench_qpos seed 0, which is chip_smoke.initial_batch;
qvel 0; a 0.3 N(0, 1) ctrl tape from numpy.random.default_rng(42)), from
one model (tools/solver_parity.quick_jax_model and its port,
torch_parity.torch_model), in both packages (the JAX package's jax.grad
of its vmapped step under jit, the port's autograd), each in float32 and
float64. Prints, as a share of each input's largest |g| (the largest over
envs): each package's float32 against its float64, the port's float64
against the JAX package's, the port's float32 against the JAX package's,
and each package's float64 gradient against itself with qvel0 moved by
1e-9 ("nudge"). Where a package's own nudge is large, its gradient is not
defined by its inputs, and the two packages can meet no nearer than that.
chip_smoke.GRAD_TOL holds the card against the CPU only where these are
well under it.

    python3 tools/grad_spread.py --opts 1x4 3x2 15x15 [--envs 16 --steps 3]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NUDGE = 1e-9


def _setup(its: int, ls: int, envs: int, steps: int):
    """(JAX model, start qpos (envs, nq), ctrl tape (steps, envs, nu)) in float32."""
    import numpy as np

    from tools import solver_parity as sp
    from tools import torch_parity as tp

    jm = sp.quick_jax_model(sp.quadruped_xml(), solver=sp.CG, iterations=its, ls_iterations=ls)
    u = 0.3 * np.random.default_rng(42).standard_normal((steps, envs, jm.skel.nu))
    return jm, tp.bench_qpos(jm, envs, seed=0), u.astype(np.float32)


def jax_grads(jm, qpos, u, dtype, nudge: float = 0.0):
    """The JAX package's (d/d ctrl (envs, steps, nu), d/d qvel0) in float64 numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ambersim_tpu.engine import make_data, step

    def cast(tree):
        return jax.tree.map(lambda x: x.astype(dtype) if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
                            else x, tree)

    m = cast(jm)

    def loss(u, q0, v0):
        def one(uu, q, v):
            d, _ = jax.lax.scan(lambda d, uk: (step(m, d.replace(ctrl=uk)), None),
                                cast(make_data(m)).replace(qpos=q, qvel=v), uu)
            return d.qpos.sum() + d.qvel.sum()

        return jax.vmap(one)(jnp.swapaxes(u, 0, 1), q0, v0).sum()

    v0 = jnp.zeros((qpos.shape[0], jm.skel.nv), dtype) + nudge
    gu, gv = jax.jit(jax.grad(loss, argnums=(0, 2)))(jnp.asarray(u, dtype), jnp.asarray(qpos, dtype), v0)
    return np.swapaxes(np.asarray(gu, np.float64), 0, 1), np.asarray(gv, np.float64)


def port_grads(jm, qpos, u, dtype, nudge: float = 0.0):
    """The port's (d/d ctrl (envs, steps, nu), d/d qvel0) in float64 numpy."""
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch.engine import make_data, step
    from tools import torch_parity as tp

    m = tp.torch_model(jm)
    d = make_data(m, qpos.shape[0])
    if dtype == torch.float64:
        m, d = cs.float64_copy(m), cs.float64_copy(d)
    uu = torch.tensor(u, dtype=dtype, requires_grad=True)
    v0 = (torch.zeros(qpos.shape[0], m.skel.nv, dtype=dtype) + nudge).requires_grad_(True)
    d = d.replace(qpos=torch.tensor(qpos, dtype=dtype), qvel=v0)
    for k in range(u.shape[0]):
        d = step(m, d.replace(ctrl=uu[k]))
    gu, gv = torch.autograd.grad(d.qpos.sum() + d.qvel.sum(), (uu, v0))
    return gu.transpose(0, 1).double().numpy(), gv.double().numpy()


def share(got, want) -> float:
    """The largest |got - want| over each input's largest |want|, the larger of the two inputs."""
    import numpy as np

    return max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))


def spread(its: int, ls: int, envs: int, steps: int) -> dict:
    import jax.numpy as jnp
    import torch

    jm, qpos, u = _setup(its, ls, envs, steps)
    j32, j64 = jax_grads(jm, qpos, u, jnp.float32), jax_grads(jm, qpos, u, jnp.float64)
    p32, p64 = port_grads(jm, qpos, u, torch.float32), port_grads(jm, qpos, u, torch.float64)
    j64n, p64n = jax_grads(jm, qpos, u, jnp.float64, NUDGE), port_grads(jm, qpos, u, torch.float64, NUDGE)
    return {"jax f32 ~ f64": share(j32, j64), "port f32 ~ f64": share(p32, p64), "port f64 ~ jax f64": share(p64, j64),
            "port f32 ~ jax f32": share(p32, j32), "jax f64 nudge": share(j64n, j64),
            "port f64 nudge": share(p64n, p64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--opts", nargs="+", default=["3x2", "15x15"], help="iterations x line-search steps")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--envs", type=int, default=16)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    torch.set_num_threads(4)
    for opt in args.opts:
        its, ls = (int(v) for v in opt.split("x"))
        got = spread(its, ls, args.envs, args.steps)
        print(f"grad_spread quadruped_cg {its} x {ls}, {args.envs} envs x {args.steps} steps, of the largest |g|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in got.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
