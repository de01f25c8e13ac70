"""Fixtures and checks shared by the tests that hold the port's CG solver,
noslip pass, inverse dynamics and support functions against the JAX
package on the CPU: tests/test_torch_cg.py, test_torch_cg_elliptic.py,
test_torch_noslip.py, test_torch_inverse.py and test_torch_support.py.

`quick_jax_model` compiles a fixture with the JAX package's compiler but
without its setconst pass, whose jitted forwards take ~9 s a model on a
CPU; the setconst leaves come from the port's own compiler on the same XML
(engine/setconst.py, within cond(qM) 2^-24 of the JAX package's:
tests/test_torch_mjcf.py). Both packages then run the same Model leaves.
Like tools.torch_parity, this imports both frameworks.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tools import torch_parity as tp
from tools.weld_parity import np_batch

REPO = Path(__file__).resolve().parent.parent
CG = 1  # SolverType.CG in both packages
CONVERGED_CG = dict(solver=CG, iterations=15, ls_iterations=15)
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3  # the repo's rollout bars (tests/test_torch_bridge.py)
_SETCONST = ("dof_invweight0", "body_invweight0", "actuator_acc0", "tendon_invweight0", "tendon_length0")


def compiled(fn, *example):
    """jax.jit(fn) compiled for `example`'s shapes with XLA's expensive LLVM
    passes off: ~30% less compile time (the quadruped's CG step 14.2 ->
    9.8 s), and on that step the same bits."""
    return jax.jit(fn).lower(*example).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})


def quadruped_xml(**option) -> str:
    """The main path's quadruped.xml as text, with `option` attributes added
    to its <option> (e.g. cone="elliptic", noslip_iterations="3")."""
    xml = (REPO / "ambersim_tpu" / "models" / "quadruped" / "quadruped.xml").read_text()
    attrs = "".join(f' {k}="{v}"' for k, v in option.items())
    return xml.replace('<option timestep="0.004"', f'<option timestep="0.004"{attrs}', 1)


def quick_jax_model(xml: str, **opt):
    """The JAX package's Model of `xml`, its setconst leaves from the port's
    compiler, with Option overrides `opt`."""
    from ambersim_tpu.mjcf import compile_spec
    from ambersim_tpu.mjcf.parser import parse_mjcf_string
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.mjcf import compile_spec_arrays
    from ambersim_tpu_torch.mjcf import parse_mjcf_string as port_parse

    jm = compile_spec(parse_mjcf_string(xml))
    leaves = set_constants(*compile_spec_arrays(port_parse(xml)))
    jm = jm.replace(**{f: jnp.asarray(leaves[f]) for f in _SETCONST if f in leaves})
    return tp.with_solver(jm, **opt) if opt else jm


def quadruped_start(jm, seed: int, batch: int = 4):
    """The main path's start (qpos0, joints + 0.05 N(0, 1)) with velocities
    0.1 N(0, 1), drawn by numpy.random.default_rng(seed)."""
    qvel = 0.1 * np.random.default_rng(seed).standard_normal((batch, jm.skel.nv)).astype(np.float32)
    return np_batch(jm, qpos=tp.bench_qpos(jm, batch, seed=seed), qvel=qvel)


def rollout(jm, jd, steps: int, pd: bool, qpos_atol: float = QPOS_ATOL, qvel_atol: float = QVEL_ATOL):
    """`steps` steps of the JAX package's jitted vmapped step and the port's
    step from the same Data (the main path's PD controller when `pd`):
    finite, qpos and qvel within the bars after every step. Returns (port
    Data, JAX Data)."""
    from ambersim_tpu.engine import step as jax_step
    from ambersim_tpu_torch.engine import step

    tm = tp.torch_model(jm)
    jd = jax.tree.map(jnp.asarray, jd)
    if pd:
        jstep = compiled(jax.vmap(lambda d: jax_step(jm, d.replace(ctrl=tp.pd_ctrl_jax(d)))), jd)
    else:
        jstep = compiled(jax.vmap(lambda d: jax_step(jm, d)), jd)
    d = tp.torch_batch(tm, jd)
    for k in range(steps):
        jd = jstep(jd)
        d = step(tm, d.replace(ctrl=tp.pd_ctrl_torch(d)) if pd else d)
        assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
        tp.assert_close(f"qpos after step {k + 1}", d.qpos, jd.qpos, 0.0, qpos_atol)
        tp.assert_close(f"qvel after step {k + 1}", d.qvel, jd.qvel, 0.0, qvel_atol)
    return d, jd


def forward_pair(jm, jd):
    """(port Data, JAX Data): one forward of each package from the same Data."""
    from ambersim_tpu.engine import forward as jax_forward
    from ambersim_tpu_torch.engine.forward import forward

    tm = tp.torch_model(jm)
    jd = jax.tree.map(jnp.asarray, jd)
    return forward(tm, tp.torch_batch(tm, jd)), compiled(jax.vmap(lambda d: jax_forward(jm, d)), jd)(jd)
