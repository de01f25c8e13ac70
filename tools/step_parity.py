"""Fixtures, bars and checks shared by the tests that hold the port's
contacts of condim 4 and 6, its elliptic solve over mixed condims and its
RK4, implicit and implicitfast integrators against the JAX package on the
CPU: tests/test_torch_condim.py, test_torch_elliptic_mixed.py and
test_torch_integrators.py.

Each fixture is an XML string (the JAX package's tests' constants read as
text with chip_smoke.tests_xml, or chip_smoke's quadruped variants);
`case` compiles both packages' models and the JAX package's jitted vmapped
step once per process. Like tools.torch_parity, this imports both
frameworks.
"""

from __future__ import annotations

import re

import jax
import numpy as np
import torch

import chip_smoke
from tools import torch_parity as tp
from tools.weld_parity import np_batch  # noqa: F401 (the tests use sp.np_batch)

# ---- bars ----
RTOL = ATOL = 1e-5  # efc rows (tests/test_torch_constraint.py)
AREF_ATOL = 3e-4
# efc_D on the quadrupeds' contact rows: tests/test_torch_constraint.py's
# D_RTOL (an ulp of a contact distance moves the impedance sigmoid of
# |dist| / 1e-3 by 3e-5, amplified by 1 / (1 - imp); the spheres' rows hold
# RTOL)
D_RTOL = 1e-4
EFC_FIELDS = ("efc_J", "efc_pos", "efc_margin", "efc_D", "efc_aref", "efc_active")
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3  # rollouts
DERIV_RTOL = 1e-4  # the velocity derivatives, of each env's largest |entry|
B, STEPS = 4, 20
QUADRUPED_STEPS = 10
CONVERGED = chip_smoke.CONVERGED

# ---- fixtures ----
# tests/test_elliptic.py's sphere on a plane (30 x 30 Newton iterations,
# elliptic cones), its _pair's friction and height; `pair_xml` picks the cone
ELLIPTIC_PAIR = chip_smoke.tests_xml("test_elliptic.py", "XML")
PAIRS = ((3, 1.0), (4, 1.0), (6, 2.0))  # (condim, impratio)


def pair_xml(condim: int, imp: float, cone: str) -> str:
    xml = ELLIPTIC_PAIR.format(fr="0.8 0.1 0.01", condim=condim, imp=imp, z=0.049)
    return xml if cone == "elliptic" else xml.replace('cone="elliptic"', f'cone="{cone}"')


def _stiff_xml() -> str:
    """tests/test_integrators.py's stiff velocity servo (its
    test_implicitfast_stable_where_euler_diverges), read as text."""
    text = (chip_smoke.REPO / "tests" / "test_integrators.py").read_text()
    body = text[text.index("def test_implicitfast_stable_where_euler_diverges"):]
    return re.search(r'xml = """(.*?)"""', body, re.S).group(1)


_PASSIVE_RICH = chip_smoke.tests_xml("test_flags.py", "PASSIVE_RICH")


def passive_rich(integrator: str) -> str:
    """tests/test_flags.py's PASSIVE_RICH (a hinge and a ball joint with
    stiffness and damping, a fixed tendon with a spring and a damper) under
    `integrator`, its fluid and gravity compensation taken out (tests/
    test_torch_fluid.py holds them)."""
    return _PASSIVE_RICH.format(integrator=integrator, flags='energy="enable"').replace(
        ' density="1.2" viscosity="0.1" wind="1 0 0"', "").replace(' gravcomp="0.5"', "")


_GYRO = chip_smoke.tests_xml("test_implicit.py", "GYRO_XML")
XMLS = {
    **{f"pair{c}_{cone}": pair_xml(c, imp, cone) for c, imp in PAIRS for cone in ("pyramidal", "elliptic")},
    "spin_down": ELLIPTIC_PAIR.format(fr="0.8 0.2 0.01", condim=4, imp=1.0, z=0.0495),
    "condim46": chip_smoke.tests_xml("test_torch_bridge.py", "CONDIM46_XML"),
    "welded_condim4": chip_smoke.tests_xml("test_torch_bridge.py", "WELDED_CONDIM4_XML"),
    "soft_feet": chip_smoke.soft_feet_xml(),
    "elliptic_mixed": chip_smoke.tests_xml("test_torch_bridge.py", "ELLIPTIC_MIXED_XML"),
    "soft_feet_elliptic": chip_smoke.soft_feet_xml("elliptic"),
    "rk4_pendulum": chip_smoke.tests_xml("test_integrators.py", "RK4_PENDULUM"),
    "implicitfast": chip_smoke.tests_xml("test_integrators.py", "IMPLICITFAST"),
    "stiff": _stiff_xml(),
    "gyro_implicit": _GYRO.format(integrator="implicit"),
    "gyro_implicitfast": _GYRO.format(integrator="implicitfast"),
    "chain": chip_smoke.tests_xml("test_implicit.py", "CHAIN_XML"),
    "passive_implicitfast": passive_rich("implicitfast"),
    "passive_implicit": passive_rich("implicit"),
}
# the fixtures stepped at their own solver options (the rest at CONVERGED:
# the CPU's plain Newton arrays run every iteration of a 30 x 30 or 100 x 50
# solve)
OWN_OPTIONS = ("soft_feet", "soft_feet_elliptic", "quadruped")
QUADRUPED = {"quadruped_rk4": 1, "quadruped_implicit": 2, "quadruped_implicitfast": 3}  # IntegratorType
_CASES: dict = {}


def _jax_model(name: str, own: bool):
    if name in QUADRUPED:
        return tp.with_solver(tp.jax_model(), integrator=QUADRUPED[name])
    jm = tp.jax_model_from_xml(XMLS[name])
    return jm if own or name in OWN_OPTIONS else tp.with_solver(jm, **CONVERGED)


def case(name: str, options: dict | None = None, own: bool = False):
    """(JAX model, port model, the JAX package's jitted vmapped step) of
    fixture `name` (a key of XMLS or QUADRUPED) at CONVERGED solver options
    unless it is one of OWN_OPTIONS or `own` is set, with Option overrides
    `options`, built once per process. The quadrupeds' steps apply the main
    path's PD controller first."""
    from ambersim_tpu.engine import step

    key = (name, tuple(sorted((options or {}).items())), own)
    if key not in _CASES:
        jm = _jax_model(name, own)
        if options:
            jm = tp.with_solver(jm, **options)
        if name in QUADRUPED or name.startswith("soft_feet"):
            jstep = jax.jit(jax.vmap(lambda d: step(jm, d.replace(ctrl=tp.pd_ctrl_jax(d)))))
        else:
            jstep = jax.jit(jax.vmap(lambda d: step(jm, d)))
        _CASES[key] = jm, tp.torch_model(jm), jstep
    return _CASES[key]


def start(name: str, jm, batch: int = B):
    """Seeded starts: the quadrupeds' from the main path's (qpos0 with
    0.05 N(0, 1) on the joints) with velocities 0.1 N(0, 1), the rest from qpos0 with each free body's
    position moved by 1 mm (a sphere near the floor put 1 mm into it), its
    orientation turned by ~0.1 rad, other joints by 0.1 N(0, 1), and
    velocities 0.5 N(0, 1) (the free bodies' angular ones 2 N(0, 1)),
    drawn by numpy.random.default_rng(the fixture's index)."""
    from ambersim_tpu.core.types import JointType

    s = jm.skel
    names = list(XMLS) + list(QUADRUPED)
    rng = np.random.default_rng(names.index(name))
    if name in QUADRUPED or name.startswith("soft_feet"):
        qvel = 0.1 * rng.standard_normal((batch, s.nv)).astype(np.float32)
        return np_batch(jm, qpos=tp.bench_qpos(jm, batch, seed=names.index(name)), qvel=qvel)
    qpos = np.tile(np.asarray(jm.qpos0, np.float32), (batch, 1))
    qvel = 0.5 * rng.standard_normal((batch, s.nv)).astype(np.float32)
    for j, jtype in enumerate(np.asarray(s.jnt_type)):
        qa, da = int(s.jnt_qposadr[j]), int(s.jnt_dofadr[j])
        if jtype == JointType.FREE:
            z0 = float(qpos[0, qa + 2])
            qpos[:, qa:qa + 3] += 1e-3 * rng.standard_normal((batch, 3)).astype(np.float32)
            if z0 < 0.12:  # near the floor: 1 mm into it (a sphere of radius 0.05)
                qpos[:, qa + 2] = min(z0, 0.05) - 1e-3
            q = qpos[:, qa + 3:qa + 7] + 0.05 * rng.standard_normal((batch, 4)).astype(np.float32)
            qpos[:, qa + 3:qa + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
            qvel[:, da + 3:da + 6] *= 4.0
        elif jtype == JointType.BALL:
            q = qpos[:, qa:qa + 4] + 0.05 * rng.standard_normal((batch, 4)).astype(np.float32)
            qpos[:, qa:qa + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
        else:
            qpos[:, qa] += 0.1 * rng.standard_normal(batch).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (batch, s.nu)).astype(np.float32)
    return np_batch(jm, qpos=qpos, qvel=qvel, ctrl=ctrl)


def torch_step(name: str, tm):
    """The port's step of fixture `name` (the quadrupeds' with pd_ctrl)."""
    from ambersim_tpu_torch.engine import step

    if name in QUADRUPED or name.startswith("soft_feet"):
        return lambda d: step(tm, d.replace(ctrl=tp.pd_ctrl_torch(d)))
    return lambda d: step(tm, d)


def rollout(name: str, steps: int, options: dict | None = None):
    """(port Data, JAX Data) after `steps` steps of both packages from
    fixture `name`'s start."""
    jm, tm, jstep = case(name, options)
    jd = start(name, jm)
    d = tp.torch_batch(tm, jd)
    f = torch_step(name, tm)
    for _ in range(steps):
        jd = jstep(jd)
        d = f(d)
    return d, jd


def assert_rollout(name: str, steps: int = STEPS, options: dict | None = None):
    """`steps` steps of both packages: finite, qpos within QPOS_ATOL and
    qvel within QVEL_ATOL."""
    d, jd = rollout(name, steps, options)
    assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
    tp.assert_close("qpos", d.qpos, jd.qpos, 0.0, QPOS_ATOL)
    tp.assert_close("qvel", d.qvel, jd.qvel, 0.0, QVEL_ATOL)
    return d, jd


def forward_pair(name: str, options: dict | None = None, own: bool = False, batch: int = B):
    """(port Data, JAX Data): one forward of each package from the same
    start of `batch` envs."""
    from ambersim_tpu_torch.engine.forward import forward

    jm, tm, _ = case(name, options, own)
    jd = start(name, jm, batch)
    if name in QUADRUPED or name.startswith("soft_feet"):
        jd = jd.replace(ctrl=np.asarray(jax.vmap(tp.pd_ctrl_jax)(jd)))
    return forward(tm, tp.torch_batch(tm, jd)), jax.jit(jax.vmap(lambda d: _jax_forward(jm, d)))(jd)


def _jax_forward(jm, d):
    from ambersim_tpu.engine.forward import forward

    return forward(jm, d)


def assert_rows(name: str):
    """The efc rows of one forward from the same Data, field by field
    (efc_D of the quadrupeds at D_RTOL)."""
    got, ref = forward_pair(name)
    d_rtol = D_RTOL if name.startswith("soft_feet") else RTOL
    for field in EFC_FIELDS:
        tp.assert_close(field, getattr(got, field), getattr(ref, field), d_rtol if field == "efc_D" else RTOL,
                        AREF_ATOL if field == "efc_aref" else ATOL)
    return got, ref


def env_rel(got, want) -> np.ndarray:
    """Per-env max |got - want| / (max |want| + 1) over pairs of (B, ...) arrays."""
    rel = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64).reshape(len(g), -1), np.asarray(w, np.float64).reshape(len(w), -1)
        rel = np.maximum(rel, np.abs(g - w).max(1) / (np.abs(w).max(1) + 1.0))
    return rel


def assert_deriv(got, want, what: str) -> None:
    """(B, nv, nv) derivatives: each env within DERIV_RTOL of its largest |entry|."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(w).reshape(len(w), -1).max(1)[:, None, None]
    err = np.abs(g - w) / np.maximum(scale, 1e-30)
    assert err.max() <= DERIV_RTOL, f"{what}: {err.max():.3e} of the env's largest |entry|"
