"""The eleven per-env Model leaves admitted beside the first five
(core.types.ENV_LEAVES: dof_frictionloss, dof_armature, jnt_stiffness,
qpos0, body_ipos, body_inertia, geom_solref, geom_solimp, actuator_gear,
actuator_ctrlrange, actuator_forcerange) in the port against the JAX
package's jax.vmap(step, in_axes=(model_axes, 0)) with in_axes 0 on each
leaf (CPU).

The leaves are drawn once with numpy from a seed and given to both
packages; the JAX step takes them as arguments, so one compile serves
every draw of a model. Cases:

  * the quadruped with all sixteen leaves per env at once (4 envs, one
    step under a PD controller clamped by the per-env ctrlrange): qpos,
    qvel, qM, qfrc_passive, actuator_force, efc_frictionloss and the
    contacts' solref and solimp;
  * a small rig (RIG) for the readers the quadruped does not reach: a
    ball and a slide joint's stiffness, a joint equality row that reads
    qpos0 (a hinge with a nonzero ref), a ball-joint, a tendon and a site
    transmission's gear, forcelimited actuators, and the subtree sensors'
    body_inertia (3 steps, sensordata too);
  * the quadruped locomotion env under rl.wrappers' DomainRandomization
    VmapWrapper with rl.quadruped.randomize_quadruped_full, 3 control
    steps, against the JAX step driven by the JAX env's control law (its
    default pose is the compiled qpos0, captured at construction; its
    reset starts each env at its own qpos0);
  * each env of the quadruped's sixteen-leaf rollout against the unbatched
    model carrying that env's values, at tolerance 0.

Bars: one step's positions (qpos, qM, efc_frictionloss, contact solref and
solimp, sensordata) within atol 1e-5 and its velocities and forces (qvel,
qfrc_passive, actuator_force) within atol 1e-4, rtol 1e-5 (the existing
DR file's one-step bars, tests/test_torch_domain_randomization.py); the
env's rollout at the repo's rollout bars, qpos 1e-4 and qvel 1e-3; an env
against its own model within qpos 1e-6 and qvel 1e-5 (the same arithmetic
on other batch shapes).
"""

import jax
import numpy as np
import pytest
import torch

from tools import solver_parity as sp
from tools import torch_parity as tp
from tools.weld_parity import np_batch

POS_ATOL, FRC_ATOL, RTOL = 1e-5, 1e-4, 1e-5
QPOS_ATOL, QVEL_ATOL = 1e-4, 1e-3
SAME_QPOS, SAME_QVEL = 1e-6, 1e-5
B = 4
NEW_LEAVES = ("dof_frictionloss", "dof_armature", "jnt_stiffness", "qpos0", "body_ipos", "body_inertia",
              "geom_solref", "geom_solimp", "actuator_gear", "actuator_ctrlrange", "actuator_forcerange")

RIG = """
<mujoco><option timestep="0.005" gravity="0 0 -9.81"/>
<compiler angle="radian"/>
<worldbody>
  <body name="a" pos="0 0 1">
    <joint name="ball" type="ball" stiffness="2" damping="0.1" armature="0.01"/>
    <geom type="capsule" fromto="0 0 0 0 0.05 -0.3" size="0.03" mass="0.5"/>
    <body name="b" pos="0 0.05 -0.3">
      <joint name="h1" type="hinge" axis="0 1 0" stiffness="1" damping="0.05" ref="0.2" frictionloss="0.02"/>
      <geom type="capsule" fromto="0 0 0 0.05 0 -0.2" size="0.02" mass="0.2"/>
      <body name="c" pos="0.05 0 -0.2">
        <joint name="h2" type="hinge" axis="1 0 0" damping="0.05" frictionloss="0.01"/>
        <joint name="s1" type="slide" axis="1 0 0" damping="0.1" stiffness="3" range="-0.1 0.1"/>
        <geom type="sphere" size="0.03" mass="0.1"/>
        <site name="end"/>
      </body>
    </body>
  </body>
</worldbody>
<tendon><fixed name="t"><joint joint="h1" coef="1"/><joint joint="h2" coef="-0.5"/></fixed></tendon>
<equality><joint joint1="h2" joint2="h1" polycoef="0.1 0.5 0 0 0"/></equality>
<actuator>
  <motor joint="ball" gear="1 0.5 0.2" forcelimited="true" forcerange="-2 2" ctrlrange="-3 3" ctrllimited="true"/>
  <motor tendon="t" gear="2" forcelimited="true" forcerange="-1 1"/>
  <motor site="end" gear="1 0 0.5 0 0.5 0" ctrlrange="-1 1" ctrllimited="true"/>
  <motor joint="s1" gear="1.5" forcelimited="true" forcerange="-0.5 0.5"/>
</actuator>
<sensor><subtreeangmom body="a"/><subtreelinvel body="a"/><subtreecom body="b"/></sensor>
</mujoco>
"""


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _tile(leaves: dict, names, batch: int) -> dict:
    return {k: np.tile(np.asarray(leaves[k], np.float32), (batch,) + (1,) * np.ndim(leaves[k])) for k in names}


def _uniform(rng, lo: float, hi: float, shape) -> np.ndarray:
    return rng.uniform(lo, hi, shape).astype(np.float32)


def quadruped_leaves(base: dict, batch: int, seed: int) -> dict:
    """All sixteen per-env leaves of the quadruped from numpy(seed): the first
    five as tests/test_torch_domain_randomization.py draws them, then leg
    friction loss x U[0.5, 2], armature x U[0.8, 1.5], every joint's
    stiffness U[0, 2] (the free joint's too), leg qpos0 + U[-0.05, 0.05],
    every body's ipos + U[-0.02, 0.02] and inertia x U[0.8, 1.2], every
    geom's solref x U[0.8, 1.2] / U[0.9, 1.1] and solimp (U[0.85, 0.9],
    U[0.93, 0.97], x U[1, 3]), gear x U[0.9, 1.1], ctrlrange +-U[2, 6] (the
    PD controller's torques reach it) and forcerange +-U[20, 28] (carried:
    the motors are not forcelimited)."""
    rng = np.random.default_rng(seed)
    out = _tile(base, ("body_mass", "dof_damping", "geom_friction", "actuator_gainprm", "actuator_biasprm")
                + NEW_LEAVES, batch)
    out["body_mass"] *= _uniform(rng, 0.8, 1.2, out["body_mass"].shape)
    out["dof_damping"] = _uniform(rng, 0.5, 1.1, out["dof_damping"].shape)
    out["geom_friction"][..., 0] = _uniform(rng, 0.5, 1.25, out["geom_friction"].shape[:-1])
    out["actuator_gainprm"][..., 0] *= _uniform(rng, 0.9, 1.1, out["actuator_gainprm"].shape[:-1])
    out["actuator_biasprm"] = _uniform(rng, -0.1, 0.1, out["actuator_biasprm"].shape)
    out["dof_frictionloss"][:, 6:] *= _uniform(rng, 0.5, 2.0, (batch, 12))
    out["dof_armature"][:, 6:] *= _uniform(rng, 0.8, 1.5, (batch, 12))
    out["jnt_stiffness"] = _uniform(rng, 0.0, 2.0, out["jnt_stiffness"].shape)
    out["qpos0"][:, 7:] += _uniform(rng, -0.05, 0.05, (batch, 12))
    out["body_ipos"] += _uniform(rng, -0.02, 0.02, out["body_ipos"].shape)
    out["body_inertia"] *= _uniform(rng, 0.8, 1.2, out["body_inertia"].shape)
    out["geom_solref"] *= np.stack([_uniform(rng, 0.8, 1.2, out["geom_solref"].shape[:-1]),
                                    _uniform(rng, 0.9, 1.1, out["geom_solref"].shape[:-1])], -1)
    out["geom_solimp"][..., 0] = _uniform(rng, 0.85, 0.9, out["geom_solimp"].shape[:-1])
    out["geom_solimp"][..., 1] = _uniform(rng, 0.93, 0.97, out["geom_solimp"].shape[:-1])
    out["geom_solimp"][..., 2] *= _uniform(rng, 1.0, 3.0, out["geom_solimp"].shape[:-1])
    out["actuator_gear"][..., 0] *= _uniform(rng, 0.9, 1.1, out["actuator_gear"].shape[:-1])
    lim = _uniform(rng, 2.0, 6.0, (batch, 12))
    out["actuator_ctrlrange"] = np.stack([-lim, lim], -1)
    lim = _uniform(rng, 20.0, 28.0, (batch, 12))
    out["actuator_forcerange"] = np.stack([-lim, lim], -1)
    return out


def rig_leaves(base: dict, batch: int, seed: int) -> dict:
    """RIG's per-env leaves from numpy(seed): stiffness x U[0.5, 2], the
    hinges' and the slide's qpos0 (h1's is its ref) + U[-0.1, 0.1], gear x
    U[0.7, 1.3] in every column, ctrlrange +-U[0.2, 1] (the controls reach
    it), forcerange x U[0.1, 0.6] (the forces reach it), armature x U[0.5,
    2], friction loss x U[0.5, 2], every body's inertia x U[0.7, 1.3] and
    ipos + U[-0.02, 0.02]."""
    rng = np.random.default_rng(seed)
    names = ("jnt_stiffness", "qpos0", "actuator_gear", "actuator_ctrlrange", "actuator_forcerange", "dof_armature",
             "dof_frictionloss", "body_inertia", "body_ipos")
    out = _tile(base, names, batch)
    out["jnt_stiffness"] *= _uniform(rng, 0.5, 2.0, out["jnt_stiffness"].shape)
    out["qpos0"][:, 4:] += _uniform(rng, -0.1, 0.1, (batch, 3))
    out["actuator_gear"] *= _uniform(rng, 0.7, 1.3, out["actuator_gear"].shape)
    lim = _uniform(rng, 0.2, 1.0, out["actuator_ctrlrange"].shape[:-1])
    out["actuator_ctrlrange"] = np.stack([-lim, lim], -1)
    out["actuator_forcerange"] *= _uniform(rng, 0.1, 0.6, out["actuator_forcerange"].shape[:-1])[..., None]
    out["dof_armature"] *= _uniform(rng, 0.5, 2.0, out["dof_armature"].shape)
    out["dof_frictionloss"] *= _uniform(rng, 0.5, 2.0, out["dof_frictionloss"].shape)
    out["body_inertia"] *= _uniform(rng, 0.7, 1.3, out["body_inertia"].shape)
    out["body_ipos"] += _uniform(rng, -0.02, 0.02, out["body_ipos"].shape)
    return out


def jax_vmapped_step(jm, leaves: dict, jd, ctrl):
    """The JAX package's vmap(step, in_axes=(model_axes, 0)) with in_axes 0
    on the leaves, compiled once for `leaves`' names and shapes; called as
    (leaves, Data, ctrl)."""
    from ambersim_tpu.engine import step as jax_step

    axes = jax.tree.map(lambda _: None, jm).replace(**dict.fromkeys(leaves, 0))

    def run(lv, d, u):
        model_v = jm.replace(**lv)
        return jax.vmap(lambda m, dd, uu: jax_step(m, dd.replace(ctrl=uu)), in_axes=(axes, 0, 0))(model_v, d, u)

    return sp.compiled(run, leaves, jd, ctrl)


def torch_leaves(tm, leaves: dict):
    return tm.replace(**{k: torch.as_tensor(v) for k, v in leaves.items()})


def _check_fields(what: str, got, want, fields) -> None:
    w = tp.data_to_numpy(want)
    for f, atol in fields:
        g = getattr(got.contact, f[8:]) if f.startswith("contact.") else getattr(got, f)
        tp.assert_close(f"{what} {f}", g, w[f], RTOL, atol)


STEP_FIELDS = (("qpos", POS_ATOL), ("qvel", FRC_ATOL), ("qM", POS_ATOL), ("qfrc_passive", FRC_ATOL),
               ("actuator_force", FRC_ATOL), ("efc_frictionloss", POS_ATOL), ("contact.solref", POS_ATOL),
               ("contact.solimp", POS_ATOL))


@pytest.fixture(scope="module")
def quadruped():
    """(JAX model, port model, its compiled numpy leaves, the compiled JAX
    step over the sixteen leaves, a start Data)."""
    from tools.export_model_npz import model_arrays

    jm = sp.quick_jax_model(sp.quadruped_xml())
    base = model_arrays(jm)[1]
    leaves = quadruped_leaves(base, B, seed=3)
    jd = sp.quadruped_start(jm, seed=3, batch=B)
    jstep = jax_vmapped_step(jm, leaves, jd, np.zeros((B, 12), np.float32))
    return jm, tp.torch_model(jm), base, jstep, jd


def test_quadruped_sixteen_leaves_match_jax(quadruped):
    """All sixteen leaves per env, one step: each env reads its own values
    (the ctrlrange clamps, the contacts mix their own solref and solimp)."""
    from ambersim_tpu_torch.core.types import env_leaf_names
    from ambersim_tpu_torch.engine import step

    jm, tm, base, jstep, jd = quadruped
    leaves = quadruped_leaves(base, B, seed=3)
    ctrl = tp.KP * (0.0 - jd.qpos[:, 7:]) - tp.KD * jd.qvel[:, 6:]
    want = jstep(leaves, jd, ctrl)
    tmv = torch_leaves(tm, leaves)
    assert set(env_leaf_names(tmv)) == set(leaves) and len(leaves) == 16
    got = step(tmv, tp.torch_batch(tmv, jd).replace(ctrl=torch.as_tensor(ctrl)))
    _check_fields("quadruped", got, want, STEP_FIELDS)
    # the leaves acted: clamped controls, springs, per-env friction rows and contact parameters
    assert (np.abs(ctrl) > leaves["actuator_ctrlrange"][..., 1]).any()
    assert len(np.unique(got.efc_frictionloss.numpy()[:, 6:], axis=0)) == B
    assert len(np.unique(got.contact.solref.numpy()[:, 0], axis=0)) == B


def test_rig_leaves_match_jax():
    """RIG, 3 steps: ball, hinge and slide springs, the joint equality row's
    qpos0, ball, tendon, site and joint gears, forcerange clamps and the
    subtree sensors' inertia, each env its own."""
    from ambersim_tpu_torch.engine import step
    from tools.export_model_npz import model_arrays

    jm = tp.jax_model_from_xml(RIG)
    tm = tp.torch_model(jm)
    leaves = rig_leaves(model_arrays(jm)[1], B, seed=8)
    rng = np.random.default_rng(9)
    qpos, qvel = tp.random_state(jm, B, seed=9, qpos_scale=0.2, qvel_scale=0.5)
    qpos[:, :4] /= np.linalg.norm(qpos[:, :4], axis=1, keepdims=True)
    jd = np_batch(jm, qpos=qpos, qvel=qvel)
    ctrl = (3.0 * rng.standard_normal((3, B, jm.skel.nu))).astype(np.float32)
    jstep = jax_vmapped_step(jm, leaves, jd, ctrl[0])
    tmv = torch_leaves(tm, leaves)
    d = tp.torch_batch(tmv, jd)
    fields = STEP_FIELDS[:6] + (("sensordata", POS_ATOL),)
    for t in range(3):
        jd = jstep(leaves, jd, ctrl[t])
        d = step(tmv, d.replace(ctrl=torch.as_tensor(ctrl[t])))
        _check_fields(f"rig step {t}", d, jd, fields)
    force = d.actuator_force.numpy()
    assert (np.abs(force[:, [0, 1, 3]]) >= leaves["actuator_forcerange"][:, [0, 1, 3], 1] - 1e-6).any()


def test_randomize_quadruped_full_env_matches_jax(quadruped):
    """The locomotion env under DomainRandomizationVmapWrapper with
    randomize_quadruped_full (twelve leaves), 3 control steps from the
    port's reset state, against the JAX step with those leaves (the other
    four at their compiled values) under the JAX env's control law:
    ctrl = 24 (pose + 0.4 a - qpos[7:]) - 0.8 qvel[6:] for 4 physics
    steps, pose the compiled qpos0[7:]; obs' joint columns are qpos[7:] -
    pose. The reset draws each env's start about its own qpos0."""
    from ambersim_tpu_torch.rl.quadruped import QuadrupedLocomotionEnv, randomize_quadruped_full
    from ambersim_tpu_torch.rl.wrappers import wrap_for_training

    jm, tm, base, jstep, _ = quadruped

    def fn(model):
        return randomize_quadruped_full(model, torch.Generator().manual_seed(4), B)

    env = wrap_for_training(QuadrupedLocomotionEnv(device="cpu"), episode_length=50, randomization_fn=fn)
    model_v, names = fn(tm)
    assert len(names) == 12 and set(names) <= set(NEW_LEAVES) | {"body_mass", "dof_damping", "geom_friction",
                                                                  "actuator_gainprm"}
    plain = QuadrupedLocomotionEnv(device="cpu")
    s_dr, s_plain = (e.reset(torch.Generator().manual_seed(5), B) for e in (env, plain))
    torch.testing.assert_close(s_dr.pipeline_state.qpos - s_plain.pipeline_state.qpos,
                               model_v.qpos0 - tm.qpos0.expand(B, -1), rtol=0, atol=1e-6)
    leaves = _tile(base, ("body_mass", "dof_damping", "geom_friction", "actuator_gainprm", "actuator_biasprm")
                   + NEW_LEAVES, B)
    leaves.update({k: getattr(model_v, k).numpy() for k in names})
    rng = np.random.default_rng(6)
    qpos = model_v.qpos0.numpy().copy()
    qpos[:, 7:] += 0.08 * rng.standard_normal((B, 12)).astype(np.float32)
    qvel = np.zeros((B, 18), np.float32)
    qvel[:, :6] = 0.05 * rng.standard_normal((B, 6)).astype(np.float32)
    s = env.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel))
    jd = np_batch(jm, qpos=qpos, qvel=qvel, qacc_warmstart=s.pipeline_state.qacc_warmstart.numpy())
    pose = np.asarray(jm.qpos0, np.float32)[7:]
    for t, a in enumerate(tp.uniform_actions(6, 3, B, 12)):
        s = env.step(s, torch.as_tensor(a))
        ctrl = 24.0 * (pose + 0.4 * a - np.asarray(jd.qpos)[:, 7:]) - 0.8 * np.asarray(jd.qvel)[:, 6:]
        for _ in range(4):
            jd = jstep(leaves, jd, ctrl.astype(np.float32))
        d = s.pipeline_state
        tp.assert_close(f"qpos step {t}", d.qpos, np.asarray(jd.qpos), 0.0, QPOS_ATOL)
        tp.assert_close(f"qvel step {t}", d.qvel, np.asarray(jd.qvel), 0.0, QVEL_ATOL)
        tp.assert_close(f"obs joints step {t}", s.obs[:, 9:21], np.asarray(jd.qpos)[:, 7:] - pose, 0.0, QPOS_ATOL)


def test_env_matches_its_own_model(quadruped):
    """Each env of a sixteen-leaf rollout (4 envs x 5 steps, tolerance 0)
    against the unbatched model carrying that env's values."""
    from ambersim_tpu_torch.core.types import env_leaf_names, env_slice
    from ambersim_tpu_torch.engine import step

    jm, tm, base, _, jd = quadruped
    tm = tm.replace(opt=tm.opt.replace(tolerance=torch.zeros_like(tm.opt.tolerance)))
    tmv = torch_leaves(tm, quadruped_leaves(base, B, seed=11))

    def run(m, d):
        for _ in range(5):
            d = step(m, d.replace(ctrl=tp.pd_ctrl_torch(d)))
        return d

    got = run(tmv, tp.torch_batch(tmv, jd))
    for e in range(B):
        one = env_slice(tmv, e)
        assert env_leaf_names(one) == ()
        d = run(one, tp.torch_batch(one, jax.tree.map(lambda x: x[e:e + 1], jd)))
        tp.assert_close(f"qpos env {e}", got.qpos[e:e + 1], d.qpos.numpy(), 0.0, SAME_QPOS)
        tp.assert_close(f"qvel env {e}", got.qvel[e:e + 1], d.qvel.numpy(), 0.0, SAME_QVEL)
