"""Model/Data containers and enums for the PyTorch port.

The split mirrors the JAX package (ambersim_tpu/core/types.py): ``Model`` is
the static scene, ``Data`` the per-env state. Unlike the JAX pytrees, every
``Data`` tensor carries a leading env axis ``B`` (vmap becomes an explicit
batch axis); ``Model`` tensors are unbatched and broadcast against it, but
for the leaves of ``ENV_LEAVES``, which may carry a leading env axis of
``B`` (domain randomization: each env its own value; `check_env_leaves`).

The IntEnums and :class:`Skeleton` are numpy/pure-Python copies of the JAX
package's (same values, same content hash), so a skeleton exported from the
JAX compiler compares equal to the one loaded here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np
import torch


class DisableBit(enum.IntFlag):
    """Option flags disabling pipeline stages (mjtDisableBit, MuJoCo >= 3.9
    numbering: PASSIVE was split into SPRING and DAMPER, shifting every
    higher bit up by one — values verified against the installed oracle).

    MIDPHASE/NATIVECCD/MULTICCD/ISLAND are accepted for XML compatibility but
    are no-ops here: this engine's collision stage is static-pair +
    runtime-top-k (no BVH midphase to toggle) and its narrowphase is exact
    SAT (no CCD variant switch); islands never help a batched dense solve.
    AUTORESET (host-side reset-on-divergence) is likewise a no-op: batched RL
    wrappers own reset semantics (rl/wrappers.py).
    """

    CONSTRAINT = 1 << 0
    EQUALITY = 1 << 1
    FRICTIONLOSS = 1 << 2
    LIMIT = 1 << 3
    CONTACT = 1 << 4
    SPRING = 1 << 5
    DAMPER = 1 << 6
    GRAVITY = 1 << 7
    CLAMPCTRL = 1 << 8
    WARMSTART = 1 << 9
    FILTERPARENT = 1 << 10
    ACTUATION = 1 << 11
    REFSAFE = 1 << 12
    SENSOR = 1 << 13
    MIDPHASE = 1 << 14
    EULERDAMP = 1 << 15
    AUTORESET = 1 << 16
    NATIVECCD = 1 << 17
    ISLAND = 1 << 18
    MULTICCD = 1 << 19
    # compatibility alias for the pre-3.9 flag the reference era used:
    # disabling "passive" means disabling both springs and dampers (and with
    # both set, mj_passive returns early — fluid/gravcomp zeroed too)
    PASSIVE = SPRING | DAMPER


class EnableBit(enum.IntFlag):
    """Option flags enabling optional computations (mjtEnableBit values
    verified against the installed oracle).

    OVERRIDE, ENERGY and FWDINV are implemented; INVDISCRETE and SLEEP are
    accepted for XML compatibility but no-ops (discrete-time inverse is the
    `engine.inverse` default contract here, and sleeping is a host-side
    serial-sim optimization that never pays under vmap)."""

    OVERRIDE = 1 << 0
    ENERGY = 1 << 1
    FWDINV = 1 << 2
    INVDISCRETE = 1 << 3
    SLEEP = 1 << 4
    DIAGEXACT = 1 << 5


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3

    @property
    def dof_width(self) -> int:
        return {0: 6, 1: 3, 2: 1, 3: 1}[int(self)]

    @property
    def qpos_width(self) -> int:
        return {0: 7, 1: 4, 2: 1, 3: 1}[int(self)]


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class SolverType(enum.IntEnum):
    PGS = 0
    CG = 1
    NEWTON = 2


class IntegratorType(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class EqType(enum.IntEnum):
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3


class TrnType(enum.IntEnum):
    JOINT = 0
    JOINTINPARENT = 1
    SLIDERCRANK = 2
    TENDON = 3
    SITE = 4
    BODY = 5


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3
    MUSCLE = 4


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1
    MUSCLE = 2


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1
    MUSCLE = 2


class CamLightMode(enum.IntEnum):
    """Camera/light tracking modes (MuJoCo-compatible mjtCamLight values)."""

    FIXED = 0
    TRACK = 1
    TRACKCOM = 2
    TARGETBODY = 3
    TARGETBODYCOM = 4


class SensorType(enum.IntEnum):
    """Sensor types (MuJoCo-compatible mjtSensor values, mujoco 3.10)."""

    TOUCH = 0
    ACCELEROMETER = 1
    VELOCIMETER = 2
    GYRO = 3
    FORCE = 4
    TORQUE = 5
    MAGNETOMETER = 6
    RANGEFINDER = 7
    CAMPROJECTION = 8
    JOINTPOS = 9
    JOINTVEL = 10
    TENDONPOS = 11
    TENDONVEL = 12
    ACTUATORPOS = 13
    ACTUATORVEL = 14
    ACTUATORFRC = 15
    JOINTACTFRC = 16
    TENDONACTFRC = 17
    BALLQUAT = 18
    BALLANGVEL = 19
    JOINTLIMITPOS = 20
    JOINTLIMITVEL = 21
    JOINTLIMITFRC = 22
    TENDONLIMITPOS = 23
    TENDONLIMITVEL = 24
    TENDONLIMITFRC = 25
    FRAMEPOS = 26
    FRAMEQUAT = 27
    FRAMEXAXIS = 28
    FRAMEYAXIS = 29
    FRAMEZAXIS = 30
    FRAMELINVEL = 31
    FRAMEANGVEL = 32
    FRAMELINACC = 33
    FRAMEANGACC = 34
    SUBTREECOM = 35
    SUBTREELINVEL = 36
    SUBTREEANGMOM = 37
    INSIDESITE = 38
    GEOMDIST = 39
    GEOMNORMAL = 40
    GEOMFROMTO = 41
    CONTACT = 42
    USER = 48
    E_POTENTIAL = 43
    E_KINETIC = 44
    CLOCK = 45


class ObjType(enum.IntEnum):
    """Object types sensors can attach to (MuJoCo-compatible mjtObj values)."""

    UNKNOWN = 0
    BODY = 1
    XBODY = 2
    JOINT = 3
    GEOM = 5
    SITE = 6
    CAMERA = 7
    TENDON = 18
    ACTUATOR = 19


class SiteType(enum.IntEnum):
    """Site shapes (subset of GeomType; used for touch-sensor zones)."""

    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6


def _freeze(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    a.setflags(write=False)
    return a


class Skeleton:
    """Immutable, content-hashed structural description of a scene.

    Every field is numpy or plain Python, so host code (schedules, index
    tables, row layouts) is built from it once per model and cached by it.
    """

    def __init__(self, **fields: Any):
        self._fields = {}
        for k, v in fields.items():
            if isinstance(v, np.ndarray):
                v = _freeze(v)
            elif isinstance(v, list):
                v = tuple(v)
            self._fields[k] = v
        object.__setattr__(self, "_hash", self._compute_hash())

    def _compute_hash(self) -> int:
        items = []
        for k in sorted(self._fields):
            v = self._fields[k]
            if isinstance(v, np.ndarray):
                items.append((k, v.shape, v.dtype.str, v.tobytes()))
            else:
                items.append((k, v))
        return hash(tuple(items))

    def __getattr__(self, name: str):
        try:
            return self._fields[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:  # pragma: no cover
            raise AttributeError("Skeleton is immutable")

    def replace(self, **updates: Any) -> "Skeleton":
        fields = dict(self._fields)
        fields.update(updates)
        return Skeleton(**fields)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        if not isinstance(other, Skeleton):
            return NotImplemented
        if self._hash != other._hash:
            return False
        if set(self._fields) != set(other._fields):
            return False
        for k, v in self._fields.items():
            w = other._fields[k]
            if isinstance(v, np.ndarray):
                if not (isinstance(w, np.ndarray) and v.shape == w.shape and (v == w).all()):
                    return False
            elif v != w:
                return False
        return True

    def __repr__(self) -> str:  # pragma: no cover
        return f"Skeleton({', '.join(sorted(self._fields))})"


class _Tensors:
    """``replace``/``to`` for the dataclasses below (their fields are tensors,
    nested containers of tensors, or plain Python values)."""

    def replace(self, **updates: Any):
        return dataclasses.replace(self, **updates)

    def to(self, device):
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _Tensors)):
                moved[f.name] = v.to(device)
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass
class Option(_Tensors):
    """Physics options (cf. mjOption). Float fields are 0-d or 1-d tensors;
    the integer fields select code paths."""

    timestep: torch.Tensor
    gravity: torch.Tensor  # (3,)
    wind: torch.Tensor  # (3,)
    magnetic: torch.Tensor  # (3,)
    density: torch.Tensor
    viscosity: torch.Tensor
    impratio: torch.Tensor
    tolerance: torch.Tensor
    noslip_tolerance: torch.Tensor
    o_margin: Optional[torch.Tensor] = None
    o_solref: Optional[torch.Tensor] = None  # (2,)
    o_solimp: Optional[torch.Tensor] = None  # (5,)
    o_friction: Optional[torch.Tensor] = None  # (5,)
    integrator: int = int(IntegratorType.EULER)
    solver: int = int(SolverType.NEWTON)
    cone: int = int(ConeType.PYRAMIDAL)
    iterations: int = 100
    ls_iterations: int = 50
    noslip_iterations: int = 0
    disableflags: int = 0
    enableflags: int = 0
    disableactuator: int = 0
    hessian_bf16: bool = False


OPTION_STATIC_FIELDS = (
    "integrator",
    "solver",
    "cone",
    "iterations",
    "ls_iterations",
    "noslip_iterations",
    "disableflags",
    "enableflags",
    "disableactuator",
    "hessian_bf16",
)


@dataclasses.dataclass
class Contact(_Tensors):
    """Fixed-capacity contact set, (B, ncon, ...) per field."""

    dist: torch.Tensor  # (B, ncon)
    pos: torch.Tensor  # (B, ncon, 3)
    frame: torch.Tensor  # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
    friction: torch.Tensor  # (B, ncon, 5)
    solref: torch.Tensor  # (B, ncon, 2)
    solimp: torch.Tensor  # (B, ncon, 5)
    includemargin: torch.Tensor  # (B, ncon)
    gap: torch.Tensor  # (B, ncon)
    geom1: torch.Tensor  # (B, ncon) int32
    geom2: torch.Tensor  # (B, ncon) int32


@dataclasses.dataclass
class Model(_Tensors):
    """Static scene description. Field names and shapes are those of the JAX
    package's Model (unbatched)."""

    skel: Skeleton
    opt: Option

    qpos0: torch.Tensor
    qpos_spring: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    body_invweight0: torch.Tensor
    body_gravcomp: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_range: torch.Tensor
    jnt_actfrcrange: torch.Tensor
    jnt_stiffness: torch.Tensor
    jnt_solref: torch.Tensor
    jnt_solimp: torch.Tensor
    jnt_margin: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_invweight0: torch.Tensor
    dof_solref: torch.Tensor
    dof_solimp: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    site_size: torch.Tensor
    cam_pos: torch.Tensor
    cam_quat: torch.Tensor
    cam_fovy: torch.Tensor
    cam_resolution: torch.Tensor
    cam_intrinsic: torch.Tensor
    cam_sensorsize: torch.Tensor
    cam_pos0: torch.Tensor
    cam_poscom0: torch.Tensor
    cam_mat0: torch.Tensor
    light_pos: torch.Tensor
    light_dir: torch.Tensor
    light_pos0: torch.Tensor
    light_poscom0: torch.Tensor
    light_dir0: torch.Tensor
    sensor_cutoff: torch.Tensor
    tendon_J: torch.Tensor
    tendon_Jq: torch.Tensor
    tendon_range: torch.Tensor
    tendon_stiffness: torch.Tensor
    tendon_damping: torch.Tensor
    tendon_frictionloss: torch.Tensor
    tendon_lengthspring: torch.Tensor
    tendon_solref_lim: torch.Tensor
    tendon_solimp_lim: torch.Tensor
    tendon_solref_fri: torch.Tensor
    tendon_solimp_fri: torch.Tensor
    tendon_margin: torch.Tensor
    tendon_length0: torch.Tensor
    tendon_invweight0: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_friction: torch.Tensor
    geom_solref: torch.Tensor
    geom_solimp: torch.Tensor
    geom_solmix: torch.Tensor
    geom_priority: torch.Tensor
    geom_margin: torch.Tensor
    geom_gap: torch.Tensor
    geom_rbound: torch.Tensor
    actuator_gear: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    actuator_forcerange: torch.Tensor
    actuator_gainprm: torch.Tensor
    actuator_biasprm: torch.Tensor
    actuator_dynprm: torch.Tensor
    actuator_actrange: torch.Tensor
    actuator_lengthrange: torch.Tensor
    actuator_cranklength: torch.Tensor
    actuator_acc0: torch.Tensor
    eq_data: torch.Tensor
    eq_solref: torch.Tensor
    eq_solimp: torch.Tensor
    key_time: torch.Tensor
    key_qpos: torch.Tensor
    key_qvel: torch.Tensor
    key_act: torch.Tensor
    key_ctrl: torch.Tensor
    key_mpos: torch.Tensor
    key_mquat: torch.Tensor
    pair_friction: torch.Tensor
    pair_solref: torch.Tensor
    pair_solimp: torch.Tensor
    pair_margin: torch.Tensor
    pair_gap: torch.Tensor
    mesh_vert: torch.Tensor
    mesh_face_normal: torch.Tensor
    mesh_face_dist: torch.Tensor
    mesh_face_vert: torch.Tensor
    mesh_edge: torch.Tensor
    hfield_size: torch.Tensor
    hfield_data: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def nq(self) -> int:
        return self.skel.nq


def _ranked(names: str, rank: int) -> dict:
    return dict.fromkeys(names.split(), rank)


# every Model tensor leaf's rank without an env axis
LEAF_RANK = {
    **_ranked("""qpos0 qpos_spring body_mass body_gravcomp dof_armature dof_damping dof_frictionloss dof_invweight0
                 jnt_stiffness jnt_margin cam_fovy sensor_cutoff tendon_stiffness tendon_damping tendon_frictionloss
                 tendon_margin tendon_length0 tendon_invweight0 geom_solmix geom_priority geom_margin geom_gap
                 geom_rbound actuator_cranklength actuator_acc0 key_time pair_margin pair_gap""", 1),
    **_ranked("""body_pos body_quat body_ipos body_iquat body_inertia body_invweight0 jnt_pos jnt_axis jnt_range
                 jnt_actfrcrange jnt_solref jnt_solimp dof_solref dof_solimp site_pos site_quat site_size cam_pos
                 cam_quat cam_resolution cam_intrinsic cam_sensorsize cam_pos0 cam_poscom0 light_pos light_dir
                 light_pos0 light_poscom0 light_dir0 tendon_J tendon_Jq tendon_range tendon_lengthspring
                 tendon_solref_lim tendon_solimp_lim tendon_solref_fri tendon_solimp_fri geom_pos geom_quat geom_size
                 geom_friction geom_solref geom_solimp actuator_gear actuator_ctrlrange actuator_forcerange
                 actuator_gainprm actuator_biasprm actuator_dynprm actuator_actrange actuator_lengthrange eq_data
                 eq_solref eq_solimp key_qpos key_qvel key_act key_ctrl pair_friction pair_solref pair_solimp
                 mesh_face_dist hfield_size""", 2),
    **_ranked("cam_mat0 key_mpos key_mquat mesh_vert mesh_face_normal hfield_data", 3),
    **_ranked("mesh_face_vert mesh_edge", 4),
}
# every Option float's rank; none may carry an env axis
OPTION_RANK = {**_ranked("timestep density viscosity impratio tolerance noslip_tolerance o_margin", 0),
               **_ranked("gravity wind magnetic o_solref o_solimp o_friction", 1)}
# The leaves that may carry a leading env axis (domain randomization): the
# JAX package's randomized leaves and the usual sim-to-real ones. The
# engine reads each on its trailing axes, as the JAX package's vmap with
# in_axes 0 on the leaf computes: each env with its own value. Nothing is
# recomputed from them: dof_invweight0, body_invweight0, actuator_acc0,
# tendon_length0 and the efc row set keep their compiled values. The row
# set comes from the static skeleton, so a per-env dof_frictionloss scales
# the friction rows the compile made (a dof with none there gets none) and
# a per-env actuator_forcerange clamps only actuators compiled
# forcelimited, in both packages.
ENV_LEAVES = ("body_mass", "dof_damping", "geom_friction", "actuator_gainprm", "actuator_biasprm",
              "dof_frictionloss", "dof_armature", "jnt_stiffness", "qpos0", "body_ipos", "body_inertia",
              "geom_solref", "geom_solimp", "actuator_gear", "actuator_ctrlrange", "actuator_forcerange")


def env_leaf_names(m: "Model") -> tuple:
    """The leaves of `m` that carry an env axis (a rank above LEAF_RANK's)."""
    return tuple(k for k in ENV_LEAVES if getattr(m, k).dim() > LEAF_RANK[k])


def check_env_leaves(m: "Model", batch: int) -> None:
    """Raise unless every leaf of `m` has its rank, or is one of
    ENV_LEAVES with a leading env axis of `batch` ahead of it: a leaf of
    another name (an Option float too) with an extra axis raises
    NotImplementedError, a per-env leaf of the wrong size ValueError, each
    naming the leaf. Cached on the Model (a `replace` makes a new one)."""
    if m.__dict__.get("_env_checked") == batch:
        return
    for k, rank in OPTION_RANK.items():
        t = getattr(m.opt, k)
        if t is not None and t.dim() != rank:
            raise NotImplementedError(f"Option field {k} has shape {tuple(t.shape)}, not rank {rank}: no Option "
                                      "field may be per env (ROADMAP item 5o)")
    for k, rank in LEAF_RANK.items():
        t = getattr(m, k)
        if t.dim() == rank:
            continue
        if k not in ENV_LEAVES:
            raise NotImplementedError(f"Model leaf {k} has an env axis ({tuple(t.shape)}); only {', '.join(ENV_LEAVES)} "
                                      "may be per env (domain randomization)")
        if t.dim() != rank + 1 or t.shape[0] != batch:
            raise ValueError(f"per-env Model leaf {k} has shape {tuple(t.shape)}: want ({batch}, ...) ahead of its "
                             f"rank-{rank} shape for {batch} envs")
    m.__dict__["_env_checked"] = batch


def env_slice(m: "Model", envs) -> "Model":
    """`m` with its per-env leaves cut to envs `envs` (an index, a slice or
    an index tensor): an env's own model when `envs` is an int."""
    return m.replace(**{k: getattr(m, k)[envs] for k in env_leaf_names(m)})


@dataclasses.dataclass
class Data(_Tensors):
    """Per-env state and derived quantities; every tensor is batch-first
    (B, ...) with the JAX package's per-env shape after the batch axis."""

    time: torch.Tensor  # (B,)
    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor
    ctrl: torch.Tensor
    qfrc_applied: torch.Tensor
    xfrc_applied: torch.Tensor
    qacc_warmstart: torch.Tensor
    mocap_pos: torch.Tensor
    mocap_quat: torch.Tensor
    xpos: torch.Tensor
    xquat: torch.Tensor
    xipos: torch.Tensor
    ximat: torch.Tensor
    xanchor: torch.Tensor
    xaxis: torch.Tensor
    geom_xpos: torch.Tensor
    geom_xmat: torch.Tensor
    site_xpos: torch.Tensor
    site_xmat: torch.Tensor
    cam_xpos: torch.Tensor
    cam_xmat: torch.Tensor
    light_xpos: torch.Tensor
    light_xdir: torch.Tensor
    ten_length: torch.Tensor
    ten_velocity: torch.Tensor
    ten_J: torch.Tensor
    subtree_com: torch.Tensor
    cinert: torch.Tensor
    cdof: torch.Tensor
    cdof_dot: torch.Tensor
    cvel: torch.Tensor
    qM: torch.Tensor
    qLD: torch.Tensor
    qfrc_bias: torch.Tensor
    qfrc_passive: torch.Tensor
    qfrc_spring: torch.Tensor
    qfrc_damper: torch.Tensor
    actuator_length: torch.Tensor
    actuator_velocity: torch.Tensor
    actuator_force: torch.Tensor
    act_dot: torch.Tensor
    qfrc_actuator: torch.Tensor
    qfrc_smooth: torch.Tensor
    qacc_smooth: torch.Tensor
    qfrc_constraint: torch.Tensor
    qacc: torch.Tensor
    qfrc_inverse: torch.Tensor
    contact: Contact
    efc_J: torch.Tensor
    efc_bJ: torch.Tensor
    efc_dsc: torch.Tensor
    efc_D: torch.Tensor
    efc_aref: torch.Tensor
    efc_pos: torch.Tensor
    efc_margin: torch.Tensor
    efc_frictionloss: torch.Tensor
    efc_active: torch.Tensor  # bool
    efc_force: torch.Tensor
    cacc: torch.Tensor
    sensordata: torch.Tensor
    energy: Optional[torch.Tensor] = None
    solver_fwdinv: Optional[torch.Tensor] = None
