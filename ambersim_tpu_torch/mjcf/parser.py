"""MJCF XML parser: file/string -> ModelSpec (host-side, numpy only).

Implements the subset of MJCF semantics the framework's models and the
reference's models exercise (reference models: ambersim/models/pendulum/*.xml,
ambersim/models/barrett_hand/bh280.xml): <include>, nested <default> classes
with childclass inheritance, <option> + <flag>, <compiler> units
(angle=degree default, eulerseq), body trees with joint/freejoint/geom/site/
inertial, <actuator> (motor/position/velocity/general), <equality>
(joint/connect/weld), <contact> (pair/exclude), <asset><mesh>.

The parser resolves defaults and units; numeric assembly happens in
compiler.py.

The port's copy of ambersim_tpu/mjcf/parser.py, the same code, so that the
port compiles models where JAX is not installed; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree as ET

import numpy as np

# Elements whose attributes participate in the default-class mechanism.
_DEFAULT_KINDS = (
    "joint",
    "geom",
    "site",
    "motor",
    "position",
    "velocity",
    "general",
    "equality",
    "mesh",
    "pair",
    "tendon",
    "camera",
    "light",
)


@dataclasses.dataclass
class ElemSpec:
    """One parsed element: tag kind + fully-resolved attribute dict."""

    kind: str
    attrib: Dict[str, str]


@dataclasses.dataclass
class BodySpec:
    name: str
    attrib: Dict[str, str]
    parent: int  # index into ModelSpec.bodies
    childclass: str
    inertial: Optional[Dict[str, str]] = None
    joints: List[ElemSpec] = dataclasses.field(default_factory=list)
    geoms: List[ElemSpec] = dataclasses.field(default_factory=list)
    sites: List[ElemSpec] = dataclasses.field(default_factory=list)
    cameras: List[ElemSpec] = dataclasses.field(default_factory=list)
    lights: List[ElemSpec] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TendonSpec:
    """One <tendon><fixed> (or <spatial>) element: attributes + wrap list.

    Each wrap is (kind, target_name, coef) — kind 'joint' for fixed tendons,
    'site'/'geom' for spatial ones."""

    kind: str
    attrib: Dict[str, str]
    wraps: List[Tuple[str, str, float]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModelSpec:
    model_name: str = "model"
    compiler: Dict[str, str] = dataclasses.field(default_factory=dict)
    option: Dict[str, str] = dataclasses.field(default_factory=dict)
    flags: Dict[str, str] = dataclasses.field(default_factory=dict)
    bodies: List[BodySpec] = dataclasses.field(default_factory=list)
    actuators: List[ElemSpec] = dataclasses.field(default_factory=list)
    sensors: List[ElemSpec] = dataclasses.field(default_factory=list)
    tendons: List["TendonSpec"] = dataclasses.field(default_factory=list)
    equalities: List[ElemSpec] = dataclasses.field(default_factory=list)
    pairs: List[ElemSpec] = dataclasses.field(default_factory=list)
    excludes: List[ElemSpec] = dataclasses.field(default_factory=list)
    meshes: Dict[str, Dict[str, str]] = dataclasses.field(default_factory=dict)
    hfields: Dict[str, Dict[str, str]] = dataclasses.field(default_factory=dict)
    keyframes: List[Dict[str, str]] = dataclasses.field(default_factory=list)
    custom: Dict[str, "np.ndarray"] = dataclasses.field(default_factory=dict)
    base_dir: str = "."

    def degrees(self) -> bool:
        return self.compiler.get("angle", "degree") == "degree"


class _Defaults:
    """Nested default classes: class name -> {kind: attrib dict}."""

    def __init__(self):
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"main": {k: {} for k in _DEFAULT_KINDS}}

    def add_tree(self, elem: ET.Element, parent_class: str = "main"):
        name = elem.get("class", "main" if parent_class == "main" else None)
        if name is None:
            raise ValueError("nested <default> must have a class name")
        base = copy.deepcopy(self.classes[parent_class])
        for child in elem:
            if child.tag == "default":
                continue
            if child.tag in _DEFAULT_KINDS:
                base.setdefault(child.tag, {}).update(child.attrib)
        self.classes[name] = base
        for child in elem:
            if child.tag == "default":
                self.add_tree(child, name)

    def resolve(self, kind: str, attrib: Dict[str, str], cls: str) -> Dict[str, str]:
        out = dict(self.classes.get(cls, self.classes["main"]).get(kind, {}))
        out.update(attrib)
        out.pop("class", None)
        return out


def _expand_includes(elem: ET.Element, base_dir: str) -> None:
    """Recursively splice <include file=.../> children in place
    (reference exercises this via models/pendulum/scene.xml:3)."""
    i = 0
    children = list(elem)
    for child in children:
        if child.tag == "include":
            path = os.path.join(base_dir, child.attrib["file"])
            sub = ET.parse(path).getroot()
            _expand_includes(sub, os.path.dirname(path))
            idx = list(elem).index(child)
            elem.remove(child)
            # splice the included <mujoco> root's children at the include point;
            # sections with the same tag merge naturally downstream.
            for j, sub_child in enumerate(sub):
                elem.insert(idx + j, sub_child)
        else:
            _expand_includes(child, base_dir)
        i += 1


def _parse_body(
    elem: ET.Element,
    parent: int,
    childclass: str,
    defaults: _Defaults,
    spec: ModelSpec,
) -> None:
    body = BodySpec(
        name=elem.get("name", f"body{len(spec.bodies)}"),
        attrib=dict(elem.attrib),
        parent=parent,
        childclass=elem.get("childclass", childclass),
    )
    spec.bodies.append(body)
    my_index = len(spec.bodies) - 1
    cls = body.childclass
    for child in elem:
        tag = child.tag
        if tag == "inertial":
            body.inertial = dict(child.attrib)
        elif tag == "joint":
            body.joints.append(ElemSpec("joint", defaults.resolve("joint", child.attrib, child.get("class", cls))))
        elif tag == "freejoint":
            attrib = {"type": "free"}
            if "name" in child.attrib:
                attrib["name"] = child.attrib["name"]
            body.joints.append(ElemSpec("joint", attrib))
        elif tag == "geom":
            body.geoms.append(ElemSpec("geom", defaults.resolve("geom", child.attrib, child.get("class", cls))))
        elif tag == "site":
            body.sites.append(ElemSpec("site", defaults.resolve("site", child.attrib, child.get("class", cls))))
        elif tag == "camera":
            body.cameras.append(
                ElemSpec("camera", defaults.resolve("camera", child.attrib, child.get("class", cls)))
            )
        elif tag == "light":
            body.lights.append(ElemSpec("light", defaults.resolve("light", child.attrib, child.get("class", cls))))
        elif tag == "body":
            _parse_body(child, my_index, body.childclass, defaults, spec)
        elif tag == "frame":
            _parse_frame(child, body, my_index, cls, defaults, spec, np.zeros(3), np.array([1.0, 0, 0, 0]))
        elif tag == "replicate":
            _parse_replicate(child, body, my_index, cls, defaults, spec, np.zeros(3), np.array([1.0, 0, 0, 0]))
        elif tag == "composite":
            _parse_composite(child, my_index, cls, defaults, spec, np.zeros(3), np.array([1.0, 0, 0, 0]))


def _fmt_vec(v: np.ndarray) -> str:
    return " ".join(repr(float(x)) for x in np.asarray(v).ravel())


def _compose_pose_attrib(attrib: Dict[str, str], fpos, fquat, fR, deg: bool, eulerseq: str) -> None:
    """Fold a frame transform (fpos, fquat) into an element's pose attributes
    in place: pos' = fpos + fR·pos, quat' = fquat ∘ quat. fromto endpoints are
    transformed directly (the compiler derives pos/quat from fromto)."""
    if "fromto" in attrib:
        ft = parse_vec(attrib["fromto"], 6)
        attrib["fromto"] = _fmt_vec(np.concatenate([fpos + fR @ ft[:3], fpos + fR @ ft[3:]]))
        return
    pos = parse_vec(attrib.get("pos"), 3)
    q = orientation_to_quat(attrib, deg, eulerseq)
    for k in ("euler", "axisangle", "zaxis", "xyaxes"):
        attrib.pop(k, None)
    attrib["pos"] = _fmt_vec(fpos + fR @ pos)
    attrib["quat"] = _fmt_vec(_np_mul_quat(fquat, q))


def _parse_frame(
    elem: ET.Element,
    owner: "BodySpec",
    owner_index: int,
    childclass: str,
    defaults: "_Defaults",
    spec: ModelSpec,
    ppos: np.ndarray,
    pquat: np.ndarray,
) -> None:
    """<frame>: a pure coordinate transform folded into its children at parse
    time (MuJoCo compiler semantics — frames never appear in the compiled
    model). Supports nesting and body/geom/site/joint/inertial children."""
    deg, eulerseq = spec.degrees(), spec.compiler.get("eulerseq", "xyz")
    fpos = ppos + _np_quat_to_mat(pquat) @ parse_vec(elem.get("pos"), 3)
    fquat = _np_mul_quat(pquat, orientation_to_quat(elem.attrib, deg, eulerseq))
    fR = _np_quat_to_mat(fquat)
    cls = elem.get("childclass", childclass)
    for child in elem:
        tag = child.tag
        if tag == "body":
            _compose_pose_attrib(child.attrib, fpos, fquat, fR, deg, eulerseq)
            _parse_body(child, owner_index, cls, defaults, spec)
        elif tag == "frame":
            _parse_frame(child, owner, owner_index, cls, defaults, spec, fpos, fquat)
        elif tag in ("geom", "site", "camera", "light"):
            attrib = defaults.resolve(tag, child.attrib, child.get("class", cls))
            if tag == "light":
                attrib["pos"] = _fmt_vec(fpos + fR @ parse_vec(attrib.get("pos"), 3))
                attrib["dir"] = _fmt_vec(fR @ parse_vec(attrib.get("dir"), 3, np.array([0.0, 0, -1])))
            else:
                _compose_pose_attrib(attrib, fpos, fquat, fR, deg, eulerseq)
            lists = {"geom": owner.geoms, "site": owner.sites, "camera": owner.cameras, "light": owner.lights}
            lists[tag].append(ElemSpec(tag, attrib))
        elif tag in ("joint", "freejoint"):
            if tag == "freejoint":
                attrib = {"type": "free"}
                if "name" in child.attrib:
                    attrib["name"] = child.attrib["name"]
            else:
                attrib = defaults.resolve("joint", child.attrib, child.get("class", cls))
                attrib["pos"] = _fmt_vec(fpos + fR @ parse_vec(attrib.get("pos"), 3))
                attrib["axis"] = _fmt_vec(fR @ parse_vec(attrib.get("axis"), 3, np.array([0.0, 0, 1])))
            owner.joints.append(ElemSpec("joint", attrib))
        elif tag == "inertial":
            # MuJoCo's XML parser attaches <inertial> to the enclosing body
            # ignoring the frame transform (verified vs 3.10.0) — match that.
            owner.inertial = dict(child.attrib)
        elif tag == "replicate":
            _parse_replicate(child, owner, owner_index, cls, defaults, spec, fpos, fquat)
        elif tag == "composite":
            _parse_composite(child, owner_index, cls, defaults, spec, fpos, fquat)


def _suffix_names(elem: ET.Element, suffix: str) -> None:
    """Append a replicate suffix to every named element in a subtree."""
    for e in elem.iter():
        if "name" in e.attrib:
            e.attrib["name"] = e.attrib["name"] + suffix


def _parse_replicate(
    elem: ET.Element,
    owner: "BodySpec",
    owner_index: int,
    childclass: str,
    defaults: "_Defaults",
    spec: ModelSpec,
    ppos: np.ndarray,
    pquat: np.ndarray,
) -> None:
    """<replicate count= offset= euler= sep=>: stamp `count` copies of the
    children, copy i posed at T^i with T = (offset, euler) composed on the
    left (oracle-pinned: pos_i = R(i*euler) @ pos + sum_k R(k*euler) @ offset),
    names suffixed with sep + i. Pure parse-time macro, like <frame>."""
    deg, eulerseq = spec.degrees(), spec.compiler.get("eulerseq", "xyz")
    count = int(elem.attrib["count"].split()[0])
    sep = elem.get("sep", "")
    off = parse_vec(elem.get("offset"), 3)
    qstep = orientation_to_quat(elem.attrib, deg, eulerseq)
    t, q = np.zeros(3), np.array([1.0, 0, 0, 0])
    for i in range(count):
        frame = ET.Element("frame", {"pos": _fmt_vec(t), "quat": _fmt_vec(q)})
        for child in elem:
            c = copy.deepcopy(child)
            _suffix_names(c, sep + str(i))
            frame.append(c)
        _parse_frame(frame, owner, owner_index, childclass, defaults, spec, ppos, pquat)
        t = _np_quat_to_mat(qstep) @ t + off
        q = _np_mul_quat(qstep, q)


def _parse_composite(
    elem: ET.Element,
    owner_index: int,
    childclass: str,
    defaults: "_Defaults",
    spec: ModelSpec,
    ppos: np.ndarray,
    pquat: np.ndarray,
) -> None:
    """<composite type="cable">: expand into a chain of bodies with ball
    joints along a curve (MuJoCo 3 user_composite semantics, the one
    non-deprecated composite; particle/grid are <replicate> now).

    Body frames are parallel-transported along the curve: body 0's x axis is
    the first tangent with z = normalize(t0 x t1), and each subsequent frame
    is the previous one rotated by the minimal rotation between consecutive
    tangents (oracle-pinned on straight/planar/helix/vertex-list cables in
    tests/test_composite.py). The elasticity plugin is not supported."""
    at = elem.attrib
    ctype = at.get("type", "")
    if ctype != "cable":
        raise NotImplementedError(
            f"composite type '{ctype}' is not supported (cable is; particle/grid are "
            "deprecated upstream in favor of <replicate>)"
        )
    if elem.find("plugin") is not None:
        raise NotImplementedError("composite cable elasticity plugins are not supported")
    prefix = at.get("prefix", "")
    offset = parse_vec(at.get("offset"), 3)
    if "vertex" in at:
        flat = np.fromstring(at["vertex"], sep=" ")
        verts = flat.reshape(-1, 3) + offset
    else:
        count = int(at["count"].split()[0])
        size = parse_vec(at.get("size"), 3)
        s = np.arange(count) / max(count - 1, 1)
        cols = []
        curve = at.get("curve", "s").split()
        for k in range(3):
            tok = curve[k] if k < len(curve) else "0"
            if tok == "s":
                cols.append(size[0] * s)
            elif tok == "cos(s)":
                cols.append(size[1] * np.cos(np.pi * size[2] * s))
            elif tok == "sin(s)":
                cols.append(size[1] * np.sin(np.pi * size[2] * s))
            elif tok == "0":
                cols.append(np.zeros_like(s))
            else:
                raise NotImplementedError(f"composite curve function '{tok}'")
        verts = np.stack(cols, axis=1) + offset
    n = len(verts) - 1
    if n < 1:
        raise ValueError("composite cable needs at least 2 vertices")

    tang = np.diff(verts, axis=0)
    seglen = np.linalg.norm(tang, axis=1)
    tang = tang / seglen[:, None]

    def minrot(a, b):  # minimal rotation matrix taking unit vector a to b
        c, dd = np.cross(a, b), float(a @ b)
        if np.linalg.norm(c) < 1e-12:
            return np.eye(3)
        K = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
        return np.eye(3) + K + K @ K / (1.0 + dd)

    x = tang[0]
    z = np.cross(tang[0], tang[1]) if n > 1 else np.zeros(3)
    if np.linalg.norm(z) < 1e-10:
        ref = np.array([0.0, 0, 1]) if abs(x[2]) < 0.9 else np.array([0.0, 1, 0])
        z = ref - x * (ref @ x)
    z = z / np.linalg.norm(z)
    frames_ = [np.stack([x, np.cross(z, x), z], axis=1)]
    for i in range(1, n):
        frames_.append(minrot(tang[i - 1], tang[i]) @ frames_[-1])

    geom_t = elem.find("geom")
    if geom_t is None:
        raise ValueError("composite cable requires a <geom> template")
    joint_t = {}
    for jt in elem.findall("joint"):
        if jt.get("kind", "main") == "main":
            joint_t = {k: v for k, v in jt.attrib.items() if k != "kind"}
    initial = at.get("initial", "free")

    def tag_name(i):
        return "first" if i == 0 else ("last" if i == n - 1 else str(i))

    root = None
    parent_elem = None
    for i in range(n):
        name = tag_name(i)
        if i == 0:
            pos, quat = verts[0], _np_mat_to_quat(frames_[0])
        else:
            pos = frames_[i - 1].T @ (verts[i] - verts[i - 1])
            quat = _np_mat_to_quat(frames_[i - 1].T @ frames_[i])
        b = ET.Element("body", {"name": f"{prefix}B_{name}", "pos": _fmt_vec(pos), "quat": _fmt_vec(quat)})
        if i == 0:
            if initial == "free":
                ET.SubElement(b, "freejoint", {"name": f"{prefix}J_first"})
            elif initial == "ball":
                ja = dict(joint_t)
                ja.update({"name": f"{prefix}J_first", "type": "ball"})
                ET.SubElement(b, "joint", ja)
            elif initial != "none":
                raise ValueError(f"composite initial '{initial}'")
        else:
            ja = dict(joint_t)
            ja.update({"name": f"{prefix}J_{name}", "type": "ball", "pos": "0 0 0"})
            ET.SubElement(b, "joint", ja)
        ga = dict(geom_t.attrib)
        ga.pop("pos", None)
        ga.pop("quat", None)
        if "name" in ga:
            ga["name"] = f"{ga['name']}G_{name}"
        ga["fromto"] = _fmt_vec(np.concatenate([np.zeros(3), [seglen[i], 0, 0]]))
        ET.SubElement(b, "geom", ga)
        if root is None:
            root = b
        else:
            parent_elem.append(b)
        parent_elem = b

    wrapper = ET.Element("frame", {"pos": "0 0 0"})
    wrapper.append(root)
    # find the owner BodySpec for _parse_frame dispatch
    owner = spec.bodies[owner_index]
    _parse_frame(wrapper, owner, owner_index, childclass, defaults, spec, ppos, pquat)


def parse_mjcf_string(xml: str, base_dir: str = ".") -> ModelSpec:
    root = ET.fromstring(xml)
    return _parse_root(root, base_dir)


def parse_mjcf(path: str) -> ModelSpec:
    path = str(path)
    root = ET.parse(path).getroot()
    return _parse_root(root, os.path.dirname(os.path.abspath(path)))


def _parse_root(root: ET.Element, base_dir: str) -> ModelSpec:
    if root.tag != "mujoco":
        raise ValueError(f"expected <mujoco> root, got <{root.tag}>")
    _expand_includes(root, base_dir)

    spec = ModelSpec(model_name=root.get("model", "model"), base_dir=base_dir)
    defaults = _Defaults()

    # first pass: compiler/option/defaults/assets (sections may repeat after include splicing)
    for sec in root:
        if sec.tag == "compiler":
            spec.compiler.update(sec.attrib)
        elif sec.tag == "option":
            spec.option.update(sec.attrib)
            for sub in sec:
                if sub.tag == "flag":
                    spec.flags.update(sub.attrib)
        elif sec.tag == "default":
            defaults.add_tree(sec)
        elif sec.tag == "asset":
            for sub in sec:
                if sub.tag == "mesh":
                    attrib = defaults.resolve("mesh", sub.attrib, sub.get("class", "main"))
                    name = attrib.get("name") or os.path.splitext(os.path.basename(attrib["file"]))[0]
                    spec.meshes[name] = attrib
                elif sub.tag == "hfield":
                    attrib = dict(sub.attrib)
                    spec.hfields[attrib["name"]] = attrib
        elif sec.tag == "custom":
            # <custom><numeric name=... data=.../></custom>: the MJX/Brax
            # convention for engine tuning knobs (e.g. max_contact_points)
            for sub in sec:
                if sub.tag == "numeric":
                    data = np.fromstring(sub.get("data", "0"), sep=" ")
                    spec.custom[sub.attrib["name"]] = data

    # worldbody: body index 0 is the world
    world = BodySpec(name="world", attrib={}, parent=-1, childclass="main")
    spec.bodies.append(world)
    for sec in root:
        if sec.tag == "worldbody":
            for child in sec:
                if child.tag == "body":
                    _parse_body(child, 0, "main", defaults, spec)
                elif child.tag == "geom":
                    world.geoms.append(
                        ElemSpec("geom", defaults.resolve("geom", child.attrib, child.get("class", "main")))
                    )
                elif child.tag == "site":
                    world.sites.append(
                        ElemSpec("site", defaults.resolve("site", child.attrib, child.get("class", "main")))
                    )
                elif child.tag == "camera":
                    world.cameras.append(
                        ElemSpec("camera", defaults.resolve("camera", child.attrib, child.get("class", "main")))
                    )
                elif child.tag == "light":
                    world.lights.append(
                        ElemSpec("light", defaults.resolve("light", child.attrib, child.get("class", "main")))
                    )
                elif child.tag == "frame":
                    _parse_frame(child, world, 0, "main", defaults, spec, np.zeros(3), np.array([1.0, 0, 0, 0]))
                elif child.tag == "replicate":
                    _parse_replicate(child, world, 0, "main", defaults, spec, np.zeros(3), np.array([1.0, 0, 0, 0]))
                elif child.tag == "composite":
                    _parse_composite(child, 0, "main", defaults, spec, np.zeros(3), np.array([1.0, 0, 0, 0]))

    for sec in root:
        if sec.tag == "actuator":
            for child in sec:
                kind = child.tag  # motor | position | velocity | general
                spec.actuators.append(ElemSpec(kind, defaults.resolve(kind, child.attrib, child.get("class", "main"))))
        elif sec.tag == "equality":
            for child in sec:
                spec.equalities.append(
                    ElemSpec(child.tag, defaults.resolve("equality", child.attrib, child.get("class", "main")))
                )
        elif sec.tag == "sensor":
            for child in sec:
                spec.sensors.append(ElemSpec(child.tag, dict(child.attrib)))
        elif sec.tag == "tendon":
            for child in sec:
                ten = TendonSpec(child.tag, defaults.resolve("tendon", child.attrib, child.get("class", "main")))
                for sub in child:
                    if sub.tag == "joint":
                        ten.wraps.append(("joint", sub.attrib["joint"], float(sub.get("coef", "0"))))
                    elif sub.tag == "site":
                        ten.wraps.append(("site", sub.attrib["site"], 0.0))
                    elif sub.tag == "geom":
                        # aux carries the optional sidesite name ("" if absent)
                        ten.wraps.append(("geom", sub.attrib["geom"], sub.get("sidesite", "")))
                    elif sub.tag == "pulley":
                        ten.wraps.append(("pulley", "", float(sub.attrib["divisor"])))
                spec.tendons.append(ten)
        elif sec.tag == "keyframe":
            for child in sec:
                if child.tag == "key":
                    spec.keyframes.append(dict(child.attrib))
        elif sec.tag == "contact":
            for child in sec:
                if child.tag == "pair":
                    spec.pairs.append(
                        ElemSpec("pair", defaults.resolve("pair", child.attrib, child.get("class", "main")))
                    )
                elif child.tag == "exclude":
                    spec.excludes.append(ElemSpec("exclude", dict(child.attrib)))

    return spec


def parse_vec(s: Optional[str], size: int, default: Optional[np.ndarray] = None) -> np.ndarray:
    if s is None:
        if default is None:
            return np.zeros(size)
        return np.asarray(default, dtype=np.float64)
    v = np.fromstring(s, sep=" ", dtype=np.float64)
    if v.size == size:
        return v
    # MJCF allows short vectors (e.g. geom size "0.03"); pad with default/zeros
    out = np.zeros(size) if default is None else np.array(default, dtype=np.float64)
    out[: v.size] = v[:size] if v.size > size else v
    return out


def parse_float(s: Optional[str], default: float) -> float:
    return default if s is None else float(s)


def parse_int(s: Optional[str], default: int) -> int:
    return default if s is None else int(s)


def parse_bool(s: Optional[str], default: bool) -> bool:
    if s is None:
        return default
    return s.lower() in ("true", "1")


def orientation_to_quat(attrib: Dict[str, str], degrees: bool, eulerseq: str = "xyz") -> np.ndarray:
    """Resolve MJCF orientation attributes (quat/euler/axisangle/zaxis/xyaxes) to wxyz quat."""
    if "quat" in attrib:
        q = parse_vec(attrib["quat"], 4, np.array([1.0, 0, 0, 0]))
        return q / np.linalg.norm(q)
    if "euler" in attrib:
        ang = parse_vec(attrib["euler"], 3)
        if degrees:
            ang = np.deg2rad(ang)
        q = np.array([1.0, 0.0, 0.0, 0.0])
        # MuJoCo composes euler rotations about moving axes in eulerseq order
        for axis_name, a in zip(eulerseq, ang):
            axis = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}[axis_name.lower()]
            q = _np_mul_quat(q, _np_axis_angle(np.array(axis, dtype=np.float64), a))
        return q
    if "axisangle" in attrib:
        aa = parse_vec(attrib["axisangle"], 4)
        angle = np.deg2rad(aa[3]) if degrees else aa[3]
        axis = aa[:3] / max(np.linalg.norm(aa[:3]), 1e-15)
        return _np_axis_angle(axis, angle)
    if "zaxis" in attrib:
        z = parse_vec(attrib["zaxis"], 3, np.array([0.0, 0, 1]))
        z = z / max(np.linalg.norm(z), 1e-15)
        return _np_quat_z_to(z)
    if "xyaxes" in attrib:
        xy = parse_vec(attrib["xyaxes"], 6)
        x = xy[:3] / max(np.linalg.norm(xy[:3]), 1e-15)
        y = xy[3:] - np.dot(xy[3:], x) * x
        y = y / max(np.linalg.norm(y), 1e-15)
        z = np.cross(x, y)
        return _np_mat_to_quat(np.stack([x, y, z], axis=1))
    return np.array([1.0, 0.0, 0.0, 0.0])


def _np_mul_quat(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    uw, ux, uy, uz = u
    vw, vx, vy, vz = v
    return np.array(
        [
            uw * vw - ux * vx - uy * vy - uz * vz,
            uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx,
            uw * vz + ux * vy - uy * vx + uz * vw,
        ]
    )


def _np_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def _np_quat_z_to(z: np.ndarray) -> np.ndarray:
    """Minimal rotation taking (0,0,1) to z."""
    z0 = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z0, z))
    if c > 1 - 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    if c < -1 + 1e-12:
        return np.array([0.0, 1.0, 0.0, 0.0])
    axis = np.cross(z0, z)
    axis = axis / np.linalg.norm(axis)
    return _np_axis_angle(axis, float(np.arccos(np.clip(c, -1, 1))))


def _np_quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _np_mat_to_quat(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)
