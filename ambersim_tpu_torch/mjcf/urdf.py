"""URDF importer: URDF -> ModelSpec (host side).

Replicates the reference's URDF pipeline semantics
(reference: ambersim/utils/io_utils.py:18-136):
  * <transmission> blocks synthesize torque actuators with ctrlrange from the
    joint effort limit (io_utils.py:44-66)
  * <mimic> tags synthesize joint equality constraints with polycoef
    (multiplier/offset) couplings (io_utils.py:96-113)
  * an optional <mujoco><compiler .../> extension tag is honored
    (models/pendulum/pendulum.urdf:4-6)
  * `force_float_base` injects a free joint when the root body has none
    (io_utils.py:120-136)
  * vendor namespace tags (e.g. drake:declare_convex) are tolerated via
    lxml recover parsing (io_utils.py:29-32)

Unlike the reference (which round-trips through the MuJoCo C compiler), this
builds our ModelSpec directly.

The port's copy of ambersim_tpu/mjcf/urdf.py, the same code, so that the
port compiles models where JAX is not installed; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ambersim_tpu_torch.mjcf.parser import BodySpec, ElemSpec, ModelSpec, _np_axis_angle, _np_mul_quat

try:
    from lxml import etree as _ET

    def _parse_file(path):
        parser = _ET.XMLParser(recover=True, remove_comments=True)
        return _ET.parse(path, parser).getroot()

except ImportError:  # pragma: no cover
    from xml.etree import ElementTree as _ET2

    def _parse_file(path):
        return _ET2.parse(path).getroot()


def _strip_ns(tag) -> str:
    if not isinstance(tag, str):
        return ""
    return tag.split("}")[-1]


def _rpy_to_quat(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy: fixed-axis rotations applied roll(x), pitch(y), yaw(z)."""
    qx = _np_axis_angle(np.array([1.0, 0, 0]), rpy[0])
    qy = _np_axis_angle(np.array([0.0, 1, 0]), rpy[1])
    qz = _np_axis_angle(np.array([0.0, 0, 1]), rpy[2])
    return _np_mul_quat(qz, _np_mul_quat(qy, qx))


def _origin(elem) -> tuple:
    pos = np.zeros(3)
    quat = np.array([1.0, 0, 0, 0])
    if elem is not None:
        o = elem.find("origin")
        if o is not None:
            pos = np.fromstring(o.get("xyz", "0 0 0"), sep=" ")
            quat = _rpy_to_quat(np.fromstring(o.get("rpy", "0 0 0"), sep=" "))
    return pos, quat


def _vec_str(v) -> str:
    return " ".join(repr(float(x)) for x in np.atleast_1d(v))


def _geom_attrib(gelem, visual: bool, idx: int, link_name: str, base_dir: str, spec: ModelSpec) -> Optional[Dict]:
    geometry = gelem.find("geometry")
    if geometry is None:
        return None
    pos, quat = _origin(gelem)
    attrib: Dict[str, str] = {
        "name": gelem.get("name", f"{link_name}_{'visual' if visual else 'collision'}_{idx}"),
        "pos": _vec_str(pos),
        "quat": _vec_str(quat),
    }
    if visual:
        # visual-only geoms: no contacts, no mass contribution
        attrib.update(contype="0", conaffinity="0", group="1", density="0")
    shape = None
    for child in geometry:
        tag = _strip_ns(child.tag)
        if tag == "box":
            full = np.fromstring(child.get("size", "0 0 0"), sep=" ")
            attrib.update(type="box", size=_vec_str(full / 2))
        elif tag == "sphere":
            attrib.update(type="sphere", size=child.get("radius", "0"))
        elif tag == "cylinder":
            r = float(child.get("radius", 0))
            l = float(child.get("length", 0))
            attrib.update(type="cylinder", size=f"{r} {l / 2}")
        elif tag == "capsule":
            r = float(child.get("radius", 0))
            l = float(child.get("length", 0))
            attrib.update(type="capsule", size=f"{r} {l / 2}")
        elif tag == "mesh":
            fname = child.get("filename", "")
            mesh_name = os.path.splitext(os.path.basename(fname))[0]
            spec.meshes.setdefault(mesh_name, {"name": mesh_name, "file": fname, "scale": child.get("scale", "1 1 1")})
            attrib.update(type="mesh", mesh=mesh_name)
        else:
            continue
        shape = tag
        break
    if shape is None:
        return None
    return attrib


def urdf_to_spec(path: str) -> ModelSpec:
    root = _parse_file(str(path))
    if _strip_ns(root.tag) != "robot":
        raise ValueError(f"expected <robot> root in URDF, got <{root.tag}>")
    base_dir = os.path.dirname(os.path.abspath(str(path)))
    spec = ModelSpec(model_name=root.get("name", "robot"), base_dir=base_dir)
    spec.compiler["angle"] = "radian"

    # honor the <mujoco><compiler/> extension tag
    for mj in root:
        if _strip_ns(mj.tag) == "mujoco":
            for sub in mj:
                if _strip_ns(sub.tag) == "compiler":
                    spec.compiler.update({k: v for k, v in sub.attrib.items()})

    links: Dict[str, object] = {}
    joints: List = []
    for child in root:
        tag = _strip_ns(child.tag)
        if tag == "link":
            links[child.get("name")] = child
        elif tag == "joint":
            joints.append(child)

    child_links = set()
    parent_of: Dict[str, List] = {}
    for j in joints:
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        child_links.add(child)
        parent_of.setdefault(parent, []).append(j)

    roots = [name for name in links if name not in child_links]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, found {roots}")

    world = BodySpec(name="world", attrib={}, parent=-1, childclass="main")
    spec.bodies.append(world)

    def add_link(link_name: str, parent_idx: int, jelem) -> None:
        link = links[link_name]
        if jelem is not None:
            pos, quat = _origin(jelem)
        else:
            pos, quat = np.zeros(3), np.array([1.0, 0, 0, 0])
        body = BodySpec(
            name=link_name,
            attrib={"pos": _vec_str(pos), "quat": _vec_str(quat)},
            parent=parent_idx,
            childclass="main",
        )
        spec.bodies.append(body)
        my_idx = len(spec.bodies) - 1

        # joint connecting this link to its parent
        if jelem is not None:
            jtype = jelem.get("type")
            if jtype in ("revolute", "continuous", "prismatic"):
                axis_elem = jelem.find("axis")
                axis = np.fromstring(axis_elem.get("xyz"), sep=" ") if axis_elem is not None else np.array([1.0, 0, 0])
                attrib = {
                    "name": jelem.get("name"),
                    "type": "hinge" if jtype in ("revolute", "continuous") else "slide",
                    "axis": _vec_str(axis),
                    "pos": "0 0 0",
                }
                limit = jelem.find("limit")
                if jtype == "revolute" and limit is not None and limit.get("lower") is not None:
                    attrib["range"] = f"{limit.get('lower')} {limit.get('upper')}"
                dynamics = jelem.find("dynamics")
                if dynamics is not None:
                    if dynamics.get("damping"):
                        attrib["damping"] = dynamics.get("damping")
                    if dynamics.get("friction"):
                        attrib["frictionloss"] = dynamics.get("friction")
                body.joints.append(ElemSpec("joint", attrib))
            elif jtype == "floating":
                body.joints.append(ElemSpec("joint", {"type": "free", "name": jelem.get("name")}))
            elif jtype == "fixed":
                pass
            else:
                raise NotImplementedError(f"URDF joint type '{jtype}'")

        # inertial
        inertial = link.find("inertial")
        if inertial is not None:
            ipos, iquat = _origin(inertial)
            mass = inertial.find("mass").get("value")
            inertia = inertial.find("inertia")
            body.inertial = {
                "pos": _vec_str(ipos),
                "quat": _vec_str(iquat),
                "mass": mass,
                "fullinertia": " ".join(
                    inertia.get(k, "0") for k in ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")
                ),
            }

        discard_visual = spec.compiler.get("discardvisual", "true") in ("true", "1")
        gidx = 0
        for v in link.findall("visual"):
            if discard_visual:
                continue
            attrib = _geom_attrib(v, True, gidx, link_name, base_dir, spec)
            if attrib:
                body.geoms.append(ElemSpec("geom", attrib))
                gidx += 1
        for c in link.findall("collision"):
            attrib = _geom_attrib(c, False, gidx, link_name, base_dir, spec)
            if attrib:
                body.geoms.append(ElemSpec("geom", attrib))
                gidx += 1

        for j in parent_of.get(link_name, []):
            add_link(j.find("child").get("link"), my_idx, j)

    add_link(roots[0], 0, None)

    # transmissions -> torque actuators (reference io_utils.py:18-70)
    jnt_effort: Dict[str, Optional[str]] = {}
    for j in joints:
        limit = j.find("limit")
        jnt_effort[j.get("name")] = limit.get("effort") if limit is not None else None
    for tr in root:
        if _strip_ns(tr.tag) != "transmission":
            continue
        jelem = tr.find("joint")
        if jelem is None:
            continue
        jname = jelem.get("name")
        act = tr.find("actuator")
        aname = act.get("name") if act is not None else f"{jname}_actuator"
        attrib = {"name": aname, "joint": jname}
        effort = jnt_effort.get(jname)
        if effort is not None:
            attrib["ctrlrange"] = f"-{effort} {effort}"
            attrib["ctrllimited"] = "true"
        spec.actuators.append(ElemSpec("motor", attrib))

    # mimic -> joint equality with polycoef (reference io_utils.py:73-117)
    for j in joints:
        mimic = j.find("mimic")
        if mimic is None:
            continue
        multiplier = mimic.get("multiplier", "1")
        offset = mimic.get("offset", "0")
        spec.equalities.append(
            ElemSpec(
                "joint",
                {
                    "name": f"{j.get('name')}_mimic",
                    "joint1": j.get("name"),
                    "joint2": mimic.get("joint"),
                    "polycoef": f"{offset} {multiplier} 0 0 0",
                },
            )
        )

    return spec


def force_float_base(spec: ModelSpec) -> None:
    """Add a free joint to the first body if it has none
    (reference: io_utils.py:120-136 `_modify_robot_float_base`)."""
    for body in spec.bodies:
        if body.parent == 0:
            if not any(j.attrib.get("type") == "free" for j in body.joints):
                body.joints.insert(0, ElemSpec("joint", {"type": "free", "name": f"{body.name}_freejoint"}))
            return
