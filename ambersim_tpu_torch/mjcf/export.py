"""MJCF XML export: ModelSpec -> XML string/file.

Plays the role of mj_saveLastXML in the reference's save_model_xml
(reference: ambersim/utils/conversion_utils.py:11-37), letting any loadable
model (URDF included) be round-tripped to MJCF.

The port's copy of ambersim_tpu/mjcf/export.py, the same code, so that the
port compiles models where JAX is not installed; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from xml.dom import minidom
from xml.etree import ElementTree as ET

from ambersim_tpu_torch.mjcf.parser import ModelSpec


def spec_to_xml(spec: ModelSpec) -> str:
    root = ET.Element("mujoco", {"model": spec.model_name})
    if spec.compiler:
        ET.SubElement(root, "compiler", dict(spec.compiler))
    if spec.option or spec.flags:
        opt = ET.SubElement(root, "option", dict(spec.option))
        if spec.flags:
            ET.SubElement(opt, "flag", dict(spec.flags))
    if spec.meshes or spec.hfields:
        asset = ET.SubElement(root, "asset")
        for name, attrib in spec.meshes.items():
            ET.SubElement(asset, "mesh", {k: str(v) for k, v in attrib.items()})
        for name, attrib in spec.hfields.items():
            ET.SubElement(asset, "hfield", {k: str(v) for k, v in attrib.items()})

    worldbody = ET.SubElement(root, "worldbody")
    elems = {0: worldbody}
    for i, body in enumerate(spec.bodies):
        if i == 0:
            parent_elem = worldbody
            body_elem = worldbody
        else:
            parent_elem = elems[body.parent]
            body_elem = ET.SubElement(parent_elem, "body", {"name": body.name, **body.attrib})
        elems[i] = body_elem
        if i == 0:
            pass
        if body.inertial is not None:
            ET.SubElement(body_elem, "inertial", dict(body.inertial))
        for j in body.joints:
            if j.attrib.get("type") == "free" and len(j.attrib) <= 2:
                fj = {k: v for k, v in j.attrib.items() if k == "name"}
                ET.SubElement(body_elem, "freejoint", fj)
            else:
                ET.SubElement(body_elem, "joint", dict(j.attrib))
        for g in body.geoms:
            ET.SubElement(body_elem, "geom", dict(g.attrib))
        for s_ in body.sites:
            ET.SubElement(body_elem, "site", dict(s_.attrib))
        for c in body.cameras:
            ET.SubElement(body_elem, "camera", dict(c.attrib))
        for lt in body.lights:
            ET.SubElement(body_elem, "light", dict(lt.attrib))

    if spec.actuators:
        act = ET.SubElement(root, "actuator")
        for a in spec.actuators:
            ET.SubElement(act, a.kind, dict(a.attrib))
    if spec.tendons:
        ten = ET.SubElement(root, "tendon")
        for t in spec.tendons:
            te = ET.SubElement(ten, t.kind, dict(t.attrib))
            for kind, target, aux in t.wraps:
                if kind == "joint":
                    wrap_at = {"joint": target, "coef": repr(aux)}
                elif kind == "geom":
                    wrap_at = {"geom": target}
                    if aux:
                        wrap_at["sidesite"] = aux
                elif kind == "pulley":
                    wrap_at = {"divisor": repr(aux)}
                else:
                    wrap_at = {kind: target}
                ET.SubElement(te, kind, wrap_at)
    if spec.sensors:
        sen = ET.SubElement(root, "sensor")
        for sp in spec.sensors:
            ET.SubElement(sen, sp.kind, dict(sp.attrib))
    if spec.equalities:
        eq = ET.SubElement(root, "equality")
        for e in spec.equalities:
            ET.SubElement(eq, e.kind, dict(e.attrib))
    if spec.pairs or spec.excludes:
        con = ET.SubElement(root, "contact")
        for p in spec.pairs:
            ET.SubElement(con, "pair", dict(p.attrib))
        for x in spec.excludes:
            ET.SubElement(con, "exclude", dict(x.attrib))
    if spec.keyframes:
        kfs = ET.SubElement(root, "keyframe")
        for kf in spec.keyframes:
            ET.SubElement(kfs, "key", dict(kf))
    if spec.custom:
        cus = ET.SubElement(root, "custom")
        for name, data in spec.custom.items():
            ET.SubElement(
                cus, "numeric", {"name": name, "data": " ".join(repr(float(v)) for v in data)}
            )

    raw = ET.tostring(root, encoding="unicode")
    return minidom.parseString(raw).toprettyxml(indent="  ")


def save_spec_xml(spec: ModelSpec, path: str) -> None:
    with open(path, "w") as f:
        f.write(spec_to_xml(spec))
