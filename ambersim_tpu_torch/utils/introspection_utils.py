"""Name-table introspection of a port Model (reference:
ambersim/utils/introspection_utils.py:8-25; port of
ambersim_tpu/utils/introspection_utils.py)."""

from __future__ import annotations

from typing import List

from ambersim_tpu_torch.core.types import Model


def get_actuator_names(model: Model) -> List[str]:
    return list(model.skel.actuator_names)


def get_equality_names(model: Model) -> List[str]:
    return list(model.skel.eq_names)


def get_geom_names(model: Model) -> List[str]:
    return list(model.skel.geom_names)


def get_joint_names(model: Model) -> List[str]:
    return list(model.skel.jnt_names)


def get_body_names(model: Model) -> List[str]:
    return list(model.skel.body_names)


def get_site_names(model: Model) -> List[str]:
    return list(model.skel.site_names)


def get_sensor_names(model: Model) -> List[str]:
    return list(model.skel.sensor_names)


def get_tendon_names(model: Model) -> List[str]:
    return list(model.skel.tendon_names)


def get_hfield_names(model: Model) -> List[str]:
    return list(model.skel.hfield_names)
