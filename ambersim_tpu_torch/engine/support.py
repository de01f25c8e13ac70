"""Support functions: Jacobians, mass-matrix products and the Cartesian
force map (mj_jac*, mj_fullM, mj_mulM, mj_applyFT; port of
ambersim_tpu/engine/support.py), batch-first.

`point` is a world-frame (B, 3) tensor (or (3,), broadcast over the envs);
body, site and geom ids are Python ints. Jacobians are (B, nv, 3), the
transpose of MuJoCo's C layout as in the JAX package: jacp^T qvel is the
point's world velocity and jacp @ force maps a world force to qfrc.
"""

from __future__ import annotations

import torch

from ambersim_tpu_torch.core.types import Data, Model
from ambersim_tpu_torch.engine.schedule import device_index
from ambersim_tpu_torch.engine.smooth import _body_dof_support


def jac(m: Model, d: Data, point: torch.Tensor, bodyid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(jacp, jacr), each (B, nv, 3), of a world-frame `point` on body
    `bodyid`: jacp^T qvel is the point's linear velocity, jacr^T qvel its
    angular velocity."""
    s = m.skel
    mask = device_index(_body_dof_support(s)[bodyid], d.qpos.device, dtype=d.qpos.dtype)[None, :, None]
    offset = point - d.subtree_com[:, int(s.body_rootid[bodyid])]
    ang = d.cdof[..., :3]
    lin = d.cdof[..., 3:] + torch.cross(ang, offset[:, None, :].expand_as(ang), dim=-1)
    return lin * mask, ang * mask


def jac_body(m: Model, d: Data, bodyid: int):
    """Jacobian of the body frame's origin (mj_jacBody)."""
    return jac(m, d, d.xpos[:, bodyid], bodyid)


def jac_body_com(m: Model, d: Data, bodyid: int):
    """Jacobian of the body's center of mass (mj_jacBodyCom)."""
    return jac(m, d, d.xipos[:, bodyid], bodyid)


def jac_site(m: Model, d: Data, siteid: int):
    """Jacobian of a site (mj_jacSite)."""
    return jac(m, d, d.site_xpos[:, siteid], int(m.skel.site_bodyid[siteid]))


def jac_geom(m: Model, d: Data, geomid: int):
    """Jacobian of a geom frame's origin (mj_jacGeom)."""
    return jac(m, d, d.geom_xpos[:, geomid], int(m.skel.geom_bodyid[geomid]))


def full_m(m: Model, d: Data) -> torch.Tensor:
    """The dense joint-space inertia matrix (mj_fullM; dense already), (B, nv, nv)."""
    return d.qM


def mul_m(m: Model, d: Data, vec: torch.Tensor) -> torch.Tensor:
    """qM @ vec (mj_mulM), (B, nv)."""
    return (d.qM * vec[:, None, :]).sum(-1)


def apply_ft(m: Model, d: Data, force: torch.Tensor, torque: torch.Tensor, point: torch.Tensor,
             bodyid: int) -> torch.Tensor:
    """Generalized force (B, nv) of a world-frame force and torque applied
    at `point` on body `bodyid` (mj_applyFT's qfrc_target contribution)."""
    jacp, jacr = jac(m, d, point, bodyid)
    return (jacp * force[..., None, :]).sum(-1) + (jacr * torque[..., None, :]).sum(-1)
