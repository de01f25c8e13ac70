"""Spatial math: quaternions, rotations, 6-D motion/force algebra.

Port of ambersim_tpu/core/math.py (the helpers the engine and the envs use).
Conventions follow MuJoCo: quaternions are (w, x, y, z); spatial vectors are
(angular[3], linear[3]) at a per-tree com origin. Every function broadcasts
over leading dims, so model tensors (unbatched) mix freely with batch-first
data tensors.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def mul_quat(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u*v for (..., 4) quaternions."""
    uw, ux, uy, uz = u.unbind(-1)
    vw, vx, vy, vz = v.unbind(-1)
    return torch.stack(
        [
            uw * vw - ux * vx - uy * vy - uz * vz,
            uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx,
            uw * vz + ux * vy - uy * vx + uz * vw,
        ],
        dim=-1,
    )


def neg_quat(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    """Normalize to a unit quaternion; maps the zero quaternion to identity."""
    n2 = (q * q).sum(-1, keepdim=True)
    good = n2 > 1e-24
    norm = torch.sqrt(torch.where(good, n2, torch.ones_like(n2)))
    unit = torch.zeros_like(q)
    unit[..., 0] = 1.0
    return torch.where(good, q / norm, unit)


def rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vec by (..., 4) quat: R(q) @ vec."""
    w = quat[..., :1]
    u = quat[..., 1:]
    c = cross(u, vec)
    return vec + 2.0 * (w * c + cross(u, c))


def rotate_inv(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotate vec by the inverse of quat: R(q)^T @ vec."""
    return rotate(vec, neg_quat(quat))


def mat_t_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """mat^T @ v over the last axes: (..., 3, 3), (..., 3) -> (..., 3)."""
    return (mat * v[..., :, None]).sum(-2)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) + angle (...) -> quaternion."""
    half = 0.5 * angle
    axis = axis.expand(half.shape + (3,))
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q <- q * exp(omega * dt / 2), omega in the local frame
    (mju_quatIntegrate), with the small-angle series near zero."""
    t2 = (omega * omega).sum(-1, keepdim=True) * (dt * dt)
    good = t2 > 1e-24
    theta = torch.sqrt(torch.where(good, t2, torch.ones_like(t2)))
    half = 0.5 * theta
    sinc_half = torch.where(good, torch.sin(half) / theta, 0.5 - t2 / 48.0)
    cos_half = torch.where(good, torch.cos(half), 1.0 - t2 / 8.0)
    dq = torch.cat([cos_half, omega * dt * sinc_half], dim=-1)
    return normalize_quat(mul_quat(q, dq))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """3-vector v with qa = qb * exp(v/2) (mju_subQuat)."""
    dq = mul_quat(neg_quat(qb), qa)
    dq = torch.where(dq[..., :1] < 0, -dq, dq)
    s2 = (dq[..., 1:] * dq[..., 1:]).sum(-1, keepdim=True)
    good = s2 > 1e-24
    sin_half = torch.sqrt(torch.where(good, s2, torch.ones_like(s2)))
    angle = 2.0 * torch.atan2(sin_half[..., 0], dq[..., 0])[..., None]
    axis = dq[..., 1:] / sin_half
    return torch.where(good, axis * angle, 2.0 * dq[..., 1:])


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x_m m (crm)."""
    vang, vlin = v[..., :3], v[..., 3:]
    mang, mlin = m[..., :3], m[..., 3:]
    ang = cross(vang, mang)
    lin = cross(vlin, mang) + cross(vang, mlin)
    return torch.cat([ang, lin], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x_f f (crf): dual of motion_cross."""
    vang, vlin = v[..., :3], v[..., 3:]
    fang, flin = f[..., :3], f[..., 3:]
    ang = cross(vang, fang) + cross(vlin, flin)
    lin = cross(vang, flin)
    return torch.cat([ang, lin], dim=-1)
