"""Ray casting against geoms (mju_rayGeom / mj_ray semantics). Port of
ambersim_tpu/engine/ray.py, batch-first: `ray` casts one ray per env.

Each geom type has a closed form for the smallest nonnegative ray
parameter t (_INF = a miss); `ray` takes the first geom, in geom order, of
the smallest t. Conventions, as in the JAX package:
  * a ray starting inside a convex geom hits its exit surface;
  * geoms of `bodyexclude` are skipped;
  * a plane is bounded by size[0] / size[1] where they are positive;
  * a height field is a Moller-Trumbore test against every triangle of
    its grid (cells split along their (j, i) -> (j + 1, i + 1) diagonal).
The JAX package's model fields are compile-time constants under its jit,
and XLA folds a division by one into a product with its float32
reciprocal: the ellipsoid's scaling does the same here.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import Data, GeomType, Model

_INF = 1e10


def _pick_t(t0: torch.Tensor, t1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The smallest nonnegative root; a start inside gives the exit root."""
    return torch.where(valid & (t0 >= 0), t0, torch.where(valid & (t1 >= 0), t1, _INF))


def ray_sphere(p, v, r):
    """Local-frame rays (..., 3) against a sphere of radius r at the origin."""
    a = (v * v).sum(-1)
    b = 2.0 * (p * v).sum(-1)
    c = (p * p).sum(-1) - r * r
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    den = torch.clamp(2 * a, min=1e-20)
    return _pick_t((-b - sq) / den, (-b + sq) / den, disc >= 0)


def ray_plane(p, v, size):
    """Against the z = 0 plane, bounded by size[0] / size[1] where > 0."""
    vz = torch.where(v[..., 2].abs() < 1e-15, 1e-15, v[..., 2])
    t = -p[..., 2] / vz
    x = p[..., 0] + t * v[..., 0]
    y = p[..., 1] + t * v[..., 1]
    inb = ((size[..., 0] <= 0) | (x.abs() <= size[..., 0])) & ((size[..., 1] <= 0) | (y.abs() <= size[..., 1]))
    return torch.where((t >= 0) & inb, t, _INF)


def ray_box(p, v, size):
    """Against an origin-centred box (slabs)."""
    vsafe = torch.where(v.abs() < 1e-15, 1e-15, v)
    t_lo = (-size - p) / vsafe
    t_hi = (size - p) / vsafe
    tmin = torch.minimum(t_lo, t_hi).amax(-1)
    tmax = torch.maximum(t_lo, t_hi).amin(-1)
    return _pick_t(tmin, tmax, tmin <= tmax)


def _ray_infinite_cyl(p, v, r):
    """Roots (t0, t1, valid) of the infinite cylinder |xy| = r."""
    a = v[..., 0] ** 2 + v[..., 1] ** 2
    b = 2.0 * (p[..., 0] * v[..., 0] + p[..., 1] * v[..., 1])
    c = p[..., 0] ** 2 + p[..., 1] ** 2 - r * r
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    den = torch.clamp(2 * a, min=1e-20)
    return (-b - sq) / den, (-b + sq) / den, (disc >= 0) & (a > 1e-20)


def _ray_side(p, v, r, hl):
    """The cylinder's side between z = -hl and hl."""
    t0, t1, valid = _ray_infinite_cyl(p, v, r)
    z0 = p[..., 2] + t0 * v[..., 2]
    z1 = p[..., 2] + t1 * v[..., 2]
    return _pick_t(torch.where(z0.abs() <= hl, t0, _INF), torch.where(z1.abs() <= hl, t1, _INF), valid)


def ray_capsule(p, v, r, hl):
    """Against a capsule along z (half-length hl, radius r)."""
    t_side = _ray_side(p, v, r, hl)
    up = torch.zeros_like(p)
    up[..., 2] = hl
    t_top = ray_sphere(p - up, v, r)
    t_bot = ray_sphere(p + up, v, r)
    # a cap's hit must be on its hemisphere (|z| > hl), else the side's wins
    t_top = torch.where(p[..., 2] + t_top * v[..., 2] >= hl, t_top, _INF)
    t_bot = torch.where(p[..., 2] + t_bot * v[..., 2] <= -hl, t_bot, _INF)
    return torch.minimum(torch.minimum(t_side, t_top), t_bot)


def ray_cylinder(p, v, r, hl):
    """Against a solid cylinder along z (flat disk caps)."""
    t = _ray_side(p, v, r, hl)
    vz = torch.where(v[..., 2].abs() < 1e-15, 1e-15, v[..., 2])
    caps = []
    for zcap in (hl, -hl):
        tc = (zcap - p[..., 2]) / vz
        x = p[..., 0] + tc * v[..., 0]
        y = p[..., 1] + tc * v[..., 1]
        caps.append(torch.where((tc >= 0) & (x * x + y * y <= r * r), tc, _INF))
    return torch.minimum(t, torch.minimum(caps[0], caps[1]))


def ray_ellipsoid(p, v, size):
    """Against an axis-aligned ellipsoid: scaled to the unit sphere, which
    keeps the ray parameter."""
    inv = 1.0 / size
    return ray_sphere(p * inv, v * inv, 1.0)


def ray_hull(p, v, face_n, face_d, face_mask):
    """Against a convex polytope {x : n_i . x <= d_i}; face_n (F, 3), face_d
    (F,), face_mask (F,) the real (unpadded) faces."""
    nv = (v[..., None, :] * face_n).sum(-1)
    np_ = (p[..., None, :] * face_n).sum(-1)
    lim = (face_d - np_) / torch.where(nv.abs() < 1e-15, 1e-15, nv)
    upper = nv > 0
    tmax = torch.where(upper & face_mask, lim, _INF).amin(-1)
    tmin = torch.where(~upper & face_mask, lim, -_INF).amax(-1)
    return _pick_t(tmin, tmax, tmin <= tmax)


def hfield_triangles(m: Model, hid: int):
    """Every surface triangle (a, b, c), each (T, 3) in the field's frame,
    of height field `hid`: T = 2 (nrow - 1)(ncol - 1)."""
    s = m.skel
    nrow, ncol = int(s.hfield_nrow[hid]), int(s.hfield_ncol[hid])
    size = m.hfield_size[hid]
    dx = 2.0 * size[0] / (ncol - 1)
    dy = 2.0 * size[1] / (nrow - 1)
    xs = -size[0] + torch.arange(ncol, device=size.device) * dx
    ys = -size[1] + torch.arange(nrow, device=size.device) * dy
    z = m.hfield_data[hid, :nrow, :ncol] * size[2]
    V = torch.stack([xs[None, :].expand(nrow, ncol), ys[:, None].expand(nrow, ncol), z], dim=-1)
    v00, v01 = V[:-1, :-1].reshape(-1, 3), V[:-1, 1:].reshape(-1, 3)
    v10, v11 = V[1:, :-1].reshape(-1, 3), V[1:, 1:].reshape(-1, 3)
    return torch.cat([v00, v00]), torch.cat([v01, v11]), torch.cat([v11, v10])


def ray_hfield(m: Model, hid: int, p, v):
    """Local-frame rays (B, 3) against every triangle of height field `hid`
    (Moller-Trumbore), (B,)."""
    tri_a, tri_b, tri_c = hfield_triangles(m, hid)
    e1, e2 = tri_b - tri_a, tri_c - tri_a
    h = am.cross(v[:, None, :], e2)  # (B, T, 3)
    det = (e1 * h).sum(-1)
    det = torch.where(det.abs() < 1e-15, 1e-15, det)
    sv = p[:, None, :] - tri_a
    u = (sv * h).sum(-1) / det
    q = am.cross(sv, e1)
    w = (v[:, None, :] * q).sum(-1) / det
    t = (e2 * q).sum(-1) / det
    hit = (u >= 0) & (w >= 0) & (u + w <= 1) & (t >= 0)
    return torch.where(hit, t, _INF).amin(-1)


def ray_geom_local(gtype: int, p, v, size, mesh=None):
    """Dispatch on a static geom type; p and v in the geom's frame."""
    if gtype == int(GeomType.SPHERE):
        return ray_sphere(p, v, size[..., 0])
    if gtype == int(GeomType.PLANE):
        return ray_plane(p, v, size)
    if gtype == int(GeomType.BOX):
        return ray_box(p, v, size)
    if gtype == int(GeomType.CAPSULE):
        return ray_capsule(p, v, size[..., 0], size[..., 1])
    if gtype == int(GeomType.CYLINDER):
        return ray_cylinder(p, v, size[..., 0], size[..., 1])
    if gtype == int(GeomType.ELLIPSOID):
        return ray_ellipsoid(p, v, size)
    if gtype == int(GeomType.MESH):
        return ray_hull(p, v, *mesh)
    return p.new_full(p.shape[:-1], _INF)  # another type: no hit


def ray(m: Model, d: Data, pnt, vec, bodyexclude: int = -1):
    """Cast one world-frame ray per env against every geom (mj_ray).

    pnt and vec broadcast to (B, 3) for d's B envs. Returns (dist (B,),
    geomid (B,) int32): the smallest hit parameter (the distance when vec
    is a unit vector) and its geom, or (-1, -1) on a miss. Geoms of body
    `bodyexclude` are skipped."""
    s = m.skel
    B = d.qpos.shape[0]
    pnt = torch.as_tensor(pnt, dtype=d.qpos.dtype, device=d.qpos.device).expand(B, 3)
    vec = torch.as_tensor(vec, dtype=d.qpos.dtype, device=d.qpos.device).expand(B, 3)
    best_t = d.qpos.new_full((B,), _INF)
    best_g = torch.full((B,), -1, dtype=torch.int32, device=d.qpos.device)
    for g in range(s.ngeom):
        if bodyexclude >= 0 and int(s.geom_bodyid[g]) == bodyexclude:
            continue
        gtype = int(s.geom_type[g])
        R = d.geom_xmat[:, g]
        p_l = ((pnt - d.geom_xpos[:, g])[:, :, None] * R).sum(-2)  # R^T (pnt - xpos)
        v_l = (vec[:, :, None] * R).sum(-2)
        if gtype == int(GeomType.HFIELD):
            t = ray_hfield(m, int(s.geom_hfieldid[g]), p_l, v_l)
        else:
            mesh = None
            if gtype == int(GeomType.MESH):
                mid = int(s.geom_meshid[g])
                fmask = torch.as_tensor(np.arange(m.mesh_face_normal.shape[1]) < int(s.mesh_facenum[mid]),
                                        device=d.qpos.device)
                mesh = (m.mesh_face_normal[mid], m.mesh_face_dist[mid], fmask)
            t = ray_geom_local(gtype, p_l, v_l, m.geom_size[g], mesh)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_g = torch.where(better, g, best_g)
    hit = best_t < _INF * 0.5
    return torch.where(hit, best_t, -1.0), torch.where(hit, best_g, -1)
