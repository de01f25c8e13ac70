"""Batched collision: the plane against sphere, capsule, box, cylinder,
ellipsoid and mesh, sphere-sphere, sphere-capsule, sphere-box,
capsule-capsule, capsule-box, box-box, sphere, capsule, box and mesh
against a mesh's convex hull (box-box, box-mesh and mesh-mesh by SAT,
engine/convex.py), and a height field against sphere, capsule and box
(each env against the triangles of its own window of the grid). Port of
ambersim_tpu/engine/collision.py (_make_frame, these narrowphases,
_mix_params, explicit <pair> overrides, the OVERRIDE flag and `collision`
with its broadphase-capped groups and global row cap). A cylinder or
ellipsoid in any other pair is the compiler's synthesized hull, so it
meets that pair as a mesh.

Each geom-type pair group runs one batched narrowphase and writes fixed
contact slots; "no contact" is dist > includemargin, masked downstream.
A group with more candidate pairs than the model's broadphase cap has only
`bpg_nsel` pairs' worth of slots, filled every step with the most-overlapping
pairs by bounding-sphere distance, so its contact geom ids differ per env.
With a max_contact_points row cap the ncand candidate slots are compacted
to the ncon deepest. Both selections are index gathers after a stable sort
(`_top_k`): exact, with no matrix product. Contact frame rows are (normal,
tangent1, tangent2), normal from geom1 to geom2, as in MuJoCo.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import Contact, Data, EnableBit, GeomType, Model
from ambersim_tpu_torch.engine import convex
from ambersim_tpu_torch.engine.schedule import device_index

_BIG = 1e10

_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], dtype=np.float32
)


def _make_frame(n: torch.Tensor) -> torch.Tensor:
    """(..., 3) normal -> (..., 3, 3) frame rows (n, t1, t2): reference axis
    y if |n_y| <= |n_x| else x, orthogonalized against n; t2 = n x t1."""
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    use_y = (n[..., 1:2].abs() <= n[..., 0:1].abs()).to(n.dtype)
    ref = torch.cat([1.0 - use_y, use_y, torch.zeros_like(use_y)], dim=-1)  # e_y or e_x
    t1 = ref - n * (n * ref).sum(-1, keepdim=True)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([n, t1, am.cross(n, t1)], dim=-2)


# Each narrowphase takes batched geom poses (B, P, 3) / (B, P, 3, 3) and
# model sizes (P, 3), and returns dist (B, P, k), pos (B, P, k, 3) and
# frame (B, P, k, 3, 3) for a fixed k contact points per pair.


def plane_sphere(xp1, xm1, s1, xp2, xm2, s2):
    n = xm1[..., :, 2]
    r = s2[..., 0]
    dist = ((xp2 - xp1) * n).sum(-1) - r
    pos = xp2 - n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], _make_frame(n)[..., None, :, :]


def plane_capsule(xp1, xm1, s1, xp2, xm2, s2):
    n = xm1[..., :, 2]
    r, hl = s2[..., 0], s2[..., 1]
    axis = xm2[..., :, 2]
    dists, poss = [], []
    for sign in (1.0, -1.0):
        c = xp2 + sign * hl[..., None] * axis
        dist = ((c - xp1) * n).sum(-1) - r
        dists.append(dist)
        poss.append(c - n * (r + 0.5 * dist)[..., None])
    pos = torch.stack(poss, dim=-2)
    frame = _make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))
    return torch.stack(dists, dim=-1), pos, frame


def plane_box(xp1, xm1, s1, xp2, xm2, s2):
    """The 4 deepest box corners against the plane (ties: first corner)."""
    n = xm1[..., :, 2]
    corners = device_index(_BOX_CORNERS, xp2.device)
    # corner world positions, one (..., 8) tensor per world axis
    pts = [
        xp2[..., i, None] + sum(xm2[..., i, j, None] * (s2[..., j, None] * corners[:, j]) for j in range(3))
        for i in range(3)
    ]
    d = sum((pts[i] - xp1[..., i, None]) * n[..., i, None] for i in range(3))  # (..., 8)
    arange8 = torch.arange(8, device=xp2.device)
    dists, poss = [], []
    for _ in range(4):
        dk = d.min(-1).values
        oh = (arange8 == d.argmin(-1)[..., None]).to(d.dtype)
        pk = [(pts[i] * oh).sum(-1) for i in range(3)]
        dists.append(dk)
        poss.append(torch.stack([pk[i] - 0.5 * dk * n[..., i] for i in range(3)], dim=-1))
        d = d + oh * _BIG  # exclude the picked corner from later rounds
    pos = torch.stack(poss, dim=-2)
    frame = _make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))
    return torch.stack(dists, dim=-1), pos, frame


def _sphere_sphere_raw(c1, r1, c2, r2):
    delta = c2 - c1
    dd = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / torch.clamp(dd, min=1e-12)[..., None]
    # concentric spheres: the z axis
    n = torch.where(dd[..., None] > 1e-9, n, device_index(np.array([0.0, 0.0, 1.0]), c1.device))
    dist = dd - (r1 + r2)
    return dist, c1 + n * (r1 + 0.5 * dist)[..., None], n


def sphere_sphere(xp1, xm1, s1, xp2, xm2, s2):
    dist, pos, n = _sphere_sphere_raw(xp1, s1[..., 0], xp2, s2[..., 0])
    return dist[..., None], pos[..., None, :], _make_frame(n)[..., None, :, :]


def _closest_on_segment(p, a, axis, hl):
    t = torch.clamp(((p - a) * axis).sum(-1), -hl, hl)
    return a + t[..., None] * axis


def sphere_capsule(xp1, xm1, s1, xp2, xm2, s2):
    c = _closest_on_segment(xp1, xp2, xm2[..., :, 2], s2[..., 1])
    dist, pos, n = _sphere_sphere_raw(xp1, s1[..., 0], c, s2[..., 0])
    return dist[..., None], pos[..., None, :], _make_frame(n)[..., None, :, :]


def capsule_capsule(xp1, xm1, s1, xp2, xm2, s2):
    """Closest points of the two segments by a clamped solve, then the two
    spheres there. Near-parallel segments (|1 - (a1.a2)^2| <= 1e-9) start
    from u = 0, and their branch divides by 1, so neither branch of the
    select makes an inf or a NaN."""
    a1, a2 = xm1[..., :, 2], xm2[..., :, 2]
    hl1, hl2 = s1[..., 1], s2[..., 1]
    d12 = (a1 * a2).sum(-1)
    r = xp2 - xp1
    s_, t_ = (r * a1).sum(-1), (r * a2).sum(-1)
    denom = 1.0 - d12 * d12
    ok = denom.abs() > 1e-9
    u = torch.where(ok, (s_ - d12 * t_) / torch.where(ok, denom, 1.0), 0.0)
    u = torch.clamp(u, -hl1, hl1)
    v = torch.clamp(u * d12 - t_, -hl2, hl2)
    u = torch.clamp(v * d12 + s_, -hl1, hl1)
    p1 = xp1 + u[..., None] * a1
    p2 = xp2 + v[..., None] * a2
    dist, pos, n = _sphere_sphere_raw(p1, s1[..., 0], p2, s2[..., 0])
    return dist[..., None], pos[..., None, :], _make_frame(n)[..., None, :, :]


def _sphere_box_raw(center, r, xp2, xm2, s2):
    local = (xm2 * (center - xp2)[..., :, None]).sum(-2)  # sphere center in the box frame
    inside = (local.abs() < s2).all(-1)
    # a center inside the box is pushed out through the nearest face
    onehot = torch.nn.functional.one_hot((s2 - local.abs()).argmin(-1), 3).to(local.dtype)
    face_pt = torch.where(
        inside[..., None], local * (1 - onehot) + onehot * torch.sign(local) * s2, torch.clamp(local, -s2, s2)
    )
    delta = xp2 + (xm2 * face_pt[..., None, :]).sum(-1) - center
    dd = torch.linalg.vector_norm(delta, dim=-1)
    n_out = delta / torch.clamp(dd, min=1e-12)[..., None]
    n = torch.where(inside[..., None], -n_out, n_out)  # inside: from the sphere into the box face
    dist = torch.where(inside, -(dd + r), dd - r)
    return dist, center + n * (r + 0.5 * dist)[..., None], n


def sphere_box(xp1, xm1, s1, xp2, xm2, s2):
    dist, pos, n = _sphere_box_raw(xp1, s1[..., 0], xp2, xm2, s2)
    return dist[..., None], pos[..., None, :], _make_frame(n)[..., None, :, :]


def capsule_box(xp1, xm1, s1, xp2, xm2, s2):
    """Three contacts, in this slot order: sphere-box at the capsule's +axis
    and -axis endpoints, then at the segment point nearest the box (8 fixed
    rounds of alternating projection between segment and box)."""
    r, hl = s1[..., 0], s1[..., 1]
    axis = xm1[..., :, 2]
    e1 = xp1 + hl[..., None] * axis
    e2 = xp1 - hl[..., None] * axis
    pseg = xp1
    for _ in range(8):
        local = (xm2 * (pseg - xp2)[..., :, None]).sum(-2)
        q = xp2 + (xm2 * torch.clamp(local, -s2, s2)[..., None, :]).sum(-1)
        pseg = _closest_on_segment(q, xp1, axis, hl)
    dists, poss, ns = zip(*(_sphere_box_raw(c, r, xp2, xm2, s2) for c in (e1, e2, pseg)))
    return torch.stack(dists, dim=-1), torch.stack(poss, dim=-2), _make_frame(torch.stack(ns, dim=-2))


def box_box(xp1, xm1, s1, xp2, xm2, s2):
    """Exact SAT box-box with a clipped 8-point manifold (engine/convex.py)."""
    dist, pos, n = convex.hull_hull(convex.box_hull(xp1, xm1, s1), convex.box_hull(xp2, xm2, s2), 8)
    return dist, pos, _make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))


def plane_cylinder(xp1, xm1, s1, xp2, xm2, s2):
    """Four candidate contacts: the low rim point of each cap (a cylinder
    lying on its side) and the lower cap's rim at +-120 degrees from it (a
    cylinder standing on a cap). Slots that do not touch are masked by
    distance downstream."""
    n = xm1[..., :, 2]
    a = xm2[..., :, 2]
    r, hl = s2[..., 0], s2[..., 1]
    an = (a * n).sum(-1)
    d = n - an[..., None] * a  # steepest descent in the cap plane
    dn = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d_rn = torch.where(dn > 1e-6, d / torch.clamp(dn, min=1e-12), xm2[..., :, 0])  # axis || n: any tangent
    lower = -torch.sign(an)[..., None]
    cap_lo = xp2 + lower * hl[..., None] * a
    cap_hi = xp2 - lower * hl[..., None] * a
    rim = -r[..., None] * d_rn

    def rot_about_axis(v, ang):
        cs, sn = float(np.cos(ang)), float(np.sin(ang))
        return v * cs + am.cross(a, v) * sn + a * (a * v).sum(-1, keepdim=True) * (1 - cs)

    pts = torch.stack([cap_lo + rim, cap_hi + rim, cap_lo + rot_about_axis(rim, 2.0 * np.pi / 3),
                       cap_lo + rot_about_axis(rim, -2.0 * np.pi / 3)], dim=-2)
    dist = ((pts - xp1[..., None, :]) * n[..., None, :]).sum(-1)
    pos = pts - 0.5 * dist[..., None] * n[..., None, :]
    return dist, pos, _make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))


def plane_ellipsoid(xp1, xm1, s1, xp2, xm2, s2):
    """The ellipsoid's support point along -normal (one contact)."""
    n = xm1[..., :, 2]
    n_l = (xm2 * -n[..., :, None]).sum(-2)  # -n in the ellipsoid's frame
    sn = s2 * n_l
    w = s2 * sn / torch.clamp(torch.linalg.vector_norm(sn, dim=-1, keepdim=True), min=1e-12)
    p = xp2 + (xm2 * w[..., None, :]).sum(-1)
    dist = ((p - xp1) * n).sum(-1)
    pos = p - 0.5 * dist[..., None] * n
    return dist[..., None], pos[..., None, :], _make_frame(n)[..., None, :, :]


# A mesh geom's hull arrives as the tuple (verts (.., V, 3), vert_mask
# (.., V), face normals (.., F, 3), face offsets (.., F), face rings
# (.., F, FV, 3), edges (.., E, 2, 3)), gathered by the pairs' mesh ids
# (`_mesh_tuple`).


def plane_mesh(xp1, xm1, s1, xp2, xm2, s2, mesh2):
    """The 4 deepest hull vertices against the plane. Padded vertices sit at
    +_BIG; a stable sort takes tied vertices (a face resting flat) lowest
    index first, as the JAX package's argsort does."""
    verts, vert_mask = mesh2[0], mesh2[1]
    n = xm1[..., :, 2]
    pts = xp2[..., None, :] + convex._rotate(xm2, verts)
    dvert = ((pts - xp1[..., None, :]) * n[..., None, :]).sum(-1)
    dvert = torch.where(vert_mask, dvert, _BIG)
    idx = torch.sort(dvert, dim=-1, stable=True).indices[..., :4]
    dist = torch.take_along_dim(dvert, idx, dim=-1)
    pos = torch.take_along_dim(pts, idx[..., None], dim=-2) - 0.5 * dist[..., None] * n[..., None, :]
    return dist, pos, _make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))


def _point_hull_sd(p_local, face_n, face_d):
    """Signed distance of points p_local (..., K, 3), in the mesh frame, to a
    hull by its face planes, and the outward normal of the first face that
    attains it (..., K, 3). Exact inside and nearest a face; past an edge or
    corner it overestimates the depth, which contact near the surface
    tolerates."""
    plane_d = (p_local[..., :, None, :] * face_n[..., None, :, :]).sum(-1) - face_d[..., None, :]  # (..., K, F)
    sd, idx = plane_d.max(-1).values, plane_d.argmax(-1)
    fn = face_n[..., None, :, :].expand(p_local.shape[:-1] + face_n.shape[-2:])
    return sd, torch.take_along_dim(fn, idx[..., None, None], dim=-2).squeeze(-2)


def _mesh_frame_points(pts_world, xp_m, xm_m):
    """World points (..., K, 3) in a mesh's frame: R^T (p - xp)."""
    return ((pts_world - xp_m[..., None, :])[..., :, :, None] * xm_m[..., None, :, :]).sum(-2)


def _points_vs_hull(pts_world, r, xp_m, xm_m, face_n, face_d):
    """Spheres of radius r centered at pts_world (..., K, 3) against a hull:
    dist (..., K), pos at the middle of the overlap, and the hull's outward
    world normal (..., K, 3)."""
    sd, n_l = _point_hull_sd(_mesh_frame_points(pts_world, xp_m, xm_m), face_n, face_d)
    n_w = convex._rotate(xm_m, n_l)
    dist = sd - r
    return dist, pts_world - (r + 0.5 * dist)[..., None] * n_w, n_w


def sphere_mesh(xp1, xm1, s1, xp2, xm2, s2, mesh2):
    dist, pos, n_w = _points_vs_hull(xp1[..., None, :], s1[..., 0:1], xp2, xm2, mesh2[2], mesh2[3])
    return dist, pos, _make_frame(-n_w)  # the hull's outward normal points geom2 -> geom1


def capsule_mesh(xp1, xm1, s1, xp2, xm2, s2, mesh2):
    """Both endpoints and the segment point nearest the hull: a 12-round
    ternary search on the hull's signed distance along the segment (a max
    of affine functions, so convex)."""
    fn2, fd2 = mesh2[2], mesh2[3]
    r, hl = s1[..., 0], s1[..., 1]
    axis = xm1[..., :, 2]

    def sd_at(t):
        p_l = _mesh_frame_points((xp1 + t[..., None] * axis)[..., None, :], xp2, xm2)
        return _point_hull_sd(p_l, fn2, fd2)[0][..., 0]

    lo, hi = -hl, hl
    for _ in range(12):
        m1 = lo + (hi - lo) / 3
        m2 = hi - (hi - lo) / 3
        left = sd_at(m1) < sd_at(m2)
        hi = torch.where(left, m2, hi)
        lo = torch.where(left, lo, m1)
    tmid = 0.5 * (lo + hi)
    pts = torch.stack([xp1 + hl[..., None] * axis, xp1 - hl[..., None] * axis, xp1 + tmid[..., None] * axis], dim=-2)
    dist, pos, n_w = _points_vs_hull(pts, r[..., None], xp2, xm2, fn2, fd2)
    return dist, pos, _make_frame(-n_w)


def box_mesh(xp1, xm1, s1, xp2, xm2, s2, mesh2):
    """Exact SAT box-hull with a clipped 4-point manifold (engine/convex.py)."""
    h2 = convex.mesh_hull(xp2, xm2, mesh2[0], mesh2[2], mesh2[4], mesh2[5])
    dist, pos, n = convex.hull_hull(convex.box_hull(xp1, xm1, s1), h2, 4)
    return dist, pos, _make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))


def mesh_mesh(xp1, xm1, s1, xp2, xm2, s2, mesh1, mesh2):
    """Exact SAT hull-hull with a clipped 4-point manifold (engine/convex.py).
    Its axis set holds E1 x E2 edge-cross axes: two 186-edge hulls give
    34,596, each projected on both hulls' vertices."""
    h1 = convex.mesh_hull(xp1, xm1, mesh1[0], mesh1[2], mesh1[4], mesh1[5])
    h2 = convex.mesh_hull(xp2, xm2, mesh2[0], mesh2[2], mesh2[4], mesh2[5])
    dist, pos, n = convex.hull_hull(h1, h2, 4)
    return dist, pos, _make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))


def _closest_on_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, branch-free (Ericson,
    Real-Time Collision Detection 5.1.5); all (..., 3), broadcasting."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-20)
    v = torch.clamp(vb / denom, 0.0, 1.0)
    w = torch.clamp(vc / denom, 0.0, 1.0)
    out = a + v[..., None] * ab + w[..., None] * ac
    # the edge and vertex regions, in the JAX package's order of selects
    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-20), 0.0, 1.0)
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-20), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=1e-20), 0.0, 1.0)
    for region, q in (
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[..., None] * ab),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[..., None] * ac),
        ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0), b + t_bc[..., None] * (c - b)),
        ((d1 <= 0) & (d2 <= 0), a),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d6 >= 0) & (d5 <= d6), c),
    ):
        out = torch.where(region[..., None], q, out)
    return out


def _hfield_window_tris(m: Model, hid: int, c_local: torch.Tensor, K: int):
    """The 2 (K-1)^2 local-frame surface triangles (a, b, c), each (..., T, 3),
    of the K x K grid window of height field `hid` nearest each local point
    c_local (..., 3): every env gets its own window. Cells split along the
    (j, i) -> (j + 1, i + 1) diagonal. The window's corner is clamped to
    this field's own nrow - K / ncol - K (hfield_data pads every grid to
    the largest)."""
    s = m.skel
    nrow, ncol = int(s.hfield_nrow[hid]), int(s.hfield_ncol[hid])
    size = m.hfield_size[hid]
    dx = 2.0 * size[0] / (ncol - 1)
    dy = 2.0 * size[1] / (nrow - 1)
    # the cell's floor, (c + size) / dx as the jitted JAX package computes
    # it: XLA folds a division by the constant dx into a product with its
    # float32 reciprocal, which floors otherwise on a cell border
    i0 = torch.clamp(torch.floor((c_local[..., 0] + size[0]) * (1.0 / dx)).long() - (K - 1) // 2, 0, ncol - K)
    j0 = torch.clamp(torch.floor((c_local[..., 1] + size[1]) * (1.0 / dy)).long() - (K - 1) // 2, 0, nrow - K)
    ar = torch.arange(K, device=c_local.device)
    cols, rows = i0[..., None] + ar, j0[..., None] + ar  # (..., K)
    win = m.hfield_data[hid][rows[..., :, None], cols[..., None, :]] * size[2]  # (..., K, K) as [j, i]
    xs = -size[0] + cols.to(win.dtype) * dx
    ys = -size[1] + rows.to(win.dtype) * dy
    V = torch.stack([xs[..., None, :].expand(win.shape), ys[..., :, None].expand(win.shape), win], dim=-1)
    lead = V.shape[:-3]
    v00 = V[..., :-1, :-1, :].reshape(lead + (-1, 3))
    v01 = V[..., :-1, 1:, :].reshape(lead + (-1, 3))
    v10 = V[..., 1:, :-1, :].reshape(lead + (-1, 3))
    v11 = V[..., 1:, 1:, :].reshape(lead + (-1, 3))
    return torch.cat([v00, v00], -2), torch.cat([v01, v11], -2), torch.cat([v11, v10], -2)


def _hfield_spheres(m: Model, hid: int, K: int, xp_h, xm_h, centers_w, r, k_out: int):
    """The k_out deepest contacts between spheres of radius r (P,) centered
    at centers_w (B, P, N, 3) and the triangles of each pair's window of
    height field `hid` at pose (xp_h (B, P, 3), xm_h (B, P, 3, 3)). Returns
    dist (B, P, k_out), world pos (B, P, k_out, 3) and frames (B, P, k_out,
    3, 3), the normal from the field into the sphere.

    A center below a triangle's plane inside that triangle's column is
    pushed up along the plane's normal; one below a plane outside its
    column is ignored (_BIG), so that a tall neighbour cannot claim a
    sphere beside it. The deepest candidates over (sphere, triangle) are
    taken in the order of lax.top_k (stable: ties lowest index first), so
    ignored ones fill the slots when fewer than k_out are valid."""
    cs = _mesh_frame_points(centers_w, xp_h, xm_h)  # (B, P, N, 3) local centers
    N = cs.shape[-2]
    c_sum = cs[..., 0, :]
    for i in range(1, N):  # jnp.mean's order: a sum left to right, then x float32(1 / N) (XLA's fold)
        c_sum = c_sum + cs[..., i, :]
    tri_a, tri_b, tri_c = _hfield_window_tris(m, hid, c_sum * (1.0 / cs.new_tensor(float(N))), K)  # (B, P, T, 3)
    a, b, c = tri_a[..., None, :, :], tri_b[..., None, :, :], tri_c[..., None, :, :]
    p = cs[..., :, None, :]  # (B, P, N, 1, 3)
    cp = _closest_on_triangle(p, a, b, c)  # (B, P, N, T, 3)
    dvec = p - cp
    dd = torch.linalg.vector_norm(dvec, dim=-1)
    n = dvec / torch.clamp(dd, min=1e-12)[..., None]
    # the upward plane normal of each triangle and the centers' signed
    # distance to it. The JAX package divides by jnp.linalg.norm(nt, -1,
    # keepdims=True), whose -1 is `ord`: the (T, 3) matrix's 1-norm of
    # order -1, its smallest column sum of |nt|, one scale for the window,
    # not a unit normal per triangle. Copied as it is (ROADMAP, queue 3).
    nt = am.cross(b - a, c - a)
    nt = nt * torch.sign(nt[..., 2:3])
    nt = nt / torch.clamp(nt.abs().sum(-2, keepdim=True).amin(-1, keepdim=True), min=1e-12)
    sd = ((p - a) * nt).sum(-1)
    # is the center's xy inside the triangle's column? (2D barycentric)
    e0, e1, dp = (b - a)[..., :2], (c - a)[..., :2], (p - a)[..., :2]
    det = e0[..., 0] * e1[..., 1] - e0[..., 1] * e1[..., 0]
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    u = (dp[..., 0] * e1[..., 1] - dp[..., 1] * e1[..., 0]) / det
    v = (e0[..., 0] * dp[..., 1] - e0[..., 1] * dp[..., 0]) / det
    inside = (u >= 0) & (v >= 0) & (u + v <= 1)
    below = inside & (sd < 0)
    ignore = ~inside & (sd < 0)
    rr = r[:, None, None]
    n = torch.where(below[..., None], nt.expand(n.shape), n)
    dist = torch.where(ignore, _BIG, torch.where(below, sd - rr, dd - rr))
    cp = torch.where(below[..., None], p - sd[..., None] * nt, cp)
    lead = dist.shape[:-2]
    flat = dist.reshape(lead + (-1,))
    sel = _top_k(-flat, k_out)
    dist_k = torch.take_along_dim(flat, sel, dim=-1)
    cp_k = torch.take_along_dim(cp.reshape(lead + (-1, 3)), sel[..., None], dim=-2)
    n_w = convex._rotate(xm_h, torch.take_along_dim(n.reshape(lead + (-1, 3)), sel[..., None], dim=-2))
    pos = xp_h[..., None, :] + convex._rotate(xm_h, cp_k) + 0.5 * dist_k[..., None] * n_w
    return dist_k, pos, _make_frame(n_w)


def _hfield_group(m: Model, d: Data, idx: np.ndarray, other_type: int, k_out: int):
    """Height field against spheres, capsules (3 spheres along the axis) or
    boxes (the 8 corners as points of radius 0) for the pairs `idx` of one
    group, batched over the pairs that share a field and a window size
    (pair_hfk). Returns (B, P, k_out) dist and its pos and frames."""
    s = m.skel
    gh, go = s.pair_geom1[idx], s.pair_geom2[idx]
    keys = [(int(s.geom_hfieldid[g]), int(s.pair_hfk[i])) for g, i in zip(gh, idx)]
    out = None
    for key in dict.fromkeys(keys):
        sub = np.array([j for j, k in enumerate(keys) if k == key])
        gh_s, go_s = device_index(gh[sub], d.qpos.device), device_index(go[sub], d.qpos.device)
        xp, xm, size = d.geom_xpos[:, go_s], d.geom_xmat[:, go_s], m.geom_size[go_s]
        if other_type == int(GeomType.SPHERE):
            centers, r = xp[..., None, :], size[:, 0]
        elif other_type == int(GeomType.CAPSULE):
            coef = xp.new_tensor([-1.0, 0.0, 1.0])[:, None] * size[:, 1, None, None]  # (P, 3, 1)
            centers, r = xp[..., None, :] + coef * xm[..., None, :, 2], size[:, 0]
        else:
            corners = device_index(_BOX_CORNERS, xp.device) * size[:, None, :]  # (P, 8, 3)
            centers, r = xp[..., None, :] + convex._rotate(xm, corners), torch.zeros_like(size[:, 0])
        res = _hfield_spheres(m, *key, d.geom_xpos[:, gh_s], d.geom_xmat[:, gh_s], centers, r, k_out)
        if len(sub) == len(idx):
            return res
        if out is None:
            out = [x.new_zeros(x.shape[:1] + (len(idx),) + x.shape[2:]) for x in res]
        for o, x in zip(out, res):
            o[:, device_index(sub, x.device)] = x
    return tuple(out)


# keyed by (type1, type2) with type1 <= type2, as the compiler orders pairs;
# the height-field pairs dispatch through _hfield_group, which reads the
# field's grid and the pairs' window sizes
_NARROWPHASE = {
    (int(GeomType.PLANE), int(GeomType.SPHERE)): (plane_sphere, 1),
    (int(GeomType.PLANE), int(GeomType.CAPSULE)): (plane_capsule, 2),
    (int(GeomType.PLANE), int(GeomType.BOX)): (plane_box, 4),
    (int(GeomType.SPHERE), int(GeomType.SPHERE)): (sphere_sphere, 1),
    (int(GeomType.SPHERE), int(GeomType.CAPSULE)): (sphere_capsule, 1),
    (int(GeomType.SPHERE), int(GeomType.BOX)): (sphere_box, 1),
    (int(GeomType.CAPSULE), int(GeomType.CAPSULE)): (capsule_capsule, 1),
    (int(GeomType.CAPSULE), int(GeomType.BOX)): (capsule_box, 3),
    (int(GeomType.BOX), int(GeomType.BOX)): (box_box, 8),
    (int(GeomType.PLANE), int(GeomType.CYLINDER)): (plane_cylinder, 4),
    (int(GeomType.PLANE), int(GeomType.ELLIPSOID)): (plane_ellipsoid, 1),
    (int(GeomType.PLANE), int(GeomType.MESH)): (plane_mesh, 4),
    (int(GeomType.SPHERE), int(GeomType.MESH)): (sphere_mesh, 1),
    (int(GeomType.CAPSULE), int(GeomType.MESH)): (capsule_mesh, 3),
    (int(GeomType.BOX), int(GeomType.MESH)): (box_mesh, 4),
    (int(GeomType.MESH), int(GeomType.MESH)): (mesh_mesh, 4),
    (int(GeomType.HFIELD), int(GeomType.SPHERE)): (None, 4),
    (int(GeomType.HFIELD), int(GeomType.CAPSULE)): (None, 4),
    (int(GeomType.HFIELD), int(GeomType.BOX)): (None, 4),
}


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, largest first and
    equal values lowest index first, as lax.top_k orders them. torch.topk
    promises no order among equal values (empty slots all sit at -_BIG), so
    this is a stable descending sort cut to k."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _broadphase(m: Model, d: Data, tkey, g1s: np.ndarray, g2s: np.ndarray, exp: np.ndarray, k: int):
    """(B, k) geom ids and explicit-pair ids of the k most-overlapping pairs
    of a capped group, by bounding-sphere (or plane half-space) distance
    minus the larger margin, or an explicit <pair>'s own margin."""
    dev = d.qpos.device
    g1, g2 = device_index(g1s, dev), device_index(g2s, dev)
    delta = d.geom_xpos[:, g2] - d.geom_xpos[:, g1]  # (B, P, 3)
    margin_ub = torch.maximum(m.geom_margin[g1], m.geom_margin[g2])
    if (exp >= 0).any():
        margin_ub = torch.where(device_index(exp >= 0, dev), m.pair_margin[device_index(np.maximum(exp, 0), dev)],
                                margin_ub)
    if tkey[0] == int(GeomType.PLANE):
        bound = (delta * d.geom_xmat[:, g1, :, 2]).sum(-1) - m.geom_rbound[g2]
    else:
        bound = torch.linalg.vector_norm(delta, dim=-1) - m.geom_rbound[g1] - m.geom_rbound[g2]
    sel = _top_k(-(bound - margin_ub), k)
    return g1[sel], g2[sel], device_index(exp, dev)[sel]


def _mesh_tuple(m: Model, g: torch.Tensor):
    """The hull arrays of geoms `g` ((P,) or (B, k) ids) by their mesh ids,
    in the order the mesh narrowphases take them."""
    s = m.skel
    meshid = device_index(s.geom_meshid, g.device)[g]
    vertnum = device_index(s.mesh_vertnum, g.device)[meshid]
    vert_mask = torch.arange(m.mesh_vert.shape[1], device=g.device) < vertnum[..., None]
    return (m.mesh_vert[meshid], vert_mask, m.mesh_face_normal[meshid], m.mesh_face_dist[meshid],
            m.mesh_face_vert[meshid], m.mesh_edge[meshid])


def _per_env_rows(leaf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Rows `g` ((P,) or (B, k) geom ids) of a (ngeom, w) leaf, or of a
    (B, ngeom, w) one that carries an env axis (domain randomization), each
    env's from its own rows."""
    if leaf.dim() == 2:
        return leaf[g]
    if g.dim() == 1:
        return leaf[:, g]
    return torch.take_along_dim(leaf, g[..., None], dim=1)


def _mix_params(m: Model, g1: torch.Tensor, g2: torch.Tensor):
    """Contact parameter mixing (mj_contactParam): priority wins, otherwise
    solmix-weighted solref/solimp and max friction; margins add; gap is the
    larger one."""
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    eq = p1 == p2
    sm1, sm2 = m.geom_solmix[g1], m.geom_solmix[g2]
    w1 = sm1 / torch.clamp(sm1 + sm2, min=1e-12)
    w1 = torch.where((sm1 >= 1e-12) & (sm2 < 1e-12), 1.0, w1)
    w1 = torch.where((sm1 < 1e-12) & (sm2 >= 1e-12), 0.0, w1)
    w1 = torch.where((sm1 < 1e-12) & (sm2 < 1e-12), 0.5, w1)
    w1 = torch.where(eq, w1, torch.where(p1 > p2, 1.0, 0.0))[..., None]

    sr1, sr2 = _per_env_rows(m.geom_solref, g1), _per_env_rows(m.geom_solref, g2)
    standard = (sr1[..., 0] > 0) & (sr2[..., 0] > 0)
    solref = torch.where(standard[..., None], w1 * sr1 + (1 - w1) * sr2, torch.minimum(sr1, sr2))
    solimp = w1 * _per_env_rows(m.geom_solimp, g1) + (1 - w1) * _per_env_rows(m.geom_solimp, g2)

    f1, f2 = _per_env_rows(m.geom_friction, g1), _per_env_rows(m.geom_friction, g2)
    fr = torch.where(eq[..., None], torch.maximum(f1, f2), torch.where((p1 > p2)[..., None], f1, f2))
    friction = torch.stack([fr[..., 0], fr[..., 0], fr[..., 1], fr[..., 2], fr[..., 2]], dim=-1)
    margin = m.geom_margin[g1] + m.geom_margin[g2]
    gap = torch.maximum(m.geom_gap[g1], m.geom_gap[g2])
    return friction, solref, solimp, margin, gap


def _contact_params(m: Model, g1: torch.Tensor, g2: torch.Tensor, exp: np.ndarray, exp_t: torch.Tensor):
    """(friction, solref, solimp, includemargin, gap) of pairs g1-g2: the
    mixed geom parameters, an explicit <pair>'s own where the pair has one
    (`exp` its static ids, `exp_t` those the pairs carry; JAX collision.py:
    779-792), and under the OVERRIDE flag the Option's o_* values for every
    pair, with includemargin o_margin and gap 0 (:794-808)."""
    friction, solref, solimp, margin, gap = _mix_params(m, g1, g2)
    if (exp >= 0).any():
        has, e = exp_t >= 0, torch.clamp(exp_t, min=0)
        friction = torch.where(has[..., None], m.pair_friction[e], friction)
        solref = torch.where(has[..., None], m.pair_solref[e], solref)
        solimp = torch.where(has[..., None], m.pair_solimp[e], solimp)
        margin = torch.where(has, m.pair_margin[e], margin)
        gap = torch.where(has, m.pair_gap[e], gap)
    if m.opt.enableflags & EnableBit.OVERRIDE:
        o = m.opt
        friction, solref, solimp = (x.to(margin.dtype).expand_as(y) for x, y in (
            (o.o_friction, friction), (o.o_solref, solref), (o.o_solimp, solimp)))
        margin, gap = o.o_margin.to(margin.dtype).expand_as(margin), torch.zeros_like(gap)
    return friction, solref, solimp, margin, gap


def collision(m: Model, d: Data) -> Data:
    """Narrowphase for every candidate pair group into its contact slots, then
    the row cap when the model has one."""
    s = m.skel
    if s.ncon == 0:
        return d
    dev = d.qpos.device
    B = d.qpos.shape[0]

    def ix(a):
        return device_index(a, dev)

    ncand = s.ncand
    dist_all = d.qpos.new_full((B, ncand), _BIG)
    pos_all = d.qpos.new_zeros((B, ncand, 3))
    frame_all = torch.eye(3, dtype=d.qpos.dtype, device=dev).expand(B, ncand, 3, 3).clone()
    fric_all = d.qpos.new_zeros((B, ncand, 5))
    solref_all = d.qpos.new_zeros((B, ncand, 2))
    solimp_all = d.qpos.new_zeros((B, ncand, 5))
    margin_all = d.qpos.new_zeros((B, ncand))
    gap_all = d.qpos.new_zeros((B, ncand))
    geom1_all = device_index(s.con_geom1, dev, torch.int32).expand(B, -1).clone()
    geom2_all = device_index(s.con_geom2, dev, torch.int32).expand(B, -1).clone()
    capped = {
        (int(t1), int(t2)): (int(adr), int(nsel))
        for t1, t2, adr, nsel in zip(s.bpg_type1, s.bpg_type2, s.bpg_adr, s.bpg_nsel)
    }

    groups: dict = {}
    for i in range(len(s.pair_geom1)):
        groups.setdefault((int(s.pair_ctype1[i]), int(s.pair_ctype2[i])), []).append(i)
    for tkey, idx_list in groups.items():
        fn, ncon_per = _NARROWPHASE[tkey]
        idx = np.array(idx_list, dtype=np.int32)
        exp = np.asarray(s.pair_explicit)[idx]  # each pair's explicit <pair> id, -1 for none
        if tkey in capped:
            adr, k = capped[tkey]
            g1, g2, exp_t = _broadphase(m, d, tkey, s.pair_geom1[idx], s.pair_geom2[idx], exp, k)  # (B, k)
            slots = ix(adr + np.arange(k * ncon_per))
            geom1_all[:, slots] = g1.repeat_interleave(ncon_per, dim=1).to(torch.int32)
            geom2_all[:, slots] = g2.repeat_interleave(ncon_per, dim=1).to(torch.int32)
            poses = [torch.take_along_dim(x, g[(...,) + (None,) * (x.dim() - 2)], dim=1)
                     for g in (g1, g2) for x in (d.geom_xpos, d.geom_xmat)]
        else:
            g1, g2, exp_t = ix(s.pair_geom1[idx]), ix(s.pair_geom2[idx]), ix(exp)  # (P,)
            slots = ix(np.concatenate([np.arange(ncon_per) + int(s.con_adr[i]) for i in idx]))
            poses = [x[:, g] for g in (g1, g2) for x in (d.geom_xpos, d.geom_xmat)]
        if tkey[0] == int(GeomType.HFIELD):
            dist, pos, frame = _hfield_group(m, d, idx, tkey[1], ncon_per)
        else:
            args = [poses[0], poses[1], m.geom_size[g1], poses[2], poses[3], m.geom_size[g2]]
            args += [_mesh_tuple(m, g) for t, g in zip(tkey, (g1, g2)) if t == int(GeomType.MESH)]
            dist, pos, frame = fn(*args)
        # each parameter's pairs' dim: (P, ...) static, (B, k, ...) capped or
        # per-env (a randomized geom_friction, solref or solimp), ahead of its own width
        friction, solref, solimp, margin, gap = (
            x.repeat_interleave(ncon_per, dim=x.dim() - 1 - w)
            for x, w in zip(_contact_params(m, g1, g2, exp, exp_t), (1, 1, 1, 0, 0))
        )
        dist_all[:, slots] = dist.reshape(B, -1)
        pos_all[:, slots] = pos.reshape(B, -1, 3)
        frame_all[:, slots] = frame.reshape(B, -1, 3, 3)
        fric_all[:, slots] = friction
        solref_all[:, slots] = solref
        solimp_all[:, slots] = solimp
        margin_all[:, slots] = margin  # includemargin
        gap_all[:, slots] = gap

    fields = [dist_all, pos_all, frame_all, fric_all, solref_all, solimp_all, margin_all, gap_all, geom1_all,
              geom2_all]
    if s.ncon < ncand:
        # global row cap (max_contact_points): keep the ncon candidates deepest
        # past their margin; empty slots sit at -_BIG and tie, lowest slot first
        sel = _top_k(margin_all - dist_all, s.ncon)  # (B, ncon)
        fields = [torch.take_along_dim(x, sel[(...,) + (None,) * (x.dim() - 2)], dim=1) for x in fields]
    names = ("dist", "pos", "frame", "friction", "solref", "solimp", "includemargin", "gap", "geom1", "geom2")
    return d.replace(contact=Contact(**dict(zip(names, fields))))


def geom_pair_distance(m: Model, d: Data, g1, g2):
    """Signed surface distance and closest points of static geom pairs, for
    every env (port of the JAX package's `geom_pair_distance`, batched).

    `g1`, `g2`: geom ids, two ints or two equal-length int arrays. Returns
    (dist, p1, p2), p1 on geom1's surface and p2 on geom2's: (B,), (B, 3),
    (B, 3) for ints, (B, P), (B, P, 3), (B, P, 3) for arrays. Pairs of one
    type pair share one batched narrowphase (the deepest of its contact
    points, ties to the first); a type pair outside the narrowphases (a
    height field, plane-plane) raises by name. Backs the <distance>,
    <normal> and <fromto> sensors (engine/sensor.py)."""
    s = m.skel
    dev = d.qpos.device
    scalar = np.ndim(g1) == 0
    g1 = np.atleast_1d(np.asarray(g1, np.int64))
    g2 = np.atleast_1d(np.asarray(g2, np.int64))
    types = np.asarray(s.geom_type)
    swap = types[g1] > types[g2]
    ga, gb = np.where(swap, g2, g1), np.where(swap, g1, g2)
    keys = list(zip(types[ga].tolist(), types[gb].tolist()))
    order, parts = [], []
    for key in dict.fromkeys(keys):
        fn = _NARROWPHASE.get(key, (None, 0))[0]
        if fn is None:
            raise NotImplementedError(
                f"distance sensor between geom types {GeomType(key[0]).name} and {GeomType(key[1]).name} "
                "is not supported")
        idx = np.array([i for i, k in enumerate(keys) if k == key])
        a, b = device_index(ga[idx], dev), device_index(gb[idx], dev)
        args = [d.geom_xpos[:, a], d.geom_xmat[:, a], m.geom_size[a], d.geom_xpos[:, b], d.geom_xmat[:, b],
                m.geom_size[b]]
        args += [_mesh_tuple(m, g) for t, g in zip(key, (a, b)) if t == int(GeomType.MESH)]
        dist, pos, frame = fn(*args)  # (B, P, k), (B, P, k, 3), (B, P, k, 3, 3)
        i = dist.argmin(-1)[..., None]
        di = torch.take_along_dim(dist, i, dim=-1)[..., 0]
        n = torch.take_along_dim(frame[..., 0, :], i[..., None], dim=-2)[..., 0, :]  # the normal, geom1 to geom2
        p = torch.take_along_dim(pos, i[..., None], dim=-2)[..., 0, :]
        half = n * (di * 0.5)[..., None]
        p1, p2 = p - half, p + half
        sw = device_index(swap[idx], dev)[:, None]
        parts.append((di, torch.where(sw, p2, p1), torch.where(sw, p1, p2)))
        order.append(idx)
    if len(parts) == 1:
        di, p1, p2 = parts[0]
    else:
        inv = device_index(np.argsort(np.concatenate(order)), dev)
        di, p1, p2 = (torch.cat(x, 1)[:, inv] for x in zip(*parts))
    return (di[:, 0], p1[:, 0], p2[:, 0]) if scalar else (di, p1, p2)
