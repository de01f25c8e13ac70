"""Convex-convex narrowphase: separating-axis test with a clipped contact
manifold, for box and mesh-hull geoms.

Port of ambersim_tpu/engine/convex.py (`box_hull`, `mesh_hull`,
`_seg_seg_closest`, `hull_hull`). The SAT runs over the complete axis set of the two polytopes
(all face normals and all edge-direction cross products), which is exact for
convex polytopes, with no data-dependent control flow. The manifold comes
from a flat, fully masked clip candidate set (incident face vertices inside
the reference face, reference vertices inside the incident face, incident
edge / reference side-plane crossings), reduced to `ncon` slots: the deepest
point, then points spread around the contact-plane compass.

Every tensor is batch-first over arbitrary leading dims. Products are
spelled as elementwise multiplies and sums and selections as index gathers,
never as matrix products, so no TF32 question arises on the card.
Mesh hulls come from the compiler, padded by repeating real geometry (the
last vertex of a face ring, the first face), so no reduction needs a mask.

Conventions match MuJoCo: the normal points from hull1 into hull2, the
contact position is the midpoint of the surface overlap, dist < 0 inside.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.engine.schedule import device_index

_BIG = 1e10


class Hull(NamedTuple):
    """World-frame convex polytope, batched over leading dims: verts
    (..., V, 3), outward unit face normals (..., F, 3), face rings CCW
    around their normal (..., F, FV, 3), edge segments (..., E, 2, 3)."""

    verts: torch.Tensor
    face_n: torch.Tensor
    face_v: torch.Tensor
    edge: torch.Tensor


# corner k = (sx, sy, sz) with k = 4*(x>0) + 2*(y>0) + (z>0), as collision._BOX_CORNERS
_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], dtype=np.float32
)
# face rings (CCW around the outward normal), one per +-x, +-y, +-z
_BOX_FACES = np.array(
    [[4, 6, 7, 5], [0, 1, 3, 2], [2, 3, 7, 6], [0, 4, 5, 1], [1, 5, 7, 3], [0, 2, 6, 4]], dtype=np.int64
)
_BOX_FACE_N = np.eye(3, dtype=np.float32)[[0, 0, 1, 1, 2, 2]] * np.array(
    [1.0, -1.0, 1.0, -1.0, 1.0, -1.0], dtype=np.float32
)[:, None]
_BOX_EDGES = np.array(
    [[0, 1], [2, 3], [4, 5], [6, 7], [0, 2], [1, 3], [4, 6], [5, 7], [0, 4], [1, 5], [2, 6], [3, 7]],
    dtype=np.int64,
)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _rotate(xm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """xm (..., 3, 3) applied to points v (..., K, 3) -> (..., K, 3)."""
    return (xm[..., None, :, :] * v[..., :, None, :]).sum(-1)


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x's entries at idx (..., ) along `dim` (counted from the end), with
    that dim dropped."""
    trailing = -dim - 1
    out = torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (trailing + 1)), dim=dim)
    return out.squeeze(dim)


def box_hull(xp: torch.Tensor, xm: torch.Tensor, size: torch.Tensor) -> Hull:
    """Hull view of a box geom: 8 verts, 6 faces, 12 edges."""
    dev = xp.device
    verts = xp[..., None, :] + _rotate(xm, device_index(_BOX_CORNERS, dev) * size[..., None, :])
    face_n = _rotate(xm, device_index(_BOX_FACE_N, dev))
    face_v = verts[..., device_index(_BOX_FACES, dev), :]  # (..., 6, 4, 3)
    edge = verts[..., device_index(_BOX_EDGES, dev), :]  # (..., 12, 2, 3)
    return Hull(verts, face_n, face_v, edge)


def mesh_hull(xp: torch.Tensor, xm: torch.Tensor, verts_l, face_n_l, face_v_l, edge_l) -> Hull:
    """Hull view of a mesh geom from its compiled local-frame hull: verts
    (..., V, 3), face normals (..., F, 3), face rings (..., F, FV, 3) and
    edges (..., E, 2, 3), posed by xp (..., 3) and xm (..., 3, 3)."""
    fv_shape, e_shape = face_v_l.shape, edge_l.shape
    face_v = xp[..., None, :] + _rotate(xm, face_v_l.reshape(fv_shape[:-3] + (-1, 3)))
    edge = xp[..., None, :] + _rotate(xm, edge_l.reshape(e_shape[:-3] + (-1, 3)))
    return Hull(xp[..., None, :] + _rotate(xm, verts_l), _rotate(xm, face_n_l),
                face_v.reshape(face_v.shape[:-2] + fv_shape[-3:]), edge.reshape(edge.shape[:-2] + e_shape[-3:]))


def _pad_ring(fv: torch.Tensor, width: int) -> torch.Tensor:
    """A face ring (..., FV, 3) padded to `width` vertices by repeating its
    last one (a degenerate edge, harmless to the clip)."""
    extra = width - fv.shape[-2]
    if extra <= 0:
        return fv
    return torch.cat([fv, fv[..., -1:, :].expand(fv.shape[:-2] + (extra, 3))], dim=-2)


def _seg_seg_closest(a0, a1, b0, b1):
    """Closest points between segments [a0, a1] and [b0, b1], branch-free."""
    da, db, r = a1 - a0, b1 - b0, b0 - a0
    aa, bb, ab = _dot(da, da), _dot(db, db), _dot(da, db)
    ar, br = _dot(da, r), _dot(db, r)
    den = aa * bb - ab * ab
    safe = den.abs() > 1e-12
    t = torch.where(safe, (ar * bb - br * ab) / torch.where(safe, den, 1.0), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    u = torch.where(bb > 1e-12, (t * ab - br) / torch.clamp(bb, min=1e-12), 0.0)
    u = torch.clamp(u, 0.0, 1.0)
    t = torch.where(aa > 1e-12, (u * ab + ar) / torch.clamp(aa, min=1e-12), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return a0 + t[..., None] * da, b0 + u[..., None] * db


def _side_planes(ring: torch.Tensor, fn_own: torch.Tensor) -> torch.Tensor:
    """Inward side-plane normals of a ring: face_n x (v_{k+1} - v_k)."""
    ev = torch.roll(ring, -1, dims=-2) - ring
    return am.cross(fn_own[..., None, :], ev)


def _inside(pts, ring, sn, tol):
    """pts (..., K, 3) inside every side plane (..., FV, 3) of a ring, up to
    tol times each plane normal's length."""
    dd = ((pts[..., :, None, :] - ring[..., None, :, :]) * sn[..., None, :, :]).sum(-1)  # (..., K, FV)
    slack = tol[..., None, None] * torch.clamp(torch.linalg.vector_norm(sn, dim=-1), min=1e-12)[..., None, :]
    return (dd >= -slack).all(-1)


def hull_hull(h1: Hull, h2: Hull, ncon: int):
    """SAT narrowphase between two convex polytopes. Returns dist (..., ncon),
    pos (..., ncon, 3) and the normal n (..., 3) from hull1 into hull2;
    unused slots carry dist = +_BIG."""
    from ambersim_tpu_torch.engine.collision import _make_frame

    F1, F2 = h1.face_n.shape[-2], h2.face_n.shape[-2]
    E1, E2 = h1.edge.shape[-3], h2.edge.shape[-3]
    cdir = h2.verts.mean(-2) - h1.verts.mean(-2)

    # ---- axis set: face normals (oriented 1 -> 2) and edge-cross axes ----
    e1d = h1.edge[..., 1, :] - h1.edge[..., 0, :]
    e2d = h2.edge[..., 1, :] - h2.edge[..., 0, :]
    cr = am.cross(e1d[..., :, None, :], e2d[..., None, :, :])
    cr = cr.reshape(cr.shape[:-3] + (E1 * E2, 3))
    crn = torch.linalg.vector_norm(cr, dim=-1)
    cr_ok = crn > 1e-8
    cr = cr / torch.clamp(crn, min=1e-12)[..., None]
    axes = torch.cat([h1.face_n, -h2.face_n, cr], dim=-2)  # (..., A, 3)
    axes = torch.where((_dot(axes, cdir[..., None, :]) < 0)[..., None], -axes, axes)

    # ---- support values along every axis ----
    d1 = _dot(axes[..., :, None, :], h1.verts[..., None, :, :])  # (..., A, V1)
    d2 = _dot(axes[..., :, None, :], h2.verts[..., None, :, :])
    sep = d2.amin(-1) - d1.amax(-1)  # > 0: disjoint along the axis
    valid = torch.cat([torch.ones_like(cr_ok[..., :1]).expand(cr_ok.shape[:-1] + (F1 + F2,)), cr_ok], dim=-1)
    sep = torch.where(valid, sep, -_BIG)

    # best face and best edge axis; an edge axis wins only when decisively better
    sep_f, sep_e = sep[..., : F1 + F2], sep[..., F1 + F2 :]
    bf, be = sep_f.argmax(-1), sep_e.argmax(-1)
    best_f, best_e = _take(sep_f, bf, -1), _take(sep_e, be, -1)
    use_edge = best_e > best_f + torch.clamp(1e-3 * best_f.abs(), min=1e-7)
    dist0 = torch.where(use_edge, best_e, best_f)
    bidx = torch.where(use_edge, be + F1 + F2, bf)
    n = _take(axes, bidx, -2)  # (..., 3)

    # ================= face-case manifold =================
    # the reference face lives on hull1 iff the winning face axis is hull1's;
    # each hull's ring is its face most aligned with n as seen from that hull
    # (the reference's rf = if selection). Rings of unequal width (a box's
    # four against a mesh face's) are padded to the wider one.
    on1 = bf < F1
    if1 = _dot(h1.face_n, n[..., None, :]).argmax(-1)
    if2 = _dot(h2.face_n, n[..., None, :]).argmin(-1)
    fvw = max(h1.face_v.shape[-2], h2.face_v.shape[-2])
    fv1, fn1 = _pad_ring(_take(h1.face_v, if1, -3), fvw), _take(h1.face_n, if1, -2)
    fv2, fn2 = _pad_ring(_take(h2.face_v, if2, -3), fvw), _take(h2.face_n, if2, -2)
    sel = on1[..., None, None]
    ref_v, inc_v = torch.where(sel, fv1, fv2), torch.where(sel, fv2, fv1)
    ref_n_own = torch.where(on1[..., None], fn1, fn2)
    inc_n_own = torch.where(on1[..., None], fn2, fn1)
    FV_r, FV_i = ref_v.shape[-2], inc_v.shape[-2]
    ref_sn, inc_sn = _side_planes(ref_v, ref_n_own), _side_planes(inc_v, inc_n_own)
    tol = 1e-6 + 1e-6 * ref_v.abs().amax(dim=(-2, -1))

    ok_iv = _inside(inc_v, ref_v, ref_sn, tol)
    ok_rv = _inside(ref_v, inc_v, inc_sn, tol)
    # incident ring edges against each reference side plane (plane k through ref_v[k])
    inc_a, inc_e = inc_v, torch.roll(inc_v, -1, dims=-2) - inc_v
    num = (ref_sn[..., None, :, :] * (ref_v[..., None, :, :] - inc_a[..., :, None, :])).sum(-1)  # (..., FV_i, FV_r)
    den = (ref_sn[..., None, :, :] * inc_e[..., :, None, :]).sum(-1)
    t_ok = den.abs() > 1e-12
    t = torch.where(t_ok, num / torch.where(t_ok, den, 1.0), -1.0)
    cross_pt = inc_a[..., :, None, :] + t[..., None] * inc_e[..., :, None, :]
    cross_pt = cross_pt.reshape(cross_pt.shape[:-3] + (FV_i * FV_r, 3))
    t_flat = t.reshape(t.shape[:-2] + (FV_i * FV_r,))
    ok_cross = (t_flat >= 0.0) & (t_flat <= 1.0) & _inside(cross_pt, ref_v, ref_sn, tol)
    cand = torch.cat([inc_v, ref_v, cross_pt], dim=-2)  # (..., C, 3)
    ok = torch.cat([ok_iv, ok_rv, ok_cross], dim=-1)

    # per-candidate depth: project along n onto each hull's face plane
    plane1_n = torch.where(on1[..., None], ref_n_own, inc_n_own)
    plane2_n = torch.where(on1[..., None], inc_n_own, ref_n_own)
    p1_anchor = torch.where(on1[..., None], ref_v[..., 0, :], inc_v[..., 0, :])
    p2_anchor = torch.where(on1[..., None], inc_v[..., 0, :], ref_v[..., 0, :])

    def line_plane_t(pn, pa):
        dn = _dot(pn, n)
        dn = torch.where(dn.abs() > 1e-6, dn, torch.where(dn >= 0, 1e-6, -1e-6))
        return _dot(pa[..., None, :] - cand, pn[..., None, :]) / dn[..., None]

    t1, t2 = line_plane_t(plane1_n, p1_anchor), line_plane_t(plane2_n, p2_anchor)
    cpos = cand + (0.5 * (t1 + t2))[..., None] * n[..., None, :]
    cdist = torch.where(ok, t2 - t1, _BIG)  # gap along n, hull2 surface minus hull1's

    # ---- manifold reduction: slot 0 the deepest, the others spread around
    # the contact-plane compass, softly biased toward depth ----
    frame_n = _make_frame(n)
    tan1, tan2 = frame_n[..., 1, :], frame_n[..., 2, :]
    sel_idx = [cdist.argmin(-1)]
    for k in range(1, ncon):
        ang = 2.0 * math.pi * k / max(ncon - 1, 1)
        uvec = float(np.cos(ang)) * tan1 + float(np.sin(ang)) * tan2
        score = torch.where(ok, _dot(cand, uvec[..., None, :]) - 0.5 * cdist, -_BIG)
        sel_idx.append(score.argmax(-1))
    sel_idx = torch.stack(sel_idx, dim=-1)  # (..., ncon)
    face_dist = torch.take_along_dim(cdist, sel_idx, dim=-1)
    face_pos = torch.take_along_dim(cpos, sel_idx[..., None], dim=-2)
    any_ok = ok.any(-1)

    # ================= edge-case manifold =================
    # the supporting edge pair along n: hull1's edge of max midpoint support,
    # hull2's of min
    e1i = _dot(0.5 * (h1.edge[..., 0, :] + h1.edge[..., 1, :]), n[..., None, :]).argmax(-1)
    e2i = _dot(0.5 * (h2.edge[..., 0, :] + h2.edge[..., 1, :]), n[..., None, :]).argmin(-1)
    a, b = _take(h1.edge, e1i, -3), _take(h2.edge, e2i, -3)
    p_e, q_e = _seg_seg_closest(a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :])
    edge_pos = 0.5 * (p_e + q_e)

    # ================= support-point fallback =================
    sp1 = _take(h1.verts, _take(d1, bidx, -2).argmax(-1), -2)
    sp2 = _take(h2.verts, _take(d2, bidx, -2).argmin(-1), -2)
    fb_pos = 0.5 * (sp1 + sp2)

    # ================= combine =================
    use_face = (~use_edge) & any_ok
    pos0 = torch.where(use_edge[..., None], edge_pos, torch.where(any_ok[..., None], face_pos[..., 0, :], fb_pos))
    d0 = torch.where(use_edge, dist0, torch.where(any_ok, face_dist[..., 0], dist0))
    dist = torch.cat([d0[..., None], torch.where(use_face[..., None], face_dist[..., 1:], _BIG)], dim=-1)
    pos = torch.cat([pos0[..., None, :], torch.where(use_face[..., None, None], face_pos[..., 1:, :], 0.0)], dim=-2)

    # dedup: the spread selection can pick one candidate for several slots
    dtol = 1e-6 + 1e-5 * ref_v.abs().amax(dim=(-2, -1))
    for k in range(1, ncon):
        dup = torch.zeros_like(use_face)
        for j in range(k):
            near = torch.linalg.vector_norm(pos[..., k, :] - pos[..., j, :], dim=-1) < dtol
            dup = dup | (near & (dist[..., j] < _BIG * 0.5))
        dist[..., k] = torch.where(dup, _BIG, dist[..., k])
    return dist, pos, n
