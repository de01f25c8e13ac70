"""Mesh loading, convex hulls, connected components, signed distance.

Covers the roles of trimesh (mesh I/O + hulls) and libigl (signed distance)
in the reference's pipeline (reference: ambersim/utils/conversion_utils.py:
69-81, tests/test_model_io.py:168-178), using only numpy + scipy.

The port's copy of ambersim_tpu/mjcf/mesh.py, the same code, so that the
port compiles models where JAX is not installed; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.spatial import ConvexHull


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ loader: vertices (n, 3) float64, faces (m, 3) int (triangulated)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def convex_hull(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(hull vertices, hull faces) with outward-oriented triangles."""
    hull = ConvexHull(verts)
    used = np.unique(hull.simplices)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    hverts = verts[used]
    hfaces = remap[hull.simplices]
    # orient faces outward (Qhull equations give outward normals)
    centroid = hverts.mean(axis=0)
    for i, face in enumerate(hfaces):
        a, b, c = hverts[face]
        n = np.cross(b - a, c - a)
        if np.dot(n, a - centroid) < 0:
            hfaces[i] = face[::-1]
    return hverts, hfaces


def decimate_hull(hverts: np.ndarray, max_verts: int) -> np.ndarray:
    """Subset of <= max_verts hull vertices approximating the hull well.

    Compile-time vertex budget for the SAT narrowphase (the role MJX's
    maxhullvert cap plays in the convex pipeline cited at reference
    ambersim/utils/io_utils.py:230-233): SAT axis count grows O(E1*E2) and
    support evaluation O(A*V), so unbounded scanned-mesh hulls would cliff.

    Greedy incremental refinement: seed with the 6 axis-extreme points, then
    repeatedly add the input vertex farthest OUTSIDE the current sub-hull
    (max plane violation over Qhull facet equations). Each step maximally
    reduces the worst Hausdorff error, so the budgeted hull hugs the true
    hull tightly; exact when len(hverts) <= max_verts (returned unchanged).
    """
    n = len(hverts)
    if n <= max_verts:
        return hverts
    if max_verts < 4:
        raise ValueError(f"maxhullvert must be >= 4, got {max_verts}")
    selected: List[int] = []
    for axis in range(3):
        for pick in (np.argmin, np.argmax):
            i = int(pick(hverts[:, axis]))
            if i not in selected:
                selected.append(i)
    # degenerate seeds (coplanar extremes) are fixed by the greedy loop's
    # QJ-jittered hull below
    while len(selected) < max_verts:
        try:
            sub = ConvexHull(hverts[selected])
            eqs = sub.equations  # (nf, 4): n.x + d <= 0 inside
        except Exception:
            sub = ConvexHull(hverts[selected], qhull_options="QJ")
            eqs = sub.equations
        # violation of each candidate vs the sub-hull
        viol = (hverts @ eqs[:, :3].T + eqs[None, :, 3]).max(axis=1)
        viol[selected] = -np.inf
        j = int(np.argmax(viol))
        if viol[j] <= 1e-12:
            break  # sub-hull already contains every input vertex
        selected.append(j)
    return hverts[np.asarray(selected)]


def connected_components(verts: np.ndarray, faces: np.ndarray) -> List[np.ndarray]:
    """Face index groups of topologically connected submeshes."""
    parent = np.arange(len(verts))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for f in faces:
        a = find(f[0])
        for v in f[1:]:
            parent[find(v)] = a
    roots = np.array([find(f[0]) for f in faces])
    groups = []
    for r in np.unique(roots):
        groups.append(np.nonzero(roots == r)[0])
    return groups


def signed_distance(points: np.ndarray, verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Signed distance of points to a CONVEX mesh (negative inside).

    For a convex mesh, sd(p) = max over faces of the signed plane distance
    when inside; for outside points we fall back to exact distance to the
    hull surface via face-plane clamping. Adequate for the decomposition
    parity tests (the reference uses libigl's generic signed distance:
    tests/test_model_io.py:176-178).
    """
    normals = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]])
    normals = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-15)
    offsets = np.einsum("fi,fi->f", normals, verts[faces[:, 0]])
    plane_d = points @ normals.T - offsets  # (npoint, nface)
    inside_sd = plane_d.max(axis=1)  # negative inside (all planes behind)
    out = np.empty(len(points))
    for i, p in enumerate(points):
        if inside_sd[i] <= 0:
            out[i] = inside_sd[i]
            continue
        # outside: exact distance to the triangle set
        out[i] = np.sqrt(min(_point_tri_d2(p, verts[f]) for f in faces))
    return out


def _point_tri_d2(p: np.ndarray, tri: np.ndarray) -> float:
    a, b, c = tri
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = ab @ ap, ac @ ap
    if d1 <= 0 and d2 <= 0:
        return float(ap @ ap)
    bp = p - b
    d3, d4 = ab @ bp, ac @ bp
    if d3 >= 0 and d4 <= d3:
        return float(bp @ bp)
    vc = d1 * d4 - d3 * d2
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        t = d1 / (d1 - d3)
        q = a + t * ab
        return float((p - q) @ (p - q))
    cp = p - c
    d5, d6 = ab @ cp, ac @ cp
    if d6 >= 0 and d5 <= d6:
        return float(cp @ cp)
    vb = d5 * d2 - d1 * d6
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        t = d2 / (d2 - d6)
        q = a + t * ac
        return float((p - q) @ (p - q))
    va = d3 * d6 - d5 * d4
    if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
        t = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        q = b + t * (c - b)
        return float((p - q) @ (p - q))
    denom = 1.0 / (va + vb + vc)
    v = vb * denom
    w = vc * denom
    q = a + ab * v + ac * w
    return float((p - q) @ (p - q))


def hull_mass_properties(verts: np.ndarray, faces: np.ndarray):
    """Exact volume, centroid, and inertia (about centroid, unit density) of a
    closed triangulated polyhedron (Eberly's polyhedral mass properties)."""
    intg = np.zeros(10)  # 1, x, y, z, x^2, y^2, z^2, xy, yz, zx

    def subexpr(w0, w1, w2):
        t0 = w0 + w1
        f1 = t0 + w2
        t1 = w0 * w0
        t2 = t1 + w1 * t0
        f2 = t2 + w2 * f1
        f3 = w0 * t1 + w1 * t2 + w2 * f2
        g0 = f2 + w0 * (f1 + w0)
        g1 = f2 + w1 * (f1 + w1)
        g2 = f2 + w2 * (f1 + w2)
        return f1, f2, f3, g0, g1, g2

    for tri in faces:
        p0, p1, p2 = verts[tri[0]], verts[tri[1]], verts[tri[2]]
        d = np.cross(p1 - p0, p2 - p0)
        x0, y0, z0 = p0
        x1, y1, z1 = p1
        x2, y2, z2 = p2
        f1x, f2x, f3x, g0x, g1x, g2x = subexpr(x0, x1, x2)
        f1y, f2y, f3y, g0y, g1y, g2y = subexpr(y0, y1, y2)
        f1z, f2z, f3z, g0z, g1z, g2z = subexpr(z0, z1, z2)
        intg[0] += d[0] * f1x
        intg[1] += d[0] * f2x
        intg[2] += d[1] * f2y
        intg[3] += d[2] * f2z
        intg[4] += d[0] * f3x
        intg[5] += d[1] * f3y
        intg[6] += d[2] * f3z
        intg[7] += d[0] * (y0 * g0x + y1 * g1x + y2 * g2x)
        intg[8] += d[1] * (z0 * g0y + z1 * g1y + z2 * g2y)
        intg[9] += d[2] * (x0 * g0z + x1 * g1z + x2 * g2z)
    intg *= np.array([1 / 6, 1 / 24, 1 / 24, 1 / 24, 1 / 60, 1 / 60, 1 / 60, 1 / 120, 1 / 120, 1 / 120])
    volume = intg[0]
    com = intg[1:4] / max(volume, 1e-15)
    # inertia about com (unit density)
    ixx = intg[5] + intg[6] - volume * (com[1] ** 2 + com[2] ** 2)
    iyy = intg[4] + intg[6] - volume * (com[2] ** 2 + com[0] ** 2)
    izz = intg[4] + intg[5] - volume * (com[0] ** 2 + com[1] ** 2)
    ixy = -(intg[7] - volume * com[0] * com[1])
    iyz = -(intg[8] - volume * com[1] * com[2])
    ixz = -(intg[9] - volume * com[2] * com[0])
    imat = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    return volume, com, imat


def hull_topology(hverts: np.ndarray, hfaces: np.ndarray):
    """Merged polygon topology of a convex hull, for SAT narrowphase.

    Qhull emits simplicial (triangle) facets; coplanar triangles are merged
    into convex polygon faces so face normals form a minimal SAT axis set and
    face polygons form proper contact-manifold clip regions.

    Returns (face_normal (F, 3), face_dist (F,), face_polys: list of ordered
    vertex-index rings, edges (E, 2) unique undirected vertex-index pairs).
    """
    n = np.cross(
        hverts[hfaces[:, 1]] - hverts[hfaces[:, 0]], hverts[hfaces[:, 2]] - hverts[hfaces[:, 0]]
    )
    norms = np.linalg.norm(n, axis=1, keepdims=True)
    keep = norms[:, 0] > 1e-12 * max(1.0, float(np.abs(hverts).max()) ** 2)
    hfaces, n, norms = hfaces[keep], n[keep], norms[keep]
    n = n / norms
    d = np.einsum("fi,fi->f", n, hverts[hfaces[:, 0]])
    scale = max(1.0, float(np.abs(hverts).max()))

    groups: List[List[int]] = []
    gkeys: List[Tuple[np.ndarray, float]] = []
    for f in range(len(hfaces)):
        placed = False
        for g, (gn, gd) in enumerate(gkeys):
            if np.dot(gn, n[f]) > 1.0 - 1e-6 and abs(gd - d[f]) < 1e-6 * scale:
                groups[g].append(f)
                placed = True
                break
        if not placed:
            groups.append([f])
            gkeys.append((n[f], d[f]))

    face_normal, face_dist, face_polys = [], [], []
    for g, fids in enumerate(groups):
        gn, gd = gkeys[g]
        vids = np.unique(hfaces[fids].ravel())
        pts = hverts[vids]
        center = pts.mean(axis=0)
        # in-plane basis
        ref = np.array([1.0, 0, 0]) if abs(gn[0]) < 0.9 else np.array([0.0, 1, 0])
        t1 = np.cross(gn, ref)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(gn, t1)
        ang = np.arctan2((pts - center) @ t2, (pts - center) @ t1)
        ring = vids[np.argsort(ang)]
        face_normal.append(gn)
        face_dist.append(gd)
        face_polys.append(ring)

    edges = set()
    for ring in face_polys:
        for i in range(len(ring)):
            a, b = int(ring[i]), int(ring[(i + 1) % len(ring)])
            edges.add((min(a, b), max(a, b)))
    return (
        np.asarray(face_normal, np.float64),
        np.asarray(face_dist, np.float64),
        face_polys,
        np.asarray(sorted(edges), np.int64).reshape(-1, 2),
    )
