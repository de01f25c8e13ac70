"""Batched collision over the model's static candidate pairs: the plane
against sphere, capsule and box (every quadruped geom pair). Port of
ambersim_tpu/engine/collision.py (_make_frame, the plane narrowphases,
_mix_params and the static-pair branch of `collision`).

Each geom-type pair group runs one batched narrowphase and writes fixed
contact slots; "no contact" is dist > includemargin, masked downstream.
Contact frame rows are (normal, tangent1, tangent2), normal from geom1 to
geom2, as in MuJoCo.
"""

from __future__ import annotations

import numpy as np
import torch

from ambersim_tpu_torch.core import math as am
from ambersim_tpu_torch.core.types import Contact, Data, GeomType, Model
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


_NARROWPHASE = {
    (int(GeomType.PLANE), int(GeomType.SPHERE)): (plane_sphere, 1),
    (int(GeomType.PLANE), int(GeomType.CAPSULE)): (plane_capsule, 2),
    (int(GeomType.PLANE), int(GeomType.BOX)): (plane_box, 4),
}


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

    sr1, sr2 = m.geom_solref[g1], m.geom_solref[g2]
    standard = (sr1[..., 0] > 0) & (sr2[..., 0] > 0)
    solref = torch.where(standard[..., None], w1 * sr1 + (1 - w1) * sr2, torch.minimum(sr1, sr2))
    solimp = w1 * m.geom_solimp[g1] + (1 - w1) * m.geom_solimp[g2]

    f1, f2 = m.geom_friction[g1], m.geom_friction[g2]
    fr = torch.where(eq[..., None], torch.maximum(f1, f2), torch.where((p1 > p2)[..., None], f1, f2))
    friction = torch.stack([fr[..., 0], fr[..., 0], fr[..., 1], fr[..., 2], fr[..., 2]], dim=-1)
    margin = m.geom_margin[g1] + m.geom_margin[g2]
    gap = torch.maximum(m.geom_gap[g1], m.geom_gap[g2])
    return friction, solref, solimp, margin, gap


def collision(m: Model, d: Data) -> Data:
    """Narrowphase for every static candidate pair into its contact slots."""
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
    frame_all = torch.eye(3, device=dev).expand(B, ncand, 3, 3).clone()
    fric_all = d.qpos.new_zeros((B, ncand, 5))
    solref_all = d.qpos.new_zeros((B, ncand, 2))
    solimp_all = d.qpos.new_zeros((B, ncand, 5))
    margin_all = d.qpos.new_zeros((B, ncand))
    gap_all = d.qpos.new_zeros((B, ncand))

    groups: dict = {}
    for i in range(len(s.pair_geom1)):
        groups.setdefault((int(s.pair_ctype1[i]), int(s.pair_ctype2[i])), []).append(i)
    for tkey, idx_list in groups.items():
        fn, ncon_per = _NARROWPHASE[tkey]
        idx = np.array(idx_list, dtype=np.int32)
        g1, g2 = ix(s.pair_geom1[idx]), ix(s.pair_geom2[idx])
        slots = ix(np.concatenate([np.arange(ncon_per) + int(s.con_adr[i]) for i in idx]))
        dist, pos, frame = fn(
            d.geom_xpos[:, g1], d.geom_xmat[:, g1], m.geom_size[g1],
            d.geom_xpos[:, g2], d.geom_xmat[:, g2], m.geom_size[g2],
        )
        friction, solref, solimp, margin, gap = _mix_params(m, g1, g2)
        dist_all[:, slots] = dist.reshape(B, -1)
        pos_all[:, slots] = pos.reshape(B, -1, 3)
        frame_all[:, slots] = frame.reshape(B, -1, 3, 3)
        fric_all[:, slots] = friction.repeat_interleave(ncon_per, dim=0)
        solref_all[:, slots] = solref.repeat_interleave(ncon_per, dim=0)
        solimp_all[:, slots] = solimp.repeat_interleave(ncon_per, dim=0)
        margin_all[:, slots] = margin.repeat_interleave(ncon_per, dim=0)  # includemargin
        gap_all[:, slots] = gap.repeat_interleave(ncon_per, dim=0)

    contact = Contact(
        dist=dist_all,
        pos=pos_all,
        frame=frame_all,
        friction=fric_all,
        solref=solref_all,
        solimp=solimp_all,
        includemargin=margin_all,
        gap=gap_all,
        geom1=d.contact.geom1,
        geom2=d.contact.geom2,
    )
    return d.replace(contact=contact)
