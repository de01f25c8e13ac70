"""The port's height-field narrowphase (engine/collision.py: _hfield_group,
_hfield_spheres, _hfield_window_tris, _closest_on_triangle) against the
JAX package's (CPU, jitted and vmapped over envs), then the whole
collision and a PD rollout of the terrain quadruped.

Grids: tests/test_hfield.py's 9 x 9 wavy and bowl fields (size 1 1 0.3),
a flat one (every candidate of a window ties), and quadruped_terrain's
24 x 24 field at terrain_seed 3 (size 6 6 0.05) with its 17 pairs. The
9 x 9 scene holds a sphere, a capsule and a box, whose pairs get windows
of K = 3, 4 and 4. Poses are drawn by numpy from a seed: positions over
and past the field's edge (clamped windows), heights from below the
surface to above it (pushed-up and ignored candidates, and slots filled
by ignored ones when fewer than 4 are valid), random orientations; and
centers on grid vertices (_poses). Each env's window at points exactly on
cell borders is held bit for bit by test_hfield_window_on_cell_borders.

Bars: dist, pos and frame at rtol/atol 1e-5, as
tests/test_torch_mesh_pairs.py. A center on a grid vertex lies in the
column of the six triangles around it, and each pushes it up by the same
depth up to rounding, which the two packages sum in other orders: which
of those tied candidates the 4 slots take is rounding. So dist is held
slot by slot, and each slot's (dist, pos, frame) must be one of the JAX
package's candidates of that pair (its narrowphase run with every
candidate kept, deepest first) within the bars; a slot filled by an
ignored candidate by its dist alone (1e10 on both: the slot is never
active, and its pos, the surface point plus 0.5e10 x the normal, is
float32 noise of that product). The frame's normal, a difference of
points over its length where the center is not pushed up, rounds by
u |pos| / |dist + r| (u = 2^-24, r the sphere's radius): so it is held at
TOL plus 8 times that (and pos, the surface point plus dist / 2 x the
normal, at TOL plus |dist| / 2 times that), as
tests/test_torch_capsule_pairs.py holds capsule-box where the segment
meets the box; the tangents likewise where that bar leaves the frame's
reference axis decided (| |n_x| - |n_y| | above 10 times it; elsewhere a
rounding picks the other axis), and every frame orthonormal. The
rollout: 16 envs x 20 steps of the main path's PD controller at qpos
1e-4 / qvel 1e-3, as tests/test_torch_rollout.py.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_mesh_pairs import _rot
from tools import torch_parity as tp

TOL = 1e-5
B = 64  # envs of seeded poses per case
BIG = 1e10

HFIELD_SCENE = """
<mujoco><option timestep="0.002"/>
  <asset><hfield name="terrain" nrow="9" ncol="9" size="1 1 0.3 0.1"/></asset>
  <worldbody>
    <geom name="hf" type="hfield" hfield="terrain"/>
    <body pos="0 0 0.5"><freejoint/><geom name="s" type="sphere" size="0.08"/></body>
    <body pos="0.3 0 0.5"><freejoint/><geom name="c" type="capsule" size="0.05 0.15"/></body>
    <body pos="-0.3 0 0.5"><freejoint/><geom name="b" type="box" size="0.1 0.08 0.05"/></body>
  </worldbody>
</mujoco>
"""


def _wavy():
    return (0.5 + 0.5 * np.sin(np.linspace(0, 6, 81))).reshape(9, 9)


def _bowl():
    gx, gy = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 9))
    return (gx**2 + gy**2) / 2.0


GRIDS = {"wavy": _wavy, "bowl": _bowl, "flat": lambda: np.zeros((9, 9))}


def _terrain_jax_model():
    from ambersim_tpu.rl.quadruped.terrain import QuadrupedTerrainConfig, _build_terrain_model

    return _build_terrain_model(QuadrupedTerrainConfig(terrain_seed=3))


_MODELS: dict = {}


def _models(grid: str):
    """(JAX model, port model) of the 9 x 9 scene on `grid`, or of the
    terrain quadruped; built once per module."""
    if grid not in _MODELS:
        if grid == "terrain":
            jm = _terrain_jax_model()
        else:
            jm = tp.jax_model_from_xml(HFIELD_SCENE)
            jm = jm.replace(hfield_data=GRIDS[grid]().reshape(1, 9, 9).astype(np.float32))
        _MODELS[grid] = (jm, tp.torch_model(jm))
    return _MODELS[grid]


def _surface(jm, x, y):
    """The field's height at the grid vertex nearest (x, y) (field at the origin)."""
    size = np.asarray(jm.hfield_size[0])
    nrow, ncol = int(jm.skel.hfield_nrow[0]), int(jm.skel.hfield_ncol[0])
    i = np.clip(np.round((x + size[0]) / (2 * size[0] / (ncol - 1))).astype(int), 0, ncol - 1)
    j = np.clip(np.round((y + size[1]) / (2 * size[1] / (nrow - 1))).astype(int), 0, nrow - 1)
    return np.asarray(jm.hfield_data[0])[j, i] * size[2]


def _poses(jm, seed: int):
    """(B, ngeom, 3) geom_xpos and (B, ngeom, 3, 3) geom_xmat: the field at
    the origin, every other geom at a seeded pose near the surface; the
    first quarter of the envs with centers on grid vertices: exactly where
    the spacing is a power of two (the 9 x 9 fields' 0.25, whose products
    round nowhere), (1e-3, 3e-3) x dx past them where it is not (the terrain's
    12 / 23: there a point exactly on a triangle's edge is inside or not
    by the last bit of a product that XLA contracts into an FMA, and
    test_hfield_window_on_cell_borders holds the exact borders)."""
    rng = np.random.default_rng(seed)
    s = jm.skel
    size = np.asarray(jm.hfield_size[0])
    ncol = int(s.hfield_ncol[0])
    ng = s.ngeom
    xpos = np.zeros((B, ng, 3), np.float32)
    xmat = np.tile(np.eye(3, dtype=np.float32), (B, ng, 1, 1))
    for g in range(ng):
        if int(s.geom_hfieldid[g]) >= 0:
            continue
        x, y = (rng.uniform(-1.15, 1.15, (2, B)) * size[:2, None]).astype(np.float32)
        q = B // 4
        dx = np.float32(2 * size[0] / (ncol - 1))
        nudge = 0.0 if dx == 0.25 else 1e-3 * dx
        x[:q] = -size[0] + rng.integers(0, ncol, q) * dx + nudge  # on a cell border
        y[:q] = -size[1] + rng.integers(0, ncol, q) * dx + 3 * nudge  # off the cells' diagonals too
        reach = float(jm.geom_rbound[g])
        z = _surface(jm, x, y) + rng.uniform(-1.2 * reach, 1.5 * reach, B)
        xpos[:, g] = np.stack([x, y, z], -1)
        xmat[:, g] = _rot(rng.standard_normal((B, 4)))
        xmat[: q // 2, g] = np.eye(3, dtype=np.float32)  # axis-aligned: ties between windows' triangles
    return xpos, xmat


def _group_idx(jm, other: int) -> np.ndarray:
    from ambersim_tpu.core.types import GeomType

    s = jm.skel
    return np.nonzero((np.asarray(s.pair_ctype1) == int(GeomType.HFIELD)) & (np.asarray(s.pair_ctype2) == other))[0]


def _close(a, b, atol):
    return np.abs(a - b) <= atol + TOL * np.abs(b)


def _jax_group(jm, idx, t, xpos, xmat, k_out):
    """The JAX package's _hfield_group over the envs, k_out slots a pair."""
    from ambersim_tpu.engine import collision as jcol

    s = jm.skel
    jd = tp.jax_batch(jm, geom_xpos=xpos, geom_xmat=xmat)
    f = jax.vmap(lambda d: jcol._hfield_group(jm, s, d, s.pair_geom1[idx], s.pair_geom2[idx], t, k_out))
    return tuple(np.asarray(x) for x in jax.jit(f)(jd))


def _check_contacts(what, got, jm, idx, t, xpos, xmat):
    """dist slot by slot against the JAX package's 4 deepest; each slot's
    (dist, pos, frame) one of its candidates (every candidate kept)."""
    from ambersim_tpu.core.types import GeomType

    gd, gp, gf = (x.numpy() for x in got)
    for x in (gd, gp, gf):
        assert np.isfinite(x).all(), what
    wd = _jax_group(jm, idx, t, xpos, xmat, 4)[0]
    tp.assert_close(f"{what} dist", gd, wd, rtol=TOL, atol=TOL)
    real = wd < 0.5 * BIG
    np.testing.assert_array_equal(gd >= 0.5 * BIG, ~real, err_msg=f"{what} ignored slots")
    N = {int(GeomType.SPHERE): 1, int(GeomType.CAPSULE): 3, int(GeomType.BOX): 8}[t]
    K = min(int(jm.skel.pair_hfk[i]) for i in idx)
    cd, cp, cf = _jax_group(jm, idx, t, xpos, xmat, N * 2 * (K - 1) ** 2)
    # the frame: its normal is dvec / |dvec| (but where the center was pushed
    # up along its triangle's normal), whose rounding is that of coordinates
    # of size |pos| over |dvec| = |dist + r|: held at TOL + 8 u max(1, |pos|)
    # / |dist + r| (u = 2^-24), pos at TOL + |dist| / 2 x that (pos is the
    # surface point plus dist / 2 x the normal), and the tangents at the
    # normal's bar where it leaves _make_frame's choice of axis decided
    # (| |n_x| - |n_y| | more than 10 times it); slots filled by ignored
    # candidates by their dist alone
    s = jm.skel
    r = np.asarray(jm.geom_size)[s.pair_geom2[idx], 0] * (t != int(GeomType.BOX))
    cond = 8 * 2.0**-24 * np.maximum(1.0, np.abs(gp).max(-1)) / np.maximum(np.abs(gd + r[:, None]), 1e-12)
    n_tol = (TOL + cond)[..., None, None]  # (B, P, 4, 1, 1) against the candidates' (B, P, 1, M, ...)
    p_tol = (TOL + 0.5 * np.abs(gd) * cond)[..., None, None]
    match = _close(gd[..., :, None], cd[..., None, :], TOL) & (
        ~real[..., None] | _close(gp[..., :, None, :], cp[..., None, :, :], p_tol).all(-1))
    gn, cn = gf[..., :, None, 0, :], cf[..., None, :, 0, :]
    n_ok = ~real[..., None] | _close(gn, cn, n_tol).all(-1)
    decided = real[..., None] & (np.abs(np.abs(cn[..., 0]) - np.abs(cn[..., 1])) > 10 * n_tol[..., 0])
    t_ok = ~decided | _close(gf[..., :, None, 1:, :], cf[..., None, :, 1:, :], n_tol[..., None]).all((-1, -2))
    bad = np.argwhere(~(match & n_ok & t_ok).any(-1))
    assert not len(bad), f"{what}: (env, pair, slot) {bad[:5].tolist()} match no JAX candidate"
    np.testing.assert_allclose(gf @ np.swapaxes(gf, -1, -2), np.broadcast_to(np.eye(3), gf.shape), atol=1e-5)
    return real


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("other", ["sphere", "capsule", "box"])
@pytest.mark.parametrize("grid", ["wavy", "bowl", "flat", "terrain"])
def test_hfield_narrowphase_matches_jax(grid, other):
    from ambersim_tpu.core.types import GeomType
    from ambersim_tpu_torch.engine import collision

    jm, tm = _models(grid)
    t = int(getattr(GeomType, other.upper()))
    idx = _group_idx(jm, t)
    assert len(idx), (grid, other)
    xpos, xmat = _poses(jm, seed=20 + 3 * [*GRIDS, "terrain"].index(grid) + ["sphere", "capsule", "box"].index(other))
    got = collision._hfield_group(tm, tp.torch_batch(tm, tp.jax_batch(jm, geom_xpos=xpos, geom_xmat=xmat)), idx, t, 4)
    assert got[0].shape == (B, len(idx), 4)
    real = _check_contacts(f"{grid} hfield-{other}", got, jm, idx, t, xpos, xmat)
    # the draws reach contacts and separated slots, and a sphere's slots
    # filled by ignored candidates (a capsule's 3 x T or a box's 8 x T
    # candidates always hold 4 valid ones)
    gd = got[0].numpy()
    assert (gd < 0).any() and (gd[real] > 0).any(), (grid, other)
    assert other != "sphere" or (~real).any(), grid


def test_hfield_window_clamps_to_its_own_field():
    """Two fields of different sizes in one model: hfield_data pads the
    smaller grid to the larger, and each pair's window clamps to its own
    field's nrow - K / ncol - K (a sphere past the small field's far edge)."""
    from ambersim_tpu.core.types import GeomType
    from ambersim_tpu_torch.engine import collision

    xml = HFIELD_SCENE.replace(
        '<hfield name="terrain" nrow="9" ncol="9" size="1 1 0.3 0.1"/>',
        '<hfield name="terrain" nrow="9" ncol="9" size="1 1 0.3 0.1"/>'
        '<hfield name="small" nrow="5" ncol="6" size="0.5 0.4 0.2 0.1"/>',
    ).replace('<geom name="hf" type="hfield" hfield="terrain"/>',
              '<geom name="hf" type="hfield" hfield="terrain"/><geom name="hs" type="hfield" hfield="small"/>')
    jm = tp.jax_model_from_xml(xml)
    data = np.zeros((2, 9, 9), np.float32)
    data[0] = _wavy()
    data[1, :5, :6] = _bowl()[:5, :6] + 0.1
    data[1, 5:, :] = 7.0  # padding the small field's window must never read
    data[1, :, 6:] = 7.0
    jm = jm.replace(hfield_data=data)
    tm = tp.torch_model(jm)
    s = jm.skel
    t = int(GeomType.SPHERE)
    idx = _group_idx(jm, t)
    assert sorted(int(s.geom_hfieldid[g]) for g in s.pair_geom1[idx]) == [0, 1]
    rng = np.random.default_rng(3)
    xpos = np.zeros((B, s.ngeom, 3), np.float32)
    xmat = np.tile(np.eye(3, dtype=np.float32), (B, s.ngeom, 1, 1))
    g = int(s.pair_geom2[idx[0]])
    xpos[:, g, 0] = rng.uniform(-1.2, 1.2, B)
    xpos[:, g, 1] = rng.uniform(-1.2, 1.2, B)
    xpos[:, g, 2] = rng.uniform(0.0, 0.3, B)
    got = collision._hfield_group(tm, tp.torch_batch(tm, tp.jax_batch(jm, geom_xpos=xpos, geom_xmat=xmat)), idx, t, 4)
    _check_contacts("two fields", got, jm, idx, t, xpos, xmat)
    # the small field's windows read none of its padding (7.0 x its z scale)
    small = [i for i in idx if int(s.geom_hfieldid[s.pair_geom1[i]]) == 1][0]
    tris = collision._hfield_window_tris(tm, 1, torch.as_tensor(xpos[:, g]), int(s.pair_hfk[small]))
    assert max(x[..., 2].max().item() for x in tris) < 2.0 * float(jm.hfield_size[1, 2])


@pytest.mark.parametrize("grid", ["wavy", "terrain"])
def test_hfield_window_on_cell_borders(grid):
    """Each env's window at points exactly on cell borders and one float32
    step either side of them, and past the field's edges (the window
    clamped): the floor of (c + size) / dx, which the jitted JAX package
    takes as a product with dx's float32 reciprocal. The heights bit for
    bit (the same cells); x and y within 1e-6 (XLA contracts -size + k dx
    into a fused multiply-add, one rounding fewer)."""
    from ambersim_tpu.engine import collision as jcol
    from ambersim_tpu_torch.engine import collision

    jm, tm = _models(grid)
    s = jm.skel
    size = np.asarray(jm.hfield_size[0])
    ncol = int(s.hfield_ncol[0])
    dx = np.float32(2 * size[0] / (ncol - 1))
    on = (-size[0] + np.arange(-1, ncol + 1) * dx).astype(np.float32)
    xs = np.concatenate([on, np.nextafter(on, np.float32(np.inf)), np.nextafter(on, np.float32(-np.inf))])
    rng = np.random.default_rng(4)
    c = np.stack([xs, rng.permutation(xs), np.zeros_like(xs)], -1).astype(np.float32)
    for K in (2, 3, 4):
        want = jax.jit(jax.vmap(lambda p: jcol._hfield_window_tris(jm, s, 0, p, K, np.float32)))(c)
        got = collision._hfield_window_tris(tm, 0, torch.as_tensor(c), K)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[..., 2], np.asarray(w)[..., 2], err_msg=f"{grid} K={K}")
            tp.assert_close(f"{grid} K={K}", g, w, rtol=0.0, atol=1e-6)


def test_closest_on_triangle_matches_jax():
    """Points in every Voronoi region of random triangles (a height field's
    triangles are never degenerate: its spacings are positive)."""
    from ambersim_tpu.engine import collision as jcol
    from ambersim_tpu_torch.engine import collision

    rng = np.random.default_rng(8)
    tri = rng.standard_normal((256, 3, 3)).astype(np.float32)
    p = (2.0 * rng.standard_normal((256, 3))).astype(np.float32)
    want = jax.jit(jcol._closest_on_triangle)(p, tri[:, 0], tri[:, 1], tri[:, 2])
    got = collision._closest_on_triangle(*(torch.as_tensor(x) for x in (p, tri[:, 0], tri[:, 1], tri[:, 2])))
    tp.assert_close("closest point", got, want, rtol=TOL, atol=TOL)


def _terrain_height(jm, x, y):
    """The terrain's surface height at (x, y): the grid's two triangles of
    the cell, split along its (j, i) -> (j + 1, i + 1) diagonal."""
    size = np.asarray(jm.hfield_size[0], np.float64)
    n = int(jm.skel.hfield_ncol[0])
    z = np.asarray(jm.hfield_data[0], np.float64) * size[2]
    fx, fy = (x + size[0]) / (2 * size[0] / (n - 1)), (y + size[1]) / (2 * size[1] / (n - 1))
    i, j = np.clip(np.floor(fx).astype(int), 0, n - 2), np.clip(np.floor(fy).astype(int), 0, n - 2)
    u, v = fx - i, fy - j
    z00, z01, z10, z11 = z[j, i], z[j, i + 1], z[j + 1, i], z[j + 1, i + 1]
    return np.where(u >= v, z00 + u * (z01 - z00) + v * (z11 - z01), z00 + v * (z10 - z00) + u * (z11 - z10))


def _terrain_start(jm, seed: int, spread: float):
    """The main path's start (bench_qpos) moved to a seeded xy within
    `spread` m of the spawn and raised by the terrain's height there."""
    qpos = tp.bench_qpos(jm, 16, seed=seed)
    qpos[:, :2] += np.random.default_rng(seed).uniform(-spread, spread, (16, 2)).astype(np.float32)
    qpos[:, 2] += _terrain_height(jm, qpos[:, 0], qpos[:, 1]).astype(np.float32)
    return qpos


@pytest.fixture(scope="module")
def terrain_collision():
    """collision() of 16 terrain quadrupeds over the whole field (past the
    flattened spawn), from 8 cm into the terrain to 5 cm above it."""
    from ambersim_tpu.engine import collision as jcol
    from ambersim_tpu.engine import smooth as jsmooth
    from ambersim_tpu_torch.engine import collision, smooth

    jm, tm = _models("terrain")
    qpos = _terrain_start(jm, 12, 5.5)
    qpos[:, 2] += np.random.default_rng(112).uniform(-0.08, 0.05, 16).astype(np.float32)
    jd = jax.jit(jax.vmap(lambda d: jsmooth.kinematics(jm, d)))(tp.jax_batch(jm, qpos=qpos))
    want = jax.jit(jax.vmap(lambda d: jcol.collision(jm, d)))(jd)
    got = collision.collision(tm, smooth.kinematics(tm, tp.torch_batch(tm, jd)))
    return jm, jd, want, got


@pytest.mark.parametrize("field", ["contacts", "friction", "solref", "solimp", "includemargin", "gap", "geom1",
                                   "geom2"])
def test_terrain_collision_matches_jax(terrain_collision, field):
    """Every contact slot of the 17 pairs: dist, pos and frame by each
    group's candidates as above, the mixed parameters and geom ids slot by
    slot."""
    from ambersim_tpu.core.types import GeomType

    jm, jd, want, got = terrain_collision
    s = jm.skel
    assert got.contact.dist.shape == (16, 68)
    assert (np.asarray(want.contact.dist) < 0).any()
    if field != "contacts":
        w, g = np.asarray(getattr(want.contact, field)), getattr(got.contact, field).numpy()
        if field in ("geom1", "geom2"):
            np.testing.assert_array_equal(g, w)
        else:
            tp.assert_close(field, g, w, rtol=TOL, atol=TOL)
        return
    xpos, xmat = np.asarray(jd.geom_xpos), np.asarray(jd.geom_xmat)
    for t in (GeomType.SPHERE, GeomType.CAPSULE, GeomType.BOX):
        idx = _group_idx(jm, int(t))
        slots = np.asarray(s.con_adr)[idx][:, None] + np.arange(4)
        grouped = tuple(getattr(got.contact, f)[:, slots] for f in ("dist", "pos", "frame"))
        _check_contacts(f"terrain collision {t.name.lower()}", grouped, jm, idx, int(t), xpos, xmat)


@pytest.fixture(scope="module")
def terrain_rollout():
    """16 envs x 20 steps of PD standing from the main path's start moved
    up to 1.5 m off the spawn and raised onto the terrain there."""
    from ambersim_tpu.engine.rollout import rollout as jax_rollout
    from ambersim_tpu_torch.engine import rollout

    jm, tm = _models("terrain")
    jd = tp.jax_batch(jm, qpos=_terrain_start(jm, 13, 1.5))
    ref = jax.jit(lambda d: jax_rollout(jm, d, 20, ctrl_fn=tp.pd_ctrl_jax, batched=True))(jd)
    got = rollout(tm, tp.torch_batch(tm, jd), 20, ctrl_fn=tp.pd_ctrl_torch)
    return ref, got


@pytest.mark.parametrize("field, atol", [("qpos", 1e-4), ("qvel", 1e-3)])
def test_terrain_rollout_matches_jax(terrain_rollout, field, atol):
    ref, got = terrain_rollout
    tp.assert_close(field, getattr(got, field), getattr(ref, field), rtol=0.0, atol=atol)
    assert got.efc_active.sum(-1).min().item() > 0  # every env on the terrain
