"""Quadruped locomotion over procedural height-field terrain (port of
ambersim_tpu/rl/quadruped/terrain.py).

The scene is built from the packaged quadruped model with the port's own
compiler: the flat floor is replaced by a height field whose elevation
grid is generated from the config's seed, and the trunk, calves and feet
collide with the terrain's triangles (engine/collision.py, the height-field
narrowphase). The task is the flat-ground velocity-tracking one, its fall
check (`_done`) the flat env's at the terrain config's lower min_height.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ambersim_tpu_torch.rl.base import MjxEnv
from ambersim_tpu_torch.rl.quadruped.locomotion import QuadrupedLocomotionConfig, QuadrupedLocomotionEnv
from ambersim_tpu_torch.utils._internal_utils import ROOT

# the packaged quadruped, read as a data file; its floor is replaced by the terrain
QUADRUPED_XML = ROOT + "/models/quadruped/quadruped.xml"


@dataclasses.dataclass(frozen=True)
class QuadrupedTerrainConfig(QuadrupedLocomotionConfig):
    """The terrain's grid (elevations normalized to [0, 1]; world height =
    terrain_height). The scene is always built from QUADRUPED_XML: the
    inherited `model` (an exported asset's name) must keep its default."""

    terrain_seed: int = 0
    terrain_nrow: int = 24
    terrain_ncol: int = 24
    terrain_extent: float = 6.0  # half-width of the square field (m)
    terrain_height: float = 0.05  # z scale (m)
    # rough terrain is harder: a slightly laxer fall threshold
    min_height: float = 0.10

    def __post_init__(self):
        if self.model != QuadrupedLocomotionConfig.model:
            raise ValueError(f"quadruped_terrain builds its scene from {QUADRUPED_XML}; model={self.model!r} is not read")


def _terrain_grid(cfg: QuadrupedTerrainConfig) -> np.ndarray:
    """Smooth random terrain: a sum of a few low-frequency sinusoids,
    flattened near the spawn point so that the standing pose starts
    feasible. The JAX package's numpy, draw for draw."""
    rng = np.random.default_rng(cfg.terrain_seed)
    gy, gx = np.meshgrid(
        np.linspace(-1, 1, cfg.terrain_nrow), np.linspace(-1, 1, cfg.terrain_ncol), indexing="ij"
    )
    z = np.zeros_like(gx)
    for _ in range(4):
        fx, fy = rng.uniform(1.0, 3.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        z += rng.uniform(0.3, 1.0) * np.sin(fx * np.pi * gx + px) * np.sin(fy * np.pi * gy + py)
    z -= z.min()
    z /= max(z.max(), 1e-9)
    spawn_flat = np.exp(-((gx / 0.25) ** 2 + (gy / 0.25) ** 2))  # bowl-free spawn
    return z * (1.0 - spawn_flat)


def terrain_arrays(cfg: QuadrupedTerrainConfig) -> tuple[dict, dict]:
    """(skel_fields, leaves) of the terrain scene, setconst applied and the
    generated grid in hfield_data, as `io.bridge.model_from_numpy` takes
    them. The scene compiles once per config and process; each call
    returns new dicts of those arrays."""
    skel_fields, leaves = _compiled(cfg)
    return dict(skel_fields), dict(leaves)


@functools.lru_cache(maxsize=8)
def _compiled(cfg: QuadrupedTerrainConfig) -> tuple[dict, dict]:
    from ambersim_tpu_torch.engine.setconst import set_constants
    from ambersim_tpu_torch.mjcf import compile_spec_arrays, parse_mjcf
    from ambersim_tpu_torch.mjcf.parser import ElemSpec

    spec = parse_mjcf(QUADRUPED_XML)
    world = spec.bodies[0]
    world.geoms = [g for g in world.geoms if g.attrib.get("name") != "floor"]
    spec.hfields["terrain"] = dict(
        name="terrain",
        nrow=str(cfg.terrain_nrow),
        ncol=str(cfg.terrain_ncol),
        size=f"{cfg.terrain_extent} {cfg.terrain_extent} {cfg.terrain_height} 0.1",
    )
    world.geoms.append(
        ElemSpec(
            "geom",
            {
                "name": "terrain",
                "type": "hfield",
                "hfield": "terrain",
                "contype": "1",
                "conaffinity": "1",
                "friction": "0.8 0.02 0.01",
            },
        )
    )
    skel_fields, leaves = compile_spec_arrays(spec)
    leaves = set_constants(skel_fields, leaves)
    return skel_fields, {**leaves, "hfield_data": _terrain_grid(cfg).astype(np.float32)[None]}


def _build_terrain_model(cfg: QuadrupedTerrainConfig, device="cuda"):
    from ambersim_tpu_torch.io.bridge import model_from_numpy

    return model_from_numpy(*terrain_arrays(cfg), device=device)


class QuadrupedTerrainEnv(QuadrupedLocomotionEnv):
    """Velocity-tracking locomotion over smooth random terrain."""

    def __init__(self, config: QuadrupedTerrainConfig | None = None, device="cuda"):
        self.config = config or QuadrupedTerrainConfig()
        # the flat env's __init__ loads the flat asset: the scene is built here
        MjxEnv.__init__(self, _build_terrain_model(self.config, device), self.config.physics_steps_per_control_step)
