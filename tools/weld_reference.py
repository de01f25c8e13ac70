"""The JAX package's own run of chip_smoke.py's weld, drag and refsite paths
on the CPU: the numbers their bars are set against.

Each path's model is chip_smoke's XML compiled by the JAX package, started
as chip_smoke starts it (`weld_start`, `drag_start`, `refsite_start`, the
first B envs of the seeded draws), and rolled out by the JAX package's
step for the path's steps. Prints, per path: mocap_weld's and
mocap_drag's largest box-to-target distance, mocap_drag's lowest geom point
above its floor and the share of envs with a contact row active at the
last step, and refsite_arm's largest |actuator_length| per actuator at the
start and at the last step.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/weld_reference.py [--envs 256] [--paths mocap_drag ...]
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np
import torch

import chip_smoke
from tools import torch_parity as tp


def _batch(jm, d) -> object:
    """make_data's JAX Data broadcast to the port Data d's batch, with d's
    qpos, qvel, ctrl and mocap_pos."""
    from ambersim_tpu.engine import make_data

    B = d.qpos.shape[0]
    jd = jax.tree.map(lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)), make_data(jm))
    return jd.replace(qpos=d.qpos.numpy(), qvel=d.qvel.numpy(), ctrl=d.ctrl.numpy(), mocap_pos=d.mocap_pos.numpy())


def run(name: str, envs: int) -> None:
    from ambersim_tpu.engine import forward, step
    from ambersim_tpu_torch.engine import smooth

    p = chip_smoke.PATHS[name]
    xml = {"mocap_weld": chip_smoke.mocap_rig_xml, "mocap_drag": chip_smoke.mocap_drag_xml,
           "refsite_arm": chip_smoke.refsite_arm_xml}[name]()
    jm = tp.jax_model_from_xml(xml)
    tm = tp.torch_model(jm)
    jd = _batch(jm, p["start"](tm, envs, "cpu"))
    t0 = time.perf_counter()
    roll = jax.jit(jax.vmap(lambda d: forward(jm, jax.lax.fori_loop(0, p["steps"], lambda _, x: step(jm, x), d))))
    out = roll(jd)
    jax.block_until_ready(out.qpos)
    line = f"{name}: {envs} envs x {p['steps']} steps ({time.perf_counter() - t0:.1f} s)"
    if name.startswith("mocap"):
        err = np.linalg.norm(np.asarray(out.qpos)[:, :3] - np.asarray(out.mocap_pos)[:, 0], axis=-1)
        line += f"; box to target: max {err.max():.6f} m, mean {err.mean():.6f} m"
    if name == "mocap_drag":
        d = smooth.kinematics(tm, tp.torch_batch(tm, out))
        low = (chip_smoke.lowest_geom_point(tm, d) - chip_smoke.DRAG_FLOOR).numpy()
        touching = np.asarray(out.efc_active)[:, jm.skel.ne:].any(1).mean()
        line += f"; lowest geom point {low.min():.6f} m from the floor; contact rows active on {touching:.4f} of the envs"
    if name == "refsite_arm":
        first = np.abs(np.asarray(jax.jit(jax.vmap(lambda d: forward(jm, d)))(jd).actuator_length)).max(0)
        last = np.abs(np.asarray(out.actuator_length)).max(0)
        line += (f"; largest |actuator_length| per actuator {np.array2string(first, precision=4)} at the start -> "
                 f"{np.array2string(last, precision=4)} at the last step (ratio "
                 f"{np.array2string(last / first, precision=4)})")
    print(line, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--paths", nargs="+", default=["mocap_weld", "mocap_drag", "refsite_arm"])
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    for name in args.paths:
        run(name, args.envs)


if __name__ == "__main__":
    main()
