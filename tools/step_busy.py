"""The busy picture of a path's physics step on the card.

    python3 tools/step_busy.py [--paths quadruped quadruped_terrain]

For each of chip_smoke.py's paths named (its model, start and controller
at ENVS envs), after 20 warm-up steps: the wall ms of a step (host clock
around a synchronize, STEPS steps; every path's before any profile), the
device kernels a step and their summed device time (torch.profiler over
another STEPS steps), the busy share (device time over the unprofiled
wall time), and each stage's wall ms (chip_smoke.stage_split). Run from a
checkout of the repository on a CUDA card; it builds the kernels and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ENVS = 4096
STEPS = 20


def busy(names, card: str) -> None:
    """Every path's wall time first, then each one's profile and stage
    split: a profiler run can leave the host's launches slower after it."""
    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch.engine import rollout

    device = torch.device("cuda", 0)
    runs = {}
    for name in names:
        p = cs.PATHS[name]
        m = cs.path_model(name, device)
        d = rollout(m, p["start"](m, ENVS, device), 20, ctrl_fn=p["ctrl"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(m, d, STEPS, ctrl_fn=p["ctrl"])
        torch.cuda.synchronize()
        runs[name] = (m, d, p["ctrl"], 1e3 * (time.perf_counter() - t0) / STEPS)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, (m, d, ctrl, wall_ms) in runs.items():
        with torch.profiler.profile(activities=activities) as prof:
            rollout(m, d, STEPS, ctrl_fn=ctrl)
            torch.cuda.synchronize()
        kernels, device_us = 0, 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels += e.count
                device_us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if device_us:
            picture = (f"{kernels / STEPS:.0f} device kernels and {device_us / 1e3 / STEPS:.3f} ms of device time a "
                       f"step: busy {device_us / 1e3 / STEPS / wall_ms:.3f}")
        else:
            picture = "device time not measured"
        print(f"{name}: {ENVS} envs, {wall_ms:.3f} ms a step (wall, {STEPS} steps); {picture} [{card}]", flush=True)
        cs.SETTLED[name] = d
        cs.stage_split(name, device, card, steps=10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="+", default=["quadruped", "quadruped_terrain"])
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from ambersim_tpu_torch.engine.forward import full_f32_matmul
    from ambersim_tpu_torch.ops import _build

    _build.build()
    _build.library()
    card = cs.card_line()
    with full_f32_matmul():
        busy(args.paths, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
