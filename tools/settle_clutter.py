#!/usr/bin/env python3
"""Write the settled state of the 32-body clutter scene that chip_smoke.py's
Newton spread check starts from.

    python3 tools/settle_clutter.py [--steps 600] [--out PATH]

Steps one env of `clutter32_rowcap192` from make_data (every env of the
clutter paths starts there alike) for --steps steps with zero ctrl, the
paths' settle, on the CPU with the port's plain versions, and saves its
qpos and qvel (float32) to ambersim_tpu_torch/assets/
clutter32_rowcap192_settled.npz. ~2.5 minutes on one CPU core; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

MODEL = "clutter32_rowcap192"
OUT = REPO / "ambersim_tpu_torch" / "assets" / f"{MODEL}_settled.npz"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()

    from ambersim_tpu_torch import load_model
    from ambersim_tpu_torch.engine import make_data, rollout

    m = load_model(MODEL, device="cpu")
    d = rollout(m, make_data(m, 1), args.steps)
    np.savez(args.out, qpos=d.qpos[0].numpy(), qvel=d.qvel[0].numpy(), steps=np.int64(args.steps))
    print(f"{args.out}: qpos {tuple(d.qpos[0].shape)}, qvel {tuple(d.qvel[0].shape)} after {args.steps} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
