"""Host ms of the Newton kernels' plain versions on the weld and tendon
paths' own operands, at the models' default 100 x 50 iterations.

chip_smoke.check_newton_tendon and check_newton_weld time kernels 4 and 5
there but hold their plain versions at CONVERGED iterations (or run them
once a dtype), since a plain call at 100 x 50 takes seconds of host
dispatch. This fills that column of PERF.md section 6: each path is driven
as chip_smoke drives it (4096 envs, chip_smoke.drive_path), its final state
goes through the same pre-solve and warmstart (the same seeds), and the
plain version is timed over `--calls` calls, host clock around a
synchronize, after one warm call.

    python3 tools/newton_plain_ms.py [--paths tendon_rig mocap_drag refsite_arm mocap_weld] [--calls 2]

Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEEDS = {"tendon_rig": 12, "mocap_drag": 13, "refsite_arm": 13, "mocap_weld": 13}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="+", default=list(SEEDS))
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from ambersim_tpu_torch.engine.forward import full_f32_matmul
    from ambersim_tpu_torch.engine.solver import _newton_arrays
    from ambersim_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("newton_plain_ms: no CUDA card", flush=True)
        return 1
    _build.build()
    _build.library()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    out = {}
    with full_f32_matmul():
        for name in args.paths:
            cs.drive_path(name, device, card)
            m = cs.path_model(name, device)
            s = m.skel
            pa = cs.solver_operands(m, cs.pre_solve(m, cs.SETTLED[name]), seed=SEEDS[name])
            kw = dict(ne=int(s.ne), nf=int(s.nf), iterations=int(m.opt.iterations),
                      ls_iterations=int(m.opt.ls_iterations), use_ws=True)
            _newton_arrays(**pa, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                _newton_arrays(**pa, **kw)
            torch.cuda.synchronize()
            out[name] = 1e3 * (time.perf_counter() - t0) / args.calls
            print(f"newton_plain_ms: {name} B={pa['J'].shape[0]} nefc {s.nefc} nv {s.nv} at "
                  f"{kw['iterations']} x {kw['ls_iterations']}: plain {out[name]:.3f} ms a call [{card}]", flush=True)
    print(json.dumps({"newton_plain_ms": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
