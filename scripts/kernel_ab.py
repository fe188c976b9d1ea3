#!/usr/bin/env python3
"""Time the witness kernels of one checkout, for before/after pairs.

    python3 scripts/kernel_ab.py --src SRC_DIR --tag NAME [--road64k]

Needs one NVIDIA card and ``nvcc``.  Imports ``repro_torch`` from
``SRC_DIR`` (the ``src`` directory of this checkout, or of an unpacked
parent commit), so two checkouts can be timed in turns inside one chip
call (parent, change, change, parent).  On seeded integer inputs with
~20% +inf it times, with CUDA events and (for the witness argmin) the
profiler's device time:

  * ``ops.minplus_twoside_argmin`` at q = 16 and 1,024 against S+1 =
    480 and 4,614, and q = 1,024 against S_top+1 = 1,712;
  * ``ops.fw_batch_next`` (whichever variant the checkout dispatches)
    at [6, 1024, 1024], [130, 496, 496] and [1, 4613, 4613];
  * with ``--road64k``, the road64k device build at its preset's 3
    levels: ``plan.build_timings`` (frag_stage, sf_stage_l1/l2, ...).

Prints one JSON line tagged NAME and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(_HERE.parent))

ARGMIN = ((16, 480), (1024, 480), (16, 4614), (1024, 4614), (1024, 1712))
FW = ((6, 1024), (130, 496), (1, 4613))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--road64k", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    # chip_smoke puts this checkout's src first on import: the checkout
    # timed goes in front of it after
    from chip_smoke import _device_ms, _int_inf, _time_ms
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build, ops
    _build.build()
    rec: dict = {"tag": args.tag, "src": args.src, "argmin": {}, "fw": {}}
    for q, k in ARGMIN:
        rng = np.random.default_rng(q * 37 + k)
        rows, d, rowt = (torch.from_numpy(_int_inf(s, rng)).cuda()
                         for s in ((q, k), (k, k), (q, k)))

        def fn():
            return ops.minplus_twoside_argmin(rows, d, rowt)
        rec["argmin"][f"q={q} k={k}"] = {"ms": _time_ms(fn, 10),
                                         "device_ms": _device_ms(fn, 10)}
    for b, n in FW:
        rng = np.random.default_rng(b * 7919 + n)
        d = torch.from_numpy(_int_inf((b, n, n), rng)).cuda()
        rec["fw"][f"b={b} n={n}"] = _time_ms(lambda: ops.fw_batch_next(d),
                                             2)
    if args.road64k:
        from repro_torch.core.device_engine import build_device_index_with_plan
        from repro_torch.core.graph import road_like
        from repro_torch.core.supergraph import build_index
        from repro_torch.data.roads import road_preset
        preset = road_preset("road64k")
        ix = build_index(road_like(preset.nodes, seed=0))
        _dix, plan = build_device_index_with_plan(
            ix, device="cuda", hierarchy_levels=preset.hierarchy)
        rec["road64k_build_timings"] = dict(plan.build_timings)
    print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
