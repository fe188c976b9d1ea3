#!/usr/bin/env python3
"""Where a serve batch's time goes on the card, for the PyTorch/CUDA port.

    python3 scripts/torch_serve_profile.py --graph road64k
    python3 scripts/torch_serve_profile.py --graph road64k \
        --hierarchy-levels 1

Builds the index with ``repro_torch`` on the card (the preset's overlay
hierarchy unless ``--hierarchy-levels`` overrides it), warms the query
planner up, then serves ``--batches`` batches of
``--batch-size`` uniform random queries twice: once timed by the host
clock (each batch ends in a device-to-host copy, so it includes the
card), once under ``torch.profiler``, whose CUDA activity gives device
time by kernel name.  Prints the device-build stage seconds, the median
batch time, device time per batch by kernel, and the device's idle share
of the profiled window (1 - summed kernel time / wall time; one stream,
so kernels do not overlap).  Writes the same as JSON to
``chiprun_out/profile_<graph>_l<levels>.json``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.device_engine import build_device_index_with_plan
    from repro_torch.core.dist_engine import QueryPlanner
    from repro_torch.core.supergraph import build_index
    from repro_torch.data.roads import road_preset

    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="road64k")
    ap.add_argument("--hierarchy-levels", default=None,
                    help="1, 2..5 or auto (default: the preset's)")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    preset = road_preset(args.graph)
    levels = preset.hierarchy
    if args.hierarchy_levels is not None:
        levels = (args.hierarchy_levels if args.hierarchy_levels == "auto"
                  else int(args.hierarchy_levels))
    g = preset.make()
    ix = build_index(g)
    dix, plan = build_device_index_with_plan(
        ix, device="cuda", hierarchy_levels=levels)
    planner = QueryPlanner(dix)
    planner.warmup(args.batch_size)
    rng = np.random.default_rng(args.seed + 1)
    batches = [(rng.integers(0, g.n, args.batch_size),
                rng.integers(0, g.n, args.batch_size))
               for _ in range(args.batches)]
    wall = []
    for s, t in batches:
        t0 = time.perf_counter()
        planner(s, t)
        wall.append(time.perf_counter() - t0)
    buckets = dict(planner.last_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s, t in batches:
            planner(s, t)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the CPU-side ops
        # that launched them carry the same time again
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if dev_us > 0:
            kernels[e.key] = {"device_us_per_batch": dev_us / args.batches,
                              "calls_per_batch": e.count / args.batches}
    kernels = dict(sorted(kernels.items(),
                          key=lambda kv: -kv[1]["device_us_per_batch"]))
    busy_us = sum(k["device_us_per_batch"] for k in kernels.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res = {
        "graph": args.graph, "hierarchy_levels": plan.hierarchy_levels,
        "levels_S2": [h.S2 for h in plan.hier or []],
        "n": g.n, "S": plan.S, "k": plan.k,
        "maxf": plan.maxf, "mb": plan.mb, "card": smi,
        "build_stages_s": plan.build_timings,
        "batch_size": args.batch_size, "buckets_last_batch": buckets,
        "median_batch_ms": float(np.median(wall)) * 1e3,
        "profiled_ms_per_batch": window_s * 1e3 / args.batches,
        "device_busy_ms_per_batch": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us * args.batches
        / (window_s * 1e6),
        "kernels": kernels,
    }
    print(f"{args.graph}: n={g.n} S={plan.S} k={plan.k} maxf={plan.maxf}"
          f" mb={plan.mb} levels={res['hierarchy_levels']} "
          f"S2={res['levels_S2']}; card {smi}")
    print(f"build stages (s): {plan.build_timings}")
    print(f"median batch {res['median_batch_ms']:.3f} ms "
          f"(profiled {res['profiled_ms_per_batch']:.3f} ms); device busy "
          f"{res['device_busy_ms_per_batch']:.3f} ms/batch, idle share "
          f"{res['device_idle_share']:.3f}; buckets {buckets}")
    for name, k in kernels.items():
        print(f"  {k['device_us_per_batch']:10.1f} us/batch "
              f"{k['calls_per_batch']:6.1f} calls  {name[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{args.graph}_l{plan.hierarchy_levels}.json"
     ).write_text(
        json.dumps(res, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
