#!/usr/bin/env python3
"""Where a batch's time goes in the hierarchy's distance ladder, by level.

    PYTHONPATH=src python3 scripts/ladder_levels.py --graph road250k \
        [--batches 20] [--batch-size 1024] [--build-workers 8]

Builds the preset's index on the card (depth "auto", as the benchmark's
batch cells), warms the planner up, then serves ``--batches`` batches of
uniform random pairs twice: with the tracer off (host clock: ms a batch
and queries/s) and with it on (``repro_torch.obs.trace``), where it
sums each ``serve.lift`` and ``serve.leg`` span's card time by level and
kind per 1,000 queries.  Prints one JSON line.
``--device cpu --graph road4000 --hierarchy-levels 3`` rehearses it on
the plain versions (no card time there); the larger presets are for the
card.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="road250k")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--build-workers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hierarchy-levels", default="auto",
                    type=lambda v: v if v == "auto" else int(v))
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.dist_engine import EpochedEngine
    from repro_torch.data.roads import road_preset
    from repro_torch.obs import trace

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    g = road_preset(args.graph).make()
    t0 = time.perf_counter()
    eng = EpochedEngine(g, device=dev, warm_refresh=False,
                        hierarchy_levels=args.hierarchy_levels,
                        build_workers=args.build_workers)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    pairs = [(rng.integers(0, g.n, args.batch_size),
              rng.integers(0, g.n, args.batch_size))
             for _ in range(args.batches)]
    eng.planner.warmup(args.batch_size)
    eng.query(*pairs[0])
    sync()

    t0 = time.perf_counter()
    for s, t in pairs:
        eng.query(s, t)
    sync()
    off_s = time.perf_counter() - t0

    tr = trace.get_tracer()
    tr.clear()
    tr.enable()
    try:
        for s, t in pairs:
            eng.query(s, t)
        sync()
        events = tr.drain()
    finally:
        tr.enable(False)
        tr.clear()
    kq = args.batches * args.batch_size / 1e3
    ms = collections.defaultdict(float)
    for e in events:
        a = e["args"]
        if e["name"] in ("serve.lift", "serve.leg"):
            key = f"{e['name'][6:]}.{a.get('kind', 'leg')}.l{a['level']}"
            ms[key] += a.get("device_ms", 0.0) / kq
    out = {
        "graph": args.graph, "nodes": g.n, "levels": eng.dix.hierarchy_levels,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"), "build_s": build_s,
        "batches": args.batches, "batch_size": args.batch_size,
        "ms_per_batch_untraced": off_s / args.batches * 1e3,
        "queries_per_s_untraced": args.batches * args.batch_size / off_s,
        "device_ms_per_kq": dict(sorted(ms.items())),
        "lift_ms_per_kq": sum(v for k, v in ms.items()
                              if k.startswith("lift")),
        "leg_ms_per_kq": sum(v for k, v in ms.items()
                             if k.startswith("leg")),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
