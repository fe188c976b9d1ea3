"""DISLAND serve CLI of the port (offline planner mode).

Builds the index over a synthetic road graph (host build, then the
device build on the card), warms the query planner up, serves
``--batches`` batches of ``--batch-size`` uniform random queries, prints
the build stage times, the median batch time, µs/query and the planner's
buckets, and validates a sample of the last batch against host Dijkstra
(any mismatch exits non-zero).

    PYTHONPATH=src python -m repro_torch.launch.serve --graph road4000
    PYTHONPATH=src python -m repro_torch.launch.serve --graph road64k \\
        --validate 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --nodes 900 --batches 1 --batch-size 64 --validate 16

The port closes the overlay densely (``hierarchy_levels=1``); a preset
or size whose overlay needs the N-level hierarchy is refused by the
device build until that slice is ported.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import dijkstra
from ..core.device_engine import (build_device_index_with_plan,
                                  resolve_device)
from ..core.dist_engine import QueryPlanner
from ..core.graph import road_like
from ..core.supergraph import build_index
from ..data.roads import road_preset


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--graph", default=None,
                    help="named road preset (overrides --nodes)")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--validate", type=int, default=64,
                    help="check this many answers of the last batch "
                         "against host Dijkstra (0 mismatches or exit 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Build, warm up, serve and validate; returns the run's summary
    (stage seconds, median batch ms, µs/query, planner buckets, the
    validation mismatch count)."""
    device = resolve_device(args.device)
    levels = "auto"
    if args.graph:
        preset = road_preset(args.graph)
        args.nodes, levels = preset.nodes, preset.hierarchy
    t0 = time.perf_counter()
    g = road_like(args.nodes, seed=args.seed)
    graph_s = time.perf_counter() - t0
    print(f"graph: n={g.n} m={g.m} ({graph_s:.2f}s)")
    t0 = time.perf_counter()
    ix = build_index(g)
    host_s = time.perf_counter() - t0
    print(f"host index: {ix.timings} ({host_s:.2f}s)")
    t0 = time.perf_counter()
    dix, plan = build_device_index_with_plan(ix, device=device,
                                             hierarchy_levels=levels)
    device_s = time.perf_counter() - t0
    stages = {k: round(v, 3) for k, v in plan.build_timings.items()}
    print(f"device index on {device}: k={plan.k} maxf={plan.maxf} "
          f"mb={plan.mb} S={plan.S} pieces={plan.n_pieces} "
          f"stages={stages} ({device_s:.2f}s)")

    planner = QueryPlanner(dix)
    t0 = time.perf_counter()
    planner.warmup(args.batch_size)
    warmup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 1)
    times = []
    last = None
    for _ in range(args.batches):
        s = rng.integers(0, g.n, args.batch_size)
        t = rng.integers(0, g.n, args.batch_size)
        t0 = time.perf_counter()
        out = planner(s, t)              # host copy: waits for the card
        times.append(time.perf_counter() - t0)
        last = (s, t, out)
    med = float(np.median(times)) if times else float("nan")
    per_q = med / args.batch_size
    print(f"served {args.batches * args.batch_size} queries; median batch "
          f"{med * 1e3:.3f}ms -> {per_q * 1e6:.3f}us/query "
          f"({1 / per_q:,.0f} qps)")
    print(f"planner buckets (last batch): {planner.last_counts}")

    bad = 0
    if args.validate and last is not None:
        s, t, got = last
        n_check = min(args.validate, len(s))
        for i in range(n_check):
            want = dijkstra.pair(g, int(s[i]), int(t[i]))
            bad += dijkstra.mismatches_oracle(want, float(got[i]))
        print(f"validation: {bad} mismatches of {n_check}")
    return {
        "graph": args.graph or f"road{args.nodes}", "n": g.n,
        "device": str(device), "S": plan.S, "k": plan.k,
        "maxf": plan.maxf, "mb": plan.mb,
        "host_build_s": host_s, "device_build_s": device_s,
        "stages_s": dict(plan.build_timings), "warmup_s": warmup_s,
        "median_batch_ms": med * 1e3, "us_per_query": per_q * 1e6,
        "buckets": dict(planner.last_counts), "mismatches": bad,
        "answers_finite": bool(last is not None
                               and np.isfinite(last[2]).all()),
    }


def main(argv=None) -> int:
    res = run(parse_args(argv))
    return 1 if res["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
