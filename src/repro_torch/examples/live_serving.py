"""Online serving under live traffic: the DESIGN.md §11 runtime on the
port (a copy of ``examples/live_serving.py``).

Single (s, t) requests arrive as an open-loop Poisson stream with a
Zipf-skewed pair mix; the ServingRuntime micro-batches them against
the planner's warmed pow2 buckets, answers the hot head from the
epoch-tagged result cache, and keeps serving while a background
RefreshDriver absorbs waves of traffic updates through the incremental
delta path.  At the end, a sample of responses is checked against the
host Dijkstra oracle *of the epoch that served each one* — the
consistency contract under concurrent refresh; any mismatch fails.

    PYTHONPATH=src python -m repro_torch.examples.live_serving [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

from ..core.dist_engine import EpochedEngine
from ..core.graph import road_like
from ..serving import (ServingRuntime, run_load_with_refresh,
                       validate_against_epochs, workload_pairs)


def main(device: str = "cuda", nodes: int = 1600,
         requests: int = 3000) -> int:
    t0 = time.perf_counter()
    g = road_like(nodes, seed=11)
    engine = EpochedEngine(g, device=device)
    runtime = ServingRuntime(engine, max_batch=128, deadline_s=0.002,
                             cache_size=16384)
    runtime.warmup()
    print(f"built road graph n={g.n} m={g.m}, index on {engine.device}, "
          f"and warm serving runtime in {time.perf_counter() - t0:.1f}s "
          f"(max_batch={runtime.max_batch}, deadline 2ms)")

    # one blocking request straight away
    d = runtime.query(3, g.n - 5)
    print(f"single query dist(3, {g.n - 5}) = {d}")

    # open-loop Zipf load with two concurrent refresh waves, staged
    # through the prioritized refresh pipeline (DESIGN.md §14): the
    # busiest-served groups re-close first and every intermediate
    # epoch publishes with an explicit staleness descriptor
    pairs = workload_pairs(engine.g, "zipf", requests, seed=2)
    report, graphs, driver = run_load_with_refresh(
        runtime, pairs, rate_qps=600.0, seed=3, refresh_rounds=2,
        refresh_frac=0.03, refresh_interval_s=0.2, refresh_seed=5,
        refresh_pipelined=True)
    runtime.close()

    stats = report.runtime_stats
    epochs = sorted({r.epoch for r in report.requests})
    print(f"served {report.n_requests} requests at "
          f"{report.achieved_qps:.0f} qps: p50 {report.p50_ms}ms "
          f"p95 {report.p95_ms}ms p99 {report.p99_ms}ms")
    print(f"cache: {stats['cache_hit_rate']:.1%} hit rate, "
          f"{stats['cache_stale']} stale entries rejected; "
          f"{stats['flushes']} flushes "
          f"(full={stats['flush_full']}, "
          f"deadline={stats['flush_deadline']}), occupancy "
          f"{stats['mean_occupancy']:.1%}")
    rec = driver.as_record()
    print(f"epochs served: {epochs} (refresh mean "
          f"{rec['refresh_mean_s']}s across {rec['refresh_items']} "
          f"pipelined work items)")
    print(f"staleness: max serving gap {report.max_serving_gap_ms}ms, "
          f"{report.stale_responses} responses from mid-pipeline "
          f"epochs, max lag {report.max_staleness_batches} batch(es)")
    checked, bad = validate_against_epochs(report.requests, graphs,
                                           sample=48,
                                           evicted=driver.evicted_epochs)
    assert bad == 0, f"{bad} responses broke epoch consistency"
    print(f"validated {checked} responses against their serving "
          "epoch's host oracle: 0 mismatches — live-serving demo OK")
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nodes", type=int, default=1600)
    ap.add_argument("--requests", type=int, default=3000)
    args = ap.parse_args(argv)
    return main(device=args.device, nodes=args.nodes,
                requests=args.requests)


if __name__ == "__main__":
    sys.exit(cli())
