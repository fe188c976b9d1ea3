"""The observability overhead budget on the port's live serving: a copy
of ``scripts/obs_overhead.py`` over ``repro_torch``.

Live serving qps with the full observability stack ON (tracing spans,
the periodic metrics exporter and the Prometheus HTTP endpoint) against
OFF (registry counters only, which are always on), on the same engine.
The two arms run interleaved repeats of the same open-loop load (same
pair pool, same seeds) against fresh runtimes; each arm scores its best
achieved qps (max of the repeats) and the overhead is
``1 - qps_on / qps_off``.  The run exits non-zero when the overhead
exceeds ``--budget`` (2% by default).  ``--json PATH`` appends a
``section: "obs_overhead"`` record to the history at PATH
(``repro_torch.perflog``); without it nothing is written.

    PYTHONPATH=src python -m repro_torch.obs.overhead      # road4000, on the card
    PYTHONPATH=src python -m repro_torch.obs.overhead --device cpu \\
        --nodes 1000 --seconds 2 --repeats 2

The HTTP endpoint binds an ephemeral port on localhost; the exporter's
snapshots go to the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def run_phase(engine, pairs, args, traced: bool, rep: int) -> float:
    """One load phase against a fresh runtime; returns achieved qps."""
    from . import MetricsExporter, MetricsServer, trace
    from ..serving import ServingRuntime, run_load

    tr = trace.get_tracer()
    handles = []
    rt = ServingRuntime(engine, max_batch=args.live_batch,
                        cache_size=args.cache_size)
    rt.warmup()
    if traced:
        tr.clear()
        tr.enable()
        out = os.path.join(tempfile.gettempdir(),
                           f"obs_overhead_{os.getpid()}.json")
        handles.append(MetricsExporter(rt.registry, out,
                                       interval_s=0.5).start())
        handles.append(MetricsServer(rt.registry, port=0).start())
    try:
        report = run_load(rt, pairs, rate_qps=args.rate,
                          seed=args.seed + rep)
    finally:
        rt.close()
        for h in handles:
            h.stop()
        if traced:
            tr.enable(False)
            tr.clear()
    arm = "on " if traced else "off"
    print(f"  rep {rep} obs={arm}: {report.achieved_qps:8.1f} qps "
          f"achieved (p99 {report.p99_ms}ms, "
          f"{report.latency_source})", flush=True)
    return report.achieved_qps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered qps (kept above capacity so achieved "
                         "qps measures throughput, not the clock)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--live-batch", type=int, default=256)
    ap.add_argument("--cache-size", type=int, default=65536)
    ap.add_argument("--mix", default="zipf")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget", type=float, default=0.02,
                    help="max tolerated overhead fraction (fail above)")
    ap.add_argument("--json", default="",
                    help="perf history to append the record to "
                         "('' skips)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..core.dist_engine import EpochedEngine
    from ..core.graph import road_like
    from ..data.queries import workload_pairs

    g = road_like(args.nodes, seed=args.seed)
    engine = EpochedEngine(g, device=args.device)
    print(f"built road{args.nodes} engine on {engine.device}", flush=True)
    engine.warmup(args.live_batch)
    n = max(1, int(round(args.rate * args.seconds)))
    pairs = workload_pairs(g, args.mix, n, seed=args.seed + 4)
    print(f"A-B: {n} {args.mix} requests at {args.rate:.0f} qps "
          f"offered, {args.repeats} interleaved repeats per arm")

    qps_off, qps_on = [], []
    for rep in range(args.repeats):
        qps_off.append(run_phase(engine, pairs, args, False, rep))
        qps_on.append(run_phase(engine, pairs, args, True, rep))
    best_off, best_on = max(qps_off), max(qps_on)
    overhead = 1.0 - best_on / best_off
    print(f"obs_overhead: road{args.nodes} qps off={best_off:.1f} "
          f"on={best_on:.1f} overhead={overhead * 100:.2f}% "
          f"(budget {args.budget * 100:.1f}%)")

    if args.json:
        from ..perflog import append_records
        append_records(args.json, [{
            "section": "obs_overhead",
            "graph": f"road{args.nodes}",
            "backend": engine.device.type,
            "mix": args.mix,
            "rate_qps": args.rate,
            "n_requests": n,
            "repeats": args.repeats,
            "qps_off": round(best_off, 1),
            "qps_on": round(best_on, 1),
            "overhead_frac": round(overhead, 4),
            "budget_frac": args.budget,
        }])
        print(f"obs_overhead: recorded in {args.json}")

    if overhead > args.budget:
        print(f"obs_overhead: FAIL — {overhead * 100:.2f}% exceeds "
              f"the {args.budget * 100:.1f}% budget")
        return 1
    print("obs_overhead: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
