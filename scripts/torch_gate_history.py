#!/usr/bin/env python
"""Record the port's bench-gate history: each gated configuration of
``python -m repro_torch.launch.bench_gate`` run ``--runs`` times through
the gate's own serve command lines, appended to ``--out``.

    python3 scripts/torch_gate_history.py --runs 5 \\
        --out chiprun_out/BENCH_torch_serve.json      # on the card
    python3 scripts/torch_gate_history.py --spread BENCH_torch_serve.json

The runs go in this order: ``--runs`` offline serves (3 batches of
1,024, planner), ``--runs`` live runs (Zipf, 500 qps, 3 s, one refresh
round: each writes the ``serve_live`` and ``serve_refresh`` records)
and ``--runs`` host builds with 2 workers.  Every run also writes a
``host_build`` record; the 2-worker builds come last, so the gate's
``host_build`` window (its last 5 records) holds them.  Each fresh
``serve_live`` record is held to the gate's tier and histogram field
contract.  The records land exactly as the serve CLI wrote them.

Then (and with ``--spread FILE`` alone) it prints, for each gated
metric and each card, the values, their median, min, max and max/min:
a section is gated on the card only when max/min stays under the
gate's factor.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import bench_gate  # noqa: E402
from repro_torch.perflog import read_records  # noqa: E402


def gated(gate: argparse.Namespace) -> tuple:
    """The gate's (section, metric, config keys) at its defaults, as
    ``bench_gate.main`` matches them (``device_name`` apart)."""
    live = {"mix": gate.mix, "rate_qps": gate.rate}
    return (("serve", "us_per_query",
             {"mode": gate.mode, "batch_size": gate.batch_size}),
            ("serve_live", "p99_ms", {**live, "cache": "on",
                                      "refresh": "on"}),
            ("serve_refresh", "refresh_max_s", {**live, "pipelined": True}),
            ("serve_refresh", "max_serving_gap_ms",
             {**live, "pipelined": True}),
            ("host_build", "wall_s", {}))


def spread(path: str, last: int = 5) -> list:
    """Per gated metric and card: the last ``last`` values of the gate's
    window at its default configuration (road4000), with median, min,
    max and max/min."""
    gate = bench_gate.parse_args([])
    graph = f"road{gate.nodes}"
    recs = read_records(path)
    out = []
    for section, metric, keys in gated(gate):
        mine = [r for r in recs if r.get("section") == section
                and r.get("graph") == graph]
        for card in sorted({r.get("device_name") for r in mine}):
            match = {"section": section, "graph": graph,
                     "device_name": card, **keys}
            vals = bench_gate.history_window(recs, match, metric, last)
            if not vals:
                continue
            lo, hi = min(vals), max(vals)
            power = [r.get("power_limit_w") for r in mine
                     if r.get("device_name") == card]
            row = {"section": section, "metric": metric, "card": card,
                   "power_limit_w": sorted(set(power), key=str),
                   "n": len(vals), "values": vals,
                   "median": statistics.median(vals), "min": lo, "max": hi,
                   "max_over_min": hi / lo if lo else float("inf")}
            out.append(row)
            print(json.dumps(row))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/BENCH_torch_serve.json")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--spread", default="",
                    help="only print the spread of this history")
    args = ap.parse_args()
    if args.spread:
        spread(args.spread)
        return 0
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    gate = bench_gate.parse_args(["--fresh", out,
                                  "--history", out + ".none"])
    for run in (bench_gate.run_serve, bench_gate.run_live,
                bench_gate.run_host_build):
        for _ in range(args.runs):
            run(gate)
    spread(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
