"""The port's paper-table harness: one section per paper table or
experiment (``repro_torch.paper.tables``), the counterpart of
``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.paper.run [--only table3,exp5] \\
        [--json PATH] [--device cuda|cpu]

Prints the reference's CSV rows (section,graph,...) and a
``# <function> took <s>s`` line after each section, so the two
harnesses' outputs diff line by line.  ``--json PATH`` also appends
structured perf records (``_perf_records``) to the history at PATH
(``repro_torch.perflog``); without it nothing is written.  ``--device``
(default ``cuda``, which raises without a card) is where Exp-5 and
Exp-7 to Exp-10 build and serve; the host tables run on the CPU either
way.  ``EXP10_GRAPHS`` and ``EXP10_BUILD_WORKERS`` set Exp-10's graphs
and host-build workers, as in the reference.
"""
from __future__ import annotations

import argparse
import sys
import time


# copied from benchmarks/run.py:18
def _perf_records(rows: list[str]) -> list[dict]:
    """Extract structured perf records from latency/refresh rows."""
    records = []
    for row in rows:
        parts = row.split(",")
        if parts[0] == "exp5" and parts[1] != "graph":
            us = float(parts[4])
            records.append({
                "section": "exp5",
                "graph": parts[1],
                "bucket": parts[2],
                "algo": parts[3],
                "us_per_query": us,
                "qps": round(1e6 / us, 1) if us > 0 else float("inf"),
            })
        elif parts[0] == "exp8" and parts[1] != "graph":
            us = float(parts[3])
            records.append({
                "section": "exp8_paths",
                "graph": parts[1],
                "algo": parts[2],
                "us_per_query": us,
                "mean_hops": float(parts[4]),
                "exact": bool(int(parts[5])),
            })
        elif parts[0] == "exp9" and parts[1] != "graph":
            records.append({
                "section": "exp9_live",
                "graph": parts[1],
                "rate_qps": float(parts[2]),
                "cache": bool(int(parts[3])),
                "refresh": bool(int(parts[4])),
                "achieved_qps": float(parts[5]),
                "p50_ms": float(parts[6]),
                "p99_ms": float(parts[7]),
                "cache_hit_rate": float(parts[8]),
                "mean_occupancy": float(parts[9]),
                "epochs_served": int(parts[10]),
                "oracle_bad": int(parts[11]),
            })
        elif parts[0] == "exp10" and parts[1] != "graph":
            ov = int(parts[7])
            s = int(parts[3])
            records.append({
                "section": "exp10_scale",
                "graph": parts[1],
                "n": int(parts[2]),
                "S": s,
                "hierarchy_levels": int(parts[4]),
                "nsf": int(parts[5]),
                "S2": int(parts[6]),
                "overlay_bytes": ov,
                "overlay_dense_bytes": int(parts[8]),
                # the resident overlay tables are smaller than the dense
                # closure pair measured in the same row
                "sub_quadratic": ov < int(parts[8]),
                "build_s": float(parts[9]),
                "device_s": float(parts[10]),
                "refresh_s": float(parts[11]),
                "us_per_query": float(parts[12]),
                "oracle_bad": int(parts[13]),
            })
        elif parts[0] == "host_build" and parts[1] != "graph":
            records.append({
                "section": "host_build",
                "graph": parts[1],
                "build_workers": int(parts[2]),
                "wall_s": float(parts[3]),
            })
        elif parts[0] == "exp7" and parts[1] != "graph":
            records.append({
                "section": "exp7_refresh",
                "graph": parts[1],
                "round": int(parts[2]),
                "update_frac": float(parts[3]),
                "dirty_frag_frac": float(parts[4]),
                "decrease_only": bool(int(parts[5])),
                "refresh_s": float(parts[6]),
                "scratch_reweight_s": float(parts[7]),
                "scratch_pipeline_s": float(parts[8]),
                "refresh_over_scratch": float(parts[9]),
                "scratch_match": bool(int(parts[10])),
            })
    return records


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated section prefixes")
    ap.add_argument("--json", default=None,
                    help="append structured perf records to this file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> list[str]:
    """Run the selected sections on ``args.device`` -> the output lines
    (CSV rows and ``#`` timing lines)."""
    from ..core.device_engine import resolve_device
    from . import tables

    device = resolve_device(args.device)       # raises without a card
    only = set(args.only.split(",")) if args.only else None
    out: list[str] = []
    t_all = time.perf_counter()
    for fn in tables.ALL:
        name = fn.__name__
        if only and not any(name.startswith(o) for o in only):
            continue
        t0 = time.perf_counter()
        fn(out, device=device)
        out.append(f"# {name} took {time.perf_counter() - t0:.1f}s")
    out.append(f"# total {time.perf_counter() - t_all:.1f}s")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    print("\n".join(out))
    if args.json:
        from ..perflog import append_records
        records = _perf_records(out)
        append_records(args.json, records)
        print(f"# {len(records)} perf records appended to {args.json}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
