# Copied from scripts/bench_gate.py; keep the two in step.  The port's
# changes: it runs ``repro_torch.launch.serve`` with ``--device``, reads
# through ``repro_torch.perflog``, gates against the port's own history
# (``BENCH_torch_serve.json``) and adds ``device_name`` to every
# section's match.
"""Perf-regression gate for the port's serve path.

Runs the port's serve smoke with ``--json`` into a fresh records file,
then compares the fresh µs/query against the *median of the last N
committed* ``BENCH_torch_serve.json`` records for the same config
(section/graph/mode/backend/device_name/batch_size).  Fails (exit 1)
when the fresh number exceeds ``--factor`` x that median — 2.5x by
default, deliberately loose because shared machines are noisy; the gate
exists to catch order-of-magnitude mistakes (an accidental [q, mb, mb]
materialization, a kernel falling back to its plain version, a host
loop in the serving path), not 10% drift.  The median-of-history
baseline makes one slow committed record unable to poison the gate in
either direction.

Every section's config key carries ``device_name`` (the card's name, or
``cpu``): card and CPU histories never mix, nor do two card models, by
the same rule that keeps road4000 and road64k apart.  The committed
history holds only card records, each beside the card's name and power
limit (``power_limit_w``); ``chip_smoke.py``'s ``gate`` phase runs the
gate on the card.

``--live`` gates the *online* serving runtime instead: a short open-loop
``serve --live`` run with concurrent refresh, compared on p99 latency
against committed ``section: "serve_live"`` records of the same config
(graph/backend/device_name/mix/rate/cache/refresh — a separate section
key, so the offline-serve and live-serve histories never mix).  Same
2.5x median rule; the run also re-asserts the per-epoch oracle check,
so the gate doubles as a consistency smoke.

``--refresh`` gates the concurrent-refresh path (``section:
"serve_refresh"``, emitted by every ``--live`` run that refreshes):
BOTH the refresh wall time (``refresh_max_s``) and the longest
foreground serving gap (``max_serving_gap_ms``) must stay within
``--factor`` x their committed medians — the second metric is the
stop-the-world detector, failing long before wall time moves if a
change re-serializes refresh against the serving flushes.

``--host-build`` gates the staged host preprocessing pipeline
(``section: "host_build"``, emitted by every serve run) on wall
seconds, keyed (section, graph, device_name) — same 2.5x median rule.
It catches a host build stage quietly regressing to a Python-loop
implementation long before any serve-path number moves.

Every fresh ``serve_live`` record must additionally carry the per-tier
serving fields (``cache_hits`` / ``label_hits`` /
``planner_dispatches`` plus the per-tier latencies); a record missing
them fails loudly.  The same rule covers the histogram-latency fields:
a fresh ``serve_live`` record must report p50/p95/p99 derived from the
runtime's streaming latency histogram (``latency_source ==
"histogram"``, with ``latency_n`` observations), so the gated p99 is the
same bounded-memory number a production metrics scraper would read.

    python -m repro_torch.launch.bench_gate                  # on the card
    python -m repro_torch.launch.bench_gate --live           # live p99 gate
    python -m repro_torch.launch.bench_gate --refresh        # refresh + gap
    python -m repro_torch.launch.bench_gate --host-build     # host build
    python -m repro_torch.launch.bench_gate --inject-slowdown 10
        # self-test: the fresh measurement is multiplied by 10x, which
        # MUST fail the gate
    python -m repro_torch.launch.bench_gate --device cpu --nodes 600 \\
        --batches 1 --batch-size 64 --history H.json --fresh F.json

With no matching history (a new graph/mode/backend/card config) the
gate warns and passes: a config's first record cannot regress against
itself.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


# copied from scripts/bench_gate.py:71
def ensure_distinct_files(fresh: str, history: str) -> None:
    """The fresh run's records file and the committed history must be
    different files: if they alias, the fresh record would land in the
    history *before* the median is taken and be included in its own
    baseline — a gate that can never fail.  Checked up front, loudly.
    """
    if os.path.realpath(fresh) == os.path.realpath(history):
        raise SystemExit(
            f"bench_gate: --fresh and --history resolve to the same "
            f"file ({os.path.realpath(fresh)}); the fresh record would "
            "be included in its own median baseline")


# copied from scripts/bench_gate.py:85
def history_window(records: list, match: dict, metric: str,
                   last: int) -> list:
    """The metric values of the last ``last`` committed records
    matching ``match`` — with malformed records failing LOUDLY.

    Three malformation classes would otherwise silently shrink (or
    worse, mix) the window: a record with no ``section`` field cannot
    be classified into the offline-serve vs serve_live histories at
    all (their metrics have different units — µs/query vs ms p99 — so
    a misclassified record poisons the median); a record with no
    ``graph`` field cannot be keyed to a graph scale, and the
    (section, graph) pair IS the history key — a road64k µs/query
    landing in the road4000 window would inflate the median and mask
    any road4000 regression; and a record that matches every identity
    key but lacks a numeric ``metric`` is a half-written entry that
    used to just vanish from the window.
    """
    window = []
    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or "section" not in rec:
            raise SystemExit(
                f"bench_gate: malformed history record #{i}: no "
                f"'section' field (cannot classify offline vs live, "
                f"units would mix): {rec!r}")
        if "graph" not in rec:
            raise SystemExit(
                f"bench_gate: malformed history record #{i}: no "
                f"'graph' field (road4000 and road64k histories would "
                f"mix — scales differ by orders of magnitude): {rec!r}")
        if not all(rec.get(k) == v for k, v in match.items()):
            continue
        val = rec.get(metric)
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            raise SystemExit(
                f"bench_gate: history record #{i} matches "
                f"{match} but has no numeric {metric!r}: {val!r}")
        window.append(val)
    return window[-last:]


# per-tier serving fields every FRESH serve_live record must carry; the
# check runs on fresh records only, so a runtime that stops attributing
# responses per tier fails here
TIER_FIELDS = ("cache_hits", "label_hits", "planner_dispatches",
               "label_us_per_query", "planner_us_per_query",
               "label_hit_rate", "hub_budget")


def require_tier_fields(rec: dict) -> None:
    missing = [f for f in TIER_FIELDS if f not in rec]
    if missing:
        raise SystemExit(
            f"bench_gate: fresh serve_live record is missing per-tier "
            f"fields {missing} — the serving runtime no longer "
            "attributes responses to cache/label/planner tiers")


# histogram-provenance fields every FRESH serve_live record must carry:
# the gated p99_ms comes from the runtime's streaming latency histogram,
# and latency_source/latency_n say so explicitly.  A fresh run that
# stops reporting histogram-derived percentiles (or silently falls back
# to the sampled path) fails here.
HIST_FIELDS = ("p50_ms", "p95_ms", "p99_ms", "latency_source",
               "latency_n")


def require_hist_fields(rec: dict) -> None:
    missing = [f for f in HIST_FIELDS if f not in rec]
    if missing:
        raise SystemExit(
            f"bench_gate: fresh serve_live record is missing "
            f"histogram-latency fields {missing} — the load report no "
            "longer carries streaming-histogram percentiles "
            "(DESIGN.md §16)")
    if rec.get("latency_source") != "histogram":
        raise SystemExit(
            f"bench_gate: fresh serve_live record has latency_source="
            f"{rec.get('latency_source')!r}, not 'histogram' — the "
            "runtime's streaming latency histogram missed requests and "
            "the report fell back to the sampled path")


def _run_serve_cmd(args, extra: list, record_filter: dict) -> dict:
    """Run the port's serve driver as a subprocess with ``extra`` flags
    and return the fresh record matching ``record_filter`` (or die)."""
    from ..perflog import latest

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--nodes", str(args.nodes),
           "--validate", str(args.validate),
           "--device", args.device,
           "--json", args.fresh] + extra
    print("bench_gate: running", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO, env=env)
    rec = latest(args.fresh, graph=f"road{args.nodes}",
                 **record_filter)
    if rec is None:
        raise SystemExit(
            f"bench_gate: serve run produced no "
            f"{record_filter.get('section')} record")
    return rec


def run_serve(args) -> dict:
    """Run the serve smoke as a subprocess, return its fresh record."""
    return _run_serve_cmd(
        args,
        ["--batches", str(args.batches),
         "--batch-size", str(args.batch_size), "--mode", args.mode],
        {"section": "serve", "mode": args.mode,
         "batch_size": args.batch_size})


def run_live(args) -> dict:
    """Run the live-serving smoke as a subprocess, return its fresh
    ``serve_live`` record (which must carry the per-tier fields)."""
    rec = _run_serve_cmd(
        args,
        ["--live", "--rate", str(args.rate),
         "--live-seconds", str(args.live_seconds), "--mix", args.mix,
         "--live-update-batches", str(args.live_update_batches)],
        {"section": "serve_live", "mix": args.mix,
         "rate_qps": args.rate})
    require_tier_fields(rec)
    require_hist_fields(rec)
    return rec


def run_refresh(args) -> dict:
    """Run the live smoke WITH concurrent refresh and return its fresh
    ``serve_refresh`` record (the per-run refresh/staleness summary the
    driver emits alongside ``serve_live``)."""
    from ..perflog import latest

    rec = _run_serve_cmd(
        args,
        ["--live", "--rate", str(args.rate),
         "--live-seconds", str(args.live_seconds), "--mix", args.mix,
         "--live-update-batches",
         str(max(1, args.live_update_batches))],
        {"section": "serve_refresh", "mix": args.mix,
         "rate_qps": args.rate})
    # the same run emitted a serve_live record — hold it to the same
    # per-tier field contract even when only the refresh path is gated
    live_rec = latest(args.fresh, graph=f"road{args.nodes}",
                      section="serve_live")
    if live_rec is not None:
        require_tier_fields(live_rec)
        require_hist_fields(live_rec)
    return rec


def run_host_build(args) -> dict:
    """Run a minimal serve smoke and return its fresh ``host_build``
    record — the staged host preprocessing pipeline's wall seconds,
    emitted by every serve run."""
    return _run_serve_cmd(
        args,
        ["--batches", "1", "--batch-size", "256",
         "--build-workers", str(args.build_workers)],
        {"section": "host_build",
         "build_workers": args.build_workers})


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--history", default=os.path.join(
        REPO, "BENCH_torch_serve.json"),
        help="committed perf-record history to gate against")
    ap.add_argument("--fresh", default=os.path.join(
        REPO, "bench_gate_fresh_torch.json"),
        help="where the fresh run's records land")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the serve runs on (passed to the serve "
                         "CLI)")
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--validate", type=int, default=16)
    ap.add_argument("--mode", default="planner")
    ap.add_argument("--last", type=int, default=5,
                    help="history records to take the median over")
    ap.add_argument("--factor", type=float,
                    default=float(os.environ.get("BENCH_GATE_FACTOR",
                                                 "2.5")),
                    help="fail when fresh > factor * median(history); "
                         "overridable via BENCH_GATE_FACTOR (the "
                         "committed baseline is machine-relative — if "
                         "a machine class is uniformly slower than "
                         "the recording machine, widen the factor or "
                         "commit a record measured there rather than "
                         "deleting the gate)")
    ap.add_argument("--inject-slowdown", type=float, default=1.0,
                    help="multiply the fresh measurement (gate "
                         "self-test hook; >= factor must fail)")
    live = ap.add_argument_group("live-serve gate (--live)")
    live.add_argument("--live", action="store_true",
                      help="gate the online serving runtime's p99 "
                           "latency (section serve_live) instead of "
                           "the offline us/query")
    live.add_argument("--rate", type=float, default=500.0,
                      help="offered qps for the live smoke")
    live.add_argument("--live-seconds", type=float, default=3.0)
    live.add_argument("--mix", default="zipf")
    live.add_argument("--live-update-batches", type=int, default=1,
                      help="concurrent refresh rounds during the "
                           "live smoke")
    hb = ap.add_argument_group("host-build gate (--host-build)")
    hb.add_argument("--host-build", action="store_true",
                    help="gate the staged host preprocessing pipeline "
                         "(section host_build) on wall seconds, keyed "
                         "(section, graph, device_name) — same median "
                         "rule; catches a host stage regressing to a "
                         "Python loop long before the serve numbers "
                         "move")
    hb.add_argument("--build-workers", type=int, default=2,
                    help="cover workers for the host-build smoke")
    live.add_argument("--refresh", action="store_true",
                      help="gate the concurrent-refresh path (section "
                           "serve_refresh) instead: refresh wall time "
                           "(refresh_max_s) AND the longest foreground "
                           "serving gap (max_serving_gap_ms) both gate "
                           "against their committed medians")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..perflog import read_records

    ensure_distinct_files(args.fresh, args.history)
    if args.host_build:
        fresh = run_host_build(args)
        checks = [("wall_s", "s host build")]
        # keyed (section, graph, card) only: the serial-parity contract
        # makes the worker count a non-identity knob — every worker
        # setting must stay within the factor of the committed wall time
        match = {"section": "host_build", "graph": f"road{args.nodes}",
                 "device_name": fresh.get("device_name")}
        desc = (f"road{args.nodes}/host_build/"
                f"{fresh.get('device_name')}")
    elif args.refresh:
        fresh = run_refresh(args)
        # two metrics gate together: the refresh must not get slower
        # AND the foreground must keep serving while it runs (a
        # regression to stop-the-world shows up as a huge serving gap
        # long before refresh wall time moves)
        checks = [("refresh_max_s", "s refresh"),
                  ("max_serving_gap_ms", "ms gap")]
        match = {"section": "serve_refresh",
                 "graph": f"road{args.nodes}",
                 "backend": fresh.get("backend"),
                 "device_name": fresh.get("device_name"), "mix": args.mix,
                 "rate_qps": args.rate,
                 "pipelined": fresh.get("pipelined")}
        desc = (f"road{args.nodes}/refresh/{args.mix}"
                f"@{args.rate:.0f}qps/"
                f"pipelined={fresh.get('pipelined')}/"
                f"{fresh.get('backend')}/{fresh.get('device_name')}")
    elif args.live:
        fresh = run_live(args)
        checks = [("p99_ms", "ms p99")]
        # separate section + config key: live histories never mix with
        # offline serve records or with differently-shaped live runs
        match = {"section": "serve_live", "graph": f"road{args.nodes}",
                 "backend": fresh.get("backend"),
                 "device_name": fresh.get("device_name"), "mix": args.mix,
                 "rate_qps": args.rate, "cache": fresh.get("cache"),
                 "refresh": fresh.get("refresh")}
        desc = (f"road{args.nodes}/live/{args.mix}@{args.rate:.0f}qps/"
                f"cache={fresh.get('cache')}/"
                f"refresh={fresh.get('refresh')}/"
                f"{fresh.get('backend')}/{fresh.get('device_name')}")
    else:
        fresh = run_serve(args)
        checks = [("us_per_query", "us/query")]
        match = {"section": "serve", "graph": f"road{args.nodes}",
                 "mode": args.mode, "backend": fresh.get("backend"),
                 "device_name": fresh.get("device_name"),
                 "batch_size": args.batch_size}
        desc = (f"road{args.nodes}/{args.mode}/{fresh.get('backend')}/"
                f"{fresh.get('device_name')}/b{args.batch_size}")

    history = read_records(args.history)
    failed = 0
    for metric, unit in checks:
        fresh_val = fresh[metric] * args.inject_slowdown
        if args.inject_slowdown != 1.0:
            print(f"bench_gate: INJECTED {args.inject_slowdown}x "
                  f"slowdown ({fresh[metric]} -> {fresh_val:.3f}{unit})")
        window = history_window(history, match, metric, args.last)
        if not window:
            print(f"bench_gate: PASS [{metric}] (no committed history "
                  f"for {desc} in {args.history}; nothing to regress "
                  f"against)")
            continue
        baseline = statistics.median(window)
        limit = args.factor * baseline
        print(f"bench_gate: [{metric}] fresh {fresh_val:.3f}{unit} vs "
              f"median of last {len(window)} committed records "
              f"{baseline:.3f}{unit} (limit {limit:.3f} = "
              f"{args.factor}x)")
        if fresh_val > limit:
            print(f"bench_gate: FAIL — [{metric}] {fresh_val:.3f}{unit} "
                  f"is {fresh_val / baseline:.2f}x the committed "
                  f"median (allowed {args.factor}x)")
            failed = 1
        else:
            print(f"bench_gate: PASS [{metric}]")
    return failed


if __name__ == "__main__":
    sys.exit(main())
