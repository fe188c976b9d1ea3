"""DISLAND serve CLI of the port.

Builds the index over a synthetic road graph (host build, then the
device build on the card), warms the serving front end up, serves
``--batches`` batches of ``--batch-size`` uniform random queries, prints
the build stage times, the median batch time and µs/query (and the
planner's buckets), and validates a sample of the last batch against
host Dijkstra (any mismatch exits non-zero).

``--mode`` picks the front end: ``planner`` (the default) buckets each
batch by case (``QueryPlanner``); ``fused`` runs the monolithic
``serve_step`` over the whole batch; ``sharded`` (alias ``--sharded``)
splits the batch over ``make_host_mesh(device=--device)`` (every
visible card, or the CPU) through ``serve_jit``, which is
``serve_sharded`` with the index replicas placed once.  ``fused`` and
``sharded`` warm up on a throwaway batch; every mode serves the same
batches.  ``--paths``, ``--live``, ``--update-batches`` and
``--check-build-parity`` need ``--mode planner``.

    PYTHONPATH=src python -m repro_torch.launch.serve --graph road4000
    PYTHONPATH=src python -m repro_torch.launch.serve --graph road64k \\
        --validate 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --nodes 900 --batches 1 --batch-size 64 --validate 16 --paths
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --nodes 900 --batches 2 --batch-size 64 --validate 16 \\
        --mode sharded

``--paths`` then serves ``--path-batches`` batches of
``--path-batch-size`` random pairs (default: ``--batches`` and
``--batch-size``) in witness mode, unwinds every answer to a node
sequence on the host with one ``PathUnwinder`` per index, prints the
median batch ms, µs/path, paths/s and mean hops, and validates
``--validate`` paths of the last batch: each must be edge-valid with
``path_weight == served distance == Dijkstra`` (any mismatch exits
non-zero).

``--update-batches N`` then absorbs N rounds of localized live-traffic
weight updates (``--update-frac`` of the edges each, ``traffic_updates``)
through an ``EpochedEngine``: each round refreshes the index
incrementally and publishes the next epoch, serves a batch on it and
validates ``--validate`` answers against Dijkstra, then rebuilds from
scratch twice (the full pipeline, and ``reweight_index`` + device build)
and checks that the refreshed epoch is array-equal to the reweight
rebuild on ``REFRESHED_FIELDS`` and the host sidecars; it prints the
refresh seconds by stage beside both rebuilds' and ``match=``.  With
``--paths`` the path loop runs again on the last epoch.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --nodes 900 --batches 1 --batch-size 64 --validate 16 \\
        --update-batches 2 --update-frac 0.02

``--hierarchy-levels`` picks the overlay closure (1 dense, 2..5 the
N-level hierarchy, auto; default the preset's, else auto) and
``--resident-mb`` the resident pre-lifted row budget on hierarchical
indices (0 disables).  On a hierarchical index the run prints the
per-level overlay shapes and memory (``hier_overlay_stats``) and the
resident group count.  ``--build-workers N`` computes the host build's
fragment covers in N spawned processes (array-equal to the serial
build; ``--check-build-parity`` rebuilds serially and counts any table
that differs as a failure).

``--live`` replaces the offline batch loop with the online serving
runtime (``repro_torch.serving``): an open-loop Poisson stream of
``--rate`` single requests for ``--live-seconds`` (a ``--mix`` of
uniform, Zipf or geo-local pairs) flows through the deadline-aware
micro-batcher, the epoch-tagged result cache, the hub-label hot tier
(``--hub-budget`` traffic-head nodes) and the planner, while a
background thread absorbs ``--live-update-batches`` refresh rounds; the
run prints p50/p95/p99 latency, offered and achieved qps, the tier
split, the batch occupancy and the longest serving gap, validates
``--validate`` responses against the Dijkstra oracle of the epoch that
served each, and prints its ``serve_live`` (and ``serve_refresh``)
record as one JSON line each.  The engine is built through the host
build's streaming handoff (``EpochedEngine(build_workers=)``).
``--metrics-out``/``--metrics-port`` export the runtime's registry,
``--trace-out`` writes the build, refresh and per-request spans as a
Chrome trace.

``--json PATH`` (default off) appends the run's records to the history
at PATH (``repro_torch.perflog``): ``host_build`` (every run),
``serve``, ``serve_paths``, ``refresh`` (one an epoch) and
``serve_live``/``serve_refresh``, each printed first beside the previous
record of its section and graph (``perflog.latest``).  Every record
carries the reference's keys of its section, ``backend`` the device
type among them, and the card it ran on: ``device_name`` and, on a
card, ``power_limit_w`` from nvidia-smi.  ``python -m
repro_torch.launch.bench_gate`` gates these records against the
committed ``BENCH_torch_serve.json``.  The port never writes the
reference's ``BENCH_serve.json``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --nodes 900 --live --rate 500 --live-seconds 1 \
        --live-update-batches 2 --hub-budget 64 --build-workers 2 \
        --check-build-parity
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..core import dijkstra
from ..core.device_engine import (build_device_index,
                                  build_device_index_with_plan,
                                  index_fields_equal, resolve_device,
                                  serve_step, sidecars_equal)
from ..core.hierarchy import hier_overlay_stats
from ..core.dist_engine import EpochedEngine, QueryPlanner, serve_jit
from ..core.graph import road_like, traffic_updates
from ..core.paths import PathUnwinder, path_weight
from ..core.supergraph import build_index, index_arrays_equal, reweight_index
from ..data.roads import road_preset
from ..obs import trace
from ..perflog import append_records, latest
from ..runtime import StragglerMonitor
from .mesh import make_host_mesh

# copied from src/repro/launch/serve.py:54
#: the tables a refresh re-derives; the refresh == rebuild check compares
#: them array for array (per-level tuples leaf by leaf; the hierarchical,
#: resident and hub ones are dummies where the index has none)
REFRESHED_FIELDS = ("frag_apsp", "frag_next", "brow", "d_super",
                    "super_next", "piece_flat", "piece_next",
                    "dist_to_agent",
                    "sf_closure", "sf_next", "l2row", "d2", "d2_next",
                    "res_rows", "res_of_frag",
                    "hub_rows", "hub_of_agent")


#: the serving front ends of ``--mode``
MODES = ("planner", "fused", "sharded")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--graph", default=None,
                    help="named road preset (overrides --nodes)")
    ap.add_argument("--hierarchy-levels", default=None,
                    help="overlay closure: 1 (dense), N in 2..5 (N-level "
                         "hierarchy) or auto; default: the preset's "
                         "setting, else auto")
    # copied from src/repro/launch/serve.py:556-561
    ap.add_argument("--expect-hierarchy", type=int, default=0,
                    help="fail unless the built index uses exactly "
                         "this many overlay levels (CI smoke sanity; "
                         "catches an auto build silently falling back "
                         "to a shallower hierarchy)")
    ap.add_argument("--max-s2-ratio", type=float, default=0.0,
                    help="fail if the level-2 boundary exceeds this "
                         "fraction of S (partitioner-quality gate; "
                         "0 disables)")
    ap.add_argument("--resident-mb", default="auto",
                    help="budget (MiB) for the resident pre-lifted rows "
                         "on hierarchical indices; 0 disables, auto uses "
                         "the built-in default")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--validate", type=int, default=64,
                    help="check this many answers of the last batch "
                         "against host Dijkstra (0 mismatches or exit 1)")
    ap.add_argument("--paths", action="store_true",
                    help="after the distance batches, serve random pairs "
                         "in witness mode, unwind them to paths and "
                         "validate --validate of them")
    ap.add_argument("--path-batches", type=int, default=None,
                    help="batches of the --paths loop (default --batches)")
    ap.add_argument("--path-batch-size", type=int, default=None,
                    help="pairs per --paths batch (default --batch-size)")
    ap.add_argument("--update-batches", type=int, default=0,
                    help="rounds of live-traffic weight updates, each "
                         "refreshed into a new epoch, served, validated "
                         "and checked against a scratch rebuild")
    ap.add_argument("--update-frac", type=float, default=0.02,
                    help="share of the edges each update round changes")
    ap.add_argument("--build-workers", type=int, default=1,
                    help="processes computing the host build's fragment "
                         "covers (array-equal to --build-workers 1)")
    ap.add_argument("--check-build-parity", action="store_true",
                    help="rebuild the host index serially and fail "
                         "unless the --build-workers build is array-"
                         "equal on every index table")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mode", choices=MODES, default="planner",
                    help="serving front end: the bucketing planner, the "
                         "monolithic serve_step, or serve_step sharded "
                         "over every visible device")
    ap.add_argument("--sharded", action="store_true",
                    help="alias for --mode sharded")
    # copied from src/repro/launch/serve.py:596-671 (live and
    # observability flags)
    live = ap.add_argument_group("live serving (--live)")
    live.add_argument("--live", action="store_true",
                      help="replace the offline batch loop with the "
                           "online serving runtime: open-loop arrivals "
                           "through micro-batching + result cache")
    live.add_argument("--rate", type=float, default=1500.0,
                      help="offered arrival rate, queries/sec")
    live.add_argument("--live-seconds", type=float, default=4.0,
                      help="load duration (requests = rate * seconds)")
    live.add_argument("--mix", choices=("uniform", "zipf", "geo"),
                      default="zipf", help="query mix")
    live.add_argument("--zipf-a", type=float, default=1.2,
                      help="Zipf exponent for --mix zipf")
    live.add_argument("--deadline-ms", type=float, default=2.0,
                      help="micro-batch flush deadline")
    live.add_argument("--live-batch", type=int, default=256,
                      help="micro-batch size cap (snapped to a planner "
                           "bucket size)")
    live.add_argument("--cache-size", type=int, default=65536,
                      help="result-cache capacity (0 disables)")
    live.add_argument("--hub-budget", type=int, default=0,
                      help="pin hub labels for up to this many "
                           "traffic-head nodes (the Zipf pool's top-"
                           "ranked endpoints); 0 disables the label "
                           "hot tier")
    live.add_argument("--hot-tier", type=float, default=0.0,
                      help="fail unless the label tier served at "
                           "least this fraction of cache misses "
                           "(requires --hub-budget)")
    live.add_argument("--live-update-batches", type=int, default=0,
                      help="concurrent background refresh rounds "
                           "during the load run")
    live.add_argument("--live-pipelined",
                      action=argparse.BooleanOptionalAction,
                      default=True,
                      help="stage each refresh round through the "
                           "prioritized pipeline (one epoch per work "
                           "item, traffic-weighted order, staleness "
                           "tags); --no-live-pipelined applies each "
                           "round as one epoch")
    live.add_argument("--max-serving-gap", type=float, default=0.0,
                      help="fail if no response completes for longer "
                           "than this many seconds during the live "
                           "run (0 disables)")
    live.add_argument("--live-wait-timeout", type=float, default=60.0,
                      help="seconds to wait for every response after "
                           "the load phase")
    live.add_argument("--live-join-timeout", type=float, default=900.0,
                      help="seconds to wait for background refresh "
                           "rounds to finish after the load phase")
    live.add_argument("--live-update-every", type=float, default=0.25,
                      help="seconds between background refresh rounds")
    obs = ap.add_argument_group("observability")
    obs.add_argument("--metrics-out", default="",
                     help="write periodic metrics snapshots (JSON + "
                          "Prometheus .prom sidecar) to this path "
                          "during --live ('' disables)")
    obs.add_argument("--metrics-every", type=float, default=2.0,
                     help="seconds between metrics snapshots")
    obs.add_argument("--metrics-port", type=int, default=0,
                     help="serve live Prometheus text at "
                          "127.0.0.1:PORT/metrics during --live "
                          "(0 disables)")
    obs.add_argument("--json", default="",
                     help="append the run's records to this JSON "
                          "history ('' disables: the default)")
    obs.add_argument("--trace-out", default="",
                     help="enable tracing spans and write the Chrome-"
                          "trace JSON here at exit (build, refresh, "
                          "and per-request serve spans)")
    args = ap.parse_args(argv)
    if args.sharded:
        args.mode = "sharded"
    # copied from src/repro/launch/serve.py:687-711, for the flags the
    # port has
    if args.expect_hierarchy and args.mode != "planner":
        # the gates run in the planner's build (_scale_gates); accepting
        # the flag elsewhere would silently skip the check it exists for
        ap.error("--expect-hierarchy requires --mode planner")
    if args.update_batches and args.mode != "planner":
        ap.error("--update-batches requires --mode planner")
    if args.check_build_parity and args.mode != "planner":
        ap.error("--check-build-parity requires --mode planner")
    if args.paths and args.mode != "planner":
        ap.error("--paths requires --mode planner")
    if args.live and args.mode != "planner":
        ap.error("--live requires --mode planner")
    if args.live and args.paths:
        ap.error("--paths is not supported with --live (the live "
                 "runtime serves distances only)")
    if args.hub_budget and not args.live:
        ap.error("--hub-budget requires --live (the label hot tier "
                 "is a serving-runtime tier)")
    if args.hot_tier and not args.hub_budget:
        ap.error("--hot-tier requires --hub-budget (no labels, no "
                 "label hits to gate on)")
    if (args.metrics_out or args.metrics_port) and not args.live:
        ap.error("--metrics-out/--metrics-port require --live (the "
                 "metrics registry lives on the serving runtime)")
    return args


def _levels_arg(value):
    """``--hierarchy-levels`` as the build takes it: "auto" or an int."""
    return value if value == "auto" else int(value)


def _overlay_record(dix, plan) -> dict:
    """Overlay-closure shapes and memory of the built index."""
    if plan.hierarchy_levels >= 2:
        rec = hier_overlay_stats(plan.hier, plan.S)
        rec["resident_groups"] = max(0, int(dix.res_rows.shape[0]) - 1)
        return rec
    dense = 2 * (plan.S + 1) * (plan.S + 1) * 4
    return {"hierarchy_levels": 1, "S": plan.S,
            "overlay_bytes": dense, "overlay_dense_bytes": dense}


@functools.lru_cache(maxsize=None)
def _power_limit_w(index: int) -> float | None:
    """The card's power limit in W from ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` (line ``index``), read once a
    card; None when nvidia-smi gives none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        return float(out[index].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def device_fields(device) -> dict:
    """What every record says of the device it ran on: ``backend`` (the
    device type, the reference's key), ``device_name`` (the card's name,
    or ``cpu``) and, on a card, ``power_limit_w``.  The gate keys its
    histories on ``device_name``, so card and CPU records never mix."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"backend": device.type, "device_name": device.type}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return {"backend": "cuda",
            "device_name": torch.cuda.get_device_name(index),
            "power_limit_w": _power_limit_w(index)}


# copied from src/repro/launch/serve.py:111-123
def host_build_record(args, timings: dict, device) -> dict:
    """``section: "host_build"`` perf record from the host index stage
    timings, the bench gate's ``host_build`` section: ``wall_s`` sums
    the numeric stage entries of ``timings`` as the reference does; the
    port's own total ``host_build_s`` is not a stage and is left out."""
    stages = {k: round(float(v), 4) for k, v in timings.items()
              if k != "host_build_s" and isinstance(v, (int, float))
              and not isinstance(v, bool)}
    return {
        "section": "host_build",
        "graph": args.graph or f"road{args.nodes}",
        **device_fields(device),
        "build_workers": int(getattr(args, "build_workers", 1) or 1),
        "wall_s": round(sum(stages.values()), 4),
        **{f"stage_{k}_s": v for k, v in stages.items()},
    }


# copied from src/repro/launch/serve.py:189-201
def _scale_gates(args: argparse.Namespace, ov: dict) -> None:
    """``--expect-hierarchy`` and ``--max-s2-ratio`` on the overlay
    record: exit (SystemExit, the reference's messages) when the built
    depth differs or the level-2 boundary is too large a share of S."""
    if args.expect_hierarchy and \
            ov["hierarchy_levels"] != args.expect_hierarchy:
        raise SystemExit(
            f"expected hierarchy_levels={args.expect_hierarchy}, "
            f"built {ov['hierarchy_levels']} (S={ov['S']})")
    if args.max_s2_ratio and ov["hierarchy_levels"] >= 2:
        ratio = ov["S2"] / max(1, ov["S"])
        if ratio > args.max_s2_ratio:
            raise SystemExit(
                f"level-2 boundary too large: S2={ov['S2']} / "
                f"S={ov['S']} = {ratio:.3f} > --max-s2-ratio "
                f"{args.max_s2_ratio}")
        print(f"S2/S ratio {ratio:.3f} <= {args.max_s2_ratio} (ok)")


def _build_knobs(args: argparse.Namespace) -> tuple:
    """(device, hierarchy levels, resident budget) of the run; a named
    preset sets ``args.nodes``."""
    device = resolve_device(args.device)
    levels = "auto"
    if args.graph:
        preset = road_preset(args.graph)
        args.nodes, levels = preset.nodes, preset.hierarchy
    if args.hierarchy_levels is not None:
        levels = _levels_arg(args.hierarchy_levels)
    resident_mb = (args.resident_mb if args.resident_mb == "auto"
                   else float(args.resident_mb))
    return device, levels, resident_mb


def _graph(args: argparse.Namespace):
    t0 = time.perf_counter()
    g = road_like(args.nodes, seed=args.seed)
    print(f"graph: n={g.n} m={g.m} ({time.perf_counter() - t0:.2f}s)")
    return g


def build_host(args: argparse.Namespace) -> tuple:
    """The run's graph and host index -> (graph, DislandIndex), the
    covers computed by ``--build-workers`` processes."""
    _build_knobs(args)
    g = _graph(args)
    t0 = time.perf_counter()
    ix = build_index(g, build_workers=args.build_workers)
    ix.timings["host_build_s"] = time.perf_counter() - t0
    print(f"host index: {ix.timings} (workers={args.build_workers})")
    return g, ix


def build_parity(args: argparse.Namespace, g, ix) -> dict:
    """``--check-build-parity``: the host index rebuilt serially must be
    array-equal to ``ix`` on every table (``index_arrays_equal``);
    returns the workers, the tables that differ and the seconds."""
    t0 = time.perf_counter()
    eq = index_arrays_equal(ix, build_index(g))
    took = time.perf_counter() - t0
    differ = sorted(k for k, ok in eq.items() if not ok)
    print(f"build parity: workers={args.build_workers} "
          + (f"DIFFERS from the serial build on {differ}" if differ
             else "== serial on all index tables")
          + f" ({took:.2f}s)")
    return {"workers": args.build_workers, "differ": differ, "s": took}


def _summary(args, g, ix, dix, plan, device, device_s: float) -> dict:
    """Print the device build and return the run's summary."""
    stages = {k: round(v, 3) for k, v in plan.build_timings.items()}
    print(f"device index on {device}: k={plan.k} maxf={plan.maxf} "
          f"mb={plan.mb} S={plan.S} pieces={plan.n_pieces} "
          f"stages={stages} ({device_s:.2f}s)")
    overlay = _overlay_record(dix, plan)
    if plan.hierarchy_levels >= 2:
        print(f"overlay hierarchy: {overlay['hierarchy_levels']} levels, "
              f"S={overlay['S']} -> levels_S2={overlay['levels_S2']} "
              f"(top S={overlay['S_top']}), "
              f"{overlay['overlay_bytes'] / 2**20:.1f} MiB (dense would be "
              f"{overlay['overlay_dense_bytes'] / 2**20:.1f} MiB), "
              f"{overlay['resident_groups']} resident groups")
    if args.mode == "planner":
        # the reference runs the gates in its planner setup only
        _scale_gates(args, overlay)
    hub_labels = int(dix.hub_rows.shape[0]) - 1
    if hub_labels:
        print(f"hub labels: {hub_labels} agents x {dix.hub_rows.shape[1]} "
              f"columns")
    return {
        "graph": args.graph or f"road{args.nodes}", "n": g.n,
        "device": str(device), "S": plan.S, "k": plan.k,
        "maxf": plan.maxf, "mb": plan.mb, "overlay": overlay,
        "hub_labels": hub_labels,
        "host_build_s": ix.timings["host_build_s"],
        "host_timings": dict(ix.timings),
        "device_build_s": device_s, "stages_s": dict(plan.build_timings)}


def build(args: argparse.Namespace, hub_nodes=None, host=None) -> tuple:
    """Graph, host index and device index of the run ->
    (graph, DeviceIndex, BuildPlan, summary of the build).
    ``hub_nodes`` pins the hub-label tier's node set (the offline CLI
    builds without one); ``host`` = (graph, host index) from
    ``build_host`` skips building those again."""
    device, levels, resident_mb = _build_knobs(args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    g, ix = build_host(args) if host is None else host
    t0 = time.perf_counter()
    dix, plan = build_device_index_with_plan(
        ix, device=device, hierarchy_levels=levels,
        resident_mb=resident_mb, hub_nodes=hub_nodes)
    device_s = time.perf_counter() - t0
    summary = _summary(args, g, ix, dix, plan, device, device_s)
    if args.check_build_parity:
        summary["build_parity"] = build_parity(args, g, ix)
    return g, dix, plan, summary


def _path_shape(args: argparse.Namespace) -> tuple[int, int]:
    """(batches, batch size) of the --paths loop."""
    return (args.batches if args.path_batches is None else args.path_batches,
            args.batch_size if args.path_batch_size is None
            else args.path_batch_size)


def _front_end(args: argparse.Namespace, g, dix):
    """The ``--mode`` front end, warmed up -> (fn(s, t) -> numpy
    answers, the planner or None, warmup seconds).  The planner warms
    every padded bucket size a batch can produce; ``fused`` and
    ``sharded`` serve one throwaway batch."""
    t0 = time.perf_counter()
    if args.mode == "planner":
        planner = QueryPlanner(dix, paths=args.paths)
        planner.warmup(max(args.batch_size, _path_shape(args)[1])
                       if args.paths else args.batch_size)
        return planner, planner, time.perf_counter() - t0
    if args.mode == "fused":
        def fn(s, t):
            return serve_step(dix, torch.as_tensor(s, device=dix.device),
                              torch.as_tensor(t, device=dix.device)
                              ).cpu().numpy()
    else:
        step = serve_jit(make_host_mesh(device=args.device), dix)

        def fn(s, t):
            return step(s, t).cpu().numpy()
    rng = np.random.default_rng(args.seed + 6)
    fn(rng.integers(0, g.n, args.batch_size),
       rng.integers(0, g.n, args.batch_size))
    return fn, None, time.perf_counter() - t0


def _median_s(monitor: StragglerMonitor) -> float:
    """The median of the batch times ``monitor`` recorded (NaN for no
    batch), as the reference reads ``StragglerMonitor.summary()``."""
    return monitor.summary()["median_s"] if monitor.times else float("nan")


def serve(args: argparse.Namespace, g, dix, summary: dict,
          plan=None) -> dict:
    """Warm the ``--mode`` front end up, serve the batches and validate
    against Dijkstra (then, with ``--paths``, the path loop, which needs
    the build's ``plan``); returns ``summary`` completed with the mode,
    the median batch ms, µs/query, the planner's buckets, peak device
    memory, the validation mismatch count and the path loop's record."""
    device = dix.device
    fn, planner, warmup_s = _front_end(args, g, dix)
    rng = np.random.default_rng(args.seed + 1)
    monitor = StragglerMonitor()
    last = None
    totals = (None if planner is None
              else dict.fromkeys(QueryPlanner.CASES, 0))
    for _ in range(args.batches):
        s = rng.integers(0, g.n, args.batch_size)
        t = rng.integers(0, g.n, args.batch_size)
        monitor.start()
        out = fn(s, t)                   # host copy: waits for the card
        monitor.stop()
        last = (s, t, out)
        if planner is not None:
            for case, count in planner.last_counts.items():
                totals[case] += count
    med = _median_s(monitor)
    per_q = med / args.batch_size
    print(f"served {args.batches * args.batch_size} queries "
          f"(--mode {args.mode}); median batch "
          f"{med * 1e3:.3f}ms -> {per_q * 1e6:.3f}us/query "
          f"({1 / per_q:,.0f} qps)")
    if planner is not None:
        print(f"planner buckets (all batches): {totals}")
    peak_mb = None
    if device.type == "cuda":
        peak_mb = torch.cuda.max_memory_allocated(device) / 2**20
        print(f"peak device memory (max_memory_allocated): "
              f"{peak_mb:.1f} MiB")

    bad = 0
    if args.validate and last is not None:
        s, t, got = last
        n_check = min(args.validate, len(s))
        for i in range(n_check):
            want = dijkstra.pair(g, int(s[i]), int(t[i]))
            bad += dijkstra.mismatches_oracle(want, float(got[i]))
        print(f"validation: {bad} mismatches of {n_check}")
    res = dict(
        summary, mode=args.mode, warmup_s=warmup_s,
        median_batch_ms=med * 1e3, us_per_query=per_q * 1e6,
        qps=1 / per_q, buckets=totals, peak_device_mb=peak_mb, mismatches=bad,
        answers_finite=bool(last is not None
                            and np.isfinite(last[2]).all()))
    if args.paths:
        res["paths"] = serve_paths(args, g, dix, plan, planner)
    return res


def _path_ok(g, s: int, t: int, dist: float, path) -> bool:
    """A served path is right: None exactly when t is unreachable, else
    it runs s -> t over real edges with weight == dist == Dijkstra."""
    want = dijkstra.pair(g, s, t)
    if path is None:
        return bool(np.isinf(want))
    if path[0] != s or path[-1] != t:
        return False
    try:
        weight = path_weight(g, path)
    except ValueError:                   # a hop that is not an edge
        return False
    return weight == float(dist) == want


def serve_paths(args: argparse.Namespace, g, dix, plan,
                planner: QueryPlanner) -> dict:
    """The path loop: random pairs through ``planner.query_witness``,
    unwound on the host by one ``PathUnwinder(dix, plan)``; validates
    ``--validate`` paths of the last batch.  Returns the loop's record
    (median batch ms with and without the unwind, µs/path, paths/s,
    mean hops, the validation mismatch count)."""
    batches, size = _path_shape(args)
    t0 = time.perf_counter()
    uw = PathUnwinder(dix, plan)
    unwinder_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 3)
    monitor, wit_monitor = StragglerMonitor(), StragglerMonitor()
    last = None
    for _ in range(batches):
        s = rng.integers(0, g.n, size)
        t = rng.integers(0, g.n, size)
        monitor.start()
        t0 = time.perf_counter()
        dist, wit = planner.query_witness(s, t, dix=dix)
        wit_monitor.observe(time.perf_counter() - t0)
        paths = uw.unwind_many(s, t, dist, wit)
        monitor.stop()
        last = (s, t, dist, paths)
    med, med_wit = _median_s(monitor), _median_s(wit_monitor)
    hops = [len(p) - 1 for p in last[3] if p is not None] if last else []
    mean_hops = float(np.mean(hops)) if hops else 0.0
    print(f"paths: {batches * size} unwound (unwinder {unwinder_s:.2f}s); "
          f"median batch {med * 1e3:.3f}ms (witness serving "
          f"{med_wit * 1e3:.3f}ms) -> {med / size * 1e6:.3f}us/path "
          f"({size / med:,.0f} paths/s, mean {mean_hops:.1f} hops)")
    bad = n_check = 0
    if args.validate and last is not None:
        s, t, dist, paths = last
        n_check = min(args.validate, len(s))
        bad = sum(not _path_ok(g, int(s[i]), int(t[i]), dist[i], paths[i])
                  for i in range(n_check))
        print(f"path validation: {bad} mismatches of {n_check} "
              f"(edge-valid, weight == served distance == Dijkstra)")
    return {"batches": batches, "batch_size": size,
            "unwinder_s": unwinder_s, "median_batch_ms": med * 1e3,
            "median_witness_ms": med_wit * 1e3,
            "us_per_path": med / size * 1e6, "paths_per_s": size / med,
            "mean_hops": mean_hops, "mismatches": bad, "validated": n_check}


def update_loop(engine: EpochedEngine, args: argparse.Namespace) -> list:
    """Absorb ``--update-batches`` rounds of localized traffic, serving
    and validating on each new epoch and checking it against scratch
    rebuilds; returns one record per round (refresh seconds by stage,
    both rebuilds' seconds, the mismatch count, ``scratch_match``)."""
    records = []
    plan = engine.plan
    rng = np.random.default_rng(args.seed + 2)
    for r in range(args.update_batches):
        u, v, w = traffic_updates(engine.g, args.update_frac,
                                  seed=args.seed + 10 + r)
        t0 = time.perf_counter()
        stats = engine.apply_updates(u, v, w)      # synchronised
        apply_s = time.perf_counter() - t0
        s = rng.integers(0, engine.g.n, args.batch_size)
        t = rng.integers(0, engine.g.n, args.batch_size)
        t0 = time.perf_counter()
        out = engine.query(s, t)                   # ends in a host copy
        serve_s = time.perf_counter() - t0
        n_check = min(args.validate, len(s))
        bad = sum(dijkstra.mismatches_oracle(
            dijkstra.pair(engine.g, int(s[i]), int(t[i])), float(out[i]))
            for i in range(n_check))
        # two from-scratch baselines on the updated graph: the full
        # pipeline (host build + device build), and the same structure
        # reweighted + device build, the refresh's exactness reference
        # (same depth, resident budget and hub set as the live plan)
        t0 = time.perf_counter()
        build_device_index(build_index(engine.g), device=engine.device,
                           hierarchy_levels=plan.hierarchy_levels)
        pipeline_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sdix = build_device_index(
            reweight_index(engine.ix, engine.g), device=engine.device,
            hierarchy_levels=plan.hierarchy_levels,
            resident_mb=plan.resident_mb, hub_nodes=plan.hub_nodes)
        reweight_s = time.perf_counter() - t0
        fields = index_fields_equal(engine.dix, sdix, REFRESHED_FIELDS)
        sides = sidecars_equal(engine.dix, sdix)
        differ = sorted(k for k, ok in {**fields, **sides}.items()
                        if not ok)
        # apply_s: the whole apply_updates (new graph, refresh, swap);
        # the record's refresh_s and stage_timings are refresh_index's
        rec = {"epoch": engine.epoch, "update_frac": args.update_frac,
               "apply_s": apply_s, "scratch_pipeline_s": pipeline_s,
               "scratch_reweight_s": reweight_s,
               "refresh_over_scratch": apply_s / pipeline_s,
               "refresh_over_reweight": apply_s / reweight_s,
               "post_refresh_mismatches": bad, "validated": n_check,
               "scratch_match": not differ, "differ": differ,
               "serve_batch_ms": serve_s * 1e3, **stats.as_record()}
        records.append(rec)
        print(f"epoch {engine.epoch}: refresh {apply_s * 1e3:.1f}ms "
              f"({rec['dirty_frags']} frags, {rec['dirty_pieces']} pieces, "
              f"decrease_only={stats.decrease_only}, "
              f"top_closure={stats.top_closure}, stages "
              f"{rec['stage_timings']}) -> "
              f"{apply_s / pipeline_s:.1%} of full pipeline "
              f"({pipeline_s:.2f}s), {apply_s / reweight_s:.1%} of "
              f"reweight rebuild ({reweight_s:.2f}s); validation {bad} "
              f"mismatches of {n_check}; match={not differ}"
              + (f" (differ: {differ})" if differ else ""))
    return records


# copied from src/repro/launch/serve.py:94
def _hub_selection(g, args) -> np.ndarray | None:
    """Traffic-head hub set for the label hot tier: the endpoints of the
    top-ranked rows of the Zipf pool the live workload draws from (same
    seed => bit-identical pool), first seen in rank order, capped at
    ``--hub-budget`` nodes.  Returns None when the budget is 0 (tier
    off)."""
    budget = args.hub_budget
    if not budget:
        return None
    from ..data.queries import zipf_pool

    pairs = zipf_pool(g, seed=args.seed + 4)
    flat = pairs.ravel()        # rank-interleaved (s1, t1, s2, t2, ...)
    _, first = np.unique(flat, return_index=True)
    return flat[np.sort(first)][:budget]


def build_engine(args: argparse.Namespace, host=None) -> tuple:
    """The run's ``EpochedEngine`` and the build's summary ->
    (engine, summary).  Without ``host`` the host build runs inside the
    engine through the streaming handoff, its covers in
    ``--build-workers`` processes beside the device build; ``host`` =
    (graph, host index) skips it.  ``--hub-budget`` pins the hub set
    (``_hub_selection``); the refresh warmup runs only when the run
    applies updates.  With ``--check-build-parity`` the summary gains
    ``build_parity``."""
    device, levels, resident_mb = _build_knobs(args)
    g, ix = (_graph(args), None) if host is None else host
    hub_nodes = _hub_selection(g, args)
    warm = bool(args.update_batches
                or (args.live and args.live_update_batches))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with trace.span("build.device_engine",
                    build_workers=args.build_workers, warm_refresh=warm):
        engine = EpochedEngine(
            g, ix=ix, device=device, paths=args.paths,
            hierarchy_levels=levels, resident_mb=resident_mb,
            hub_nodes=hub_nodes, warm_refresh=warm,
            build_workers=args.build_workers)
    engine_s = time.perf_counter() - t0
    timings = engine.ix.timings
    if "host_build_s" not in timings:        # streamed into the engine
        timings["host_build_s"] = sum(timings.values())
        print(f"host index: {timings} (workers={args.build_workers}, "
              f"covers beside the device build)")
    summary = _summary(args, g, engine.ix, engine.dix, engine.plan,
                       device, sum(engine.plan.build_timings.values()))
    summary["engine_s"] = engine_s
    print(f"engine: {engine_s:.2f}s (host build, device build"
          + (", refresh warmup" if warm else "") + ")")
    if args.check_build_parity:
        summary["build_parity"] = build_parity(args, g, engine.ix)
    return engine, summary


def run_epoched(args: argparse.Namespace) -> tuple:
    """The run with ``--update-batches``: build through an
    ``EpochedEngine``, serve epoch 0 (``serve``), then ``update_loop``
    and, with ``--paths``, the path loop again on the last epoch.
    Returns (engine, summary)."""
    engine, summary = build_engine(args, host=build_host(args))
    res = serve(args, engine.g, engine.dix, summary, engine.plan)
    res["refresh"] = update_loop(engine, args)
    if args.paths:
        print(f"paths on epoch {engine.epoch}:")
        res["paths_last_epoch"] = serve_paths(
            args, engine.g, engine.dix, engine.plan, engine.planner)
    return engine, res


# copied from src/repro/launch/serve.py:361-407
def _start_obs(args, runtime) -> dict:
    """Wire the live runtime's registry to the exporters the CLI asked
    for (--metrics-out periodic snapshots + Prometheus text sidecar,
    --metrics-port HTTP endpoint).  Returns the handles to stop."""
    handles: dict = {}
    if args.metrics_out:
        from ..obs import MetricsExporter

        handles["exporter"] = MetricsExporter(
            runtime.registry, args.metrics_out,
            interval_s=args.metrics_every,
            extra=lambda: {
                "slow_queries": runtime.slow_log.records()}).start()
    if args.metrics_port:
        from ..obs import MetricsServer

        srv = MetricsServer(runtime.registry, args.metrics_port).start()
        handles["server"] = srv
        print(f"metrics: http://127.0.0.1:{srv.port}/metrics")
    return handles


def _stop_obs(args, handles: dict) -> None:
    exporter = handles.get("exporter")
    if exporter is not None:
        exporter.stop()
        print(f"metrics: {exporter.writes} snapshot(s) -> "
              f"{args.metrics_out} (+ .prom exposition)")
    server = handles.get("server")
    if server is not None:
        server.stop()


def _write_trace(args) -> None:
    """Drain the default tracer into a Chrome-trace file
    (--trace-out; load it in chrome://tracing or Perfetto)."""
    if not args.trace_out:
        return
    from ..obs.export import write_chrome_trace

    tr = trace.get_tracer()
    events = tr.events()
    write_chrome_trace(args.trace_out, events)
    dropped = f" ({tr.dropped} dropped)" if tr.dropped else ""
    print(f"trace: {len(events)} event(s) -> {args.trace_out}"
          f"{dropped}")


def live_loop(engine: EpochedEngine, args: argparse.Namespace) -> dict:
    """The online serving runtime under open-loop load, with
    ``--live-update-batches`` concurrent refresh rounds (copied from
    src/repro/launch/serve.py:410).  Returns ``{"serve_live": record,
    "serve_refresh": record or None, "gate_failures": [...]}``; each
    record is also printed as one JSON line.  The reference's asserts
    and exits (oracle mismatches, ``--max-serving-gap``,
    ``--hot-tier``) become the record's ``oracle_bad`` and the
    ``gate_failures`` messages, which ``failures`` counts."""
    from ..serving import (ServingRuntime, run_load_with_refresh,
                           validate_against_epochs, workload_pairs)

    runtime = ServingRuntime(engine, max_batch=args.live_batch,
                             deadline_s=args.deadline_ms * 1e-3,
                             cache_size=args.cache_size)
    tm: dict = {}
    with trace.timed("serve.warmup", tm, "warmup"):
        runtime.warmup()
    print(f"live: warmed {runtime.max_batch}-cap buckets in "
          f"{tm['warmup']:.1f}s; deadline "
          f"{args.deadline_ms}ms, cache "
          f"{args.cache_size or 'off'}, mix {args.mix}")
    n = max(1, int(round(args.rate * args.live_seconds)))
    pairs = workload_pairs(engine.g, args.mix, n, seed=args.seed + 4,
                           zipf_a=args.zipf_a)
    obs_handles = _start_obs(args, runtime)
    try:
        report, graphs, driver = run_load_with_refresh(
            runtime, pairs, rate_qps=args.rate, seed=args.seed + 5,
            refresh_rounds=args.live_update_batches,
            refresh_frac=args.update_frac,
            refresh_interval_s=args.live_update_every,
            refresh_seed=args.seed,
            refresh_pipelined=args.live_pipelined,
            wait_timeout_s=args.live_wait_timeout,
            join_timeout_s=args.live_join_timeout)
        runtime.close()
    finally:
        _stop_obs(args, obs_handles)
    epochs = sorted({r.epoch for r in report.requests})
    stats = runtime.stats()
    # per-tier resolution split: every response came from exactly one
    # of cache / label merge / planner dispatch
    label_rate = stats["label_hits"] / max(
        1, stats["label_hits"] + stats["planner_dispatches"])
    print(f"live: {report.n_requests} requests at "
          f"{report.offered_qps:.0f} qps offered / "
          f"{report.achieved_qps:.0f} achieved; latency p50 "
          f"{report.p50_ms}ms p95 {report.p95_ms}ms p99 "
          f"{report.p99_ms}ms "
          f"({report.latency_source}, n={report.latency_n}); "
          f"tiers: {stats['cache_hits']} cache / "
          f"{stats['label_hits']} label / "
          f"{stats['planner_dispatches']} planner "
          f"({stats.get('cache_hit_rate', 0.0):.1%} cache hit rate, "
          f"{stats.get('cache_stale', 0)} stale rejected; label tier "
          f"took {label_rate:.1%} of misses at "
          f"{stats['label_us_per_query']:.0f}us/q vs planner "
          f"{stats['planner_us_per_query']:.0f}us/q); "
          f"{stats['flushes']} flushes, mean occupancy "
          f"{stats['mean_occupancy']:.1%} "
          f"(full={stats['flush_full']} "
          f"deadline={stats['flush_deadline']}); epochs served "
          f"{epochs}")
    slow = runtime.slow_log.records()
    if slow:
        w0 = slow[0]
        print(f"slow queries: worst {w0['latency_ms']:.0f}ms "
              f"(tier {w0['tier']}, epoch {w0['epoch']}, waited "
              f"{w0['batch_wait_ms']:.0f}ms in a "
              f"{w0['batch_size']}-request batch); {len(slow)} logged "
              f"of {runtime.slow_log.offered}")
    if args.live_update_batches:
        print(f"live staleness: max serving gap "
              f"{report.max_serving_gap_ms:.0f}ms, "
              f"{report.stale_responses} responses from mid-pipeline "
              f"epochs, max lag {report.max_staleness_batches} "
              "batch(es)")
    evicted = driver.evicted_epochs if driver is not None else ()
    checked, bad = validate_against_epochs(
        report.requests, graphs, sample=args.validate, seed=args.seed,
        evicted=evicted)
    print(f"live validation: {bad} mismatches of {checked} vs the "
          "host oracle of each response's serving epoch")
    gate_failures = []
    if args.max_serving_gap and \
            report.max_serving_gap_ms > args.max_serving_gap * 1e3:
        gate_failures.append(
            f"serving stalled: max gap {report.max_serving_gap_ms:.0f}"
            f"ms > --max-serving-gap {args.max_serving_gap}s")
    if args.hot_tier and label_rate < args.hot_tier:
        gate_failures.append(
            f"hot tier underused: label tier served {label_rate:.1%} "
            f"of cache misses < --hot-tier {args.hot_tier:.1%}")
    for msg in gate_failures:
        print(f"live gate FAILED: {msg}")
    rec = {
        "section": "serve_live",
        "graph": args.graph or f"road{args.nodes}",
        "device": str(engine.device),
        **device_fields(engine.device),
        "mix": args.mix,
        "rate_qps": args.rate,
        "deadline_ms": args.deadline_ms,
        "max_batch": runtime.max_batch,
        "cache": "on" if args.cache_size else "off",
        "refresh": "on" if args.live_update_batches else "off",
        "hub_budget": args.hub_budget,
        "label_hit_rate": round(label_rate, 4),
        "epochs_served": len(epochs),
        "oracle_checked": checked,
        "oracle_bad": bad,
        **report.as_record(),
    }
    refresh_rec = None
    if driver is not None:
        rec.update(driver.as_record())
        refresh_rec = {
            "section": "serve_refresh",
            "graph": rec["graph"],
            "device": rec["device"],
            **device_fields(engine.device),
            "mix": args.mix,
            "rate_qps": args.rate,
            "update_frac": args.update_frac,
            "pipelined": args.live_pipelined,
            "max_serving_gap_ms": report.max_serving_gap_ms,
            "stale_responses": report.stale_responses,
            "max_staleness_batches": report.max_staleness_batches,
            "epochs_served": len(epochs),
            **driver.as_record(),
        }
    for r in (rec, refresh_rec):
        if r is not None:
            print(json.dumps(r))
    return {"serve_live": rec, "serve_refresh": refresh_rec,
            "gate_failures": gate_failures}


def run_live(args: argparse.Namespace, host=None) -> tuple:
    """The run with ``--live``: ``build_engine``, ``live_loop`` and,
    with ``--update-batches``, ``update_loop`` after it.  Returns
    (engine, summary)."""
    engine, res = build_engine(args, host)
    res["live"] = live_loop(engine, args)
    if args.update_batches:
        res["refresh"] = update_loop(engine, args)
    return engine, res


def run(args: argparse.Namespace) -> dict:
    """Build, warm up, serve and validate (and the path loop with
    ``--paths``, the update rounds with ``--update-batches``, the live
    runtime with ``--live``); returns the run's summary (stage seconds,
    overlay shapes, median batch ms, µs/query, planner buckets, the
    validation mismatch counts, the live records).  ``--trace-out``
    traces the whole run."""
    if args.trace_out:
        # on before the build, so build and refresh spans land in the
        # same trace as the serve lifecycle events
        trace.get_tracer().enable()
    if args.live:
        res = run_live(args)[1]
    elif args.update_batches:
        res = run_epoched(args)[1]
    else:
        g, dix, plan, summary = build(args)
        res = serve(args, g, dix, summary, plan)
    _write_trace(args)
    if args.json:
        write_records(args.json, records(args, res))
    return res


#: what identifies "the same run" of a section when the previous record
#: is looked up
_PREV_KEYS = {"host_build": ("graph", "build_workers"),
              "serve": ("graph", "mode"), "serve_paths": ("graph",),
              "refresh": ("graph",), "serve_live": ("graph", "mix",
                                                     "rate_qps", "cache",
                                                     "refresh"),
              "serve_refresh": ("graph", "mix", "rate_qps")}


def records(args: argparse.Namespace, res: dict) -> list:
    """The run's records, as ``run`` returns them in ``res``: one
    ``host_build`` record (the host build's stages), one ``serve``
    record (the offline batches), one ``serve_paths`` a path loop, one
    ``refresh`` an update round, and the live records; each with its
    ``section``, ``graph``, ``device`` and ``device_fields``, and with
    every key of the reference's record of its section."""
    graph = args.graph or f"road{args.nodes}"
    device = res.get("device")
    base = {"graph": graph, "device": device,
            **(device_fields(device) if device else {})}
    out = []
    if "host_timings" in res:
        out.append({**host_build_record(args, res["host_timings"],
                                        device), "device": device})
    if "median_batch_ms" in res:
        out.append({"section": "serve", **base, "mode": res["mode"],
                    "batch_size": args.batch_size,
                    **{k: res[k] for k in (
                        "median_batch_ms", "us_per_query", "qps",
                        "warmup_s", "peak_device_mb", "mismatches",
                        "host_build_s", "device_build_s")},
                    **res["overlay"]})
    for key in ("paths", "paths_last_epoch"):
        if key in res:
            out.append({"section": "serve_paths", **base,
                        "last_epoch": key == "paths_last_epoch",
                        **res[key]})
    for rec in res.get("refresh", ()):
        out.append({"section": "refresh", **base,
                    "initial_build_s": res.get("engine_s"), **rec})
    live = res.get("live")
    if live:
        out += [r for r in (live["serve_live"], live["serve_refresh"]) if r]
    return out


def write_records(path: str, recs: list) -> list:
    """Print each record's previous one (``perflog.latest`` over its
    section's keys), then append ``recs`` to the history at ``path``."""
    for rec in recs:
        keys = _PREV_KEYS.get(rec["section"], ("graph",))
        prev = latest(path, section=rec["section"],
                      **{k: rec.get(k) for k in keys})
        print(f"previous {rec['section']} record: "
              f"{json.dumps(prev, default=str) if prev else None}")
    append_records(path, json.loads(json.dumps(recs, default=str)))
    print(f"{len(recs)} record(s) appended to {path}")
    return recs


def failures(res: dict) -> int:
    """Mismatches of every check a run made, refreshed epochs that
    differ from their scratch rebuild, a parallel host build that
    differs from the serial one, and failed live gates."""
    live = res.get("live")
    return (res.get("mismatches", 0)
            + res.get("paths", {}).get("mismatches", 0)
            + res.get("paths_last_epoch", {}).get("mismatches", 0)
            + sum(r["post_refresh_mismatches"] + (not r["scratch_match"])
                  for r in res.get("refresh", ()))
            + bool(res.get("build_parity", {}).get("differ"))
            + (live["serve_live"]["oracle_bad"]
               + len(live["gate_failures"]) if live else 0))


def main(argv=None) -> int:
    return 1 if failures(run(parse_args(argv))) else 0


if __name__ == "__main__":
    sys.exit(main())
