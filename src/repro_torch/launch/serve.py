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
        --nodes 900 --batches 1 --batch-size 64 --validate 16 --paths

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
resident group count.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..core import dijkstra
from ..core.device_engine import (build_device_index,
                                  build_device_index_with_plan,
                                  index_fields_equal, resolve_device,
                                  sidecars_equal)
from ..core.hierarchy import hier_overlay_stats
from ..core.dist_engine import EpochedEngine, QueryPlanner
from ..core.graph import road_like, traffic_updates
from ..core.paths import PathUnwinder, path_weight
from ..core.supergraph import build_index, reweight_index
from ..data.roads import road_preset

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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--graph", default=None,
                    help="named road preset (overrides --nodes)")
    ap.add_argument("--hierarchy-levels", default=None,
                    help="overlay closure: 1 (dense), N in 2..5 (N-level "
                         "hierarchy) or auto; default: the preset's "
                         "setting, else auto")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


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


def build_host(args: argparse.Namespace) -> tuple:
    """The run's graph and host index -> (graph, DislandIndex)."""
    _build_knobs(args)
    t0 = time.perf_counter()
    g = road_like(args.nodes, seed=args.seed)
    print(f"graph: n={g.n} m={g.m} ({time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    ix = build_index(g)
    ix.timings["host_build_s"] = time.perf_counter() - t0
    print(f"host index: {ix.timings}")
    return g, ix


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
        "device_build_s": device_s, "stages_s": dict(plan.build_timings)}


def build(args: argparse.Namespace, hub_nodes=None, host=None) -> tuple:
    """Graph, host index and device index of the run ->
    (graph, DeviceIndex, BuildPlan, summary of the build).
    ``hub_nodes`` pins the hub-label tier's node set (the CLI builds
    without one); ``host`` = (graph, host index) from ``build_host``
    skips building those again."""
    device, levels, resident_mb = _build_knobs(args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    g, ix = build_host(args) if host is None else host
    t0 = time.perf_counter()
    dix, plan = build_device_index_with_plan(
        ix, device=device, hierarchy_levels=levels,
        resident_mb=resident_mb, hub_nodes=hub_nodes)
    device_s = time.perf_counter() - t0
    return g, dix, plan, _summary(args, g, ix, dix, plan, device, device_s)


def _path_shape(args: argparse.Namespace) -> tuple[int, int]:
    """(batches, batch size) of the --paths loop."""
    return (args.batches if args.path_batches is None else args.path_batches,
            args.batch_size if args.path_batch_size is None
            else args.path_batch_size)


def serve(args: argparse.Namespace, g, dix, summary: dict,
          plan=None) -> dict:
    """Warm the planner up, serve the batches and validate against
    Dijkstra (then, with ``--paths``, the path loop, which needs the
    build's ``plan``); returns ``summary`` completed with the median
    batch ms, µs/query, planner buckets, peak device memory, the
    validation mismatch count and the path loop's record."""
    device = dix.device
    planner = QueryPlanner(dix, paths=args.paths)
    t0 = time.perf_counter()
    planner.warmup(max(args.batch_size, _path_shape(args)[1]) if args.paths
                   else args.batch_size)
    warmup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed + 1)
    times = []
    last = None
    totals = dict.fromkeys(planner.CASES, 0)
    for _ in range(args.batches):
        s = rng.integers(0, g.n, args.batch_size)
        t = rng.integers(0, g.n, args.batch_size)
        t0 = time.perf_counter()
        out = planner(s, t)              # host copy: waits for the card
        times.append(time.perf_counter() - t0)
        last = (s, t, out)
        for case, count in planner.last_counts.items():
            totals[case] += count
    med = float(np.median(times)) if times else float("nan")
    per_q = med / args.batch_size
    print(f"served {args.batches * args.batch_size} queries; median batch "
          f"{med * 1e3:.3f}ms -> {per_q * 1e6:.3f}us/query "
          f"({1 / per_q:,.0f} qps)")
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
        summary, warmup_s=warmup_s, median_batch_ms=med * 1e3,
        us_per_query=per_q * 1e6, buckets=totals, peak_device_mb=peak_mb,
        mismatches=bad,
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
    times, wit_times = [], []
    last = None
    for _ in range(batches):
        s = rng.integers(0, g.n, size)
        t = rng.integers(0, g.n, size)
        t0 = time.perf_counter()
        dist, wit = planner.query_witness(s, t, dix=dix)
        t1 = time.perf_counter()
        paths = uw.unwind_many(s, t, dist, wit)
        times.append(time.perf_counter() - t0)
        wit_times.append(t1 - t0)
        last = (s, t, dist, paths)
    med = float(np.median(times)) if times else float("nan")
    med_wit = float(np.median(wit_times)) if times else float("nan")
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


def run_epoched(args: argparse.Namespace) -> tuple:
    """The run with ``--update-batches``: build through an
    ``EpochedEngine``, serve epoch 0 (``serve``), then ``update_loop``
    and, with ``--paths``, the path loop again on the last epoch.
    Returns (engine, summary)."""
    device, levels, resident_mb = _build_knobs(args)
    g, ix = build_host(args)
    t0 = time.perf_counter()
    engine = EpochedEngine(g, ix=ix, device=device, paths=args.paths,
                           hierarchy_levels=levels,
                           resident_mb=resident_mb)
    device_s = time.perf_counter() - t0
    summary = _summary(args, g, ix, engine.dix, engine.plan, device,
                       device_s)
    res = serve(args, g, engine.dix, summary, engine.plan)
    res["refresh"] = update_loop(engine, args)
    if args.paths:
        print(f"paths on epoch {engine.epoch}:")
        res["paths_last_epoch"] = serve_paths(
            args, engine.g, engine.dix, engine.plan, engine.planner)
    return engine, res


def run(args: argparse.Namespace) -> dict:
    """Build, warm up, serve and validate (and the path loop with
    ``--paths``, the update rounds with ``--update-batches``); returns
    the run's summary (stage seconds, overlay shapes, median batch ms,
    µs/query, planner buckets, the validation mismatch counts)."""
    if args.update_batches:
        return run_epoched(args)[1]
    g, dix, plan, summary = build(args)
    return serve(args, g, dix, summary, plan)


def failures(res: dict) -> int:
    """Mismatches of every check a run made, plus refreshed epochs that
    differ from their scratch rebuild."""
    return (res["mismatches"]
            + res.get("paths", {}).get("mismatches", 0)
            + res.get("paths_last_epoch", {}).get("mismatches", 0)
            + sum(r["post_refresh_mismatches"] + (not r["scratch_match"])
                  for r in res.get("refresh", ())))


def main(argv=None) -> int:
    return 1 if failures(run(parse_args(argv))) else 0


if __name__ == "__main__":
    sys.exit(main())
