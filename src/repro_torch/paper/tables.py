"""One function per paper table or experiment, on the port: a copy of
``benchmarks/paper_tables.py`` over ``repro_torch``.

Synthetic road networks stand in for the DIMACS USA graphs (offline
container; DESIGN.md §6); each function validates the paper's
*structural* claim at reduced scale and appends CSV rows to ``out``.
The section names, columns and formatting are the reference's, so the
two harnesses' outputs diff line by line.

Every function keeps the reference's name and its ``out`` argument and
takes keywords with the reference's constants as defaults: ``sizes``
(the ``road_like`` node counts; a function that uses one graph takes
the first), or ``graphs`` for ``exp10_scale``, and ``device``.  The
host tables (I, III-VI, Exp-4) are numpy only and never touch the card.
Experiments 5 and 7-10 build on ``device`` (default ``cuda``, which
raises without a card; ``"cpu"`` runs the plain PyTorch versions):

* Exp-5's ``disland-batched`` row serves each bucket in one
  ``serve_step`` call on int32 tensors on the device, warmed by one
  call, timed over one call that ends in a synchronise;
* Exp-7 compares the refreshed epoch with its scratch rebuild with
  ``torch.equal`` on the device;
* every other timed region around device work ends in a synchronise
  or a device-to-host copy (the planner returns numpy answers).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..core import dijkstra
from ..core.agent_wrap import AgentAccelerated, PlainDijkstra
from ..core.agents import compute_dras
from ..core.arcflags import ArcFlags
from ..core.ch import CH
from ..core.device_engine import (build_device_index, resolve_device,
                                  serve_step)
from ..core.dist_engine import EpochedEngine
from ..core.engine import DislandEngine
from ..core.graph import road_like, traffic_updates
from ..core.hierarchy import hier_overlay_stats
from ..core.landmarks import landmark_cover_2approx, landmark_cover_cost
from ..core.partition import partition_bgp
from ..core.paths import path_weight
from ..core.supergraph import build_index, reweight_index
from ..data.queries import grid_distance_queries
from ..data.roads import road_preset
from ..serving import (ServingRuntime, run_load_with_refresh,
                       validate_against_epochs, workload_pairs)

GRAPH_SIZES = (1000, 2500, 6000, 12000)

#: the tables Exp-7 holds a refreshed epoch to its scratch rebuild on
EXP7_FIELDS = ("frag_apsp", "frag_next", "brow", "d_super", "super_next",
               "piece_flat", "piece_next", "dist_to_agent")


def _graphs(sizes=GRAPH_SIZES):
    for n in sizes:
        yield f"road{n // 1000}k" if n >= 1000 else f"road{n}", \
            road_like(n, seed=n)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def table1_landmark_overhead(out: List[str], *, sizes=(600, 1200, 2500),
                             device=None) -> None:
    """Table I: direct landmark covers are impractical."""
    out.append("table1,graph,n,m,|D|,frac_nodes,cover_bytes,"
               "graph_bytes,ratio,time_s")
    for name, g in _graphs(sizes):
        t0 = time.perf_counter()
        cover, _ = landmark_cover_2approx(g)
        dt = time.perf_counter() - t0
        c = landmark_cover_cost(g, cover)
        out.append(
            f"table1,{name},{g.n},{g.m},{c['n_landmarks']},"
            f"{c['frac_nodes']:.3f},{c['cover_bytes']},"
            f"{c['graph_bytes']},{c['ratio']:.1f},{dt:.2f}")


def table3_agents(out: List[str], *, sizes=GRAPH_SIZES,
                  device=None) -> None:
    """Table III: agents/DRA counts + compDRAs runtime."""
    out.append("table3,graph,n,agents,agents_frac,represented,"
               "rep_frac,time_s")
    for name, g in _graphs(sizes):
        t0 = time.perf_counter()
        dras = compute_dras(g)
        dt = time.perf_counter() - t0
        rep = int(dras.represented_mask().sum())
        out.append(f"table3,{name},{g.n},{dras.n_nontrivial_agents},"
                   f"{dras.n_nontrivial_agents / g.n:.3f},{rep},"
                   f"{rep / g.n:.3f},{dt:.2f}")


def table4_partitions(out: List[str], *, sizes=GRAPH_SIZES,
                      device=None) -> None:
    """Table IV: BGP fragment/boundary statistics on shrink graphs."""
    out.append("table4,graph,shrink_n,fragments,avg_nodes,"
               "boundary_frac,time_s")
    for name, g in _graphs(sizes):
        dras = compute_dras(g)
        shrink, _ = g.subgraph(dras.shrink_nodes())
        gamma = 2 * int(np.sqrt(g.n))
        t0 = time.perf_counter()
        part = partition_bgp(shrink, gamma)
        dt = time.perf_counter() - t0
        b = part.boundary_mask(shrink).sum()
        out.append(f"table4,{name},{shrink.n},{part.n_fragments},"
                   f"{shrink.n / max(part.n_fragments, 1):.1f},"
                   f"{b / max(shrink.n, 1):.3f},{dt:.2f}")


def table5_hybrid_covers(out: List[str], *, sizes=(2500,),
                         device=None) -> None:
    """Table V: hybrid covers with vs without the cost model."""
    out.append("table5,graph,with_cm_lm,with_cm_edges,"
               "without_cm_lm,without_cm_edges")
    for name, g in _graphs(sizes):
        ix = build_index(g, use_cost_model=True)
        lm_w = np.mean([f.cover.landmarks.size for f in ix.fragments])
        e_w = np.mean([f.cover.n_enforced_edges for f in ix.fragments])
        ix2 = build_index(g, use_cost_model=False)
        lm_o = np.mean([f.cover.landmarks.size for f in ix2.fragments])
        e_o = np.mean([f.cover.n_enforced_edges for f in ix2.fragments])
        out.append(f"table5,{name},{lm_w:.1f},{e_w:.1f},{lm_o:.1f},"
                   f"{e_o:.1f}")


def table6_super_graphs(out: List[str], *, sizes=GRAPH_SIZES,
                        device=None) -> None:
    """Table VI: SUPER graph sizes relative to the input."""
    out.append("table6,graph,super_nodes_frac,super_edges_frac")
    for name, g in _graphs(sizes):
        ix = build_index(g)
        sup = ix.super_graph.graph
        out.append(f"table6,{name},{sup.n / g.n:.4f},{sup.m / g.m:.4f}")


def exp4_preprocessing(out: List[str], *, sizes=(2500,),
                       device=None) -> None:
    """Exp-4: preprocessing time + extra space across approaches."""
    out.append("exp4,graph,approach,prep_s,extra_edges_or_bits")
    name, g = next(_graphs(sizes))
    t0 = time.perf_counter()
    ix = build_index(g)
    disland_t = time.perf_counter() - t0
    out.append(f"exp4,{name},disland,{disland_t:.2f},"
               f"{ix.extra_space_edges()['total']}")
    t0 = time.perf_counter()
    ch = CH(g)
    out.append(f"exp4,{name},ch,{time.perf_counter() - t0:.2f},"
               f"{ch.extra_edges()}")
    t0 = time.perf_counter()
    af = ArcFlags(g, n_regions=12)
    out.append(f"exp4,{name},arcflags,{time.perf_counter() - t0:.2f},"
               f"{af.extra_bits()}")
    t0 = time.perf_counter()
    ac = AgentAccelerated(g, lambda s: CH(s))
    out.append(f"exp4,{name},agent+ch,{time.perf_counter() - t0:.2f},"
               f"{ac.inner.extra_edges()}")


def exp5_query_latency(out: List[str], *, sizes=(6000,), device=None,
                       answers: dict | None = None) -> None:
    """Exp-5 / Figs 9-10: query latency per grid-distance bucket.

    ``answers``, when given, receives ``{"Q<bucket>": (pairs, batched
    device answers as numpy)}``, copied back after the timing."""
    dev = resolve_device(device)
    out.append("exp5,graph,bucket,algo,us_per_query")
    name, g = next(_graphs(sizes))
    queries = grid_distance_queries(g, n_per_set=40, n_sets=6, seed=1)
    ix = build_index(g)
    eng = DislandEngine(ix)
    dix = build_device_index(ix, device=dev)
    ch = CH(g)
    af = ArcFlags(g, n_regions=12)
    abd = AgentAccelerated(g, lambda s: PlainDijkstra(s,
                                                      bidirectional=True))
    algos: Dict[str, Callable] = {
        "dijkstra": lambda s, t: dijkstra.pair(g, s, t),
        "bidijkstra": lambda s, t: dijkstra.bidirectional(g, s, t),
        "agent+bidij": abd.query,
        "ch": ch.query,
        "arcflags": af.query,
        "disland": eng.query,
    }
    for bucket, pairs in queries.items():
        for algo, fn in algos.items():
            t0 = time.perf_counter()
            for s, t in pairs:
                fn(int(s), int(t))
            dt = (time.perf_counter() - t0) / len(pairs)
            out.append(f"exp5,{name},Q{bucket},{algo},{dt * 1e6:.1f}")
        # batched device engine: the whole bucket in one serve_step call
        s = torch.as_tensor(pairs[:, 0], dtype=torch.int32, device=dev)
        t = torch.as_tensor(pairs[:, 1], dtype=torch.int32, device=dev)
        serve_step(dix, s, t)                       # warm
        _sync(dev)
        t0 = time.perf_counter()
        d = serve_step(dix, s, t)
        _sync(dev)
        dt = (time.perf_counter() - t0) / len(pairs)
        out.append(f"exp5,{name},Q{bucket},disland-batched,"
                   f"{dt * 1e6:.2f}")
        if answers is not None:
            answers[f"Q{bucket}"] = (pairs, d.cpu().numpy())


def exp7_incremental_refresh(out: List[str], *, sizes=(2500,),
                             device=None) -> None:
    """Exp-7 (beyond the paper): incremental index refresh vs rebuild.

    Absorbs localized live-traffic batches through the delta path
    (DESIGN.md §9) and compares against a from-scratch device rebuild
    on the same structure — wall time and array-for-array parity (on
    the device, ``torch.equal`` on ``EXP7_FIELDS``).
    """
    dev = resolve_device(device)
    out.append("exp7,graph,round,update_frac,dirty_frag_frac,"
               "decrease_only,refresh_s,reweight_s,pipeline_s,"
               "ratio_vs_pipeline,match")
    name, g = next(_graphs(sizes))
    eng = EpochedEngine(g, device=dev)
    for r in range(3):
        u, v, w = traffic_updates(eng.g, 0.02, seed=40 + r)
        t0 = time.perf_counter()
        stats = eng.apply_updates(u, v, w)
        refresh_s = time.perf_counter() - t0
        # reweight rebuild: exactness reference (same structure)
        t0 = time.perf_counter()
        sdix = build_device_index(reweight_index(eng.ix, eng.g), device=dev)
        _sync(dev)
        reweight_s = time.perf_counter() - t0
        # full pipeline: the pre-delta-path cost of a weight change
        # (hybrid covers are weight-dependent, DESIGN.md §9)
        t0 = time.perf_counter()
        build_device_index(build_index(eng.g), device=dev)
        _sync(dev)
        pipeline_s = time.perf_counter() - t0
        match = all(torch.equal(getattr(eng.dix, f), getattr(sdix, f))
                    for f in EXP7_FIELDS)
        out.append(f"exp7,{name},{r},0.02,"
                   f"{stats.dirty_frag_frac:.3f},"
                   f"{int(stats.decrease_only)},"
                   f"{refresh_s:.3f},{reweight_s:.3f},{pipeline_s:.3f},"
                   f"{refresh_s / max(pipeline_s, 1e-9):.3f},"
                   f"{int(match)}")


def exp8_path_reconstruction(out: List[str], *, sizes=(2500,),
                             device=None) -> None:
    """Exp-8 (beyond the paper): exact path serving via witness
    unwinding (DESIGN.md §10) vs distance-only serving vs host Dijkstra
    with predecessors.

    The witness mode's extra device cost is the argmin carry; the host
    cost is O(path length) table chasing per query — no graph search.
    Every unwound path is validated edge-by-edge and weight-exact.
    """
    dev = resolve_device(device)
    out.append("exp8,graph,algo,us_per_query,mean_hops,exact")
    name, g = next(_graphs(sizes))
    eng = EpochedEngine(g, paths=True, device=dev)
    rng = np.random.default_rng(8)
    q = 512
    s = rng.integers(0, g.n, q).astype(np.int32)
    t = rng.integers(0, g.n, q).astype(np.int32)
    eng.warmup(q)
    eng.unwinder()                       # snapshot outside the timing
    # distance-only planner serving (numpy answers: ends in a D2H copy)
    t0 = time.perf_counter()
    eng.query(s, t)
    dist_us = (time.perf_counter() - t0) / q * 1e6
    # witness serving + host unwind
    t0 = time.perf_counter()
    dist, paths = eng.query_path(s, t)
    path_us = (time.perf_counter() - t0) / q * 1e6
    hops = [len(p) - 1 for p in paths if p is not None]
    exact = all(
        (p is None and np.isinf(dist[i]))
        or path_weight(g, p) == float(dist[i])
        == dijkstra.pair(g, int(s[i]), int(t[i]))
        for i, p in list(enumerate(paths))[:64])
    # host baseline: one predecessor Dijkstra per query
    t0 = time.perf_counter()
    for a, b in zip(s[:64], t[:64]):
        dijkstra.pair_with_path(g, int(a), int(b))
    host_us = (time.perf_counter() - t0) / 64 * 1e6
    out.append(f"exp8,{name},serve-dist,{dist_us:.1f},0,1")
    out.append(f"exp8,{name},serve-paths,{path_us:.1f},"
               f"{np.mean(hops):.1f},{int(exact)}")
    out.append(f"exp8,{name},dijkstra-path,{host_us:.1f},"
               f"{np.mean(hops):.1f},1")


def exp9_sustained_load(out: List[str], *, sizes=(2500,), device=None,
                        rates=(500.0, 2000.0), caches=(True, False),
                        refreshes=(True, False),
                        seconds: float = 2.5) -> None:
    """Exp-9 (beyond the paper): the online serving runtime under
    sustained open-loop load (DESIGN.md §11).

    Arrival-rate sweep x result-cache on/off x concurrent-refresh
    on/off over a Zipf-skewed mix: tail latency (p50/p99), achieved
    qps, cache hit rate, and mean batch occupancy per cell, with a
    per-epoch host-oracle check on a response sample (bad == 0 is the
    epoch-consistency claim under load).  Each cell rebuilds the
    device index from the same host index so cells stay comparable
    (refresh cells mutate weights).  ``rates``, ``caches``,
    ``refreshes`` and ``seconds`` (requests a cell = rate x seconds)
    default to the reference's grid.
    """
    dev = resolve_device(device)
    out.append("exp9,graph,rate_qps,cache,refresh,achieved_qps,"
               "p50_ms,p99_ms,hit_rate,mean_occ,epochs,oracle_bad,"
               "max_gap_ms,stale_resp")
    name, g = next(_graphs(sizes))
    ix = build_index(g)
    for rate in rates:
        for cache in caches:
            for refresh in refreshes:
                eng = EpochedEngine(g, ix=ix, device=dev)
                rt = ServingRuntime(eng, max_batch=256,
                                    deadline_s=0.002,
                                    cache_size=65536 if cache else 0)
                rt.warmup()
                pairs = workload_pairs(eng.g, "zipf",
                                       max(1, int(rate * seconds)), seed=9)
                rep, graphs, drv = run_load_with_refresh(
                    rt, pairs, rate_qps=rate, seed=5,
                    refresh_rounds=2 if refresh else 0,
                    refresh_interval_s=0.2, refresh_seed=17,
                    refresh_pipelined=refresh)
                rt.close()
                _n, bad = validate_against_epochs(
                    rep.requests, graphs, sample=32,
                    evicted=drv.evicted_epochs if drv else ())
                st = rep.runtime_stats
                epochs = len({r.epoch for r in rep.requests})
                out.append(
                    f"exp9,{name},{rate:.0f},"
                    f"{int(cache)},{int(refresh)},"
                    f"{rep.achieved_qps:.0f},{rep.p50_ms},"
                    f"{rep.p99_ms},"
                    f"{st.get('cache_hit_rate', 0.0):.3f},"
                    f"{st['mean_occupancy']:.3f},{epochs},{bad},"
                    f"{rep.max_serving_gap_ms},"
                    f"{rep.stale_responses}")


def exp10_scale(out: List[str], *, graphs: str | None = None,
                device=None) -> None:
    """Exp-10 (beyond the paper): the hierarchy scale sweep
    (DESIGN.md §12).

    Builds each preset end to end — host index, device index with the
    preset's overlay closure (dense at road4000, deep multilevel
    hierarchy at road64k) — then measures planner serve latency at
    batch 1024, a refresh round, the overlay memory actually resident
    (closure + witness + row tables) against the dense (S+1)^2
    baseline, and a sampled host-Dijkstra parity check.

    ``graphs`` (comma-separated preset names) defaults to the
    ``EXP10_GRAPHS`` environment variable, else road4000,road64k;
    ``EXP10_BUILD_WORKERS`` processes compute the host build's covers
    (spawned: a script calling this needs a ``__main__`` guard).
    """
    dev = resolve_device(device)
    names = graphs or os.environ.get("EXP10_GRAPHS", "road4000,road64k")
    workers = int(os.environ.get("EXP10_BUILD_WORKERS", "1"))
    out.append("exp10,graph,n,S,levels,nsf,S2,overlay_bytes,"
               "overlay_dense_bytes,build_s,device_s,refresh_s,"
               "us_per_query,oracle_bad")
    out.append("host_build,graph,build_workers,wall_s")
    for name in names.split(","):
        preset = road_preset(name.strip())
        g = preset.make()
        t0 = time.perf_counter()
        ix = build_index(g, build_workers=workers)
        build_s = time.perf_counter() - t0
        out.append(f"host_build,{name},{workers},{build_s:.4f}")
        t0 = time.perf_counter()
        eng = EpochedEngine(g, ix=ix, device=dev,
                            hierarchy_levels=preset.hierarchy)
        _sync(dev)
        device_s = time.perf_counter() - t0
        plan = eng.plan
        if plan.hierarchy_levels >= 2:
            st = hier_overlay_stats(plan.hier, plan.S)
            nsf, s2 = st["nsf"], st["S2"]
            ov_bytes = st["overlay_bytes"]
            dense_bytes = st["overlay_dense_bytes"]
        else:
            nsf, s2 = 0, 0
            dense_bytes = ov_bytes = 2 * (plan.S + 1) ** 2 * 4
        eng.warmup(1024)
        rng = np.random.default_rng(7)
        s = rng.integers(0, g.n, 1024).astype(np.int32)
        t = rng.integers(0, g.n, 1024).astype(np.int32)
        t0 = time.perf_counter()
        got = eng.query(s, t)
        serve_s = time.perf_counter() - t0
        u, v, w = traffic_updates(eng.g, frac=0.01, seed=11)
        t0 = time.perf_counter()
        eng.apply_updates(u, v, w)
        refresh_s = time.perf_counter() - t0
        got2 = eng.query(s, t)
        bad = 0
        for i in range(16):
            want = dijkstra.pair(g, int(s[i]), int(t[i]))
            bad += dijkstra.mismatches_oracle(want, float(got[i]))
            want2 = dijkstra.pair(eng.g, int(s[i]), int(t[i]))
            bad += dijkstra.mismatches_oracle(want2, float(got2[i]))
        out.append(
            f"exp10,{name},{g.n},{plan.S},{plan.hierarchy_levels},"
            f"{nsf},{s2},{ov_bytes},{dense_bytes},{build_s:.1f},"
            f"{device_s:.1f},{refresh_s:.2f},"
            f"{serve_s / 1024 * 1e6:.2f},{bad}")


ALL = [table1_landmark_overhead, table3_agents, table4_partitions,
       table5_hybrid_covers, table6_super_graphs, exp4_preprocessing,
       exp5_query_latency, exp7_incremental_refresh,
       exp8_path_reconstruction, exp9_sustained_load, exp10_scale]
