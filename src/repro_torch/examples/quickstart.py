"""Quickstart: build a DISLAND index over a synthetic road network and
answer exact shortest-distance queries three ways (a copy of
``examples/quickstart.py`` on the port).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The host engine answers one pair; ``serve_step`` answers a batch of 512
on the device; the query planner's buckets answer the same batch and
must equal ``serve_step`` exactly (integer weights keep every float32
sum exact); a witness answer is unwound to a path whose weight must be
the served distance.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core import dijkstra
from ..core.device_engine import (build_device_index_with_plan,
                                  resolve_device, serve_step)
from ..core.dist_engine import QueryPlanner
from ..core.engine import DislandEngine
from ..core.graph import road_like
from ..core.paths import PathUnwinder, path_weight
from ..core.supergraph import build_index


def main(device: str = "cuda", nodes: int = 3000) -> int:
    dev = resolve_device(device)
    g = road_like(nodes, seed=0)
    print(f"graph: {g.n} nodes, {g.m} edges")

    # 1. preprocessing (paper Fig. 7): agents/DRAs -> partition ->
    #    hybrid landmark covers -> SUPER graph
    ix = build_index(g)
    sup = ix.super_graph.graph
    print(f"index: {len(ix.fragments)} fragments, SUPER graph "
          f"{sup.n} nodes ({sup.n / g.n:.1%}) / {sup.m} edges")

    # 2. host engine (paper-faithful bi-level query answering)
    eng = DislandEngine(ix)
    s, t = 17, g.n - 5
    print(f"DISLAND  dist({s},{t}) = {eng.query(s, t):.1f}")
    print(f"Dijkstra dist({s},{t}) = {dijkstra.pair(g, s, t):.1f}")

    # 3. device engine: one serve_step call answers a whole batch
    dix, plan = build_device_index_with_plan(ix, device=dev)
    rng = np.random.default_rng(1)
    qs_np = rng.integers(0, g.n, 512).astype(np.int32)
    qt_np = rng.integers(0, g.n, 512).astype(np.int32)
    dist = serve_step(dix, torch.as_tensor(qs_np, device=dev),
                      torch.as_tensor(qt_np, device=dev)).cpu().numpy()
    print(f"batched device engine on {dev}: {dist.shape[0]} queries, "
          f"mean dist {float(np.mean(np.where(np.isfinite(dist), dist, 0))):.1f}")

    # 4. query planner: bucket the batch by case so each program does
    #    only its own work; its answers are serve_step's, exactly
    planner = QueryPlanner(dix)
    dist_p = planner(qs_np, qt_np)
    assert np.array_equal(dist, dist_p), \
        f"planner != serve_step on {int((dist != dist_p).sum())} answers"
    print(f"planner buckets: {planner.last_counts} (== serve_step)")

    # 5. exact *paths*: witness-mode serving + host-side unwinding
    #    (DESIGN.md §10) — same index, no extra graph search
    d_w, wit = planner.query_witness(qs_np[:8], qt_np[:8])
    unwinder = PathUnwinder(dix, plan)
    path = unwinder.unwind(int(qs_np[0]), int(qt_np[0]), d_w[0], wit[0])
    assert path_weight(g, path) == float(d_w[0])
    print(f"path({int(qs_np[0])},{int(qt_np[0])}): {len(path) - 1} hops, "
          f"weight {path_weight(g, path):.0f} == served distance")
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nodes", type=int, default=3000)
    args = ap.parse_args(argv)
    return main(device=args.device, nodes=args.nodes)


if __name__ == "__main__":
    sys.exit(cli())
