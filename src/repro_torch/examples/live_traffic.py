"""Live traffic on a road graph: serve through weight updates (a copy
of ``examples/live_traffic.py`` on the port).

The end-to-end demo of the incremental-maintenance subsystem
(DESIGN.md §9): an EpochedEngine serves exact batched shortest-distance
queries while waves of localized traffic (jams, then clears) mutate
edge weights.  Each wave is absorbed by the delta path — only the dirty
fragments are re-solved, the SUPER overlay is re-closed from their new
boundary distances, only the dirty pieces are rewritten — and published
as a new immutable index epoch; queries never see a half-updated index
and a sample is validated against host Dijkstra on the *current* graph
every epoch (``dijkstra.mismatches_oracle``; any mismatch fails).

    PYTHONPATH=src python -m repro_torch.examples.live_traffic [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import dijkstra
from ..core.dist_engine import EpochedEngine
from ..core.graph import road_like, traffic_updates


def validate(engine: EpochedEngine, rng, n_queries=256, n_check=24) -> str:
    s = rng.integers(0, engine.g.n, n_queries)
    t = rng.integers(0, engine.g.n, n_queries)
    t0 = time.perf_counter()
    out = engine.query(s, t)            # numpy: ends in a D2H copy
    dt = time.perf_counter() - t0
    bad = sum(dijkstra.mismatches_oracle(
        dijkstra.pair(engine.g, int(s[i]), int(t[i])), float(out[i]))
        for i in range(n_check))
    assert bad == 0, f"{bad} mismatches vs Dijkstra"
    return (f"{n_queries} queries in {dt * 1e3:.1f}ms "
            f"({dt / n_queries * 1e6:.1f}us/q), {n_check} validated, "
            f"0 mismatches")


def main(device: str = "cuda", nodes: int = 1600, waves: int = 3) -> int:
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    g = road_like(nodes, seed=11)
    engine = EpochedEngine(g, device=device)
    engine.warmup(256)
    print(f"built road graph n={g.n} m={g.m} + index on {engine.device} "
          f"in {time.perf_counter() - t0:.1f}s "
          f"(k={engine.plan.k} fragments, S={engine.plan.S} boundary "
          f"nodes, {engine.plan.n_pieces} pieces)")
    print(f"epoch 0: {validate(engine, rng)}")

    for wave in range(waves):
        # morning jam: localized slowdowns; evening: the jam clears
        u, v, w = traffic_updates(engine.g, frac=0.03, seed=100 + wave,
                                  jam_frac=1.0 if wave % 2 == 0 else 0.0)
        t0 = time.perf_counter()
        stats = engine.apply_updates(u, v, w)
        dt = time.perf_counter() - t0
        kind = "jam" if wave % 2 == 0 else "clear"
        print(f"epoch {engine.epoch}: absorbed {stats.n_updates} "
              f"{kind} updates in {dt * 1e3:.0f}ms — dirty "
              f"{stats.n_dirty_frags}/{stats.n_frags} fragments, "
              f"{stats.n_dirty_pieces}/{stats.n_pieces} pieces, "
              f"{stats.n_eb_slots} E_B slots, "
              f"decrease_only={stats.decrease_only}")
        print(f"         {validate(engine, rng)}")
    print("live-traffic demo OK")
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nodes", type=int, default=1600)
    args = ap.parse_args(argv)
    return main(device=args.device, nodes=args.nodes)


if __name__ == "__main__":
    sys.exit(cli())
