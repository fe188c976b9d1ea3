# Copied from src/repro/core/arcflags.py (numpy only); keep the two in step.
"""Arc-Flags (Moehring et al. [22]) — baseline + DISLAND integration.

Partition-based edge labelling: flag[slot, r] = 1 iff the directed edge
(CSR slot) lies on some shortest path into region r.  Built with one
backward shortest-path tree per boundary node per region (the expensive
preprocessing the paper measures in Exp-4); queries run Dijkstra pruned
to edges flagged for the target's region.

Role: comparison baseline for the auxiliary workloads (DESIGN.md §8).
Invariant: flags are conservative (every shortest-path edge into r is
flagged), so the pruned Dijkstra stays exact — only faster.
"""
from __future__ import annotations

import heapq

import numpy as np

from .dijkstra import sssp
from .graph import Graph
from .partition import partition_bgp


class ArcFlags:
    def __init__(self, g: Graph, n_regions: int = 16, seed: int = 0):
        self.g = g
        gamma = max(4, int(np.ceil(g.n / max(n_regions, 1))))
        part = partition_bgp(g, gamma, seed=seed)
        self.region = part.labels
        self.k = part.n_fragments
        nslots = g.indices.size
        self.flags = np.zeros((nslots, self.k), dtype=bool)
        self._slot_src = np.repeat(np.arange(g.n, dtype=np.int64),
                                   np.diff(g.indptr))
        self._build()

    def _build(self) -> None:
        g = self.g
        # intra-region edges: flag both directions for their own region
        src = self._slot_src
        dst = g.indices
        same = self.region[src] == self.region[dst]
        self.flags[same, self.region[src[same]]] = True
        # boundary nodes per region
        cross_u = g.edge_u[self.region[g.edge_u] != self.region[g.edge_v]]
        cross_v = g.edge_v[self.region[g.edge_u] != self.region[g.edge_v]]
        boundary = np.unique(np.concatenate([cross_u, cross_v]))
        for b in boundary:
            r = int(self.region[b])
            dist = sssp(g, int(b))
            # directed edge u->v is on a shortest path toward b iff
            # dist[v] + w == dist[u]
            du = dist[src]
            dv = dist[dst]
            on_sp = np.isfinite(du) & np.isclose(dv + g.weights, du)
            self.flags[on_sp, r] = True

    def query(self, s: int, t: int) -> float:
        if s == t:
            return 0.0
        g = self.g
        rt = int(self.region[t])
        dist = np.full(g.n, np.inf)
        dist[s] = 0.0
        pq = [(0.0, int(s))]
        while pq:
            d, u = heapq.heappop(pq)
            if u == t:
                return d
            if d > dist[u]:
                continue
            a, b = g.indptr[u], g.indptr[u + 1]
            for slot in range(a, b):
                if not self.flags[slot, rt]:
                    continue
                v = int(g.indices[slot])
                nd = d + float(g.weights[slot])
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(pq, (nd, v))
        return np.inf

    def extra_bits(self) -> int:
        return self.flags.size
