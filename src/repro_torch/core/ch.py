# Copied from src/repro/core/ch.py (numpy only); keep the two in step.
"""Contraction Hierarchies (Geisberger et al. [13]) — baseline + CH
integration for DISLAND (paper §VI-C).

Build: contract nodes in ascending 'importance' order (lazy-updated
priority = edge difference + contracted-neighbour count), adding witness-
checked shortcuts.  Query: bidirectional upward Dijkstra; only edges to
higher-ranked endpoints are relaxed (order-rising paths; the meeting node
is the unique order-turning apex).

Role: comparison baseline for the auxiliary workloads (DESIGN.md §8).
Invariant: every shortcut is witness-checked at insertion, so the
contracted graph preserves all pairwise distances exactly and the
bidirectional query equals plain Dijkstra on the original graph.
"""
from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np

from .graph import Graph


class CH:
    def __init__(self, g: Graph, hop_limit: int = 16,
                 witness_settle_limit: int = 64):
        self.g = g
        self.n = g.n
        self.hop_limit = hop_limit
        self.witness_settle_limit = witness_settle_limit
        self.order = np.zeros(g.n, dtype=np.int64)   # rank per node
        self.n_shortcuts = 0
        self._build()

    # ------------------------------------------------------------------
    def _witness_dist(self, adj, s: int, t: int, skip: int,
                      bound: float) -> float:
        """Bounded local Dijkstra ignoring ``skip``; settles few nodes."""
        dist = {s: 0.0}
        pq = [(0.0, s)]
        settled = 0
        while pq and settled < self.witness_settle_limit:
            d, u = heapq.heappop(pq)
            if d > dist.get(u, np.inf):
                continue
            if u == t:
                return d
            if d > bound:
                break
            settled += 1
            for v, w in adj[u].items():
                if v == skip:
                    continue
                nd = d + w
                if nd <= bound and nd < dist.get(v, np.inf):
                    dist[v] = nd
                    heapq.heappush(pq, (nd, v))
        return dist.get(t, np.inf)

    def _shortcuts_needed(self, adj, v: int) -> List[tuple]:
        """Shortcuts required to preserve distances when contracting v."""
        nbrs = list(adj[v].items())
        out = []
        for i in range(len(nbrs)):
            u, wu = nbrs[i]
            for j in range(i + 1, len(nbrs)):
                w, ww = nbrs[j]
                through = wu + ww
                if self._witness_dist(adj, u, w, v, through) > through:
                    out.append((u, w, through))
        return out

    def _build(self) -> None:
        g = self.g
        # live adjacency (remaining graph) as dict-of-dict
        adj: List[Dict[int, float]] = [dict() for _ in range(self.n)]
        for u, v, w in zip(g.edge_u, g.edge_v, g.edge_w):
            u, v, w = int(u), int(v), float(w)
            if v not in adj[u] or w < adj[u][v]:
                adj[u][v] = w
                adj[v][u] = w
        # search graph accumulates original edges + shortcuts
        search: List[Dict[int, float]] = [dict(a) for a in adj]
        deleted_nbrs = np.zeros(self.n, dtype=np.int64)

        def priority(v: int) -> float:
            sc = self._shortcuts_needed(adj, v)
            return len(sc) - len(adj[v]) + 0.5 * deleted_nbrs[v]

        pq = [(priority(v), v) for v in range(self.n)]
        heapq.heapify(pq)
        rank = 0
        contracted = np.zeros(self.n, dtype=bool)
        while pq:
            p, v = heapq.heappop(pq)
            if contracted[v]:
                continue
            # lazy re-evaluation: re-insert if priority became stale
            np_ = priority(v)
            if pq and np_ > pq[0][0]:
                heapq.heappush(pq, (np_, v))
                continue
            # contract v
            for (a, b, w) in self._shortcuts_needed(adj, v):
                if b not in adj[a] or w < adj[a][b]:
                    adj[a][b] = w
                    adj[b][a] = w
                if b not in search[a] or w < search[a][b]:
                    search[a][b] = w
                    search[b][a] = w
                    self.n_shortcuts += 1
            for u in adj[v]:
                del adj[u][v]
                deleted_nbrs[u] += 1
            adj[v].clear()
            contracted[v] = True
            self.order[v] = rank
            rank += 1
        # upward CSR: edges to higher-ranked endpoints only
        eu, ev, ew = [], [], []
        for u in range(self.n):
            for v, w in search[u].items():
                if self.order[v] > self.order[u]:
                    eu.append(u)
                    ev.append(v)
                    ew.append(w)
        self.up_head = np.array(ev, dtype=np.int32)
        self.up_w = np.array(ew, dtype=np.float64)
        ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(ptr, np.array(eu, dtype=np.int64) + 1, 1)
        self.up_ptr = np.cumsum(ptr)
        order_idx = np.argsort(np.array(eu, dtype=np.int64), kind="stable")
        self.up_head = self.up_head[order_idx]
        self.up_w = self.up_w[order_idx]

    # ------------------------------------------------------------------
    def _upward_search(self, s: int) -> Dict[int, float]:
        dist = {int(s): 0.0}
        pq = [(0.0, int(s))]
        settled: Dict[int, float] = {}
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist.get(u, np.inf):
                continue
            settled[u] = d
            a, b = self.up_ptr[u], self.up_ptr[u + 1]
            for v, w in zip(self.up_head[a:b], self.up_w[a:b]):
                v = int(v)
                nd = d + float(w)
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    heapq.heappush(pq, (nd, v))
        return settled

    def query(self, s: int, t: int) -> float:
        if s == t:
            return 0.0
        df = self._upward_search(s)
        db = self._upward_search(t)
        mu = np.inf
        small, big = (df, db) if len(df) < len(db) else (db, df)
        for v, d in small.items():
            if v in big:
                mu = min(mu, d + big[v])
        return mu

    def settled_per_query(self, s: int, t: int) -> int:
        return len(self._upward_search(s)) + len(self._upward_search(t))

    def extra_edges(self) -> int:
        return self.n_shortcuts
