# Copied from src/repro/core/dijkstra.py (numpy only); keep the two in step.
"""Dijkstra variants: baseline query algorithms (paper §VI-C, [20]).

Host-side reference implementations used (a) as the paper's baselines
for Exp-4/Exp-5 and (b) as correctness oracles for the JAX device engine.

Role: the ground truth every differential test compares against
(DESIGN.md §2).  Owned invariants: distances are computed in float64
(exact for the stack's integer weights), and ``mismatches_oracle`` is
the single comparator all validation paths share — infs match only
infs, NaN never matches, finites compare with relative tolerance.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from .graph import Graph


def sssp(g: Graph, s: int, targets: Optional[np.ndarray] = None
         ) -> np.ndarray:
    """Single-source shortest distances; early exit once targets settle."""
    dist = np.full(g.n, np.inf)
    dist[s] = 0.0
    remaining = None if targets is None else set(int(t) for t in targets)
    pq = [(0.0, int(s))]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        if remaining is not None:
            remaining.discard(u)
            if not remaining:
                break
        a, b = g.indptr[u], g.indptr[u + 1]
        for v, w in zip(g.indices[a:b], g.weights[a:b]):
            nd = d + float(w)
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, int(v)))
    return dist


def pair_with_path(g: Graph, s: int, t: int
                   ) -> tuple[float, Optional[list]]:
    """s->t distance and one shortest path as a node list (None when
    unreachable), with target early exit.  The predecessor tree is the
    host path oracle the witness-unwinding device path (paths.py) is
    differentially tested against."""
    if s == t:
        return 0.0, [int(s)]
    dist = np.full(g.n, np.inf)
    pred = np.full(g.n, -1, dtype=np.int64)
    dist[s] = 0.0
    pq = [(0.0, int(s))]
    found = False
    while pq:
        d, u = heapq.heappop(pq)
        if u == t:
            found = True
            break
        if d > dist[u]:
            continue
        a, b = g.indptr[u], g.indptr[u + 1]
        for v, w in zip(g.indices[a:b], g.weights[a:b]):
            nd = d + float(w)
            if nd < dist[v]:
                dist[v] = nd
                pred[v] = u
                heapq.heappush(pq, (nd, int(v)))
    if not found:
        return np.inf, None
    path = [int(t)]
    while path[-1] != s:
        path.append(int(pred[path[-1]]))
    return float(dist[t]), path[::-1]


def mismatches_oracle(want: float, got: float, *,
                      rel_tol: float = 1e-4) -> bool:
    """The one spelling of "served distance disagrees with the host
    oracle": infinities must agree exactly (a finite answer for an
    unreachable pair is as wrong as the reverse), finite values within
    ``rel_tol`` relative tolerance.  Shared by the serve drivers, the
    live-serving validators, and the tests so the correctness contract
    cannot drift between spellings."""
    if not (np.isfinite(want) and np.isfinite(got)):
        # both +inf (unreachable) is the only non-finite agreement;
        # NaN anywhere is always a mismatch
        return not (np.isinf(want) and np.isinf(got))
    return abs(got - want) > rel_tol * max(want, 1.0)


def pair(g: Graph, s: int, t: int) -> float:
    """s->t distance with target early exit (unidirectional Dijkstra)."""
    if s == t:
        return 0.0
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
        for v, w in zip(g.indices[a:b], g.weights[a:b]):
            nd = d + float(w)
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, int(v)))
    return np.inf


def bidirectional(g: Graph, s: int, t: int) -> float:
    """Bidirectional Dijkstra [20]: meet-in-the-middle with the standard
    top(fwd)+top(bwd) >= mu stopping criterion."""
    if s == t:
        return 0.0
    INF = np.inf
    dist_f = {int(s): 0.0}
    dist_b = {int(t): 0.0}
    done_f: set = set()
    done_b: set = set()
    pq_f = [(0.0, int(s))]
    pq_b = [(0.0, int(t))]
    mu = INF

    def expand(pq, dist, done, other_dist):
        nonlocal mu
        d, u = heapq.heappop(pq)
        if u in done:
            return
        done.add(u)
        a, b = g.indptr[u], g.indptr[u + 1]
        for v, w in zip(g.indices[a:b], g.weights[a:b]):
            v = int(v)
            nd = d + float(w)
            if nd < dist.get(v, INF):
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
            if v in other_dist:
                mu = min(mu, nd + other_dist[v])

    while pq_f and pq_b:
        if pq_f[0][0] + pq_b[0][0] >= mu:
            break
        if pq_f[0][0] <= pq_b[0][0]:
            expand(pq_f, dist_f, done_f, dist_b)
        else:
            expand(pq_b, dist_b, done_b, dist_f)
    return mu
