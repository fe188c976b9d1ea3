"""The plain reference of the benchmark: exact shortest distances on a road
graph and its epochs, in NumPy and the standard library only.

It takes edge lists and update batches, never anything the program made:
each epoch's graph is rebuilt here from the base edges and the batches the
benchmark handed to both sides, in order (``replay``).  ``Road.dijkstra``
answers from one source to many targets in float64, which is exact on the
integer weights the benchmark generates; with ``bf16=True`` every tentative
distance is rounded to bfloat16 as it is formed, the control that a
comparison with limit 0 has to fail.
"""
from __future__ import annotations

import heapq
import math

import numpy as np


def _bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (8 significant bits), ties to
    even; exact for 0 and +inf."""
    if x == 0.0 or math.isinf(x):
        return x
    m, e = math.frexp(x)              # x = m * 2**e, 0.5 <= m < 1
    ulp = math.ldexp(1.0, e - 8)
    return round(x / ulp) * ulp


class Road:
    """An undirected weighted graph from its edge list; both directions of
    each edge are stored."""

    def __init__(self, n: int, edge_u, edge_v, edge_w):
        u = np.asarray(edge_u, np.int64)
        v = np.asarray(edge_v, np.int64)
        w = np.asarray(edge_w, np.float64)
        if (w <= 0).any():
            raise ValueError("weights must be positive")
        self.n = int(n)
        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
        ww = np.concatenate([w, w])
        order = np.argsort(src, kind="stable")
        indptr = np.zeros(self.n + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        self._ptr = np.cumsum(indptr).tolist()
        self._dst = dst[order].tolist()
        self._w = ww[order].tolist()
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        key = lo * self.n + hi
        korder = np.argsort(key, kind="stable")
        self._key = key[korder]
        self._kw = w[korder]

    def edge_weight(self, a, b) -> np.ndarray:
        """Weight of each edge (a, b), NaN where the graph has none (the
        lightest where it has parallel ones)."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        key = np.minimum(a, b) * self.n + np.maximum(a, b)
        if self._key.size == 0:
            return np.full(key.shape, np.nan)
        i = np.clip(np.searchsorted(self._key, key), 0, self._key.size - 1)
        return np.where(self._key[i] == key, self._kw[i], np.nan)

    def dijkstra(self, s: int, targets, *, bf16: bool = False
                 ) -> np.ndarray:
        """Shortest distances from ``s`` to each of ``targets`` (+inf where
        unreachable); stops once every target is settled."""
        targets = np.asarray(targets, np.int64)
        want = set(targets.tolist())
        ptr, dst, wt = self._ptr, self._dst, self._w
        dist = {int(s): 0.0}
        done: dict = {}
        heap = [(0.0, int(s))]
        while heap and want:
            d, x = heapq.heappop(heap)
            if x in done:
                continue
            done[x] = d
            want.discard(x)
            for i in range(ptr[x], ptr[x + 1]):
                y = dst[i]
                if y in done:
                    continue
                nd = d + wt[i]
                if bf16:
                    nd = _bf16(nd)
                if nd < dist.get(y, math.inf):
                    dist[y] = nd
                    heapq.heappush(heap, (nd, y))
        return np.array([done.get(int(t), math.inf) for t in targets],
                        np.float64)


def replay(n: int, edge_u, edge_v, edge_w, batches) -> list:
    """The weight array of every epoch: epoch 0 is ``edge_w``, epoch e
    applies batches 1..e in order, each (u, v, w) replacing the weights of
    existing edges (the last of duplicates wins) -> [E + 1] arrays."""
    u0 = np.asarray(edge_u, np.int64)
    v0 = np.asarray(edge_v, np.int64)
    key = np.minimum(u0, v0) * n + np.maximum(u0, v0)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    out = [np.asarray(edge_w, np.float64).copy()]
    for bu, bv, bw in batches:
        bu = np.asarray(bu, np.int64)
        bv = np.asarray(bv, np.int64)
        bkey = np.minimum(bu, bv) * n + np.maximum(bu, bv)
        i = np.clip(np.searchsorted(skey, bkey), 0, max(skey.size - 1, 0))
        if skey.size == 0 or (skey[i] != bkey).any():
            raise ValueError("an update names an edge the graph lacks")
        w = out[-1].copy()
        w[order[i]] = np.asarray(bw, np.float64)
        out.append(w)
    return out


def exact(road: Road, pairs, *, bf16: bool = False) -> np.ndarray:
    """Distances of ``pairs`` ([q, 2]), one search per distinct source."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    out = np.empty(len(pairs), np.float64)
    for s in np.unique(pairs[:, 0]):
        rows = np.nonzero(pairs[:, 0] == s)[0]
        out[rows] = road.dijkstra(int(s), pairs[rows, 1], bf16=bf16)
    return out


def path_fault(road: Road, s: int, t: int, path, dist: float) -> str:
    """Why ``path`` is not an s -> t path of length ``dist`` in ``road``
    ("" when it is one): it must start at s, end at t, step only along
    edges, and its weights, summed in float64, must equal ``dist``."""
    if path is None:
        return "no path" if math.isfinite(dist) else ""
    p = np.asarray(path, np.int64)
    if p.size == 0 or p[0] != s or p[-1] != t:
        return "wrong endpoints"
    w = road.edge_weight(p[:-1], p[1:])
    if np.isnan(w).any():
        return "steps off the graph"
    if float(w.sum()) != float(dist):
        return f"weights sum to {float(w.sum())}, not {float(dist)}"
    return ""
