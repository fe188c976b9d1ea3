# Copied from src/repro/core/graph.py (numpy only); keep the two in step.
"""Weighted undirected graph substrate.

CSR adjacency on the host (numpy) for the one-shot preprocessing passes
(BCC, BC-SKETCH, partitioning) plus a flat edge-list view the index build
consumes directly.  The port keeps the subset its main path runs: the
shared-memory views (parallel host build) and the live-traffic weight
updates stay in the reference package until those slices are ported.

All graphs are simple, undirected, positive-weighted, as in the paper
(Section II-A). Node ids are dense ints [0, n).

Owned invariant (DESIGN.md §6): every weight this module produces —
the ``road_like`` generator — is
a positive *integer*, small enough that any shortest-distance sum
stays below 2**24 and is therefore exactly representable in f32.  The
whole stack's bit-for-bit exactness story (serve == refresh == scratch
rebuild == host Dijkstra with ``==``, any (min,+) association order,
DESIGN.md §10/§15) rests on this one property; do not add a
float-weight source here without revisiting it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable undirected weighted graph in CSR form.

    ``indptr/indices/weights`` store each undirected edge twice (both
    directions), the standard adjacency-list representation the paper
    costs its Table I against. ``edge_u/edge_v/edge_w`` keep each
    undirected edge exactly once (u < v) for algorithms that iterate
    edges (vertex cover, partition coarsening, super-graph assembly).
    """

    n: int
    indptr: np.ndarray   # [n+1] int64
    indices: np.ndarray  # [2m] int32 neighbor ids
    weights: np.ndarray  # [2m] float64 edge weights
    edge_u: np.ndarray   # [m] int32, u < v
    edge_v: np.ndarray   # [m] int32
    edge_w: np.ndarray   # [m] float64

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_edges(n: int, u, v, w) -> "Graph":
        u = np.asarray(u, dtype=np.int32)
        v = np.asarray(v, dtype=np.int32)
        w = np.asarray(w, dtype=np.float64)
        if u.size:
            if (u == v).any():
                raise ValueError("self loops not allowed")
            if (w <= 0).any():
                raise ValueError("weights must be positive")
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        # dedupe parallel edges keeping the lightest
        order = np.lexsort((w, hi, lo))
        lo, hi, w = lo[order], hi[order], w[order]
        if lo.size:
            keep = np.ones(lo.size, dtype=bool)
            keep[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
            lo, hi, w = lo[keep], hi[keep], w[keep]
        m = lo.size
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        ww = np.concatenate([w, w])
        order = np.argsort(src, kind="stable")
        src, dst, ww = src[order], dst[order], ww[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return Graph(n=n, indptr=indptr, indices=dst.astype(np.int32),
                     weights=ww, edge_u=lo.astype(np.int32),
                     edge_v=hi.astype(np.int32), edge_w=w)

    # ---- basic accessors ---------------------------------------------
    @property
    def m(self) -> int:
        return self.edge_u.size

    def neighbors(self, u: int):
        s, e = self.indptr[u], self.indptr[u + 1]
        return self.indices[s:e], self.weights[s:e]

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def size_bytes(self) -> int:
        """Adjacency-list space cost, 4-byte ids/weights (paper Table I)."""
        return 4 * (self.n + 1) + 4 * self.indices.size * 2

    # ---- subgraphs ----------------------------------------------------
    def subgraph(self, nodes: Sequence[int]) -> tuple["Graph", np.ndarray]:
        """Induced subgraph G[nodes]; returns (graph, old_ids[new_id])."""
        nodes = np.unique(np.asarray(nodes, dtype=np.int64)).astype(np.int32)
        remap = -np.ones(self.n, dtype=np.int32)
        remap[nodes] = np.arange(nodes.size, dtype=np.int32)
        mask = (remap[self.edge_u] >= 0) & (remap[self.edge_v] >= 0)
        g = Graph.from_edges(nodes.size, remap[self.edge_u[mask]],
                             remap[self.edge_v[mask]], self.edge_w[mask])
        return g, nodes

    def extract_fragments(self, labels) -> List[Tuple["Graph", np.ndarray]]:
        """Batched ``subgraph`` for a complete partition of the nodes.

        ``labels[v]`` in [0, k) assigns every node to one fragment.
        Returns ``[(graph_i, old_ids_i)]`` for i in [0, k), each equal to
        ``self.subgraph(nonzero(labels == i))`` — one vectorized pass over
        the edge list instead of k O(m) masks, which is what keeps host
        fragment extraction linear when k ~ sqrt(n).  Equality holds
        because ``from_edges`` canonicalizes (lexsort + dedupe), so edge
        grouping order never leaks into the product.
        """
        labels = np.asarray(labels, dtype=np.int64)
        if labels.size != self.n:
            raise ValueError("labels must assign every node")
        k = int(labels.max()) + 1 if labels.size else 0
        if labels.size and labels.min() < 0:
            raise ValueError("labels must be a complete partition (>= 0)")
        # nodes per fragment, ascending within each (stable argsort)
        order = np.argsort(labels, kind="stable")
        counts = np.bincount(labels, minlength=k)
        starts = np.concatenate([[0], np.cumsum(counts)])
        local = np.empty(self.n, dtype=np.int32)
        local[order] = (np.arange(self.n, dtype=np.int64)
                        - starts[labels[order]]).astype(np.int32)
        # internal edges grouped by fragment
        el = labels[self.edge_u]
        internal = el == labels[self.edge_v]
        eu, ev = self.edge_u[internal], self.edge_v[internal]
        ew, el = self.edge_w[internal], el[internal]
        eorder = np.argsort(el, kind="stable")
        eu, ev, ew = eu[eorder], ev[eorder], ew[eorder]
        ecounts = np.bincount(el, minlength=k)
        estarts = np.concatenate([[0], np.cumsum(ecounts)])
        out: List[Tuple[Graph, np.ndarray]] = []
        for i in range(k):
            nodes = order[starts[i]:starts[i + 1]].astype(np.int32)
            es, ee = estarts[i], estarts[i + 1]
            fg = Graph.from_edges(nodes.size, local[eu[es:ee]],
                                  local[ev[es:ee]], ew[es:ee])
            out.append((fg, nodes))
        return out

    def connected_components(self) -> np.ndarray:
        """Label array [n] via iterative BFS (host, linear time)."""
        comp = -np.ones(self.n, dtype=np.int32)
        cur = 0
        for seed in range(self.n):
            if comp[seed] >= 0:
                continue
            stack = [seed]
            comp[seed] = cur
            while stack:
                x = stack.pop()
                s, e = self.indptr[x], self.indptr[x + 1]
                for y in self.indices[s:e]:
                    if comp[y] < 0:
                        comp[y] = cur
                        stack.append(int(y))
            cur += 1
        return comp

    def largest_component(self) -> "Graph":
        comp = self.connected_components()
        if comp.size == 0:
            return self
        big = np.bincount(comp).argmax()
        g, _ = self.subgraph(np.nonzero(comp == big)[0])
        return g


# ---- synthetic road-network generators --------------------------------
def road_like(n_target: int, seed: int = 0, *, highway_frac: float = 0.01,
              delete_frac: float = 0.35) -> Graph:
    """Synthetic road network (DIMACS stand-in; DESIGN.md §6).

    2D lattice with a fraction of edges deleted (dead ends, rivers) plus a
    few long-range 'highway' shortcuts. Produces avg degree ~2.4-3.0 and a
    cut-node-rich periphery, matching USA road-graph structure the paper
    exploits (many small BCCs + one big BCC core).
    """
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n_target))
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    nid = (ii * side + jj).astype(np.int32)
    # horizontal + vertical lattice edges
    us = [nid[:, :-1].ravel(), nid[:-1, :].ravel()]
    vs = [nid[:, 1:].ravel(), nid[1:, :].ravel()]
    u = np.concatenate(us)
    v = np.concatenate(vs)
    keep = rng.random(u.size) > delete_frac
    u, v = u[keep], v[keep]
    w = rng.integers(1, 1000, size=u.size).astype(np.float64)
    # long-range highways between random lattice points
    nh = max(1, int(highway_frac * n))
    hu = rng.integers(0, n, size=nh)
    hv = rng.integers(0, n, size=nh)
    ok = hu != hv
    hu, hv = hu[ok], hv[ok]
    hw = rng.integers(500, 5000, size=hu.size).astype(np.float64)
    g = Graph.from_edges(n, np.concatenate([u, hu]),
                         np.concatenate([v, hv]),
                         np.concatenate([w, hw]))
    return g.largest_component()
