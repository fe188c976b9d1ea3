# Copied from src/repro/core/graph.py (numpy only); keep the two in step.
"""Weighted undirected graph substrate.

CSR adjacency on the host (numpy) for the one-shot preprocessing passes
(BCC, BC-SKETCH, partitioning) plus a flat edge-list view the index build
consumes directly.  The port keeps the subset its paths run: the
shared-memory views serve the parallel host build
(``supergraph.start_build``), ``edge_ids`` path validation
(``paths.path_weight``), ``with_edge_weights`` / ``traffic_updates``
the live-traffic refresh (``device_engine.refresh_index``), and
``random_graph`` / ``tree_with_blobs`` the tests' graphs.

All graphs are simple, undirected, positive-weighted, as in the paper
(Section II-A). Node ids are dense ints [0, n).

Owned invariant (DESIGN.md §6): every weight this module produces —
the generators and ``traffic_updates`` — is
a positive *integer*, small enough that any shortest-distance sum
stays below 2**24 and is therefore exactly representable in f32.  The
whole stack's bit-for-bit exactness story (serve == refresh == scratch
rebuild == host Dijkstra with ``==``, any (min,+) association order,
DESIGN.md §10/§15) rests on this one property; do not add a
float-weight source here without revisiting it.
"""
from __future__ import annotations

import dataclasses
import os
import secrets
from multiprocessing import shared_memory
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

    # copied from src/repro/core/graph.py:149
    def edge_ids(self, u, v) -> np.ndarray:
        """Indices into ``edge_u/edge_v/edge_w`` for each (u, v) pair.

        Orientation-insensitive; returns -1 where no such edge exists.
        Vectorized (sorted-key binary search), so update batches stay
        O(b log m) on the host.
        """
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        key = lo * self.n + hi
        # from_edges lexsorts by (lo, hi) and hi < n, so the edge keys
        # are already strictly ascending — searchsorted directly
        ekey = self.edge_u.astype(np.int64) * self.n + self.edge_v
        if ekey.size == 0:
            return np.full(key.shape, -1, dtype=np.int64)
        idx = np.clip(np.searchsorted(ekey, key), 0, ekey.size - 1)
        return np.where(ekey[idx] == key, idx, -1).astype(np.int64)

    # copied from src/repro/core/graph.py:168
    def with_edge_weights(self, u, v, w) -> "Graph":
        """New Graph with the weights of existing edges (u, v) replaced.

        Topology is untouched — this is the live-traffic update primitive:
        edge orderings, CSR layout, and ids are all preserved, so
        downstream index structures built against this graph stay
        position-stable.  Raises on unknown edges or non-positive
        weights; duplicate updates to one edge keep the last value.
        """
        w = np.asarray(w, dtype=np.float64)
        if w.size and (w <= 0).any():
            raise ValueError("weights must be positive")
        idx = self.edge_ids(u, v)
        if (idx < 0).any():
            bad = np.nonzero(idx < 0)[0][:3]
            raise ValueError(
                f"no such edge(s): {[(int(np.asarray(u)[i]), int(np.asarray(v)[i])) for i in bad]}")
        edge_w = self.edge_w.copy()
        edge_w[idx] = w
        # CSR stores each edge twice; rebuild its weight view in place
        # using the same doubling + stable ordering as from_edges
        src = np.concatenate([self.edge_u, self.edge_v])
        ww = np.concatenate([edge_w, edge_w])
        order = np.argsort(src, kind="stable")
        return Graph(n=self.n, indptr=self.indptr, indices=self.indices,
                     weights=ww[order], edge_u=self.edge_u,
                     edge_v=self.edge_v, edge_w=edge_w)

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

    # copied from src/repro/core/graph.py:224
    def to_shared(self) -> "SharedGraph":
        """Export all six CSR/edge arrays into one shared-memory block.

        Worker processes attach with ``Graph.from_shared(handle.meta)``
        and get zero-copy read-only views — nothing but the small
        ``meta`` dict ever crosses the pickle boundary.  The caller owns
        the block: call ``close()`` in every attached process and
        ``unlink()`` exactly once (the creator) when the build is done.
        """
        arrays = [self.indptr, self.indices, self.weights,
                  self.edge_u, self.edge_v, self.edge_w]
        offsets, total = [], 0
        for a in arrays:
            total = (total + 7) & ~7          # 8-byte alignment
            offsets.append(total)
            total += a.nbytes
        # named by this process (``shared_block_prefix``), where the
        # reference takes the library's anonymous ``psm_`` names: a
        # leaked block is told apart from other programs' blocks
        shm = shared_memory.SharedMemory(
            create=True, size=max(total, 1),
            name=shared_block_prefix() + secrets.token_hex(6))
        for a, off in zip(arrays, offsets):
            view = np.ndarray(a.shape, dtype=a.dtype, buffer=shm.buf,
                              offset=off)
            view[:] = a
        meta = {
            "name": shm.name,
            "n": int(self.n),
            "shapes": [tuple(a.shape) for a in arrays],
            "dtypes": [str(a.dtype) for a in arrays],
            "offsets": offsets,
        }
        return SharedGraph(shm=shm, meta=meta)

    @staticmethod
    def from_shared(meta: dict) -> "SharedGraph":
        """Attach to a block exported by ``to_shared``; zero-copy views.

        The views are marked read-only: the shared CSR is a broadcast
        input, never a communication channel.  Keep the returned handle
        alive as long as ``handle.graph`` is in use (the buffer dies
        with it), and ``close()`` when done.
        """
        shm = shared_memory.SharedMemory(name=meta["name"])
        views = []
        for shape, dtype, off in zip(meta["shapes"], meta["dtypes"],
                                     meta["offsets"]):
            v = np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf,
                           offset=off)
            v.flags.writeable = False
            views.append(v)
        g = Graph(n=meta["n"], indptr=views[0], indices=views[1],
                  weights=views[2], edge_u=views[3], edge_v=views[4],
                  edge_w=views[5])
        return SharedGraph(shm=shm, meta=dict(meta), graph=g)


def shared_block_prefix(pid: int | None = None) -> str:
    """Name prefix of the shared-memory blocks ``Graph.to_shared``
    creates in process ``pid`` (default: this one)."""
    return f"repro_torch_{os.getpid() if pid is None else pid}_"


# copied from src/repro/core/graph.py:278
@dataclasses.dataclass
class SharedGraph:
    """Handle for a Graph living in a shared-memory block.

    ``meta`` is the picklable attach token (block name + array layout);
    ``graph`` is set on the attach side (``from_shared``).  Lifecycle:
    every process that holds the handle calls ``close()``; the creating
    process additionally calls ``unlink()`` once to free the block.
    """
    shm: shared_memory.SharedMemory
    meta: dict
    graph: "Graph | None" = None

    def close(self) -> None:
        try:
            self.shm.close()
        except BufferError:
            # numpy views still alive in this process; the block is
            # freed by unlink regardless, so this is not a leak
            pass

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


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


# copied from src/repro/core/graph.py:342
def traffic_updates(g: Graph, frac: float = 0.05, seed: int = 0, *,
                    localized: bool = True,
                    jam_frac: float = 0.5) -> tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Synthetic live-traffic weight-update batch: (u, v, new_w).

    Picks ``round(frac * m)`` distinct edges and rescales their weights:
    a ``jam_frac`` share jam (x2..x6) and the rest clear (/2../6), with
    integer outputs so f32 index arithmetic stays exact.

    ``localized=True`` samples edges from a BFS ball around a random
    center instead of uniformly — traffic is spatially correlated, which
    is what keeps the dirty-fragment set small and the incremental
    refresh path cheap.
    """
    rng = np.random.default_rng(seed)
    n_upd = max(1, int(round(frac * g.m)))
    if localized and g.m > n_upd:
        # grow a BFS ball until it touches enough incident edges
        center = int(rng.integers(0, g.n))
        in_ball = np.zeros(g.n, dtype=bool)
        in_ball[center] = True
        frontier = [center]
        picked = np.zeros(g.m, dtype=bool)
        while frontier and picked.sum() < n_upd:
            nxt = []
            for x in frontier:
                s, e = g.indptr[x], g.indptr[x + 1]
                for y in g.indices[s:e]:
                    if not in_ball[y]:
                        in_ball[y] = True
                        nxt.append(int(y))
            picked = in_ball[g.edge_u] & in_ball[g.edge_v]
            frontier = nxt
        cand = np.nonzero(picked)[0]
        if cand.size < n_upd:       # ball swallowed a whole component
            cand = np.arange(g.m)
    else:
        cand = np.arange(g.m)
    idx = rng.choice(cand, size=min(n_upd, cand.size), replace=False)
    jam = rng.random(idx.size) < jam_frac
    factor = np.where(jam, rng.integers(2, 7, idx.size),
                      1.0 / rng.integers(2, 7, idx.size))
    new_w = np.maximum(1, np.round(g.edge_w[idx] * factor)).astype(
        np.float64)
    return g.edge_u[idx].copy(), g.edge_v[idx].copy(), new_w


# copied from src/repro/core/graph.py:391
def random_graph(n: int, m: int, seed: int = 0, max_w: int = 100) -> Graph:
    """Erdos-Renyi-ish random connected-ish graph for property tests."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=m)
    v = rng.integers(0, n, size=m)
    ok = u != v
    u, v = u[ok], v[ok]
    w = rng.integers(1, max_w + 1, size=u.size).astype(np.float64)
    # chain to keep it connected
    cu = np.arange(n - 1)
    cv = cu + 1
    cw = rng.integers(1, max_w + 1, size=n - 1).astype(np.float64)
    return Graph.from_edges(n, np.concatenate([u, cu]),
                            np.concatenate([v, cv]),
                            np.concatenate([w, cw]))


# copied from src/repro/core/graph.py:408
def tree_with_blobs(n_blobs: int, blob_size: int, seed: int = 0) -> Graph:
    """Cut-node-heavy graph: blobs (cliques) strung on a path. Every blob
    connector is a cut node -> exercises agents/DRAs densely."""
    rng = np.random.default_rng(seed)
    edges_u, edges_v = [], []
    nid = 0
    prev_anchor = None
    for _ in range(n_blobs):
        base = nid
        nid += blob_size
        for a in range(blob_size):
            for b in range(a + 1, blob_size):
                if rng.random() < 0.6 or b == a + 1:
                    edges_u.append(base + a)
                    edges_v.append(base + b)
        if prev_anchor is not None:
            edges_u.append(prev_anchor)
            edges_v.append(base)
        prev_anchor = base
    w = rng.integers(1, 50, size=len(edges_u)).astype(np.float64)
    return Graph.from_edges(nid, edges_u, edges_v, w)
