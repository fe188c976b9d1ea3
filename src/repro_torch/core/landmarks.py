# Copied from src/repro/core/landmarks.py (numpy only); keep the two in step.
"""Distance landmarks revisited (paper §III) + hybrid covers (§III-B, §V).

Three pieces:
  1. REF graphs: drop redundant edges (removal does not change the
     endpoint distance).
  2. Theorem 2: on an REF graph a landmark cover IS a vertex cover, so
     the classical maximal-matching 2-approximation applies (Fig. 1).
     Used for the Table I overhead estimation.
  3. Hybrid landmark covers with the per-node cost model
     space_L(x)=|N_x| <= space_N(x)=|P_x| (paper Example 1), built for
     the *boundary nodes of a fragment* (§V-A) — the production path.

Role: preprocessing stage for the per-fragment enforced edges
(DESIGN.md §7).  Owned invariant: a cover's enforced edges preserve
every boundary-to-boundary shortest distance through the fragment, so
the SUPER graph built on them is distance-exact.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

import numpy as np

from .graph import Graph


# --------------------------------------------------------------------------
# REF graphs + 2-approx landmark covers (paper §III-A)
# --------------------------------------------------------------------------
def _alt_dist_bounded(g: Graph, u: int, v: int, skip_w: float,
                      skip_v: int) -> float:
    """Shortest u->v distance ignoring one (u,v) edge, early-exit when the
    frontier exceeds ``skip_w`` (the paper's redundancy test)."""
    dist = {u: 0.0}
    pq = [(0.0, u)]
    while pq:
        d, x = heapq.heappop(pq)
        if d > dist.get(x, np.inf):
            continue
        if d > skip_w:
            return np.inf  # every remaining node is farther than w(u,v)
        if x == v:
            return d
        s, e = g.indptr[x], g.indptr[x + 1]
        for y, w in zip(g.indices[s:e], g.weights[s:e]):
            y = int(y)
            if x == u and y == skip_v:
                continue  # skip the candidate edge itself
            nd = d + float(w)
            if nd <= skip_w and nd < dist.get(y, np.inf):
                dist[y] = nd
                heapq.heappush(pq, (nd, y))
    return np.inf


def redundant_edge_mask(g: Graph) -> np.ndarray:
    """bool[m]: True where edge (u,v) is redundant (alt path <= w)."""
    out = np.zeros(g.m, dtype=bool)
    for i in range(g.m):
        u, v, w = int(g.edge_u[i]), int(g.edge_v[i]), float(g.edge_w[i])
        out[i] = _alt_dist_bounded(g, u, v, w, v) <= w
    return out


def ref_graph(g: Graph) -> Graph:
    """One REF graph of G: drop redundant edges greedily.

    Removing one redundant edge can make another edge non-redundant
    (two routes that certify each other), so we re-test each edge against
    the *current* graph, sweeping heaviest-first so long shortcuts go
    before they can shield each other.  Mutable dict-of-dict adjacency
    keeps each test a bounded Dijkstra on the live graph.
    """
    adj: List[Dict[int, float]] = [dict() for _ in range(g.n)]
    for u, v, w in zip(g.edge_u, g.edge_v, g.edge_w):
        adj[int(u)][int(v)] = float(w)
        adj[int(v)][int(u)] = float(w)

    def alt_dist(u: int, v: int, bound: float) -> float:
        dist = {u: 0.0}
        pq = [(0.0, u)]
        while pq:
            d, x = heapq.heappop(pq)
            if d > dist.get(x, np.inf):
                continue
            if d > bound:
                return np.inf
            if x == v:
                return d
            for y, w in adj[x].items():
                if x == u and y == v:
                    continue
                nd = d + w
                if nd <= bound and nd < dist.get(y, np.inf):
                    dist[y] = nd
                    heapq.heappush(pq, (nd, y))
        return np.inf

    order = np.argsort(-g.edge_w)
    alive = np.ones(g.m, dtype=bool)
    for i in order:
        u, v, w = int(g.edge_u[i]), int(g.edge_v[i]), float(g.edge_w[i])
        if alt_dist(u, v, w) <= w:
            alive[i] = False
            del adj[u][v], adj[v][u]
    return Graph.from_edges(g.n, g.edge_u[alive], g.edge_v[alive],
                            g.edge_w[alive])


def vertex_cover_2approx(g: Graph, rng_seed: int = 0) -> np.ndarray:
    """Maximal-matching 2-approx vertex cover [31]; returns node ids."""
    rng = np.random.default_rng(rng_seed)
    order = rng.permutation(g.m)
    used = np.zeros(g.n, dtype=bool)
    for i in order:
        u, v = int(g.edge_u[i]), int(g.edge_v[i])
        if not used[u] and not used[v]:
            used[u] = True
            used[v] = True
    return np.nonzero(used)[0].astype(np.int32)


def landmark_cover_2approx(g: Graph) -> Tuple[np.ndarray, Graph]:
    """Fig. 1: REF reduction + vertex cover => landmark cover of G.

    Returns (landmarks, ref_graph). |D|/2 and |D| bound the optimum.
    """
    ref = ref_graph(g)
    return vertex_cover_2approx(ref), ref


def landmark_cover_cost(g: Graph, cover: np.ndarray) -> dict:
    """Paper Table I accounting: 4-byte entries, |D|*(|V|-1) distances."""
    d = int(cover.size)
    return {
        "n_landmarks": d,
        "frac_nodes": d / max(g.n, 1),
        "cover_bytes": 4 * d * (g.n - 1),
        "graph_bytes": g.size_bytes(),
        "ratio": (4 * d * (g.n - 1)) / max(g.size_bytes(), 1),
        "lower_bound": d // 2,
    }


# --------------------------------------------------------------------------
# Hybrid landmark covers for fragment boundary nodes (paper §III-B + §V-A)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HybridCover:
    """Hybrid landmark cover D~ = (D, E_D^-) of a fragment's boundary set.

    ``landmark_edges``: (u, x, dist) rows, u in N_x — the |N_x| cost.
    ``direct_edges``:   (b1, b2, dist) rows for uncovered pairs E_D^-.
    All node ids are *fragment-local*; ``dist`` is the fragment-local
    shortest distance (the Upsilon weight of §V-A).
    """
    landmarks: np.ndarray          # local node ids
    landmark_edges: np.ndarray     # [e,3] float64 (u, x, dist)
    direct_edges: np.ndarray       # [e,3] float64 (b1, b2, dist)

    @property
    def n_enforced_edges(self) -> int:
        return len(self.landmark_edges) + len(self.direct_edges)


def _dijkstra_with_parent(g: Graph, s: int):
    dist = np.full(g.n, np.inf)
    parent = -np.ones(g.n, dtype=np.int64)
    dist[s] = 0.0
    pq = [(0.0, s)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        a, b = g.indptr[u], g.indptr[u + 1]
        for v, w in zip(g.indices[a:b], g.weights[a:b]):
            v = int(v)
            nd = d + float(w)
            if nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(pq, (nd, v))
    return dist, parent


def multi_source_sssp(g: Graph, sources: np.ndarray):
    """Exact distances + a shortest-path-tree parent for every source at
    once: vectorized Bellman-Ford to fixpoint over the CSR.

    Returns ``(dist [ns, n], parent [ns, n])``.  Integer weights keep
    every path sum exactly representable, so the fixpoint distances
    equal Dijkstra's bit for bit.  The parent rule is deterministic and
    order-free: ``parent[i, v]`` is the neighbour u minimising
    ``(dist[i, u] + w(u, v), u)`` lexicographically (-1 at sources and
    unreachable nodes), so every process — serial or worker — derives
    the identical tree from the same graph (the serial-parity
    contract, DESIGN.md §17).
    """
    sources = np.asarray(sources, dtype=np.int64)
    ns, n = sources.size, g.n
    # node-major layout [n, ns]: every relaxation step is then a
    # contiguous row gather/scatter instead of a strided column one
    distT = np.full((n, ns), np.inf)
    parentT = -np.ones((n, ns), dtype=np.int64)
    if ns:
        distT[sources, np.arange(ns)] = 0.0
    if ns == 0 or g.indices.size == 0:
        return (np.ascontiguousarray(distT.T),
                np.ascontiguousarray(parentT.T))
    # padded incoming adjacency [n, D] (undirected: a node's CSR row IS
    # its incoming-tail list), rows sorted by neighbour id so argmax of
    # the tie mask lands on the smallest tail.  The relaxation becomes
    # one contiguous axis-reduce per iteration — no reduceat, no
    # variable-length groups.
    deg = np.diff(g.indptr)
    total = int(g.indices.size)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    order = np.lexsort((g.indices, rows))
    nbr = g.indices[order].astype(np.int64)
    nbw = g.weights[order]
    D = int(deg.max())
    cols = np.arange(total, dtype=np.int64) - g.indptr[rows]
    pad_src = np.zeros((n, D), dtype=np.int64)
    pad_w = np.full((n, D), np.inf)
    pad_src[rows, cols] = nbr
    pad_w[rows, cols] = nbw
    pad_w3 = pad_w[:, :, None]
    while True:
        cand = distT[pad_src] + pad_w3        # [n, D, ns]
        best = cand.min(axis=1)               # [n, ns]
        upd = np.minimum(distT, best)
        if not (upd < distT).any():
            break
        distT = upd
    # one more candidate pass at the fixpoint extracts the parents
    cand = distT[pad_src] + pad_w3
    best = cand.min(axis=1)
    # a node gets a parent only where the best incoming relaxation
    # equals its final distance: true for every reachable non-source
    # (inf == inf would otherwise hand parents to unreachable nodes)
    ok = np.isfinite(best) & (best == distT)
    col = (cand == best[:, None, :]).argmax(axis=1)
    parentT = np.where(ok, pad_src[np.arange(n)[:, None], col], -1)
    return np.ascontiguousarray(distT.T), np.ascontiguousarray(parentT.T)


def hybrid_cover(frag: Graph, boundary: np.ndarray,
                 use_cost_model: bool = True) -> HybridCover:
    """Build a hybrid landmark cover for ``boundary`` nodes of a fragment.

    One vectorized multi-source SSSP over all boundary nodes gives (a)
    the local boundary-to-boundary distances and (b) one canonical
    shortest path per pair (the deterministic lexicographic parent
    tree, ``multi_source_sssp``), whose *internal* nodes are the
    landmark candidates (Example 1 semantics).

    Greedy selection under the cost model: repeatedly pick the node x
    maximising |P_x| among those with |N_x| <= |P_x| over the still-
    uncovered pairs (disjointness condition (b) of §III-B is maintained
    because covered pairs are removed).  ``use_cost_model=False``
    reproduces the paper's Table V ablation: any node on >= 1 path is
    eligible (classical landmark-cover greedy).
    """
    boundary = np.unique(np.asarray(boundary, dtype=np.int64)).astype(
        np.int32)
    nb = boundary.size
    if nb <= 1:
        return HybridCover(landmarks=np.empty(0, np.int32),
                           landmark_edges=np.empty((0, 3)),
                           direct_edges=np.empty((0, 3)))
    dist, parent = multi_source_sssp(frag, boundary)
    dist_bb = dist[:, boundary]
    # walk every pair's canonical parent chain t -> b simultaneously:
    # each step is one [n_active] gather, arrays compacting as chains
    # terminate.  Pairs are encoded as i*nb + j (i < j).
    iu, ju = np.triu_indices(nb, k=1)
    finite = np.isfinite(dist_bb[iu, ju])
    iu, ju = iu[finite], ju[finite]
    pairid = iu.astype(np.int64) * nb + ju
    bsrc = boundary[iu].astype(np.int64)
    cur = parent[iu, boundary[ju]]
    xs_parts: List[np.ndarray] = []
    ps_parts: List[np.ndarray] = []
    walking = (cur >= 0) & (cur != bsrc)
    while walking.any():
        iu, cur = iu[walking], cur[walking]
        bsrc, pairid = bsrc[walking], pairid[walking]
        xs_parts.append(cur)
        ps_parts.append(pairid)
        cur = parent[iu, cur]
        walking = (cur >= 0) & (cur != bsrc)
    # node -> set of pair ids whose canonical path passes through it
    through: Dict[int, set] = {}
    if xs_parts:
        xs = np.concatenate(xs_parts)
        ps = np.concatenate(ps_parts)
        order = np.argsort(xs, kind="stable")
        xs, ps = xs[order], ps[order]
        ux, ustarts = np.unique(xs, return_index=True)
        bounds = np.append(ustarts, xs.size).tolist()
        pslist = ps.tolist()
        through = {int(x): set(pslist[s:e]) for x, s, e in
                   zip(ux.tolist(), bounds[:-1], bounds[1:])}

    covered: set = set()
    landmarks: List[int] = []
    lm_edges: List[Tuple[int, int, float]] = []
    # greedy max |P_x| with cost-model gate, via a lazy max-heap: live
    # pair counts only ever shrink, so a popped entry whose count is
    # still current is the global argmax (CELF-style lazy greedy).
    # Ties break toward the smaller node id — value-determined, so
    # every process selects the identical landmark sequence.
    heap = [(-len(pairs), x) for x, pairs in through.items()]
    heapq.heapify(heap)
    while heap:
        negc, x = heapq.heappop(heap)
        pairs = through.get(x)
        if pairs is None:
            continue
        live = pairs - covered
        if not live:
            del through[x]
            continue
        if len(live) != -negc:
            through[x] = live
            heapq.heappush(heap, (-len(live), x))
            continue
        nx = {p // nb for p in live} | {p % nb for p in live}
        del through[x]
        if use_cost_model and len(nx) > len(live):
            # space_L > space_N: cheaper to materialise pairs directly;
            # drop x from candidacy (its surviving pairs go to E_D^-)
            continue
        landmarks.append(int(x))
        # enforced edges (u, x) for u in N_x with local shortest
        # distance: dist(b_u, x) is a row gather from the multi-source
        # run (undirected symmetry), not another SSSP.  sorted(nx) so
        # edge order is value-determined, identical in every process.
        for bi in sorted(nx):
            lm_edges.append((int(boundary[bi]), int(x),
                             float(dist[bi, x])))
        covered |= live

    # E_D^-: finite, still-uncovered pairs become direct edges
    iu, ju = np.triu_indices(nb, k=1)
    dvals = dist_bb[iu, ju]
    keep = np.isfinite(dvals)
    if covered:
        cov = np.fromiter(covered, dtype=np.int64, count=len(covered))
        keep &= ~np.isin(iu.astype(np.int64) * nb + ju, cov)
    direct = np.column_stack([boundary[iu[keep]], boundary[ju[keep]],
                              dvals[keep]]).astype(np.float64)
    return HybridCover(
        landmarks=np.array(landmarks, dtype=np.int32),
        landmark_edges=np.array(lm_edges, dtype=np.float64).reshape(-1, 3),
        direct_edges=direct.reshape(-1, 3))
