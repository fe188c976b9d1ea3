# Copied from src/repro/core/partition.py (numpy only); keep the two in step.
"""Bounded graph partitioning (paper §V-B).

BGP: partition V into fragments with |V_i| <= Gamma minimising the number
of boundary nodes.  NP-complete (Prop 13); the paper attacks it through
the classical edge-cut objective (|B| <= 2|E_B|, §V key observation)
with METIS.  METIS is not available offline, so this module implements
the same multilevel scheme in-repo (DESIGN.md §7.2):

  1. coarsening by heavy-edge matching (contract heaviest incident edge;
     node weights accumulate so balance is tracked in original-node
     units),
  2. initial partition by greedy heaviest-connection (Prim-style) region
     growing on the coarsest graph: each region repeatedly absorbs the
     unassigned node with the largest total edge weight into the region,
     grown only to ``_FILL * Gamma`` so refinement has slack to move
     nodes without violating the hard bound,
  3. uncoarsening with boundary Kernighan-Lin/FM refinement: move
     boundary nodes to the neighbouring fragment with the best edge-cut
     gain subject to the size bound.

Objective note: BGP minimizes the *number* of boundary nodes, so the
cut objective counts edges (|B| <= 2|E_B|) — by default every edge
weighs 1 in matching and refinement regardless of the graph's own
weights (road travel times are noise for this objective).  Callers
whose edge weights ARE cut multiplicities — the hierarchy planner's
unit quotient graph, where one edge stands for N parallel cross-unit
slots — pass ``cut_weights=True`` to optimize the weighted cut.

Owned invariants: |V_i| <= Gamma is a HARD bound (refinement may only
improve the cut within it), every node is assigned to exactly one
fragment, and the partition is purely topological — weight refreshes
never re-partition, which is what keeps refresh shapes stable
(DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List

import numpy as np

from .graph import Graph

#: initial regions grow only to this fraction of Gamma, leaving FM
#: refinement headroom to move boundary nodes (a partition packed to
#: 100% of the bound admits no moves at all — every region is full)
_FILL = 0.8


@dataclasses.dataclass
class PartitionResult:
    labels: np.ndarray           # int[n] fragment id
    n_fragments: int

    def boundary_mask(self, g: Graph) -> np.ndarray:
        lab = self.labels
        cross = lab[g.edge_u] != lab[g.edge_v]
        mask = np.zeros(g.n, dtype=bool)
        mask[g.edge_u[cross]] = True
        mask[g.edge_v[cross]] = True
        return mask

    def edge_cut(self, g: Graph) -> int:
        return int((self.labels[g.edge_u] != self.labels[g.edge_v]).sum())

    def fragment_nodes(self, i: int) -> np.ndarray:
        return np.nonzero(self.labels == i)[0].astype(np.int32)


# ---------------------------------------------------------------------------
def _heavy_edge_matching(g: Graph, node_w: np.ndarray, max_node_w: int,
                         rng: np.random.Generator):
    """Heavy-edge matching via vectorized propose-accept rounds.

    Every unmatched node proposes its incident live edge of maximal
    global rank (weight, then a random per-edge priority — one strict
    total order shared by all nodes); mutual proposals match.  The
    globally top-ranked live edge is always mutual, so every round
    makes progress and the loop terminates.  Same METIS-HEM contract
    as the sequential visit-order scan this replaces — match heavy
    edges first under the ``max_node_w`` balance bound — but each
    round is O(live edges) numpy instead of a Python adjacency walk.
    """
    n = g.n
    match = -np.ones(n, dtype=np.int64)
    m = g.edge_u.size
    if m == 0:
        match[:] = np.arange(n)
        return match
    # directed edge list with undirected ids for the shared rank
    eprio = rng.permutation(m)
    src = np.concatenate([g.edge_u, g.edge_v]).astype(np.int64)
    dst = np.concatenate([g.edge_v, g.edge_u]).astype(np.int64)
    eid = np.concatenate([np.arange(m), np.arange(m)])
    feasible = (node_w[src] + node_w[dst]) <= max_node_w
    src, dst, eid = src[feasible], dst[feasible], eid[feasible]
    # sort once by (src, weight, priority); per round the last live
    # entry of each src group is that node's proposal
    order = np.lexsort((eprio[eid], g.edge_w[eid], src))
    src, dst = src[order], dst[order]
    while src.size:
        live = (match[src] < 0) & (match[dst] < 0)
        src, dst = src[live], dst[live]
        if not src.size:
            break
        last = np.flatnonzero(np.r_[src[1:] != src[:-1], True])
        proposal = -np.ones(n, dtype=np.int64)
        proposal[src[last]] = dst[last]
        u = src[last]
        mutual = u[proposal[proposal[u]] == u]
        if not mutual.size:
            break
        match[mutual] = proposal[mutual]
    match[match < 0] = np.nonzero(match < 0)[0]
    return match


def _contract(g: Graph, node_w: np.ndarray, match: np.ndarray):
    """Contract matched pairs; sum parallel edge weights (cut weight)."""
    rep = np.minimum(np.arange(g.n), match)
    new_id = -np.ones(g.n, dtype=np.int64)
    uniq = np.unique(rep)
    new_id[uniq] = np.arange(uniq.size)
    cmap = new_id[rep]  # old node -> coarse node
    cw = np.zeros(uniq.size, dtype=np.int64)
    np.add.at(cw, cmap, node_w)
    cu = cmap[g.edge_u]
    cv = cmap[g.edge_v]
    keep = cu != cv
    cu, cv, w = cu[keep], cv[keep], g.edge_w[keep]
    lo, hi = np.minimum(cu, cv), np.maximum(cu, cv)
    # sum weights of parallel edges
    key = lo.astype(np.int64) * uniq.size + hi
    order = np.argsort(key, kind="stable")
    key, lo, hi, w = key[order], lo[order], hi[order], w[order]
    if key.size:
        first = np.ones(key.size, dtype=bool)
        first[1:] = key[1:] != key[:-1]
        idx = np.cumsum(first) - 1
        ws = np.zeros(first.sum())
        np.add.at(ws, idx, w)
        lo, hi = lo[first], hi[first]
        w = ws
    cg = Graph.from_edges(uniq.size, lo, hi, w) if lo.size else \
        Graph.from_edges(uniq.size, [], [], [])
    return cg, cw, cmap


def _initial_partition(g: Graph, node_w: np.ndarray, gamma: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Greedy heaviest-connection region growing bounded by gamma.

    Prim-style: the region absorbs the unassigned node with the
    largest accumulated edge weight into the region (a max-heap keyed
    by connection weight, stale entries skipped).  Plain BFS order
    crosses a 1-weight long-range edge as readily as a 20-weight
    interface, which scatters regions all over the graph; growing by
    connection strength keeps them geometrically compact, which is
    what the FM passes need to polish the cut.
    """
    labels = -np.ones(g.n, dtype=np.int64)
    frag = 0
    order = np.argsort(np.diff(g.indptr))  # grow from low-degree periphery
    for seed in order:
        if labels[seed] >= 0:
            continue
        size = 0
        conn = {int(seed): 0.0}
        heap = [(0.0, int(seed))]
        while heap:
            negw, u = heapq.heappop(heap)
            if labels[u] >= 0 or -negw < conn.get(u, 0.0):
                continue               # already taken / stale entry
            if size + node_w[u] > gamma and size > 0:
                continue
            labels[u] = frag
            size += int(node_w[u])
            s, e = g.indptr[u], g.indptr[u + 1]
            for v, w in zip(g.indices[s:e], g.weights[s:e]):
                v = int(v)
                if labels[v] < 0:
                    conn[v] = conn.get(v, 0.0) + float(w)
                    heapq.heappush(heap, (-conn[v], v))
        frag += 1
    return labels


def _refine(g: Graph, node_w: np.ndarray, labels: np.ndarray, gamma: int,
            passes: int = 8) -> np.ndarray:
    """Boundary FM: greedy positive-gain moves under the size bound."""
    labels = labels.copy()
    nfrag = int(labels.max()) + 1 if labels.size else 0
    sizes = np.zeros(nfrag, dtype=np.int64)
    np.add.at(sizes, labels, node_w)
    for _ in range(passes):
        cross = labels[g.edge_u] != labels[g.edge_v]
        bnodes = np.unique(np.concatenate([g.edge_u[cross],
                                           g.edge_v[cross]]))
        moved = 0
        for u in bnodes:
            u = int(u)
            s, e = g.indptr[u], g.indptr[u + 1]
            lu = labels[u]
            # weight of edges toward each neighbouring fragment
            gains: dict[int, float] = {}
            for v, w in zip(g.indices[s:e], g.weights[s:e]):
                gains[int(labels[v])] = gains.get(int(labels[v]), 0.0) + w
            internal = gains.get(int(lu), 0.0)
            best_l, best_gain = lu, 0.0
            for l, wsum in gains.items():
                if l == lu:
                    continue
                if sizes[l] + node_w[u] > gamma:
                    continue
                gain = wsum - internal
                if gain > best_gain:
                    best_l, best_gain = l, gain
            if best_l != lu:
                sizes[lu] -= node_w[u]
                sizes[best_l] += node_w[u]
                labels[u] = best_l
                moved += 1
        if moved == 0:
            break
    return labels


def partition_bgp(g: Graph, gamma: int, seed: int = 0,
                  coarsen_to: int = 512,
                  node_w: np.ndarray | None = None,
                  cut_weights: bool = False) -> PartitionResult:
    """Multilevel BGP partitioner: fragments of <= gamma weight units.

    ``node_w=None`` (the default, and the level-1 call path) weights
    every node 1 so gamma bounds original-node counts exactly as
    before.  A caller partitioning a *quotient* graph — the hierarchy
    planner grouping fragments by overlay-boundary mass — passes its
    own per-node weights and gamma bounds their sum per fragment; the
    coarsening, initial partition, and FM refinement already track
    accumulated node weights, so the scheme is unchanged.

    ``cut_weights=False`` (default) optimizes the *unweighted* edge
    cut — the BGP boundary objective, where road travel times on the
    edges are irrelevant noise; ``cut_weights=True`` keeps the graph's
    edge weights as cut multiplicities (the quotient-graph callers,
    whose one edge stands for N parallel cross-unit slots).
    """
    if g.n == 0:
        return PartitionResult(labels=np.empty(0, np.int64), n_fragments=0)
    if not cut_weights:
        g = Graph.from_edges(g.n, g.edge_u, g.edge_v,
                             np.ones(g.m, dtype=np.float64))
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = [g]
    if node_w is None:
        node_w = np.ones(g.n, dtype=np.int64)
    weights: List[np.ndarray] = [np.asarray(node_w, dtype=np.int64)]
    maps: List[np.ndarray] = []
    # 1. coarsen
    while graphs[-1].n > coarsen_to:
        cur, curw = graphs[-1], weights[-1]
        match = _heavy_edge_matching(cur, curw, max(1, gamma // 2), rng)
        cg, cw, cmap = _contract(cur, curw, match)
        if cg.n >= cur.n:  # no progress (matching saturated)
            break
        graphs.append(cg)
        weights.append(cw)
        maps.append(cmap)
    # 2. initial partition on the coarsest level (grown to _FILL*gamma
    #    so the refinement passes have slack; the bound stays gamma)
    grow = max(1, int(_FILL * gamma))
    labels = _initial_partition(graphs[-1], weights[-1], grow, rng)
    labels = _refine(graphs[-1], weights[-1], labels, gamma)
    # 3. uncoarsen + refine
    for lvl in range(len(maps) - 1, -1, -1):
        labels = labels[maps[lvl]]
        labels = _refine(graphs[lvl], weights[lvl], labels, gamma)
    # compact labels
    uniq, inv = np.unique(labels, return_inverse=True)
    return PartitionResult(labels=inv.astype(np.int64),
                           n_fragments=int(uniq.size))
