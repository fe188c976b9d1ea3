# Copied from src/repro/core/agents.py (numpy only); keep the two in step.
"""Agents and Deterministic Routing Areas (paper §IV; host-side
preprocessing stage 1, DESIGN.md §7).

Owned invariant: every non-agent node belongs to exactly one DRA and
reaches the rest of G only through that DRA's agent — the case split
every engine (host and device) keys its query routing on.

An *agent* u represents a set of nodes A_u (|A_u| <= c*floor(sqrt(n)))
whose only connection to the rest of G is through u.  The union A_u^+ of
all sets represented by u is its DRA: a maximal connected subgraph that
touches the rest of G only at u (Props 3-9).

compDRAs (Fig. 6) runs in linear time:
  1. cut-nodes + BCCs (Hopcroft-Tarjan),
  2. BC-SKETCH bipartite tree (cut-nodes x BCCs, Prop 12),
  3. leaf-inward peeling of the sketch tree, merging BCC regions whose
     combined size stays under the threshold; surviving cut-nodes whose
     leaf regions fit the bound become maximal agents.

Deviation from the paper's pseudo-code, recorded per DESIGN.md: line 3 of
extractDRAs picks "a cut-node with leaf neighbours"; for the claimed
invariant "at most one non-leaf neighbour" to hold we peel with the
standard tree worklist (only cut-nodes with <= 1 non-leaf neighbour are
eligible), which is the unique order-independent reading.  We also keep a
cut-node whose neighbours are ALL leaves as an agent instead of collapsing
its whole component into an orphan region, preserving DRA coverage for
small components.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List

import numpy as np

from .bcc import biconnected_components
from .graph import Graph


@dataclasses.dataclass
class AgentInfo:
    agent: int                     # graph node id of the maximal agent
    pieces: List[np.ndarray]       # each A_u^i (node ids, includes agent)
    nodes: np.ndarray              # A_u^+ \ {agent}: represented nodes
    dist_to_agent: np.ndarray      # dist(agent, v) for v in ``nodes``
    piece_of: np.ndarray           # piece index aligned with ``nodes``


@dataclasses.dataclass
class DRAResult:
    agents: List[AgentInfo]
    agent_of: np.ndarray           # int[n]; representing agent or self
    dist_to_agent: np.ndarray      # float[n]; 0 for agents/trivial nodes
    piece_of: np.ndarray           # int[n]; piece idx within DRA, -1 else
    threshold: int

    @property
    def n_nontrivial_agents(self) -> int:
        return len(self.agents)

    def represented_mask(self) -> np.ndarray:
        mask = np.zeros(self.agent_of.size, dtype=bool)
        for a in self.agents:
            mask[a.nodes] = True
        return mask

    def shrink_nodes(self) -> np.ndarray:
        """Nodes surviving into the shrink graph G[A] (agents + trivial)."""
        return np.nonzero(~self.represented_mask())[0].astype(np.int32)


def _sssp_within(g: Graph, source: int, allowed: np.ndarray) -> Dict[int, float]:
    """Dijkstra from ``source`` restricted to ``allowed`` node set."""
    ok = np.zeros(g.n, dtype=bool)
    ok[allowed] = True
    dist = {int(source): 0.0}
    pq = [(0.0, int(source))]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist.get(u, np.inf):
            continue
        s, e = g.indptr[u], g.indptr[u + 1]
        for v, w in zip(g.indices[s:e], g.weights[s:e]):
            v = int(v)
            if not ok[v]:
                continue
            nd = d + float(w)
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist


def compute_dras(g: Graph, c: int = 2) -> DRAResult:
    """Algorithm compDRAs (paper Fig. 6)."""
    n = g.n
    threshold = c * int(np.floor(np.sqrt(n)))
    bcc = biconnected_components(g)

    # ---- BC-SKETCH tree ------------------------------------------------
    # sketch node ids: cut-node c_v -> ('c', v); BCC regions get dict ids.
    cut_ids = np.nonzero(bcc.cut)[0]
    is_cut = bcc.cut
    # region state (BCC sketch nodes, merged over time).  Contents are
    # kept as lazy lists of member arrays with an exact size counter:
    # regions adjacent to one cut node pairwise intersect in exactly
    # that node (the sketch is a tree), so merged sizes follow by
    # arithmetic and the arrays are unioned only once, for the leaf
    # regions that survive into agent pieces — the peeling loop never
    # pays an O(region) set union.
    region_parts: Dict[int, List[np.ndarray]] = {}  # rid -> member arrays
    region_size: Dict[int, int] = {}       # rid -> exact |contents|
    region_adj: Dict[int, set] = {}        # rid -> adjacent cut graph-node ids
    cut_adj: Dict[int, set] = {}           # cut graph-node id -> rids
    next_rid = 0
    for comp in bcc.bcc_nodes:
        rid = next_rid
        next_rid += 1
        region_parts[rid] = [comp.astype(np.int32)]
        region_size[rid] = int(comp.size)
        borders = {int(v) for v in comp[is_cut[comp]]}
        region_adj[rid] = borders
        for v in borders:
            cut_adj.setdefault(v, set()).add(rid)
    for v in cut_ids:
        cut_adj.setdefault(int(v), set())

    def non_leaf_regions(v: int) -> List[int]:
        return [r for r in cut_adj[v] if len(region_adj[r]) > 1]

    # ---- leaf-inward peeling (extractDRAs lines 1-9) --------------------
    work = [v for v in cut_adj if len(non_leaf_regions(v)) <= 1]
    in_work = set(work)
    alive_cut = set(cut_adj.keys())
    while work:
        v = work.pop()
        in_work.discard(v)
        if v not in alive_cut:
            continue
        X = list(cut_adj[v])
        if not X:
            continue
        nonleaf = [r for r in X if len(region_adj[r]) > 1]
        if len(nonleaf) > 1:
            continue  # not eligible (yet); re-added when neighbours merge
        if len(nonleaf) == 0:
            # all-leaf cut node: keep v as a surviving agent candidate
            continue
        alpha = sum(region_size[r] for r in X) - len(X) + 1
        if alpha > threshold:
            continue  # v survives as a potential maximal agent
        # merge X and v into a new region replacing the non-leaf one
        y0 = nonleaf[0]
        merged: List[np.ndarray] = []
        for r in X:
            merged.extend(region_parts[r])
        merged.append(np.array([v], dtype=np.int32))
        new_borders = (region_adj[y0] - {v})
        rid = next_rid
        next_rid += 1
        region_parts[rid] = merged
        region_size[rid] = alpha
        region_adj[rid] = set(new_borders)
        for r in X:
            for w in region_adj[r]:
                cut_adj[w].discard(r)
            del region_parts[r], region_adj[r], region_size[r]
        for w in new_borders:
            cut_adj[w].add(rid)
        alive_cut.discard(v)
        del cut_adj[v]
        # neighbours of the new region may have become eligible
        for w in new_borders:
            if w not in in_work:
                work.append(w)
                in_work.add(w)

    # ---- identify agents + DRAs (extractDRAs lines 10-15) ---------------
    agents: List[AgentInfo] = []
    agent_of = np.arange(n, dtype=np.int32)
    dist_to_agent = np.zeros(n, dtype=np.float64)
    piece_of = -np.ones(n, dtype=np.int32)
    for v in sorted(alive_cut):
        leaf_pieces = [r for r in sorted(cut_adj[v])
                       if len(region_adj[r]) == 1
                       and region_size[r] <= threshold]
        # piece must contain more than just {v, one other}?  No: any size
        # >= 2 region represents >= 1 non-agent node.
        pieces = []
        rep_parts: List[np.ndarray] = []
        pp_parts: List[np.ndarray] = []
        for r in leaf_pieces:
            # the one union a surviving leaf region ever pays
            nodes = np.unique(np.concatenate(region_parts[r])).astype(
                np.int32)
            if nodes.size <= 1:
                continue
            pieces.append(nodes)
            rep_r = nodes[nodes != v]
            rep_parts.append(rep_r)
            pp_parts.append(np.full(rep_r.size, len(pieces) - 1,
                                    dtype=np.int32))
        if not rep_parts:
            continue
        rep = np.concatenate(rep_parts)
        ppiece = np.concatenate(pp_parts)
        allp = np.unique(np.concatenate(pieces))
        dmap = _sssp_within(g, v, allp)
        d = np.array([dmap.get(int(x), np.inf) for x in rep])
        agents.append(AgentInfo(agent=int(v), pieces=pieces, nodes=rep,
                                dist_to_agent=d, piece_of=ppiece))
        agent_of[rep] = v
        dist_to_agent[rep] = d
        piece_of[rep] = ppiece
    return DRAResult(agents=agents, agent_of=agent_of,
                     dist_to_agent=dist_to_agent, piece_of=piece_of,
                     threshold=threshold)


def shrink_graph(g: Graph, dras: DRAResult) -> tuple[Graph, np.ndarray]:
    """Shrink graph G[A] (preprocessing step 3): remove represented nodes.

    Returns (graph, old_ids) with old_ids[new_id] = original node id.
    """
    return g.subgraph(dras.shrink_nodes())
