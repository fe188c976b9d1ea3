# Copied from src/repro/core/agent_wrap.py (numpy only); keep the two in step.
"""Agent + X wrappers (paper Exp-4/Exp-5: Agent+Dijkstra/CH/ArcFlags).

Agents/DRAs are a light-weight front: X is built on the *shrink graph*
(2/3 of the input on road graphs), and a query (s, t) becomes
dist(s,u_s) + X(u_s, u_t) + dist(u_t,t), with same-DRA queries answered
from the agent tables alone (paper §VI-B case 1).

Role: baseline combinators for the auxiliary-workload experiments
(DESIGN.md §8).  Invariant: wrapping never changes answers — every
wrapped oracle stays exact vs host Dijkstra, because the agent
decomposition is the paper's exact case split, not a heuristic.
"""
from __future__ import annotations

import numpy as np

from . import dijkstra
from .agents import DRAResult, compute_dras
from .graph import Graph


class AgentAccelerated:
    """Wraps a shrink-graph query oracle with the agent/DRA front-end."""

    def __init__(self, g: Graph, inner_factory, c: int = 2,
                 dras: DRAResult | None = None):
        self.g = g
        self.dras = dras if dras is not None else compute_dras(g, c=c)
        nodes = self.dras.shrink_nodes()
        self.shrink, self.shrink_ids = g.subgraph(nodes)
        self.to_shrink = -np.ones(g.n, dtype=np.int64)
        self.to_shrink[self.shrink_ids] = np.arange(self.shrink_ids.size)
        self.inner = inner_factory(self.shrink)

    def _same_dra(self, s: int, t: int, u: int) -> float:
        d = self.dras
        if s == u:
            return float(d.dist_to_agent[t])
        if t == u:
            return float(d.dist_to_agent[s])
        if d.piece_of[s] == d.piece_of[t]:
            for a in d.agents:
                if a.agent == u:
                    piece = a.pieces[int(d.piece_of[s])]
                    sub, ids = self.g.subgraph(piece)
                    remap = {int(x): k for k, x in enumerate(ids)}
                    return float(dijkstra.pair(sub, remap[s], remap[t]))
        return float(d.dist_to_agent[s] + d.dist_to_agent[t])

    def query(self, s: int, t: int) -> float:
        if s == t:
            return 0.0
        us = int(self.dras.agent_of[s])
        ut = int(self.dras.agent_of[t])
        if us == ut:
            return self._same_dra(s, t, us)
        mid = self.inner.query(int(self.to_shrink[us]),
                               int(self.to_shrink[ut]))
        return (float(self.dras.dist_to_agent[s]) + mid
                + float(self.dras.dist_to_agent[t]))


class PlainDijkstra:
    """Adapter so plain/bidirectional Dijkstra fit the oracle protocol."""

    def __init__(self, g: Graph, bidirectional: bool = False):
        self.g = g
        self.bi = bidirectional

    def query(self, s: int, t: int) -> float:
        if self.bi:
            return dijkstra.bidirectional(self.g, s, t)
        return dijkstra.pair(self.g, s, t)
