# Copied from src/repro/core/engine.py (numpy only); keep the two in step.
"""DISLAND bi-level query answering (paper §VI-B) — host reference.

Given the preprocessed DislandIndex:
  case 1  s, t in the same DRA: answered from agent tables (constant
          time across pieces, local Dijkstra within one piece);
  case 2  different DRAs/trivial: dist(s,t) = dist(s,u_s)
          + dist_shrink(u_s,u_t) + dist(u_t,t) where the middle term is a
          Dijkstra on G[V_s] u G[V_t] u SUPER (observation of [4]).

This is the paper-faithful engine; device_engine.py is the batched
device reformulation validated against it (DESIGN.md §1-§2).  Owned
invariant: answers equal host Dijkstra on the input graph exactly —
this module is the readable middle step of that proof chain, not a
performance path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from . import dijkstra
from .graph import Graph
from .supergraph import DislandIndex


class DislandEngine:
    def __init__(self, index: DislandIndex):
        self.ix = index
        self._union_cache: Dict[Tuple[int, int], tuple] = {}
        self._agent_by_id = {int(a.agent): a for a in index.dras.agents}

    # ---- case 1 helpers -------------------------------------------------
    def _same_dra(self, s: int, t: int, u: int) -> float:
        ix = self.ix
        if s == u:
            return float(ix.dras.dist_to_agent[t])
        if t == u:
            return float(ix.dras.dist_to_agent[s])
        if ix.dras.piece_of[s] == ix.dras.piece_of[t]:
            # same A_u^i: local Dijkstra on the piece
            a = self._agent_by_id.get(u)
            if a is None:
                raise AssertionError("agent table inconsistent")
            piece = a.pieces[int(ix.dras.piece_of[s])]
            sub, ids = ix.g.subgraph(piece)
            remap = {int(x): k for k, x in enumerate(ids)}
            return float(dijkstra.pair(sub, remap[s], remap[t]))
        return float(ix.dras.dist_to_agent[s] + ix.dras.dist_to_agent[t])

    # ---- case 2: union graph --------------------------------------------
    def _union_graph(self, fs: int, ft: int):
        key = (min(fs, ft), max(fs, ft))
        hit = self._union_cache.get(key)
        if hit is not None:
            return hit
        ix = self.ix
        eu, ev, ew = [], [], []

        def add_fragment(fi: int):
            f = ix.fragments[fi]
            fmap = f.nodes
            for u, v, w in zip(f.graph.edge_u, f.graph.edge_v,
                               f.graph.edge_w):
                eu.append(int(fmap[u]))
                ev.append(int(fmap[v]))
                ew.append(float(w))

        add_fragment(fs)
        if ft != fs:
            add_fragment(ft)
        sgraph = ix.super_graph
        for u, v, w in zip(sgraph.graph.edge_u, sgraph.graph.edge_v,
                           sgraph.graph.edge_w):
            eu.append(int(sgraph.node_ids[u]))
            ev.append(int(sgraph.node_ids[v]))
            ew.append(float(w))
        nodes = sorted(set(eu) | set(ev))
        remap = {x: i for i, x in enumerate(nodes)}
        g = Graph.from_edges(len(nodes),
                             [remap[x] for x in eu],
                             [remap[x] for x in ev], ew)
        out = (g, remap)
        if len(self._union_cache) < 256:
            self._union_cache[key] = out
        return out

    # ---- public API -------------------------------------------------------
    def query(self, s: int, t: int) -> float:
        if s == t:
            return 0.0
        ix = self.ix
        us = int(ix.dras.agent_of[s])
        ut = int(ix.dras.agent_of[t])
        if us == ut:
            return self._same_dra(s, t, us)
        d_s = float(ix.dras.dist_to_agent[s])
        d_t = float(ix.dras.dist_to_agent[t])
        fs = int(ix.frag_of[us])
        ft = int(ix.frag_of[ut])
        if fs < 0 or ft < 0:
            # agent node in no fragment: isolated shrink component
            return float("inf") if fs != ft else d_s + d_t
        g, remap = self._union_graph(fs, ft)
        if us not in remap or ut not in remap:
            return float("inf")
        mid = dijkstra.pair(g, remap[us], remap[ut])
        return d_s + mid + d_t

    def query_many(self, pairs) -> np.ndarray:
        return np.array([self.query(int(s), int(t)) for s, t in pairs])

    # ---- path oracle (host reference for the device witness path) -----
    def _piece_path(self, s: int, t: int) -> list:
        """Shortest s -> t path inside the DRA piece containing both
        (paths between piece members and their agent never leave the
        piece, Props 3-9)."""
        if s == t:
            return [int(s)]
        ix = self.ix
        ref = s if ix.dras.piece_of[s] >= 0 else t
        a = self._agent_by_id[int(ix.dras.agent_of[ref])]
        piece = a.pieces[int(ix.dras.piece_of[ref])]
        sub, ids = ix.g.subgraph(piece)
        remap = {int(x): k for k, x in enumerate(ids)}
        _d, p = dijkstra.pair_with_path(sub, remap[s], remap[t])
        assert p is not None, (s, t)
        return [int(ids[x]) for x in p]

    def query_path(self, s: int, t: int) -> tuple:
        """(distance, node sequence) — the bi-level decomposition with
        every leg resolved by a predecessor-tracking Dijkstra on its own
        subgraph: piece paths never leave their piece, and the middle
        u_s -> u_t leg never leaves the shrink graph (a path entering a
        DRA must exit through the same agent, so with positive weights
        it never pays to).  This is the host oracle the device witness
        unwinding is differentially tested against.
        """
        if s == t:
            return 0.0, [int(s)]
        ix = self.ix
        us = int(ix.dras.agent_of[s])
        ut = int(ix.dras.agent_of[t])
        if us == ut:
            if ix.dras.piece_of[s] >= 0 and \
                    ix.dras.piece_of[s] == ix.dras.piece_of[t]:
                path = self._piece_path(s, t)
            else:
                leg_s = self._piece_path(s, us) if s != us else [s]
                leg_t = self._piece_path(ut, t) if t != ut else [t]
                path = leg_s + leg_t[1:]
        else:
            sid_s = int(ix.shrink_id_of[us])
            sid_t = int(ix.shrink_id_of[ut])
            if sid_s < 0 or sid_t < 0:
                return float("inf"), None
            _d, mid = dijkstra.pair_with_path(ix.shrink, sid_s, sid_t)
            if mid is None:
                return float("inf"), None
            leg_s = self._piece_path(s, us) if s != us else [s]
            leg_t = self._piece_path(ut, t) if t != ut else [t]
            path = leg_s + [int(ix.shrink_ids[x]) for x in mid][1:] \
                + leg_t[1:]
        w = 0.0
        for a, b in zip(path, path[1:]):
            e = ix.g.edge_ids([a], [b])[0]
            assert e >= 0, (a, b)
            w += float(ix.g.edge_w[e])
        return w, path
