# Copied from src/repro/core/bcc.py (numpy only); keep the two in step.
"""Cut-nodes and bi-connected components (paper §II-A, §IV-C step 1).

Iterative Hopcroft-Tarjan articulation-point / BCC algorithm [6],[15].
Linear time O(n + m); iterative because road graphs have paths far deeper
than Python's recursion limit.

Outputs the pieces compDRAs needs:
  - ``cut``: bool[n] articulation-point mask
  - ``bcc_nodes``: list[np.ndarray] node sets per BCC (each undirected
    edge lands in exactly one BCC; a BCC is identified by its edge set,
    the node set is the union of the edge endpoints)

Role: the first host preprocessing pass (DESIGN.md §7).  Owned
invariants: the edge partition above, and cut-mask correctness —
removing a flagged node disconnects its component; removing an
unflagged one never does (property-tested in tests/test_bcc_agents).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .graph import Graph


@dataclasses.dataclass
class BCCResult:
    cut: np.ndarray                 # bool [n]
    bcc_nodes: List[np.ndarray]     # per-BCC sorted node ids
    n_bcc: int

    def bcc_sizes(self) -> np.ndarray:
        return np.array([b.size for b in self.bcc_nodes], dtype=np.int64)


def biconnected_components(g: Graph) -> BCCResult:
    """Iterative Tarjan BCC over the CSR adjacency.

    We walk directed CSR slots so each undirected edge {u,v} appears as
    two slots; a slot is a *tree or back edge* the first time its
    undirected pair is traversed, and is skipped on the reverse
    traversal (tracked with a visited-slot mask paired via ``pair``).
    """
    n = g.n
    indptr, indices = g.indptr, g.indices
    nslots = indices.size

    # pair[i] = CSR slot index of the reverse edge of slot i.
    # Build by sorting (min,max,occurrence) keys of both directions.
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = indices.astype(np.int64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    order = np.lexsort((dst, lo, hi))  # groups the two slots of each edge
    pair = np.empty(nslots, dtype=np.int64)
    a = order[0::2]
    b = order[1::2]
    pair[a] = b
    pair[b] = a

    disc = -np.ones(n, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    cut = np.zeros(n, dtype=bool)
    slot_used = np.zeros(nslots, dtype=bool)  # traversed as tree/back edge
    timer = 0
    edge_stack: list[int] = []  # CSR slot ids of edges on the BCC stack
    bcc_nodes: List[np.ndarray] = []

    for root in range(n):
        if disc[root] >= 0:
            continue
        if indptr[root] == indptr[root + 1]:
            # isolated node forms its own (node-only) BCC
            disc[root] = timer
            timer += 1
            bcc_nodes.append(np.array([root], dtype=np.int32))
            continue
        disc[root] = low[root] = timer
        timer += 1
        root_children = 0
        # frames: [node, csr_cursor]
        stack = [[root, int(indptr[root])]]
        while stack:
            frame = stack[-1]
            u, cursor = frame
            if cursor < indptr[u + 1]:
                frame[1] = cursor + 1
                if slot_used[cursor] or slot_used[pair[cursor]]:
                    continue  # undirected edge already traversed
                v = int(indices[cursor])
                if disc[v] < 0:
                    slot_used[cursor] = True
                    edge_stack.append(cursor)
                    disc[v] = low[v] = timer
                    timer += 1
                    if u == root:
                        root_children += 1
                    stack.append([v, int(indptr[v])])
                elif disc[v] < disc[u]:
                    # back edge u -> ancestor v
                    slot_used[cursor] = True
                    edge_stack.append(cursor)
                    if disc[v] < low[u]:
                        low[u] = disc[v]
            else:
                stack.pop()
                if stack:
                    p = stack[-1][0]
                    if low[u] < low[p]:
                        low[p] = low[u]
                    if low[u] >= disc[p]:
                        # pop the BCC: everything above and including the
                        # tree edge (p, u) belongs to it
                        comp: set[int] = set()
                        while edge_stack:
                            s = edge_stack.pop()
                            a_, b_ = int(src[s]), int(dst[s])
                            comp.add(a_)
                            comp.add(b_)
                            if a_ == p and b_ == u:
                                break
                        if comp:
                            bcc_nodes.append(
                                np.array(sorted(comp), dtype=np.int32))
                        if p != root:
                            cut[p] = True
        if root_children >= 2:
            cut[root] = True
    return BCCResult(cut=cut, bcc_nodes=bcc_nodes, n_bcc=len(bcc_nodes))
