# Copied from src/repro/data/pipelines.py (numpy only, over the port's Graph); keep the two in step.
"""Synthetic data pipelines for every model family.

Deterministic, seedable, host-side numpy generators producing the exact
batch dicts the model forwards expect.  The neighbour sampler is a real
CSR fanout sampler (minibatch_lg is a *sampled-training* shape — the
sampler is part of the system, not a stub).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..core.graph import Graph


# ---------------------------------------------------------------------------
def lm_batches(batch: int, seq: int, vocab: int, seed: int = 0
               ) -> Iterator[np.ndarray]:
    """Zipf-ish token stream, [batch, seq] int32 per step."""
    rng = np.random.default_rng(seed)
    while True:
        z = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
        yield np.minimum(z - 1, vocab - 1).astype(np.int32)


def recsys_batches(batch: int, n_sparse: int, rows_per_field: int,
                   hots: int, n_dense: int = 13, seed: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        z = rng.zipf(1.2, size=(batch, n_sparse, hots))
        ids = np.minimum(z - 1, rows_per_field - 1).astype(np.int32)
        dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
        # labels correlate weakly with dense features (learnable signal)
        p = 1 / (1 + np.exp(-dense[:, :3].sum(-1)))
        labels = (rng.random(batch) < p).astype(np.int32)
        yield {"sparse_ids": ids, "dense": dense, "labels": labels}


# ---------------------------------------------------------------------------
def _edge_features(g: Graph) -> np.ndarray:
    """4-dim edge features: weight, log-weight, deg(u), deg(v)."""
    deg = g.degree().astype(np.float32)
    w = g.edge_w.astype(np.float32)
    return np.stack([w / (w.max() + 1e-9), np.log1p(w),
                     deg[g.edge_u] / (deg.max() + 1e-9),
                     deg[g.edge_v] / (deg.max() + 1e-9)], axis=1)


def _directed(g: Graph):
    src = np.concatenate([g.edge_u, g.edge_v]).astype(np.int32)
    dst = np.concatenate([g.edge_v, g.edge_u]).astype(np.int32)
    return src, dst


def gnn_full_batch(g: Graph, d_feat: int, n_classes: int, seed: int = 0,
                   n_out: int = 1) -> Dict[str, np.ndarray]:
    """Full-graph training batch with every key any GNN arch needs."""
    rng = np.random.default_rng(seed)
    src, dst = _directed(g)
    ef = np.concatenate([_edge_features(g)] * 2, axis=0)
    x = rng.normal(size=(g.n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, g.n).astype(np.int32)
    tri = _sample_triplets(g, src, dst, max_tri=2 * src.size, rng=rng)
    return {
        "node_feat": x,
        "edge_src": src, "edge_dst": dst, "edge_feat": ef,
        "edge_dist": np.concatenate([g.edge_w, g.edge_w]).astype(
            np.float32) / (g.edge_w.max() + 1e-9) * 3.0,
        "labels": labels,
        "loss_mask": np.ones(g.n, np.float32),
        "target": rng.normal(size=(g.n, n_out)).astype(np.float32),
        "graph_id": np.zeros(g.n, np.int32),
        "target_g": rng.normal(size=(1,)).astype(np.float32),
        **tri,
    }


def _sample_triplets(g: Graph, src, dst, max_tri: int, rng):
    """(k->j->i) edge pairs: for each edge (j,i) sample in-edges (k,j)."""
    e = src.size
    # build: for edge index a=(j->i), pick random edge b=(k->j)
    by_dst = np.argsort(dst, kind="stable")
    dst_sorted = dst[by_dst]
    starts = np.searchsorted(dst_sorted, np.arange(g.n))
    ends = np.searchsorted(dst_sorted, np.arange(g.n) + 1)
    tri_kj, tri_ji = [], []
    per_edge = max(1, max_tri // max(e, 1))
    for a in range(e):
        j = src[a]
        s_, e_ = starts[j], ends[j]
        if e_ <= s_:
            continue
        picks = rng.integers(s_, e_, size=min(per_edge, e_ - s_))
        for p in picks:
            b = by_dst[p]
            if b == a:
                continue
            tri_kj.append(b)
            tri_ji.append(a)
            if len(tri_kj) >= max_tri:
                break
        if len(tri_kj) >= max_tri:
            break
    t = max(len(tri_kj), 1)
    return {
        "tri_edge_kj": np.array(tri_kj or [0], np.int32),
        "tri_edge_ji": np.array(tri_ji or [0], np.int32),
        "tri_angle": rng.uniform(0, np.pi, t).astype(np.float32),
    }


def gnn_molecule_batch(n_graphs: int, n_nodes: int, n_edges: int,
                       d_feat: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Block-diagonal disjoint union of small random molecules."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for gi in range(n_graphs):
        off = gi * n_nodes
        u = rng.integers(0, n_nodes, n_edges // 2)
        v = (u + 1 + rng.integers(0, n_nodes - 1, n_edges // 2)) % n_nodes
        srcs += [u + off, v + off]
        dsts += [v + off, u + off]
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    n = n_graphs * n_nodes
    e = src.size
    gid = np.repeat(np.arange(n_graphs, dtype=np.int32), n_nodes)
    # triplets within molecules
    tri_n = 2 * e
    a = rng.integers(0, e, tri_n)
    # match: b must share src[a] as dst — approximate by rejection
    b = rng.integers(0, e, tri_n)
    ok = dst[b] == src[a]
    return {
        "node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
        "edge_src": src, "edge_dst": dst,
        "edge_feat": rng.normal(size=(e, 4)).astype(np.float32),
        "edge_dist": rng.uniform(0.5, 3.0, e).astype(np.float32),
        "labels": rng.integers(0, 8, n).astype(np.int32),
        "loss_mask": np.ones(n, np.float32),
        "target": rng.normal(size=(n, 1)).astype(np.float32),
        "graph_id": gid,
        "target_g": rng.normal(size=(n_graphs,)).astype(np.float32),
        "tri_edge_kj": np.where(ok, b, 0).astype(np.int32),
        "tri_edge_ji": a.astype(np.int32),
        "tri_angle": rng.uniform(0, np.pi, tri_n).astype(np.float32),
    }


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NeighborSampler:
    """Real fanout neighbour sampler over CSR (GraphSAGE-style).

    sample(seeds) returns a padded sampled subgraph in the unified
    edge-list format (seed nodes first, loss_mask marks them)."""
    g: Graph
    fanouts: tuple
    d_feat: int
    n_classes: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        rng = np.random.default_rng(self.seed + 1)
        # persistent synthetic features/labels for the big graph
        self._labels = rng.integers(0, self.n_classes,
                                    self.g.n).astype(np.int32)
        self._feat_seed = self.seed + 2

    def _features(self, nodes: np.ndarray) -> np.ndarray:
        """Deterministic per-node features without storing N x d."""
        out = np.empty((nodes.size, self.d_feat), np.float32)
        for i, v in enumerate(nodes):
            r = np.random.default_rng(self._feat_seed + int(v))
            out[i] = r.standard_normal(self.d_feat)
        return out

    def sample(self, seeds: np.ndarray) -> Dict[str, np.ndarray]:
        g = self.g
        frontier = seeds.astype(np.int64)
        nodes = [seeds.astype(np.int64)]
        edges_u, edges_v = [], []
        for fan in self.fanouts:
            nxt = []
            for u in frontier:
                s_, e_ = g.indptr[u], g.indptr[u + 1]
                deg = e_ - s_
                if deg == 0:
                    continue
                take = min(fan, deg)
                picks = self._rng.choice(deg, size=take, replace=False)
                nbrs = g.indices[s_ + picks]
                for v in nbrs:
                    edges_u.append(int(v))
                    edges_v.append(int(u))
                nxt.append(nbrs.astype(np.int64))
            frontier = (np.concatenate(nxt) if nxt
                        else np.empty(0, np.int64))
            nodes.append(frontier)
        all_nodes, inv = np.unique(np.concatenate(nodes),
                                   return_inverse=False), None
        remap = {int(v): i for i, v in enumerate(all_nodes)}
        src = np.array([remap[u] for u in edges_u], np.int32)
        dst = np.array([remap[v] for v in edges_v], np.int32)
        n = all_nodes.size
        mask = np.zeros(n, np.float32)
        for s_ in seeds:
            mask[remap[int(s_)]] = 1.0
        e = max(src.size, 1)
        rng = self._rng
        return {
            "node_feat": self._features(all_nodes),
            "edge_src": src if src.size else np.zeros(1, np.int32),
            "edge_dst": dst if dst.size else np.zeros(1, np.int32),
            "edge_feat": rng.normal(size=(e, 4)).astype(np.float32),
            "edge_dist": rng.uniform(0.5, 3.0, e).astype(np.float32),
            "labels": self._labels[all_nodes],
            "loss_mask": mask,
            "target": rng.normal(size=(n, 1)).astype(np.float32),
            "graph_id": np.zeros(n, np.int32),
            "target_g": rng.normal(size=(1,)).astype(np.float32),
            "tri_edge_kj": np.zeros(1, np.int32),
            "tri_edge_ji": np.zeros(1, np.int32),
            "tri_angle": np.zeros(1, np.float32),
        }
