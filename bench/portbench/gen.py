"""The benchmark's own input generators, frozen here so that a later change
to the program's copies cannot move the yardstick.

Every generator copied from the program names its source beside it
(``walk_pairs`` and ``pairs``, which read a traffic file's mix, are the
benchmark's own); a graph is a plain ``Edges`` record of numpy
arrays, never the program's ``Graph``.  The harness hands the same arrays to
the program (``repro_torch.core.graph.Graph.from_edges``) and to the plain
reference (``bench/reference/roadref.py``).

Seeds: ``rng(seed, stream)`` derives one independent numpy stream per use
from the run's ``--seed`` (any non-negative whole number, 64 bits and more).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# streams of one run's seed, one per input
POOL, PAIRS, SAMPLE, WARM = 1, 4, 6, 7


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])


@dataclasses.dataclass(frozen=True)
class Edges:
    """An undirected graph as its canonical edge list (u < v, sorted by
    (u, v), no parallel edges) and the CSR both directions make."""
    n: int
    edge_u: np.ndarray   # [m] int32
    edge_v: np.ndarray   # [m] int32
    edge_w: np.ndarray   # [m] float64
    indptr: np.ndarray   # [n + 1] int64
    indices: np.ndarray  # [2m] int32

    @property
    def m(self) -> int:
        return int(self.edge_u.size)


def from_edges(n: int, u, v, w) -> Edges:
    """Canonical edge list: (min, max) orientation, the lightest of
    parallel edges, sorted by (u, v); as ``Graph.from_edges``
    (src/repro_torch/core/graph.py) canonicalises."""
    u = np.asarray(u, np.int32)
    v = np.asarray(v, np.int32)
    w = np.asarray(w, np.float64)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    order = np.lexsort((w, hi, lo))
    lo, hi, w = lo[order], hi[order], w[order]
    if lo.size:
        keep = np.ones(lo.size, bool)
        keep[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        lo, hi, w = lo[keep], hi[keep], w[keep]
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    return Edges(n=n, edge_u=lo.astype(np.int32), edge_v=hi.astype(np.int32),
                 edge_w=w, indptr=np.cumsum(indptr),
                 indices=dst[order].astype(np.int32))


def largest_component(g: Edges) -> Edges:
    """The largest connected component, its nodes renumbered in id order;
    of equal ones the component holding the smallest id (the program's
    breadth-first labelling picks the same)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if g.n == 0:
        return g
    a = coo_matrix((np.ones(g.m), (g.edge_u, g.edge_v)), shape=(g.n, g.n))
    _, comp = connected_components(a, directed=False)
    sizes = np.bincount(comp)
    first = np.full(sizes.size, g.n, np.int64)
    np.minimum.at(first, comp, np.arange(g.n))
    best = np.lexsort((first, -sizes))[0]
    nodes = np.nonzero(comp == best)[0]
    remap = np.full(g.n, -1, np.int64)
    remap[nodes] = np.arange(nodes.size)
    keep = (remap[g.edge_u] >= 0) & (remap[g.edge_v] >= 0)
    return from_edges(nodes.size, remap[g.edge_u[keep]],
                      remap[g.edge_v[keep]], g.edge_w[keep])


def road_like(n_target: int, seed: int = 0, *, highway_frac: float = 0.01,
              delete_frac: float = 0.35) -> Edges:
    """Copied from src/repro_torch/core/graph.py ``road_like``: a lattice
    with a share of edges deleted plus long-range highways, its largest
    component kept (DESIGN.md §6)."""
    r = np.random.default_rng(seed)
    side = int(np.sqrt(n_target))
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    nid = (ii * side + jj).astype(np.int32)
    u = np.concatenate([nid[:, :-1].ravel(), nid[:-1, :].ravel()])
    v = np.concatenate([nid[:, 1:].ravel(), nid[1:, :].ravel()])
    keep = r.random(u.size) > delete_frac
    u, v = u[keep], v[keep]
    w = r.integers(1, 1000, size=u.size).astype(np.float64)
    nh = max(1, int(highway_frac * n))
    hu = r.integers(0, n, size=nh)
    hv = r.integers(0, n, size=nh)
    ok = hu != hv
    hu, hv = hu[ok], hv[ok]
    hw = r.integers(500, 5000, size=hu.size).astype(np.float64)
    g = from_edges(n, np.concatenate([u, hu]), np.concatenate([v, hv]),
                   np.concatenate([w, hw]))
    return largest_component(g)


def zipf_pool(n: int, pool: int, r: np.random.Generator) -> np.ndarray:
    """Copied from src/repro_torch/data/queries.py ``_zipf_pool``: ``pool``
    distinct uniform (s, t) pairs, s != t, in rank order -> [pool, 2]."""
    pool = min(pool, max(1, n * (n - 1)))
    s = r.integers(0, n, 2 * pool)
    t = r.integers(0, n, 2 * pool)
    clash = s == t
    t[clash] = (t[clash] + 1 + r.integers(0, n - 1, int(clash.sum()))) % n
    _, first = np.unique(s * np.int64(n) + t, return_index=True)
    keep = np.sort(first)[:pool]
    return np.stack([s[keep], t[keep]], axis=1).astype(np.int64)


def zipf_weights(npool: int, a: float) -> np.ndarray:
    """Rank r's share of the draws, proportional to r**-a (as
    ``zipf_pairs`` in src/repro_torch/data/queries.py)."""
    p = np.arange(1, npool + 1, dtype=float) ** -a
    return p / p.sum()


def zipf_picks(npool: int, count: int, a: float,
               r: np.random.Generator) -> np.ndarray:
    """Pool rows of ``count`` Zipf draws (``zipf_pairs``' second step)."""
    return r.choice(npool, size=count, p=zipf_weights(npool, a))


def uniform_pairs(n: int, count: int, r: np.random.Generator) -> np.ndarray:
    """Copied from src/repro_torch/data/queries.py ``workload_pairs``'
    "uniform" mix: independent uniform endpoints, t moved on where it
    equals s -> [count, 2] int64."""
    s = r.integers(0, n, count)
    t = r.integers(0, n, count)
    clash = s == t
    t[clash] = (t[clash] + 1) % n
    return np.stack([s, t], axis=1).astype(np.int64)


def hub_selection(pool: np.ndarray, budget: int) -> np.ndarray:
    """Copied from src/repro_torch/launch/serve.py ``_hub_selection``: the
    pool's endpoints in rank order, each first occurrence, at most
    ``budget`` of them."""
    flat = pool.ravel()
    _, first = np.unique(flat, return_index=True)
    return flat[np.sort(first)][:budget]


def walk_pairs(g: Edges, count: int, steps: int,
               r: np.random.Generator) -> np.ndarray:
    """Spatially local pairs: s uniform, t where a walk of ``steps`` edges
    from s ends, each step to a uniform neighbour, stepped on while it is
    s -> [count, 2] int64.  (Every node of the largest component has a
    neighbour, and one step from s never lands on s.)"""
    deg = np.diff(g.indptr)

    def step(x):
        return g.indices[g.indptr[x] + (r.random(x.size) * deg[x]).astype(
            np.int64)].astype(np.int64)
    s = r.integers(0, g.n, count)
    t = s.copy()
    for _ in range(steps):
        t = step(t)
    clash = t == s
    if clash.any():
        t[clash] = step(t[clash])
    return np.stack([s, t], axis=1).astype(np.int64)


def pairs(mix: list, g: Edges, pool: np.ndarray, count: int,
          r: np.random.Generator) -> np.ndarray:
    """``count`` query pairs of a traffic file's ``pairs``: a list of
    parts, each ``{"kind": ..., "share": w}`` with its parameters --
    ``uniform``; ``zipf`` (``a``: draws from the deployment's Zipf pool);
    ``walk`` (``steps``: spatially local pairs).  Each pair's part is
    drawn by the shares (not at all where there is one part), then each
    part's pairs in list order -> [count, 2] int64."""
    if len(mix) == 1:
        part = np.zeros(count, np.int64)
    else:
        share = np.asarray([p["share"] for p in mix], np.float64)
        part = r.choice(len(mix), size=count, p=share / share.sum())
    out = np.empty((count, 2), np.int64)
    for i, p in enumerate(mix):
        sel = part == i
        k = int(sel.sum())
        if p["kind"] == "uniform":
            out[sel] = uniform_pairs(g.n, k, r)
        elif p["kind"] == "zipf":
            out[sel] = pool[zipf_picks(len(pool), k, p["a"], r)]
        elif p["kind"] == "walk":
            out[sel] = walk_pairs(g, k, p["steps"], r)
        else:
            raise ValueError(f"unknown kind of pairs {p['kind']!r}")
    return out
