# Copied from src/repro/data/queries.py (numpy only); keep the two in step.
"""Distance-query generators.

``grid_distance_queries`` is the paper's evaluation workload (§VII-A,
after Wu et al. [34]): a 256 x 256 grid is imposed over the (synthetic)
road network's coordinates; query set Q_i holds node pairs whose grid
distance falls in [2^(i-1) * l, 2^i * l) — Q_1 is near pairs, Q_8 spans
the map.

The *serving* workloads (DESIGN.md §11) model live traffic instead of
benchmark buckets:

* ``zipf_pairs`` — a small pool of distinct OD pairs sampled with
  Zipf(a) frequencies, so a top sliver of pairs carries most of the
  query mass (what makes the epoch-tagged result cache pay);
* ``geo_local_pairs`` — destination within a Chebyshev ball of the
  source in lattice coordinates (commutes, deliveries), which lands
  queries disproportionately in the same-fragment planner bucket;
* ``workload_pairs`` — one dispatcher over mix names for the load
  harness and benchmarks.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.graph import Graph


def _lattice_coords(g: Graph) -> tuple[np.ndarray, int]:
    """Default node positions for ``road_like`` graphs: node id ->
    (row, col) on the generator's square lattice."""
    side = int(np.ceil(np.sqrt(g.n)))
    ids = np.arange(g.n)
    return np.stack([ids // side, ids % side],
                    axis=1).astype(float), side


def _zipf_pool(g: Graph, pool: int,
               rng: np.random.Generator) -> np.ndarray:
    pool = min(pool, max(1, g.n * (g.n - 1)))
    # over-draw, then dedupe preserving draw order so the pool really
    # holds distinct pairs (duplicates would merge two Zipf ranks into
    # one observed pair and skew the analytic head mass)
    s = rng.integers(0, g.n, 2 * pool)
    t = rng.integers(0, g.n, 2 * pool)
    clash = s == t
    t[clash] = (t[clash] + 1 + rng.integers(0, g.n - 1,
                                            int(clash.sum()))) % g.n
    _, first = np.unique(s * np.int64(g.n) + t, return_index=True)
    keep = np.sort(first)[:pool]
    return np.stack([s[keep], t[keep]], axis=1).astype(np.int64)


def zipf_pool(g: Graph, *, pool: int = 2048,
              seed: int = 0) -> np.ndarray:
    """The distinct OD-pair pool behind ``zipf_pairs`` -> [pool, 2]
    int64, in Zipf rank order (row r is rank r+1, so a prefix of the
    rows is exactly the traffic head).

    Exposed separately so the hub-label hot tier (DESIGN.md §15) can
    pin its label set from the same deterministic pool the workload
    draws from — the pool draws lead the seeded RNG stream, so this
    returns bit-identical rows to the pool ``zipf_pairs(seed=seed)``
    samples from.
    """
    return _zipf_pool(g, pool, np.random.default_rng(seed))


def zipf_pairs(g: Graph, n_queries: int, *, a: float = 1.2,
               pool: int = 2048, seed: int = 0) -> np.ndarray:
    """Zipf-skewed repeated-pair workload -> [n_queries, 2] int64.

    A pool of ``pool`` distinct uniform-random (s, t) pairs
    (``zipf_pool``) is ranked 1..pool; query i draws pair r with
    probability proportional to r**-a.  ``top_pair_mass`` computes the
    resulting head mass analytically so tests (and capacity planning
    for the result cache) can assert the skew rather than eyeball it.
    """
    if n_queries <= 0:
        raise ValueError(f"n_queries must be positive: {n_queries}")
    rng = np.random.default_rng(seed)
    pairs = _zipf_pool(g, pool, rng)
    npool = len(pairs)
    p = np.arange(1, npool + 1, dtype=float) ** -a
    p /= p.sum()
    idx = rng.choice(npool, size=n_queries, p=p)
    return pairs[idx]


def top_pair_mass(frac: float, *, a: float = 1.2,
                  pool: int = 2048) -> float:
    """Analytic share of ``zipf_pairs`` queries carried by the top
    ``frac`` of the pool (e.g. 0.01 -> top-1% pairs)."""
    p = np.arange(1, pool + 1, dtype=float) ** -a
    k = max(1, int(np.floor(frac * pool)))
    return float(p[:k].sum() / p.sum())


def geo_local_pairs(g: Graph, n_queries: int, *, radius: int = 8,
                    coords: np.ndarray | None = None,
                    seed: int = 0) -> np.ndarray:
    """Geo-local workload -> [n_queries, 2]: s uniform, t within the
    Chebyshev ball of ``radius`` grid cells around s (t != s).

    coords: [n, 2] node positions; defaults to the ``road_like``
    lattice.  With explicit coords, t is found by rejection sampling
    against the ball (falling back to the nearest sampled candidate so
    pathological geometries still terminate).
    """
    if n_queries <= 0:
        raise ValueError(f"n_queries must be positive: {n_queries}")
    rng = np.random.default_rng(seed)
    if coords is None:
        co, side = _lattice_coords(g)
        s = rng.integers(0, g.n, n_queries)
        sr = co[s, 0].astype(int)
        sc = co[s, 1].astype(int)
        t = np.full(n_queries, -1, np.int64)
        todo = np.arange(n_queries)
        # draw offsets in the ball, clipped to the grid; re-draw
        # entries that landed on s or past the (partial) last lattice
        # row — ids are compacted, so row*side+col can exceed n-1
        for _ in range(32):
            if not todo.size:
                break
            di = rng.integers(-radius, radius + 1, todo.size)
            dj = rng.integers(-radius, radius + 1, todo.size)
            ri = np.clip(sr[todo] + di, 0, side - 1)
            cj = np.clip(sc[todo] + dj, 0, side - 1)
            cand = ri * side + cj
            ok = (cand < g.n) & (cand != s[todo])
            t[todo[ok]] = cand[ok]
            todo = todo[~ok]
        # fallback: a lattice neighbor (same row, else previous row
        # for the id-space edge s+1 == n) is always valid and in-ball
        if todo.size:
            fb = np.where(s[todo] % side > 0, s[todo] - 1, s[todo] + 1)
            fb = np.where(fb >= g.n, s[todo] - side, fb)
            t[todo] = fb
        return np.stack([s, t], axis=1).astype(np.int64)
    span = coords.max(0) - coords.min(0)
    cell = max(span.max() / 256, 1e-9)
    out = np.empty((n_queries, 2), np.int64)
    for i in range(n_queries):
        s = int(rng.integers(0, g.n))
        t, best, best_d = -1, -1, np.inf
        for _ in range(64):
            c = int(rng.integers(0, g.n))
            if c == s:
                continue
            d = np.abs(coords[c] - coords[s]).max() / cell
            if d <= radius:
                t = c
                break
            if d < best_d:
                best, best_d = c, d
        out[i] = (s, t if t >= 0 else best)
    return out


def workload_pairs(g: Graph, mix: str, n: int, *, seed: int = 0,
                   zipf_a: float = 1.2, pool: int = 2048,
                   radius: int = 8) -> np.ndarray:
    """Serving-workload dispatcher: mix in {uniform, zipf, geo}."""
    if mix == "uniform":
        rng = np.random.default_rng(seed)
        s = rng.integers(0, g.n, n)
        t = rng.integers(0, g.n, n)
        clash = s == t
        t[clash] = (t[clash] + 1) % g.n
        return np.stack([s, t], axis=1).astype(np.int64)
    if mix == "zipf":
        return zipf_pairs(g, n, a=zipf_a, pool=pool, seed=seed)
    if mix == "geo":
        return geo_local_pairs(g, n, radius=radius, seed=seed)
    raise ValueError(f"unknown workload mix: {mix!r} "
                     "(expected uniform | zipf | geo)")


def grid_distance_queries(g: Graph, coords: np.ndarray | None = None,
                          n_per_set: int = 1000, n_sets: int = 8,
                          grid: int = 256, seed: int = 0
                          ) -> Dict[int, np.ndarray]:
    """-> {i: [n, 2] node pairs}, i in 1..n_sets.

    coords: [n, 2] node positions; defaults to lattice positions for the
    road_like generator (node id -> (row, col))."""
    rng = np.random.default_rng(seed)
    if coords is None:
        side = int(np.ceil(np.sqrt(g.n)))
        ids = np.arange(g.n)
        coords = np.stack([ids // side, ids % side], axis=1).astype(float)
    span = coords.max(0) - coords.min(0)
    cell = max(span.max() / grid, 1e-9)
    out: Dict[int, List[Tuple[int, int]]] = {i: [] for i in
                                             range(1, n_sets + 1)}
    need = n_per_set * n_sets
    tries = 0
    while tries < 200 * need and any(len(v) < n_per_set
                                     for v in out.values()):
        tries += 1
        s, t = rng.integers(0, g.n, 2)
        if s == t:
            continue
        gd = np.abs(coords[s] // cell - coords[t] // cell).max()
        if gd < 1:
            continue
        i = int(np.floor(np.log2(max(gd, 1)))) + 1
        if 1 <= i <= n_sets and len(out[i]) < n_per_set:
            out[i].append((int(s), int(t)))
    return {i: np.array(v if v else [(0, 0)], np.int64)
            for i, v in out.items()}
