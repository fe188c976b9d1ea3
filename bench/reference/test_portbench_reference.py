"""The plain reference against brute-force all-pairs distances (a NumPy
Floyd-Warshall) on small road graphs, with and without update batches."""
import numpy as np
import pytest

import roadref


def _road_like(n_target, seed):
    """A small lattice road graph (the benchmark's generator's shape)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n_target))
    ids = np.arange(side * side).reshape(side, side)
    u = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
    v = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
    keep = rng.random(u.size) > 0.35
    u, v = u[keep], v[keep]
    w = rng.integers(1, 1000, u.size).astype(np.float64)
    hu, hv = rng.integers(0, side * side, (2, max(1, side // 4)))
    ok = hu != hv
    u = np.concatenate([u, hu[ok]])
    v = np.concatenate([v, hv[ok]])
    w = np.concatenate([w, rng.integers(500, 5000, ok.sum())])
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key, first = np.unique(lo * side * side + hi, return_index=True)
    return side * side, lo[first], hi[first], w[first].astype(np.float64)


def _floyd_warshall(n, u, v, w):
    d = np.full((n, n), np.inf)
    np.fill_diagonal(d, 0.0)
    np.minimum.at(d, (u, v), w)
    np.minimum.at(d, (v, u), w)
    for k in range(n):
        d = np.minimum(d, d[:, k, None] + d[None, k, :])
    return d


def _batches(n, u, v, w, count, rng):
    out = []
    for _ in range(count):
        idx = rng.choice(u.size, size=max(1, u.size // 20), replace=False)
        out.append((u[idx], v[idx], np.maximum(
            1, np.round(w[idx] * rng.choice([0.25, 0.5, 2, 4], idx.size)))))
    return out


@pytest.mark.parametrize("n_target,seed", [(64, 0), (100, 1), (144, 2)])
def test_dijkstra_equals_all_pairs(n_target, seed):
    n, u, v, w = _road_like(n_target, seed)
    road = roadref.Road(n, u, v, w)
    full = _floyd_warshall(n, u, v, w)
    rng = np.random.default_rng(seed)
    for s in rng.choice(n, 8, replace=False):
        got = road.dijkstra(int(s), np.arange(n))
        np.testing.assert_array_equal(got, full[s])
    pairs = rng.integers(0, n, (50, 2))
    np.testing.assert_array_equal(roadref.exact(road, pairs),
                                  full[pairs[:, 0], pairs[:, 1]])


@pytest.mark.parametrize("seed", [3, 4])
def test_every_epoch_equals_all_pairs_of_its_graph(seed):
    n, u, v, w = _road_like(100, seed)
    rng = np.random.default_rng(seed)
    batches = _batches(n, u, v, w, 3, rng)
    weights = roadref.replay(n, u, v, w, batches)
    assert len(weights) == 4
    cur = w.copy()
    for e, (bu, bv, bw) in enumerate(batches, start=1):
        for a, b, x in zip(bu, bv, bw):
            cur[(u == min(a, b)) & (v == max(a, b))] = x
        np.testing.assert_array_equal(weights[e], cur)
        full = _floyd_warshall(n, u, v, cur)
        pairs = rng.integers(0, n, (40, 2))
        got = roadref.exact(roadref.Road(n, u, v, weights[e]), pairs)
        np.testing.assert_array_equal(got, full[pairs[:, 0], pairs[:, 1]])


def test_replay_keeps_the_last_of_duplicate_updates_and_refuses_non_edges():
    n, u, v, w = 4, np.array([0, 1, 2]), np.array([1, 2, 3]), \
        np.array([5.0, 6.0, 7.0])
    out = roadref.replay(n, u, v, w, [(np.array([1, 2]), np.array([0, 1]),
                                       np.array([9.0, 8.0]))])
    np.testing.assert_array_equal(out[1], [9.0, 8.0, 7.0])
    with pytest.raises(ValueError):
        roadref.replay(n, u, v, w, [(np.array([0]), np.array([3]),
                                     np.array([1.0]))])


def test_path_fault_names_each_fault():
    n, u, v, w = 4, np.array([0, 1, 2]), np.array([1, 2, 3]), \
        np.array([5.0, 6.0, 7.0])
    road = roadref.Road(n, u, v, w)
    assert roadref.path_fault(road, 0, 3, [0, 1, 2, 3], 18.0) == ""
    assert "endpoints" in roadref.path_fault(road, 0, 3, [1, 2, 3], 13.0)
    assert "off the graph" in roadref.path_fault(road, 0, 3, [0, 2, 3], 18.0)
    assert "sum" in roadref.path_fault(road, 0, 3, [0, 1, 2, 3], 17.0)
    assert roadref.path_fault(road, 0, 0, [0], 0.0) == ""
    assert roadref.path_fault(road, 0, 3, None, float("inf")) == ""
    assert roadref.path_fault(road, 0, 3, None, 18.0) == "no path"


def test_bfloat16_rounding_and_the_control():
    assert roadref._bf16(257.0) == 256.0
    assert roadref._bf16(259.0) == 260.0
    assert roadref._bf16(21503.0) == 21504.0
    assert roadref._bf16(0.0) == 0.0 and roadref._bf16(np.inf) == np.inf
    n, u, v, w = _road_like(144, 5)
    road = roadref.Road(n, u, v, w)
    pairs = np.random.default_rng(5).integers(0, n, (40, 2))
    exact = roadref.exact(road, pairs)
    low = roadref.exact(road, pairs, bf16=True)
    assert (low != exact).sum() > 10
