"""The frozen generators against the program's copies they were taken
from, and their determinism by seed."""
import argparse

import numpy as np
import pytest

import portbench_small  # noqa: F401  (puts bench/ and src/ on the path)
from portbench import gen, harness

from repro_torch.core import graph as pgraph
from repro_torch.data import queries as pqueries
from repro_torch.launch import serve as pserve


@pytest.mark.parametrize("n,seed", [(400, 0), (900, 3), (1400, 23)])
def test_road_like_is_the_programs(n, seed):
    mine = gen.road_like(n, seed)
    theirs = pgraph.road_like(n, seed=seed)
    assert mine.n == theirs.n
    for a in ("edge_u", "edge_v", "edge_w", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(mine, a), getattr(theirs, a))
    ported = harness.port_graph(mine)
    np.testing.assert_array_equal(ported.weights, theirs.weights)


def test_pairs_pool_and_hubs_are_the_programs():
    g = gen.road_like(900, 2)
    pg = pgraph.road_like(900, seed=2)
    pool = gen.zipf_pool(g.n, 256, np.random.default_rng(9))
    np.testing.assert_array_equal(pool, pqueries.zipf_pool(pg, pool=256,
                                                            seed=9))
    uni = gen.uniform_pairs(g.n, 500, np.random.default_rng(4))
    np.testing.assert_array_equal(
        uni, pqueries.workload_pairs(pg, "uniform", 500, seed=4))
    r = np.random.default_rng(5)
    pool = gen.zipf_pool(g.n, 2048, r)
    picks = gen.zipf_picks(len(pool), 300, 1.2, r)
    np.testing.assert_array_equal(
        pool[picks], pqueries.zipf_pairs(pg, 300, a=1.2, pool=2048, seed=5))
    hubs = gen.hub_selection(gen.zipf_pool(g.n, 2048,
                                           np.random.default_rng(6 + 4)), 64)
    np.testing.assert_array_equal(
        hubs, pserve._hub_selection(pg, argparse.Namespace(hub_budget=64,
                                                           seed=6)))


@pytest.mark.parametrize("seed", [0, 17, 2**31 + 5, 2**40 + 1])
def test_inputs_and_pairs_are_fixed_by_the_seed(seed):
    _wl, config, traffic = portbench_small.small("batch")
    a = harness.Inputs(config, seed)
    b = harness.Inputs(config, seed)
    c = harness.Inputs(config, seed + 1)
    np.testing.assert_array_equal(a.pool, b.pool)
    np.testing.assert_array_equal(a.hubs, b.hubs)
    assert not np.array_equal(a.pool, c.pool)
    mix = [{"kind": "zipf", "a": 1.2, "share": 1},
           {"kind": "walk", "steps": 4, "share": 1},
           {"kind": "uniform", "share": 1}]
    draws = [gen.pairs(mix, x.graph, x.pool, 300, gen.rng(seed, gen.PAIRS))
             for x in (a, b)]
    np.testing.assert_array_equal(*draws)


def test_one_uniform_part_draws_as_uniform_pairs():
    g = gen.road_like(900, 2)
    np.testing.assert_array_equal(
        gen.pairs([{"kind": "uniform"}], g, None, 500,
                  np.random.default_rng(4)),
        gen.uniform_pairs(g.n, 500, np.random.default_rng(4)))


def _hops(g, s):
    """Breadth-first hop counts from s."""
    d = np.full(g.n, -1)
    d[s] = 0
    frontier = [s]
    while frontier:
        nxt = []
        for x in frontier:
            for y in g.indices[g.indptr[x]:g.indptr[x + 1]]:
                if d[y] < 0:
                    d[y] = d[x] + 1
                    nxt.append(int(y))
        frontier = nxt
    return d


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_walk_pairs_stay_within_their_steps(steps):
    g = gen.road_like(900, 1)
    p = gen.walk_pairs(g, 200, steps, np.random.default_rng(3))
    assert p.shape == (200, 2) and (p[:, 0] != p[:, 1]).all()
    for s, t in p[:40]:
        assert 1 <= _hops(g, int(s))[t] <= steps


def test_mixed_parts_follow_their_shares():
    g = gen.road_like(900, 1)
    pool = gen.zipf_pool(g.n, 64, np.random.default_rng(1))
    p = gen.pairs([{"kind": "zipf", "a": 1.2, "share": 3},
                   {"kind": "uniform", "share": 1}], g, pool, 4000,
                  np.random.default_rng(2))
    in_pool = {(int(s), int(t)) for s, t in pool}
    share = np.mean([(int(s), int(t)) in in_pool for s, t in p])
    assert 0.70 < share < 0.80
    with pytest.raises(ValueError):
        gen.pairs([{"kind": "nearby"}], g, pool, 4,
                  np.random.default_rng(2))
