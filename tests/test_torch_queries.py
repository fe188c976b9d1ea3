"""The port's serving workload generators (``repro_torch.data.queries``)
against the reference's (``repro.data.queries``): the same graph and
seed give array-equal pairs for every mix, the Zipf pool the hub tier
pins its labels from, and the paper's grid-distance query sets."""
import dataclasses

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.data import queries as jq
from repro_torch.core import graph as tgraph
from repro_torch.data import queries as tq

SEEDS = (0, 4, 17)


def _graphs(n, seed):
    g = jgraph.road_like(n, seed=seed)
    return tgraph.Graph(**{f.name: getattr(g, f.name)
                           for f in dataclasses.fields(g)}), g


@pytest.mark.parametrize("mix", ["uniform", "zipf", "geo"])
@pytest.mark.parametrize("seed", SEEDS)
def test_workload_pairs_equal_reference(mix, seed):
    tg, jg = _graphs(900, 2)
    got = tq.workload_pairs(tg, mix, 3000, seed=seed)
    want = jq.workload_pairs(jg, mix, 3000, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.shape == (3000, 2)
    assert (got[:, 0] != got[:, 1]).all()
    assert (got >= 0).all() and (got < tg.n).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_zipf_pool_and_pairs_equal_reference(seed):
    tg, jg = _graphs(400, 1)
    np.testing.assert_array_equal(tq.zipf_pool(tg, seed=seed),
                                  jq.zipf_pool(jg, seed=seed))
    np.testing.assert_array_equal(
        tq.zipf_pairs(tg, 2000, a=0.8, pool=256, seed=seed),
        jq.zipf_pairs(jg, 2000, a=0.8, pool=256, seed=seed))
    assert (tq.top_pair_mass(0.01, a=0.8, pool=256)
            == jq.top_pair_mass(0.01, a=0.8, pool=256))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("radius", [1, 9])
def test_geo_local_pairs_equal_reference(seed, radius):
    tg, jg = _graphs(170, 4)
    np.testing.assert_array_equal(
        tq.geo_local_pairs(tg, 2500, radius=radius, seed=seed),
        jq.geo_local_pairs(jg, 2500, radius=radius, seed=seed))
    coords = np.random.default_rng(seed).random((tg.n, 2)) * 256
    np.testing.assert_array_equal(
        tq.geo_local_pairs(tg, 64, radius=64, coords=coords, seed=seed),
        jq.geo_local_pairs(jg, 64, radius=64, coords=coords, seed=seed))


def test_grid_distance_queries_equal_reference():
    tg, jg = _graphs(900, 0)
    got = tq.grid_distance_queries(tg, n_per_set=20, seed=3)
    want = jq.grid_distance_queries(jg, n_per_set=20, seed=3)
    assert sorted(got) == sorted(want)
    for i in got:
        np.testing.assert_array_equal(got[i], want[i])


def test_bad_mix_and_sizes_raise():
    tg, _ = _graphs(300, 5)
    with pytest.raises(ValueError, match="unknown workload mix"):
        tq.workload_pairs(tg, "bogus", 8)
    with pytest.raises(ValueError):
        tq.zipf_pairs(tg, 0)
    with pytest.raises(ValueError):
        tq.geo_local_pairs(tg, 0)
