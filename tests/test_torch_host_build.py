"""The port's host build (numpy copies) against the reference package's.

Same graphs in both, every index table array-equal: the DislandIndex
(DRAs, shrink graph, partition, fragments, covers, SUPER graph) and the
device BuildPlan assembled from it.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import device_engine as jde
from repro.core import graph as jgraph
from repro.core import padding as jpadding
from repro.core.supergraph import build_index as jbuild_index
from repro.core.supergraph import index_arrays_equal
from repro.data import roads as jroads
from repro_torch.core import device_engine as tde
from repro_torch.core import graph as tgraph
from repro_torch.core import padding as tpadding
from repro_torch.core.supergraph import build_index as tbuild_index
from repro_torch.data import roads as troads

GRAPHS = {
    "road_like_900": lambda: jgraph.road_like(900, seed=0),
    "random_graph": lambda: jgraph.random_graph(300, 700, seed=4),
    "tree_with_blobs": lambda: jgraph.tree_with_blobs(12, 6, seed=2),
}


def _port_graph(g) -> tgraph.Graph:
    return tgraph.Graph(**{f.name: getattr(g, f.name)
                           for f in dataclasses.fields(g)})


def _graph_arrays(g):
    return [g.n] + [getattr(g, f) for f in ("indptr", "indices", "weights",
                                            "edge_u", "edge_v", "edge_w")]


@pytest.mark.parametrize("n,seed", [(900, 0), (2500, 3)])
def test_road_like_matches_reference(n, seed):
    for a, b in zip(_graph_arrays(tgraph.road_like(n, seed=seed)),
                    _graph_arrays(jgraph.road_like(n, seed=seed))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_index_matches_reference(name):
    g = GRAPHS[name]()
    jix = jbuild_index(g)
    tix = tbuild_index(_port_graph(g))
    eq = index_arrays_equal(tix, jix)
    assert all(eq.values()), {k: v for k, v in eq.items() if not v}
    assert sorted(tix.timings) == sorted(jix.timings)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_plan_matches_reference(name):
    g = GRAPHS[name]()
    jplan = jde.make_build_plan(jbuild_index(g))
    tplan = tde.make_build_plan(tbuild_index(_port_graph(g)))
    for f in dataclasses.fields(tplan):
        a, b = getattr(tplan, f.name), getattr(jplan, f.name)
        if f.name == "piece_members":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif f.name != "build_timings":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
    jde.super_weights(jplan, jplan.frag_adj)
    tde.super_weights(tplan, tplan.frag_adj)
    np.testing.assert_array_equal(tplan.sup_w, jplan.sup_w)
    np.testing.assert_array_equal(tde.super_overlay(tplan),
                                  np.asarray(jde.super_overlay(jplan)))
    np.testing.assert_array_equal(tde.overlay_slot_table(tplan),
                                  jde.overlay_slot_table(jplan))
    np.testing.assert_array_equal(
        np.stack(tde._node_piece_addressing(tplan)),
        np.stack(jde._node_piece_addressing(jplan)))


@pytest.mark.parametrize("x", [0, 1, 7, 8, 9, 100, 1023, 1025])
def test_padding_rules_match_reference(x):
    assert tpadding.pad_to(x) == jpadding.pad_to(x)
    assert tpadding.pow2(x, 8) == jpadding.pow2(x, 8)
    assert tpadding.pad_pow2(x) == jpadding.pad_pow2(x)


def test_presets_match_reference_but_road64k_closes_densely():
    """Every preset equals the reference's, hierarchy included: road64k
    no longer closes densely now that the hierarchy is ported (the name
    is kept from the slice that pinned it to one level)."""
    assert sorted(troads.ROAD_PRESETS) == sorted(jroads.ROAD_PRESETS)
    for name, p in troads.ROAD_PRESETS.items():
        q = jroads.ROAD_PRESETS[name]
        assert (p.nodes, p.seed, p.hierarchy) == (q.nodes, q.seed,
                                                  q.hierarchy), name
    assert troads.road_preset("road64k").hierarchy == 3
    with pytest.raises(ValueError, match="unknown road preset"):
        troads.road_preset("road1")


@pytest.mark.parametrize("S,levels", [(0, "auto"), (500, "auto"),
                                      (5000, "auto"), (5000, 1),
                                      (5000, 3), (0, 2)])
def test_resolve_hierarchy_levels_matches_reference(S, levels):
    assert (tde.resolve_hierarchy_levels(S, levels)
            == jde.resolve_hierarchy_levels(S, levels))
