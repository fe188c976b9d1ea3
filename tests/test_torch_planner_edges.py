"""The port's QueryPlanner on edge cases, on a disconnected graph, and
pinned to an epoch.

The cases of ``tests/test_planner_edges.py``: a batch of one per planner
case, single-case batches (no other bucket dispatched), the empty batch,
pow2 filler that never leaks into answers (the (0, 0) filler query also
asked for real), and self queries, all ``==`` Dijkstra.  Then the
disjoint union of ``road_like(1400, 23)``, ``road_like(400, 2)`` and
``tree_with_blobs(10, 5, 3)`` with 200 hub nodes at hierarchy levels 1,
2 and 3: planner distances, ``hub_mask`` / ``query_hub`` and one-to-all
array-equal to the reference package and ``==`` Dijkstra, unreachable
pairs included, before and after one refresh epoch.  Last, the epoch
pin: ``plan`` / ``hub_mask`` / ``query`` with ``dix=`` bucket and gate
with that epoch's sidecars, and the planner's cached maps are hit or
missed by index identity.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core.dist_engine import QueryPlanner as JQueryPlanner
from repro.core.graph import Graph as JGraph
from repro.core.supergraph import build_index as jbuild_index
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra, padding
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import (Graph, road_like, traffic_updates,
                                    tree_with_blobs)
from repro_torch.core.supergraph import build_index
from repro_torch.launch.serve import REFRESHED_FIELDS

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

_BUILT: dict = {}


def _world(name):
    """(graph, index, planner): "dense" is road_like(1000, 41) at one
    level; "res" is road_like(2500, 3) at 3 levels, whose resident rows
    make the cross_res bucket reachable."""
    if name not in _BUILT:
        n, seed, lv = {"dense": (1000, 41, 1), "res": (2500, 3, 3)}[name]
        g = road_like(n, seed=seed)
        dix = tde.build_device_index(build_index(g), device="cpu",
                                     hierarchy_levels=lv)
        _BUILT[name] = (g, dix, QueryPlanner(dix))
    return _BUILT[name]


def _oracle(g, s, t):
    return np.array([dijkstra.pair(g, int(a), int(b)) for a, b in zip(s, t)],
                    np.float32)


def _check(g, planner, pairs):
    pairs = np.asarray(pairs)
    got = planner(pairs[:, 0], pairs[:, 1])
    np.testing.assert_array_equal(got, _oracle(g, pairs[:, 0], pairs[:, 1]))
    return got


def _pairs_of_case(dix, case, n):
    """n query pairs all of one planner case."""
    agent_of = dix.agent_of.numpy()
    fa = dix.frag_of.numpy()[agent_of]
    out = []
    if case == "same_dra":
        agents, counts = np.unique(agent_of, return_counts=True)
        members = np.nonzero(agent_of == agents[np.argmax(counts)])[0]
        out = [(members[i % members.size], members[(i + 1) % members.size])
               for i in range(n)]
    elif case == "same_frag":
        for f in np.unique(fa[fa >= 0]):
            nodes = np.nonzero(fa == f)[0]
            us = agent_of[nodes]
            if np.unique(us).size >= 2:
                out = [(nodes[0], nodes[int(np.argmax(us != us[0]))])] * n
                break
    elif case == "cross_res":
        rf, tg = dix.host_res_frag, dix.host_topgrp_frag
        hot = np.nonzero(rf >= 0)[0]
        f0 = int(hot[0])
        f1 = int(hot[np.argmax(tg[hot] != tg[f0])])
        assert tg[f1] != tg[f0], "no resident pair across top groups"
        out = [(np.nonzero(fa == f0)[0][0], np.nonzero(fa == f1)[0][0])] * n
    else:                                          # cross_frag
        valid = np.nonzero(fa >= 0)[0]
        other = valid[np.argmax(fa[valid] != fa[valid[0]])]
        if dix.host_res_frag is not None:          # keep the pair cold
            cold = np.nonzero(dix.host_res_frag[fa[valid]] < 0)[0]
            if cold.size:
                other = valid[cold[0]]
        out = [(valid[0], other)] * n
    assert len(out) == n, f"could not build {case} pairs"
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("case", QueryPlanner.CASES)
def test_batch_of_one(case):
    g, dix, planner = _world("res" if case == "cross_res" else "dense")
    _check(g, planner, _pairs_of_case(dix, case, 1))
    assert planner.last_counts[case] == 1
    assert sum(planner.last_counts.values()) == 1


@pytest.mark.parametrize("case", QueryPlanner.CASES)
def test_single_case_batches(case):
    """A batch entirely of one case dispatches no other bucket."""
    g, dix, planner = _world("res" if case == "cross_res" else "dense")
    _check(g, planner, _pairs_of_case(dix, case, 13))   # odd: pow2 pad
    for c, n in planner.last_counts.items():
        assert n == (13 if c == case else 0)


def test_empty_batch():
    _g, _dix, planner = _world("dense")
    got = planner(np.empty(0, np.int64), np.empty(0, np.int64))
    assert got.shape == (0,) and got.dtype == np.float32
    assert all(n == 0 for n in planner.last_counts.values())
    d, w = planner.query_witness(np.empty(0, np.int64),
                                 np.empty(0, np.int64))
    assert d.shape == (0,) and w.shape == (0,)


@pytest.mark.parametrize("size", [1, 2, 3, 5, 17, 100])
def test_pow2_filler_never_leaks(size):
    """Non-pow2 batches get filler slots; the answers equal Dijkstra,
    the degenerate query (0, 0) asked for real included."""
    g, _dix, planner = _world("dense")
    pairs = np.random.default_rng(size).integers(0, g.n, size=(size, 2))
    pairs[0] = (0, 0)
    got = _check(g, planner, pairs)
    assert got[0] == 0.0 and got.shape == (size,)
    assert padding.pad_pow2(size) >= size


@pytest.mark.parametrize("world", ["dense", "res"])
def test_self_queries_everywhere(world):
    g, _dix, planner = _world(world)
    s = np.arange(0, g.n, 97)
    np.testing.assert_array_equal(planner(s, s), np.zeros(s.size, np.float32))
    d, w = planner.query_witness(s, s)
    np.testing.assert_array_equal(d, 0.0)
    np.testing.assert_array_equal(w, -1)


# -- a disconnected graph ----------------------------------------------------

def _union():
    """(port graph, reference graph, component sizes, hub nodes) of the
    3-component union."""
    if "union" not in _BUILT:
        parts = [road_like(1400, seed=23), road_like(400, seed=2),
                 tree_with_blobs(10, 5, seed=3)]
        us, vs, ws, off = [], [], [], 0
        for p in parts:
            us.append(p.edge_u.astype(np.int64) + off)
            vs.append(p.edge_v.astype(np.int64) + off)
            ws.append(p.edge_w)
            off += p.n
        u, v, w = np.concatenate(us), np.concatenate(vs), np.concatenate(ws)
        hubs = np.random.default_rng(9).choice(off, 200, replace=False)
        _BUILT["union"] = (Graph.from_edges(off, u, v, w),
                           JGraph.from_edges(off, u, v, w),
                           [p.n for p in parts], hubs)
    return _BUILT["union"]


def _union_built(lv):
    """Port and reference (index, plan) of the union at ``lv`` levels,
    with the hub set; then the same refresh epoch through both."""
    key = ("union", lv)
    if key not in _BUILT:
        g, jg, _sizes, hubs = _union()
        dix, plan = tde.build_device_index_with_plan(
            build_index(g), device="cpu", hierarchy_levels=lv,
            hub_nodes=hubs)
        jdix, jplan = jde.build_device_index_with_plan(
            jbuild_index(jg), hierarchy_levels=lv, hub_nodes=hubs)
        assert dix.hierarchy_levels == lv
        u, v, w = traffic_updates(g, 0.02, seed=5, jam_frac=0.5)
        g2, jg2 = g.with_edge_weights(u, v, w), jg.with_edge_weights(u, v, w)
        dix2, stats = tde.refresh_index(dix, plan, g2, u, v, w)
        jdix2, jstats = jde.refresh_index(jdix, jplan, jg2, u, v, w)
        assert stats.top_closure == jstats.top_closure
        _BUILT[key] = {0: (g, dix, jdix), 1: (g2, dix2, jdix2)}
    return _BUILT[key]


def _union_pairs(g, sizes, seed=4):
    """Random pairs within and across the components (so about two
    thirds are unreachable), plus self pairs."""
    rng = np.random.default_rng(seed)
    s, t = rng.integers(0, g.n, 192), rng.integers(0, g.n, 192)
    offs = np.cumsum([0] + sizes[:-1])
    for c, (o, n) in enumerate(zip(offs, sizes)):   # some within each
        s[c * 16:(c + 1) * 16] = o + rng.integers(0, n, 16)
        t[c * 16:(c + 1) * 16] = o + rng.integers(0, n, 16)
    s[-4:] = t[-4:]
    return s, t


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("lv", [1, 2, 3])
def test_disconnected_distances_match_reference_and_dijkstra(lv, epoch):
    g, dix, jdix = _union_built(lv)[epoch]
    s, t = _union_pairs(g, _union()[2])
    got = QueryPlanner(dix).query(s, t)
    want = _oracle(g, s, t)
    assert np.isinf(want).sum() > 32 and np.isfinite(want).sum() > 32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JQueryPlanner(jdix).query(s, t))


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("lv", [1, 2, 3])
def test_disconnected_hub_tier_matches_reference(lv, epoch):
    g, dix, jdix = _union_built(lv)[epoch]
    _g, _jg, _sizes, hubs = _union()
    rng = np.random.default_rng(3)
    s, t = rng.choice(hubs, 4096), rng.choice(hubs, 4096)
    planner, jplanner = QueryPlanner(dix), JQueryPlanner(jdix)
    mask = planner.hub_mask(s, t)
    np.testing.assert_array_equal(mask, jplanner.hub_mask(s, t))
    assert mask.any()
    got = planner.query_hub(s[mask], t[mask])
    np.testing.assert_array_equal(got, jplanner.query_hub(s[mask], t[mask]))
    np.testing.assert_array_equal(got, planner.query(s[mask], t[mask]))
    np.testing.assert_array_equal(got[:48], _oracle(g, s[mask][:48],
                                                    t[mask][:48]))
    assert np.isinf(got).any()           # gated pairs across components


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("lv", [1, 2, 3])
def test_disconnected_one_to_all_matches_reference(lv, epoch):
    g, dix, jdix = _union_built(lv)[epoch]
    sizes = _union()[2]
    for src in (3, sizes[0] + 3, sizes[0] + sizes[1] + 3):
        got = tde.serve_one_to_all(dix, src).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jde.serve_one_to_all(jdix, src)))
        np.testing.assert_array_equal(got, dijkstra.sssp(g, src).astype(
            np.float32))


@pytest.mark.parametrize("lv", [1, 2, 3])
def test_disconnected_refresh_matches_reference_and_rebuild(lv):
    from repro_torch.core.supergraph import reweight_index
    g2, dix2, jdix2 = _union_built(lv)[1]
    _g, _jg, _sizes, hubs = _union()
    eq = tde.index_fields_equal(dix2, jdix2, REFRESHED_FIELDS)
    assert all(eq.values()), [k for k, ok in eq.items() if not ok]
    assert all(tde.sidecars_equal(dix2, jdix2).values())
    sdix = tde.build_device_index(reweight_index(build_index(_g), g2),
                                  device="cpu", hierarchy_levels=lv,
                                  hub_nodes=hubs)
    assert all(tde.index_fields_equal(dix2, sdix, REFRESHED_FIELDS).values())
    assert all(tde.sidecars_equal(dix2, sdix).values())


# -- the epoch pin -----------------------------------------------------------

def test_plan_pinned_to_an_epoch_buckets_with_its_sidecars():
    g, dix, _planner = _world("res")
    planner = QueryPlanner(dix)
    s = np.repeat(_pairs_of_case(dix, "cross_res", 1)[:, 0], 8)
    t = np.repeat(_pairs_of_case(dix, "cross_res", 1)[:, 1], 8)
    rng = np.random.default_rng(2)
    s = np.concatenate([s, rng.integers(0, g.n, 56)])
    t = np.concatenate([t, rng.integers(0, g.n, 56)])
    want = planner.plan(s, t)
    assert want["cross_res"].size >= 8
    # the next epoch carries no resident rows: its own plan has no
    # cross_res bucket, the pinned old epoch keeps its
    cold = dataclasses.replace(
        dix, host_res_frag=np.full_like(dix.host_res_frag, -1))
    planner.set_index(cold)
    assert planner.plan(s, t)["cross_res"].size == 0
    for case, idx in planner.plan(s, t, dix).items():
        np.testing.assert_array_equal(idx, want[case])
    got = planner.query(s, t, dix=dix)
    assert planner.last_counts["cross_res"] == want["cross_res"].size
    np.testing.assert_array_equal(got, _oracle(g, s, t))


def test_hub_gate_pinned_to_an_epoch():
    g, dix, _jdix = _union_built(2)[0]
    hubs = _union()[3]
    rng = np.random.default_rng(8)
    s, t = rng.choice(hubs, 512), rng.choice(hubs, 512)
    planner = QueryPlanner(dix)
    want = planner.hub_mask(s, t)
    assert want.any()
    planner.set_index(dataclasses.replace(dix, host_hub_agent=None))
    assert not planner.hub_mask(s, t).any()
    np.testing.assert_array_equal(planner.hub_mask(s, t, dix), want)
    np.testing.assert_array_equal(
        planner.query_hub(s[want], t[want], dix=dix),
        planner.query(s[want], t[want], dix=dix))


def test_maps_hit_or_miss_by_index_identity():
    _g, dix, _planner = _world("res")
    planner = QueryPlanner(dix)
    assert planner._maps_of(None) is planner._maps
    assert planner._maps_of(dix) is planner._maps          # hit
    twin = dataclasses.replace(dix)                        # equal, not dix
    miss = planner._maps_of(twin)
    assert miss is not planner._maps and miss[0] is twin
    for a, b in zip(miss[1:], planner._maps[1:]):
        np.testing.assert_array_equal(a, b)
    planner.set_index(twin)
    assert planner._maps[0] is twin and planner.dix is twin
    assert planner._maps_of(dix)[0] is dix                 # now a miss
