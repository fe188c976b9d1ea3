"""The port's path unwinder on whole batches against the reference.

Batches that mix every kind of witness (self pairs, unreachable pairs,
pieces, via-agent, ``WIT_LOCAL``, routes that stay in their group and
routes that lift through one or both grouping levels) unwind, whole, in
batches of 16 and one path at a time, to the node sequences of the
reference's ``PathUnwinder`` on the reference's index, given the port's
witnesses: on ``road_like(900)`` (a dense epoch), on ``road_like(1400,
seed=23)`` at 3 levels, and on a disconnected union of two road graphs
and a ``tree_with_blobs`` graph with every weight 1 (ties everywhere).
The unwinder's host-built next-level id maps are ``torch.unique``'s of
each group's boundary slots, and a side of a distance block over ids of
several groups scatters its rows as one ``torch.unique`` and a
min-scatter over all of them would.
"""
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core.graph import Graph as JGraph
from repro.core.graph import road_like as jroad_like
from repro.core.paths import PathUnwinder as JPathUnwinder
from repro.core.supergraph import build_index as jbuild_index
from repro_torch.core import device_engine as tde
from repro_torch.core import paths as tpaths
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import Graph, road_like, tree_with_blobs
from repro_torch.core.paths import PathUnwinder
from repro_torch.core.supergraph import build_index
from test_torch_paths import _bucket_pairs

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

_BUILT: dict = {}


def _ref_world(name):
    """(port graph, index, plan, reference index, reference plan):
    "dense" is road_like(900) at one level, "levels" road_like(1400, 23)
    at 3, "union" the disjoint union of road_like(1400, 23),
    road_like(400, 2) and tree_with_blobs(10, 5, 3) with every weight 1
    (ties everywhere; pieces; pairs across components) at 3."""
    key = name
    if key not in _BUILT:
        if name == "union":
            parts = [road_like(1400, seed=23), road_like(400, seed=2),
                     tree_with_blobs(10, 5, seed=3)]
            off = np.cumsum([0] + [p.n for p in parts])
            u = np.concatenate([p.edge_u + o for p, o in zip(parts, off)])
            v = np.concatenate([p.edge_v + o for p, o in zip(parts, off)])
            w = np.ones(u.size)
            g, jg = (Graph.from_edges(off[-1], u, v, w),
                     JGraph.from_edges(off[-1], u, v, w))
            lv = 3
        else:
            n, seed, lv = {"dense": (900, 0, 1), "levels": (1400, 23, 3)}[name]
            g, jg = road_like(n, seed=seed), jroad_like(n, seed=seed)
        dix, plan = tde.build_device_index_with_plan(
            build_index(g), device="cpu", hierarchy_levels=lv)
        jdix, jplan = jde.build_device_index_with_plan(
            jbuild_index(jg), hierarchy_levels=lv)
        assert dix.hierarchy_levels == lv
        _BUILT[key] = (g, dix, plan, jdix, jplan)
    return _BUILT[key]


@pytest.mark.parametrize("world", ["dense", "levels", "union"])
def test_batches_unwind_to_the_reference_paths(world, monkeypatch):
    g, dix, plan, jdix, jplan = _ref_world(world)
    rng = np.random.default_rng(8)
    pairs = np.concatenate(list(_bucket_pairs(dix, rng, 40).values())
                           + [rng.integers(0, g.n, (120, 2))])
    pairs[::37, 1] = pairs[::37, 0]                          # s == t
    rng.shuffle(pairs)
    s, t = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    dist, wit = QueryPlanner(dix).query_witness(s, t)
    ju = JPathUnwinder(jdix, jplan)
    want = [ju.unwind(int(a), int(b), d, int(w))
            for a, b, d, w in zip(s, t, dist, wit)]
    uw = PathUnwinder(dix, plan)
    decided, route = [], uw._decide_routes

    def recorded(x, y):
        decided.append(route(x, y))
        return decided[-1]

    monkeypatch.setattr(uw, "_decide_routes", recorded)
    assert uw.unwind_many(s, t, dist, wit) == want
    for i in range(0, s.size, 16):
        sl = slice(i, i + 16)
        assert uw.unwind_many(s[sl], t[sl], dist[sl], wit[sl]) == want[sl]
    assert [uw.unwind(int(a), int(b), d, int(w))
            for a, b, d, w in zip(s, t, dist, wit)] == want
    agent = plan.agent_of
    cross = (s != t) & (agent[s] != agent[t]) & np.isfinite(dist)
    assert (s == t).any() and (cross & (wit >= 0)).any()
    assert (cross & (wit == tde.WIT_LOCAL)).any()
    if world == "union":
        assert any(p is None for p in want)
        same = (s != t) & (agent[s] == agent[t])
        assert (same & (wit == tde.WIT_PIECE)).any()
        assert (same & (wit == tde.WIT_VIA_AGENT)).any()
    if world == "dense":
        assert decided == []
        return
    lifts = decided[0][0]
    assert len(lifts) == (cross & (wit >= 0)).sum()
    assert any(not lf for lf in lifts) and any(1 in lf for lf in lifts)
    if world == "levels":                   # through both grouping levels
        assert any(2 in lf for lf in lifts)


@pytest.mark.parametrize("world", ["levels", "union"])
def test_next_ids_are_torch_unique_of_each_group(world):
    """The unwinder's per-group next-level ids and slot indices ==
    ``torch.unique(..., return_inverse=True)`` of the group's boundary
    slots (an invalid slot reaching id 0), at every grouping level; a
    side of a block over ids of several groups scatters each row to the
    union of theirs exactly as one ``torch.unique`` over all its rows
    and a min-scatter would."""
    _g, dix, plan, _jdix, _jplan = _ref_world(world)
    uw = PathUnwinder(dix, plan)
    rng = np.random.default_rng(3)
    spans = []
    for lvl, h in enumerate(plan.hier, start=1):
        valid = torch.as_tensor(h.bnd2_valid)
        sid = torch.as_tensor(h.bnd2_sid.astype(np.int64))
        keys = torch.where(valid, sid, 0)
        for g, (ids, inv) in enumerate(uw.next_ids[lvl - 1]):
            want_ids, want_inv = torch.unique(keys[g], return_inverse=True)
            np.testing.assert_array_equal(ids, want_ids.numpy())
            np.testing.assert_array_equal(inv, want_inv.numpy())
        xs = rng.choice(h.sf_of.size, min(h.sf_of.size, 40), replace=False)
        spans.append(np.unique(h.sf_of[xs]).size)
        st = tpaths._Stage()
        hs = [st.add(a) for a in (h.sf_of[xs], h.pos_in_sf[xs])]
        (got_ids,), run = uw._plan_side(st, lvl, [xs], *hs, False)
        sf = torch.as_tensor(h.sf_of[xs].astype(np.int64))
        ids, inv = torch.unique(keys[sf], return_inverse=True)
        r = torch.where(valid[sf], uw.l2row[lvl - 1][
            sf, torch.as_tensor(h.pos_in_sf[xs].astype(np.int64))],
            float("inf"))
        dense = torch.full((xs.size, ids.numel()), float("inf"))
        dense.scatter_reduce_(1, inv, r, reduce="amin")
        np.testing.assert_array_equal(got_ids, ids.numpy())
        np.testing.assert_array_equal(
            run(st.load(uw.dev)).view(xs.size, -1).numpy(), dense.numpy())
    assert max(spans) > 1                 # a side over several groups
