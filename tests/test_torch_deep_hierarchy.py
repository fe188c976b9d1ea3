"""The port's hierarchy at 4 and 5 levels against the reference package.

``road_like(1400, 23)`` at 4 levels and ``road_like(6000, 0)`` at 5 build
to their full depth, the last grouping level one group, so their top is
empty (S2 = 0) and every cross answer comes out of that group's
closure.  Two more graphs keep a top closure at depth: ``road_like(2000,
0)`` at 4 levels (top 65) and ``road_like(1400, 23)`` at 5 levels with
the group budget cut to a third in both packages (groups 8, 5, 3 and 2
over the levels, top 39), so a small graph gets the ladder of a large
one.  On each, the port's ``plan_hierarchy`` structure, every
``DeviceIndex`` field and host sidecar is array-equal to the
reference's build of the same graph; every distance it serves
(``serve_step``, the planner in both layouts, ``serve_cross_res`` and
``serve_one_to_all``) and every witness of ``query_witness`` is ``==``
the reference's (``serve_step_w``'s distances ``==`` the planner's),
and the distances and the unwound paths ``==`` Dijkstra in every
bucket; a reference-built index carried across through ``convert``
serves the same answers.  The unwinder's distance blocks equal each
level's dense closure, and the one-pass piece adjacency each piece's
induced subgraph.  The torch
``first_hops`` is held against the reference's numpy function on the
top closures of the 3-, 4- and 5-level graphs, on row/column blocks,
on ties, on a disconnected graph and with one row a chunk.  Integer
weights keep every float32 sum exact: every comparison is exact
(``==``).
"""
import contextlib
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core import hierarchy as jhier
from repro.core.dist_engine import QueryPlanner as JQueryPlanner
from repro.core.graph import road_like as jroad_like
from repro.core.supergraph import build_index as jbuild_index
from repro_torch import convert
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra, hierarchy
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.core.paths import PathUnwinder, path_weight
from repro_torch.core.supergraph import build_index

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

LAYOUTS = ("gather", "scatter")
#: (nodes, seed, levels, group budget divisor)
CASES = [(1400, 23, 4, 1), (6000, 0, 5, 1), (2000, 0, 4, 1),
         (1400, 23, 5, 3)]
#: the cases whose top closure is not empty
TOPPED = [(2000, 0, 4, 1), (1400, 23, 5, 3)]
BUCKETS = ("same_dra", "same_frag", "cross_frag")
N_PER_BUCKET = 60
_BUILT: dict = {}


@contextlib.contextmanager
def group_budget(div: int):
    """Both packages' per-group budget (``_default_gamma2``) divided by
    ``div``, floored at 8 (1: unchanged)."""
    if div == 1:
        yield
        return

    def cut(fn):
        return lambda S: max(8, fn(S) // div)
    with mock.patch.object(hierarchy, "_default_gamma2",
                           cut(hierarchy._default_gamma2)), \
            mock.patch.object(jhier, "_default_gamma2",
                              cut(jhier._default_gamma2)):
        yield


def _built(case):
    """(port graph, port index, port plan, reference index, reference
    plan), built once per test process."""
    if case not in _BUILT:
        n, seed, lv, div = case
        with group_budget(div):
            jdix, jplan = jde.build_device_index_with_plan(
                jbuild_index(jroad_like(n, seed=seed)), hierarchy_levels=lv)
            g = road_like(n, seed=seed)
            dix, plan = tde.build_device_index_with_plan(
                build_index(g), device="cpu", hierarchy_levels=lv)
        _BUILT[case] = (g, dix, plan, jdix, jplan)
    return _BUILT[case]


def _oracle(g, s, t):
    return np.array([dijkstra.pair(g, int(a), int(b))
                     for a, b in zip(s, t)], np.float32)


def _pairs(g, dix, seed=0, n_random=120):
    """Random pairs plus pairs for every planner bucket, resident pairs
    in different top groups included where the index has them."""
    rng = np.random.default_rng(seed)
    s = list(rng.integers(0, g.n, n_random))
    t = list(rng.integers(0, g.n, n_random))
    agent = dix.agent_of.numpy()
    fa = dix.frag_of.numpy()[agent]
    agents, counts = np.unique(agent, return_counts=True)
    members = np.nonzero(agent == agents[np.argmax(counts)])[0]
    s.append(members[0])
    t.append(members[-1])
    for f in np.unique(fa[fa >= 0])[:6]:
        nodes = np.nonzero(fa == f)[0]
        other = np.nonzero((fa >= 0) & (fa != f))[0]
        s += [nodes[0], nodes[0]]
        t += [nodes[-1], other[-1]]
    rf, tg = dix.host_res_frag, dix.host_topgrp_frag
    if rf is not None:
        hot = np.nonzero((fa >= 0) & (rf[np.maximum(fa, 0)] >= 0))[0]
        for v in hot[:: max(1, hot.size // 12)]:
            far = hot[tg[fa[hot]] != tg[fa[v]]]
            if far.size:
                s.append(v)
                t.append(far[-1])
    return np.asarray(s, np.int64), np.asarray(t, np.int64)


def _bucket_pairs(dix, rng, bucket, n_pairs=N_PER_BUCKET):
    """``n_pairs`` random pairs of one planner bucket."""
    agent_of = dix.agent_of.numpy()
    fa = dix.frag_of.numpy()[agent_of]
    n = agent_of.size
    pairs = []
    if bucket == "same_dra":
        agents, counts = np.unique(agent_of, return_counts=True)
        multi = agents[counts >= 2]
        while len(pairs) < n_pairs:
            a = int(multi[rng.integers(0, multi.size)])
            pairs.append(rng.choice(np.nonzero(agent_of == a)[0], 2))
    else:
        frags = np.unique(fa[fa >= 0])
        for _ in range(500 * n_pairs):
            if len(pairs) >= n_pairs:
                break
            if bucket == "same_frag":
                f = int(frags[rng.integers(0, frags.size)])
                s, t = rng.choice(np.nonzero(fa == f)[0], 2)
                ok = agent_of[s] != agent_of[t]
            else:
                s, t = rng.integers(0, n, 2)
                ok = (agent_of[s] != agent_of[t] and fa[s] != fa[t]
                      and fa[s] >= 0 and fa[t] >= 0)
            if ok:
                pairs.append((s, t))
    assert len(pairs) >= n_pairs, bucket
    pairs = np.asarray(pairs, np.int64)
    return pairs[:, 0], pairs[:, 1]


def _assert_exact_paths(g, uw, s, t, dist, wit, label):
    for i in range(len(s)):
        want = dijkstra.pair(g, int(s[i]), int(t[i]))
        path = uw.unwind(int(s[i]), int(t[i]), dist[i], int(wit[i]))
        if np.isinf(want):
            assert path is None, (label, i, path)
            continue
        assert path[0] == s[i] and path[-1] == t[i], (label, i)
        # path_weight raises on any hop that is not a real edge
        assert path_weight(g, path) == float(dist[i]) == want, \
            (label, int(s[i]), int(t[i]), path)


# -- build --------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_builds_at_full_depth(case):
    """Each graph builds at the depth asked for, in both packages; the
    cases in TOPPED keep a non-empty top closure above groups that are
    never one alone, the others end in one group with an empty top."""
    _g, dix, plan, jdix, jplan = _built(case)
    lv = case[2]
    assert dix.hierarchy_levels == plan.hierarchy_levels == lv
    assert jplan.hierarchy_levels == lv == 1 + len(jplan.hier)
    top = plan.hier[-1]
    if case in TOPPED:
        assert top.S2 > 0 and all(h.nsf >= 2 for h in plan.hier)
        assert tuple(dix.d2.shape) == (top.S2 + 1, top.S2 + 1)
    else:
        assert top.S2 == 0 and top.nsf == 1


@pytest.mark.parametrize("case", CASES)
def test_plan_hierarchy_matches_reference(case):
    _g, _dix, plan, _jdix, jplan = _built(case)
    assert len(plan.hier) == len(jplan.hier)
    for li, (h, jh) in enumerate(zip(plan.hier, jplan.hier)):
        for f in dataclasses.fields(hierarchy.HierPlan):
            got, want = getattr(h, f.name), getattr(jh, f.name)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype, (li, f.name)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"level {li} {f.name}")
        assert h.overlay_bytes() == jh.overlay_bytes()
    assert hierarchy.hier_overlay_stats(plan.hier, plan.S) \
        == jhier.hier_overlay_stats(jplan.hier, jplan.S)


@pytest.mark.parametrize("case", CASES)
def test_every_field_and_sidecar_matches_reference(case):
    _g, dix, _plan, jdix, _jplan = _built(case)
    for name, dtype in tde.FIELD_DTYPES.items():
        got, want = getattr(dix, name), np.asarray(getattr(jdix, name))
        assert got.dtype == dtype, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name, dtype in tde.TUPLE_FIELD_DTYPES.items():
        got, want = getattr(dix, name), getattr(jdix, name)
        assert len(got) == len(want) == dix.hierarchy_levels - 1, name
        for li, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == dtype, (name, li)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name}[{li}]")
    maps = [(dix.host_ov_slot, jdix.host_ov_slot)]
    maps += list(zip(dix.host_l2_slot, jdix.host_l2_slot, strict=True))
    for a, b in maps:
        assert a.stride == b.stride
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.slots, b.slots)
    for name in ("host_res_frag", "host_topgrp_frag"):
        want = getattr(jdix, name, None)
        if want is None:
            assert getattr(dix, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(dix, name), want)


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_serve_step_and_planner_match_reference_and_dijkstra(case, layout):
    g, dix, _plan, jdix, _ = _built(case)
    s, t = _pairs(g, dix)
    want = np.asarray(jde.serve_step(jdix, jnp.asarray(s, jnp.int32),
                                     jnp.asarray(t, jnp.int32)))
    np.testing.assert_array_equal(want, _oracle(g, s, t))
    got = tde.serve_step(dix, torch.from_numpy(s), torch.from_numpy(t),
                         layout=layout).numpy()
    np.testing.assert_array_equal(got, want)
    planner = QueryPlanner(dix, layout=layout)
    np.testing.assert_array_equal(planner.query(s, t), want)
    counts = planner.last_counts
    assert all(counts[c] for c in BUCKETS), counts
    assert (counts["cross_res"] > 0) == (dix.res_rows.shape[0] > 1), counts


@pytest.mark.parametrize("case", CASES)
def test_serve_cross_res_matches_reference_and_full_lift(case):
    """The planner's resident bucket (non-empty exactly where the index
    has resident rows) through ``serve_cross_res`` in both layouts ==
    the reference's resident program == the full per-level lift ==
    Dijkstra."""
    g, dix, _plan, jdix, _ = _built(case)
    s, t = _pairs(g, dix, seed=5, n_random=400)
    idx = QueryPlanner(dix).plan(s, t)["cross_res"]
    assert (idx.size > 0) == (dix.res_rows.shape[0] > 1)
    s, t = s[idx], t[idx]
    st, tt = torch.from_numpy(s), torch.from_numpy(t)
    want = np.asarray(jde.serve_cross_res(
        jdix, jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32)))
    np.testing.assert_array_equal(
        tde.serve_cross(dix, st, tt, with_local=False).numpy(), want)
    np.testing.assert_array_equal(want, _oracle(g, s, t))
    for layout in LAYOUTS:
        got = tde.serve_cross_res(dix, st, tt, layout=layout).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_serve_one_to_all_matches_reference_and_dijkstra(case):
    g, dix, _plan, jdix, _ = _built(case)
    for src in (0, g.n - 1):
        got = tde.serve_one_to_all(dix, src).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jde.serve_one_to_all(jdix, src)))
        np.testing.assert_array_equal(
            got, dijkstra.sssp(g, src).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_port_serves_from_reference_built_index(case):
    """The reference's index carried across through ``convert`` serves
    the port's answers (== Dijkstra) and round-trips field for field."""
    g, dix, _plan, jdix, _ = _built(case)
    fields = {name: np.asarray(getattr(jdix, name))
              for name in tde.FIELD_DTYPES}
    fields.update({name: [np.asarray(a) for a in getattr(jdix, name)]
                   for name in tde.TUPLE_FIELD_DTYPES})
    fields.update({name: getattr(jdix, name, None)
                   for name in convert.SIDECARS})
    cdix = convert.device_index_from_numpy(fields, "cpu")
    assert cdix.hierarchy_levels == case[2]
    s, t = _pairs(g, dix, seed=3)
    for layout in LAYOUTS:
        got = QueryPlanner(cdix, layout=layout).query(s, t)
        np.testing.assert_array_equal(got, QueryPlanner(dix).query(s, t))
        np.testing.assert_array_equal(got, _oracle(g, s, t))
    back = convert.device_index_to_numpy(cdix)
    for name in tde.FIELD_DTYPES:
        np.testing.assert_array_equal(back[name], fields[name])
    for name in tde.TUPLE_FIELD_DTYPES:
        for a, b in zip(back[name], fields[name], strict=True):
            np.testing.assert_array_equal(a, b)


# -- witnesses and paths ------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_witness_serving_matches_reference(case):
    g, dix, _plan, jdix, _ = _built(case)
    rng = np.random.default_rng(1)
    parts = [_bucket_pairs(dix, rng, b) for b in BUCKETS]
    s = np.concatenate([p[0] for p in parts])
    t = np.concatenate([p[1] for p in parts])
    planner = QueryPlanner(dix)
    dist, wit = planner.query_witness(s, t)
    jdist, jwit = JQueryPlanner(jdix, paths=True).query_witness(
        s.astype(np.int32), t.astype(np.int32))
    np.testing.assert_array_equal(dist, np.asarray(jdist))
    np.testing.assert_array_equal(wit, np.asarray(jwit))
    np.testing.assert_array_equal(dist, planner.query(s, t))
    got_d, _got_w = tde.serve_step_w(dix, torch.from_numpy(s),
                                     torch.from_numpy(t))
    np.testing.assert_array_equal(got_d.numpy(), dist)


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("case", CASES)
def test_paths_exact_per_bucket(case, bucket):
    """The planner's and the monolithic witnesses unwind through every
    group level to edge-valid paths, weight == served distance ==
    Dijkstra."""
    g, dix, plan, _jdix, _ = _built(case)
    s, t = _bucket_pairs(dix, np.random.default_rng(case[1] + 2), bucket)
    uw = PathUnwinder(dix, plan)
    dist, wit = QueryPlanner(dix).query_witness(s, t)
    _assert_exact_paths(g, uw, s, t, dist, wit, bucket)
    mono_d, mono_w = tde.serve_step_w(dix, torch.from_numpy(s),
                                      torch.from_numpy(t))
    _assert_exact_paths(g, uw, s, t, mono_d.numpy(), mono_w.numpy(),
                        f"{bucket} serve_step_w")


@pytest.mark.parametrize("case", CASES)
def test_cross_res_witnesses_unwind(case):
    g, dix, plan, _jdix, _ = _built(case)
    s, t = _pairs(g, dix, seed=4, n_random=400)
    planner = QueryPlanner(dix)
    idx = planner.plan(s, t)["cross_res"]
    assert (idx.size > 0) == (dix.res_rows.shape[0] > 1)
    dist, wit = planner.query_witness(s[idx], t[idx])
    _assert_exact_paths(g, PathUnwinder(dix, plan), s[idx], t[idx], dist,
                        wit, "cross_res")


@pytest.mark.parametrize("case", TOPPED)
def test_unwinder_blocks_are_level_closures(case, monkeypatch):
    """The unwinder's distance blocks (two (min,+) products a level on
    the index's device, in place of the reference's [|xs|, mb2, |U|]
    gather cube over the union U of both sides' ids) equal the dense
    closure of each level's overlay, on random id blocks at every level
    below the top, each level through ``ops.minplus``."""
    _g, dix, plan, _jdix, _ = _built(case)
    uw = PathUnwinder(dix, plan)
    from repro_torch.core import paths
    calls = []
    minplus = paths.ops.minplus

    def counted(a, b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return minplus(a, b, **kw)
    monkeypatch.setattr(paths.ops, "minplus", counted)
    rng = np.random.default_rng(2)
    for lvl in range(2, len(plan.hier) + 1):
        adj = hierarchy.l2_overlay(plan.hier[lvl - 2])
        closed = _closed(adj)
        n = adj.shape[0]
        xs = rng.choice(n, min(n, 40), replace=False)
        ys = rng.choice(n, min(n, 30), replace=False)
        calls.clear()
        got = uw._dist_block(lvl, xs, ys)
        np.testing.assert_array_equal(got, closed[np.ix_(xs, ys)],
                                      err_msg=f"level {lvl}")
        # two products at this level and at each level above, but the top
        assert len(calls) == 2 * (len(plan.hier) + 1 - lvl), (lvl, calls)
        assert calls[-1][0][0] == xs.size and calls[-1][1][1] == ys.size


@pytest.mark.parametrize("graph", ["road", "blobs"])
def test_piece_adjacency_in_one_pass(graph):
    """``_piece_adjs`` builds every bucket's piece adjacency in one pass
    over the edge list, equal to each piece's ``g.subgraph`` (the
    reference's per-piece construction), agents' edges included."""
    from repro_torch.core.graph import tree_with_blobs
    g = (_built((6000, 0, 5, 1))[0] if graph == "road"
         else tree_with_blobs(25, 6, seed=9))
    plan = tde.make_build_plan(build_index(g))
    assert plan.piece_cap.size > 0
    for cap in tde.PIECE_BUCKETS:
        gids = np.nonzero(plan.piece_cap == cap)[0]
        got = tde._piece_adjs(g, plan, gids, cap)
        assert got.shape == (gids.size, cap, cap)
        for gid, a in zip(gids, got):
            sub, _ids = g.subgraph(plan.piece_members[gid])
            want = np.full((cap, cap), np.inf, np.float32)
            want[sub.edge_u, sub.edge_v] = sub.edge_w.astype(np.float32)
            want[sub.edge_v, sub.edge_u] = sub.edge_w.astype(np.float32)
            np.testing.assert_array_equal(a, want, err_msg=f"piece {gid}")


# -- first_hops ---------------------------------------------------------------

def _closed(adj: np.ndarray) -> np.ndarray:
    d = adj.copy()
    for k in range(d.shape[0]):
        np.minimum(d, d[:, k, None] + d[None, k, :], out=d)
    return d


def _random_adj(n, rng, density=0.15, hi=4):
    a = rng.integers(1, hi, (n, n)).astype(np.float32)
    a[rng.random((n, n)) > density] = np.inf
    a = np.minimum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return a


def _first_hops_equal(adj, dist, rows=None, cols=None):
    got = hierarchy.first_hops(torch.from_numpy(adj), torch.from_numpy(dist),
                               rows=rows, cols=cols)
    want = jhier.first_hops(adj, dist, rows=rows, cols=cols)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("case", [(1400, 23, 3, 1)] + TOPPED)
def test_first_hops_on_top_closures(case):
    """The top closure of the 3-, 4- and 5-level graphs: the full
    table == the reference's == the built ``d2_next``, and row/column
    blocks (as the decrease path asks for them) == the reference's."""
    _g, dix, plan, _jdix, _ = _built(case)
    h = plan.hier[-1]
    assert dix.hierarchy_levels == case[2] and h.S2 > 0
    adj = hierarchy.l2_overlay(h)
    dist = dix.d2.numpy()[:h.S2, :h.S2]
    want = _first_hops_equal(adj, dist)
    np.testing.assert_array_equal(dix.d2_next.numpy()[:h.S2, :h.S2], want)
    rng = np.random.default_rng(case[0])
    rows = np.sort(rng.choice(h.S2, max(1, h.S2 // 3), replace=False))
    cols = np.sort(rng.choice(h.S2, max(1, h.S2 // 4), replace=False))
    _first_hops_equal(adj, dist, rows=rows)
    _first_hops_equal(adj, dist, cols=cols)
    _first_hops_equal(adj, dist, rows=rows, cols=cols)
    got = hierarchy.first_hops(torch.from_numpy(adj), torch.from_numpy(dist),
                               rows=torch.from_numpy(rows),
                               cols=torch.from_numpy(cols))
    np.testing.assert_array_equal(
        got.numpy(), jhier.first_hops(adj, dist, rows=rows, cols=cols))


def test_first_hops_ties_take_the_smallest_hop():
    """Weights from {1, 2} on a dense graph tie most first hops: the
    smallest k must win, as in the reference."""
    rng = np.random.default_rng(7)
    adj = _random_adj(60, rng, density=0.5, hi=3)
    dist = _closed(adj)
    want = _first_hops_equal(adj, dist)
    ties = 0
    for i in range(60):
        for j in range(60):
            if i == j:
                continue
            k = np.nonzero(np.isfinite(adj[i]) & (np.arange(60) != i)
                           & (adj[i] + dist[:, j] == dist[i, j]))[0]
            assert want[i, j] == k[0]
            ties += k.size > 1
    assert ties > 500


def test_first_hops_disconnected_union():
    """Three components side by side: unreachable pairs and the
    diagonal are -1, every other entry a neighbour on a shortest path."""
    rng = np.random.default_rng(11)
    parts = [_random_adj(n, rng, density=0.3) for n in (17, 40, 9)]
    n = sum(p.shape[0] for p in parts)
    adj = np.full((n, n), np.inf, np.float32)
    off = 0
    for p in parts:
        adj[off:off + p.shape[0], off:off + p.shape[0]] = p
        off += p.shape[0]
    dist = _closed(adj)
    want = _first_hops_equal(adj, dist)
    assert (want[np.isinf(dist)] == -1).all() and np.isinf(dist).any()
    assert (np.diag(want) == -1).all()
    _first_hops_equal(adj, dist, rows=np.arange(10, 30),
                      cols=np.arange(0, n, 3))


def test_first_hops_one_row_a_chunk(monkeypatch):
    """The chunking changes nothing: a cube cap of one element runs one
    row a chunk and gives the same table."""
    rng = np.random.default_rng(3)
    adj = _random_adj(45, rng, density=0.2)
    dist = _closed(adj)
    want = jhier.first_hops(adj, dist)
    monkeypatch.setattr(hierarchy, "FIRST_HOPS_CUBE", 1)
    calls = []
    amin = torch.Tensor.amin

    def counted(self, *a, **k):
        calls.append(self.shape[0])
        return amin(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "amin", counted)
    got = hierarchy.first_hops(torch.from_numpy(adj), torch.from_numpy(dist))
    assert calls == [1] * 45
    np.testing.assert_array_equal(got.numpy(), want)
    rows = np.array([44, 0, 7])
    got = hierarchy.first_hops(torch.from_numpy(adj), torch.from_numpy(dist),
                               rows=rows, cols=np.array([3, 1]))
    np.testing.assert_array_equal(
        got.numpy(), jhier.first_hops(adj, dist, rows=rows,
                                      cols=np.array([3, 1])))
