"""The port's host oracle and baselines against the reference package.

Mirrors ``tests/test_engine.py``'s exactness tests on the port: the
port's ``DislandEngine`` equals Dijkstra, and its ``query``,
``query_many`` and ``query_path`` equal the reference's; the four
baselines (CH, Arc-Flags, Agent+CH, Agent+bidirectional Dijkstra)
equal the reference's baselines and Dijkstra, with the same shortcut,
settled-node and flag-bit counts; the planner and ``serve_step`` equal
the port's host engine with every bucket exercised; and the port's test
generators (``random_graph``, ``tree_with_blobs``) are array-equal to
the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import agent_wrap as jagent_wrap
from repro.core import arcflags as jarcflags
from repro.core import ch as jch
from repro.core import graph as jgraph
from repro.core.engine import DislandEngine as JDislandEngine
from repro.core.supergraph import build_index as jbuild_index
from repro_torch.core import dijkstra
from repro_torch.core.agent_wrap import AgentAccelerated, PlainDijkstra
from repro_torch.core.arcflags import ArcFlags
from repro_torch.core.ch import CH
from repro_torch.core.device_engine import build_device_index, serve_step
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.engine import DislandEngine
from repro_torch.core.graph import random_graph, road_like, tree_with_blobs
from repro_torch.core.supergraph import build_index

torch.set_num_threads(1)

GRAPH_FIELDS = ("edge_u", "edge_v", "edge_w", "indptr", "indices",
                "weights")


def _random_pairs(g, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, g.n, size=(n, 2))


def _assert_exact(got, want, tol=1e-6):
    if np.isinf(want):
        assert np.isinf(got)
    else:
        assert abs(got - want) < tol, (got, want)


@pytest.fixture(scope="module")
def small_world():
    g = road_like(1600, seed=21)
    return g, build_index(g), JDislandEngine(
        jbuild_index(jgraph.road_like(1600, seed=21)))


@pytest.mark.parametrize("name,port,ref", [
    ("random_graph", lambda: random_graph(300, 700, seed=4),
     lambda: jgraph.random_graph(300, 700, seed=4)),
    ("random_graph_w", lambda: random_graph(50, 20, seed=9, max_w=7),
     lambda: jgraph.random_graph(50, 20, seed=9, max_w=7)),
    ("tree_with_blobs", lambda: tree_with_blobs(12, 6, seed=2),
     lambda: jgraph.tree_with_blobs(12, 6, seed=2)),
    ("tree_with_blobs_small", lambda: tree_with_blobs(10, 5, seed=6),
     lambda: jgraph.tree_with_blobs(10, 5, seed=6)),
])
def test_generators_match_reference(name, port, ref):
    g, jg = port(), ref()
    assert g.n == jg.n, name
    for f in GRAPH_FIELDS:
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype, (name, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


def test_disland_engine_exact(small_world):
    g, ix, jeng = small_world
    eng = DislandEngine(ix)
    for s, t in _random_pairs(g, 60, seed=1):
        want = dijkstra.pair(g, int(s), int(t))
        got = eng.query(int(s), int(t))
        _assert_exact(got, want)
        assert got == jeng.query(int(s), int(t)), (s, t)


def test_query_many_and_paths_match_reference(small_world):
    g, ix, jeng = small_world
    eng = DislandEngine(ix)
    pairs = _random_pairs(g, 40, seed=5)
    agent = ix.dras.agent_of
    inner = np.nonzero(agent != np.arange(g.n))[0]
    # same-DRA pairs and node -> own agent, beside the random ones
    extra = [(int(inner[0]), int(agent[inner[0]])),
             (int(agent[inner[1]]), int(inner[1]))]
    for a in ix.dras.agents[:4]:
        if len(a.pieces) and a.pieces[0].size >= 2:
            extra.append((int(a.pieces[0][0]), int(a.pieces[0][-1])))
    pairs = np.concatenate([pairs, np.asarray(extra), [[7, 7]]])
    got = eng.query_many(pairs)
    np.testing.assert_array_equal(got, jeng.query_many(pairs))
    for (s, t), d in zip(pairs, got):
        dist, path = eng.query_path(int(s), int(t))
        jdist, jpath = jeng.query_path(int(s), int(t))
        assert dist == jdist == d, (s, t)
        assert path == jpath, (s, t)


BASELINES = {
    "ch": (lambda g: CH(g), lambda g: jch.CH(g)),
    "arcflags": (lambda g: ArcFlags(g, n_regions=8),
                 lambda g: jarcflags.ArcFlags(g, n_regions=8)),
    "agent_ch": (lambda g: AgentAccelerated(g, lambda s: CH(s)),
                 lambda g: jagent_wrap.AgentAccelerated(
                     g, lambda s: jch.CH(s))),
    "agent_bidij": (lambda g: AgentAccelerated(
        g, lambda s: PlainDijkstra(s, bidirectional=True)),
        lambda g: jagent_wrap.AgentAccelerated(
            g, lambda s: jagent_wrap.PlainDijkstra(s, bidirectional=True))),
}


@pytest.mark.parametrize("name", list(BASELINES))
def test_baselines_exact(name):
    """Each baseline on the port == the reference's baseline == Dijkstra,
    and its counters (CH shortcuts and settled nodes, Arc-Flags bits)
    equal the reference's."""
    port, ref = BASELINES[name]
    g = road_like(900, seed=4)
    algo, jalgo = port(g), ref(jgraph.road_like(900, seed=4))
    for s, t in _random_pairs(g, 25, seed=3):
        want = dijkstra.pair(g, int(s), int(t))
        got = algo.query(int(s), int(t))
        _assert_exact(got, want)
        assert got == jalgo.query(int(s), int(t)), (name, s, t)
    ch = algo.inner if name == "agent_ch" else algo
    jch_ = jalgo.inner if name == "agent_ch" else jalgo
    if name in ("ch", "agent_ch"):
        assert ch.extra_edges() == jch_.extra_edges()
        np.testing.assert_array_equal(ch.order, jch_.order)
        for s, t in _random_pairs(ch.g, 5, seed=8):
            assert (ch.settled_per_query(int(s), int(t))
                    == jch_.settled_per_query(int(s), int(t)))
    if name == "arcflags":
        assert algo.extra_bits() == jalgo.extra_bits()
        np.testing.assert_array_equal(algo.flags, jalgo.flags)


# copied from tests/test_engine.py:80
def _pairs_covering_all_buckets(g, dix, n_random=60, seed=11):
    """Random pairs plus hand-picked ones so every planner bucket
    (same-DRA / same-fragment / cross-fragment, plus cross_res when
    the index carries pre-lifted resident rows) is non-empty."""
    rng = np.random.default_rng(seed)
    pairs = list(map(tuple, rng.integers(0, g.n, size=(n_random, 2))))
    agent_of = dix.agent_of.numpy()
    frag_of = dix.frag_of.numpy()
    agents, counts = np.unique(agent_of, return_counts=True)
    a = agents[np.argmax(counts)]
    members = np.nonzero(agent_of == a)[0]
    assert members.size >= 2, "graph has no non-trivial DRA"
    pairs.append((int(members[0]), int(members[-1])))
    fa = frag_of[agent_of]
    for f in np.unique(fa[fa >= 0]):
        nodes = np.nonzero(fa == f)[0]
        us = agent_of[nodes]
        if np.unique(us).size >= 2:
            i = int(nodes[0])
            j = int(nodes[np.argmax(us != us[0])])
            pairs.append((i, j))
            break
    valid = np.nonzero(fa >= 0)[0]
    f0 = fa[valid[0]]
    other = valid[np.argmax(fa[valid] != f0)]
    pairs.append((int(valid[0]), int(other)))
    rf, tg = dix.host_res_frag, dix.host_topgrp_frag
    if rf is not None and tg is not None:
        hot = (rf[fa[valid]] >= 0)
        hv = valid[hot]
        if hv.size:
            t0 = tg[fa[hv[0]]]
            j = np.argmax(tg[fa[hv]] != t0)
            if tg[fa[hv[j]]] != t0:
                pairs.append((int(hv[0]), int(hv[j])))
    return np.asarray(pairs)


@pytest.mark.parametrize("graph_factory,seed", [
    (lambda: road_like(1400, seed=23), 23),
    (lambda: tree_with_blobs(60, 7, seed=5), 5),
])
def test_planner_matches_host_engine(graph_factory, seed):
    """The planner and ``serve_step`` on the CPU == the port's
    ``DislandEngine``, with every bucket exercised."""
    g = graph_factory()
    ix = build_index(g)
    dix = build_device_index(ix, device="cpu")
    eng = DislandEngine(ix)
    pairs = _pairs_covering_all_buckets(g, dix, seed=seed)
    planner = QueryPlanner(dix)
    got = planner(pairs[:, 0], pairs[:, 1])
    assert all(n >= 1 for c, n in planner.last_counts.items()
               if c != "cross_res"), planner.last_counts
    if dix.res_rows.shape[0] > 1:
        assert planner.last_counts["cross_res"] >= 1, planner.last_counts
    got_mono = serve_step(dix, torch.from_numpy(pairs[:, 0]),
                          torch.from_numpy(pairs[:, 1])).numpy()
    want = eng.query_many(pairs).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mono, want)


def test_blob_graph_same_dra_cases():
    g = tree_with_blobs(10, 5, seed=6)
    ix = build_index(g)
    eng = DislandEngine(ix)
    jeng = JDislandEngine(jbuild_index(jgraph.tree_with_blobs(10, 5, seed=6)))
    dix = build_device_index(ix, device="cpu")
    pairs = _random_pairs(g, 80, seed=7)
    got = serve_step(dix, torch.from_numpy(pairs[:, 0]),
                     torch.from_numpy(pairs[:, 1])).numpy()
    for i, (a, b) in enumerate(pairs):
        want = dijkstra.pair(g, int(a), int(b))
        assert eng.query(int(a), int(b)) == want == jeng.query(int(a), int(b))
        assert got[i] == np.float32(want)
        dist, path = eng.query_path(int(a), int(b))
        assert (dist, path) == jeng.query_path(int(a), int(b))
