"""The port's witness serve mode and path unwinding against the reference.

On ``road_like(900)`` (dense overlay) and ``road_like(1400, seed=23)``
at 3 levels, the port's ``QueryPlanner.query_witness`` and
``serve_step_w`` return distances and witnesses array-equal to the
reference package's (its default CPU dispatch), and every served
witness unwinds (``repro_torch.core.paths``) to an edge-valid path whose
weight is ``==`` the served distance and the Dijkstra oracle, for at
least 100 pairs per planner bucket.  A ``tree_with_blobs`` graph covers
the same-DRA witnesses ``WIT_PIECE`` and ``WIT_VIA_AGENT``.  Integer
weights keep every float32 sum exact, so every comparison is exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core.dist_engine import QueryPlanner as JQueryPlanner
from repro.core.graph import road_like as jroad_like
from repro.core.supergraph import build_index as jbuild_index
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like, tree_with_blobs
from repro_torch.core.paths import PathUnwinder, path_weight, unwind_path
from repro_torch.core.supergraph import build_index

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

N_PER_BUCKET = 100
BUCKETS = ("same_dra", "same_frag", "cross_frag")
# (nodes, seed, levels): dense, and a graph that keeps 3 real levels
GRAPHS = [(900, 0, 1), (1400, 23, 3)]
_BUILT: dict = {}


def _built(n, seed, lv):
    """(port graph, port index, port plan, reference index), built once
    per test process."""
    key = (n, seed, lv)
    if key not in _BUILT:
        jdix = jde.build_device_index(jbuild_index(jroad_like(n, seed=seed)),
                                      hierarchy_levels=lv)
        g = road_like(n, seed=seed)
        dix, plan = tde.build_device_index_with_plan(
            build_index(g), device="cpu", hierarchy_levels=lv)
        assert dix.hierarchy_levels == lv
        _BUILT[key] = (g, dix, plan, jdix)
    return _BUILT[key]


def _bucket_pairs(dix, rng, n_per_bucket, buckets=BUCKETS):
    """>= n_per_bucket random pairs for each planner case (the sampler
    of tests/test_paths.py: uniform pairs alone starve the same-DRA and
    same-fragment buckets on road graphs)."""
    agent_of = dix.agent_of.numpy()
    fa = dix.frag_of.numpy()[agent_of]
    n = agent_of.size
    out = {}
    if "same_dra" in buckets:
        agents, counts = np.unique(agent_of, return_counts=True)
        multi = agents[counts >= 2]
        assert multi.size, "graph has no multi-member DRA"
        pairs = []
        while len(pairs) < n_per_bucket:
            a = int(multi[rng.integers(0, multi.size)])
            s, t = rng.choice(np.nonzero(agent_of == a)[0], 2)
            pairs.append((int(s), int(t)))
        out["same_dra"] = np.asarray(pairs)
    if "same_frag" in buckets:
        frags = np.unique(fa[fa >= 0])
        pairs = []
        for _ in range(200 * n_per_bucket):
            if len(pairs) >= n_per_bucket:
                break
            f = int(frags[rng.integers(0, frags.size)])
            s, t = rng.choice(np.nonzero(fa == f)[0], 2)
            if agent_of[s] != agent_of[t]:
                pairs.append((int(s), int(t)))
        assert len(pairs) >= n_per_bucket, "could not build same_frag pairs"
        out["same_frag"] = np.asarray(pairs)
    if "cross_frag" in buckets:
        pairs = []
        for _ in range(500 * n_per_bucket):
            if len(pairs) >= n_per_bucket:
                break
            s, t = rng.integers(0, n, 2)
            if (agent_of[s] != agent_of[t] and fa[s] != fa[t]
                    and fa[s] >= 0 and fa[t] >= 0):
                pairs.append((int(s), int(t)))
        assert len(pairs) >= n_per_bucket, "could not build cross_frag pairs"
        out["cross_frag"] = np.asarray(pairs)
    return out


def _all_pairs(dix, seed=1):
    pairs = np.concatenate(list(_bucket_pairs(
        dix, np.random.default_rng(seed), N_PER_BUCKET).values()))
    return pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)


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


@pytest.mark.parametrize("n,seed,lv", GRAPHS)
def test_witness_serving_matches_reference(n, seed, lv):
    """query_witness and serve_step_w: distances and witnesses
    array-equal to the reference's, distances == serve_step."""
    _g, dix, _plan, jdix = _built(n, seed, lv)
    s, t = _all_pairs(dix)
    planner = QueryPlanner(dix)
    dist, wit = planner.query_witness(s, t)
    assert dist.dtype == np.float32 and wit.dtype == np.int32
    assert all(planner.last_counts[c] for c in BUCKETS), planner.last_counts
    jdist, jwit = JQueryPlanner(jdix, paths=True).query_witness(
        s.astype(np.int32), t.astype(np.int32))
    np.testing.assert_array_equal(dist, np.asarray(jdist))
    np.testing.assert_array_equal(wit, np.asarray(jwit))
    np.testing.assert_array_equal(dist, planner.query(s, t))
    js, jt = jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32)
    got_d, got_w = tde.serve_step_w(dix, torch.from_numpy(s),
                                    torch.from_numpy(t))
    want_d, want_w = jde.serve_step_w(jdix, js, jt)
    assert got_w.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(
        got_d.numpy(), tde.serve_step(dix, torch.from_numpy(s),
                                      torch.from_numpy(t)).numpy())


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("n,seed,lv", GRAPHS)
def test_paths_exact_per_bucket(n, seed, lv, bucket):
    """>= 100 pairs of the bucket: the planner's and the monolithic
    witnesses both unwind to edge-valid paths with
    path_weight == served distance == Dijkstra."""
    g, dix, plan, _jdix = _built(n, seed, lv)
    pairs = _bucket_pairs(dix, np.random.default_rng(seed + 2),
                          N_PER_BUCKET, buckets=(bucket,))[bucket]
    s, t = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    uw = PathUnwinder(dix, plan)
    dist, wit = QueryPlanner(dix).query_witness(s, t)
    _assert_exact_paths(g, uw, s, t, dist, wit, bucket)
    mono_d, mono_w = tde.serve_step_w(dix, torch.from_numpy(s),
                                      torch.from_numpy(t))
    _assert_exact_paths(g, uw, s, t, mono_d.numpy(), mono_w.numpy(),
                        f"{bucket} serve_step_w")


def test_cross_res_bucket_witnesses_unwind():
    """On the 3-level graph some cross pairs fall in the resident bucket;
    witness mode serves them through the full-lift program, exactly."""
    g, dix, plan, _jdix = _built(1400, 23, 3)
    s, t = _all_pairs(dix, seed=4)
    planner = QueryPlanner(dix)
    idx = planner.plan(s, t)["cross_res"]
    assert idx.size >= 10
    dist, wit = planner.query_witness(s[idx], t[idx])
    _assert_exact_paths(g, PathUnwinder(dix, plan), s[idx], t[idx], dist,
                        wit, "cross_res")


def test_blob_graph_piece_witnesses():
    """A piece-heavy graph (``tree_with_blobs``): same-DRA witnesses
    take both WIT_PIECE and WIT_VIA_AGENT, and every one unwinds
    exactly."""
    g = tree_with_blobs(25, 6, seed=9)
    dix, plan = tde.build_device_index_with_plan(build_index(g),
                                                 device="cpu")
    pairs = _bucket_pairs(dix, np.random.default_rng(5), 200,
                          buckets=("same_dra",))["same_dra"]
    s, t = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    dist, wit = QueryPlanner(dix).query_witness(s, t)
    real = s != t
    assert (wit[real] == tde.WIT_PIECE).any()
    assert (wit[real] == tde.WIT_VIA_AGENT).any()
    _assert_exact_paths(g, PathUnwinder(dix, plan), s, t, dist, wit,
                        "blob same_dra")


def test_unwind_trivial_and_unreachable():
    g, dix, plan, _jdix = _built(900, 0, 1)
    uw = PathUnwinder(dix, plan)
    assert uw.unwind(5, 5, 0.0, -1) == [5]
    assert uw.unwind(0, 1, float("inf"), -1) is None
    assert unwind_path(dix, plan, 0, 1, float("inf"), tde.WIT_NONE) is None
    dist, wit = QueryPlanner(dix).query_witness([7, 7], [7, 123])
    assert dist[0] == 0.0 and wit[0] == tde.WIT_NONE
    paths = uw.unwind_many([7, 7], [7, 123], dist, wit)
    assert paths[0] == [7]
    assert path_weight(g, paths[1]) == float(dist[1]) \
        == dijkstra.pair(g, 7, 123)
    with pytest.raises(ValueError, match="not an edge"):
        path_weight(g, [paths[1][0], paths[1][-1]])


@pytest.mark.parametrize("layout", ("gather", "scatter"))
def test_agent_outside_every_fragment_serves_wit_none(layout):
    """An agent with frag_of == -1: the port clamps before its gathers
    and agrees with the reference (+inf, WIT_NONE)."""
    g, dix, plan, jdix = _built(900, 0, 1)
    s = np.array([3, 10, 400], np.int64)
    t = np.array([700, 600, 20], np.int64)
    u = int(plan.agent_of[s[0]])
    frag_of = dix.frag_of.clone()
    frag_of[u] = -1
    jfrag = np.asarray(jdix.frag_of).copy()
    jfrag[u] = -1
    pj = dataclasses.replace(jdix, frag_of=jnp.asarray(jfrag))
    for with_local in (True, False):
        got_d, got_w = tde.serve_cross_w(
            dataclasses.replace(dix, frag_of=frag_of), torch.from_numpy(s),
            torch.from_numpy(t), with_local=with_local, layout=layout)
        want_d, want_w = jde.serve_cross_w(
            pj, jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32),
            with_local=with_local)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        assert np.isinf(got_d[0].item())
        assert got_w[0].item() == tde.WIT_NONE


@pytest.mark.parametrize("width", [24, 10_000])
def test_chunk_width_leaves_witnesses_unchanged(monkeypatch, width):
    """The card steps the witness loops by wider chunks than the CPU's
    8 (``_chunk``); the smallest-index-wins rule makes every width give
    the same witnesses, dense and hierarchical, in both layouts."""
    cases = [(_built(n, seed, lv), _all_pairs(_built(n, seed, lv)[1],
                                              seed=6))
             for n, seed, lv in GRAPHS]
    want = [[QueryPlanner(dix, layout=layout).query_witness(s, t)
             for layout in ("gather", "scatter")]
            for (_g, dix, _p, _j), (s, t) in cases]
    monkeypatch.setattr(tde, "_chunk",
                        lambda row, _w: min(width, row.shape[1]))
    for ((_g, dix, _p, _j), (s, t)), per_layout in zip(cases, want):
        for layout, (wd, ww) in zip(("gather", "scatter"), per_layout):
            got_d, got_w = QueryPlanner(dix, layout=layout).query_witness(
                s, t)
            np.testing.assert_array_equal(got_d, wd)
            np.testing.assert_array_equal(got_w, ww)
