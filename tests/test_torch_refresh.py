"""The port's incremental refresh and epoch-swapped serving against the
reference package.

One scripted sequence of three update batches (mixed, decrease-only,
jam) runs through the reference ``EpochedEngine`` (its CPU dispatch) and
the port's (``device="cpu"``) at hierarchy levels 1, 2 and 3, with and
without 64 seeded hub nodes.  After every epoch the port's refreshed
index is array-equal to the reference's epoch and to the port's own
scratch rebuild (``build_device_index(reweight_index(ix, g))``) on every
``REFRESHED_FIELDS`` table and every host sidecar, the ``RefreshStats``
agree, and 64 planner answers are ``==`` the reference's and Dijkstra's.
The update generators, ``reweight_index``, ``classify_updates`` and
``l2_decrease_stage`` are held against the reference one by one; the
refresh's rollback, the immutability of the serving epoch, epoch-pinned
queries and paths, the staged ``RefreshPipeline`` and the
``--update-batches`` CLI are tested on the port alone.  Integer weights
keep every float32 sum exact, so every comparison is exact.

``tests/test_torch_refresh_card.py`` holds a refresh on the card to the
same refresh on the CPU.
"""
import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core import hierarchy as jhier
from repro.core.dist_engine import EpochedEngine as JEpochedEngine
from repro.core.graph import road_like as jroad_like
from repro.core.graph import traffic_updates as jtraffic_updates
from repro.core.graph import tree_with_blobs as jtree_with_blobs
from repro.core.supergraph import build_index as jbuild_index
from repro.core.supergraph import reweight_index as jreweight_index
from repro.launch.serve import REFRESHED_FIELDS as JREFRESHED_FIELDS
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra, hierarchy
from repro_torch.core.dist_engine import EpochedEngine
from repro_torch.core.graph import road_like, traffic_updates, tree_with_blobs
from repro_torch.core.paths import path_weight
from repro_torch.core.refresh_pipeline import (FRESH, RefreshPipeline,
                                               Staleness, UpdateQueue)
from repro_torch.core.supergraph import build_index, reweight_index
from repro_torch.launch import serve
from repro_torch.launch.serve import REFRESHED_FIELDS

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

#: (nodes, seed, hierarchy levels, with 64 hub nodes)
CONFIGS = {"lv1": (420, 13, 1, False), "lv1_hubs": (420, 13, 1, True),
           "lv2_hubs": (420, 41, 2, True), "lv3": (1400, 23, 3, False)}
#: (frac, seed, jam_frac): mixed, decrease-only, jam.  The decrease-only
#: batch takes the top closure's decrease path at levels 2 and 3
SEQUENCE = ((0.02, 10, 0.5), (0.002, 12, 0.0), (0.02, 12, 1.0))
STAT_FIELDS = ("n_dirty_frags", "n_dirty_pieces", "n_eb_slots", "n_inert",
               "decrease_only", "total_increase", "top_closure")
_RUNS: dict = {}


def _oracle(g, s, t):
    return np.array([dijkstra.pair(g, int(a), int(b)) for a, b in zip(s, t)],
                    np.float32)


def _run(name):
    """The scripted sequence through both engines, once per process:
    one record per epoch."""
    if name not in _RUNS:
        n, seed, lv, with_hubs = CONFIGS[name]
        g = road_like(n, seed=seed)
        hubs = (np.random.default_rng(seed + 1).choice(g.n, 64, replace=False)
                if with_hubs else None)
        eng = EpochedEngine(g, device="cpu", hierarchy_levels=lv,
                            hub_nodes=hubs)
        jeng = JEpochedEngine(jroad_like(n, seed=seed), hierarchy_levels=lv,
                              hub_nodes=hubs, warm_refresh=False)
        assert eng.dix.hierarchy_levels == lv
        rng = np.random.default_rng(seed)
        epochs = []
        for frac, sd, jam in SEQUENCE:
            u, v, w = traffic_updates(eng.g, frac, seed=sd, jam_frac=jam)
            stats = eng.apply_updates(u, v, w)
            jstats = jeng.apply_updates(u, v, w)
            scratch = tde.build_device_index(
                reweight_index(eng.ix, eng.g), device="cpu",
                hierarchy_levels=lv, hub_nodes=hubs)
            s, t = rng.integers(0, g.n, 64), rng.integers(0, g.n, 64)
            epochs.append({
                "dix": eng.dix, "jdix": jeng.dix, "scratch": scratch,
                "stats": stats, "jstats": jstats, "got": eng.query(s, t),
                "jgot": jeng.query(s, t), "want": _oracle(eng.g, s, t)})
        _RUNS[name] = epochs
    return _RUNS[name]


def test_refreshed_fields_list_matches_reference():
    assert REFRESHED_FIELDS == JREFRESHED_FIELDS


# -- 1. update generators ----------------------------------------------------

@pytest.mark.parametrize("jam_frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("localized", [True, False])
def test_traffic_updates_match_reference(localized, jam_frac):
    got = traffic_updates(road_like(420, seed=13), 0.05, seed=4,
                          localized=localized, jam_frac=jam_frac)
    want = jtraffic_updates(jroad_like(420, seed=13), 0.05, seed=4,
                            localized=localized, jam_frac=jam_frac)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_with_edge_weights_matches_reference():
    g, jg = road_like(420, seed=13), jroad_like(420, seed=13)
    u, v, w = traffic_updates(g, 0.1, seed=3, localized=False)
    g2, jg2 = g.with_edge_weights(u, v, w), jg.with_edge_weights(u, v, w)
    for name in ("indptr", "indices", "weights", "edge_u", "edge_v",
                 "edge_w"):
        np.testing.assert_array_equal(getattr(g2, name),
                                      getattr(jg2, name), err_msg=name)
    # the graph it came from is untouched
    np.testing.assert_array_equal(g.edge_w, jg.edge_w)


def test_with_edge_weights_rejects_unknown_edges_and_weights():
    g = road_like(300, seed=1)
    with pytest.raises(ValueError):
        g.with_edge_weights([0], [0], [5.0])
    a, b = int(g.edge_u[0]), int(g.edge_v[-1])
    assert g.edge_ids([a], [b])[0] < 0
    with pytest.raises(ValueError):
        g.with_edge_weights([a], [b], [5.0])
    with pytest.raises(ValueError):
        g.with_edge_weights(g.edge_u[:1], g.edge_v[:1], [-1.0])
    with pytest.raises(ValueError):
        g.with_edge_weights(g.edge_u[:1], g.edge_v[:1], [0.0])


# -- 2. reweight_index -------------------------------------------------------

def test_reweight_index_matches_reference():
    g = road_like(420, seed=13)
    u, v, w = traffic_updates(g, 0.08, seed=5, localized=False)
    ix = reweight_index(build_index(g), g.with_edge_weights(u, v, w))
    jix = jreweight_index(jbuild_index(jroad_like(420, seed=13)),
                          jroad_like(420, seed=13).with_edge_weights(u, v, w))
    np.testing.assert_array_equal(ix.dras.dist_to_agent,
                                  jix.dras.dist_to_agent)
    for a, b in zip(ix.dras.agents, jix.dras.agents):
        np.testing.assert_array_equal(a.dist_to_agent, b.dist_to_agent)
    assert len(ix.fragments) == len(jix.fragments)
    for f, jf in zip([ix.shrink] + [x.graph for x in ix.fragments],
                     [jix.shrink] + [x.graph for x in jix.fragments]):
        for name in ("indptr", "indices", "weights", "edge_u", "edge_v",
                     "edge_w"):
            np.testing.assert_array_equal(getattr(f, name), getattr(jf, name))
    with pytest.raises(ValueError):
        reweight_index(ix, road_like(300, seed=1))


# -- 3. classify_updates -----------------------------------------------------

def _blob_graphs():
    return tree_with_blobs(25, 6, seed=9), jtree_with_blobs(25, 6, seed=9)


@pytest.mark.parametrize("graph", ["road", "blobs"])
def test_classify_updates_matches_reference(graph):
    if graph == "road":
        g, jg = road_like(420, seed=13), jroad_like(420, seed=13)
    else:
        g, jg = _blob_graphs()
    plan = tde.make_build_plan(build_index(g))
    jplan = jde.make_build_plan(jbuild_index(jg))
    kinds = set()
    for sd in range(3):
        u, v, w = traffic_updates(g, 0.06, seed=50 + sd, localized=bool(sd))
        got, want = tde.classify_updates(plan, u, v, w), \
            jde.classify_updates(jplan, u, v, w)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        kinds |= {k for k, x in (("frag", got.dirty_frags),
                                 ("eb", got.eb_slots),
                                 ("piece", got.dirty_gids)) if x.size}
    # the road graph's batches reach fragments and E_B slots, the blob
    # graph's pieces
    assert kinds >= ({"frag", "eb"} if graph == "road" else {"piece"})


# -- 4. refresh == reference == rebuild, every epoch -------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_refresh_matches_reference_tables(name):
    for e, rec in enumerate(_run(name)):
        eq = tde.index_fields_equal(rec["dix"], rec["jdix"], REFRESHED_FIELDS)
        assert all(eq.values()), (e, [k for k, ok in eq.items() if not ok])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_refresh_matches_scratch_rebuild(name):
    for e, rec in enumerate(_run(name)):
        eq = tde.index_fields_equal(rec["dix"], rec["scratch"],
                                    REFRESHED_FIELDS)
        assert all(eq.values()), (e, [k for k, ok in eq.items() if not ok])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_refresh_sidecars_match_reference_and_rebuild(name):
    for e, rec in enumerate(_run(name)):
        for other in ("jdix", "scratch"):
            eq = tde.sidecars_equal(rec["dix"], rec[other])
            assert all(eq.values()), (e, other, eq)
        dix = rec["dix"]
        assert dix.host_ov_slot is not None
        if name.endswith("hubs"):
            assert dix.host_hub_agent is not None
        if dix.hierarchy_levels > 1:
            assert len(dix.host_l2_slot) == dix.hierarchy_levels - 1
            assert dix.host_topgrp_frag is not None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_refresh_stats_match_reference(name):
    closures = []
    for e, rec in enumerate(_run(name)):
        st, jst = rec["stats"], rec["jstats"]
        for f in STAT_FIELDS:
            assert getattr(st, f) == getattr(jst, f), (e, f)
        assert set(st.as_record()["stage_timings"]) == {
            "classify", "frag_fw", "super_fw", "hub", "pieces"}
        closures.append(st.top_closure)
    assert [r["stats"].decrease_only for r in _run(name)] == [False, True,
                                                               False]
    if CONFIGS[name][2] >= 2:
        assert "decrease" in closures and "dense" not in closures, closures


@pytest.mark.parametrize("name", list(CONFIGS))
def test_refresh_answers_exact(name):
    for e, rec in enumerate(_run(name)):
        np.testing.assert_array_equal(rec["got"], rec["jgot"],
                                      err_msg=f"epoch {e + 1}")
        np.testing.assert_array_equal(rec["got"], rec["want"],
                                      err_msg=f"epoch {e + 1}")


def test_hub_labels_carry_when_clean_and_rederive_when_dirty():
    """A batch that touches no labeled fragment and no overlay weight
    carries the label rows by reference; one that moves the overlay
    re-derives them (still equal to scratch, test above)."""
    g = road_like(420, seed=13)
    eng = EpochedEngine(g, device="cpu", hierarchy_levels=1,
                        hub_nodes=np.arange(0, g.n, 97))
    plan = eng.plan
    hub_frags = np.unique(plan.frag_of[plan.agent_of[plan.hub_nodes]])
    gid_e = np.maximum(plan.piece_gid[g.edge_u], plan.piece_gid[g.edge_v])
    clean = np.nonzero(gid_e >= 0)[0][:3]          # piece edges only
    assert clean.size
    old = eng.dix
    eng.apply_updates(g.edge_u[clean], g.edge_v[clean],
                      g.edge_w[clean] + 1)
    assert eng.dix.hub_rows is old.hub_rows
    fa = plan.frag_of
    inner = np.nonzero((fa[g.edge_u] >= 0) & (fa[g.edge_u] == fa[g.edge_v])
                       & np.isin(fa[g.edge_u], hub_frags))[0][:4]
    before = eng.dix
    stats = eng.apply_updates(g.edge_u[inner], g.edge_v[inner],
                              eng.g.edge_w[inner] * 7)
    assert stats.n_dirty_frags > 0
    assert eng.dix.hub_rows is not before.hub_rows


# -- 5. l2_decrease_stage ----------------------------------------------------

def _decreased_top(plan, jplan, slots):
    """Lower the listed top slots' weights in both plans (the same new
    values), returning the previous weights to restore."""
    h, jh = plan.hier[-1], jplan.hier[-1]
    old = h.l2_w.copy()
    new = np.maximum(1.0, np.floor(h.l2_w[slots] / 3)).astype(np.float32)
    h.l2_w[slots] = new
    jh.l2_w[slots] = new
    return old


def test_l2_decrease_stage_matches_reference():
    g = road_like(420, seed=41)
    dix, plan = tde.build_device_index_with_plan(
        build_index(g), device="cpu", hierarchy_levels=2)
    jdix, jplan = jde.build_device_index_with_plan(
        jbuild_index(jroad_like(420, seed=41)), hierarchy_levels=2)
    h, jh = plan.hier[-1], jplan.hier[-1]
    fin = np.nonzero(np.isfinite(h.l2_w) & (h.l2_w > 1))[0]
    rng = np.random.default_rng(0)
    for n_slots in (1, 3):
        slots = np.sort(rng.choice(fin, n_slots, replace=False))
        old = _decreased_top(plan, jplan, slots)
        got = hierarchy.l2_decrease_stage(h, dix.d2, dix.d2_next, slots)
        want = jhier.l2_decrease_stage(jh, jdix.d2, jdix.d2_next, slots)
        assert got is not None and want is not None
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # and it is the full closure of the lowered weights
        full = hierarchy.l2_stage(h, torch.device("cpu"))
        for a, b in zip(got, full):
            assert torch.equal(a, b)
        h.l2_w[:] = old
        jh.l2_w[:] = old
    # the bail-out: more touched endpoints than max(16, S2 / 8)
    limit = max(16, h.S2 // hierarchy.DECREASE_MAX_FRAC)
    slots, ends = [], set()
    for sl in fin:
        slots.append(sl)
        ends |= {int(h.l2_src[sl]), int(h.l2_dst[sl])}
        if len(ends) > limit:
            break
    assert len(ends) > limit
    slots = np.asarray(slots)
    assert hierarchy.l2_decrease_stage(h, dix.d2, dix.d2_next, slots) is None
    assert jhier.l2_decrease_stage(jh, jdix.d2, jdix.d2_next, slots) is None


# -- 6. rollback and immutability -------------------------------------------

def _tensors(dix) -> dict:
    out = {}
    for f in dataclasses.fields(dix):
        x = getattr(dix, f.name)
        if isinstance(x, torch.Tensor):
            out[f.name] = x
        elif isinstance(x, tuple):
            out.update({f"{f.name}[{i}]": t for i, t in enumerate(x)})
    return out


def test_failed_refresh_rolls_back_and_serving_epoch_is_never_written():
    g = road_like(420, seed=41)
    eng = EpochedEngine(g, device="cpu", hierarchy_levels=2)
    plan = eng.plan
    u, v, w = traffic_updates(g, 0.05, seed=2, jam_frac=1.0)
    assert ((plan.piece_gid[u] >= 0) | (plan.piece_gid[v] >= 0)).any()
    caches = (plan.frag_adj.copy(), plan.sup_w.copy(),
              [h.sf_adj.copy() for h in plan.hier],
              [h.l2_w.copy() for h in plan.hier])

    def assert_caches(same: bool):
        now = (plan.frag_adj, plan.sup_w, [h.sf_adj for h in plan.hier],
               [h.l2_w for h in plan.hier])
        eq = [np.array_equal(now[0], caches[0]),
              np.array_equal(now[1], caches[1])] + [
            np.array_equal(a, b) for i in (2, 3)
            for a, b in zip(now[i], caches[i])]
        assert all(eq) if same else not all(eq[2:]), eq

    with pytest.raises(AttributeError):         # the piece stage blows up
        tde.refresh_index(eng.dix, plan, object(), u, v, w)
    assert_caches(True)
    old = eng.snapshot()[1]
    kept = {k: t.clone() for k, t in _tensors(old).items()}
    kept_sidecars = copy.deepcopy({k: getattr(old, k) for k in tde.SIDECARS})
    stats = eng.apply_updates(u, v, w)
    # the same batch did reach the per-level caches the rollback restored
    assert stats.top_closure != "carry"
    assert_caches(False)
    for k, t in _tensors(old).items():
        assert torch.equal(t, kept[k]), k
    assert all(tde.sidecars_equal(
        old, types.SimpleNamespace(**kept_sidecars)).values())
    assert eng.dix is not old and eng.snapshot()[1] is eng.dix
    # untouched tables are shared by reference across epochs
    for f in ("agent_of", "frag_of", "pos_in_frag", "piece_gid", "bnd_super"):
        assert getattr(eng.dix, f) is getattr(old, f)
    # and the next refresh still lands on the scratch rebuild
    eng.apply_updates(*traffic_updates(eng.g, 0.03, seed=3))
    sdix = tde.build_device_index(reweight_index(eng.ix, eng.g),
                                  device="cpu", hierarchy_levels=2)
    eq = tde.index_fields_equal(eng.dix, sdix, REFRESHED_FIELDS)
    assert all(eq.values()) and all(tde.sidecars_equal(eng.dix,
                                                       sdix).values())


def test_refresh_index_composes_without_engine():
    g = road_like(350, seed=31)
    ix = build_index(g)
    dix, plan = tde.build_device_index_with_plan(ix, device="cpu")
    u, v, w = traffic_updates(g, 0.05, seed=8)
    g2 = g.with_edge_weights(u, v, w)
    dix2, stats = tde.refresh_index(dix, plan, g2, u, v, w)
    sdix = tde.build_device_index(reweight_index(ix, g2), device="cpu")
    assert all(tde.index_fields_equal(dix2, sdix, REFRESHED_FIELDS).values())
    assert all(v >= 0 for v in stats.timings.values())
    assert sum(stats.as_record()["stage_timings"].values()) \
        <= stats.timings["total"] + 1e-3


# -- 7. epoch pinning: queries and paths -------------------------------------

def test_pinned_queries_answer_their_epoch():
    g = road_like(420, seed=41)
    eng = EpochedEngine(g, device="cpu", hierarchy_levels=2)
    rng = np.random.default_rng(6)
    s, t = rng.integers(0, g.n, 128), rng.integers(0, g.n, 128)
    old, g_old = eng.dix, eng.g
    before = eng.planner.query(s, t)
    wbefore = eng.planner.query_witness(s, t)
    eng.apply_updates(*traffic_updates(g, 0.3, seed=1, jam_frac=1.0))
    after = eng.planner.query(s, t)
    pinned = eng.planner.query(s, t, dix=old)
    assert (after != before).any()
    np.testing.assert_array_equal(pinned, before)
    np.testing.assert_array_equal(pinned, _oracle(g_old, s, t))
    np.testing.assert_array_equal(after, _oracle(eng.g, s, t))
    for a, b in zip(eng.planner.query_witness(s, t, dix=old), wbefore):
        np.testing.assert_array_equal(a, b)


def _bucket_pairs(dix, rng, n, buckets=("same_dra", "same_frag",
                                         "cross_frag")):
    """n random pairs in each of the listed planner buckets (same-DRA,
    same-fragment, cross-fragment)."""
    agent_of = dix.agent_of.numpy()
    fa = dix.frag_of.numpy()[agent_of]
    agents, counts = np.unique(agent_of, return_counts=True)
    multi = agents[counts >= 2]
    frags = np.unique(fa[fa >= 0])

    def draw(bucket):
        if bucket == "same_dra":
            a = int(multi[rng.integers(0, multi.size)])
            return rng.choice(np.nonzero(agent_of == a)[0], 2)
        if bucket == "same_frag":
            f = int(frags[rng.integers(0, frags.size)])
            x, y = rng.choice(np.nonzero(fa == f)[0], 2)
            return (x, y) if agent_of[x] != agent_of[y] else None
        x, y = rng.integers(0, agent_of.size, 2)
        return (x, y) if fa[x] >= 0 and fa[y] >= 0 and fa[x] != fa[y] \
            else None

    out = {}
    for bucket in buckets:
        pairs = [p for p in (draw(bucket) for _ in range(500 * n))
                 if p is not None][:n]
        assert len(pairs) == n, f"could not draw {bucket} pairs"
        out[bucket] = np.asarray(pairs, np.int64)
    return out


def _assert_paths_exact(eng, pairs, label):
    dist, paths = eng.query_path(pairs[:, 0], pairs[:, 1])
    for (a, b), d, p in zip(pairs, dist, paths):
        want = dijkstra.pair(eng.g, int(a), int(b))
        if np.isinf(want):
            assert p is None, (label, a, b)
            continue
        assert p[0] == a and p[-1] == b, (label, a, b)
        assert path_weight(eng.g, p) == float(d) == want, \
            (label, eng.epoch, int(a), int(b))


@pytest.mark.parametrize("lv", [1, 3])
def test_paths_exact_on_refreshed_epochs(lv):
    n, seed = (900, 0) if lv == 1 else (1400, 23)
    eng = EpochedEngine(road_like(n, seed=seed), device="cpu", paths=True,
                        hierarchy_levels=lv)
    buckets = _bucket_pairs(eng.dix, np.random.default_rng(1), 40)
    for r in range(2):
        eng.apply_updates(*traffic_updates(eng.g, 0.04, seed=10 + r,
                                           localized=bool(r % 2)))
        for bucket, pairs in buckets.items():
            _assert_paths_exact(eng, pairs, bucket)
    assert eng.epoch == 2


def test_paths_blob_graph_pieces_refreshed():
    g, _jg = _blob_graphs()
    eng = EpochedEngine(g, device="cpu", paths=True)
    pairs = _bucket_pairs(eng.dix, np.random.default_rng(5), 60,
                          buckets=("same_dra",))["same_dra"]
    stats = eng.apply_updates(*traffic_updates(eng.g, 0.06, seed=77,
                                               localized=False))
    assert stats.n_dirty_pieces > 0 and stats.n_inert == 0
    _assert_paths_exact(eng, pairs, "same_dra")


def test_unwinder_snapshot_outlives_its_epoch():
    g = road_like(500, seed=6)
    eng = EpochedEngine(g, device="cpu", paths=True)
    s, t = np.arange(0, 40), np.arange(40, 80)
    dist0, wit0 = eng.planner.query_witness(s, t)
    uw0, g0 = eng.unwinder(), eng.g
    assert eng.unwinder() is uw0                 # cached by index identity
    eng.apply_updates(*traffic_updates(g, 0.05, seed=8))
    assert eng.unwinder() is not uw0
    for i in range(len(s)):
        if np.isfinite(dist0[i]):
            p = uw0.unwind(int(s[i]), int(t[i]), dist0[i], int(wit0[i]))
            assert path_weight(g0, p) == float(dist0[i])
    dist, paths = eng.query_path([7, 7], [7, 123])
    assert paths[0] == [7] and dist[0] == 0.0


# -- 8. refresh_pipeline -----------------------------------------------------

def test_update_queue_coalesces_last_write_wins():
    q = UpdateQueue()
    s1 = q.submit([1, 2], [2, 3], [5.0, 6.0])
    s2 = q.submit([2], [1], [9.0])      # same undirected edge, flipped
    assert (s1, s2) == (1, 2)
    assert len(q) == 2
    u, v, w, sub = q.take()
    assert sub == 2 and len(q) == 0
    pool = {(int(a), int(b)): float(x) for a, b, x in zip(u, v, w)}
    assert pool == {(1, 2): 9.0, (2, 3): 6.0}
    u, v, w, sub = q.take()
    assert u.size == 0 and v.size == 0 and w.size == 0 and sub == 2


def test_staleness_semantics():
    assert FRESH.complete and FRESH.lag_batches == 0
    s = Staleness(watermark=2, submitted=5, pending_updates=7,
                  pending_groups=(0, 3))
    assert not s.complete and s.lag_batches == 3
    rec = s.as_record()
    assert rec["pending_groups"] == 2 and rec["complete"] is False
    assert rec["lag_batches"] == 3
    assert Staleness(watermark=5, submitted=5).complete


@pytest.fixture(scope="module")
def pipe_engine():
    return EpochedEngine(road_like(380, seed=21), device="cpu")


def _coalesced(u, v, w):
    pool = {}
    for a, b, x in zip(u, v, w):
        pool[(min(int(a), int(b)), max(int(a), int(b)))] = float(x)
    keys = np.asarray(list(pool), np.int64).reshape(-1, 2)
    return keys[:, 0], keys[:, 1], np.asarray(list(pool.values()))


def test_plan_orders_by_pending_dirt_without_traffic(pipe_engine):
    u, v, w = traffic_updates(pipe_engine.g, frac=0.2, seed=5)
    pipe = RefreshPipeline(pipe_engine, max_items=4)
    pipe.submit(u, v, w)
    n = pipe.plan()
    assert n == pipe.pending_items() <= 4
    cu, cv, _cw = _coalesced(u, v, w)
    groups, counts = np.unique(pipe._owner_group(cu, cv), return_counts=True)
    order = np.lexsort((groups, -counts.astype(float)))
    heads = [it[0] for it in pipe._items]
    for i, gs in enumerate(heads[:-1]):
        assert gs == (int(groups[order[i]]),)
    assert sorted(g for gs in heads for g in gs) \
        == sorted(int(g) for g in groups)
    assert sum(it[1][0].size for it in pipe._items) == cu.size


def test_plan_orders_by_serving_traffic(pipe_engine):
    u, v, w = traffic_updates(pipe_engine.g, frac=0.2, seed=6)
    cu, cv, _cw = _coalesced(u, v, w)
    probe = RefreshPipeline(pipe_engine, max_items=64)
    groups, counts = np.unique(probe._owner_group(cu, cv),
                               return_counts=True)
    assert groups.size >= 2
    cold = int(groups[np.argmin(counts)])    # least dirty group
    plan = pipe_engine.plan
    frag2grp = np.asarray(plan.hier[0].sf_of_frag[:plan.k]
                          if plan.hier else np.arange(plan.k))
    per_frag = np.where(frag2grp == cold, 1000, 0).astype(np.int64)
    pipe = RefreshPipeline(pipe_engine, traffic=lambda: per_frag,
                           max_items=4)
    pipe.submit(u, v, w)
    assert pipe.plan() >= 2
    assert pipe._items[0][0] == (cold,)


def test_plan_is_noop_while_items_pending():
    g = road_like(300, seed=7)
    eng = EpochedEngine(g, device="cpu")
    u, v, w = traffic_updates(g, frac=0.1, seed=3)
    pipe = RefreshPipeline(eng, max_items=3)
    pipe.submit(u, v, w)
    n = pipe.plan()
    assert n >= 2
    pipe.submit(u[:1], v[:1], w[:1] + 1)
    assert pipe.plan() == n and len(pipe.queue) == 1
    stats = pipe.drain()
    assert len(stats) == n and pipe.pending_items() == 0
    stale = eng.snapshot()[3]
    assert not stale.complete and stale.lag_batches == 1
    assert stale.pending_updates == 1
    assert pipe.plan() == 1
    assert pipe.step() is not None and pipe.step() is None
    assert pipe.watermark == 2
    assert eng.snapshot()[3].complete


def _assert_final_matches_scratch(eng):
    sdix = tde.build_device_index(reweight_index(eng.ix, eng.g),
                                  device="cpu",
                                  hierarchy_levels=eng.plan.hierarchy_levels)
    eq = tde.index_fields_equal(eng.dix, sdix, REFRESHED_FIELDS)
    assert all(eq.values()), [k for k, ok in eq.items() if not ok]
    assert all(tde.sidecars_equal(eng.dix, sdix).values())


@pytest.mark.parametrize("lv", [1, 2])
def test_staged_epochs_exact_and_final_matches_scratch(lv):
    g = road_like(380, seed=33)
    eng = EpochedEngine(g, device="cpu", hierarchy_levels=lv)
    rng = np.random.default_rng(0)
    u, v, w = traffic_updates(g, frac=0.08, seed=9)
    pipe = RefreshPipeline(eng, max_items=4)
    sub = pipe.submit(u, v, w)
    n_items = pipe.plan()
    assert n_items >= 2
    e_start = eng.snapshot()[0]
    applied, prev_pending = 0, None
    while pipe.step() is not None:
        applied += 1
        epoch, _dix, _g, stale = eng.snapshot()
        assert epoch == e_start + applied
        assert stale.submitted == sub
        if prev_pending is not None:
            assert stale.pending_updates < prev_pending
        prev_pending = stale.pending_updates
        if pipe.pending_items():
            assert not stale.complete and stale.lag_batches == 1
        else:
            assert stale.complete and stale.watermark == sub
        s, t = rng.integers(0, g.n, 12), rng.integers(0, g.n, 12)
        np.testing.assert_array_equal(eng.query(s, t), _oracle(eng.g, s, t))
    assert applied == n_items and pipe.watermark == sub
    _assert_final_matches_scratch(eng)


def test_step_failure_requeues_item_and_publishes_nothing():
    g = road_like(300, seed=11)
    eng = EpochedEngine(g, device="cpu")
    u, v, w = traffic_updates(g, frac=0.05, seed=3)
    pipe = RefreshPipeline(eng, max_items=3)
    pipe.submit(u, v, w)
    n = pipe.plan()
    e0 = eng.snapshot()[0]

    def boom(u, v, w, *, staleness=None):
        raise RuntimeError("refresh died")

    eng.apply_updates = boom
    with pytest.raises(RuntimeError, match="refresh died"):
        pipe.step()
    del eng.apply_updates
    assert pipe.pending_items() == n
    assert eng.snapshot()[0] == e0
    assert pipe.watermark == 0
    assert len(pipe.drain()) == n
    _assert_final_matches_scratch(eng)


# -- 9. the CLI --------------------------------------------------------------

def test_cli_update_batches(capsys):
    rc = serve.main(["--device", "cpu", "--nodes", "900", "--batches", "1",
                     "--batch-size", "64", "--validate", "16",
                     "--update-batches", "2", "--update-frac", "0.02"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert len(lines) == 2 and all("match=True" in ln for ln in lines), out
    assert all("0 mismatches of 16" in ln for ln in lines)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EpochedEngine(road_like(300, seed=1))
