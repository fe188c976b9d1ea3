"""The port's refresh and epochs at 4 and 5 hierarchy levels against the
reference package.

A scripted sequence of three update batches (mixed, decrease-only, jam)
runs through the reference ``EpochedEngine`` (its CPU dispatch) and the
port's (``device="cpu"``) on three hierarchies: ``road_like(2000, 0)``
at 4 levels (top 65), ``road_like(1400, 23)`` at 5 levels with the group
budget cut to a third in both packages (top 39) and 64 seeded hub
nodes, and ``road_like(6000, 0)`` at 5 levels (its last level one group,
top empty) with 64 hub nodes.  The batches are chosen so that on each
graph with a top closure one epoch re-closes it by the decrease path
(``l2_decrease_stage``) and one by the full closure (``"full_fw"``); on
the graph without one every cascade stops below the top
(``"carry"``).  After every epoch the port's index is array-equal to the
reference's epoch and to the port's scratch rebuild
(``build_device_index(reweight_index(ix, g))``) on every
``REFRESHED_FIELDS`` table and every host sidecar, the ``RefreshStats``
agree, 64 answers are ``==`` the reference's and Dijkstra's, and 24
paths (``query_path``) are the reference's node for node, with weights
``==`` Dijkstra.  ``l2_decrease_stage`` is held against the reference
and the full closure at both depths.  Integer weights keep every float32
sum exact: every comparison is exact (``==``).
"""
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core import hierarchy as jhier
from repro.core.dist_engine import EpochedEngine as JEpochedEngine
from repro.core.graph import road_like as jroad_like
from repro.core.supergraph import build_index as jbuild_index
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra, hierarchy
from repro_torch.core.dist_engine import EpochedEngine
from repro_torch.core.graph import road_like, traffic_updates
from repro_torch.core.paths import path_weight
from repro_torch.core.supergraph import build_index, reweight_index
from repro_torch.launch.serve import REFRESHED_FIELDS
from test_torch_deep_hierarchy import group_budget

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

#: (frac, seed, jam_frac) batches: mixed, decrease-only, jam
SEQ4 = ((0.02, 10, 0.5), (0.002, 1, 0.0), (0.02, 12, 1.0))
SEQ5 = ((0.02, 10, 0.5), (0.002, 12, 0.0), (0.02, 12, 1.0))
#: (nodes, seed, levels, hub nodes, group budget divisor, batches,
#: top closure of each epoch)
CONFIGS = {
    "lv4": (2000, 0, 4, 0, 1, SEQ4, ("carry", "decrease", "full_fw")),
    "lv5_hubs": (1400, 23, 5, 64, 3, SEQ5,
                 ("full_fw", "decrease", "full_fw")),
    "lv5_top_empty_hubs": (6000, 0, 5, 64, 1, SEQ5,
                           ("carry", "carry", "carry")),
}
STAT_FIELDS = ("n_dirty_frags", "n_dirty_pieces", "n_eb_slots", "n_inert",
               "decrease_only", "total_increase", "top_closure")
_RUNS: dict = {}


def _oracle(g, s, t):
    return np.array([dijkstra.pair(g, int(a), int(b)) for a, b in zip(s, t)],
                    np.float32)


def _run(name):
    """The scripted sequence through both engines, once per process:
    one record per epoch."""
    if name in _RUNS:
        return _RUNS[name]
    n, seed, lv, n_hubs, div, seq, _ = CONFIGS[name]
    g = road_like(n, seed=seed)
    hubs = (np.random.default_rng(seed + 1).choice(g.n, n_hubs,
                                                   replace=False)
            if n_hubs else None)
    rng = np.random.default_rng(seed)
    epochs = []
    with group_budget(div):
        eng = EpochedEngine(g, device="cpu", hierarchy_levels=lv,
                            hub_nodes=hubs)
        jeng = JEpochedEngine(jroad_like(n, seed=seed), hierarchy_levels=lv,
                              hub_nodes=hubs, warm_refresh=False)
        assert eng.dix.hierarchy_levels == jeng.dix.hierarchy_levels == lv
        for frac, sd, jam in seq:
            u, v, w = traffic_updates(eng.g, frac, seed=sd, jam_frac=jam)
            stats = eng.apply_updates(u, v, w)
            jstats = jeng.apply_updates(u, v, w)
            scratch = tde.build_device_index(
                reweight_index(eng.ix, eng.g), device="cpu",
                hierarchy_levels=lv, hub_nodes=hubs)
            s, t = rng.integers(0, g.n, 64), rng.integers(0, g.n, 64)
            ps, pt = s[:24], t[:24]
            epochs.append({
                "g": eng.g, "dix": eng.dix, "jdix": jeng.dix,
                "scratch": scratch, "stats": stats, "jstats": jstats,
                "got": eng.query(s, t), "jgot": jeng.query(s, t),
                "want": _oracle(eng.g, s, t), "pairs": (ps, pt),
                "paths": eng.query_path(ps, pt),
                "jpaths": jeng.query_path(ps.astype(np.int32),
                                          pt.astype(np.int32))})
    _RUNS[name] = epochs
    return epochs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_deep_refresh_matches_reference_tables(name):
    for e, rec in enumerate(_run(name)):
        assert rec["dix"].hierarchy_levels == CONFIGS[name][2]
        eq = tde.index_fields_equal(rec["dix"], rec["jdix"], REFRESHED_FIELDS)
        assert all(eq.values()), (e, [k for k, ok in eq.items() if not ok])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_deep_refresh_matches_scratch_rebuild(name):
    for e, rec in enumerate(_run(name)):
        eq = tde.index_fields_equal(rec["dix"], rec["scratch"],
                                    REFRESHED_FIELDS)
        assert all(eq.values()), (e, [k for k, ok in eq.items() if not ok])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_deep_refresh_sidecars_match_reference_and_rebuild(name):
    for e, rec in enumerate(_run(name)):
        for other in ("jdix", "scratch"):
            eq = tde.sidecars_equal(rec["dix"], rec[other])
            assert all(eq.values()), (e, other, eq)
        dix = rec["dix"]
        assert len(dix.host_l2_slot) == dix.hierarchy_levels - 1
        assert (dix.host_hub_agent is not None) == bool(CONFIGS[name][3])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_deep_refresh_stats_and_top_closures(name):
    """The stats equal the reference's, and each epoch re-closes the top
    as scripted: by the decrease path and by the full closure where the
    graph has a top, never where it has none."""
    runs = _run(name)
    for e, rec in enumerate(runs):
        st, jst = rec["stats"], rec["jstats"]
        for f in STAT_FIELDS:
            assert getattr(st, f) == getattr(jst, f), (e, f)
    assert [r["stats"].decrease_only for r in runs] == [False, True, False]
    assert tuple(r["stats"].top_closure for r in runs) == CONFIGS[name][6]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_deep_refresh_answers_exact(name):
    for e, rec in enumerate(_run(name)):
        np.testing.assert_array_equal(rec["got"], rec["jgot"],
                                      err_msg=f"epoch {e + 1}")
        np.testing.assert_array_equal(rec["got"], rec["want"],
                                      err_msg=f"epoch {e + 1}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_deep_refresh_paths_match_reference_and_dijkstra(name):
    """Every epoch's paths unwind through all its levels to the
    reference's node sequences, with weights == Dijkstra on the epoch's
    weights."""
    for e, rec in enumerate(_run(name)):
        (dist, paths), (jdist, jpaths) = rec["paths"], rec["jpaths"]
        np.testing.assert_array_equal(dist, np.asarray(jdist))
        assert [None if p is None else list(map(int, p)) for p in paths] \
            == [None if p is None else list(map(int, p)) for p in jpaths], e
        ps, pt = rec["pairs"]
        want = _oracle(rec["g"], ps, pt)
        np.testing.assert_array_equal(dist, want)
        for p, d in zip(paths, dist):
            if p is not None:
                assert path_weight(rec["g"], p) == float(d)


def _decreased_top(plan, jplan, slots):
    """Lower the listed top slots' weights in both plans (the same new
    values), returning the previous weights to restore."""
    h, jh = plan.hier[-1], jplan.hier[-1]
    old = h.l2_w.copy()
    new = np.maximum(1.0, np.floor(h.l2_w[slots] / 3)).astype(np.float32)
    h.l2_w[slots] = new
    jh.l2_w[slots] = new
    return old


@pytest.mark.parametrize("n,seed,lv,div", [(2000, 0, 4, 1),
                                           (1400, 23, 5, 3)])
def test_l2_decrease_stage_at_depth_matches_reference(n, seed, lv, div):
    """Lowered top slots re-closed by ``l2_decrease_stage``: == the
    reference's and == the full ``l2_stage`` of the lowered weights
    (witnesses re-derived by the torch ``first_hops`` on the touched rows
    and columns)."""
    with group_budget(div):
        dix, plan = tde.build_device_index_with_plan(
            build_index(road_like(n, seed=seed)), device="cpu",
            hierarchy_levels=lv)
        jdix, jplan = jde.build_device_index_with_plan(
            jbuild_index(jroad_like(n, seed=seed)), hierarchy_levels=lv)
    assert dix.hierarchy_levels == lv
    h, jh = plan.hier[-1], jplan.hier[-1]
    fin = np.nonzero(np.isfinite(h.l2_w) & (h.l2_w > 1))[0]
    rng = np.random.default_rng(0)
    for n_slots in (1, 2, 4):
        slots = np.sort(rng.choice(fin, n_slots, replace=False))
        old = _decreased_top(plan, jplan, slots)
        got = hierarchy.l2_decrease_stage(h, dix.d2, dix.d2_next, slots)
        want = jhier.l2_decrease_stage(jh, jdix.d2, jdix.d2_next, slots)
        assert got is not None and want is not None
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        full = hierarchy.l2_stage(h, torch.device("cpu"))
        for a, b in zip(got, full):
            assert torch.equal(a, b)
        # the old epoch's tables are never written
        np.testing.assert_array_equal(dix.d2_next.numpy(),
                                      np.asarray(jdix.d2_next))
        h.l2_w[:] = old
        jh.l2_w[:] = old
