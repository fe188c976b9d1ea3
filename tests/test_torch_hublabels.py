"""The port's hub-label tier against the reference package.

On ``road_like(1400, seed=23)`` built at hierarchy levels 1, 2 and 3
with one seeded hub set, the port's hub tables (``hub_rows``,
``hub_of_agent``) and sidecars (``host_hub_agent``,
``host_topgrp_frag``) are array-equal to the reference build's,
``QueryPlanner.hub_mask`` gates the same pairs, and on every gated pair
``query_hub`` (one label merge) is ``==`` the planner's ``query`` and
the Dijkstra oracle.  Integer weights make the merge's re-association
of the (min,+) sums exact, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core.dist_engine import QueryPlanner as JQueryPlanner
from repro.core.graph import road_like as jroad_like
from repro.core.supergraph import build_index as jbuild_index
from repro_torch import convert
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

N, SEED, N_HUBS = 1400, 23, 256
LEVELS = (1, 2, 3)
_BUILT: dict = {}


def _world():
    """(port graph, hub set, reference host index, port host index)."""
    if "world" not in _BUILT:
        g = road_like(N, seed=SEED)
        hubs = np.random.default_rng(SEED + 1).choice(g.n, N_HUBS,
                                                      replace=False)
        _BUILT["world"] = (g, hubs, jbuild_index(jroad_like(N, seed=SEED)),
                           build_index(g))
    return _BUILT["world"]


def _built(lv):
    """(port graph, port index, reference index) at ``lv`` levels with
    the hub set, built once per test process."""
    if lv not in _BUILT:
        g, hubs, jix, ix = _world()
        jdix = jde.build_device_index(jix, hierarchy_levels=lv,
                                      hub_nodes=hubs)
        dix = tde.build_device_index(ix, device="cpu", hierarchy_levels=lv,
                                     hub_nodes=hubs)
        assert dix.hierarchy_levels == lv
        _BUILT[lv] = (g, dix, jdix)
    return _BUILT[lv]


def _candidates(g, n_cand=2000, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, g.n, n_cand).astype(np.int64),
            rng.integers(0, g.n, n_cand).astype(np.int64))


@pytest.mark.parametrize("lv", LEVELS)
def test_hub_tables_match_reference(lv):
    _g, dix, jdix = _built(lv)
    assert dix.hub_rows.dtype == torch.float32
    assert dix.hub_of_agent.dtype == torch.int32
    assert dix.hub_rows.shape[0] > 1
    for name in ("hub_rows", "hub_of_agent"):
        np.testing.assert_array_equal(getattr(dix, name).numpy(),
                                      np.asarray(getattr(jdix, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(dix.host_hub_agent, jdix.host_hub_agent)
    want = getattr(jdix, "host_topgrp_frag", None)
    if want is None:
        assert dix.host_topgrp_frag is None
    else:
        np.testing.assert_array_equal(dix.host_topgrp_frag, want)


@pytest.mark.parametrize("lv", LEVELS)
def test_hub_mask_matches_reference(lv):
    g, dix, jdix = _built(lv)
    s, t = _candidates(g)
    mask = QueryPlanner(dix).hub_mask(s, t)
    assert mask.any(), "gate admitted nothing: fixture too small"
    np.testing.assert_array_equal(mask, JQueryPlanner(jdix).hub_mask(
        s.astype(np.int32), t.astype(np.int32)))


@pytest.mark.parametrize("lv", LEVELS)
def test_query_hub_equals_query_and_dijkstra(lv):
    g, dix, _jdix = _built(lv)
    s, t = _candidates(g, seed=3)
    planner = QueryPlanner(dix)
    mask = planner.hub_mask(s, t)
    assert mask.any(), "gate admitted nothing: fixture too small"
    got = planner.query_hub(s[mask], t[mask])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, planner.query(s[mask], t[mask]))
    oracle = [dijkstra.pair(g, int(a), int(b))
              for a, b in zip(s[mask][:24], t[mask][:24])]
    np.testing.assert_array_equal(got[:24], np.asarray(oracle, np.float32))


def test_hub_mask_rejects_unlabeled_and_trivial_pairs():
    _g, dix, _jdix = _built(2)
    hubs = _world()[1]
    planner = QueryPlanner(dix)
    # labels cover agents: "unlabeled" means the node's agent has no row
    agent_of = dix.agent_of.numpy()
    unlabeled = np.nonzero(dix.host_hub_agent[agent_of] < 0)[0][:16]
    assert unlabeled.size == 16
    labeled = np.asarray(hubs[:16], np.int64)
    assert not planner.hub_mask(unlabeled, labeled).any()
    assert not planner.hub_mask(labeled, unlabeled).any()
    # s == t is never gated (the planner's same-node case is free)
    assert not planner.hub_mask(labeled, labeled).any()
    # a mis-gated pair reads the all-INF sentinel row: +inf, never wrong
    assert np.isinf(planner.query_hub(unlabeled[:4], labeled[:4])).all()


def test_index_without_hubs_gates_nothing():
    """No hub set: dummy tables, no sidecar, an empty gate, +inf from
    query_hub, and warmup never runs the hub program."""
    g, _hubs, _jix, ix = _world()
    dix = tde.build_device_index(ix, device="cpu", hierarchy_levels=1)
    assert tuple(dix.hub_rows.shape) == (1, 1)
    assert dix.host_hub_agent is None
    planner = QueryPlanner(dix)
    s, t = _candidates(g, n_cand=50)
    assert not planner.hub_mask(s, t).any()
    assert np.isinf(planner.query_hub(s, t)).all()
    planner._hub_fn = None                  # would raise if called
    planner.warmup(20)


def test_warmup_runs_hub_program_on_labeled_index():
    _g, dix, _jdix = _built(3)
    planner = QueryPlanner(dix)
    ran = []
    hub_fn = planner._hub_fn

    def rec(d, sp, tp):
        ran.append(sp.numel())
        return hub_fn(d, sp, tp)
    planner._hub_fn = rec
    planner.warmup(40)
    assert ran == QueryPlanner.bucket_sizes(40)


def test_convert_carries_hub_tables_and_sidecar():
    """The reference's labeled index carried across serves the same
    gate and answers, and round-trips the hub fields."""
    g, dix, jdix = _built(3)
    fields = {name: np.asarray(getattr(jdix, name))
              for name in tde.FIELD_DTYPES}
    fields.update({name: [np.asarray(a) for a in getattr(jdix, name)]
                   for name in tde.TUPLE_FIELD_DTYPES})
    fields.update({name: getattr(jdix, name, None)
                   for name in convert.SIDECARS})
    cdix = convert.device_index_from_numpy(fields, "cpu")
    s, t = _candidates(g, seed=4)
    mask = QueryPlanner(cdix).hub_mask(s, t)
    np.testing.assert_array_equal(mask, QueryPlanner(dix).hub_mask(s, t))
    np.testing.assert_array_equal(
        QueryPlanner(cdix).query_hub(s[mask], t[mask]),
        QueryPlanner(dix).query_hub(s[mask], t[mask]))
    back = convert.device_index_to_numpy(cdix)
    for name in ("hub_rows", "hub_of_agent", "host_hub_agent"):
        np.testing.assert_array_equal(back[name], fields[name])


@pytest.mark.parametrize("lv", (2, 3))
def test_rejected_labeled_pair_is_finite_and_never_short(lv):
    """``query_hub`` off the gate: labeled pairs that ``hub_mask``
    rejects (both agents labeled, in different fragments of one TOP
    group) get a finite answer, the length of a real path through the
    top boundary, so never below Dijkstra, and ``==`` the reference's
    ``query_hub``.  Callers gate first; this pins what the docstrings
    of ``serve_hub`` and ``QueryPlanner.query_hub`` say."""
    g, dix, jdix = _built(lv)
    planner = QueryPlanner(dix)
    s, t = _candidates(g, n_cand=20000, seed=7)
    agent_of = dix.agent_of.numpy()
    frag_of = dix.frag_of.numpy()
    us, ut = agent_of[s], agent_of[t]
    topgrp = dix.host_topgrp_frag
    assert topgrp is not None
    labeled = ((dix.host_hub_agent[us] >= 0) & (dix.host_hub_agent[ut] >= 0)
               & (frag_of[us] >= 0) & (frag_of[ut] >= 0))
    same_top = (frag_of[us] != frag_of[ut]) & (
        topgrp[np.maximum(frag_of[us], 0)]
        == topgrp[np.maximum(frag_of[ut], 0)])
    pick = labeled & same_top & (s != t)
    assert pick.sum() >= 4, "no labeled same-top-group pair: fixture"
    s, t = s[pick][:64], t[pick][:64]
    assert not planner.hub_mask(s, t).any()
    got = planner.query_hub(s, t)
    want = JQueryPlanner(jdix).query_hub(s.astype(np.int32),
                                         t.astype(np.int32))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.isfinite(got).all()
    oracle = np.asarray([dijkstra.pair(g, int(a), int(b))
                         for a, b in zip(s, t)], np.float32)
    assert (got >= oracle).all(), (got - oracle).min()
