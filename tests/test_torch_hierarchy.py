"""The port's N-level overlay hierarchy against the reference package.

On small road graphs built at ``hierarchy_levels`` 2 and 3 (and a
graph where 3 levels do not collapse), the port's ``plan_hierarchy``
structure, every hierarchical ``DeviceIndex`` field and host sidecar is
array-equal to ``repro.core.device_engine.build_device_index_with_plan``
of the same graph, and every distance the port serves (``serve_step``,
the 4-case planner with a non-empty ``cross_res`` bucket and
``serve_one_to_all``, in both combine layouts) is ``==`` the reference's
answer and the Dijkstra oracle.  The reference runs its default CPU
dispatch (the jnp oracles).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_engine as jde
from repro.core.graph import road_like as jroad_like
from repro.core.supergraph import build_index as jbuild_index
from repro_torch import convert
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra, hierarchy
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

LAYOUTS = ("gather", "scatter")
# (nodes, seed, levels): road_like(700, 7) and road_like(900) collapse
# to one grouping level above 2 (their second level has one group);
# road_like(1400, 23) keeps three real levels with resident rows
CASES = [(700, 7, 2), (700, 7, 3), (900, 0, 2), (900, 0, 3),
         (1400, 23, 3)]
_BUILT: dict = {}


def _built(n, seed, lv):
    """(port graph, port index, port plan, reference index, reference
    plan), built once per test process."""
    key = (n, seed, lv)
    if key not in _BUILT:
        jdix, jplan = jde.build_device_index_with_plan(
            jbuild_index(jroad_like(n, seed=seed)), hierarchy_levels=lv)
        g = road_like(n, seed=seed)
        dix, plan = tde.build_device_index_with_plan(
            build_index(g), device="cpu", hierarchy_levels=lv)
        _BUILT[key] = (g, dix, plan, jdix, jplan)
    return _BUILT[key]


def _oracle(g, s, t):
    return np.array([dijkstra.pair(g, int(a), int(b))
                     for a, b in zip(s, t)], np.float32)


def _pairs(g, dix, seed=0, n_random=120):
    """Random pairs plus pairs that fill every planner bucket: same DRA,
    same fragment, cross fragment, and (when the index carries resident
    rows) both ends resident in different top groups."""
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


@pytest.mark.parametrize("n,seed,lv", CASES)
def test_plan_hierarchy_matches_reference(n, seed, lv):
    _g, dix, plan, _jdix, jplan = _built(n, seed, lv)
    assert dix.hierarchy_levels == plan.hierarchy_levels \
        == jplan.hierarchy_levels == 1 + len(jplan.hier)
    assert len(plan.hier) == len(jplan.hier)
    for li, (h, jh) in enumerate(zip(plan.hier, jplan.hier)):
        for f in dataclasses.fields(hierarchy.HierPlan):
            got, want = getattr(h, f.name), getattr(jh, f.name)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype, (li, f.name)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"level {li} {f.name}")
        assert h.overlay_bytes() == jh.overlay_bytes()
    from repro.core.hierarchy import hier_overlay_stats
    assert hierarchy.hier_overlay_stats(plan.hier, plan.S) \
        == hier_overlay_stats(jplan.hier, jplan.S)


@pytest.mark.parametrize("n,seed,lv", CASES)
def test_every_hier_field_and_sidecar_matches_reference(n, seed, lv):
    _g, dix, _plan, jdix, _jplan = _built(n, seed, lv)
    for name, dtype in tde.FIELD_DTYPES.items():
        got, want = getattr(dix, name), np.asarray(getattr(jdix, name))
        assert got.dtype == dtype, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name, dtype in tde.TUPLE_FIELD_DTYPES.items():
        got, want = getattr(dix, name), getattr(jdix, name)
        assert len(got) == len(want) == dix.hierarchy_levels - 1, name
        for li, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == dtype, (name, li)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name}[{li}]")
    assert isinstance(dix.host_ov_slot, hierarchy.SlotMap)
    maps = [(dix.host_ov_slot, jdix.host_ov_slot)]
    maps += list(zip(dix.host_l2_slot, jdix.host_l2_slot))
    assert len(dix.host_l2_slot) == len(jdix.host_l2_slot)
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


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n,seed,lv", CASES)
def test_serve_step_and_planner_match_reference_and_dijkstra(
        n, seed, lv, layout):
    g, dix, _plan, jdix, _ = _built(n, seed, lv)
    s, t = _pairs(g, dix)
    want = np.asarray(jde.serve_step(jdix, jnp.asarray(s, jnp.int32),
                                     jnp.asarray(t, jnp.int32)))
    oracle = _oracle(g, s, t)
    np.testing.assert_array_equal(want, oracle)
    got = tde.serve_step(dix, torch.from_numpy(s), torch.from_numpy(t),
                         layout=layout).numpy()
    np.testing.assert_array_equal(got, want)
    planner = QueryPlanner(dix, layout=layout)
    np.testing.assert_array_equal(planner.query(s, t), want)
    counts = planner.last_counts
    assert sum(counts.values()) == s.size
    assert all(counts[c] for c in ("same_dra", "same_frag", "cross_frag"))
    if dix.res_rows.shape[0] > 1:
        assert counts["cross_res"] > 0, counts
    else:
        assert counts["cross_res"] == 0, counts


def test_cross_res_bucket_matches_full_lift():
    """The resident program answers its bucket exactly as the full
    per-level lift of serve_cross does, in both layouts."""
    g, dix, _plan, _jdix, _ = _built(1400, 23, 3)
    s, t = _pairs(g, dix, seed=5)
    idx = QueryPlanner(dix).plan(s, t)["cross_res"]
    assert idx.size >= 4
    s, t = torch.from_numpy(s[idx]), torch.from_numpy(t[idx])
    want = tde.serve_cross(dix, s, t, with_local=False).numpy()
    np.testing.assert_array_equal(want, _oracle(g, s.numpy(), t.numpy()))
    for layout in LAYOUTS:
        got = tde.serve_cross_res(dix, s, t, layout=layout).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,seed,lv", [(700, 7, 2), (1400, 23, 3)])
def test_serve_one_to_all_matches_reference_and_dijkstra(n, seed, lv):
    g, dix, _plan, jdix, _ = _built(n, seed, lv)
    for src in (0, 17, g.n - 1):
        got = tde.serve_one_to_all(dix, src).numpy()
        want = np.asarray(jde.serve_one_to_all(jdix, src))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, dijkstra.sssp(g, src).astype(
            np.float32))


def test_one_to_all_from_agent_outside_every_fragment_is_inf():
    """A source whose agent lies outside every fragment: the reference
    wraps frag_of = -1 in its gathers and masks after; the port clamps
    before (no out-of-range gather) and agrees: +inf to every target
    outside the source's DRA, the same-DRA answers unchanged."""
    g, dix, plan, jdix, _ = _built(1400, 23, 3)
    src = 11
    u = int(plan.agent_of[src])
    frag_of = dix.frag_of.clone()
    frag_of[u] = -1
    got = tde.serve_one_to_all(dataclasses.replace(dix, frag_of=frag_of),
                               src).numpy()
    jfrag = np.asarray(jdix.frag_of).copy()
    jfrag[u] = -1
    want = np.asarray(jde.serve_one_to_all(
        dataclasses.replace(jdix, frag_of=jnp.asarray(jfrag)), src))
    np.testing.assert_array_equal(got, want)
    same = plan.agent_of == u
    assert np.isinf(got[~same]).all()
    np.testing.assert_array_equal(
        got[same], tde.serve_one_to_all(dix, src).numpy()[same])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_serves_from_reference_built_hier_index(layout):
    """The reference's hierarchical index carried across through
    convert serves the same answers, sidecars and all, and round-trips
    field for field."""
    g, dix, _plan, jdix, _ = _built(1400, 23, 3)
    fields = {name: np.asarray(getattr(jdix, name))
              for name in tde.FIELD_DTYPES}
    fields.update({name: [np.asarray(a) for a in getattr(jdix, name)]
                   for name in tde.TUPLE_FIELD_DTYPES})
    fields.update({name: getattr(jdix, name, None)
                   for name in convert.SIDECARS})
    cdix = convert.device_index_from_numpy(fields, "cpu")
    assert cdix.hierarchy_levels == 3
    s, t = _pairs(g, dix, seed=3)
    planner = QueryPlanner(cdix, layout=layout)
    np.testing.assert_array_equal(planner.query(s, t), _oracle(g, s, t))
    assert planner.last_counts["cross_res"] > 0
    back = convert.device_index_to_numpy(cdix)
    for name in tde.FIELD_DTYPES:
        np.testing.assert_array_equal(back[name], fields[name])
    for name in tde.TUPLE_FIELD_DTYPES:
        for a, b in zip(back[name], fields[name], strict=True):
            np.testing.assert_array_equal(a, b)
    bad = dict(fields, sf_of=fields["sf_of"][:1])
    with pytest.raises(ValueError, match="levels"):
        convert.device_index_from_numpy(bad, "cpu")


def test_hier_planner_warmup_and_padding():
    """warmup runs the resident program only where it has rows; padded
    (0, 0) filler queries reach every program without an out-of-range
    gather."""
    g, dix, _plan, _jdix, _ = _built(1400, 23, 3)
    planner = QueryPlanner(dix)
    ran = set()
    for case, fn in list(planner._fns.items()):
        def rec(d, sp, tp, _fn=fn, _case=case):
            ran.add(_case)
            return _fn(d, sp, tp)
        planner._fns[case] = rec
    planner.warmup(20)
    assert ran == set(QueryPlanner.CASES)
    ran.clear()
    dense = QueryPlanner(_built(700, 7, 3)[1])
    assert dense.dix.res_rows.shape[0] == 1
    for case, fn in list(dense._fns.items()):
        def rec2(d, sp, tp, _fn=fn, _case=case):
            ran.add(_case)
            return _fn(d, sp, tp)
        dense._fns[case] = rec2
    dense.warmup(20)
    assert "cross_res" not in ran and len(ran) == 3


@pytest.mark.parametrize("width", [24, 64, 10_000])
def test_chunk_width_leaves_answers_unchanged(monkeypatch, width):
    """The card steps the gather loops by wider chunks than the CPU's 8
    (``_chunk``); any width, ragged last chunk included, gives the same
    answers in every bucket and layout and in one-to-all."""
    g, dix, _plan, jdix, _ = _built(1400, 23, 3)
    s, t = _pairs(g, dix, seed=9)
    want = {layout: QueryPlanner(dix, layout=layout).query(s, t)
            for layout in LAYOUTS}
    o2a = tde.serve_one_to_all(dix, 17).numpy()
    monkeypatch.setattr(tde, "_chunk",
                        lambda row, _w: min(width, row.shape[1]))
    for layout in LAYOUTS:
        np.testing.assert_array_equal(
            QueryPlanner(dix, layout=layout).query(s, t), want[layout])
    np.testing.assert_array_equal(want["gather"], want["scatter"])
    np.testing.assert_array_equal(tde.serve_one_to_all(dix, 17).numpy(), o2a)
    gd = road_like(700, seed=7)
    dense = tde.build_device_index(build_index(gd), device="cpu",
                                   hierarchy_levels=1)
    sd, td = s % gd.n, t % gd.n
    np.testing.assert_array_equal(
        tde.serve_step(dense, torch.from_numpy(sd), torch.from_numpy(td),
                       layout="gather").numpy(), _oracle(gd, sd, td))


def test_chunk_rule():
    """8 columns on the CPU (the reference's chunk); on a CUDA tensor a
    multiple of 8 under the byte cap, never below 8 nor above the
    width; a meta tensor (the dry runs) takes the card's chunking."""
    cpu = torch.zeros((1024, 440))
    assert tde._chunk(cpu, 592) == 8
    assert tde._chunk(torch.zeros((4, 5)), 7) == 5
    meta = torch.empty((1024, 440), device="meta")
    # (64 << 20) // (4 * 1024 * 592) = 27 -> 24, the card's width
    assert tde._chunk(meta, 592) == 24
