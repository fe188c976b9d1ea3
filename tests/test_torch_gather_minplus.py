"""The hierarchy's gathered-row (min,+) products: the lifts
(``ops.gather_minplus``) and the same-group legs
(``ops.gather_minplus_twoside``) of the distance ladder, whose kernels are
``csrc/gather_minplus.cu``.

On the CPU the ops' plain versions are held bit for bit against the
chunked gathers the serve programs ran before them (copied below as they
were: ``_chunked_leg``, ``_chunked_lift``, ``_chunked_lift_res`` and the
ladder around them), on ``road_like`` indices at 3, 4 and 5 levels, in
both layouts, with a fragment id of -1, sentinel-only rows, all-+inf rows
and queries whose groups differ at every level; so are the plain models
of the kernels' schedules.  The invariant the legs' early exit rests on
is pinned: in every side row at every level each finite entry sits at a
slot of slot 0's group, and sentinel slots carry +inf.  On the card
(``cuda``) each kernel equals its plain version at road64k's two and
road250k's four level shapes in every regime, and the planner's main
path launches them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gather_minplus.py

Integer weights keep every sum below 2**24, so "equal" is ``torch.equal``.
This file imports no JAX.
"""
import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra, hierarchy
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index
from repro_torch.kernels import gather_minplus, ops, ref

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

INF = float("inf")
#: (nodes, seed, levels, group-budget divisor): road_like(1400, 23) at 3
#: levels (resident rows) and at 5 with the group budget cut to a third,
#: road_like(2000, 0) at 4; each keeps two or more groups at its last
#: grouping level, so some pairs differ at every level
CASES = {"l3": (1400, 23, 3, 1), "l4": (2000, 0, 4, 1),
         "l5": (1400, 23, 5, 3)}
LAYOUTS = ("scatter", "gather")
_BUILT: dict = {}


@contextlib.contextmanager
def _group_budget(div: int):
    """The per-group budget (``_default_gamma2``) divided by ``div``,
    floored at 8 (1: unchanged)."""
    if div == 1:
        yield
        return
    base = hierarchy._default_gamma2
    with mock.patch.object(hierarchy, "_default_gamma2",
                           lambda S: max(8, base(S) // div)):
        yield


def _built(case):
    """(graph, index) on the CPU, built once per test process."""
    if case not in _BUILT:
        n, seed, lv, div = CASES[case]
        g = road_like(n, seed=seed)
        with _group_budget(div):
            dix = tde.build_device_index(build_index(g), device="cpu",
                                         hierarchy_levels=lv)
        assert len(dix.sf_of) == lv - 1
        _BUILT[case] = (g, dix)
    return _BUILT[case]


# -- the serve programs' chunked gathers before the kernel, as they were --
def _chunked_leg(dix, li, row_s, grp_s, pos_s, row_t, grp_t, pos_t):
    q, mbs = row_s.shape
    c = tde._chunk(row_s, row_t.shape[1])
    clo = dix.sf_closure[li]
    acc = torch.full((q, row_t.shape[1]), INF, dtype=row_s.dtype)
    for i in range(0, mbs, c):
        g_c, p_c = grp_s[:, i:i + c, None], pos_s[:, i:i + c, None]
        blk = clo[g_c, p_c, pos_t[:, None, :]]
        same = g_c == grp_t[:, None, :]
        cand = torch.where(same, row_s[:, i:i + c, None] + blk, INF)
        acc = torch.minimum(acc, cand.amin(dim=1))
    return (acc + row_t).amin(dim=1)


def _chunked_lift(dix, li, row, grp, pos):
    q, mb = row.shape
    l2 = dix.l2row[li]
    c = tde._chunk(row, l2.shape[2])
    acc = torch.full((q, l2.shape[2]), INF, dtype=row.dtype)
    for i in range(0, mb, c):
        l2_c = l2[grp[:, i:i + c], pos[:, i:i + c]]
        acc = torch.minimum(acc, (row[:, i:i + c, None] + l2_c).amin(dim=1))
    return acc


def _chunked_lift_res(dix, row, pos, ridx, cols):
    q, mb = row.shape
    width = cols.shape[1]
    c = tde._chunk(row, width)
    acc = torch.full((q, width), INF, dtype=row.dtype)
    for i in range(0, mb, c):
        blk = dix.res_rows[ridx[:, None, None], pos[:, i:i + c, None],
                           cols[:, None, :]]
        acc = torch.minimum(acc, (row[:, i:i + c, None] + blk).amin(dim=1))
    return acc


def _chunked_combine_h(dix, row_s, bs, row_t, bt, layout):
    q = row_s.shape[0]
    ids_s, ids_t = bs.long(), bt.long()
    va = torch.full((q,), INF, dtype=row_s.dtype)
    for li in range(len(dix.sf_of)):
        grp_s = dix.sf_of[li][ids_s].long()
        pos_s = dix.pos_in_sf[li][ids_s].long()
        grp_t = dix.sf_of[li][ids_t].long()
        pos_t = dix.pos_in_sf[li][ids_t].long()
        va = torch.minimum(va, _chunked_leg(dix, li, row_s, grp_s, pos_s,
                                            row_t, grp_t, pos_t))
        new_s = _chunked_lift(dix, li, row_s, grp_s, pos_s)
        new_t = _chunked_lift(dix, li, row_t, grp_t, pos_t)
        top_s, top_t = grp_s[:, 0].contiguous(), grp_t[:, 0].contiguous()
        ids_s = dix.bnd2_sid[li][top_s].long()
        ids_t = dix.bnd2_sid[li][top_t].long()
        row_s, row_t = new_s, new_t
    if layout == "scatter":
        vb = ops.minplus_twoside_grouped(row_s, top_s, dix.bnd2_sid[-1],
                                         dix.d2, row_t, top_t,
                                         dix.bnd2_sid[-1])
    else:
        vb = tde._top_mid_gather(dix, row_s, ids_s, row_t, ids_t)
    return torch.minimum(va, vb)


def _chunked_serve_cross(dix, s, t, with_local, layout):
    ds, dt, fs, ft, ps, pt, valid = tde._ends(dix, s, t)
    row_s, row_t = dix.brow[fs, ps], dix.brow[ft, pt]
    mid = _chunked_combine_h(dix, row_s, dix.bnd_super[fs], row_t,
                             dix.bnd_super[ft], layout)
    if with_local:
        mid = torch.minimum(mid, torch.where(
            fs == ft, dix.frag_apsp[fs, ps, pt], INF))
    return torch.where(valid, ds + mid + dt, INF)


def _chunked_serve_cross_res(dix, s, t, layout):
    ds, dt, fs_c, ft_c, ps, pt, valid = tde._ends(dix, s, t)
    row_s, row_t = dix.brow[fs_c, ps], dix.brow[ft_c, pt]
    pos_s = dix.pos_in_sf[0][dix.bnd_super[fs_c].long()].long()
    pos_t = dix.pos_in_sf[0][dix.bnd_super[ft_c].long()].long()
    top = dix.bnd2_sid[-1]
    grp_s = dix.topgrp_of_frag[fs_c].long()
    grp_t = dix.topgrp_of_frag[ft_c].long()
    ids_s, ids_t = top[grp_s].long(), top[grp_t].long()
    rs = _chunked_lift_res(dix, row_s, pos_s,
                           dix.res_of_frag[fs_c].long(), ids_s)
    rt = _chunked_lift_res(dix, row_t, pos_t,
                           dix.res_of_frag[ft_c].long(), ids_t)
    if layout == "scatter":
        mid = ops.minplus_twoside_grouped(rs, grp_s, top, dix.d2, rt, grp_t,
                                          top)
    else:
        mid = tde._top_mid_gather(dix, rs, ids_s, rt, ids_t)
    return torch.where(valid, ds + mid + dt, INF)


# -- pairs --------------------------------------------------------------
def _frag_of_node(dix):
    return dix.frag_of.numpy()[dix.agent_of.numpy()]


def _top_group(dix):
    """fragment -> its group at the last grouping level, up the ladder
    through each table row's slot 0."""
    unit, tab = torch.arange(dix.bnd_super.shape[0]), dix.bnd_super
    for li in range(len(dix.sf_of)):
        unit = dix.sf_of[li][tab[unit, 0].long()].long()
        tab = dix.bnd2_sid[li]
    return unit.numpy()


def _pairs(g, dix, seed=0, n_random=96):
    """Random cross-DRA pairs, pairs whose TOP groups differ (so their
    groups differ at every level), pairs in one fragment, and resident
    pairs in different top groups where the index has resident rows."""
    rng = np.random.default_rng(seed)
    fa = _frag_of_node(dix)
    agent = dix.agent_of.numpy()
    s = rng.integers(0, g.n, 4 * n_random)
    t = rng.integers(0, g.n, 4 * n_random)
    keep = agent[s] != agent[t]
    s, t = list(s[keep][:n_random]), list(t[keep][:n_random])
    tg = _top_group(dix)
    inside = np.nonzero(fa >= 0)[0]
    far = [(a, b) for a, b in zip(rng.choice(inside, 400),
                                  rng.choice(inside, 400))
           if tg[fa[a]] != tg[fa[b]] and agent[a] != agent[b]]
    assert far, "no pair crosses the top groups"
    s += [a for a, _b in far[:24]]
    t += [b for _a, b in far[:24]]
    for f in np.unique(fa[fa >= 0])[:4]:
        nodes = np.nonzero((fa == f))[0]
        other = [v for v in nodes if agent[v] != agent[nodes[0]]]
        if other:
            s.append(nodes[0])
            t.append(other[-1])
    rf = dix.host_res_frag
    if rf is not None:
        hot = np.nonzero((fa >= 0) & (rf[np.maximum(fa, 0)] >= 0))[0]
        for v in hot[:: max(1, hot.size // 12)]:
            cand = hot[tg[fa[hot]] != tg[fa[v]]]
            if cand.size:
                s.append(v)
                t.append(cand[-1])
    return (torch.as_tensor(np.asarray(s, np.int64)),
            torch.as_tensor(np.asarray(t, np.int64)))


def _with_unfragmented_agent(dix, s):
    """A copy of ``dix`` whose fragment id of the agent of s[0] is -1 (an
    agent outside every fragment), as the serve programs must clamp."""
    frag_of = dix.frag_of.clone()
    frag_of[dix.agent_of[s[0]].long()] = -1
    return dataclasses.replace(dix, frag_of=frag_of)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", list(CASES))
def test_serve_programs_bit_equal_to_chunked_gathers(case, layout):
    """serve_cross (both cross buckets) and serve_cross_res through the
    ops give the chunked gathers' bits, on a fragment id of -1 too, and
    Dijkstra's distances."""
    g, dix = _built(case)
    s, t = _pairs(g, dix)
    for d in (dix, _with_unfragmented_agent(dix, s)):
        for local in (False, True):
            got = tde.serve_cross(d, s, t, with_local=local, layout=layout)
            want = _chunked_serve_cross(d, s, t, local, layout)
            assert torch.equal(got, want)
    assert torch.isinf(tde.serve_cross(
        _with_unfragmented_agent(dix, s), s[:1], t[:1], with_local=True,
        layout=layout)).all()
    if dix.res_rows.shape[0] > 1:
        got = tde.serve_cross_res(dix, s, t, layout=layout)
        assert torch.equal(got, _chunked_serve_cross_res(dix, s, t, layout))
    agent = dix.agent_of.numpy()
    want = np.array([dijkstra.pair(g, int(a), int(b))
                     for a, b in zip(s[:40], t[:40])], np.float32)
    got = QueryPlanner(dix, layout=layout).query(s[:40].numpy(),
                                                  t[:40].numpy())
    np.testing.assert_array_equal(got, want)
    assert (agent[s] != agent[t]).all()


def _ladder(dix, s, t):
    """Each level's operands of the distance ladder, as the serve
    programs hand them to the ops -> [(li, rows [2q, K], units [2q],
    tab)], plus rows of their own: sentinel-only rows (the sentinel
    group's table row, above level 1) and all-+inf rows."""
    _ds, _dt, fs, ft, ps, pt, _v = tde._ends(dix, s, t)
    rows = torch.cat([dix.brow[fs, ps], dix.brow[ft, pt]])
    units = torch.cat([fs, ft])
    tab = dix.bnd_super
    out = []
    for li in range(len(dix.sf_of)):
        r, u = rows.clone(), units.clone()
        r[1::7] = INF                                   # all-+inf rows
        if li:
            u[2::9] = tab.shape[0] - 1                  # sentinel-only
            r[2::9] = INF
        out.append((li, r, u, tab))
        top = dix.sf_of[li][tab[:, 0].long()].long()[units]
        rows = ops.gather_minplus(rows, units, tab, dix.pos_in_sf[li],
                                  dix.l2row[li], gof=dix.sf_of[li])
        units, tab = top, dix.bnd2_sid[li]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_ops_equal_chunked_steps_at_every_level(case):
    """At every level, on the ladder's own operands with sentinel-only
    and all-+inf rows added: the plain lift == the chunked lift of each
    side, the plain leg == the chunked leg, at any chunk width; the plain
    models of the kernels' schedules (tiles of 64 and of 8 rows, one row
    at a time) == the plain versions."""
    g, dix = _built(case)
    s, t = _pairs(g, dix, seed=3)
    q = s.shape[0]
    for li, rows, units, tab in _ladder(dix, s, t):
        gof, pof = dix.sf_of[li], dix.pos_in_sf[li]
        ids = tab[units].long()
        grp, pos = gof[ids].long(), pof[ids].long()
        lift = ops.gather_minplus(rows, units, tab, pof, dix.l2row[li],
                                  gof=gof)
        assert torch.equal(lift, _chunked_lift(dix, li, rows, grp, pos))
        assert torch.equal(lift, ops.gather_minplus(
            rows, units, tab, pof, dix.l2row[li], gof=gof, chunk=37))
        leg = ops.gather_minplus_twoside(rows[:q], units[:q], rows[q:],
                                         units[q:], tab, gof, pof,
                                         dix.sf_closure[li])
        assert torch.equal(leg, _chunked_leg(dix, li, rows[:q], grp[:q],
                                             pos[:q], rows[q:], grp[q:],
                                             pos[q:]))
        for q_tile in (64, 8):
            assert torch.equal(ref.gather_minplus_model(
                rows, units, tab, pof, dix.l2row[li], gof=gof,
                q_tile=q_tile, x_tile=16), lift)
        for q_tile in (64, 8, 1):
            assert torch.equal(ref.gather_minplus_twoside_model(
                rows[:q], units[:q], rows[q:], units[q:], tab, gof, pof,
                dix.sf_closure[li], q_tile=q_tile, x_tile=16), leg)
        # the queries whose slot-0 groups differ: +inf, as the kernel
        # answers them without reading the closure
        differ = grp[:q, 0] != grp[q:, 0]
        assert differ.any() and torch.isinf(leg[differ]).all()


def test_plain_resident_lift_equals_chunked():
    """_lift_res's op (the unit's group from ``res_of_frag``, the columns
    through the top group's ``bnd2_sid`` row) == the chunked gather, and
    its plain model in the store's one-row-a-unit form."""
    g, dix = _built("l3")
    assert dix.res_rows.shape[0] > 1
    s, t = _pairs(g, dix, seed=5)
    _ds, _dt, fs, _ft, ps, _pt, _v = tde._ends(dix, s, t)
    row = dix.brow[fs, ps].clone()
    row[3::5] = INF
    grp = dix.topgrp_of_frag[fs].long()
    got = ops.gather_minplus(row, fs, dix.bnd_super, dix.pos_in_sf[0],
                             dix.res_rows, ugrp=dix.res_of_frag, cunit=grp,
                             ctab=dix.bnd2_sid[-1])
    pos = dix.pos_in_sf[0][dix.bnd_super[fs].long()].long()
    want = _chunked_lift_res(dix, row, pos, dix.res_of_frag[fs].long(),
                             dix.bnd2_sid[-1][grp].long())
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_side_rows_keep_finite_slots_in_slot0_group(case):
    """The invariant the legs' early exit rests on, at every level: in
    every table row each id that is not the sentinel lies in slot 0's
    group; in every side row (every fragment position's boundary row at
    level 1, the ladder's lifted rows above) each finite entry sits at
    such a slot, and sentinel slots carry +inf."""
    g, dix = _built(case)
    s, t = _pairs(g, dix, seed=7)
    frags = torch.arange(dix.brow.shape[0])
    every = (dix.brow.reshape(-1, dix.brow.shape[2]),
             frags.repeat_interleave(dix.brow.shape[1]))
    tab = dix.bnd_super
    seen = 0
    for li, rows, units, tab in _ladder(dix, s, t):
        gof = dix.sf_of[li]
        sentinel = gof.shape[0] - 1
        ids = tab.long()
        grp = gof[ids]
        ok = (ids == sentinel) | (grp == grp[:, :1])
        assert ok.all(), (li, torch.nonzero(~ok)[:5])
        checks = [(rows, units)] + ([every] if li == 0 else [])
        for r, u in checks:
            rid = ids[u.long()]
            finite = torch.isfinite(r)
            assert (grp[u.long()] == grp[u.long(), :1])[finite].all()
            assert torch.isinf(r[rid == sentinel]).all()
            seen += int(finite.sum())
    assert seen


@pytest.mark.parametrize("rows,slots,units,keys,want", [
    (2048, 96, 246, 246, "warp"),        # road250k level 1 lift
    (1024, 96, 246, 246 ** 2, "warp"),   # its leg
    (2048, 1072, 11, 11, "tiles"),       # road250k levels 2-4 lifts
    (2048, 2056, 5, 5, "tiles"),
    (1024, 1072, 11, 121, "tiles"),      # their legs
    (1024, 2056, 5, 25, "tiles"),
    (32, 1072, 11, 11, "tiles"),         # a bucket of 16 queries
    (16, 440, 16, 16, "tiles"),          # witness batch: a row per query
    (16, 64, 16, 16, "warp"),            # its level 1
    (2048, 64, 130, 130, "warp"),        # road64k level 1
    (8192, 64, 130, 130, "tiles"),       # 63 rows a unit
    (8192, 1072, 70, 4900, "warp"),      # more keys than the order takes
])
def test_plan_picks_regime_from_shapes(rows, slots, units, keys, want):
    assert gather_minplus.plan(rows, slots, units, keys) == want
    assert gather_minplus.max_tiles(rows, keys) >= -(-rows // 64)


def test_planner_main_path_calls_one_op_a_step():
    """A cross bucket makes one leg and one lift (both sides) a level,
    the resident bucket one lift a side; the witness programs lift
    through the op a side and level."""
    g, dix = _built("l3")
    L = len(dix.sf_of)
    calls = []
    real = (ops.gather_minplus, ops.gather_minplus_twoside)

    def lift(*a, **k):
        calls.append(("lift", k.get("ctab") is not None, a[0].shape[0]))
        return real[0](*a, **k)

    def leg(*a, **k):
        calls.append(("leg", False, a[0].shape[0]))
        return real[1](*a, **k)
    s, t = _pairs(g, dix, seed=11)
    with mock.patch.object(ops, "gather_minplus", lift), \
            mock.patch.object(ops, "gather_minplus_twoside", leg):
        planner = QueryPlanner(dix)
        planner.query(s.numpy(), t.numpy())
        counts = dict(planner.last_counts)
        cross = sum(bool(counts.get(c)) for c in ("cross_frag", "same_frag"))
        assert cross == 2 and counts["cross_res"] > 0, counts
        assert [k for k, res, _q in calls if not res].count("leg") == L * 2
        assert [k for k, res, _q in calls if not res].count("lift") == L * 2
        assert sum(res for _k, res, _q in calls) == 2
        assert all(r % 2 == 0 for k, res, r in calls
                   if k == "lift" and not res)
        calls.clear()
        QueryPlanner(dix, paths=True).query_witness(s[:16].numpy(),
                                                    t[:16].numpy())
        assert calls and all(k == "lift" for k, _r, _q in calls)


def test_wrappers_refuse_cpu_tensors():
    g, dix = _built("l3")
    row = dix.brow[0]
    unit = torch.zeros(row.shape[0], dtype=torch.int64)
    before = (gather_minplus.gather_minplus_cuda.launches,
              gather_minplus.gather_minplus_twoside_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        gather_minplus.gather_minplus_cuda(row, unit, dix.bnd_super,
                                           dix.pos_in_sf[0], dix.l2row[0],
                                           gof=dix.sf_of[0])
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_minplus_twoside(row, unit, row, unit, dix.bnd_super,
                                   dix.sf_of[0], dix.pos_in_sf[0],
                                   dix.sf_closure[0], force="kernel")
    assert before == (gather_minplus.gather_minplus_cuda.launches,
                      gather_minplus.gather_minplus_twoside_cuda.launches)


def test_meta_route_allocates_the_kernels_outputs():
    """On ``meta`` the ops return the outputs the CUDA wrappers
    allocate, at the regime ``plan`` picks."""
    m = torch.empty((6, 64, 300), device="meta")
    row = torch.empty((512, 200), device="meta")
    unit = torch.empty((512,), dtype=torch.int64, device="meta")
    tab = torch.empty((6, 200), dtype=torch.int32, device="meta")
    ids = torch.empty((400,), dtype=torch.int32, device="meta")
    out = ops.gather_minplus(row, unit, tab, ids, m, gof=ids)
    assert out.shape == (512, 300) and out.device.type == "meta"
    leg = ops.gather_minplus_twoside(row, unit, row, unit, tab, ids, ids,
                                     torch.empty((6, 64, 64),
                                                 device="meta"))
    assert leg.shape == (512,) and leg.device.type == "meta"


# -- the card ---------------------------------------------------------
#: (label, units, groups, m2, slots, next width): road64k's two level
#: shapes (fragment rows of 64 over 130 fragments, then 440) and
#: road250k's four (rows of 96 over 246 fragments, then 1,072, 1,624 and
#: 2,056 over its groups), at q = 1,024 (2,048 rows a lift)
CARD_LEVELS = [
    ("road64k-l1", 130, 6, 1024, 64, 440),
    ("road64k-l2", 7, 3, 1024, 440, 592),
    ("road250k-l1", 246, 10, 2048, 96, 1072),
    ("road250k-l2", 11, 7, 2048, 1072, 1624),
    ("road250k-l3", 8, 4, 4096, 1624, 2056),
    ("road250k-l4", 5, 2, 4096, 2056, 2336),
]


#: the largest finite entry of a row or closure in the "large" operands
#: and of a lift row: a leg's three terms and a lift's two reach
#: 3 * BIG == BIG + BIG_LIFT == 2**24 - 1, the integer invariant's bound
BIG = (2**24 - 1) // 3
BIG_LIFT = 2**24 - 1 - BIG


def _synthetic_level(units, groups, m2, slots, width, rows, kind, seed,
                     device):
    """One level's operands: overlay ids g * m2 + p in ``groups`` groups
    (the sentinel id groups * m2 in the sentinel group, pos 0); ``units``
    table rows (the last all-sentinel), each a run of distinct ids of
    one group, then sentinels (padded slots); closures and lift rows of
    integers with ~20% +inf ("ties": {0, 1, 2}; "large": the four
    largest values up to each part's bound, BIG or BIG_LIFT), the sentinel
    group's +inf; rows finite on valid slots only (~20% +inf, some all
    +inf); units drawn at random.  "large" also plants the sums at the
    bound: the first lift row (row 0) and the first leg query (rows 0
    and rows // 2, as the card test splits them) hold one finite entry
    each, so lift[0, 0] and leg[0] are exactly 2**24 - 1.  "holes" adds
    +inf in every operand position: slots 32-63 of every row wider than
    64 slots (an all-+inf x-tile inside the valid slots of the tiles
    regime), every fifth closure row and seventh column, and every third
    row from rows // 2 + 1 on (whole +inf t-rows of the legs beside
    finite s-rows); its first leg query has both sides in unit 0, so
    some leg is finite at every shape."""
    rng = np.random.default_rng(seed)
    S = groups * m2
    gof = np.concatenate([np.repeat(np.arange(groups), m2), [groups]])
    pof = np.concatenate([np.tile(np.arange(m2), groups), [0]])
    tab = np.full((units, slots), S, np.int64)
    for u in range(units - 1):
        g = u % groups
        k = int(rng.integers(slots // 2, slots + 1))
        tab[u, :k] = g * m2 + rng.choice(m2, k, replace=False)

    def ints(shape, top=BIG):
        lo, hi = (top - 3, top + 1) if kind == "large" else (
            0, 3 if kind == "ties" else 100)
        x = rng.integers(lo, hi, shape).astype(np.float32)
        x[rng.random(shape) < 0.2] = np.inf
        return x
    lift = ints((groups + 1, m2, width), top=BIG_LIFT)
    lift[groups] = np.inf
    clo = ints((groups + 1, m2, m2))
    clo[groups] = np.inf
    unit = rng.integers(0, units, rows)
    row = ints((rows, slots))
    row[tab[unit] == S] = np.inf
    row[5::11] = np.inf
    q = rows // 2
    if kind in ("large", "holes"):
        unit[0] = unit[q] = 0
    if kind == "large":
        row[0] = row[q] = np.inf
        row[0, 0] = row[q, 1] = BIG
        a, b = tab[0, 0], tab[0, 1]
        lift[gof[a], pof[a], 0] = BIG_LIFT
        clo[gof[a], pof[a], pof[b]] = BIG
    if kind == "holes":
        if slots > 64:
            row[:, 32:64] = np.inf
        row[q + 1::3] = np.inf
        for m in (lift, clo):
            m[:, ::5] = np.inf
            m[:, :, ::7] = np.inf
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt).to(device)  # noqa
    return dict(row=as_t(row, torch.float32), unit=as_t(unit, torch.int64),
                tab=as_t(tab, torch.int32), gof=as_t(gof, torch.int32),
                pof=as_t(pof, torch.int32),
                lift=as_t(lift, torch.float32),
                clo=as_t(clo, torch.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2048, 48])
@pytest.mark.parametrize("kind", ["ragged", "ties", "large", "holes"])
@pytest.mark.parametrize("label,units,groups,m2,slots,width", CARD_LEVELS)
def test_kernels_match_plain_on_card(cuda_device, label, units, groups, m2,
                                     slots, width, kind, rows):
    """Lift (both sides' rows at once) and leg == their plain versions at
    each level shape, level 1 in the warp regime, above it in the
    tiles; with "large" operands the planted sums of 2**24 - 1 come out
    exactly."""
    op = _synthetic_level(units, groups, m2, slots, width, rows, kind,
                          seed=rows + slots, device=cuda_device)
    row, unit, tab, gof, pof = (op[k] for k in ("row", "unit", "tab", "gof",
                                                "pof"))
    before = gather_minplus.gather_minplus_cuda.launches
    got = ops.gather_minplus(row, unit, tab, pof, op["lift"], gof=gof)
    assert gather_minplus.gather_minplus_cuda.launches == before + 1
    want = ops.gather_minplus(row, unit, tab, pof, op["lift"], gof=gof,
                              chunk=tde._chunk(row, width), force="ref")
    assert torch.equal(got, want), label
    if kind == "large":
        assert got[0, 0].item() == 2**24 - 1
    q = rows // 2
    args = (row[:q], unit[:q], row[q:], unit[q:], tab, gof, pof, op["clo"])
    got = ops.gather_minplus_twoside(*args)
    want = ops.gather_minplus_twoside(*args, chunk=tde._chunk(row[:q],
                                                              slots),
                                      force="ref")
    assert torch.equal(got, want), label
    assert torch.isfinite(want).any()
    if kind == "large":
        assert got[0].item() == 2**24 - 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1024, 33])
@pytest.mark.parametrize("cols", ["top", "identity"])
def test_resident_lift_kernel_matches_plain_on_card(cuda_device, rows,
                                                    cols):
    """The store with the unit's group (``_lift_res``'s form) == its
    plain version: through a top group's columns (one warp a row), and
    with identity columns over wide rows of an odd width (the tiles,
    with 4-byte copies and stores)."""
    units, slots, width = (130, 64, 1712) if cols == "top" else (7, 440,
                                                                  1071)
    op = _synthetic_level(units, 6, 1024, slots, width, rows, "ragged",
                          seed=rows, device=cuda_device)
    rng = np.random.default_rng(1)
    ugrp = torch.as_tensor(rng.integers(0, 7, units), dtype=torch.int32,
                           device=cuda_device)
    kw = {"ugrp": ugrp}
    if cols == "top":
        kw["ctab"] = torch.as_tensor(
            np.sort(rng.integers(0, width, (4, 592)), 1), dtype=torch.int32,
            device=cuda_device)
        kw["cunit"] = op["unit"] % 4
    args = (op["row"], op["unit"], op["tab"], op["pof"], op["lift"])
    got = ops.gather_minplus(*args, **kw)
    assert torch.equal(got, ops.gather_minplus(*args, **kw, force="ref"))
    assert torch.isfinite(got).any()


@pytest.mark.cuda
def test_planner_launches_the_kernels_on_card(cuda_device):
    """The planner's main path on a 3-level index on the card launches
    both kernels and answers as the CPU does."""
    g = road_like(1400, seed=23)
    ix = build_index(g)
    dix = tde.build_device_index(ix, device=cuda_device, hierarchy_levels=3)
    cpu = tde.build_device_index(ix, device="cpu", hierarchy_levels=3)
    s, t = _pairs(g, cpu, seed=13)
    before = (gather_minplus.gather_minplus_cuda.launches,
              gather_minplus.gather_minplus_twoside_cuda.launches)
    got = QueryPlanner(dix).query(s.numpy(), t.numpy())
    after = (gather_minplus.gather_minplus_cuda.launches,
             gather_minplus.gather_minplus_twoside_cuda.launches)
    assert after[0] > before[0] and after[1] > before[1]
    np.testing.assert_array_equal(got, QueryPlanner(cpu).query(s.numpy(),
                                                               t.numpy()))
