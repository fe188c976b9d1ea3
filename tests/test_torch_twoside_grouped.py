"""The grouped twoside contraction (kernel 2's redesign) against the
reference package.

``ops.minplus_twoside_grouped`` contracts compact boundary rows through
their id tables:

    out[q] = min_{i,j} row_s[q,i] + d[tab_s[gs[q],i], tab_t[gt[q],j]]
                       + row_t[q,j]

Its plain version (scatter each row at its ids, then the dense
contraction) is held, on the operands the serve path really hands it
(captured from the port's planner on road_like(900) at one level and
road_like(1400, seed 23) at three, both buckets of the hierarchical
combine included), against three references: scatter + the dense plain
contraction, the reference package's compact ``_top_mid_gather`` and its
Pallas ``minplus_twoside`` in interpret mode on the scattered rows.
Synthetic operands add sentinel ids, duplicate ids, all-+inf rows,
tie-heavy values, ms != mt and one table row against many.  The plain
models of the CUDA kernel's two regimes (one warp per query; ordered
64-query tiles cut into segments of equal table pairs, x splits and the
finish) equal the plain version.  In the "scatter" layout the three
distance call sites reach the grouped op and never scatter.  Integer
weights keep every sum below 2**24, so every comparison is exact
(``assert_array_equal``).  The reference package is imported through a
fixture, so the kernel's tests, which run on the card only (``cuda``),
also run on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_twoside_grouped.py
"""
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra
from repro_torch.core.dist_engine import QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.core.supergraph import build_index
from repro_torch.kernels import minplus_twoside, ops, ref

# small tensors: one thread each, so the suite's parallel workers do not
# oversubscribe the CPU
torch.set_num_threads(1)

#: (label, nodes, seed, levels): the dense index and the verify recipe's
#: real 3-level hierarchy at CPU size (with resident rows)
GRAPHS = {"level1": (900, 0, 1), "level3": (1400, 23, 3)}
#: the call sites of each graph's scatter layout
SITES = {"level1": ("_combine_mid",),
         "level3": ("_combine_mid_h", "serve_cross_res")}
_WORLD: dict = {}


@pytest.fixture(scope="module")
def J():
    """The reference package: its device engine and kernel layer."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import device_engine as jde
    from repro.kernels import ops as jops
    return SimpleNamespace(jnp=jnp, jde=jde, jops=jops)


def _pairs(g, dix, seed=0, n_random=160):
    """Random pairs plus, where the index has resident rows, pairs with
    both ends resident in different top groups (the cross_res bucket)."""
    rng = np.random.default_rng(seed)
    s = list(rng.integers(0, g.n, n_random))
    t = list(rng.integers(0, g.n, n_random))
    rf, tg = dix.host_res_frag, dix.host_topgrp_frag
    if rf is not None:
        fa = dix.frag_of.numpy()[dix.agent_of.numpy()]
        hot = np.nonzero((fa >= 0) & (rf[np.maximum(fa, 0)] >= 0))[0]
        for v in hot[:: max(1, hot.size // 24)]:
            far = hot[tg[fa[hot]] != tg[fa[v]]]
            if far.size:
                s.append(v)
                t.append(far[rng.integers(0, far.size)])
    return np.asarray(s, np.int64), np.asarray(t, np.int64)


def _world(label):
    """(graph, index, pairs, captured calls): every call the scatter
    layout's planner makes to ``ops.minplus_twoside_grouped``, as
    (call site, operands), built once per test process."""
    if label not in _WORLD:
        n, seed, lv = GRAPHS[label]
        g = road_like(n, seed=seed)
        dix = tde.build_device_index(build_index(g), device="cpu",
                                     hierarchy_levels=lv)
        s, t = _pairs(g, dix)
        calls = []
        real = ops.minplus_twoside_grouped

        def record(*args, force=None):
            calls.append((sys._getframe(1).f_code.co_name,
                          tuple(a.clone() for a in args)))
            return real(*args, force=force)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "minplus_twoside_grouped", record)
            QueryPlanner(dix, layout="scatter").query(s, t)
        _WORLD[label] = (g, dix, s, t, calls)
    return _WORLD[label]


def _site_calls(label, site):
    calls = [args for name, args in _world(label)[4] if name == site]
    assert calls, (label, site)
    return calls


def _scattered(args):
    """(rows, d, rowt) of the dense form: each side scattered at its ids."""
    row_s, gs, tab_s, d, row_t, gt, tab_t = args
    return (ref.scatter_rows(row_s, tab_s[gs.long()], d.shape[0]), d,
            ref.scatter_rows(row_t, tab_t[gt.long()], d.shape[1]))


def _brute(args):
    """numpy over the whole gathered [q, ms, mt] block."""
    row_s, gs, tab_s, d, row_t, gt, tab_t = (a.numpy() for a in args)
    ids_s, ids_t = tab_s[gs], tab_t[gt]
    blk = d[ids_s[:, :, None], ids_t[:, None, :]]
    return np.min(row_s[:, :, None] + blk + row_t[:, None, :], axis=(1, 2))


def _reference(J, kind, args):
    """One of the three references of the plain grouped version."""
    if kind == "scatter":
        return ref.minplus_twoside_ref(*_scattered(args)).numpy()
    row_s, gs, tab_s, d, row_t, gt, tab_t = (a.numpy() for a in args)
    jnp = J.jnp
    if kind == "jax_gather":
        return np.asarray(J.jde._top_mid_gather(
            SimpleNamespace(d2=jnp.asarray(d)), jnp.asarray(row_s),
            jnp.asarray(tab_s[gs]), jnp.asarray(row_t),
            jnp.asarray(tab_t[gt])))
    rows, _d, rowt = (x.numpy() for x in _scattered(args))
    return np.asarray(J.jops.minplus_twoside(
        jnp.asarray(rows), jnp.asarray(d), jnp.asarray(rowt),
        force="pallas"))


CAPTURED = [(label, site) for label in GRAPHS for site in SITES[label]]


@pytest.mark.parametrize("label", list(GRAPHS))
def test_capture_reaches_every_scatter_call_site(label):
    """The planner's scatter layout hands the grouped op compact rows at
    each call site of the graph: table rows narrower than the closure."""
    names = {name for name, _args in _world(label)[4]}
    assert names == set(SITES[label]), names
    for _name, (row_s, gs, tab_s, d, row_t, gt, tab_t) in _world(label)[4]:
        assert row_s.shape[1] == tab_s.shape[1] < d.shape[0]
        assert row_t.shape[1] == tab_t.shape[1] < d.shape[1]
        assert gs.dtype == gt.dtype == torch.int64
        assert tab_s.dtype == tab_t.dtype == torch.int32
        assert torch.isfinite(row_s).any()


@pytest.mark.parametrize("kind", ["scatter", "jax_gather", "jax_pallas"])
@pytest.mark.parametrize("label,site", CAPTURED)
def test_plain_grouped_matches_references_on_serve_operands(J, label, site,
                                                            kind):
    for args in _site_calls(label, site):
        got = ops.minplus_twoside_grouped(*args).numpy()
        np.testing.assert_array_equal(got, _reference(J, kind, args))


@pytest.mark.parametrize("label,site", CAPTURED)
def test_kernel_models_match_plain_on_serve_operands(label, site):
    for args in _site_calls(label, site):
        want = ref.minplus_twoside_grouped_ref(*args)
        assert torch.equal(ref.minplus_twoside_grouped_warp_ref(*args), want)
        for splits in (1, 3):
            assert torch.equal(ref.minplus_twoside_grouped_split_ref(
                *args, splits=splits), want)


def _synthetic(kind):
    """Grouped operands on a [150, 170] closure whose last row and column
    are +inf (the sentinel ids): "ragged" integers with ~20% +inf,
    "sentinel" table rows padded with sentinel ids under finite row
    entries, "duplicates" ids from a range of 7, "all_inf" some
    all-+inf rows on either side, "ties" values from {0, 1, 2}, "ms_ne_mt"
    rows of 100 against 33 entries, "one_vs_many" one source table row
    against a table row per query, "wide" 150-entry rows over several
    x and y tiles, "per_query_wide" 100-entry rows with a table row per
    query (the warp regime past 64 entries).  Two more, on the card only,
    both with the "wide" rows (the tiles regime): "large" the three largest
    values up to BIG in every operand, so a sum of the three terms
    reaches 3 * BIG == 2**24 - 1, the integer invariant's bound, which
    query 0 gets exactly (one finite entry a side, their cell BIG);
    "holes" +inf in every operand position: entries 32-63 and 128-149 of
    every s-row (all-+inf x-tiles inside the row and at its ragged end),
    every third t-row whole (+inf beside a finite min over the s-side),
    every fifth row and seventh column of d."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    k1, k2, q = 150, 170, 150
    ms, mt, ns, nt = 40, 40, 5, 4
    if kind == "ms_ne_mt":
        ms, mt = 100, 33
    if kind in ("wide", "large", "holes"):
        ms, mt = 150, 150
    if kind == "one_vs_many":
        ns, nt, ms, mt = 1, q, 80, 24
    if kind == "per_query_wide":
        ns, nt, ms, mt = q, q, 100, 100
    lo, hi = (BIG - 2, BIG + 1) if kind == "large" else (
        0, 3 if kind == "ties" else 100)
    frac = 0.0 if kind == "ties" else 0.2

    def ints(shape):
        x = rng.integers(lo, hi, size=shape).astype(np.float32)
        x[rng.random(shape) < frac] = np.inf
        return x
    d = ints((k1, k2))
    d[k1 - 1], d[:, k2 - 1] = np.inf, np.inf
    top = 7 if kind == "duplicates" else None
    tab_s = rng.integers(0, top or k1 - 1, (ns, ms)).astype(np.int32)
    tab_t = rng.integers(0, top or k2 - 1, (nt, mt)).astype(np.int32)
    if kind == "sentinel":
        tab_s[:, ms // 2:], tab_t[:, mt // 3:] = k1 - 1, k2 - 1
    row_s, row_t = ints((q, ms)), ints((q, mt))
    if kind == "all_inf":
        row_s[::3], row_t[1::4] = np.inf, np.inf
    gs = np.arange(q) if kind == "per_query_wide" else rng.integers(0, ns, q)
    gt = (np.arange(q) if kind in ("one_vs_many", "per_query_wide")
          else rng.integers(0, nt, q))
    if kind == "large":
        row_s[0], row_t[0] = np.inf, np.inf
        row_s[0, 0], row_t[0, 0] = BIG, BIG
        d[tab_s[gs[0], 0], tab_t[gt[0], 0]] = BIG
    if kind == "holes":
        row_s[:, 32:64], row_s[:, 128:], row_t[::3] = np.inf, np.inf, np.inf
        d[::5], d[:, ::7] = np.inf, np.inf
    return tuple(torch.from_numpy(x) for x in (
        row_s, gs.astype(np.int64), tab_s, d, row_t, gt.astype(np.int64),
        tab_t))


SYNTHETIC = ["ragged", "sentinel", "duplicates", "all_inf", "ties",
             "ms_ne_mt", "one_vs_many", "wide", "per_query_wide"]
#: the largest finite entry of the "large" operands: three terms reach
#: 3 * BIG == 2**24 - 1
BIG = (2**24 - 1) // 3


@pytest.mark.parametrize("kind", ["scatter", "jax_gather", "jax_pallas"])
@pytest.mark.parametrize("case", SYNTHETIC)
def test_plain_grouped_matches_references_on_edge_operands(J, case, kind):
    args = _synthetic(case)
    got = ops.minplus_twoside_grouped(*args).numpy()
    np.testing.assert_array_equal(got, _reference(J, kind, args))
    np.testing.assert_array_equal(got, _brute(args))
    if case == "all_inf":
        assert np.isinf(got[::3]).all() and np.isfinite(got).any()


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("case", SYNTHETIC)
def test_kernel_models_match_plain_on_edge_operands(case, splits):
    """The tiles schedule (queries grouped by table pair, segments of
    equal pairs per 64-query tile, x splits, the finish) and the warp
    regime equal the plain version; so does the tiles schedule on 8-query
    tiles, where nearly every tile holds several segments, grouped or in
    the given order."""
    args = _synthetic(case)
    want = ref.minplus_twoside_grouped_ref(*args)
    assert torch.equal(ref.minplus_twoside_grouped_split_ref(
        *args, splits=splits), want)
    assert torch.equal(ref.minplus_twoside_grouped_split_ref(
        *args, splits=splits, q_tile=8, y_tile=16, x_tile=8), want)
    assert torch.equal(ref.minplus_twoside_grouped_split_ref(
        *args, splits=splits, order=False, q_tile=8), want)
    assert torch.equal(ref.minplus_twoside_grouped_warp_ref(*args), want)


def test_identity_tables_give_the_dense_contraction():
    """One table row of identity ids is the dense contraction, which
    ``ops.minplus_twoside`` computes."""
    rng = np.random.default_rng(4)
    q, k1, k2 = 37, 90, 70
    rows, d, rowt = (torch.from_numpy(x) for x in (
        rng.integers(0, 50, s).astype(np.float32)
        for s in ((q, k1), (k1, k2), (q, k2))))
    rows[rows > 40] = float("inf")
    zero = torch.zeros(q, dtype=torch.int64)
    args = (rows, zero, torch.arange(k1, dtype=torch.int32)[None], d, rowt,
            zero, torch.arange(k2, dtype=torch.int32)[None])
    want = ops.minplus_twoside(rows, d, rowt)
    assert torch.equal(ops.minplus_twoside_grouped(*args), want)
    assert torch.equal(ref.minplus_twoside_grouped_split_ref(
        *args, splits=2), want)


@pytest.mark.parametrize("q,ms,mt,ns,nt,want", [
    (1024, 32, 32, 1024, 1024, ("warp", False, 1)),
    (1024, 64, 64, 1024, 1024, ("warp", False, 1)),
    (1024, 592, 592, 4, 4, ("tiles", True, 7)),
    (16, 592, 592, 4, 4, ("tiles", True, 19)),
    (1024, 4614, 4614, 1, 1, ("tiles", False, 1)),
    (16, 480, 480, 1, 1, ("tiles", False, 15)),
    (300, 65, 10, 1, 7, ("tiles", True, 3)),
    (1024, 100, 100, 1024, 1024, ("warp", False, 1)),
    (64, 100, 100, 64, 64, ("warp", False, 1)),
    (8192, 592, 592, 80, 80, ("warp", False, 1)),
    (8192, 592, 592, 64, 64, ("tiles", True, 1)),
])
def test_grouped_plan_picks_regime_from_shapes(q, ms, mt, ns, nt, want):
    """Rows of at most WARP_MAX entries, and rows with more table pairs
    than queries or than ORDER_KEYS (a table row per query), take one
    warp per query (no order); other wider rows take the tiles, grouped
    by table pair when there are 2 or more pairs, x split until the grid
    holds about GROUPED_BLOCKS blocks, never into an empty run."""
    got = minplus_twoside.grouped_plan(q, ms, mt, ns, nt)
    assert got == want
    if got[0] == "tiles":
        tiles = -(-mt // 64) * -(-q // 64)
        xt = -(-ms // 32)
        k = min(xt, -(-minplus_twoside.GROUPED_BLOCKS // tiles))
        per = -(-xt // got[2])
        assert per == -(-xt // k) and (got[2] - 1) * per < xt


@pytest.mark.parametrize("label", list(GRAPHS))
def test_scatter_layout_contracts_compact_rows_without_scattering(label):
    """In the "scatter" layout every distance call site reaches
    ``ops.minplus_twoside_grouped`` and none scatters a row
    (``_scatter_rows`` forbidden); the answers equal those of the old
    scatter + dense path, the gather layout and Dijkstra."""
    g, dix, s, t, _calls = _world(label)

    def forbidden(*_a, **_k):
        raise AssertionError("a distance program scattered its rows")

    def old_path(row_s, gs, tab_s, d, row_t, gt, tab_t, force=None):
        return ops.minplus_twoside(*_scattered(
            (row_s, gs, tab_s, d, row_t, gt, tab_t)), force=force)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "minplus_twoside_grouped", old_path)
        before = QueryPlanner(dix, layout="scatter").query(s, t)
    sites = []
    real = ops.minplus_twoside_grouped

    def counted(*args, force=None):
        sites.append(sys._getframe(1).f_code.co_name)
        return real(*args, force=force)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tde, "_scatter_rows", forbidden)
        mp.setattr(tde, "_scatter_top", forbidden)
        mp.setattr(ops, "minplus_twoside_grouped", counted)
        planner = QueryPlanner(dix, layout="scatter")
        after = planner.query(s, t)
        counts = dict(planner.last_counts)
    assert set(sites) == set(SITES[label]), sites
    if label == "level3":
        assert counts["cross_res"] > 0, counts
    np.testing.assert_array_equal(after, before)
    np.testing.assert_array_equal(
        after, QueryPlanner(dix, layout="gather").query(s, t))
    oracle = np.array([dijkstra.pair(g, int(a), int(b))
                       for a, b in zip(s[:48], t[:48])], np.float32)
    np.testing.assert_array_equal(after[:48], oracle)


def test_witness_programs_keep_the_argmin_on_scattered_rows():
    """The witness programs are unchanged: they scatter and run
    ``ops.minplus_twoside_argmin``, never the grouped op."""
    _g, dix, s, t, _calls = _world("level3")
    seen = []
    real = ops.minplus_twoside_argmin

    def counted(*args, force=None):
        seen.append(args[0].shape[1])
        return real(*args, force=force)

    def forbidden(*_a, **_k):
        raise AssertionError("a witness program ran the grouped op")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "minplus_twoside_argmin", counted)
        mp.setattr(ops, "minplus_twoside_grouped", forbidden)
        QueryPlanner(dix, layout="scatter", paths=True).query_witness(
            s[:64], t[:64])
    assert seen and all(w == dix.d2.shape[0] for w in seen)


def test_grouped_wrapper_refuses_cpu_tensors():
    args = _synthetic("ragged")
    before = minplus_twoside.minplus_twoside_grouped_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        minplus_twoside.minplus_twoside_grouped_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ops.minplus_twoside_grouped(*args, force="kernel")
    assert minplus_twoside.minplus_twoside_grouped_cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SYNTHETIC + ["large", "holes"])
def test_grouped_kernel_matches_plain_on_card(cuda_device, case):
    """Both regimes (rows of 40 entries, or a table row per query: one
    warp per query; wider shared rows: the sorted tiles) array-equal to
    the plain version; with "large" operands query 0's sum of 2**24 - 1
    comes out exactly."""
    args = [a.to(cuda_device) for a in _synthetic(case)]
    before = minplus_twoside.minplus_twoside_grouped_cuda.launches
    got = minplus_twoside.minplus_twoside_grouped_cuda(*args)
    assert minplus_twoside.minplus_twoside_grouped_cuda.launches == before + 1
    assert torch.equal(got, ops.minplus_twoside_grouped(*args, force="ref"))
    assert torch.isfinite(got).any()
    if case == "large":
        assert got[0].item() == 2**24 - 1


@pytest.mark.cuda
@pytest.mark.parametrize("q,k1,k2", [(5, 7, 3), (37, 130, 201),
                                     (1024, 480, 480), (16, 1712, 1712)])
def test_identity_tables_kernel_matches_plain_on_card(cuda_device, q, k1,
                                                      k2):
    """``minplus_twoside_cuda`` (the grouped kernel with identity tables)
    equals the plain dense contraction."""
    rng = np.random.default_rng(q + k1 + k2)
    args = [torch.from_numpy(rng.integers(0, 100, s).astype(np.float32))
            .to(cuda_device) for s in ((q, k1), (k1, k2), (q, k2))]
    want = ops.minplus_twoside(*args, force="ref")
    assert torch.equal(minplus_twoside.minplus_twoside_cuda(*args), want)
