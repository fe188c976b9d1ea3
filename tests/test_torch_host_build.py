"""The port's host build (numpy copies) against the reference package's.

Same graphs in both, every index table array-equal: the DislandIndex
(DRAs, shrink graph, partition, fragments, covers, SUPER graph) and the
device BuildPlan assembled from it.  The parallel build (covers in a
spawned process pool over a shared CSR) equals the serial one and the
reference's, streams its structural index before the covers land, and
fails with the original exception and no orphaned worker.
"""
import dataclasses
import multiprocessing
import os

import numpy as np
import pytest

from repro.core import device_engine as jde
from repro.core import graph as jgraph
from repro.core import padding as jpadding
from repro.core.supergraph import build_index as jbuild_index
from repro.core.supergraph import index_arrays_equal
from repro.data import roads as jroads
from repro_torch.core import device_engine as tde
from repro_torch.core import graph as tgraph
from repro_torch.core import landmarks as tlandmarks
from repro_torch.core import padding as tpadding
from repro_torch.core import supergraph as tsupergraph
from repro_torch.core.supergraph import build_index as tbuild_index
from repro_torch.data import roads as troads

GRAPHS = {
    "road_like_900": lambda: jgraph.road_like(900, seed=0),
    "random_graph": lambda: jgraph.random_graph(300, 700, seed=4),
    "tree_with_blobs": lambda: jgraph.tree_with_blobs(12, 6, seed=2),
}


def _port_graph(g) -> tgraph.Graph:
    return tgraph.Graph(**{f.name: getattr(g, f.name)
                           for f in dataclasses.fields(g)})


def _graph_arrays(g):
    return [g.n] + [getattr(g, f) for f in ("indptr", "indices", "weights",
                                            "edge_u", "edge_v", "edge_w")]


@pytest.mark.parametrize("n,seed", [(900, 0), (2500, 3)])
def test_road_like_matches_reference(n, seed):
    for a, b in zip(_graph_arrays(tgraph.road_like(n, seed=seed)),
                    _graph_arrays(jgraph.road_like(n, seed=seed))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_index_matches_reference(name):
    g = GRAPHS[name]()
    jix = jbuild_index(g)
    tix = tbuild_index(_port_graph(g))
    eq = index_arrays_equal(tix, jix)
    assert all(eq.values()), {k: v for k, v in eq.items() if not v}
    assert sorted(tix.timings) == sorted(jix.timings)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_plan_matches_reference(name):
    g = GRAPHS[name]()
    jplan = jde.make_build_plan(jbuild_index(g))
    tplan = tde.make_build_plan(tbuild_index(_port_graph(g)))
    for f in dataclasses.fields(tplan):
        a, b = getattr(tplan, f.name), getattr(jplan, f.name)
        if f.name == "piece_members":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif f.name != "build_timings":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
    jde.super_weights(jplan, jplan.frag_adj)
    tde.super_weights(tplan, tplan.frag_adj)
    np.testing.assert_array_equal(tplan.sup_w, jplan.sup_w)
    np.testing.assert_array_equal(tde.super_overlay(tplan),
                                  np.asarray(jde.super_overlay(jplan)))
    np.testing.assert_array_equal(tde.overlay_slot_table(tplan),
                                  jde.overlay_slot_table(jplan))
    np.testing.assert_array_equal(
        np.stack(tde._node_piece_addressing(tplan)),
        np.stack(jde._node_piece_addressing(jplan)))


@pytest.mark.parametrize("x", [0, 1, 7, 8, 9, 100, 1023, 1025])
def test_padding_rules_match_reference(x):
    assert tpadding.pad_to(x) == jpadding.pad_to(x)
    assert tpadding.pow2(x, 8) == jpadding.pow2(x, 8)
    assert tpadding.pad_pow2(x) == jpadding.pad_pow2(x)


def test_presets_match_reference_but_road64k_closes_densely():
    """Every preset equals the reference's, hierarchy included: road64k
    no longer closes densely now that the hierarchy is ported (the name
    is kept from the slice that pinned it to one level)."""
    assert sorted(troads.ROAD_PRESETS) == sorted(jroads.ROAD_PRESETS)
    for name, p in troads.ROAD_PRESETS.items():
        q = jroads.ROAD_PRESETS[name]
        assert (p.nodes, p.seed, p.hierarchy) == (q.nodes, q.seed,
                                                  q.hierarchy), name
    assert troads.road_preset("road64k").hierarchy == 3
    with pytest.raises(ValueError, match="unknown road preset"):
        troads.road_preset("road1")


@pytest.mark.parametrize("S,levels", [(0, "auto"), (500, "auto"),
                                      (5000, "auto"), (5000, 1),
                                      (5000, 3), (0, 2)])
def test_resolve_hierarchy_levels_matches_reference(S, levels):
    assert (tde.resolve_hierarchy_levels(S, levels)
            == jde.resolve_hierarchy_levels(S, levels))


# ---------------------------------------------------------------------------
# the parallel host build: workers == serial == the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("name", ["road_like_900", "random_graph"])
def test_parallel_build_equals_serial_and_reference(name, workers):
    g = GRAPHS[name]()
    tg = _port_graph(g)
    par = tbuild_index(tg, build_workers=workers)
    for other in (tbuild_index(tg), jbuild_index(g)):
        eq = index_arrays_equal(par, other)
        assert all(eq.values()), {k: v for k, v in eq.items() if not v}
    assert sorted(par.timings) == sorted(jbuild_index(g).timings)


@pytest.mark.parametrize("workers", [1, 2])
def test_streaming_handoff_fills_index_in_place(workers):
    """start_build exposes a structurally complete index before the
    covers land; finish fills the same object in place, idempotently,
    equal to the one-shot build."""
    g = tgraph.road_like(1000, seed=1)
    hb = tsupergraph.start_build(g, build_workers=workers)
    six = hb.structural_index()
    assert six.super_graph is None
    assert six.fragments and all(f.cover is None for f in six.fragments)
    ix = hb.finish()
    assert ix is six and ix.super_graph is not None
    assert all(f.cover is not None for f in ix.fragments)
    assert "hybrid_covers" in ix.timings
    assert hb.finish() is ix
    eq = index_arrays_equal(ix, tbuild_index(g))
    assert all(eq.values())


class _InjectedCoverFailure(RuntimeError):
    pass


def _boom_cover(fg, boundary_local, use_cost_model):
    # every fragment with a real boundary fails, so the first completed
    # future raises whatever the scheduling order
    if boundary_local.size >= 2:
        raise _InjectedCoverFailure(
            f"injected cover failure ({boundary_local.size} boundary)")
    return tlandmarks.hybrid_cover(fg, boundary_local, use_cost_model)


def _own_shm_blocks():
    """This process's shared-memory blocks (the port names them by pid,
    so blocks of other test workers never count)."""
    prefix = tgraph.shared_block_prefix()
    try:
        return {f for f in os.listdir("/dev/shm") if f.startswith(prefix)}
    except FileNotFoundError:
        return set()


@pytest.mark.parametrize("workers", [1, 4])
def test_failed_cover_surfaces_original_exception(workers):
    """A raising fragment cover fails the build with the original
    exception, the pool reaped (no live child process) and the shared
    block released, for the serial and the pool routes."""
    g = tgraph.road_like(1000, seed=2)
    assert _own_shm_blocks() == set()
    with pytest.raises(_InjectedCoverFailure, match="injected"):
        tbuild_index(g, build_workers=workers, cover_fn=_boom_cover)
    assert _own_shm_blocks() == set()
    assert multiprocessing.active_children() == []


def test_shared_graph_round_trip():
    """to_shared/from_shared: read-only zero-copy views equal to the
    source arrays, supporting the worker-side re-extraction."""
    g = _port_graph(jgraph.random_graph(40, 60, seed=3))
    handle = g.to_shared()
    assert _own_shm_blocks() == {handle.shm.name.lstrip("/")}
    try:
        attached = tgraph.Graph.from_shared(handle.meta)
        try:
            sg = attached.graph
            for a, b in zip(_graph_arrays(sg), _graph_arrays(g)):
                np.testing.assert_array_equal(a, b)
            assert not sg.indices.flags.writeable
            with pytest.raises(ValueError):
                sg.edge_w[0] = 99.0
            nodes = np.arange(0, g.n, 2, dtype=np.int32)
            for a, b in zip(_graph_arrays(g.subgraph(nodes)[0]),
                            _graph_arrays(sg.subgraph(nodes)[0])):
                np.testing.assert_array_equal(a, b)
        finally:
            attached.close()
    finally:
        handle.close()
        handle.unlink()
    assert _own_shm_blocks() == set()
