"""The planner's graph path (``QueryPlanner`` over ``core/graphs.py``) on
the CPU.

The CPU has no CUDA graphs: there the planner runs every bucket eagerly
and keeps no graph set.  The planner's side of the graph path (the keys,
the epochs, the fallbacks, the staging, the one wait and the scatter) is
held here against a stand-in ``GraphSet`` whose "graphs" run the captured
program eagerly on their static input at each launch: one graph per
(index object, kind, case, padded size), captured at warm-up, and for a
published epoch at its first batches (the publish captures nothing),
dropped with the epoch; a shape never run before runs eagerly, then is
captured at its next use; a capture counts its kernel wrappers' calls in
its tally, not in their ``.launches``; every batch's answers
and witnesses equal the eager planner's at every case mix, padding
included, with one wait a batch.  The card's side (capture, replay ==
eager, the traced intervals) is ``tests/test_torch_graph_replay_card.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.dist_engine import EpochedEngine, QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.obs import trace

_BUILT: dict = {}


def _engine():
    """road_like(2500, 3) at 3 levels (resident rows: every planner case
    reachable), with the witness programs; its planner runs eagerly (no
    graph stream, whatever a test substitutes)."""
    if "eng" not in _BUILT:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            g = road_like(2500, seed=3)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(graphs, "new_stream", lambda device: None)
                eng = EpochedEngine(g, device="cpu", hierarchy_levels=3,
                                    warm_refresh=False, paths=True)
        finally:
            torch.set_num_threads(threads)
        assert eng.dix.res_rows.shape[0] > 1
        _BUILT["eng"] = (g, eng)
    return _BUILT["eng"]


class _FakeGraph:
    """A bucket "graph" on the CPU: the program, run at each launch on the
    static input, its outputs copied to the host buffers."""

    def __init__(self, fn, dix, size):
        self.fn, self.dix, self.size = fn, dix, size
        self.st = torch.zeros((2, size), dtype=torch.int64)
        self.host_in = torch.zeros((2, size), dtype=torch.int64)
        self.host_in_np = self.host_in.numpy()
        out = fn(dix, self.st[0], self.st[1])
        outs = out if isinstance(out, tuple) else (out,)
        self.host_out_np = tuple(np.empty(tuple(o.shape),
                                          o.numpy().dtype) for o in outs)
        self.inputs = []
        self.spans = []

    def launch(self):
        self.st.copy_(self.host_in)
        self.inputs.append(self.host_in_np.copy())
        out = self.fn(self.dix, self.st[0], self.st[1])
        for h, o in zip(self.host_out_np,
                        out if isinstance(out, tuple) else (out,)):
            h[...] = o.numpy()


class _FakeSet:
    def __init__(self, dix, stream):
        self.dix, self.stream = dix, stream
        self.graphs = {}
        self.waits = 0

    def capture(self, key, fn):
        bg = self.graphs[key] = _FakeGraph(fn, self.dix, key[-1])
        return bg

    def wait(self):
        self.waits += 1


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "new_stream", lambda device: "stream")
    monkeypatch.setattr(graphs, "GraphSet", _FakeSet)


def _planner(dix):
    return QueryPlanner(dix, paths=True)


def _graphs(pl, dix=None) -> dict:
    """{(kind, case, size): graph} of ``dix``'s epoch (default: the
    planner's current one); empty where it has no graph set."""
    gs = pl._graph_set(pl.dix if dix is None else dix)
    return {} if gs is None else gs.graphs


def _mix(planner, s, t, cases, n):
    """n pairs of ``s``/``t`` whose planner case is in ``cases``."""
    plan = planner.plan(s, t)
    idx = np.sort(np.concatenate([plan[c] for c in cases]))
    assert idx.size >= n, (cases, idx.size)
    return s[idx[:n]], t[idx[:n]]


def _pool(g, seed=0, n=20000):
    """Pairs covering every case: uniform ones, and pairs of nearby node
    ids (same DRA and fragment)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, g.n, n)
    t = np.concatenate([rng.integers(0, g.n, n // 2),
                        np.clip(s[n // 2:] + rng.integers(-3, 4, n - n // 2),
                                0, g.n - 1)])
    return s, t


def test_cpu_runs_every_bucket_eagerly():
    g, eng = _engine()
    pl = _planner(eng.dix)
    pl.warmup(64)
    s, t = _pool(g)
    pl.query(s[:100], t[:100])
    assert _graphs(pl) == {}
    assert pl.graph_counts["replay"] == pl.graph_counts["captured"] == 0
    assert pl.graph_counts["eager"] == sum(
        1 for ix in pl.last_counts.values() if ix)


def test_graphs_keyed_by_index_kind_case_size(fake_graphs):
    _g, eng = _engine()
    pl = _planner(eng.dix)
    assert _graphs(pl) == {}
    pl.warmup(100)
    sizes = pl.bucket_sizes(100)
    assert sizes == [16, 32, 64, 128]
    want = {(kind, case, m) for kind in ("d", "w")
            for case in QueryPlanner.CASES for m in sizes}
    assert set(_graphs(pl)) == want
    assert pl.graph_counts["captured"] == len(want)
    for (kind, case, m), bg in _graphs(pl).items():
        assert bg.size == m and bg.dix is eng.dix
        fns = pl._fns if kind == "d" else pl._wfns
        assert bg.fn is fns[case]
    # another index object, even one holding the same tensors, has none
    twin = dataclasses.replace(eng.dix)
    assert _graphs(pl, twin) == {}


def test_set_index_captures_the_new_epoch_and_drops_the_old(fake_graphs):
    g, eng = _engine()
    pl = _planner(eng.dix)
    pl.warmup(64)
    old = _graphs(pl)
    new = dataclasses.replace(eng.dix)
    pl.set_index(new)
    assert _graphs(pl, eng.dix) == {}
    # the publish captures nothing: the first batch of the new epoch
    # captures the keys it uses, the next one replays them
    assert _graphs(pl) == {}
    assert pl.graph_counts["captured"] == len(old)
    s, t = _pool(g)
    s, t = s[:60], t[:60]
    want = eng.planner.query(s, t)
    np.testing.assert_array_equal(pl.query(s, t), want)
    used = {("d", c, pl.bucket_sizes(n)[-1])
            for c, n in pl.last_counts.items() if n}
    assert set(_graphs(pl)) == used and used <= set(old)
    assert pl.graph_counts["captured"] == len(old) + len(used)
    assert pl.graph_counts["capture"] == len(used)
    assert all(bg.dix is new and bg is not old[k]
               for k, bg in _graphs(pl).items())
    np.testing.assert_array_equal(pl.query(s, t), want)
    assert pl.graph_counts["replay"] == len(used)
    # a call pinned to the old epoch runs eagerly, with the same answers
    before = dict(pl.graph_counts)
    got = pl.query(s, t, dix=eng.dix)
    assert pl.graph_counts["replay"] == before["replay"]
    assert pl.graph_counts["eager"] > before["eager"]
    np.testing.assert_array_equal(got, want)
    assert sum(len(bg.inputs) for bg in old.values()) == 0


def test_unseen_size_runs_eagerly_then_is_captured(fake_graphs):
    g, eng = _engine()
    pl = _planner(eng.dix)
    pl.warmup(32)
    s, t = _mix(pl, *_pool(g), ("cross_frag",), 200)   # a bucket of 256
    ref = eng.planner.query(s, t)
    tr = trace.get_tracer()
    tr.clear()
    tr.enable()
    try:
        for _ in range(3):
            np.testing.assert_array_equal(pl.query(s, t), ref)
        evs = tr.drain()
    finally:
        tr.enable(False)
        tr.clear()
    tags = [e["args"]["graph"] for e in evs if e["name"] == "planner.bucket"]
    assert tags == ["eager", "capture", "replay"]
    assert ("d", "cross_frag", 256) in _graphs(pl)
    # one wait a replayed batch, after its buckets; none for the first
    waits = [e for e in evs if e["name"] == "planner.readback"]
    assert len(waits) == 3
    batches = {e["args"]["batch"] for e in evs if e["name"] == "serve.batch"}
    assert len(batches) == 3


MIXES = {"same_dra": ("same_dra",), "same_frag": ("same_frag",),
         "cross_frag": ("cross_frag",), "cross_res": ("cross_res",),
         "all": QueryPlanner.CASES}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("n", [1, 37, 100])
def test_replayed_batch_equals_eager(fake_graphs, mix, n):
    g, eng = _engine()
    pl = _planner(eng.dix)
    pl.warmup(128)
    s, t = _mix(pl, *_pool(g, seed=n), MIXES[mix], n)
    if mix == "all":
        # at least one query of every case
        s = np.concatenate([_mix(pl, *_pool(g), (c,), 1)[0]
                            for c in QueryPlanner.CASES] + [s])
        t = np.concatenate([_mix(pl, *_pool(g), (c,), 1)[1]
                            for c in QueryPlanner.CASES] + [t])
    eager = eng.planner                 # built on the CPU: no graphs
    np.testing.assert_array_equal(pl.query(s, t), eager.query(s, t))
    dist, wit = pl.query_witness(s, t)
    want_d, want_w = eager.query_witness(s, t)
    np.testing.assert_array_equal(dist, want_d)
    np.testing.assert_array_equal(wit, want_w)
    buckets = sum(1 for c in pl.last_counts.values() if c)
    assert pl.graph_counts["replay"] == 2 * buckets
    assert pl.graph_counts["eager"] == 0
    gs = pl._graph_set(eng.dix)
    assert gs.waits == 2
    # each launch saw its bucket's real pairs, then (0, 0) pads
    plan = pl.plan(s, t)
    for case, idx in plan.items():
        if idx.size == 0:
            continue
        m = pl.bucket_sizes(idx.size)[-1]
        for kind in ("d", "w"):
            seen = _graphs(pl)[(kind, case, m)].inputs[-1]
            np.testing.assert_array_equal(seen[0, :idx.size], s[idx])
            np.testing.assert_array_equal(seen[1, :idx.size], t[idx])
            assert not seen[:, idx.size:].any()


def test_busy_graph_lock_runs_the_batch_eagerly(fake_graphs):
    g, eng = _engine()
    pl = _planner(eng.dix)
    pl.warmup(64)
    s, t = _pool(g)
    s, t = s[:50], t[:50]
    want = pl.query(s, t)
    with pl._graph_lock:
        before = dict(pl.graph_counts)
        np.testing.assert_array_equal(pl.query(s, t), want)
    assert pl.graph_counts["replay"] == before["replay"]
    assert pl.graph_counts["eager"] > before["eager"]


def test_tracer_capture_mode():
    """While a thread captures, device spans on the CPU and host spans
    record nothing, and ``recording()`` stays False."""
    trace.get_tracer().clear()
    assert not trace.recording()
    with trace.capture() as spans:
        assert not trace.recording()
        with trace.span("serve.lift", device=torch.device("cpu"),
                        level=1) as sp:
            assert sp is trace._NULL_SPAN
        with trace.span("planner.plan") as sp:
            assert sp is trace._NULL_SPAN
    assert spans == []
    assert not trace.recording()
    assert trace.get_tracer().events() == []


def test_launch_tally_takes_a_capturing_threads_counts():
    """While a thread's tally is open, a kernel wrapper's launch counts
    there and not in its ``.launches``; other threads count as ever."""
    import threading

    from repro_torch.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0
    into: dict = {}
    _build.tally(into)
    try:
        _build.count_launch(wrapper)
        _build.count_launch(wrapper)
        other = threading.Thread(target=_build.count_launch,
                                 args=(wrapper,))
        other.start()
        other.join()
    finally:
        _build.tally(None)
    assert into == {wrapper: 2}
    assert wrapper.launches == 1
    _build.count_launch(wrapper)
    assert wrapper.launches == 2 and into == {wrapper: 2}
