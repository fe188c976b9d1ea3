"""The port's tracer (``repro_torch.obs.trace``) and its spans inside the
serving path, on the CPU.

The tracer records while ``enabled`` is set and while a torch.profiler
session runs; its events carry the thread's native id; a ``scope`` tags
the spans nested in it.  On a 3-level index (``road_like(2500, 3)``,
whose resident rows make every planner bucket reachable) one batch gives
one ``serve.batch``, one ``planner.bucket`` per non-empty case and lift
and leg spans at every level, all on one ``batch`` id; answers and paths
are the same with the tracer on and off; ``paths.unwind`` counts the
unwinder's one read of the card a level pass, its passes and its route
decisions.  The build keeps one span per
group closure (``build.sf_stage``).
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import paths as tpaths
from repro_torch.core.dist_engine import EpochedEngine, _pad_pow2
from repro_torch.core.graph import road_like
from repro_torch.obs import trace

_BUILT: dict = {}


def _engine():
    if "eng" not in _BUILT:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            g = road_like(2500, seed=3)
            eng = EpochedEngine(g, device="cpu", hierarchy_levels=3,
                                warm_refresh=False, paths=True)
        finally:
            torch.set_num_threads(threads)
        _BUILT["eng"] = (g, eng)
    return _BUILT["eng"]


def _pairs(g, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, g.n, n), rng.integers(0, g.n, n)


@pytest.fixture
def tracer():
    """The default tracer, enabled and empty; off and empty after."""
    tr = trace.get_tracer()
    tr.clear()
    tr.enable()
    try:
        yield tr
    finally:
        tr.enable(False)
        tr.clear()


def test_records_while_enabled_or_under_the_profiler():
    tr = trace.get_tracer()
    tr.clear()
    assert not tr.enabled and not tr.recording() and not trace.recording()
    assert trace.span("off") is trace.span("off too")
    with profile(activities=[ProfilerActivity.CPU]):
        assert tr.recording() and trace.recording()
        with trace.span("under.profiler", k=1):
            pass
    assert not tr.recording() and not trace.recording()
    with trace.span("after"):
        pass
    tr.enable()
    assert tr.recording()
    tr.enable(False)
    assert not tr.recording()
    evs = tr.drain()
    assert [e["name"] for e in evs] == ["under.profiler"]
    assert evs[0]["args"] == {"k": 1}


def test_timed_and_event_follow_the_profiler():
    tr = trace.get_tracer()
    tr.clear()
    out = {}
    with trace.timed("t.off", out, "off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.timed("t.on", out, "on"):
            pass
        trace.event("e.on", 1.0, 2.0)
    trace.event("e.off", 1.0, 2.0)
    assert set(out) == {"off", "on"}
    assert [e["name"] for e in tr.drain()] == ["t.on", "e.on"]


def test_origin_puts_events_back_on_the_host_clock(tracer):
    import time

    t0 = time.perf_counter()
    with trace.span("clocked"):
        time.sleep(0.01)
    t1 = time.perf_counter()
    (ev,) = tracer.events()
    a = tracer.origin + ev["ts"] * 1e-6
    assert t0 <= a <= a + ev["dur"] * 1e-6 <= t1
    assert ev["dur"] >= 1e4 * 0.9


def test_threads_get_distinct_native_ids(tracer):
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait(timeout=10)
        with trace.span(f"t{i}"):
            barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    evs = tracer.events()
    assert len(evs) == 4
    assert len({e["tid"] for e in evs}) == 4
    assert {e["tid"] for e in evs} <= {th.native_id for th in threads}


def test_scope_tags_nested_spans_and_restores(tracer):
    with trace.scope("outer", "batch", queries=3):
        with trace.span("inner", case="x"):
            pass
        trace.event("posthoc", 0.0, 0.0)
    with trace.span("outside"):
        pass
    with trace.scope("second", "batch"):
        pass
    by = {e["name"]: e["args"] for e in tracer.events()}
    bid = by["outer"]["batch"]
    assert by["inner"] == {"batch": bid, "case": "x", "depth": 1}
    assert by["posthoc"] == {"batch": bid}
    assert "batch" not in by["outside"]
    assert by["second"]["batch"] != bid
    assert by["outer"]["queries"] == 3


def test_device_spans_carry_no_card_time_on_the_cpu(tracer):
    with trace.span("dev", device=torch.device("cpu"), level=1):
        pass
    with trace.span("dev.true", device=True):
        pass
    evs = tracer.events()
    assert [e["name"] for e in evs] == ["dev", "dev.true"]
    for e in evs:
        assert "device_ms" not in e["args"] and "device_ts" not in e["args"]


@pytest.mark.parametrize("witness", [False, True], ids=["query", "witness"])
def test_one_batch_gives_its_buckets_lifts_and_legs(tracer, witness):
    g, eng = _engine()
    tracer.clear()
    s, t = _pairs(g, 256, 11)
    pl = eng.planner
    if witness:
        pl.query_witness(s, t)
    else:
        pl.query(s, t)
    evs = tracer.events()
    (batch,) = [e for e in evs if e["name"] == "serve.batch"]
    bid = batch["args"]["batch"]
    assert batch["args"]["queries"] == 256
    assert batch["args"]["witness"] is witness
    assert all(e["args"].get("batch") == bid for e in evs)
    assert len([e for e in evs if e["name"] == "planner.plan"]) == 1
    buckets = [e for e in evs if e["name"] == "planner.bucket"]
    counts = {c: n for c, n in pl.last_counts.items() if n}
    assert sorted(e["args"]["case"] for e in buckets) == sorted(counts)
    assert len(counts) >= 3
    for e in buckets:
        assert e["args"]["queries"] == counts[e["args"]["case"]]
        assert e["args"]["padded"] == _pad_pow2(e["args"]["queries"])
    assert sum(e["args"]["queries"] for e in buckets) == 256
    for name in ("serve.program", "planner.readback"):
        kids = [e for e in evs if e["name"] == name]
        assert len(kids) == len(buckets)
        assert all(e["args"]["depth"] == 2 for e in kids)
    levels = set(range(1, len(eng.dix.sf_of) + 1))
    legs = [e for e in evs if e["name"] == "serve.leg"]
    lifts = [e for e in evs if e["name"] == "serve.lift"]
    assert {e["args"]["level"] for e in legs} == levels
    assert {e["args"]["level"] for e in lifts
            if e["args"]["kind"] == "compact"} == levels
    kinds = {e["args"]["kind"] for e in lifts}
    # the witness programs run cross_res as the full-lift program and
    # resolve each lift's source; the distance programs lift resident
    # rows in one step
    assert kinds == ({"compact", "src_of"} if witness
                     else {"compact", "res"})
    for e in legs + lifts:
        assert "device_ms" not in e["args"]


def test_legs_emit_one_span_a_grouping_level(tracer):
    """Each hierarchical combine emits one ``serve.leg`` a grouping
    level, levels 1..L in order, on the distance and the witness
    programs, every tag a plain Python value."""
    from repro_torch.core import device_engine as tde
    g, eng = _engine()
    dix = eng.dix
    levels = list(range(1, len(dix.sf_of) + 1))
    s, t = (torch.as_tensor(x) for x in _pairs(g, 300, 13))
    tracer.clear()
    tde.serve_cross(dix, s, t, with_local=False)
    legs = [e for e in tracer.events() if e["name"] == "serve.leg"]
    assert [e["args"]["level"] for e in legs] == levels
    tracer.clear()
    eng.planner.query_witness(s.numpy(), t.numpy())
    legs += [e for e in tracer.events() if e["name"] == "serve.leg"]
    got = [e["args"]["level"] for e in legs[len(levels):]]
    assert got and got == levels * (len(got) // len(levels))
    for e in legs:
        assert all(type(v) in (int, float, str, bool)
                   for v in e["args"].values()), e


def test_answers_and_paths_equal_with_the_tracer_on_and_off():
    g, eng = _engine()
    s, t = _pairs(g, 200, 5)
    ps, pt = s[:12], t[:12]
    tr = trace.get_tracer()
    tr.clear()
    off = (eng.query(s, t), eng.planner.query_witness(s, t),
           eng.query_path(ps, pt))
    tr.enable()
    try:
        on = (eng.query(s, t), eng.planner.query_witness(s, t),
              eng.query_path(ps, pt))
    finally:
        tr.enable(False)
        tr.clear()
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1][0], off[1][0])
    np.testing.assert_array_equal(on[1][1], off[1][1])
    np.testing.assert_array_equal(on[2][0], off[2][0])
    assert on[2][1] == off[2][1]


def test_unwind_counts_every_read_that_waits(tracer, monkeypatch):
    """The unwinder decides the batch's routes a grouping level at a
    time with one read of the card a level pass, made through ``_wait``:
    the event's ``syncs`` == ``passes`` == the reads (``_host``) == the
    level passes run, levels 1, 2, ... in turn; ``routes`` == the pairs
    the passes decided, summed, the first pass taking every packed
    witness of the batch."""
    g, eng = _engine()
    s, t = _pairs(g, 24, 9)
    dist, wit = eng.planner.query_witness(s, t)
    uw = eng.unwinder()
    tracer.clear()
    seen = {"host": 0, "wait": 0, "passes": []}
    host, wait, decide = tpaths._host, uw._wait, uw._decide

    def counted_host(x):
        seen["host"] += 1
        return host(x)

    def counted_wait(read, *a):
        seen["wait"] += 1
        return wait(read, *a)

    def counted_decide(lvl, x, y):
        seen["passes"].append((lvl, len(x)))
        return decide(lvl, x, y)

    monkeypatch.setattr(tpaths, "_host", counted_host)
    monkeypatch.setattr(uw, "_wait", counted_wait)
    monkeypatch.setattr(uw, "_decide", counted_decide)
    out = uw.unwind_many(s, t, dist, wit)
    monkeypatch.undo()
    (ev,) = [e for e in tracer.events() if e["name"] == "paths.unwind"]
    args = ev["args"]
    assert args["paths"] == 24
    assert args["nodes"] == sum(len(p) for p in out if p is not None)
    levels = [lvl for lvl, _n in seen["passes"]]
    assert levels == [1, 2], seen          # both grouping levels decide
    assert args["passes"] == args["syncs"] == seen["wait"] == seen["host"] \
        == len(levels)
    agent = eng.planner.dix.agent_of.numpy()
    packed = ((s != t) & np.isfinite(dist) & (wit >= 0)
              & (agent[s] != agent[t]))
    assert seen["passes"][0][1] == packed.sum() > 0
    assert args["routes"] == sum(n for _lvl, n in seen["passes"])
    assert 0.0 < args["sync_s"] <= ev["dur"] * 1e-6


def test_unwind_counts_nothing_while_not_recording():
    g, eng = _engine()
    s, t = _pairs(g, 4, 9)
    tr = trace.get_tracer()
    tr.clear()
    dist, wit = eng.planner.query_witness(s, t)
    eng.unwinder().unwind_many(s, t, dist, wit)
    assert tr.events() == []
    assert getattr(eng.unwinder()._waits, "acc", None) is None


def test_the_build_traces_each_group_closure_once(tracer):
    g = road_like(1400, seed=23)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = EpochedEngine(g, device="cpu", hierarchy_levels=3,
                            warm_refresh=False)
    finally:
        torch.set_num_threads(threads)
    names = [e["name"] for e in tracer.events()]
    assert "hierarchy.sf_stage" not in names
    assert names.count("build.sf_stage") == len(eng.dix.sf_of)


class _FakeEvent:
    """A CUDA timing event whose card clock is the host's."""

    def __init__(self, enable_timing=False):
        self.t = None
        self.done = True

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _FakeTorch:
    """The few names of torch the tracer's device path reads."""

    def __init__(self):
        self.records = 0
        fake = self

        class cuda:
            Event = _FakeEvent

            @staticmethod
            def synchronize(dev=None):
                pass

            @staticmethod
            def current_stream(dev=None):
                return ("stream", dev)

        class _CudaEventBase:
            @staticmethod
            def record(ev, stream):
                import time

                fake.records += 1
                ev.t = time.perf_counter()

        class _C:
            @staticmethod
            def _cuda_getCurrentRawStream(dev):
                return 7

        _C._CudaEventBase = _CudaEventBase
        self.cuda, self._C = cuda, _C


def test_device_intervals_pool_reap_and_resolve(tracer, monkeypatch):
    """The device path's bookkeeping against a fake card whose clock is
    the host's: every interval resolves inside its host span, event pairs
    return to the pool and are reused, and a full pending list first
    collects the intervals that finished, stopping at one that did not."""
    import sys

    fake = _FakeTorch()
    monkeypatch.setitem(sys.modules, "torch", fake)
    monkeypatch.setattr(trace, "_REAP_AT", 4)
    monkeypatch.setattr(trace, "_card", lambda device: 0)
    for i in range(4):
        with trace.span("dev", device=True, i=i):
            pass
    pairs = {id(p[1]) for p in tracer._pending}
    assert len(tracer._pending) == 4 and len(pairs) == 4
    tracer._pending[2][2].done = False          # the third is not done
    with trace.span("dev", device=True, i=4):   # reaps the first two
        pass
    assert [p[0]["args"]["i"] for p in tracer._pending] == [2, 3, 4]
    # two pairs came back; the fifth span took one of them
    assert len(tracer._pool[0]) == 1
    assert id(tracer._pending[-1][1]) in pairs
    evs = tracer.events()
    assert not tracer._pending and len(tracer._pool[0]) == 4
    # anchor: three records, then two a span
    assert fake.records == 3 + 2 * 5
    for e in evs:
        a = e["args"]
        assert 0.0 <= a["device_ms"] <= e["dur"] * 1e-3 + 1e-9
        assert e["ts"] - 1.0 <= a["device_ts"] <= e["ts"] + e["dur"] + 1.0
    with trace.span("dev", device=True, i=5):
        pass
    assert len(tracer._pool[0]) == 3            # a pair from the pool
