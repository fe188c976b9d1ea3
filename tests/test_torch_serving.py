"""The port's online serving runtime (``repro_torch.serving``) on the CPU.

The contract is the reference's (``tests/test_serving.py``): every
response carries the epoch it was served on, its distance equals the
host Dijkstra oracle for that epoch's graph, and a cache entry written
under one epoch is never served under another, however queries,
flushes and index refreshes interleave.  Here it is held three ways:

* the reference's cases, run on the port's cache, batcher and runtime
  over the port's ``EpochedEngine`` (plain PyTorch versions);
* the same scripted interleavings (``auto=False``: submits, flushes and
  ``apply_updates`` in a fixed order) through BOTH packages' runtimes
  over their engines on one graph with one hub set: every response's
  distance, epoch, tier, ``cached`` flag and staleness tag, and every
  integer counter of ``stats()`` and of the metrics registry, equal;
* a threaded soak (auto flusher beside a ``RefreshDriver``), every join
  and wait bounded, and the staged-epoch serving contract of
  ``tests/test_refresh_pipeline.py``.

The hub tier's gate is pinned at road64k for the live workload the card
smoke (``chip_smoke.py`` phase ``road64k_live``) serves: the share of
its pairs ``hub_mask`` admits is a function of the pairs and the hub
set alone, computed here from the host build.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import dijkstra as jdijkstra
from repro.core.dist_engine import EpochedEngine as JEngine
from repro.core.graph import road_like as jroad_like
from repro.serving import ServingRuntime as JRuntime
from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra
from repro_torch.core import hierarchy
from repro_torch.core.dist_engine import EpochedEngine, QueryPlanner, hub_gate
from repro_torch.core.graph import Graph, road_like, traffic_updates
from repro_torch.core.refresh_pipeline import RefreshPipeline
from repro_torch.core.supergraph import build_index, reweight_index
from repro_torch.data.queries import workload_pairs, zipf_pairs
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.serving import (EpochCache, MicroBatcher, RefreshDriver,
                                 ServingRuntime, validate_against_epochs)

torch.set_num_threads(1)

#: road64k_live's cache-off workload (``serve --graph road64k --live
#: --mix zipf --rate 2000 --live-seconds 3 --hub-budget 2048``): 6,000
#: Zipf pairs, of which the hub gate admits this many (``chip_smoke.py``
#: holds the card's label tier to the same number)
ROAD64K_LIVE_PAIRS = 6000
ROAD64K_LIVE_GATED = 3209


# ---------------------------------------------------------------------------
# cache unit tests (no engine)
# ---------------------------------------------------------------------------
def test_mismatches_oracle_contract():
    m = dijkstra.mismatches_oracle
    inf, nan = np.inf, np.nan
    assert not m(inf, inf)
    assert m(inf, 5.0) and m(5.0, inf)
    assert m(5.0, nan) and m(inf, nan) and m(nan, nan)
    assert not m(100.0, 100.0 + 1e-4)
    assert m(100.0, 101.0)
    assert not m(0.0, 0.0)


def test_cache_epoch_tagging():
    c = EpochCache(capacity=8)
    assert c.get(1, 2, epoch=0) is None
    c.put(1, 2, epoch=0, dist=5.0)
    assert c.get(1, 2, epoch=0) == 5.0
    assert c.get(1, 2, epoch=1) is None           # stale: epoch moved
    st = c.stats()
    assert (st.hits, st.misses, st.stale) == (1, 2, 1)
    assert c.get(1, 2, epoch=1) is None           # evicted, plain miss
    assert c.stats().stale == 1
    c.put(1, 2, epoch=1, dist=7.0)
    assert c.get(1, 2, epoch=1) == 7.0
    assert 0.0 < c.stats().hit_rate < 1.0
    rec = c.stats().as_record()
    assert rec["cache_stale"] == 1 and rec["cache_hits"] == 2


def test_cache_lru_eviction():
    c = EpochCache(capacity=2)
    c.put(0, 1, 0, 1.0)
    c.put(0, 2, 0, 2.0)
    assert c.get(0, 1, 0) == 1.0
    c.put(0, 3, 0, 3.0)                           # evicts LRU (0, 2)
    assert c.get(0, 2, 0) is None
    assert c.get(0, 1, 0) == 1.0 and c.get(0, 3, 0) == 3.0
    assert c.stats().evictions == 1 and len(c) == 2
    with pytest.raises(ValueError):
        EpochCache(capacity=0)


def test_cache_put_never_clobbers_fresher_entry():
    c = EpochCache(capacity=8)
    c.put(1, 2, epoch=1, dist=7.0)       # the newer flush lands first
    c.put(1, 2, epoch=0, dist=5.0)       # the stale one arrives late
    assert c.get(1, 2, epoch=1) == 7.0
    c.put(1, 2, epoch=1, dist=6.5)
    assert c.get(1, 2, epoch=1) == 6.5
    c.put(1, 2, epoch=2, dist=9.0)
    assert c.get(1, 2, epoch=2) == 9.0
    c.put(3, 4, epoch=0, dist=1.0)
    assert c.get(3, 4, epoch=0) == 1.0


# ---------------------------------------------------------------------------
# micro-batcher unit tests (stub serving, no engine)
# ---------------------------------------------------------------------------
def _stub_serve(batch):
    for r in batch:
        r.dist = float(r.s + r.t)
        r.epoch = 0


def test_batcher_manual_flush():
    mb = MicroBatcher(_stub_serve, max_batch=8, auto=False)
    reqs = [mb.submit(i, i + 1) for i in range(3)]
    assert mb.pending == 3 and not reqs[0].done
    assert mb.flush() == 3
    assert all(r.done and r.dist == r.s + r.t for r in reqs)
    assert reqs[0].latency_s >= 0
    assert mb.flush() == 0
    assert mb.flush_reasons["manual"] == 1
    assert mb.occupancy()["flushes"] == 1


def test_batcher_deadline_flush():
    mb = MicroBatcher(_stub_serve, max_batch=64, deadline_s=0.03,
                      auto=True)
    reqs = [mb.submit(i, i) for i in range(3)]
    for r in reqs:
        assert r.wait(timeout=5.0), "deadline flush never fired"
    assert mb.flush_reasons["deadline"] >= 1
    assert mb.flush_reasons["full"] == 0
    assert mb.flushed_requests == 3
    mb.close()


def test_batcher_full_flush_before_deadline():
    mb = MicroBatcher(_stub_serve, max_batch=16, deadline_s=30.0,
                      auto=True)
    reqs = [mb.submit(i, i) for i in range(16)]
    for r in reqs:
        assert r.wait(timeout=5.0), "full-bucket flush never fired"
    assert mb.flush_reasons["full"] == 1
    occ = mb.occupancy()
    assert occ["flushes"] == 1 and occ["occupancy_hist"] == {"16": 1}
    assert occ["mean_occupancy"] == 1.0
    mb.close()


def test_batcher_unresolved_request_raises():
    mb = MicroBatcher(lambda batch: None, max_batch=8, auto=False)
    mb.submit(1, 2)
    with pytest.raises(RuntimeError):
        mb.flush()
    with pytest.raises(ValueError):
        MicroBatcher(_stub_serve, max_batch=0, auto=False)


def test_batcher_flusher_death_fails_requests_and_closes():
    def boom(batch):
        raise ValueError("device exploded")

    mb = MicroBatcher(boom, max_batch=8, deadline_s=0.005, auto=True)
    r = mb.submit(1, 2)
    assert r.wait(timeout=5.0), "failed request never resolved"
    assert isinstance(r.error, ValueError)
    with pytest.raises(RuntimeError, match="flush failed"):
        r.result(timeout=0)
    deadline = time.monotonic() + 5.0
    while True:
        assert time.monotonic() < deadline, "batcher never closed"
        try:
            r2 = mb.submit(3, 4)
        except RuntimeError as exc:
            assert "flusher died" in str(exc)
            break
        assert r2.wait(timeout=5.0) and r2.error is not None
        time.sleep(0.01)
    assert isinstance(mb.error, ValueError)


def test_manual_flush_failure_closes_batcher():
    late = []

    def boom(batch):
        late.append(mb.submit(7, 8))      # arrives mid-failing-flush
        raise ValueError("device exploded")

    mb = MicroBatcher(boom, max_batch=8, auto=False)
    r = mb.submit(1, 2)
    with pytest.raises(ValueError):
        mb.flush()
    assert r.done and isinstance(r.error, ValueError)
    assert late[0].done and isinstance(late[0].error, ValueError)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(3, 4)
    with pytest.raises(RuntimeError, match="flush failed"):
        late[0].result(timeout=0)


def test_scheduled_time_latency_basis():
    mb = MicroBatcher(_stub_serve, max_batch=8, auto=False)
    backlog = 0.25
    t_late = time.perf_counter() - backlog
    r_late = mb.submit(1, 2, t_sched=t_late)
    r_now = mb.submit(3, 4)
    mb.flush()
    assert r_late.t_sched == t_late
    assert r_now.t_sched == r_now.t_submit
    assert r_late.latency_s >= backlog
    assert r_now.latency_s < backlog
    assert abs((r_late.latency_s - r_now.latency_s)
               - (r_now.t_sched - t_late)) < 1e-9


def test_occupancy_buckets_are_planner_shapes():
    mb = MicroBatcher(_stub_serve, max_batch=64, auto=False)
    for n in (3, 17, 64):
        for i in range(n):
            mb.submit(i, i)
        mb.flush()
    occ = mb.occupancy()
    assert occ["occupancy_hist"] == {"16": 1, "32": 1, "64": 1}
    assert occ["flushes"] == 3


def test_stats_reads_consistent_under_concurrent_flushes():
    mb = MicroBatcher(_stub_serve, max_batch=4, deadline_s=0.0005,
                      auto=True)
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            occ = mb.occupancy()
            reasons = (occ["flush_full"] + occ["flush_deadline"]
                       + occ["flush_manual"])
            if (sum(occ["occupancy_hist"].values()) != occ["flushes"]
                    or reasons != occ["flushes"]):
                torn.append(occ)

    th = threading.Thread(target=reader)
    th.start()
    try:
        reqs = [mb.submit(i, i) for i in range(400)]
        for r in reqs:
            assert r.wait(timeout=10.0)
    finally:
        stop.set()
        th.join(timeout=30)
        mb.close()
    assert not th.is_alive()
    assert not torn, torn[:3]
    assert mb.flushed_requests == 400


def test_batcher_close_drains_pending():
    mb = MicroBatcher(_stub_serve, max_batch=64, deadline_s=30.0,
                      auto=True)
    reqs = [mb.submit(i, i) for i in range(5)]
    mb.close()
    assert all(r.done for r in reqs)
    with pytest.raises(RuntimeError):
        mb.submit(1, 1)


# ---------------------------------------------------------------------------
# runtime + the port's engine: correctness, cache, epochs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine():
    eng = EpochedEngine(road_like(380, seed=11), device="cpu")
    eng.warmup(64)
    return eng


def _check_vs_epoch_oracle(req, graphs_by_epoch):
    want = dijkstra.pair(graphs_by_epoch[req.epoch], req.s, req.t)
    assert not dijkstra.mismatches_oracle(want, req.dist), \
        (req.s, req.t, req.epoch, req.dist, want)


def _apply_round(eng, seed):
    u, v, w = traffic_updates(eng.g, frac=0.05, seed=seed)
    eng.apply_updates(u, v, w)
    epoch, _dix, g, _stale = eng.snapshot()
    return epoch, g


def test_runtime_serves_exact_and_caches(engine):
    rt = ServingRuntime(engine, max_batch=64, cache_size=256, auto=False)
    epoch, _dix, g, _stale = engine.snapshot()
    pairs = np.random.default_rng(0).integers(0, g.n, (20, 2))
    reqs = [rt.submit(int(a), int(b)) for a, b in pairs]
    assert rt.flush() == 20
    for r in reqs:
        assert r.epoch == epoch and not r.cached
        _check_vs_epoch_oracle(r, {epoch: g})
    again = [rt.submit(int(a), int(b)) for a, b in pairs]
    rt.flush()
    for r0, r1 in zip(reqs, again):
        assert r1.cached and r1.dist == r0.dist and r1.epoch == epoch
    st = rt.stats()
    assert st["cache_hits"] >= 20 and st["cache_stale"] == 0


def test_runtime_snaps_max_batch_to_planner_bucket(engine):
    rt = ServingRuntime(engine, max_batch=100, auto=False)
    assert rt.max_batch == engine.planner.bucket_sizes(100)[-1] == 128
    with pytest.raises(ValueError):
        ServingRuntime(engine, max_batch=0, auto=False)


def test_cache_disabled(engine):
    rt = ServingRuntime(engine, max_batch=64, cache_size=0, auto=False)
    assert rt.cache is None
    r1 = rt.submit(3, 200)
    rt.flush()
    r2 = rt.submit(3, 200)
    rt.flush()
    assert not r1.cached and not r2.cached and r1.dist == r2.dist
    st = rt.stats()
    assert st["cache_hits"] == 0
    assert st["label_hits"] + st["planner_dispatches"] == 2
    assert r1.tier in ("label", "planner") and r2.tier == r1.tier


def test_cache_hit_latency_uses_scheduled_basis(engine):
    rt = ServingRuntime(engine, max_batch=64, cache_size=256, auto=False)
    rt.submit(3, 100)
    rt.flush()
    backlog = 0.2
    r = rt.submit(3, 100, t_sched=time.perf_counter() - backlog)
    rt.flush()
    assert r.cached and r.latency_s >= backlog


def test_stale_cache_entry_detected_never_served(engine):
    rt = ServingRuntime(engine, max_batch=64, cache_size=256, auto=False)
    e0, _dix, g0, _stale = engine.snapshot()
    s, t = 5, g0.n - 7
    rt.submit(s, t)
    rt.flush()
    r1 = rt.submit(s, t)
    rt.flush()
    assert r1.cached and r1.epoch == e0
    e1, g1 = _apply_round(engine, seed=91)
    assert e1 == e0 + 1
    stale_before = rt.cache.stats().stale
    r2 = rt.submit(s, t)
    rt.flush()
    assert not r2.cached and r2.epoch == e1
    assert rt.cache.stats().stale == stale_before + 1
    _check_vs_epoch_oracle(r2, {e1: g1})
    r3 = rt.submit(s, t)
    rt.flush()
    assert r3.cached and r3.epoch == e1 and r3.dist == r2.dist


def test_slow_flush_cannot_clobber_fresh_cache(engine):
    rt = ServingRuntime(engine, max_batch=64, cache_size=256, auto=False)
    e0, dix0, g0, _stale = engine.snapshot()
    s, t = 11, g0.n - 3
    e1, _g1 = _apply_round(engine, seed=55)
    rB = rt.submit(s, t)
    rt.flush()
    assert rB.epoch == e1 and not rB.cached
    dA = float(engine.planner.query([s], [t], dix=dix0)[0])
    rt.cache.put(s, t, e0, dA)           # the late stale fill
    r = rt.submit(s, t)
    rt.flush()
    assert r.cached and r.epoch == e1 and r.dist == rB.dist


@pytest.mark.parametrize("order", [
    ("submit", "flush", "update", "submit", "flush"),
    ("submit", "update", "flush", "submit", "flush"),
    ("submit", "submit", "update", "flush", "update", "submit", "flush"),
    ("update", "submit", "flush", "submit", "update", "flush"),
])
def test_deterministic_interleavings(engine, order):
    """Every response is consistent with the one epoch it is tagged with
    (requests pending across a swap are served wholly on the new one)."""
    rt = ServingRuntime(engine, max_batch=64, cache_size=256, auto=False)
    e, _dix, g, _stale = engine.snapshot()
    graphs = {e: g}
    rng = np.random.default_rng(
        sum((i + 7) * len(op) for i, op in enumerate(order)))
    reqs = []
    seed = int(rng.integers(0, 10_000))
    for op in order:
        if op == "submit":
            a, b = rng.integers(0, g.n, 2)
            reqs.append(rt.submit(int(a), int(b)))
        elif op == "update":
            e, g = _apply_round(engine, seed=seed)
            graphs[e] = g
            seed += 1
        else:
            rt.flush()
    rt.flush()
    for r in reqs:
        assert r.done and r.epoch in graphs
        _check_vs_epoch_oracle(r, graphs)


def test_soak_concurrent_refresh(engine):
    """A background RefreshDriver publishes 3 epochs while the auto
    flusher serves hot Zipf pairs: every response equals the oracle of
    its epoch, and a tail after the last publish is served on it."""
    rt = ServingRuntime(engine, max_batch=64, deadline_s=0.002,
                        cache_size=4096, auto=True)
    e_start = engine.snapshot()[0]
    drv = RefreshDriver(engine, rounds=3, frac=0.05, interval_s=0.05,
                        seed=23).start()
    pool = zipf_pairs(engine.g, 4000, pool=128, seed=3)
    reqs = []
    i = 0
    t_end = time.monotonic() + 120.0
    while not drv.done and time.monotonic() < t_end:
        a, b = pool[i % len(pool)]
        reqs.append(rt.submit(int(a), int(b)))
        i += 1
        time.sleep(0.001)
    drv.join(timeout=120.0)
    assert drv.done and drv.error is None
    e_end = engine.snapshot()[0]
    assert e_end == e_start + 3
    tail = [rt.submit(int(a), int(b)) for a, b in pool[:24]]
    deadline = time.monotonic() + 120.0
    for r in reqs + tail:
        assert r.wait(max(0.0, deadline - time.monotonic())), \
            "runtime stalled under concurrent refresh"
        assert r.error is None, f"flush failed mid-soak: {r.error!r}"
    rt.close()
    assert all(r.epoch == e_end for r in tail)
    graphs, evicted = drv.graph_snapshots()
    assert {r.epoch for r in reqs + tail} <= set(graphs) | evicted
    checked, bad = validate_against_epochs(
        reqs + tail, graphs, sample=80, seed=1, evicted=evicted)
    assert checked >= 24 and bad == 0
    st = rt.stats()
    assert st["flushes"] > 0 and st["cache_hits"] > 0
    rec = drv.as_record()
    assert set(rec) == {"refresh_rounds", "refresh_pipelined",
                        "refresh_items", "refresh_mean_s",
                        "refresh_max_s"}
    assert rec["refresh_rounds"] == 3 and not rec["refresh_pipelined"]


def test_refresh_driver_retention_cap(engine):
    e_start = engine.snapshot()[0]
    drv = RefreshDriver(engine, rounds=5, frac=0.01, seed=7,
                        retain_epochs=3).start()
    drv.join(timeout=300.0)
    graphs, evicted = drv.graph_snapshots()
    assert sorted(graphs) == [e_start + 3, e_start + 4, e_start + 5]
    assert {e_start, e_start + 1, e_start + 2} <= evicted

    class _Resp:
        def __init__(self, e):
            self.epoch, self.s, self.t, self.dist = e, 0, 1, 0.0

    checked, bad = validate_against_epochs(
        [_Resp(e_start), _Resp(-999)], graphs, sample=16, seed=0,
        evicted=evicted)
    assert (checked, bad) == (1, 1)


def test_staged_epoch_serving_contract():
    """Serve between pipeline steps: every response's staleness tag is
    the descriptor of its epoch (mid-pipeline epochs incomplete with
    lag 1, the final one complete), every response equals the oracle
    of its epoch's graph, and the refreshed index equals scratch."""
    g = road_like(380, seed=55)
    engine = EpochedEngine(g, device="cpu")
    rt = ServingRuntime(engine, max_batch=32, cache_size=64, auto=False)
    rng = np.random.default_rng(4)
    graphs, stales = {}, {}
    e0, _d, g0, s0 = engine.snapshot()
    graphs[e0], stales[e0] = g0, s0
    assert s0.complete
    reqs = []

    def serve_some(k=6):
        batch = [rt.submit(int(a), int(b))
                 for a, b in rng.integers(0, g.n, (k, 2))]
        rt.flush()
        reqs.extend(batch)

    serve_some()
    u, v, w = traffic_updates(g, frac=0.08, seed=13)
    pipe = RefreshPipeline(engine, traffic=rt.frag_traffic, max_items=4)
    pipe.submit(u, v, w)
    assert pipe.plan() >= 2
    while pipe.step() is not None:
        e, _d, ge, se = engine.snapshot()
        graphs[e], stales[e] = ge, se
        serve_some()
    final_e = max(graphs)
    mid = [e for e in graphs if e not in (e0, final_e)]
    assert mid, "pipeline published no intermediate epoch"
    assert stales[final_e].complete
    for e in mid:
        assert not stales[e].complete and stales[e].lag_batches == 1
    for r in reqs:
        assert r.done and r.error is None
        assert r.staleness == stales[r.epoch]
        _check_vs_epoch_oracle(r, graphs)
    assert any(not r.staleness.complete for r in reqs)
    sdix = tde.build_device_index(
        reweight_index(engine.ix, engine.g), device="cpu",
        hierarchy_levels=engine.plan.hierarchy_levels)
    eq = tde.index_fields_equal(engine.dix, sdix,
                                serve.REFRESHED_FIELDS)
    assert all(eq.values()), [k for k, ok in eq.items() if not ok]


def test_post_swap_flush_builds_and_loads_nothing(monkeypatch):
    """The resident (cross_res) program and the hub program are warmed
    with the other buckets, and a flush right after ``apply_updates``
    reaches every bucket without building or loading a kernel library
    (the port's form of the reference's no-recompile test)."""
    g = road_like(2500, seed=3)
    rng = np.random.default_rng(0)
    engine = EpochedEngine(g, device="cpu", hierarchy_levels=3,
                           hub_nodes=rng.choice(g.n, 200, replace=False))
    assert engine.dix.res_rows.shape[0] > 1, "no resident rows"
    rt = ServingRuntime(engine, max_batch=64, cache_size=0, auto=False)
    rt.warmup()
    u, v = g.edge_u[:6], g.edge_v[:6]
    engine.apply_updates(u, v, g.edge_w[:6] + 1.0)

    def refuse(*a, **k):
        raise AssertionError("a serving flush built or loaded a kernel "
                             "library after warmup")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    rf = engine.dix.host_res_frag
    tg = engine.dix.host_topgrp_frag
    fa = engine.dix.frag_of.numpy()[engine.dix.agent_of.numpy()]
    hot = np.nonzero((fa >= 0) & (rf[np.maximum(fa, 0)] >= 0))[0]
    far = hot[tg[fa[hot]] != tg[fa[hot[0]]]]
    pairs = [(int(hot[0]), int(far[i % far.size])) for i in range(40)]
    pairs += [tuple(int(x) for x in p) for p in rng.integers(0, g.n, (40, 2))]
    reqs = [rt.submit(a, b) for a, b in pairs[:64]]
    rt.flush()
    assert engine.planner.last_counts["cross_res"] > 0
    reqs += [rt.submit(a, b) for a, b in pairs[64:]]
    rt.flush()
    _e, _d, g1, _s = engine.snapshot()
    for r in reqs:
        assert r.error is None
        _check_vs_epoch_oracle(r, {r.epoch: g1})
    rt.close()


# ---------------------------------------------------------------------------
# the port's runtime == the reference's, under scripted interleavings
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    """(port engine, reference engine) on one graph and one hub set."""
    jg = jroad_like(500, seed=8)
    tg = Graph(**{f.name: getattr(jg, f.name)
                  for f in dataclasses.fields(jg)})
    hubs = np.random.default_rng(2).choice(tg.n, 60, replace=False)
    teng = EpochedEngine(tg, device="cpu", hub_nodes=hubs)
    jeng = JEngine(jg, hub_nodes=hubs)
    teng.warmup(64)
    jeng.warmup(64)
    return teng, jeng, hubs


def _response(r) -> tuple:
    st = r.staleness
    return (r.s, r.t, r.dist, r.epoch, r.tier, r.cached,
            (st.watermark, st.submitted, st.pending_updates,
             tuple(st.pending_groups)))


#: registry metrics that hold wall-clock seconds (compared as present,
#: not by value)
_CLOCKED = ("serve.request.latency_s", "serve.tier.label.seconds",
            "serve.tier.planner.seconds")


def _counters(rt) -> tuple:
    snap = {k: v for k, v in rt.registry.snapshot().items()
            if k not in _CLOCKED}
    stats = {k: v for k, v in rt.stats().items()
             if not k.endswith("_us_per_query")}
    return snap, stats


@pytest.mark.parametrize("order", [
    ("submit", "flush", "update", "submit", "flush"),
    ("submit", "update", "flush", "submit", "flush"),
    ("submit", "submit", "update", "flush", "update", "submit", "flush"),
    ("update", "submit", "flush", "submit", "update", "flush"),
    ("submit", "flush", "submit", "flush", "update", "update", "submit",
     "flush"),
])
@pytest.mark.parametrize("cache_size", [256, 0])
def test_interleavings_equal_reference_runtime(engines, order, cache_size):
    """The same script through both packages' runtimes: equal answers,
    epochs, tiers (cache / label / planner), ``cached`` flags and
    staleness tags, equal integer counters; every answer == Dijkstra on
    its epoch's graph."""
    teng, jeng, hubs = engines
    rts = (ServingRuntime(teng, max_batch=64, cache_size=cache_size,
                          auto=False),
           JRuntime(jeng, max_batch=64, cache_size=cache_size, auto=False))
    e, _d, g, _s = teng.snapshot()
    assert jeng.snapshot()[0] == e
    graphs = {e: g}
    rng = np.random.default_rng(len(order) * 31 + cache_size)
    reqs = ([], [])
    for op in order:
        if op == "submit":
            # hub-node pairs (the label tier), random pairs (the
            # planner), and repeats of earlier pairs (the cache)
            k = 12
            pairs = np.concatenate([rng.choice(hubs, (k, 2)),
                                    rng.integers(0, g.n, (k, 2))])
            if reqs[0]:
                old = [(r.s, r.t) for r in reqs[0][:k]]
                pairs = np.concatenate([pairs, np.asarray(old)])
            for rt, out in zip(rts, reqs):
                out.extend(rt.submit(int(a), int(b)) for a, b in pairs)
        elif op == "update":
            u, v, w = traffic_updates(teng.g, frac=0.04,
                                      seed=int(rng.integers(0, 10_000)))
            teng.apply_updates(u, v, w)
            jeng.apply_updates(u, v, w)
            e, _d, g, _s = teng.snapshot()
            graphs[e] = g
        else:
            assert rts[0].flush() == rts[1].flush()
    for rt in rts:
        rt.flush()
        rt.close()
    assert [_response(r) for r in reqs[0]] == \
        [_response(r) for r in reqs[1]]
    assert _counters(rts[0]) == _counters(rts[1])
    tiers = {r.tier for r in reqs[0]}
    assert "label" in tiers and "planner" in tiers
    if not cache_size:
        assert "cache" not in tiers
    elif order[:4] == ("submit", "flush", "submit", "flush"):
        assert "cache" in tiers          # repeats within one epoch hit
    for r in reqs[0]:
        _check_vs_epoch_oracle(r, graphs)
        assert not jdijkstra.mismatches_oracle(
            jdijkstra.pair(graphs[r.epoch], r.s, r.t), r.dist)


# ---------------------------------------------------------------------------
# the hub tier's gate, from host data, pinned at road64k
# ---------------------------------------------------------------------------
def _host_gate(g, ix, hubs, levels, s, t) -> np.ndarray:
    """``hub_gate`` from the host build alone: the build plan, the
    hierarchy plan and the hub agents, no device build."""
    plan = tde.make_build_plan(ix)
    plan.hub_nodes = np.asarray(hubs, np.int64)
    plan.hier = hierarchy.plan_hierarchy(plan, levels=levels)
    hub_agent = np.full(plan.n, -1, np.int32)
    agents = tde.hub_agents(plan)
    hub_agent[agents] = np.arange(agents.size, dtype=np.int32)
    return hub_gate(s, t, plan.agent_of, plan.frag_of, hub_agent,
                    tde.topgrp_of_frag(plan.hier), hierarchical=True)


def test_host_gate_equals_built_index_hub_mask():
    """The host-only gate equals ``QueryPlanner.hub_mask`` on the index
    built from the same host build and hub set (3 levels)."""
    g = road_like(1400, seed=23)
    ix = build_index(g)
    rng = np.random.default_rng(3)
    hubs = rng.choice(g.n, 300, replace=False)
    dix = tde.build_device_index(ix, device="cpu", hierarchy_levels=3,
                                 hub_nodes=hubs)
    assert dix.hierarchy_levels == 3
    s = np.concatenate([rng.choice(hubs, 3000), rng.integers(0, g.n, 500)])
    t = np.concatenate([rng.choice(hubs, 3000), rng.integers(0, g.n, 500)])
    want = QueryPlanner(dix).hub_mask(s, t)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(_host_gate(g, ix, hubs, 3, s, t), want)


def test_road64k_live_hub_share_pinned():
    """road64k_live's workload and hub set, as ``serve --live`` builds
    them: the hub gate admits ROAD64K_LIVE_GATED of its pairs.  With the
    cache off, the card's label tier must serve exactly that many."""
    args = serve.parse_args(["--graph", "road64k", "--live", "--mix",
                             "zipf", "--rate", "2000", "--live-seconds",
                             "3", "--hub-budget", "2048", "--cache-size",
                             "0", "--device", "cpu"])
    serve._build_knobs(args)
    g = road_like(args.nodes, seed=args.seed)
    ix = build_index(g)
    n = int(round(args.rate * args.live_seconds))
    pairs = workload_pairs(g, args.mix, n, seed=args.seed + 4,
                           zipf_a=args.zipf_a)
    gate = _host_gate(g, ix, serve._hub_selection(g, args), 3,
                      pairs[:, 0], pairs[:, 1])
    assert (n, int(gate.sum())) == (ROAD64K_LIVE_PAIRS, ROAD64K_LIVE_GATED)
