# Copied from src/repro/serving/runtime.py (numpy only around the port's EpochedEngine); keep the two in step.
"""Online serving runtime: scheduler + cache over an EpochedEngine.

``ServingRuntime`` is the single-request front door to the batched
serving stack (DESIGN.md §11).  A request flows

    submit(s, t) -> MicroBatcher buffer -> flush
        -> pin (epoch, dix, graph) via EpochedEngine.snapshot()
        -> EpochCache lookups keyed by that epoch
        -> hub-label merge (QueryPlanner.query_hub) for the misses
           whose endpoints are both labeled in the pinned epoch
        -> one QueryPlanner.query(..., dix=pinned) for the rest
        -> cache fill + resolve, every response tagged with the epoch

The middle tier is the DESIGN.md §15 hot tier: when the build pinned
hub labels for a traffic-heavy node set, any miss whose (s, t) pair
``hub_mask`` admits is answered by an O(W) label merge instead of the
full planner contraction — exact by construction, so tiers differ in
cost only, never in answers.  Per-tier counters and wall-clock splits
(``stats()``) make the label-vs-planner latency claim measurable.

The epoch pin is the consistency argument in one line: everything a
flush does — cache reads, device serve, cache writes, the tag on each
response — binds to one atomically-read published epoch, so no
response can mix epoch e's cache with epoch e+1's index no matter how
``apply_updates`` interleaves with the flush.  (The deterministic
interleaving tests and the threaded soak in ``tests/test_serving.py``
check this against per-epoch host oracles.)

``RefreshDriver`` is the concurrent-refresh half: a background thread
absorbing synthetic traffic batches through the existing staged delta
path while the foreground keeps serving; it keeps the per-epoch graph
snapshots the differential validation needs.

On the card the two threads share one device.  The flusher launches on
its thread's current stream (the default stream); every refresh runs on
the engine's own refresh stream (``EpochedEngine.apply_updates``), so a
serving batch never queues behind a refresh's kernels, and an epoch is
published only after that stream has finished its work.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..core.dist_engine import EpochedEngine
from ..core.graph import traffic_updates
from ..core.refresh_pipeline import RefreshPipeline
from ..obs import trace
from ..obs.export import SlowQueryLog
from ..obs.metrics import MetricsRegistry
from .cache import EpochCache
from .scheduler import MicroBatcher, Request


class ServingRuntime:
    """Deadline-batched, epoch-cached serving over an EpochedEngine.

    ``cache_size=0`` disables the cache (every request hits the
    device); ``auto=False`` disables the flusher thread so tests can
    drive ``flush()`` deterministically.  ``max_batch`` is snapped up
    to a planner bucket size so every flush runs at a warmed-up
    bucket shape — call ``engine.warmup(max_batch)`` (or let
    ``warmup()`` here do it) before timing anything.
    """

    def __init__(self, engine: EpochedEngine, *, max_batch: int = 256,
                 deadline_s: float = 0.002, cache_size: int = 65536,
                 auto: bool = True,
                 registry: MetricsRegistry | None = None,
                 slow_log_n: int = 16):
        if max_batch <= 0:
            # bucket_sizes would silently floor this to 16; reject it
            # instead (cache_size=0 is the disable idiom, not this)
            raise ValueError(f"max_batch must be positive: {max_batch}")
        self.engine = engine
        self.max_batch = engine.planner.bucket_sizes(max_batch)[-1]
        # one registry per runtime (DESIGN.md §16): the cache, batcher,
        # tier ladder, and traffic counters all record into it, and the
        # exporters (--metrics-out/--metrics-port) read it live
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.slow_log = SlowQueryLog(slow_log_n)
        self.cache = EpochCache(cache_size, registry=self.registry) \
            if cache_size else None
        # per-fragment serving counters (both endpoints, represented
        # nodes routed through their agent): the traffic weights the
        # refresh pipeline prioritizes dirty groups by
        self._traffic = self.registry.array_counter(
            "serve.frag_traffic", engine.plan.k)
        # per-tier accounting (DESIGN.md §15): every cache miss is
        # resolved by exactly one of the label tier (hub merge) or the
        # planner; the wall-clock split makes the label-vs-planner
        # latency comparison a measured serve_live field, not a claim
        self._m_label_hits = self.registry.counter(
            "serve.tier.label.hits")
        self._m_planner_hits = self.registry.counter(
            "serve.tier.planner.dispatches")
        self._m_label_s = self.registry.counter(
            "serve.tier.label.seconds")
        self._m_planner_s = self.registry.counter(
            "serve.tier.planner.seconds")
        self._m_epoch = self.registry.gauge("serve.epoch")
        self.batcher = MicroBatcher(self._serve_batch,
                                    max_batch=self.max_batch,
                                    deadline_s=deadline_s, auto=auto,
                                    registry=self.registry,
                                    slow_log=self.slow_log)

    def warmup(self) -> None:
        """Run every planner sub-program at every bucket size a flush
        can produce — including the resident fast-path program
        (cross_res) when the epoch carries pre-lifted rows, and the hub
        program when it carries labels — so every kernel library is
        built and loaded here.  An epoch swap keeps every table's shape
        and loads no library, so the first live flush after
        ``apply_updates`` pays no build or load in its p99."""
        self.engine.warmup(self.max_batch)

    def submit(self, s: int, t: int,
               t_sched: float | None = None) -> Request:
        """Enqueue one query; returns its in-flight Request.
        ``t_sched``: the open-loop scheduled arrival time — latency is
        measured from it (see scheduler.Request)."""
        return self.batcher.submit(s, t, t_sched)

    def query(self, s: int, t: int,
              timeout: float | None = 30.0) -> float:
        """Blocking single-query convenience: submit + wait, raising
        on timeout or a failed flush."""
        return self.submit(s, t).result(timeout)

    def frag_traffic(self) -> np.ndarray:
        """Snapshot of the per-fragment serving counters (a copy)."""
        return self._traffic.snapshot()

    def latency_histogram(self):
        """The request-latency histogram (seconds; observed per
        resolved request on the open-loop ``t_sched`` basis) — the
        load harness derives its reported percentiles from this."""
        return self.registry.histogram("serve.request.latency_s")

    def _count_traffic(self, batch) -> None:
        plan = self.engine.plan
        nodes = np.fromiter(
            (x for r in batch for x in (r.s, r.t)), np.int64,
            2 * len(batch))
        frag = plan.frag_of[nodes]
        frag = np.where(frag >= 0, frag,
                        plan.frag_of[plan.agent_of[nodes]])
        counts = np.bincount(frag[frag >= 0], minlength=plan.k)
        self._traffic.add(counts)

    # -- the flush body (runs on the flusher thread in auto mode) ------
    def _serve_batch(self, batch) -> None:
        epoch, dix, _g, stale = self.engine.snapshot()
        self._m_epoch.set(epoch)
        self._count_traffic(batch)
        misses = []
        with trace.span("serve.cache_lookup", epoch=epoch,
                        size=len(batch)):
            for req in batch:
                hit = None if self.cache is None else \
                    self.cache.get(req.s, req.t, epoch)
                if hit is not None:
                    req.dist = hit
                    req.epoch = epoch
                    req.staleness = stale
                    req.cached = True
                    req.tier = "cache"
                else:
                    misses.append(req)
        if misses:
            planner = self.engine.planner
            s = np.fromiter((r.s for r in misses), np.int32,
                            len(misses))
            t = np.fromiter((r.t for r in misses), np.int32,
                            len(misses))
            # label tier: pairs whose endpoints are both hub-labeled
            # in the pinned epoch bypass the planner entirely — the
            # merge is exact (§15), so this changes cost, not answers
            hub = planner.hub_mask(s, t, dix=dix)
            out = np.empty(len(misses), np.float64)
            label_n = planner_n = 0
            label_s = planner_s = 0.0
            lag = stale.lag_batches if stale is not None else 0
            if hub.any():
                t0 = time.perf_counter()
                out[hub] = planner.query_hub(s[hub], t[hub], dix=dix)
                t1 = time.perf_counter()
                label_s = t1 - t0
                label_n = int(hub.sum())
                trace.event("serve.tier.label", t0, t1, n=label_n,
                            epoch=epoch, staleness=lag)
            rest = ~hub
            if rest.any():
                t0 = time.perf_counter()
                out[rest] = planner.query(s[rest], t[rest], dix=dix)
                t1 = time.perf_counter()
                planner_s = t1 - t0
                planner_n = int(rest.sum())
                trace.event("serve.tier.planner", t0, t1, n=planner_n,
                            epoch=epoch, staleness=lag)
            for req, d, h in zip(misses, out, hub):
                req.dist = float(d)
                req.epoch = epoch
                req.staleness = stale
                req.tier = "label" if h else "planner"
                if self.cache is not None:
                    self.cache.put(req.s, req.t, epoch, req.dist)
            if label_n:
                self._m_label_hits.inc(label_n)
                self._m_label_s.inc(label_s)
            if planner_n:
                self._m_planner_hits.inc(planner_n)
                self._m_planner_s.inc(planner_s)

    def flush(self) -> int:
        return self.batcher.flush()

    def close(self) -> None:
        self.batcher.close()

    def stats(self) -> dict:
        """Occupancy + per-tier counters.  ``cache_hits`` is always
        present (0 when the cache is disabled — the cache stats record
        overrides it otherwise); ``label_us_per_query`` vs
        ``planner_us_per_query`` is the measured hot-tier speedup."""
        out = self.batcher.occupancy()
        label_hits = int(self._m_label_hits.value)
        planner_hits = int(self._m_planner_hits.value)
        out["cache_hits"] = 0
        out["label_hits"] = label_hits
        out["planner_dispatches"] = planner_hits
        out["label_us_per_query"] = round(
            1e6 * self._m_label_s.value / label_hits, 3) \
            if label_hits else 0.0
        out["planner_us_per_query"] = round(
            1e6 * self._m_planner_s.value / planner_hits, 3) \
            if planner_hits else 0.0
        if self.cache is not None:
            out.update(self.cache.stats().as_record())
        return out


class RefreshDriver:
    """Background index refresher: ``rounds`` traffic batches through
    ``EpochedEngine.apply_updates`` while the foreground serves.

    Retains ``graphs_by_epoch`` — the exact host graph published with
    each epoch — so responses tagged epoch e can be validated against
    the Dijkstra oracle *for e* even after later epochs land, and
    records per-round refresh wall time.  Retention is capped at the
    last ``retain_epochs`` epochs (a road64k host graph is tens of MB;
    a long schedule retaining every epoch is an unbounded leak); the
    ids evicted past the cap are tracked so the validation oracle can
    tell "evicted" from "never published".  All snapshot access is
    synchronized (``graph_snapshots``) — the foreground may sample
    mid-run.  ``pipelined=True`` routes each round through the staged
    ``core.refresh_pipeline.RefreshPipeline`` (one epoch per work item,
    ``traffic``-prioritized) instead of one monolithic apply_updates.
    ``interval_s`` spaces the rounds out (0 = back-to-back).  Start
    with ``start()``; ``join()`` waits for completion.
    """

    def __init__(self, engine: EpochedEngine, *, rounds: int = 3,
                 frac: float = 0.02, interval_s: float = 0.0,
                 seed: int = 0, retain_epochs: int = 64,
                 pipelined: bool = False, traffic=None,
                 max_items: int = 8):
        self.engine = engine
        self.rounds = rounds
        self.frac = frac
        self.interval_s = interval_s
        self.seed = seed
        self.retain_epochs = max(2, int(retain_epochs))
        self.pipeline = RefreshPipeline(
            engine, traffic=traffic, max_items=max_items) \
            if pipelined else None
        self._glock = threading.Lock()
        e0, _dix, g0, _stale = engine.snapshot()
        self.graphs_by_epoch = {e0: g0}
        self.evicted_epochs: set[int] = set()
        self.refresh_s: list[float] = []
        self.items_per_round: list[int] = []
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run,
                                        name="refresh-driver",
                                        daemon=True)

    def start(self) -> "RefreshDriver":
        self._thread.start()
        return self

    def join(self, timeout: float | None = None) -> None:
        """Wait for the driver; raises TimeoutError if it is still
        running when ``timeout`` expires (callers must not proceed as
        if the refresh schedule completed) and re-raises any exception
        the refresh thread died with."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"RefreshDriver still running after {timeout}s "
                f"({len(self.refresh_s)}/{self.rounds} rounds done)")
        if self.error is not None:
            raise self.error

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    def _record_epoch(self) -> None:
        epoch, _dix, g, _stale = self.engine.snapshot()
        with self._glock:
            self.graphs_by_epoch[epoch] = g
            while len(self.graphs_by_epoch) > self.retain_epochs:
                old = min(self.graphs_by_epoch)
                del self.graphs_by_epoch[old]
                self.evicted_epochs.add(old)

    def graph_snapshots(self) -> tuple[dict, set]:
        """Synchronized copy of (graphs_by_epoch, evicted_epochs) —
        safe to call from the foreground mid-run."""
        with self._glock:
            return dict(self.graphs_by_epoch), set(self.evicted_epochs)

    def _run(self) -> None:
        try:
            for r in range(self.rounds):
                u, v, w = traffic_updates(self.engine.g, self.frac,
                                          seed=self.seed + 101 + r)
                t0 = time.perf_counter()
                span = trace.span("refresh.round", round=r,
                                  pipelined=self.pipeline is not None)
                with span:
                    self._one_round(u, v, w)
                self.refresh_s.append(time.perf_counter() - t0)
                if self.interval_s:
                    time.sleep(self.interval_s)
        except BaseException as exc:   # surfaced by join()
            self.error = exc

    def _one_round(self, u, v, w) -> None:
        if self.pipeline is not None:
            # staged: one epoch per work item, busiest groups
            # first — the foreground serves between items
            self.pipeline.submit(u, v, w)
            self.pipeline.plan()
            items = 0
            while self.pipeline.step() is not None:
                items += 1
                self._record_epoch()
            self.items_per_round.append(items)
        else:
            self.engine.apply_updates(u, v, w)
            self._record_epoch()
            self.items_per_round.append(1)

    def as_record(self) -> dict:
        return {
            "refresh_rounds": len(self.refresh_s),
            "refresh_pipelined": self.pipeline is not None,
            "refresh_items": int(sum(self.items_per_round)),
            "refresh_mean_s": round(float(np.mean(self.refresh_s)), 4)
            if self.refresh_s else 0.0,
            "refresh_max_s": round(max(self.refresh_s), 4)
            if self.refresh_s else 0.0,
        }
