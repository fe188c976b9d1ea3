# Copied from src/repro/serving/scheduler.py; keep the two in step.  One change:
# pad_pow2 comes from core.padding (the reference imports it through dist_engine).
"""Deadline-aware micro-batching scheduler (DESIGN.md §11).

Single ``(s, t)`` requests arrive one at a time (live traffic); the
device serves fixed pow2 batch shapes (``QueryPlanner.bucket_sizes``).
The ``MicroBatcher`` bridges the two: requests accumulate in a pending
buffer and the whole buffer flushes as one planner batch when either

  * the buffer reaches ``max_batch`` (a warmup-compiled bucket size —
    throughput bound, "full" flush), or
  * ``deadline_s`` has elapsed since the *oldest* pending request
    arrived (tail-latency bound, "deadline" flush).

So a request waits at most one deadline before its batch launches, and
under load the batch fills long before the deadline — latency degrades
into throughput exactly at the arrival rate where batching starts
paying.  Flush sizes are recorded per flush (occupancy histogram) so
the load harness can report how full the buckets actually ran.

Two drive modes: ``auto=True`` spawns a daemon flusher thread (the
production arrangement, used by the load harness and the threaded soak
test); ``auto=False`` leaves flushing to explicit ``flush()`` calls so
tests can interleave submits, flushes, and index refreshes
deterministically on one thread.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

from ..core.padding import pad_pow2
from ..obs import trace
from ..obs.metrics import MetricsRegistry


class Request:
    """One in-flight query; resolved in place by the serving flush.
    ``error`` is set instead of ``dist`` when the flush failed —
    ``result()`` is the raising accessor.

    ``t_sched`` is the request's *scheduled* arrival time (open-loop
    clock); it defaults to the submit instant but an open-loop driver
    running behind schedule passes the time the request was supposed
    to arrive, so ``latency_s`` charges the queueing delay instead of
    hiding it (coordinated omission).  The basis is a property of the
    request, not of the serve path that resolved it — a cache hit and
    a device miss measure from the same clock.

    ``tier`` records which serving tier resolved the request —
    "cache", "label" (hub-label merge, DESIGN.md §15) or "planner" —
    so responses stay attributable per tier; ``cached`` is the
    backwards-compatible boolean view of the first.
    """

    __slots__ = ("s", "t", "t_submit", "t_sched", "t_done", "dist",
                 "epoch", "staleness", "cached", "tier", "error",
                 "_done")

    def __init__(self, s: int, t: int, t_sched: float | None = None):
        self.s = int(s)
        self.t = int(t)
        self.t_submit = time.perf_counter()
        self.t_sched = self.t_submit if t_sched is None else t_sched
        self.t_done: float | None = None
        self.dist: float | None = None
        self.epoch: int | None = None
        # the pinned epoch's recency tag (core.refresh_pipeline
        # .Staleness), set by the serving flush alongside ``epoch``
        self.staleness = None
        self.cached = False
        self.tier: str | None = None
        self.error: BaseException | None = None
        self._done = threading.Event()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> float:
        """Distance, or raise: TimeoutError if unserved, the flush's
        exception if its batch failed."""
        if not self.wait(timeout):
            raise TimeoutError(f"query ({self.s},{self.t}) not served "
                               f"within {timeout}s")
        if self.error is not None:
            raise RuntimeError(
                f"serving flush failed for ({self.s},{self.t})"
            ) from self.error
        return self.dist

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def latency_s(self) -> float:
        """Completion latency from the scheduled arrival (== submit
        when no schedule was given) — the open-loop basis shared by
        cache hits and misses alike."""
        if self.t_done is None:
            raise RuntimeError("request not resolved yet")
        return self.t_done - self.t_sched


class MicroBatcher:
    """Accumulate requests; flush by deadline or full bucket.

    ``serve_batch`` is called with the list of pending requests and
    must set ``dist``/``epoch``/``cached`` on each; the batcher stamps
    completion times and wakes waiters.  Flush metadata accumulates
    incrementally (bucket histogram + counters, O(1) per flush — a
    long-lived runtime flushes hundreds of times a second) and is
    reported by ``occupancy()`` / ``flush_reasons``.
    """

    def __init__(self, serve_batch: Callable[[Sequence[Request]], None],
                 *, max_batch: int = 256, deadline_s: float = 0.002,
                 auto: bool = True, registry: MetricsRegistry | None = None,
                 slow_log=None):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive: {max_batch}")
        self._serve_batch = serve_batch
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        self._pending: list[Request] = []
        self._cond = threading.Condition()
        self._closed = False
        self.error: BaseException | None = None
        # per-flush accounting lives in registry metrics (DESIGN.md
        # §16), O(1) space: pow2-bucket labeled counter of flush sizes
        # plus flush-reason counters and the request-latency histogram.
        # All flush counters mutate only in _take (under self._cond),
        # so occupancy() snapshots them under the same lock and never
        # reports torn mid-flush state.
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._m_occ = self.registry.labeled("serve.batch.occupancy")
        self._m_reasons = self.registry.labeled("serve.batch.flushes")
        self._m_requests = self.registry.counter(
            "serve.batch.flushed_requests")
        self._m_latency = self.registry.histogram(
            "serve.request.latency_s")
        self._slow_log = slow_log
        self._thread: threading.Thread | None = None
        if auto:
            self._thread = threading.Thread(target=self._run,
                                            name="microbatcher",
                                            daemon=True)
            self._thread.start()

    # -- submission ----------------------------------------------------
    def submit(self, s: int, t: int,
               t_sched: float | None = None) -> Request:
        req = Request(s, t, t_sched)
        with self._cond:
            if self._closed:
                raise RuntimeError(
                    "MicroBatcher is closed"
                    + (f" (flusher died: {self.error!r})"
                       if self.error else ""))
            self._pending.append(req)
            # wake the flusher: either this is the first request (its
            # deadline clock starts now) or the bucket just filled
            self._cond.notify_all()
        return req

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- flushing ------------------------------------------------------
    def _take(self, reason: str) -> list[Request]:
        """Caller must hold the lock.  Detach at most ``max_batch``
        pending requests (oldest first) and account the flush."""
        batch = self._pending[:self.max_batch]
        self._pending = self._pending[self.max_batch:]
        if batch:
            self._m_occ.inc(pad_pow2(len(batch)))
            self._m_requests.inc(len(batch))
            self._m_reasons.inc(reason)
        return batch

    # Backwards-compatible counter views (the pre-§16 attribute API),
    # all reading the registry metrics _take maintains.
    @property
    def n_flushes(self) -> int:
        return int(self._m_reasons.total)

    @property
    def flushed_requests(self) -> int:
        return int(self._m_requests.value)

    @property
    def flush_reasons(self) -> dict:
        return {"full": 0, "deadline": 0, "manual": 0,
                **self._m_reasons.snapshot()}

    def _fail(self, batch: list[Request], exc: BaseException) -> None:
        """Resolve ``batch`` (and anything still pending) with ``exc``
        so no waiter hangs on a dead flush path."""
        with self._cond:
            batch = batch + self._pending
            self._pending = []
        now = time.perf_counter()
        for req in batch:
            if not req.done:
                req.error = exc
                req.t_done = now
                req._done.set()

    def _resolve(self, batch: list[Request]) -> None:
        """Serve and complete one flush.  A failure closes the batcher
        FIRST (under the lock), then resolves every affected request
        with the exception, then re-raises for the caller.

        The close-before-fail order is what makes the failure path
        race-free in BOTH drive modes: a request submitted during the
        failing flush either landed in the pending buffer before the
        close — and is swept into ``_fail`` below — or its submit
        raises with the cause.  Closing only from the auto thread (the
        old arrangement) left manual-mode (``auto=False``) callers a
        window where a request submitted while ``flush()`` was raising
        stayed queued forever on a serve path whose owner had already
        seen the exception and walked away.
        """
        if not batch:
            return
        t_flush = time.perf_counter()
        try:
            with trace.span("serve.flush", size=len(batch),
                            bucket=pad_pow2(len(batch))):
                self._serve_batch(batch)
            for req in batch:
                if req.dist is None or req.epoch is None:
                    raise RuntimeError(
                        f"serve_batch left ({req.s},{req.t}) "
                        "unresolved")
        except BaseException as exc:
            self.error = exc
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            self._fail(batch, exc)
            raise
        now = time.perf_counter()
        for req in batch:
            req.t_done = now
            req._done.set()
        self._observe(batch, t_flush, now)

    def _observe(self, batch: list[Request], t_flush: float,
                 now: float) -> None:
        """Post-resolution accounting: latency histogram, slow-query
        log, and (tracing on) one lifecycle event per request covering
        scheduled-arrival -> respond, tagged with the tier/epoch/
        staleness the flush stamped."""
        tr = trace.get_tracer()
        emit = tr.enabled
        for req in batch:
            lat = now - req.t_sched
            self._m_latency.observe(lat)
            lag = req.staleness.lag_batches \
                if req.staleness is not None else 0
            if self._slow_log is not None:
                self._slow_log.offer(lat, {
                    "s": req.s, "t": req.t, "tier": req.tier,
                    "epoch": req.epoch, "staleness_batches": lag,
                    "batch_wait_ms": round(
                        (t_flush - req.t_submit) * 1e3, 3),
                    "flush_ms": round((now - t_flush) * 1e3, 3),
                    "batch_size": len(batch),
                })
            if emit:
                tr.event("serve.request", req.t_sched, now,
                         tier=req.tier, epoch=req.epoch,
                         staleness=lag, bucket=pad_pow2(len(batch)),
                         wait_ms=round(
                             (t_flush - req.t_submit) * 1e3, 3))

    def flush(self) -> int:
        """Synchronously flush one batch of whatever is pending (the
        deterministic-test drive mode); returns its size."""
        with self._cond:
            batch = self._take("manual")
        self._resolve(batch)
        return len(batch)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                # deadline runs from the oldest pending arrival, so a
                # request never waits more than deadline_s to launch
                first = self._pending[0].t_submit
                while len(self._pending) < self.max_batch:
                    remaining = self.deadline_s \
                        - (time.perf_counter() - first)
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(timeout=remaining)
                reason = ("full" if len(self._pending) >= self.max_batch
                          else "deadline")
                batch = self._take(reason)
            try:
                self._resolve(batch)
            except BaseException:
                # _resolve already closed the batcher (so submits now
                # raise, carrying self.error) and failed the batch plus
                # every straggler — nothing ever hangs; just stop
                return

    def close(self, *, drain: bool = True) -> None:
        """Stop the flusher; by default drain pending requests first.
        Raises if the flusher will not stop (e.g. stuck in a cold
        compile) rather than draining concurrently with it — two
        threads must never drive serve_batch at once."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise RuntimeError(
                    "MicroBatcher flusher did not stop within 60s; "
                    "refusing to drain concurrently with it")
            self._thread = None
        if drain:
            while self.flush():
                pass

    # -- introspection -------------------------------------------------
    def occupancy(self) -> dict:
        """Flush-size histogram + mean occupancy vs ``max_batch``.

        Bucketed by the planner's pow2 padding rule (floor 16) applied
        to the *whole* flush — an upper bound on executable shape,
        since the planner additionally splits each flush into per-case
        buckets that may each pad smaller.  The registry metrics are
        mutated only in ``_take`` under ``self._cond``, so snapshotting
        them here under the same lock can never report torn mid-flush
        state (e.g. a bumped flush count next to a not-yet-bumped
        histogram) — the concurrency test asserts exactly this."""
        with self._cond:
            hist = self._m_occ.snapshot()
            reasons = self.flush_reasons
            flushed = int(self._m_requests.value)
        n_flushes = sum(reasons.values())
        mean = (flushed / n_flushes / self.max_batch) if n_flushes \
            else 0.0
        return {
            "flushes": n_flushes,
            "mean_occupancy": round(mean, 4),
            "occupancy_hist": hist,
            **{f"flush_{k}": v for k, v in reasons.items()},
        }
