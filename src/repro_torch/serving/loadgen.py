# Copied from src/repro/serving/loadgen.py (numpy only); keep the two in step.
"""Open-loop load harness for the serving runtime (DESIGN.md §11).

Open-loop means arrivals follow their own clock (Poisson process at
``rate_qps``), *not* the server's: when the runtime falls behind, the
generator keeps submitting and queueing delay lands in the measured
latency — the standard way to see tail behavior that closed-loop
(wait-for-response) drivers structurally hide.

Query mixes come from ``data/queries.py`` (``workload_pairs``):
``uniform`` endpoints, ``zipf`` hot-pair skew (exercises the result
cache), ``geo`` spatially-local pairs (exercises same-fragment planner
buckets).  The run report carries p50/p95/p99 latency, offered vs
achieved qps, cache hit rate, and the batch-occupancy histogram, in the
reference's record shape (the port prints it as one JSON line and
writes no ``BENCH_*.json``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .runtime import ServingRuntime
from .scheduler import Request


@dataclass
class LoadReport:
    """One load phase's results; ``as_record()`` is the record."""
    n_requests: int
    offered_qps: float
    achieved_qps: float
    wall_s: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float
    # serving-gap / staleness observability (DESIGN.md §14): the
    # longest completion-time gap between consecutive responses (a
    # stop-the-world refresh shows up here as one huge gap), how many
    # responses were served from a mid-pipeline epoch, and the worst
    # batch lag any response carried
    max_serving_gap_ms: float = 0.0
    stale_responses: int = 0
    max_staleness_batches: int = 0
    # provenance of the reported percentiles (DESIGN.md §16): "histogram"
    # means p50/p95/p99 come from the runtime's streaming latency
    # histogram scoped to this phase (n = latency_n observations);
    # "sampled" is the pre-§16 sorted-request-list fallback
    latency_source: str = "histogram"
    latency_n: int = 0
    runtime_stats: dict = field(default_factory=dict)
    requests: list = field(default_factory=list, repr=False)

    def as_record(self) -> dict:
        return {
            "n_requests": self.n_requests,
            "offered_qps": round(self.offered_qps, 1),
            "achieved_qps": round(self.achieved_qps, 1),
            "p50_ms": self.p50_ms,
            "p95_ms": self.p95_ms,
            "p99_ms": self.p99_ms,
            "mean_ms": self.mean_ms,
            "max_ms": self.max_ms,
            "latency_source": self.latency_source,
            "latency_n": self.latency_n,
            "max_serving_gap_ms": self.max_serving_gap_ms,
            "stale_responses": self.stale_responses,
            "max_staleness_batches": self.max_staleness_batches,
            **self.runtime_stats,
        }


def _percentiles(lat_ms: np.ndarray, hist_window=None) -> dict:
    """Latency fields for the report.  p50/p95/p99 come from the
    runtime's streaming histogram scoped to this phase (``hist_window``,
    a ``HistogramSnapshot``) when it saw every request — the same
    bounded-memory numbers a production scraper reads, within one 5%
    bucket of exact.  mean/max stay exact from the request list, and
    the list is also the fallback when no histogram is available."""
    if hist_window is not None and hist_window.count == len(lat_ms) \
            and hist_window.count > 0:
        return {
            "p50_ms": round(hist_window.percentile(50) * 1e3, 3),
            "p95_ms": round(hist_window.percentile(95) * 1e3, 3),
            "p99_ms": round(hist_window.percentile(99) * 1e3, 3),
            "mean_ms": round(float(lat_ms.mean()), 3),
            "max_ms": round(float(lat_ms.max()), 3),
            "latency_source": "histogram",
            "latency_n": hist_window.count,
        }
    return {
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
        "p95_ms": round(float(np.percentile(lat_ms, 95)), 3),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
        "mean_ms": round(float(lat_ms.mean()), 3),
        "max_ms": round(float(lat_ms.max()), 3),
        "latency_source": "sampled",
        "latency_n": int(len(lat_ms)),
    }


def run_load(runtime: ServingRuntime, pairs: np.ndarray, *,
             rate_qps: float, seed: int = 0,
             wait_timeout_s: float = 60.0) -> LoadReport:
    """Drive ``pairs`` ([n, 2]) through the runtime as an open-loop
    Poisson stream at ``rate_qps``; blocks until every response lands.

    Arrival times are pre-drawn (exponential inter-arrivals); a
    generator running behind schedule submits immediately rather than
    shedding, so the offered load is honored and overload shows up as
    queueing latency, not as a silently lower rate.
    """
    rng = np.random.default_rng(seed)
    n = len(pairs)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
    reqs: list[Request] = []
    # scope the runtime's streaming latency histogram to this phase:
    # freeze before the first submit, diff after the last response
    hist = getattr(runtime, "latency_histogram", lambda: None)()
    h0 = hist.freeze() if hist is not None else None
    t0 = time.perf_counter()
    for i in range(n):
        delay = arrivals[i] - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        # the scheduled arrival rides on the request itself, so every
        # consumer of its latency — cache hit or device miss — shares
        # the open-loop basis (scheduler.Request.latency_s)
        reqs.append(runtime.submit(int(pairs[i, 0]), int(pairs[i, 1]),
                                   t_sched=t0 + arrivals[i]))
    deadline = time.perf_counter() + wait_timeout_s
    for req in reqs:
        if not req.wait(max(0.0, deadline - time.perf_counter())):
            raise TimeoutError(
                f"load run: ({req.s},{req.t}) unserved after "
                f"{wait_timeout_s}s (runtime stalled?)")
        if req.error is not None:
            raise RuntimeError(
                f"load run: flush failed for ({req.s},{req.t})"
            ) from req.error
    wall = time.perf_counter() - t0
    # latency from the *scheduled* arrival, not the actual submit —
    # otherwise a generator starved by the server (GIL, overload)
    # under-reports exactly the queueing delay an open-loop client
    # would see (coordinated omission).  The basis lives on each
    # Request (t_sched), so cache-hit responses are measured the same
    # way as misses here AND everywhere else latency_s is read.
    lat_ms = np.array([r.latency_s for r in reqs]) * 1e3
    # serving gap: the longest stretch of the run in which NO response
    # completed (measured from run start through the last completion).
    # A refresh that blocks the flusher appears here directly — the
    # "foreground never pauses" acceptance gates on this number.
    done = np.sort(np.array([r.t_done for r in reqs]))
    gaps = np.diff(np.concatenate([[t0], done]))
    stale = [r.staleness for r in reqs if r.staleness is not None]
    return LoadReport(
        n_requests=n, offered_qps=rate_qps,
        achieved_qps=n / wall, wall_s=wall,
        max_serving_gap_ms=round(float(gaps.max()) * 1e3, 3)
        if gaps.size else 0.0,
        stale_responses=sum(1 for s in stale if not s.complete),
        max_staleness_batches=max(
            (s.lag_batches for s in stale), default=0),
        runtime_stats=runtime.stats(), requests=reqs,
        **_percentiles(lat_ms,
                       hist.since(h0) if hist is not None else None))


def run_load_with_refresh(runtime: ServingRuntime, pairs: np.ndarray,
                          *, rate_qps: float, seed: int = 0,
                          refresh_rounds: int = 0,
                          refresh_frac: float = 0.02,
                          refresh_interval_s: float = 0.0,
                          refresh_seed: int = 0,
                          refresh_pipelined: bool = False,
                          wait_timeout_s: float = 60.0,
                          join_timeout_s: float = 120.0):
    """``run_load`` with an optional concurrent RefreshDriver — the one
    spelling of the load-phase teardown shared by ``serve.py --live``,
    benchmarks exp9, and the example.

    ``refresh_pipelined`` stages each round through the prioritized
    refresh pipeline (intermediate epochs, traffic-weighted by this
    runtime's ``frag_traffic`` counters) instead of one monolithic
    apply_updates per round.

    Returns ``(report, graphs_by_epoch, driver)``; ``driver`` is None
    when ``refresh_rounds == 0``, and ``graphs_by_epoch`` maps every
    retained epoch to its validation-oracle graph (pass
    ``driver.evicted_epochs`` to ``validate_against_epochs`` so
    capped-out snapshots are skipped, not miscounted).
    """
    from .runtime import RefreshDriver

    driver = None
    if refresh_rounds:
        driver = RefreshDriver(runtime.engine, rounds=refresh_rounds,
                               frac=refresh_frac,
                               interval_s=refresh_interval_s,
                               seed=refresh_seed,
                               pipelined=refresh_pipelined,
                               traffic=runtime.frag_traffic).start()
    report = run_load(runtime, pairs, rate_qps=rate_qps, seed=seed,
                      wait_timeout_s=wait_timeout_s)
    if driver is not None:
        driver.join(timeout=join_timeout_s)
        graphs, _evicted = driver.graph_snapshots()
    else:
        epoch, _dix, g, _stale = runtime.engine.snapshot()
        graphs = {epoch: g}
    return report, graphs, driver


def validate_against_epochs(requests, graphs_by_epoch, *,
                            sample: int = 64, seed: int = 0,
                            evicted=()) -> tuple[int, int]:
    """Differential check: a sampled response must equal the host
    Dijkstra oracle on the graph of the epoch that served it.

    Returns ``(n_checked, n_bad)``; a response tagged with an epoch
    missing from ``graphs_by_epoch`` counts as bad (it was served
    against an index no one published) UNLESS the epoch is in
    ``evicted`` — the RefreshDriver's retention cap dropped its oracle
    graph, so the response is skipped rather than miscounted.
    """
    from ..core import dijkstra

    rng = np.random.default_rng(seed)
    reqs = list(requests)
    idx = rng.permutation(len(reqs))[:sample]
    checked = 0
    bad = 0
    for i in idx:
        req = reqs[i]
        g = graphs_by_epoch.get(req.epoch)
        if g is None:
            if req.epoch in evicted:
                continue
            checked += 1
            bad += 1
            continue
        checked += 1
        want = dijkstra.pair(g, req.s, req.t)
        bad += dijkstra.mismatches_oracle(want, req.dist)
    return checked, bad
