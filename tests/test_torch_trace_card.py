"""One clock on the card: the tracer's device intervals against the
profiler's kernels.

No JAX here (the card's machine has none).  A small batch on a 3-level
index (``road_like(2500, 3)``) runs under ``torch.profiler``; the
profiler's kernels are put on the host clock (``perf_counter``) as the
benchmark's ``bench/portbench/tracing.py`` does, through the wall clock
read beside the host clock when the session starts, corrected by card
synchronises made at known host times.  Every ``serve.lift``
and ``serve.leg`` span's device interval (``device_ts``, ``device_ms``)
must contain each kernel launched inside its host span (launch and kernel
matched by the profiler's ``correlation``), to within 20 µs at either end.
In a batch whose buckets replay CUDA graphs, the spans' intervals come
from events recorded in the graphs and one graph launch issues many
kernels, so there the gather kernels (``gmp_*``) are matched to spans on
the card's clock: under one clock offset of at most 50 µs (the two
clocks' mappings differ by a constant; 14-20 µs and more were seen),
each lies inside one replayed ``serve.lift``/``serve.leg`` interval, to
within 2 µs, and each span holds as many as the same span launches
eagerly.
Skips without a card; on one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace_card.py
"""
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import graphs
from repro_torch.core.dist_engine import EpochedEngine, QueryPlanner
from repro_torch.core.graph import road_like
from repro_torch.obs import trace

SLACK_US = 20.0
# a replayed kernel's overhang past its span's events, past the offset
TOL_US = 2.0
# the largest clock offset searched between replayed spans and kernels
OFFSET_US = 50.0
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _timed_syncs(n=5):
    """n card synchronises, each between two host clock readings."""
    out = []
    for _ in range(n):
        s0 = time.perf_counter()
        torch.cuda.synchronize()
        out.append((s0, time.perf_counter()))
    return out


def _profiled_batch(eng, s, t, path):
    """Run one batch under the profiler with the default tracer reset ->
    (tracer events, profiler events, seconds to add to a profiler ts in
    seconds to put it on the host clock, the correction within them).

    The offset is the benchmark's (the wall clock read beside the host
    clock as the session starts), corrected by synchronises made at
    known host times around the batch: the correction that puts each
    traced ``cudaDeviceSynchronize`` inside the host readings around it
    (the benchmark only checks that distance)."""
    tr = trace.get_tracer()
    tr.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.time() - time.perf_counter()
        known = _timed_syncs()
        eng.query(s, t)
        known += _timed_syncs()
    evs = tr.drain()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        raw = json.load(f)
    base_us = raw.get("baseTimeNanoseconds", 0) / 1e3 \
        if isinstance(raw, dict) else 0.0
    events = raw.get("traceEvents", []) if isinstance(raw, dict) else raw
    events = [e for e in events if e.get("ph") == "X"]
    offset = (base_us * 1e-6 - wall) if base_us else -wall
    fix = _correction(events, offset, known)
    return evs, events, offset + fix, fix


def _correction(events, offset, known):
    """Seconds that put every traced synchronise inside its known host
    readings: the middle of the intersection of the admissible ranges
    (the median of their middles where jitter leaves none).  The known
    ones are the first and the last of the traced ones, in order (the
    tracer's anchor synchronises fall between)."""
    syncs = sorted((e["ts"] * 1e-6 + offset, e.get("dur", 0.0) * 1e-6)
                   for e in events if e.get("name") == "cudaDeviceSynchronize")
    half = len(known) // 2
    ranges = [(s0 - a, s1 - a - dur) for (s0, s1), (a, dur) in
              zip(known, syncs[:half] + syncs[-half:])]
    lo, hi = max(r[0] for r in ranges), min(r[1] for r in ranges)
    if lo <= hi:
        return 0.5 * (lo + hi)
    return float(np.median([0.5 * (a + b) for a, b in ranges]))


@pytest.mark.cuda
def test_device_intervals_contain_their_kernels(cuda_device, tmp_path,
                                                monkeypatch):
    g = road_like(2500, seed=3)
    # the eager path's spans (no graph stream, as on the CPU); the
    # replayed ones: test_replayed_intervals_contain_their_kernels
    monkeypatch.setattr(graphs, "new_stream", lambda device: None)
    eng = EpochedEngine(g, device=cuda_device, hierarchy_levels=3,
                        warm_refresh=False)
    rng = np.random.default_rng(3)
    s, t = rng.integers(0, g.n, 512), rng.integers(0, g.n, 512)
    eng.warmup(512)
    eng.query(s, t)
    for rep in range(3):
        _check_batch(eng, s, t, tmp_path / f"t{rep}.json")


def _check_batch(eng, s, t, path):
    evs, prof, offset, fix = _profiled_batch(eng, s, t, path)
    kernels = {e["args"]["correlation"]: e for e in prof
               if e.get("cat") == "kernel" and "correlation" in e.get(
                   "args", {})}
    launches = [e for e in prof if e.get("cat") in LAUNCH_CATS
                and e.get("args", {}).get("correlation") in kernels]
    origin = trace.get_tracer().origin
    spans = [e for e in evs if e["name"] in ("serve.lift", "serve.leg")]
    assert {e["name"] for e in spans} == {"serve.lift", "serve.leg"}
    worst = float("-inf")
    for e in spans:
        args = e["args"]
        assert args["device_ms"] > 0
        h0 = origin + e["ts"] * 1e-6
        h1 = h0 + e["dur"] * 1e-6
        d0 = origin + args["device_ts"] * 1e-6
        d1 = d0 + args["device_ms"] * 1e-3
        inside = [kernels[la["args"]["correlation"]] for la in launches
                  if h0 <= la["ts"] * 1e-6 + offset <= h1]
        assert inside, e
        for k in inside:
            k0 = k["ts"] * 1e-6 + offset
            k1 = k0 + k["dur"] * 1e-6
            early = (d0 - k0) * 1e6
            late = (k1 - d1) * 1e6
            worst = max(worst, early, late)
            assert early <= SLACK_US and late <= SLACK_US, (
                e["name"], args, k["name"], early, late)
    for e in evs:
        if e["name"] not in ("serve.lift", "serve.leg"):
            assert "device_ms" not in e["args"]
    print(f"{len(spans)} device spans; profiler clock corrected by "
          f"{fix * 1e6:.2f} us; worst overhang {worst:.2f} us")


def _gmp_kernels(prof, offset) -> list:
    """[(start, end)] host-clock seconds of the profile's gather kernels,
    in start order."""
    return sorted((k["ts"] * 1e-6 + offset,
                   (k["ts"] + k["dur"]) * 1e-6 + offset)
                  for k in prof if k.get("cat") == "kernel"
                  and "gmp_" in k.get("name", ""))


def _eager_gmp_counts(evs, prof, offset) -> list:
    """Sorted [(span name, level, gather kernels launched inside its host
    span)] of an eager batch's lift and leg spans."""
    kernels = {e["args"]["correlation"]: e for e in prof
               if e.get("cat") == "kernel" and "correlation" in e.get(
                   "args", {})}
    launches = [(la["ts"] * 1e-6 + offset, kernels[la["args"]["correlation"]])
                for la in prof if la.get("cat") in LAUNCH_CATS
                and la.get("args", {}).get("correlation") in kernels]
    origin = trace.get_tracer().origin
    out = []
    for e in evs:
        if e["name"] not in ("serve.lift", "serve.leg"):
            continue
        h0 = origin + e["ts"] * 1e-6
        h1 = h0 + e["dur"] * 1e-6
        n = sum(1 for ts, k in launches
                if h0 <= ts <= h1 and "gmp_" in k["name"])
        out.append((e["name"], e["args"]["level"], n))
    return sorted(out)


def _replayed_gmp_counts(evs, prof, offset):
    """(sorted [(span name, level, gather kernels inside its device
    interval)], the clock offsets in µs that place every gather kernel
    inside one replayed lift or leg interval) of a replayed batch."""
    origin = trace.get_tracer().origin
    spans = []
    for e in evs:
        if e["name"] in ("serve.lift", "serve.leg"):
            d0 = origin + e["args"]["device_ts"] * 1e-6
            spans.append((d0, d0 + e["args"]["device_ms"] * 1e-3, e))
    kernels = _gmp_kernels(prof, offset)
    assert spans and kernels
    fits = {}
    for step in range(-int(OFFSET_US * 10), int(OFFSET_US * 10) + 1):
        shift = step * 1e-7
        counts = [0] * len(spans)
        for k0, k1 in kernels:
            own = [i for i, (d0, d1, _e) in enumerate(spans)
                   if d0 - TOL_US * 1e-6 <= k0 + shift
                   and k1 + shift <= d1 + TOL_US * 1e-6]
            if len(own) != 1:
                break
            counts[own[0]] += 1
        else:
            fits[step / 10] = sorted(
                (e["name"], e["args"]["level"], n)
                for (_d0, _d1, e), n in zip(spans, counts))
    return fits


@pytest.mark.cuda
def test_replayed_intervals_contain_their_kernels(cuda_device, tmp_path):
    g = road_like(2500, seed=3)
    eng = EpochedEngine(g, device=cuda_device, hierarchy_levels=3,
                        warm_refresh=False)
    rng = np.random.default_rng(3)
    s, t = rng.integers(0, g.n, 512), rng.integers(0, g.n, 512)
    eng.warmup(512)
    eng.query(s, t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "new_stream", lambda device: None)
        eager = QueryPlanner(eng.dix)
    eager.query(s, t)
    evs, prof, offset, _fix = _profiled_batch(eager, s, t,
                                              tmp_path / "eager.json")
    want = _eager_gmp_counts(evs, prof, offset)
    # every gather kernel of the batch runs inside a lift or a leg
    assert sum(n for _name, _level, n in want) == len(
        _gmp_kernels(prof, offset))
    assert want and all(n > 0 for _name, _level, n in want)
    for rep in range(3):
        evs, prof, offset, fix = _profiled_batch(eng, s, t,
                                                 tmp_path / f"r{rep}.json")
        tags = {e["args"]["graph"] for e in evs
                if e["name"] == "planner.bucket"}
        assert tags == {"replay"}
        fits = _replayed_gmp_counts(evs, prof, offset)
        good = [us for us, counts in fits.items() if counts == want]
        assert good, (want, fits)
        print(f"replay {rep}: profiler clock corrected by "
              f"{fix * 1e6:.2f} us; offsets that fit {min(good):.1f} to "
              f"{max(good):.1f} us")
