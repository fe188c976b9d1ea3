"""The readers of the program's own spans on a synthetic tracer buffer and
traced window: each reads the events of ``repro_torch.obs.trace`` inside
the window, through the tracer's ``origin``, and reads nothing without a
window, from a tracer that dropped events, or from a program whose tracer
has no ``origin`` (the benchmark's parent commits)."""
import pytest

import portbench_small  # noqa: F401
from portbench import harness, spans
from repro_torch.obs import trace

BATCH = ("serve.lift_ms_per_kq", "serve.leg_ms_per_kq",
         "serve.enqueue_ms_per_kq", "planner.host_ms_per_kq",
         "planner.pad_share")
PATHS = ("paths.syncs_per_path", "paths.sync_share")


@pytest.fixture
def buffer(monkeypatch):
    """A tracer in the program's place, holding two batches inside the
    window [10, 20] s (host clock) and one outside it, and two unwinder
    calls inside it and one outside."""
    tr = trace.Tracer(enabled=True)
    monkeypatch.setattr(trace, "_DEFAULT", tr)
    o = tr.origin

    def ev(name, a, b, **args):
        tr.event(name, o + a, o + b, **args)

    for bid, a, q, buckets in ((1, 11.0, 1000, ((600, 1024), (400, 512))),
                               (2, 13.0, 500, ((500, 512),)),
                               (3, 19.5, 800, ((800, 1024),))):
        # batch 3 ends after the window closes
        ev("serve.batch", a, a + 1.0, batch=bid, queries=q, witness=False)
        ev("planner.plan", a, a + 0.01, batch=bid)
        for i, (real, padded) in enumerate(buckets):
            b0 = a + 0.1 + 0.3 * i
            ev("planner.bucket", b0, b0 + 0.25, batch=bid, case=f"c{i}",
               queries=real, padded=padded)
            ev("serve.program", b0 + 0.01, b0 + 0.11, batch=bid)
            ev("planner.readback", b0 + 0.12, b0 + 0.2, batch=bid)
            ev("serve.lift", b0 + 0.01, b0 + 0.02, batch=bid, level=1,
               kind="compact", device_ms=7.0, device_ts=0.0)
            ev("serve.leg", b0 + 0.02, b0 + 0.03, batch=bid, level=1,
               device_ms=3.0, device_ts=0.0)
    for a, n, syncs, sync_s in ((12.0, 16, 200, 0.25), (14.0, 16, 100, 0.5),
                                (25.0, 16, 999, 0.9)):
        ev("paths.unwind", a, a + 1.0, paths=n, nodes=40 * n, syncs=syncs,
           sync_s=sync_s)
    return tr


def _ctx(tr):
    """The traced window [10, 20] s after the tracer's origin."""
    dev = {"t_start": tr.origin + 10.0, "t_stop": tr.origin + 20.0}
    return {"device": dev, "build": {"device": {}, "host": {}}}


def test_batch_readers_on_a_synthetic_window(buffer):
    ctx = _ctx(buffer)
    kq = 1.5                       # batches 1 and 2: 1,500 queries
    read = {m: harness.reader(m)(ctx) for m in BATCH + PATHS}
    # three buckets in the window, each one lift of 7 and one leg of 3 ms
    assert read["serve.lift_ms_per_kq"] == pytest.approx(3 * 7.0 / kq)
    assert read["serve.leg_ms_per_kq"] == pytest.approx(3 * 3.0 / kq)
    assert read["serve.enqueue_ms_per_kq"] == pytest.approx(3 * 100 / kq)
    # 2 s of batches less three programs (0.1 s) and readbacks (0.08 s)
    assert read["planner.host_ms_per_kq"] == pytest.approx(
        1e3 * (2.0 - 3 * 0.18) / kq)
    assert read["planner.pad_share"] == pytest.approx(
        100.0 * (2048 - 1500) / 2048)
    assert read["paths.syncs_per_path"] == pytest.approx(300 / 32)
    assert read["paths.sync_share"] == pytest.approx(100.0 * 0.75 / 2.0)


def test_card_time_readers_skip_spans_without_it(buffer):
    evs = buffer.drain()
    for e in evs:
        e["args"].pop("device_ms", None)
        e["args"].pop("device_ts", None)
    buffer._events = evs
    ctx = _ctx(buffer)
    assert harness.reader("serve.lift_ms_per_kq")(ctx) is None
    assert harness.reader("serve.leg_ms_per_kq")(ctx) is None
    assert harness.reader("serve.enqueue_ms_per_kq")(ctx) is not None


@pytest.mark.parametrize("metric", BATCH + PATHS)
def test_readers_read_nothing_without_a_window(buffer, metric):
    assert harness.reader(metric)({"build": {"device": {}, "host": {}}}) \
        is None


@pytest.mark.parametrize("metric", BATCH + PATHS)
def test_readers_read_nothing_after_drops(buffer, metric):
    buffer.dropped = 1
    assert harness.reader(metric)(_ctx(buffer)) is None


@pytest.mark.parametrize("metric", BATCH + PATHS)
def test_readers_read_nothing_from_a_tracer_without_origin(
        buffer, monkeypatch, metric):
    ctx = _ctx(buffer)

    class Older:
        """A tracer as the benchmark's parent commits have it."""
        dropped = 0

        def events(self):
            return []

    monkeypatch.setattr(trace, "_DEFAULT", Older())
    assert harness.reader(metric)(ctx) is None


def test_window_keeps_only_events_inside_it(buffer):
    evs = spans.window_events(_ctx(buffer))
    assert sorted(spans.batches(evs)) == [1, 2]
    assert all(10.0 <= a - buffer.origin and b - buffer.origin <= 20.0
               for _n, a, b, _args in evs)
    assert [a["syncs"] for n, _a, _b, a in evs if n == "paths.unwind"] \
        == [200, 100]
