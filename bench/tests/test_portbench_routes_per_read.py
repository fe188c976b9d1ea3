"""The reader of ``paths.routes_per_read`` on a synthetic tracer buffer and
traced window: Σ ``routes`` / Σ ``passes`` of the unwinder's
``paths.unwind`` events inside the window; nothing without a window, from
a tracer that dropped events or has no ``origin``, from events without
``routes`` (the benchmark's parent commits), or from a window whose
batches took no level pass (dense epochs)."""
import pytest

import portbench_small  # noqa: F401
from portbench import harness
from repro_torch.obs import trace

METRIC = "paths.routes_per_read"


@pytest.fixture
def buffer(monkeypatch):
    """A tracer in the program's place holding, inside the window [10, 20]
    s (host clock), three unwinder calls (one with no level pass) and a
    batch span, and one call after the window closes."""
    tr = trace.Tracer(enabled=True)
    monkeypatch.setattr(trace, "_DEFAULT", tr)
    o = tr.origin
    for a, routes, passes in ((11.0, 16 + 12, 2), (13.0, 15 + 3, 2),
                              (15.0, 0, 0), (25.0, 999, 1)):
        tr.event("paths.unwind", o + a, o + a + 1.0, paths=16, nodes=640,
                 syncs=passes, sync_s=0.001 * passes, routes=routes,
                 passes=passes)
    tr.event("serve.batch", o + 12.0, o + 12.5, batch=1, queries=16,
             witness=True)
    return tr


def _ctx(tr):
    """The traced window [10, 20] s after the tracer's origin."""
    dev = {"t_start": tr.origin + 10.0, "t_stop": tr.origin + 20.0}
    return {"device": dev, "build": {"device": {}, "host": {}}}


def test_routes_per_read_on_a_synthetic_window(buffer):
    assert harness.reader(METRIC)(_ctx(buffer)) == pytest.approx(46 / 4)


def test_reads_nothing_from_events_without_routes(buffer):
    evs = buffer.drain()
    for e in evs:
        for key in ("routes", "passes"):
            e["args"].pop(key, None)
    buffer._events = evs
    assert harness.reader(METRIC)(_ctx(buffer)) is None


def test_reads_nothing_where_no_pass_was_made(buffer):
    buffer._events = [e for e in buffer.drain()
                      if e["args"].get("passes", 1) == 0]
    assert harness.reader(METRIC)(_ctx(buffer)) is None


def test_reads_nothing_without_a_window_or_after_drops(buffer):
    read = harness.reader(METRIC)
    assert read({"build": {"device": {}, "host": {}}}) is None
    buffer.dropped = 1
    assert read(_ctx(buffer)) is None


def test_reads_nothing_from_a_tracer_without_origin(buffer, monkeypatch):
    ctx = _ctx(buffer)

    class Older:
        """A tracer as the benchmark's parent commits have it."""
        dropped = 0

        def events(self):
            return []

    monkeypatch.setattr(trace, "_DEFAULT", Older())
    assert harness.reader(METRIC)(ctx) is None
