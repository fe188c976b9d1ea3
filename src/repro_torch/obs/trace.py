# Copied from src/repro/obs/trace.py (standard library only); keep the two in step.
"""Tracing spans with a near-zero-cost disabled path (DESIGN.md §16).

One ``Tracer`` holds a bounded in-memory buffer of Chrome-trace
"complete" events (``ph: "X"``, microsecond timestamps).  The API is
built so that EVERY production call site stays hot-path-safe when
tracing is off:

* ``span(name, **tags)`` — context manager.  Disabled, it returns a
  shared no-op singleton whose ``__enter__``/``__exit__`` are empty
  methods: no allocation, no clock read, no tag dict materialized
  beyond the call itself.
* ``timed(name, out, key, **tags)`` — like ``span`` but ALWAYS times
  (one ``perf_counter`` pair) and writes the elapsed seconds into
  ``out[key]``.  This is the migration target for the hand-rolled
  ``timings["stage"] = time.perf_counter() - t0`` pattern in
  ``refresh_index``/``build_index``: the dict consumers keep their
  numbers, and the same measurement becomes a trace event when the
  tracer is on — one clock, two views.
* ``event(name, t0, t1, **tags)`` — post-hoc emission for intervals
  the caller already measured (per-request lifecycle events derived
  from ``Request.t_sched``/``t_done``).  Disabled, it's one attribute
  check.

Spans nest per-thread: each thread's open-span depth is tracked so
tests can assert nesting/ordering invariants, and events carry the
thread id so chrome://tracing lays concurrent flusher/refresh/export
activity out on separate rows.

A module-level default tracer (``get_tracer()``) is what the library
call sites use; ``serve.py --trace-out`` enables it and drains the
buffer into a Chrome-trace JSON at exit.
"""
from __future__ import annotations

import threading
import time


class _NullSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records wall-clock bounds on exit and appends a
    Chrome "X" event to its tracer's buffer."""

    __slots__ = ("_tracer", "name", "tags", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, tags: dict):
        self._tracer = tracer
        self.name = name
        self.tags = tags

    def __enter__(self):
        self._depth = self._tracer._enter_depth()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._exit_depth()
        self._tracer._emit(self.name, self._t0, t1, self.tags,
                           self._depth)
        return False


class _Timed:
    """Always-on timer that doubles as a span: elapsed seconds land in
    ``out[key]`` unconditionally, and in the trace buffer when the
    tracer is enabled.  ``.elapsed`` is readable after exit."""

    __slots__ = ("_tracer", "name", "_out", "_key", "tags", "_t0",
                 "_depth", "elapsed")

    def __init__(self, tracer, name, out, key, tags):
        self._tracer = tracer
        self.name = name
        self._out = out
        self._key = key
        self.tags = tags
        self.elapsed = 0.0

    def __enter__(self):
        self._depth = self._tracer._enter_depth() \
            if self._tracer.enabled else 0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.elapsed = t1 - self._t0
        if self._out is not None:
            self._out[self._key] = self.elapsed
        if self._tracer.enabled:
            self._tracer._exit_depth()
            self._tracer._emit(self.name, self._t0, t1, self.tags,
                               self._depth)
        return False


class Tracer:
    """Bounded buffer of Chrome-trace events + the span/timed/event
    API.  Disabled by default; ``enable()`` flips one attribute read
    by every call site.  The buffer keeps at most ``max_events``
    (oldest dropped, drop count reported) so a long-lived server can
    leave tracing on without unbounded growth."""

    def __init__(self, *, enabled: bool = False,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.dropped = 0
        self._local = threading.local()
        # one fixed origin so every event's ts is a positive offset
        self._origin = time.perf_counter()

    # -- depth tracking (per-thread nesting, for tests/ordering) ------
    def _enter_depth(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _exit_depth(self) -> None:
        self._local.depth = getattr(self._local, "depth", 1) - 1

    @property
    def depth(self) -> int:
        """Current thread's open-span depth."""
        return getattr(self._local, "depth", 0)

    # -- emission -----------------------------------------------------
    def _emit(self, name, t0, t1, tags, depth) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0 - self._origin) * 1e6,
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": 1,
            "tid": threading.get_ident() % 100_000,
            "args": dict(tags) if tags else {},
        }
        if depth:
            ev["args"]["depth"] = depth
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.max_events:
                drop = len(self._events) - self.max_events
                del self._events[:drop]
                self.dropped += drop

    # -- public API ---------------------------------------------------
    def enable(self, on: bool = True) -> "Tracer":
        self.enabled = on
        return self

    def span(self, name: str, **tags):
        """Context manager; the no-op singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, tags)

    def timed(self, name: str, out: dict | None, key: str, **tags):
        """Context manager that always times into ``out[key]`` and
        additionally traces when enabled."""
        return _Timed(self, name, out, key, tags)

    def event(self, name: str, t0: float, t1: float, **tags) -> None:
        """Emit a completed interval measured by the caller (both
        bounds on the ``perf_counter`` clock)."""
        if not self.enabled:
            return
        self._emit(name, t0, t1, tags, 0)

    def events(self) -> list[dict]:
        """Copy of the buffered events (chronological emit order)."""
        with self._lock:
            return list(self._events)

    def drain(self) -> list[dict]:
        """Return and clear the buffer."""
        with self._lock:
            out = self._events
            self._events = []
            return out

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0


# Module-level default: library call sites trace through this; it
# stays disabled (no-op spans, skipped events) unless a front end —
# serve.py --trace-out, a test — enables it.
_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT


def span(name: str, **tags):
    """Span on the default tracer (the common call-site spelling)."""
    if not _DEFAULT.enabled:
        return _NULL_SPAN
    return _Span(_DEFAULT, name, tags)


def timed(name: str, out: dict | None, key: str, **tags):
    """Timed span on the default tracer (always populates ``out``)."""
    return _Timed(_DEFAULT, name, out, key, tags)


def event(name: str, t0: float, t1: float, **tags) -> None:
    if _DEFAULT.enabled:
        _DEFAULT._emit(name, t0, t1, tags, 0)
